"""The integer orders of the GEMM and GEMV kernels (csrc/ozaki_gemm.cu,
csrc/ozaki_gemv.cu, csrc/ozaki_product.cuh), transcribed on the CPU.

Each transcription repeats what the kernel computes, step for step where the
order matters: the FP64 residues (residue_f64, and the low byte of lo for
m = 256), X's table in the MMA's fragment order and the lane permutation of k,
the int32 sums reduced at the kernel's fold interval (here also forced small),
and the lazy-carry Garner digits.  Each is held bitwise against the plain
versions ``gemm_hilo_ref`` / ``gemv_hilo_ref`` and against ``repro``'s
interpret-mode ``gemm_hilo`` / ``gemv_hilo``.  The kernels themselves are held
against the plain versions on the card (test_torch_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ozaki_gemm as jgemm, ozaki_gemv as jgemv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dispatch, ozaki2, splitting  # noqa: E402
from repro_torch.core.moduli import DEFAULT_MODULI  # noqa: E402
from repro_torch.kernels import common, ozaki_gemm, ozaki_gemv  # noqa: E402

RNG = np.random.default_rng(41)
K_ROUND = 6755399441055744.0  # 1.5 * 2^52
INT32 = 2 ** 31


def _balanced(v, m):
    u = np.remainder(v, m)
    return np.where(u > (m - 1) // 2, u - m, u)


def _residue_hilo(hi, lo, m):
    """residue_hilo (csrc/ozaki_common.cuh) in numpy: for m = 256 the signed low
    byte of lo; else z = hi (2^26 mod m) + lo (exact in float64, |z| < 2^40),
    y = z * fl(1/m), q = the low word of y + 1.5 * 2^52, and r = z - q m in
    32-bit wrap-around from z's low word, with no fix-up."""
    hi, lo = np.asarray(hi, np.int64), np.asarray(lo, np.int64)
    if m == 256:
        return lo.astype(np.uint8).view(np.int8).astype(np.int64)
    c = (1 << 26) % m
    y = (hi.astype(np.float64) * float(c) + lo.astype(np.float64)) * (1.0 / m)
    q = (y + K_ROUND).view(np.uint64).astype(np.int64) & 0xFFFFFFFF
    r = ((hi * c + lo) - q * m) & 0xFFFFFFFF
    return np.where(r >= 2 ** 31, r - 2 ** 32, r)


def _garner_lazy(res, plan):
    """garner_digits_lazy: the carries summed unreduced, one reduction a digit."""
    gc, ms = plan.garner, plan.moduli
    carry = [np.zeros_like(res[0]) for _ in ms]
    digits = []
    for j, m in enumerate(ms):
        t = _balanced((res[j] - carry[j]) * int(gc.inv_pref[j]), m)
        digits.append(t)
        for l in range(j + 1, len(ms)):
            carry[l] = carry[l] + t * int(gc.pref_mod[j, l])
            assert np.abs(carry[l]).max(initial=0) < 2 ** 20
    return digits


def _represent(digits, plan, out_rep):
    return common.represent([torch.from_numpy(d.astype(np.int32)) for d in digits], plan,
                            out_rep)


def _fold(acc, m):
    """The kernels' reduction of the int32 sums; they must still be exact."""
    assert np.abs(acc).max(initial=0) < INT32
    return _balanced(acc, m)


# ---------------------------------------------------------------------------
# GEMV (csrc/ozaki_gemv.cu): X's fragment-order table, two m16n8k16 per step
# ---------------------------------------------------------------------------

def _gemv_table(x_hi, x_lo, plan):
    """gemv_x_table: entry (i, c, lane) of W words, word w = residues mod m_i of
    X[k][g + 8 (w // 2)] for k = 32c + 8t + 4 (w % 2) + q in byte q."""
    K, B = x_hi.shape
    W = 4 if B > 8 else 2
    table = np.zeros((plan.r, K // 32, 32, W, 4), np.int64)
    for i, m in enumerate(plan.moduli):
        res = _residue_hilo(x_hi, x_lo, m)                    # (K, B)
        for lane in range(32):
            g, t = divmod(lane, 4)
            for w in range(W):
                col = g + 8 * (w // 2)
                if col >= B:
                    continue
                ks = (np.arange(K // 32)[:, None] * 32 + 8 * t + 4 * (w % 2)
                      + np.arange(4)[None, :])
                table[i, :, lane, w, :] = res[ks, col]
    return table


def _gemv_by_fragments(a_hi, a_lo, x_hi, x_lo, plan, out_rep, fold_every=1 << 16):
    """gemv_kernel: per warp 8 rows; per 32-deep step c and modulus i, lane
    (g, t) holds A row g's residues at k = 32c + 8t + 0..7 (the B operand) and
    the table entry (the A operand, rows = columns of X); D[b, n] of the two
    m16n8k16 products sums over (t, q); the sums are reduced every fold_every k."""
    a_hi, a_lo = a_hi.numpy().astype(np.int64), a_lo.numpy().astype(np.int64)
    M, K = a_hi.shape
    B = x_hi.shape[1]
    table = _gemv_table(x_hi.numpy(), x_lo.numpy(), plan)
    W = table.shape[3]
    res = []
    for i, m in enumerate(plan.moduli):
        ra = _residue_hilo(a_hi, a_lo, m)                        # (M, K)
        acc = np.zeros((M // 8, 16, 8), np.int64)                # (warp, b, n)
        for c in range(K // 32):
            for j in range(2):                                   # the two MMAs
                # A operand: row b < 8 from lane (g = b, t) word j; b >= 8 word 2 + j
                aop = np.zeros((16, 4, 4), np.int64)             # (b, t, q)
                for b in range(16):
                    w = j + 2 * (b // 8)
                    if w < W:
                        aop[b] = table[i, c, 4 * (b % 8):4 * (b % 8) + 4, w, :]
                # B operand: column n from lane (g = n, t): row n's k = 32c + 8t + 4j + q
                ks = 32 * c + 8 * np.arange(4)[:, None] + 4 * j + np.arange(4)[None, :]
                bop = ra[:, ks].reshape(M // 8, 8, 4, 4)         # (warp, n, t, q)
                acc += np.einsum("btq,wntq->wbn", aop, bop)
            if ((c + 1) * 32) % fold_every == 0:
                acc = _fold(acc, m)
        res.append(_fold(acc, m)[:, :B, :].transpose(0, 2, 1).reshape(M, B))
    return _represent(_garner_lazy(res, plan), plan, out_rep)


# ---------------------------------------------------------------------------
# GEMM (csrc/ozaki_gemm.cu): planes, 128-deep stages, zero fill past K
# ---------------------------------------------------------------------------

def _gemm_by_stages(a_hi, a_lo, b_hi, b_lo, plan, out_rep, fold_steps=(1 << 16) // 128):
    """residues_rows / residues_cols, then per modulus the sums of 128-deep
    stages (the last zero-filled past K, as TMA does), reduced every
    fold_steps stages but not after the last; at the end stored as (sum +
    2^31) mod m (umod_rt), which Garner reads back less 2^31 mod m."""
    a_hi, a_lo = a_hi.numpy().astype(np.int64), a_lo.numpy().astype(np.int64)
    b_hi, b_lo = b_hi.numpy().astype(np.int64), b_lo.numpy().astype(np.int64)
    K = a_hi.shape[1]
    nk = -(-K // 128)
    res = []
    for m in plan.moduli:
        pa = np.zeros((a_hi.shape[0], nk * 128), np.int64)
        pb = np.zeros((b_hi.shape[1], nk * 128), np.int64)
        pa[:, :K] = _residue_hilo(a_hi, a_lo, m)                 # (M, K) plane
        pb[:, :K] = _residue_hilo(b_hi, b_lo, m).T               # (N, K) plane
        acc = np.zeros((pa.shape[0], pb.shape[0]), np.int64)
        for ks in range(nk):
            blk = slice(128 * ks, 128 * (ks + 1))
            acc += pa[:, blk] @ pb[:, blk].T
            if (ks + 1) % fold_steps == 0 and ks + 1 < nk:
                acc = _fold(acc, m)
        assert np.abs(acc).max(initial=0) < INT32
        stored = (acc + 2 ** 31) % m                             # uint8 in cres
        assert stored.max(initial=0) < 256
        res.append(stored - (2 ** 31) % m)
    return _represent(_garner_lazy(res, plan), plan, out_rep)


def _hilo(shape, scale_axis, plan, tiny_row=False):
    x = RNG.standard_normal(shape) * np.exp(RNG.uniform(-10, 10, shape[0] if scale_axis == -1
                                                        else shape[1]))[
        (slice(None), None) if scale_axis == -1 else (None, slice(None))]
    if tiny_row:
        x[0] *= 1e-300
    xi, _ = splitting.scale_to_int(torch.from_numpy(x), plan.payload_bits, scale_axis)
    return splitting.split_hi_lo(xi)


def _jplan(plan):
    from repro.core import ozaki2 as jo

    return jo.Plan(moduli=tuple(plan.moduli), payload_bits=plan.payload_bits)


def test_residue_hilo_equals_the_plain_residue_over_int32():
    """residue_f64 (and the low byte of lo for m = 256) equals common.residue
    for any int32 (hi, lo), the ends of the range included."""
    ends = [-INT32, INT32 - 1, 0, -1, 1, -(2 ** 25), 2 ** 25, 2 ** 26 - 1, -(2 ** 26)]
    hi = np.concatenate([RNG.integers(-INT32, INT32, 200000), np.repeat(ends, len(ends))])
    lo = np.concatenate([RNG.integers(-INT32, INT32, 200000), np.tile(ends, len(ends))])
    th, tl = torch.from_numpy(hi.astype(np.int32)), torch.from_numpy(lo.astype(np.int32))
    for m in DEFAULT_MODULI:
        np.testing.assert_array_equal(_residue_hilo(hi, lo, m),
                                      common.residue(th, tl, m).numpy())


def test_lazy_garner_equals_garner_on_product_residues():
    """garner_digits_lazy on the balanced residues of real products (r = 16,
    the DGEMM's plan, and r = 20) gives garner_digits' digits."""
    for k in (8192, 1 << 21):
        plan = dispatch.get_plan(k)
        ah, al = _hilo((24, 64), -1, plan)
        bh, bl = _hilo((64, 20), 0, plan)
        res = []
        for m in plan.moduli:
            ra = common.residue(ah, al, m).to(torch.int64)
            rb = common.residue(bh, bl, m).to(torch.int64)
            res.append(common.balanced_mod(ra @ rb, m).to(torch.int32))
        lazy = _garner_lazy([r.numpy().astype(np.int64) for r in res], plan)
        for got, want in zip(lazy, common.garner_digits(res, plan)):
            np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("mkb", [(8, 32, 1), (16, 96, 2), (24, 64, 7), (8, 64, 8),
                                 (16, 128, 9), (8, 96, 16)])
@pytest.mark.parametrize("fold_every", [1 << 16, 64, 32])
def test_gemv_integer_order_equals_plain_version(mkb, fold_every):
    """X's fragment table and the permuted k of the two m16n8k16 per step,
    reduced at any interval, give gemv_hilo_ref's bits in every representation."""
    m, k, b = mkb
    plan = dispatch.get_plan(k)
    ah, al = _hilo((m, k), -1, plan, tiny_row=True)
    xh, xl = _hilo((k, b), 0, plan)
    for rep in common.OUT_REPS:
        got = _gemv_by_fragments(ah, al, xh, xl, plan, rep, fold_every)
        torch.testing.assert_close(got, ozaki_gemv.gemv_hilo_ref(ah, al, xh, xl, plan, rep),
                                   rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("mkn", [(8, 128, 24), (16, 192, 17), (8, 320, 40)])
@pytest.mark.parametrize("fold_steps", [512, 2, 1])
def test_gemm_integer_order_equals_plain_version(mkn, fold_steps):
    """128-deep stages zero-filled past K (K = 192, 320: not multiples of the
    stage), reduced every fold_steps stages, give gemm_hilo_ref's bits."""
    m, k, n = mkn
    plan = dispatch.get_plan(k)
    ah, al = _hilo((m, k), -1, plan, tiny_row=True)
    bh, bl = _hilo((k, n), 0, plan)
    for rep in common.OUT_REPS:
        got = _gemm_by_stages(ah, al, bh, bl, plan, rep, fold_steps)
        torch.testing.assert_close(got, ozaki_gemm.gemm_hilo_ref(ah, al, bh, bl, plan, rep),
                                   rtol=0, atol=0, equal_nan=True)


def test_integer_orders_at_the_largest_products_stay_exact():
    """Every residue at -128 (m = 256, lo = -128: the largest |product|, 2^14):
    the fold interval keeps the int32 sums exact.  Depth 2^17 + 128 at the
    kernels' own intervals (the GEMM's last fold falls 128 k before the end),
    checked on one row and column."""
    plan = ozaki2.Plan(moduli=DEFAULT_MODULI[:1], payload_bits=53)
    k = (1 << 17) + 128
    lo = torch.full((8, k), -128, dtype=torch.int32)
    hi = torch.zeros_like(lo)
    want = ozaki_gemm.gemm_hilo_ref(hi, lo, hi.T.contiguous(), lo.T.contiguous(), plan, "digits")
    got = _gemm_by_stages(hi, lo, hi.T.contiguous(), lo.T.contiguous(), plan, "digits")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got = _gemv_by_fragments(hi, lo, hi[:1].T.contiguous(), lo[:1].T.contiguous(), plan,
                             "digits")
    torch.testing.assert_close(got, want[:, :, :1], rtol=0, atol=0)


@pytest.mark.parametrize("out_rep", ["f64", "digits"])
def test_integer_orders_match_repro_interpret(out_rep):
    """Both transcriptions against repro's Pallas kernels in interpret mode, on
    the same (hi, lo) operands."""
    plan = convert.plan_from_fields(dispatch.get_plan(256).moduli,
                                    dispatch.get_plan(256).payload_bits)
    jp = _jplan(plan)
    ah, al = _hilo((8, 256), -1, plan, tiny_row=True)
    bh, bl = _hilo((256, 8), 0, plan)
    j = [jnp.asarray(t.numpy()) for t in (ah, al, bh, bl)]
    want = jgemm.gemm_hilo(*j, jp, out_rep, bm=8, bn=8, bk=128, interpret=True)
    got = _gemm_by_stages(ah, al, bh, bl, plan, out_rep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jgemv.gemv_hilo(*j[:2], j[2][:, :3], j[3][:, :3], jp, out_rep, bm=8, bk=128,
                           interpret=True)
    got = _gemv_by_fragments(ah, al, bh[:, :3].contiguous(), bl[:, :3].contiguous(), plan,
                             out_rep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gemv_table_size():
    assert ozaki_gemv.table_bytes(16, 8192, 1) == 16 * 8192 * 8
    assert ozaki_gemv.table_bytes(16, 8192, 8) == 16 * 8192 * 8
    assert ozaki_gemv.table_bytes(20, 64, 9) == 20 * 64 * 16
