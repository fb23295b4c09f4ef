"""repro_torch's emulated attention held against repro's (CPU).

The QKᵀ and PV products, the scaling and the masking are held bitwise.  The
softmax is held within 1e-12 of the output's scale: torch's CPU exp differs from
XLA-CPU's in up to 2 ulp on ~15% of inputs and its tanh on ~58% (ROADMAP queue 3,
item 3), and the port fixes the row-sum order (a pairwise tree) and divides by
the softcap as a multiply by its reciprocal, so that its kernel can repeat both.
repro runs on its ``xla`` route.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dispatch as jd  # noqa: E402
from repro.core import ozaki2 as jo  # noqa: E402
from repro.kernels import ozaki_attention as ja  # noqa: E402
from repro_torch.core import dispatch, ozaki2, splitting  # noqa: E402
from repro_torch.core.moduli import DEFAULT_MODULI  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ozaki_attention as ta  # noqa: E402

RNG = np.random.default_rng(23)
TOL = 1e-12   # of max|v|, the bound tests/test_attention.py holds repro to


def _qkv(S, T, D, lead=()):
    return (RNG.standard_normal(lead + (S, D)), RNG.standard_normal(lead + (T, D)),
            RNG.standard_normal(lead + (T, D)))


def _window(S, T, w):
    i, j = np.arange(S)[:, None] + (T - S), np.arange(T)[None, :]
    return ((j <= i) & (i - j < w)).astype(np.int8)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


CASES = {
    # name: (S, T, D, lead, mask, softcap)
    "ragged": (9, 21, 8, (), "causal", 0.0),
    "d16 two blocks": (20, 150, 16, (), "causal", 0.0),
    "d80 ragged batched": (13, 37, 80, (2,), "random", 0.0),
    "softcap": (16, 16, 8, (), "causal", 30.0),
    "window, fully masked row": (12, 40, 16, (), "window", 0.0),
    "batched leading dims": (8, 12, 8, (2, 2), "shared", 0.0),
    "no mask": (8, 12, 8, (), None, 0.0),
}


def _mask(kind, S, T, lead):
    if kind == "causal":
        return np.tril(np.ones((S, T), np.int8), k=T - S)
    if kind == "random":
        return (RNG.random(lead + (S, T)) < 0.7).astype(np.int8)
    if kind == "window":
        m = _window(S, T, 5)
        m[3] = 0                              # a fully masked row
        return m
    if kind == "shared":
        return (RNG.random((S, T)) < 0.8).astype(np.int8)
    return None


@pytest.mark.parametrize("name", list(CASES))
def test_dispatch_attention_matches_reference(name):
    S, T, D, lead, kind, softcap = CASES[name]
    q, k, v = _qkv(S, T, D, lead)
    mask = _mask(kind, S, T, lead)
    got = dispatch.attention(_t(q), _t(k), _t(v), mask=_t(mask), softcap=softcap)
    want = np.asarray(jd.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   mask=None if mask is None else jnp.asarray(mask),
                                   softcap=softcap, mode="xla"))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(v).max())
    via_ops = ops.ozaki_attention(_t(q), _t(k), _t(v), mask=_t(mask), softcap=softcap)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


def test_attention_ref_matches_reference_and_the_fp64_oracle():
    S, T, D, bkv = 24, 40, 16, 16             # three key blocks, the last one ragged
    q, k, v = _qkv(S, T, D)
    mask = np.tril(np.ones((S, T), np.int8), k=T - S)
    pq, pp = dispatch.get_plan(D), dispatch.get_plan(bkv)
    got = ta.attention_ref(_t(q), _t(k), _t(v), _t(mask), pq, pp, 0.0, bkv).numpy()
    jpq, jpp = jo.make_plan(D), jo.make_plan(bkv)
    want = np.asarray(ja.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(mask), jpq, jpp, bkv=bkv))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(v).max())
    s = np.where(mask != 0, q @ k.T / math.sqrt(D), -1e30)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    oracle = (p / p.sum(axis=-1, keepdims=True)) @ v
    np.testing.assert_allclose(got, oracle, rtol=0, atol=TOL * np.abs(v).max())


def test_block_products_and_scores_are_bitwise():
    """With the exp and the sum order taken out, every part is bitwise: the QKᵀ
    product of a key block, the scaled and masked scores (no softcap), and the
    PV product with the block's probabilities as an input."""
    S, D, bkv = 11, 80, 24
    q, k, v = _qkv(S, bkv, D)
    mask = (RNG.random((S, bkv)) < 0.6)
    pq, pp = dispatch.get_plan(D), dispatch.get_plan(bkv)
    jpq, jpp = jo.make_plan(D), jo.make_plan(bkv)
    s_prod = ozaki2.emulated_matmul(_t(q), _t(k).T, pq)
    want = np.asarray(jo.emulated_matmul(jnp.asarray(q), jnp.asarray(k).T, jpq))
    np.testing.assert_array_equal(s_prod.numpy(), want)
    inv = 1.0 / math.sqrt(D)
    s = ta._masked_scores(s_prod, _t(mask), 0.0, inv)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(ja._masked_scores(jnp.asarray(want), jnp.asarray(mask), 0.0, inv)))
    # probabilities as the scan makes them: in [0, 1], exactly 1 at each row max
    p = np.exp(np.minimum(RNG.standard_normal((S, bkv)) * 3, 0.0))
    p[RNG.random((S, bkv)) < 0.2] = 0.0
    pv = ozaki2.emulated_matmul(_t(p), _t(v), pp)
    np.testing.assert_array_equal(
        pv.numpy(), np.asarray(jo.emulated_matmul(jnp.asarray(p), jnp.asarray(v), jpp)))


def test_batched_emulated_matmul_is_each_problem_alone():
    a, b = RNG.standard_normal((3, 7, 40)), RNG.standard_normal((3, 40, 9))
    plan = dispatch.get_plan(40)
    got = ozaki2.emulated_matmul(_t(a), _t(b), plan)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(),
                                      ozaki2.emulated_matmul(_t(a[i]), _t(b[i]), plan).numpy())


@pytest.mark.parametrize("n", [1, 8, 24, 128])
def test_row_sum_is_the_pairwise_tree(n):
    p = np.exp(-np.abs(RNG.standard_normal((5, n))) * 4)

    def tree(x):
        w = 1 << (len(x) - 1).bit_length()
        x = list(x) + [0.0] * (w - len(x))
        while len(x) > 1:
            x = [x[i] + x[i + 1] for i in range(0, len(x), 2)]
        return x[0]

    got = ta._row_sum(_t(p)).numpy()
    np.testing.assert_array_equal(got, [tree(row) for row in p])
    np.testing.assert_allclose(got, p.sum(axis=-1), rtol=4 * n * 2.0 ** -53)


def test_online_update_matches_reference():
    s = RNG.standard_normal((6, 16)) * 4
    s[2] = ta.NEG_INF                                          # fully masked so far
    m = np.array([-1e30, 0.5, -1e30, 3.0, 9.0, -2.0])
    l = np.abs(RNG.standard_normal(6))
    got = ta._online_update(_t(s), _t(m), _t(l))
    want = ja._online_update(jnp.asarray(s), jnp.asarray(m), jnp.asarray(l))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))     # m_new: exact
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=8 * 2.0 ** -52)


def test_kernel_wrapper_on_the_host_and_its_checks():
    q, k, v = (_t(x) for x in _qkv(9, 21, 16, (3,)))
    mask = torch.ones((3, 9, 21), dtype=torch.int8)
    pq, pp = dispatch.get_plan(16), dispatch.get_plan(24)
    before = ta.attention_fused.launches
    got = ta.attention_fused(q, k, v, mask, pq, pp, 0.0, bq=16, bkv=24)
    assert ta.attention_fused.launches == before           # the plain version ran
    np.testing.assert_array_equal(got.numpy(),
                                  ta.attention_ref(q, k, v, mask, pq, pp, 0.0, 24).numpy())
    with pytest.raises(ValueError):
        ta.attention_fused(q[0], k[0], v[0], mask[0], pq, pp, bq=16, bkv=24)
    with pytest.raises(ValueError):
        ta.attention_fused(q, k[:, :20], v, mask, pq, pp, bq=16, bkv=24)
    with pytest.raises(TypeError):
        ta.attention_fused(q.to(torch.int32), k, v, mask, pq, pp, bq=16, bkv=24)


def test_attention_kind_routes_and_kernel_mode_needs_cuda():
    q, k, v = (_t(x) for x in _qkv(4, 6, 8))
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.attention(q, k, v, mode="kernel")
    with dispatch.mode_scope("kernel"), pytest.raises(ValueError, match="CUDA"):
        ops.ozaki_attention(q, k, v)
    assert dispatch.get_tuning("attention", (1, 4, 8, 6)) == {"bq": 32, "bkv": 128}


# ---------------------------------------------------------------------------
# The kernel's orders (csrc/ozaki_attention.cu), transcribed in torch
# ---------------------------------------------------------------------------

def _blocks(q, k, v, mask, bkv):
    """attention_ref's padding: k, v and the mask to whole key blocks."""
    T = k.shape[-2]
    tp = -(-T // bkv) * bkv
    return (q.to(torch.float64), ta._pad_rows(k.to(torch.float64), tp),
            ta._pad_rows(v.to(torch.float64), tp), torch.nn.functional.pad(mask != 0, (0, tp - T)),
            tp // bkv)


def _tile_scores(q, kp, mp, j, bkv, plan_qk, softcap):
    """Steps 1-2 of a tile: NEG_INF without products where no row of the tile
    attends to a key of the block (the scores do not depend on them there)."""
    blk = slice(j * bkv, (j + 1) * bkv)
    if not bool(mp[..., blk].any()):
        return torch.full(q.shape[:-1] + (bkv,), ta.NEG_INF, dtype=torch.float64)
    s_prod = ozaki2.emulated_matmul(q, kp[..., blk, :].transpose(-1, -2), plan_qk)
    return ta._masked_scores(s_prod, mp[..., blk], softcap, 1.0 / math.sqrt(q.shape[-1]))


def _pv_skipped(m_old, mx):
    """The kernel skips a tile's P V products when every row has seen a real key
    (m > NEG_INF) and the block has none (max NEG_INF): then p = 0 exactly."""
    return bool(((m_old > ta.NEG_INF) & (mx <= ta.NEG_INF)).all())


def _sweep_attention(q, k, v, mask, plan_qk, plan_pv, softcap, bkv, bq, skip=True):
    """The one-pass path per tile of bq rows, with the kernel's skips: where P V
    is skipped, pv = +0.0 and acc = acc * corr + pv still runs."""
    q, kp, vp, mp, nblk = _blocks(q, k, v, mask, bkv)
    outs = []
    for r0 in range(0, q.shape[-2], bq):
        qt, mt = q[..., r0:r0 + bq, :], mp[..., r0:r0 + bq, :]
        m = torch.full(qt.shape[:-1], ta.NEG_INF, dtype=torch.float64)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for j in range(nblk):
            s = _tile_scores(qt, kp, mt, j, bkv, plan_qk, softcap)
            m_old = m
            p, corr, m, l = ta._online_update(s, m, l)
            if skip and _pv_skipped(m_old, s.amax(dim=-1)):
                pv = torch.zeros_like(acc)
            else:
                pv = ozaki2.emulated_matmul(p, vp[..., j * bkv:(j + 1) * bkv, :], plan_pv)
            acc = acc * corr[..., None] + pv
        outs.append(acc / l[..., None])
    return torch.cat(outs, dim=-2)


def _hl_matmul(a, b, plan):
    """emulated_matmul with the row path's integer order (csrc/ozaki_attention.cu,
    attention_row_*): the residues of a's rows only; b's (hi, lo) words summed in
    int64 against them, H = sum ar * hi and L = sum ar * lo per modulus, and the
    balanced residue of (2^26 mod m) H + L as the product's residue."""
    ai, ashift = splitting.scale_to_int(a.to(torch.float64), plan.payload_bits, axis=-1)
    bi, bshift = splitting.scale_to_int(b.to(torch.float64), plan.payload_bits, axis=-2)
    ahi, alo = splitting.split_hi_lo(ai)
    bhi, blo = splitting.split_hi_lo(bi)
    hi, lo = bhi.to(torch.int64)[..., None, :, :], blo.to(torch.int64)[..., None, :, :]
    cres = []
    for m in plan.moduli:
        ar = splitting.residue(ahi, alo, m).to(torch.int64)[..., :, :, None]
        H, L = (ar * hi).sum(dim=-2), (ar * lo).sum(dim=-2)
        v = H * ((1 << 26) % m) + L
        cres.append(splitting.balanced_mod(v, m).to(torch.int32))
    c_int = ozaki2.garner_reconstruct(torch.stack(cres), plan)
    return splitting.apply_unscale(c_int, ashift, bshift)


def _row_attention(q, k, v, mask, plan_qk, plan_pv, softcap, bkv, bq=None):
    """The row path, each query row its own problem (the kernel takes S = 1):
    the key axis split across blocks in four phases, both products by
    _hl_matmul.  (1) per block the scores (Q Kᵀ not formed for masked keys:
    NEG_INF either way) and the block row max; (2) the prefix maxima M_j, with
    M_-1 = NEG_INF; (3) per block, given M_j, p, its row sum and P V, which is
    +0.0 without products for a row that has seen a real key in an earlier
    block and has none in this one; (4) per row, in block order,
    corr = exp(M_j-1 - M_j), l = l corr + sum_j, acc = acc corr + pv_j,
    out = acc / l.  All rows are independent, so they run here at once."""
    q, kp, vp, mp, nblk = _blocks(q, k, v, mask, bkv)
    scores, bmax = [], []
    for j in range(nblk):
        blk = slice(j * bkv, (j + 1) * bkv)
        s_prod = _hl_matmul(q, kp[..., blk, :].transpose(-1, -2), plan_qk)
        s = ta._masked_scores(s_prod, mp[..., blk], softcap, 1.0 / math.sqrt(q.shape[-1]))
        scores.append(s)
        bmax.append(s.amax(dim=-1))
    M, m = [], torch.full(q.shape[:-1], ta.NEG_INF, dtype=torch.float64)
    for j in range(nblk):
        m = torch.maximum(m, bmax[j])
        M.append(m)
    sums, pvs = [], []
    for j in range(nblk):
        m_prev = M[j - 1] if j else torch.full_like(M[0], ta.NEG_INF)
        p = torch.exp(scores[j] - M[j][..., None])
        sums.append(ta._row_sum(p))
        pv = _hl_matmul(p, vp[..., j * bkv:(j + 1) * bkv, :], plan_pv)
        skipped = (m_prev > ta.NEG_INF) & (bmax[j] <= ta.NEG_INF)
        pvs.append(torch.where(skipped[..., None], 0.0, pv))
    l, acc, m = torch.zeros_like(m), torch.zeros(q.shape, dtype=torch.float64), \
        torch.full_like(m, ta.NEG_INF)
    for j in range(nblk):
        corr = torch.exp(m - M[j])
        l = l * corr + sums[j]
        acc = acc * corr[..., None] + pvs[j]
        m = M[j]
    return acc / l[..., None]


def _order_mask(kind, B, S, T, bkv):
    if kind == "causal":
        return np.broadcast_to(np.tril(np.ones((S, T), np.int8), k=T - S), (B, S, T)).copy()
    if kind == "window":
        return np.broadcast_to(_window(S, T, 24), (B, S, T)).copy()
    if kind == "ring, last block only":    # decode: the only real keys in the last block
        m = np.zeros((B, S, T), np.int8)
        m[..., (T - 1) // bkv * bkv:T - 3] = 1
        return m
    if kind == "late start":               # the first blocks fully masked for every row
        m = np.tril(np.ones((S, T), np.int8), k=T - S)
        m[:, :2 * bkv] = 0
        return np.broadcast_to(m, (B, S, T)).copy()
    m = (RNG.random((B, S, T)) < 0.5).astype(np.int8)
    m[0, 1] = 0                            # a row with no key at all
    return m


ORDER_CASES = {
    # name: (B, S, T, D, bkv, mask kind)
    "decode, ring": (4, 1, 256, 16, 32, "ring, last block only"),
    "decode, causal end": (3, 1, 200, 24, 32, "causal"),
    "causal": (2, 64, 64, 16, 16, "causal"),
    "window": (3, 40, 200, 32, 32, "window"),
    "late start": (2, 24, 96, 8, 16, "late start"),
    "random, a fully masked row": (2, 9, 150, 8, 24, "random"),
}


ORDER_RUNS = [(name, "sweep", bq) for name in ORDER_CASES for bq in (8, 32)] + \
             [(name, "row", 1) for name in ORDER_CASES]


@pytest.mark.parametrize("name, path, bq", ORDER_RUNS)
def test_kernel_orders_equal_attention_ref(name, path, bq):
    """The kernel's paths, with their skips, are bitwise equal to the plain
    version, and within 1e-12 max|v| of repro's (the row path on every query
    row, each as its own S = 1 problem)."""
    B, S, T, D, bkv, kind = ORDER_CASES[name]
    q, k, v = _qkv(S, T, D, (B,))
    mask = _order_mask(kind, B, S, T, bkv)
    pq, pp = dispatch.get_plan(D), dispatch.get_plan(bkv)
    fn = {"sweep": _sweep_attention, "row": _row_attention}[path]
    got = fn(_t(q), _t(k), _t(v), _t(mask), pq, pp, 0.0, bkv, bq)
    want = ta.attention_ref(_t(q), _t(k), _t(v), _t(mask), pq, pp, 0.0, bkv)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jwant = np.stack([np.asarray(ja.attention_ref(jnp.asarray(q[b]), jnp.asarray(k[b]),
                                                  jnp.asarray(v[b]), jnp.asarray(mask[b]),
                                                  jo.make_plan(D), jo.make_plan(bkv), bkv=bkv))
                      for b in range(B)])
    np.testing.assert_allclose(got.numpy(), jwant, rtol=0, atol=TOL * np.abs(v).max())


def test_skips_apply_where_exact_and_only_there():
    """Causal prefill skips the blocks above the diagonal; the ring and
    late-start masks' leading fully masked blocks are not skipped (no row has a
    real key yet), and skipping them anyway changes the result: the fully
    masked row's output, p = 1 over every key, loses the skipped keys."""
    B, S, T, D, bkv = 1, 64, 64, 8, 16
    q, k, v = (_t(x) for x in _qkv(S, T, D, (B,)))
    mask = _t(_order_mask("causal", B, S, T, bkv))
    _, kp, _, mp, nblk = _blocks(q, k, v, mask, bkv)
    skipped = []
    for r0 in range(0, S, 16):
        m = torch.full((B, 16), ta.NEG_INF, dtype=torch.float64)
        for j in range(nblk):
            s = _tile_scores(q[:, r0:r0 + 16], kp, mp[:, r0:r0 + 16], j, bkv,
                             dispatch.get_plan(D), 0.0)
            skipped.append(_pv_skipped(m, s.amax(dim=-1)))
            m = torch.maximum(m, s.amax(dim=-1))
    assert sum(skipped) == 6                    # of 16 (tile, block) pairs
    q, k, v = (_t(x) for x in _qkv(2, 48, 8, (1,)))
    mask = torch.zeros((1, 2, 48), dtype=torch.int8)
    mask[0, 0, 40:] = 1                         # row 1 attends to nothing
    pq, pp = dispatch.get_plan(8), dispatch.get_plan(16)
    want = ta.attention_ref(q, k, v, mask, pq, pp, 0.0, 16)
    assert bool(torch.isfinite(want).all())
    for fn in (_sweep_attention, _row_attention):
        np.testing.assert_array_equal(fn(q, k, v, mask, pq, pp, 0.0, 16, 8).numpy(), want.numpy())

    def naive(m_old, mx):                       # the skip without its condition
        return bool((mx <= ta.NEG_INF).all())
    real = _pv_skipped
    globals()["_pv_skipped"] = naive
    try:
        bad = _sweep_attention(q, k, v, mask, pq, pp, 0.0, 16, 8)
    finally:
        globals()["_pv_skipped"] = real
    np.testing.assert_array_equal(bad[0, 0].numpy(), want[0, 0].numpy())
    assert not bool((bad[0, 1] == want[0, 1]).any())


def _bmod_rt(v, m):
    """The kernel's bmod_rt (csrc/ozaki_common.cuh) on int64 numpy values that
    hold int32s: u = v + 2^31, q = umulhi(u, floor(2^32 / m)), one conditional
    subtraction, minus 2^31 mod m, the balanced fix-ups."""
    u = (v + 2 ** 31).astype(np.uint64)
    r = u - ((u * np.uint64(2 ** 32 // m)) >> np.uint64(32)) * np.uint64(m)
    r = np.where(r >= m, r - m, r).astype(np.int64)
    t = r - (2 ** 31) % m
    return np.where(t > (m - 1) // 2, t - m, np.where(t < -(m // 2), t + m, t))


def test_runtime_modulus_reduction_is_exact():
    """The reduction the kernel uses where the modulus index is a loop variable
    (the products' sums, p's residues) equals the balanced residue of every
    int32, at the ends of the range too."""
    v = np.concatenate([RNG.integers(-2 ** 31, 2 ** 31, 200000),
                        [-2 ** 31, 2 ** 31 - 1, 0, -1, 1, 2 ** 21, -2 ** 21]]).astype(np.int64)
    for m in DEFAULT_MODULI:
        want = np.remainder(v, m)
        want = np.where(want > (m - 1) // 2, want - m, want)
        np.testing.assert_array_equal(_bmod_rt(v, m), want)


def _bmod_f64(z, m):
    """The kernel's bmod_f64 (csrc/ozaki_common.cuh) in numpy float64, which
    rounds as the card does: q = (z * fl(1/m) + 1.5 * 2^52) - 1.5 * 2^52, then
    r = z - q m (an fma of an exact integer result there: int64 here), the
    balanced fix-ups."""
    k = 6755399441055744.0
    q = (z * (1.0 / m) + k) - k
    r = z.astype(np.int64) - q.astype(np.int64) * m
    return np.where(r > (m - 1) // 2, r - m, np.where(r < -(m // 2), r + m, r))


def test_fp64_residues_are_exact():
    """The FP64 reductions of the residue planes (z = hi (2^26 mod m) + lo for
    any int32 pair) and of p's scaled integers (|z| <= 2^53) equal the balanced
    residues."""
    hi = np.concatenate([RNG.integers(-2 ** 31, 2 ** 31, 100000), [-2 ** 31, 2 ** 31 - 1, 0]])
    lo = np.concatenate([RNG.integers(-2 ** 31, 2 ** 31, 100000), [2 ** 31 - 1, -2 ** 31, 0]])
    p = np.concatenate([RNG.integers(-2 ** 53, 2 ** 53 + 1, 100000, dtype=np.int64),
                        [2 ** 53, -2 ** 53, 2 ** 53 - 1, 0]])
    for m in DEFAULT_MODULI:
        for z, exact in (((hi * ((1 << 26) % m) + lo).astype(np.float64), hi * 2 ** 26 + lo),
                         (p.astype(np.float64), p)):
            want = np.remainder(exact, m)
            want = np.where(want > (m - 1) // 2, want - m, want)
            np.testing.assert_array_equal(_bmod_f64(z, m), want)


def test_path_threshold_and_tile_limits():
    assert ta.choose_path(1) == "row"                         # decode
    assert ta.choose_path(2) == ta.choose_path(512) == "sweep"  # prefill
    assert ta.PATHS == ("sweep", "row")
    assert (ta.max_bq(128), ta.max_bq(129), ta.max_bq(256)) == (32, 16, 16)
