"""repro_torch's Blocked-ELL SpMV, sparse CG and format tools held against repro (CPU).

repro runs its ``xla`` route (``spmv_bell_ref``), which its own tests hold bitwise
equal to the Pallas kernel; the port's kernel wrapper takes its plain version
for CPU tensors.  Inputs are made with numpy from a seed, away from the ulps just
below a power of two (where torch's and XLA's log2 differ) and from denormals.
As for the stencil, the ds representation is held bitwise to repro's eager
``digits_to_ds`` and within 2^-44 to repro's jitted route, whose epilogue XLA
contracts into FMAs (ROADMAP queue 3).
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dispatch as jd  # noqa: E402
from repro.hpc import cg as jcg, spmv_formats as jsf  # noqa: E402
from repro.kernels import common as jc, ops as jops, ozaki_spmv as jsp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import dispatch, ozaki2  # noqa: E402
from repro_torch.core.moduli import DEFAULT_MODULI  # noqa: E402
from repro_torch.hpc import cg, spmv_formats  # noqa: E402
from repro_torch.kernels import common, ops, ozaki_spmv, ref  # noqa: E402

RNG = np.random.default_rng(29)
U = 2.0 ** -53


def _random_bell(m, n, bw, zero_frac=0.2):
    col = RNG.integers(0, n, (m, bw)).astype(np.int32)
    val = RNG.standard_normal((m, bw)) * np.exp(RNG.uniform(-8, 8, (m, 1)))
    val[RNG.random((m, bw)) < zero_frac] = 0.0     # structural zeros (padding)
    return val, col, RNG.standard_normal(n)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _denom(val, x):
    return np.abs(val).sum(-1) * np.abs(x).max() + 1e-300


def _eager_ds(val, col, x, bw):
    """repro's ds epilogue, run op by op (no FMA contraction), on the port's digits."""
    jp, tp = jd.get_plan(bw, margin_bits=4), dispatch.get_plan(bw, margin_bits=4)
    ops_ = ozaki_spmv._decompose_operands(*_t(val, col, x), tp)
    av_hi, av_lo, cols, x_hi, x_lo, sa, sx = ops_
    d8 = ozaki_spmv._contract_ref(av_hi, av_lo, cols, x_hi, x_lo, tp, "digits").numpy()
    hi, lo = jc.digits_to_ds([jnp.asarray(d.astype(np.int32)) for d in d8], jp)
    y = np.asarray(hi).astype(np.float64) + np.asarray(lo).astype(np.float64)
    return np.asarray(jnp.ldexp(jnp.asarray(y), jnp.asarray(-(sa + sx).numpy())))


def assert_matches(got, want, out_rep, val, col, x):
    """Bitwise, except ds against repro's jitted route (see the module docstring)."""
    if out_rep != "ds":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got, _eager_ds(val, col, x, val.shape[1]))
    assert np.max(np.abs(got - want) / _denom(val, x)) <= 2.0 ** -44


@pytest.mark.parametrize("mnbw", [(50, 64, 8), (17, 100, 4), (128, 32, 16), (33, 40, 27)])
@pytest.mark.parametrize("out_rep", ["f64", "digits", "ds"])
def test_spmv_bell_ref_bitwise(mnbw, out_rep):
    m, n, bw = mnbw
    val, col, x = _random_bell(m, n, bw)
    jp, tp = jd.get_plan(bw, margin_bits=4), dispatch.get_plan(bw, margin_bits=4)
    want = np.asarray(jsp.spmv_bell_ref(jnp.asarray(val), jnp.asarray(col), jnp.asarray(x), jp,
                                        out_rep=out_rep))
    got = ozaki_spmv.spmv_bell_ref(*_t(val, col, x), tp, out_rep)
    assert got.dtype == torch.float64 and tuple(got.shape) == (m,)
    assert_matches(got.numpy(), want, out_rep, val, col, x)
    # the kernel wrapper takes the plain version for CPU tensors, and launches nothing
    before = ozaki_spmv.spmv_bell.launches
    np.testing.assert_array_equal(ozaki_spmv.spmv_bell(*_t(val, col, x), tp, out_rep,
                                                       br=128).numpy(),
                                  got.numpy())
    assert ozaki_spmv.spmv_bell.launches == before


@pytest.mark.parametrize("out_rep", ["f64", "digits", "ds"])
def test_dispatch_and_ops_spmv_match_reference_seam(out_rep):
    val, col, x = _random_bell(37, 45, 6)               # ragged M
    jv, jcol, jx = jnp.asarray(val), jnp.asarray(col), jnp.asarray(x)
    want = np.asarray(jd.spmv(jv, jcol, jx, out_rep=out_rep, mode="xla"))
    assert_matches(dispatch.spmv(*_t(val, col, x), out_rep=out_rep).numpy(), want, out_rep,
                   val, col, x)
    assert_matches(ops.ozaki_spmv_bell(*_t(val, col, x), out_rep=out_rep).numpy(),
                   np.asarray(jops.ozaki_spmv_bell(jv, jcol, jx, out_rep=out_rep, mode="xla")),
                   out_rep, val, col, x)


def test_spmv_all_zero_x_and_zero_rows():
    """Every solver's first matvec has x = 0; all-zero rows are padding rows."""
    val, col, _ = _random_bell(20, 30, 5)
    val[3] = 0.0
    x0 = np.zeros(30)
    tp = dispatch.get_plan(5, margin_bits=4)
    for rep in ("f64", "digits", "ds"):
        y = ozaki_spmv.spmv_bell_ref(*_t(val, col, x0), tp, rep)
        assert torch.equal(y, torch.zeros(20, dtype=torch.float64))
    x = RNG.standard_normal(30)
    y = ozaki_spmv.spmv_bell_ref(*_t(val, col, x), tp).numpy()
    assert y[3] == 0.0
    np.testing.assert_array_equal(
        y, np.asarray(jsp.spmv_bell_ref(jnp.asarray(val), jnp.asarray(col), jnp.asarray(x),
                                        jd.get_plan(5, margin_bits=4))))


def test_decompose_operands_match_reference():
    val, col, x = _random_bell(9, 12, 4)
    tp, jp = dispatch.get_plan(4, margin_bits=4), jd.get_plan(4, margin_bits=4)
    got = ozaki_spmv._decompose_operands(*_t(val, col, x), tp)
    want = jsp._decompose_operands(jnp.asarray(val), jnp.asarray(col), jnp.asarray(x), jp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == torch.int32


def test_f64_oracle_matches_reference_oracle():
    val, col, x = _random_bell(40, 50, 9)
    got = ref.spmv_bell_f64(*_t(val, col, x)).numpy()
    want = np.asarray(jref.spmv_bell_f64(jnp.asarray(val), jnp.asarray(col), jnp.asarray(x)))
    # the same products, summed in another order: within bw ulps of Σ|a|·max|x|
    assert np.max(np.abs(got - want) / _denom(val, x)) <= 9 * U


@pytest.mark.parametrize("e", [-2, 0, 3, 60])
def test_spmv_accuracy_at_the_ulp_below_a_power_of_two(e):
    """Row maxima and max|x| at nextafter(2^e, 0), where the Phase-1 exponent of
    torch and XLA may differ (so no bitwise test here): the result still meets
    the bound of tests/test_kernels.py against native FP64."""
    val, col, x = _random_bell(24, 30, 7, zero_frac=0.0)
    val *= 0.9 / np.abs(val).max(axis=1, keepdims=True)
    val[:, 2] = np.nextafter(2.0 ** e, 0.0) * np.where(np.arange(24) % 2, 1.0, -1.0)
    x *= 0.9 * 2.0 ** -e / np.abs(x).max()
    x[5] = np.nextafter(2.0 ** -e, 0.0)
    for rep in ("f64", "digits", "ds"):
        y = ops.ozaki_spmv_bell(*_t(val, col, x), out_rep=rep).numpy()
        want = ref.spmv_bell_f64(*_t(val, col, x)).numpy()
        tol = 16 * U if rep != "ds" else 2.0 ** -44
        assert np.max(np.abs(y - want) / _denom(val, x)) <= tol


def test_spmv_long_rows_exact():
    """Rows longer than 2^17 slots, all of one value whose residue mod 256 is
    -128: an int32 row sum would pass 2^31.  The plain version sums in int64
    (the kernel reduces every 2^16 slots); the result is the exact product."""
    bw = (1 << 17) + 64
    v = 1.0 + 2.0 ** -45                     # scales to 2^52 + 2^7
    val = np.full((2, bw), v)
    col = RNG.integers(0, 5, (2, bw)).astype(np.int32)
    x = np.full(5, v)
    plan = dispatch.get_plan(bw, margin_bits=4)
    y = ozaki_spmv.spmv_bell_ref(*_t(val, col, x), plan).numpy()
    exact = float(Fraction(bw) * Fraction(v) ** 2)    # correctly rounded
    np.testing.assert_array_equal(y, np.full(2, exact))


# ---------------------------------------------------------------------------
# The kernel's integer order (csrc/ozaki_spmv.cu), transcribed in torch
# ---------------------------------------------------------------------------

def _bmod64(v, m):
    """The kernel's bmod64: v = hi32 * 2^32 + lo32 (lo32 unsigned), reduced as
    bmod(bmod(hi32) * (2^32 mod m) + lo32 mod m)."""
    hi, lo = v >> 32, v & 0xFFFFFFFF
    return common.balanced_mod(common.balanced_mod(hi, m) * ((1 << 32) % m) + lo % m, m)


def _garner_digits_lazy(accs, plan):
    """garner_digits_lazy (csrc/ozaki_common.cuh): the carries summed unreduced."""
    gc, ms = plan.garner, plan.moduli
    carry = [torch.zeros_like(accs[0]) for _ in ms]
    digits = []
    for j, m in enumerate(ms):
        t = common.balanced_mod((accs[j] - carry[j]) * int(gc.inv_pref[j]), m)
        digits.append(t)
        for l in range(j + 1, len(ms)):
            carry[l] = carry[l] + t * int(gc.pref_mod[j, l])
    return digits


def _contract_by_table(av_hi, av_lo, cols, x_hi, x_lo, plan, out_rep, fold_every=1 << 16):
    """The kernel in torch: x's residue table, then per modulus the int64 sums
    H = sum hi * xr and L = sum lo * xr over the row, folded every
    ``fold_every`` slots into L = the balanced residue of (2^26 mod m) H + L,
    the same fold at the row's end, then the lazy-carry Garner digits."""
    table = torch.stack([common.residue(x_hi, x_lo, m) for m in plan.moduli], dim=-1)
    table = table.to(torch.int8).to(torch.int64)            # one int8 row per x_j
    xr = table[cols.to(torch.int64)]                        # (M, bw, r) gathered rows
    hi, lo = av_hi.to(torch.int64), av_lo.to(torch.int64)
    M, bw = av_hi.shape
    accs = []
    for i, m in enumerate(plan.moduli):
        c26 = (1 << 26) % m
        H = torch.zeros(M, dtype=torch.int64)
        L = torch.zeros(M, dtype=torch.int64)
        for s0 in range(0, bw, fold_every):
            blk = slice(s0, s0 + fold_every)
            H = H + (hi[:, blk] * xr[:, blk, i]).sum(dim=-1)
            L = L + (lo[:, blk] * xr[:, blk, i]).sum(dim=-1)
            if s0 + fold_every < bw:
                L, H = _bmod64(H * c26 + L, m), torch.zeros_like(H)
        accs.append(_bmod64(H * c26 + L, m).to(torch.int32))
    return common.represent(_garner_digits_lazy(accs, plan), plan, out_rep)


@pytest.mark.parametrize("mnbw", [(50, 64, 8), (37, 45, 27), (300, 200, 16), (20, 9, 33)])
@pytest.mark.parametrize("fold_every", [1 << 16, 16, 5])
def test_kernel_integer_order_equals_plain_version(mnbw, fold_every):
    """The residue table and the int64 (H, L) sums, folded at any interval, give
    the plain version's bits, which repro's reference gives too."""
    m, n, bw = mnbw
    val, col, x = _random_bell(m, n, bw)
    tp = dispatch.get_plan(bw, margin_bits=4)
    ops_ = ozaki_spmv._decompose_operands(*_t(val, col, x), tp)[:5]
    for rep in ("f64", "digits"):
        got = _contract_by_table(*ops_, tp, rep, fold_every)
        torch.testing.assert_close(got, ozaki_spmv._contract_ref(*ops_, tp, rep), rtol=0, atol=0)
    y = ozaki_spmv._finish(_contract_by_table(*ops_, tp, "f64", fold_every), tp, "f64",
                           *ozaki_spmv._decompose_operands(*_t(val, col, x), tp)[5:])
    want = jsp.spmv_bell_ref(jnp.asarray(val), jnp.asarray(col), jnp.asarray(x),
                             jd.get_plan(bw, margin_bits=4))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))


def test_kernel_integer_order_on_long_rows():
    """Rows of 2^17 + 64 slots at the largest |hi * xr|: the kernel's fold every
    2^16 slots keeps the int64 sums exact, and the result is the exact product."""
    bw = (1 << 17) + 64
    v = 1.0 + 2.0 ** -45
    val, col, x = np.full((2, bw), v), RNG.integers(0, 5, (2, bw)).astype(np.int32), np.full(5, v)
    plan = dispatch.get_plan(bw, margin_bits=4)
    ops_ = ozaki_spmv._decompose_operands(*_t(val, col, x), plan)
    got = _contract_by_table(*ops_[:5], plan, "f64")
    torch.testing.assert_close(got, ozaki_spmv._contract_ref(*ops_[:5], plan, "f64"), rtol=0,
                               atol=0)
    y = ozaki_spmv._finish(got, plan, "f64", *ops_[5:]).numpy()
    np.testing.assert_array_equal(y, np.full(2, float(Fraction(bw) * Fraction(v) ** 2)))


def test_lazy_garner_digits_and_bmod64_are_exact():
    """Over random residues, the lazy-carry digits equal garner_digits', and
    bmod64 equals the balanced residue of any int64 within the kernel's range."""
    for r in (2, 15, 20):
        plan = ozaki2.Plan(moduli=DEFAULT_MODULI[:r], payload_bits=53)
        accs = [torch.from_numpy(RNG.integers(-(m // 2), (m - 1) // 2 + 1, 4000)
                                 .astype(np.int32)) for m in plan.moduli]
        for g, w in zip(_garner_digits_lazy(accs, plan), common.garner_digits(accs, plan)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    v = torch.from_numpy(np.concatenate([RNG.integers(-2 ** 62, 2 ** 62, 20000),
                                         [0, -1, 2 ** 62, -2 ** 62, 2 ** 32, -2 ** 32]]))
    for m in DEFAULT_MODULI:
        torch.testing.assert_close(_bmod64(v, m), common.balanced_mod(v, m), rtol=0, atol=0)


def test_residue_table_width():
    assert [ozaki_spmv.table_width(r) for r in (1, 15, 16, 17, 20)] == [16, 16, 16, 32, 32]


def test_wrappers_validate():
    val, col, x = _t(*_random_bell(8, 10, 3))
    plan = dispatch.get_plan(3, margin_bits=4)
    with pytest.raises(ValueError):
        ozaki_spmv.spmv_bell(val, col[:, :2], x, plan, br=128)
    with pytest.raises(TypeError):
        ozaki_spmv.spmv_bell(val, col.to(torch.float64), x, plan, br=128)
    with pytest.raises(ValueError):
        ozaki_spmv.spmv_bell(val, col, x, plan, out_rep="f32", br=128)
    with pytest.raises(ValueError):
        ozaki_spmv.spmv_bell_ref(val, col, x[:, None], plan)


# ---------------------------------------------------------------------------
# formats and sparse CG
# ---------------------------------------------------------------------------

def test_spmv_formats_match_reference():
    for dense in (jsf.laplacian_1d(12), jsf.laplacian_2d(4, 5)):
        for bw in (5, 8):
            got, want = spmv_formats.to_blocked_ell(dense, bw), jsf.to_blocked_ell(dense, bw)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
            assert spmv_formats.padding_ratio(got[0]) == jsf.padding_ratio(want[0])
    np.testing.assert_array_equal(spmv_formats.laplacian_1d(7), jsf.laplacian_1d(7))
    np.testing.assert_array_equal(spmv_formats.laplacian_2d(3, 6), jsf.laplacian_2d(3, 6))
    with pytest.raises(ValueError):
        spmv_formats.to_blocked_ell(np.ones((4, 8)), bw=4)


@pytest.mark.parametrize("record_plain", [True, False])
def test_cg_solve_bell_retraces_reference(record_plain):
    dense = jsf.laplacian_2d(8, 8)
    val, col = jsf.to_blocked_ell(dense, bw=8)
    b = RNG.standard_normal(64)
    want = jcg.cg_solve_bell(jnp.asarray(val), jnp.asarray(col), jnp.asarray(b), tol=1e-10,
                             mode="xla", record_plain=record_plain)
    got = cg.cg_solve_bell(*_t(val, col, b), tol=1e-10, record_plain=record_plain)
    assert got.converged and want.converged
    assert got.iters == want.iters
    assert got.history == want.history
    np.testing.assert_allclose(got.history_plain, want.history_plain, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-12)
    assert np.linalg.norm(dense @ got.x.numpy() - b) / np.linalg.norm(b) < 1e-9
