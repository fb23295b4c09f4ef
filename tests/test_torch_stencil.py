"""repro_torch's 7-point stencil and weighted Jacobi held bitwise against repro (CPU).

repro runs its ``xla`` route (``stencil7_ref``), which its own tests hold bitwise
equal to the Pallas kernel; the port's kernel wrapper takes its plain version
for CPU tensors.  Inputs are made with numpy from a seed, away from the ulps just
below a power of two (where torch's and XLA's log2 differ) and from denormals.

The ds output representation is the one exception to bitwise equality with
repro's jitted route: XLA-CPU contracts the multiply-adds of the jitted ds
epilogue into FMAs (ROADMAP queue 3), which the port, like the CUDA kernels
built with --fmad=false, does not.  There the port is held bitwise to repro's
eager (uncontracted) ``digits_to_ds`` on the same digits, and to repro's jitted
route within the ds representation's 2^-44 of the stencil's scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dispatch as jd  # noqa: E402
from repro.hpc import jacobi as jj  # noqa: E402
from repro.kernels import common as jc, ops as jops, ozaki_stencil as js  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import dispatch, splitting  # noqa: E402
from repro_torch.core.moduli import DEFAULT_MODULI  # noqa: E402
from repro_torch.hpc import jacobi  # noqa: E402
from repro_torch.kernels import common, ops, ozaki_stencil, ref  # noqa: E402

RNG = np.random.default_rng(23)
U = 2.0 ** -53
LAPLACE = np.array([-6.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])


def _grid(shape, scale=1.0):
    return RNG.standard_normal(shape) * scale


def _coeffs(kind):
    if kind == "laplace":
        return LAPLACE
    if kind == "spacings":
        return np.array(jj.laplacian_coeffs([0.5, 1.25, 3.0]))
    return RNG.standard_normal(7)          # anisotropic, no symmetry


def _plans():
    return jd.get_plan(8, margin_bits=4), dispatch.get_plan(8, margin_bits=4)


def _eager_ds(u, c):
    """repro's ds epilogue, run op by op (no FMA contraction), on the port's digits."""
    jp, tp = _plans()
    u_hi, u_lo, c_res, shift = ozaki_stencil._decompose(torch.from_numpy(u),
                                                        torch.from_numpy(c), tp)
    d8 = ozaki_stencil._contract_ref(u_hi, u_lo, c_res, tp, "digits").numpy()
    hi, lo = jc.digits_to_ds([jnp.asarray(d.astype(np.int32)) for d in d8], jp)
    v = np.asarray(hi).astype(np.float64) + np.asarray(lo).astype(np.float64)
    return np.asarray(jnp.ldexp(jnp.asarray(v), -int(shift)))


def assert_matches(got, want, out_rep, u, c):
    """Bitwise, except ds against repro's jitted route (see the module docstring)."""
    if out_rep != "ds":
        np.testing.assert_array_equal(got, want)
        return
    np.testing.assert_array_equal(got, _eager_ds(u, c))
    scale = 7 * np.abs(u).max() * np.abs(c).max()
    assert np.max(np.abs(got - want)) <= 2.0 ** -44 * scale


@pytest.mark.parametrize("shape", [(6, 5, 7), (4, 3, 13), (1, 1, 5)])
@pytest.mark.parametrize("coeffs", ["laplace", "spacings", "anisotropic"])
@pytest.mark.parametrize("out_rep", ["f64", "digits", "ds"])
def test_stencil7_ref_bitwise(shape, coeffs, out_rep):
    u, c = _grid(shape), _coeffs(coeffs)
    jp, tp = _plans()
    want = np.asarray(js.stencil7_ref(jnp.asarray(u), jnp.asarray(c), jp, out_rep=out_rep))
    got = ozaki_stencil.stencil7_ref(torch.from_numpy(u), torch.from_numpy(c), tp, out_rep)
    assert got.dtype == torch.float64 and tuple(got.shape) == shape
    assert_matches(got.numpy(), want, out_rep, u, c)
    # the kernel wrapper takes the plain version for CPU tensors, and launches nothing
    before = ozaki_stencil.stencil7.launches
    np.testing.assert_array_equal(
        ozaki_stencil.stencil7(torch.from_numpy(u), torch.from_numpy(c), tp, out_rep,
                               bz=64, by=4).numpy(),
        got.numpy())
    assert ozaki_stencil.stencil7.launches == before


@pytest.mark.parametrize("out_rep", ["f64", "digits", "ds"])
def test_dispatch_and_ops_stencil7_match_reference_seam(out_rep):
    u, c = _grid((5, 6, 9), 1e-3), RNG.standard_normal(7) * 1e4   # ragged Z
    want = np.asarray(jd.stencil7(jnp.asarray(u), jnp.asarray(c), out_rep=out_rep,
                                  mode="xla"))
    tu, tc = torch.from_numpy(u), torch.from_numpy(c)
    assert_matches(dispatch.stencil7(tu, tc, out_rep=out_rep).numpy(), want, out_rep, u, c)
    assert_matches(ops.ozaki_stencil7(tu, tc, out_rep=out_rep).numpy(),
                   np.asarray(jops.ozaki_stencil7(jnp.asarray(u), jnp.asarray(c),
                                                  out_rep=out_rep, mode="xla")), out_rep, u, c)


def test_stencil_all_zero_grid_and_coeffs():
    _, tp = _plans()
    zero = torch.zeros((4, 5, 6), dtype=torch.float64)
    c = torch.from_numpy(LAPLACE)
    for rep in ("f64", "digits", "ds"):
        v = ozaki_stencil.stencil7_ref(zero, c, tp, rep)
        assert torch.equal(v, zero) and not torch.signbit(v).any()
    v = ozaki_stencil.stencil7_ref(torch.from_numpy(_grid((4, 5, 6))),
                                   torch.zeros(7, dtype=torch.float64), tp)
    assert torch.equal(v, zero)


@pytest.mark.parametrize("d", range(7))
def test_stencil_boundary_zero_halo(d):
    """Each neighbour direction on its own: the exposed face sees the zero halo,
    not the wrap-around."""
    shape = (4, 5, 6)
    u = np.ones(shape)
    c = np.zeros(7)
    c[d] = 1.0
    v = ops.ozaki_stencil7(torch.from_numpy(u), torch.from_numpy(c)).numpy()
    want = np.ones(shape)
    if d:
        ax, first = (d - 1) // 2, d % 2 == 1     # -x, +x, -y, +y, -z, +z
        idx = [slice(None)] * 3
        idx[ax] = 0 if first else -1
        want[tuple(idx)] = 0.0
    np.testing.assert_array_equal(v, want)
    np.testing.assert_array_equal(v, np.asarray(js.stencil7_ref(
        jnp.asarray(u), jnp.asarray(c), _plans()[0])))


def test_global_scale_and_roll_mask_match_reference():
    for x in (_grid((3, 4, 5)), _grid(7) * 1e-200, _grid((2, 9)) * 3e150, np.zeros(4)):
        xi, s = ozaki_stencil._global_scale_to_int(torch.from_numpy(x), 53)
        jxi, js_ = js._global_scale_to_int(jnp.asarray(x), 53)
        np.testing.assert_array_equal(xi.numpy(), np.asarray(jxi))
        assert int(s) == int(js_) and s.dtype == torch.int32
    arr = RNG.integers(-50, 50, (3, 4, 5)).astype(np.int32)
    for ax in range(3):
        for d in (1, -1):
            t = torch.from_numpy(arr.copy())
            got = ozaki_stencil._roll_mask(t, ax, d)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(js._roll_mask(jnp.asarray(arr), ax, d)))
            np.testing.assert_array_equal(t.numpy(), arr)       # the input is untouched


def test_f64_oracle_matches_reference_oracle():
    u, c = _grid((5, 4, 6)), RNG.standard_normal(7)
    got = ref.stencil7_f64(torch.from_numpy(u), torch.from_numpy(c)).numpy()
    want = np.asarray(jref.stencil7_f64(jnp.asarray(u), jnp.asarray(c)))
    # the same seven products summed left to right: at most a few ulps apart
    scale = 7 * np.abs(u).max() * np.abs(c).max()
    assert np.max(np.abs(got - want)) <= 4 * U * scale


@pytest.mark.parametrize("e", [-3, 0, 1, 40])
def test_stencil_accuracy_at_the_ulp_below_a_power_of_two(e):
    """absmax = nextafter(2^e, 0) is where the Phase-1 exponent of torch and XLA
    may differ (so no bitwise test here); the result still meets the bound of
    tests/test_kernels.py against native FP64."""
    u = _grid((6, 5, 7))
    u *= 0.9 * 2.0 ** e / np.abs(u).max()
    u.flat[11] = -np.nextafter(2.0 ** e, 0.0)
    c = RNG.standard_normal(7)
    c *= 0.9 / np.abs(c).max()
    c[2] = np.nextafter(2.0, 0.0)
    tu, tc = torch.from_numpy(u), torch.from_numpy(c)
    for rep in ("f64", "digits", "ds"):
        v = ops.ozaki_stencil7(tu, tc, out_rep=rep).numpy()
        want = ref.stencil7_f64(tu, tc).numpy()
        scale = 7 * np.abs(u).max() * np.abs(c).max()
        tol = 8 * U if rep != "ds" else 2.0 ** -44
        assert np.max(np.abs(v - want)) <= tol * scale


# ---------------------------------------------------------------------------
# The kernel's own Phase 1 and integer order (csrc/ozaki_stencil.cu), transcribed
# ---------------------------------------------------------------------------

def _kernel_phase1(u, c, payload_bits, elog=None):
    """The kernel's Phase 1 as its scalar sequence: the shifts from ``_scales``
    (or from a given floor(log2) pair), the too-big guard from ldexp of each
    maximum, then per element ldexp, the x0.5, rint and the split by a multiply
    with 2^-26; the residues of c; the total shift."""
    absmax, e = ozaki_stencil._scales(u, c)
    sh = (payload_bits - 1) - (e if elog is None else elog)
    tb = splitting.ldexp(absmax, sh) >= 2.0 ** payload_bits

    def element(x, s, t):
        y = splitting.ldexp(x, s.expand(x.shape))
        y = torch.where(t, y * 0.5, y)
        xi = torch.round(y)
        hd = torch.round(xi * 2.0 ** -26)
        return hd.to(torch.int32), (xi - hd * 67108864.0).to(torch.int32)

    u_hi, u_lo = element(u, sh[0], tb[0])
    c_hi, c_lo = element(c, sh[1], tb[1])
    c_res = torch.stack(common.residues_int32(c_hi, c_lo, DEFAULT_MODULI[:15]))
    return u_hi, u_lo, c_res, (sh[0] - tb[0].to(torch.int32)) + (sh[1] - tb[1].to(torch.int32))


def _with_max(shape, absmax, seed):
    u = np.random.default_rng(seed).standard_normal(shape)
    u *= 0.5 * absmax / np.abs(u).max()
    u.flat[3] = -absmax
    return u


@pytest.mark.parametrize("u", [
    _with_max((4, 5, 6), np.nextafter(2.0 ** 7, 0.0), 1),     # just below a power of two
    _with_max((4, 5, 6), np.nextafter(2.0 ** -600, 0.0), 2),
    _with_max((3, 4, 5), 2.0 ** 53, 3),                       # at 2^payload
    _with_max((3, 4, 5), 1e300, 4),                           # a negative shift
    _with_max((3, 4, 5), 1e-300, 5),                          # a shift past 2^1023
    np.zeros((2, 3, 4)),                                       # all zero
    -np.zeros((2, 3, 4)),                                      # signed zeros
])
def test_fused_phase1_scalar_sequence_equals_decompose(u):
    """max |ldexp(u_i)| = ldexp(max |u_i|): ldexp rounds once and is monotone,
    so the kernel's guard and its per-element sequence give ``_decompose``'s
    (hi, lo), coefficient residues and shift."""
    _, tp = _plans()
    c = RNG.standard_normal(7) * 3e-5
    c[4] = -0.0
    tu, tc = torch.from_numpy(u), torch.from_numpy(c)
    for got, want in zip(_kernel_phase1(tu, tc, tp.payload_bits),
                         ozaki_stencil._decompose(tu, tc, tp)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    xi, s = ozaki_stencil._global_scale_to_int(tu, tp.payload_bits)
    a, e = ozaki_stencil._scales(tu, tc)
    assert float(a[0]) == float(np.abs(u).max()) and int(s) == (tp.payload_bits - 1) - int(
        e[0]) - int(splitting.ldexp(a[:1], (tp.payload_bits - 1) - e[:1]) >= 2.0 ** 53)


def test_fused_phase1_too_big_guard():
    """With floor(log2) one short the guard fires, and ldexp of the maximum
    decides it as the maximum over every |ldexp(u_i)| does."""
    _, tp = _plans()
    u = torch.from_numpy(_with_max((3, 4, 5), 2.0 ** 10, 6))
    c = torch.from_numpy(RNG.standard_normal(7))
    _, e = ozaki_stencil._scales(u, c)
    low = e - 1
    u_hi, u_lo, _, shift = _kernel_phase1(u, c, tp.payload_bits, elog=low)
    sh = (tp.payload_bits - 1) - low[0]
    scaled = splitting.ldexp(u, sh.expand(u.shape))
    assert bool(scaled.abs().amax() >= 2.0 ** 53)
    xi = torch.round(scaled * 0.5)
    hi, lo = splitting.split_hi_lo(xi)
    np.testing.assert_array_equal(u_hi.numpy(), hi.numpy())
    np.testing.assert_array_equal(u_lo.numpy(), lo.numpy())


def _balanced(v, m):
    r = np.remainder(v, m)
    return np.where(r > (m - 1) // 2, r - m, r)


def _residue_hilo(hi, lo, m):
    """residue_hilo (csrc/ozaki_common.cuh) in numpy: for m = 256 the signed low
    byte of lo; else q = the low word of fl(hi (2^26 mod m) + lo) * fl(1/m)
    + 1.5 * 2^52, and z - q m in 32-bit wrap-around."""
    if m == 256:
        return lo.astype(np.uint8).view(np.int8).astype(np.int64)
    c = (1 << 26) % m
    y = (hi.astype(np.float64) * float(c) + lo.astype(np.float64)) * (1.0 / m)
    q = (y + 6755399441055744.0).view(np.uint64).astype(np.int64) & 0xFFFFFFFF
    r = ((hi * c + lo) - q * m) & 0xFFFFFFFF
    return np.where(r >= 2 ** 31, r - 2 ** 32, r)


def _garner_lazy(acc, plan):
    """garner_digits_lazy (csrc/ozaki_common.cuh): carries summed unreduced."""
    gc, ms = plan.garner, plan.moduli
    carry = [np.zeros_like(acc[0]) for _ in ms]
    digits = []
    for j, m in enumerate(ms):
        t = _balanced((acc[j] - carry[j]) * int(gc.inv_pref[j]), m)
        assert np.abs((acc[j] - carry[j]) * int(gc.inv_pref[j])).max() < 2 ** 31
        digits.append(t)
        for k in range(j + 1, len(ms)):
            carry[k] = carry[k] + t * int(gc.pref_mod[j, k])
    return digits


def _transpose4(w):
    """The kernel's byte transpose of four words: word k holds byte k of each."""
    b = np.stack([(w[i] >> (8 * k)) & 0xFF for i in range(4) for k in range(4)]).reshape(4, 4,
                                                                                          *w[0].shape)
    return [sum(b[i, k] << (8 * i) for i in range(4)) for k in range(4)]


def _dp4a(a, b, c):
    sa = [((a >> (8 * k)) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)
          for k in range(4)]
    sb = [((b >> (8 * k)) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)
          for k in range(4)]
    return c + sum(x * y for x, y in zip(sa, sb))


@pytest.mark.parametrize("shape", [(5, 6, 7), (1, 1, 3), (3, 9, 2)])
def test_kernel_integer_order_equals_plain_contraction(shape):
    """Per point, the residues four to a word, the neighbours' words
    byte-transposed, two dp4a per modulus with the coefficients' words, the sums
    left unreduced, the lazy Garner digits: the plain contraction's raw output
    in every representation."""
    _, tp = _plans()
    u, c = torch.from_numpy(_grid(shape)), torch.from_numpy(RNG.standard_normal(7))
    u_hi, u_lo, c_res, _ = ozaki_stencil._decompose(u, c, tp)
    hi = np.pad(u_hi.numpy().astype(np.int64), 1)              # the zero halo
    lo = np.pad(u_lo.numpy().astype(np.int64), 1)
    r = [_residue_hilo(hi, lo, m) for m in tp.moduli] + [np.zeros_like(hi)]
    words = [sum((r[4 * g + k] & 0xFF) << (8 * k) for k in range(4)) for g in range(4)]
    X, Y, Z = shape
    centre = (slice(1, X + 1), slice(1, Y + 1), slice(1, Z + 1))

    def at(w, ax, d):
        idx = list(centre)
        idx[ax] = slice(1 + d, (X, Y, Z)[ax] + 1 + d)
        return w[tuple(idx)]

    cr = c_res.numpy().astype(np.int64)
    cw = [[sum((cr[i, d + 4 * h] & 0xFF if d + 4 * h < 7 else 0) << (8 * d) for d in range(4))
           for h in range(2)] for i in range(tp.r)]
    acc = []
    for g in range(4):
        w = words[g]
        ta = _transpose4([w[centre], at(w, 0, -1), at(w, 0, 1), at(w, 1, -1)])
        tb = _transpose4([at(w, 1, 1), at(w, 2, -1), at(w, 2, 1), np.zeros_like(w[centre])])
        for k in range(4):
            if 4 * g + k < tp.r:
                i = 4 * g + k
                acc.append(_dp4a(ta[k], np.int64(cw[i][0]), _dp4a(tb[k], np.int64(cw[i][1]), 0)))
    assert max(np.abs(a).max() for a in acc) <= 7 * 128 * 128
    digits = [torch.from_numpy(d.astype(np.int32)) for d in _garner_lazy(acc, tp)]
    for rep in ("f64", "digits", "ds"):
        np.testing.assert_array_equal(
            common.represent(digits, tp, rep).numpy(),
            ozaki_stencil._contract_ref(u_hi, u_lo, c_res, tp, rep).numpy())


# ---------------------------------------------------------------------------
# weighted Jacobi
# ---------------------------------------------------------------------------

def test_laplacian_coeffs_and_operator_match_reference():
    for sp in (None, [0.5, 1.25, 3.0]):
        np.testing.assert_array_equal(jacobi.laplacian_coeffs(sp).numpy(),
                                      np.asarray(jj.laplacian_coeffs(sp)))
    u = _grid((5, 6, 4))
    np.testing.assert_array_equal(
        jacobi.apply_dirichlet_laplacian(torch.from_numpy(u), [0.5, 1.0, 2.0]).numpy(),
        np.asarray(jj.apply_dirichlet_laplacian(jnp.asarray(u), [0.5, 1.0, 2.0], mode="xla")))


@pytest.mark.parametrize("case", [
    {"shape": (5, 5, 5), "spacings": None, "omega": 1.0, "tol": 1e-6, "maxiter": 200},
    {"shape": (6, 5, 4), "spacings": [0.5, 1.25, 3.0], "omega": 2.0 / 3.0, "tol": 1e-7,
     "maxiter": 300},
    {"shape": (6, 5, 4), "spacings": [0.5, 1.25, 3.0], "omega": 2.0 / 3.0, "tol": 0.0,
     "maxiter": 12, "check_every": 5},
])
def test_jacobi_solve_retraces_reference(case):
    case = dict(case)
    f = _grid(case.pop("shape"))
    want = jj.jacobi_solve(jnp.asarray(f), mode="xla", **case)
    got = jacobi.jacobi_solve(torch.from_numpy(f), **case)
    assert got.iters == want.iters and got.converged == want.converged
    assert got.history == want.history
    assert got.residual == want.residual
    np.testing.assert_array_equal(got.u.numpy(), np.asarray(want.u))
    if case["tol"] > 0:
        assert got.converged


def test_jacobi_zero_rhs_and_bad_shape():
    res = jacobi.jacobi_solve(torch.zeros((3, 3, 3), dtype=torch.float64), tol=1e-8)
    assert res.iters == 0 and res.history == [0.0] and res.converged
    with pytest.raises(ValueError):
        jacobi.jacobi_solve(torch.zeros((3, 3), dtype=torch.float64))
