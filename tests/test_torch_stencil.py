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
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.hpc import jacobi  # noqa: E402
from repro_torch.kernels import ops, ozaki_stencil, ref  # noqa: E402

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
