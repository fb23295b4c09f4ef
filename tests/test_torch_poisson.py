"""repro_torch.hpc.poisson held against repro.hpc.poisson (CPU).

Tolerances: the eigenvalues, the periodic Laplacian, the odd extension and the
manufactured right-hand side are bitwise equal to ``repro`` (the same numpy and
elementwise ops).  A solve is a forward FFT, a division of each mode by its
eigenvalue and an inverse FFT: the transforms agree with ``repro`` within
``dft_error_bound`` (``tests/test_torch_spectral.py``), and the division grows
that error by at most the operator's condition number max|λ| / min|λ ≠ 0|.  So
a solve is held to ``repro`` within κ · Σ_axes 2·dft_error_bound(n) · max|u|.
Every grid here is a product of dense lengths (<= 64), so the transforms'
GEMMs are bitwise equal and the bound is not approached.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dispatch as jdispatch  # noqa: E402
from repro.hpc import poisson as jpoisson  # noqa: E402
from repro_torch import spectral  # noqa: E402
from repro_torch.hpc import jacobi, poisson  # noqa: E402

RNG = np.random.default_rng(31)
SHAPES = ((64,), (24, 32), (8, 12, 16))


def _bound(shape, u):
    lam = np.abs(poisson.laplacian_eigenvalues(shape))
    kappa = lam.max() / lam[lam > 0].min()
    return kappa * sum(2 * spectral.dft_error_bound(n) for n in shape) * np.abs(u).max()


@pytest.mark.parametrize("shape,spacings", [((64,), None), ((24, 32), (0.5, 2.0)),
                                            ((8, 12, 16), None)])
def test_eigenvalues_laplacian_and_rhs_bitwise(shape, spacings):
    np.testing.assert_array_equal(poisson.laplacian_eigenvalues(shape, spacings),
                                  jpoisson.laplacian_eigenvalues(shape, spacings))
    f, u = poisson.manufactured_rhs(shape, spacings, seed=5)
    jf, ju = jpoisson.manufactured_rhs(shape, spacings, seed=5)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(poisson.apply_periodic_laplacian(u, spacings).numpy(),
                                  np.asarray(jpoisson.apply_periodic_laplacian(ju, spacings)))


@pytest.mark.parametrize("shape", SHAPES)
def test_periodic_solve_within_bound_of_reference(shape):
    f, u_exact = poisson.manufactured_rhs(shape, seed=3)
    u = poisson.poisson_solve_periodic(f)
    with jdispatch.mode_scope("xla"):
        want = np.asarray(jpoisson.poisson_solve_periodic(jnp.asarray(f.numpy())))
    assert u.dtype == torch.float64 and tuple(u.shape) == shape
    assert np.abs(u.numpy() - want).max() <= _bound(shape, want)
    # the reference's own acceptance bound on the manufactured solution
    np.testing.assert_allclose(u.numpy(), u_exact.numpy(), rtol=0, atol=1e-10)


def test_checked_solve_reports_true_residual():
    f = torch.from_numpy(RNG.standard_normal((24, 32)))
    res = poisson.poisson_solve_checked(f)
    with jdispatch.mode_scope("xla"):
        want = jpoisson.poisson_solve_checked(jnp.asarray(f.numpy()))
    assert res.residual <= 1e-12 and want.residual <= 1e-12
    assert abs(float(res.u.mean())) <= 1e-12                      # zero-mean gauge
    assert np.abs(res.u.numpy() - np.asarray(want.u)).max() <= _bound((24, 32), want.u)
    with pytest.raises(ValueError, match="CUDA"):
        poisson.poisson_solve_checked(f, mode="kernel")


def test_odd_extension_bitwise():
    f = RNG.standard_normal((3, 5, 7))
    g = poisson.odd_extension(torch.from_numpy(f))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jpoisson.odd_extension(jnp.asarray(f))))
    assert tuple(g.shape) == (8, 12, 16) and float(g.sum()) == 0.0


def test_dirichlet_solve_3d_within_bound_of_reference():
    """A 3 x 5 x 7 interior extends to 8 x 12 x 16; the solution satisfies the
    zero-halo 7-point operator that ``jacobi`` applies through ``stencil7``."""
    f = RNG.standard_normal((3, 5, 7))
    u = poisson.poisson_solve_dirichlet(torch.from_numpy(f))
    with jdispatch.mode_scope("xla"):
        want = np.asarray(jpoisson.poisson_solve_dirichlet(jnp.asarray(f)))
    assert tuple(u.shape) == (3, 5, 7)
    assert np.abs(u.numpy() - want).max() <= _bound((8, 12, 16), want)
    back = jacobi.apply_dirichlet_laplacian(u)
    np.testing.assert_allclose(back.numpy(), f, rtol=0, atol=1e-9)


def test_dirichlet_solve_1d_matches_dense():
    n = 30
    f = RNG.standard_normal(n)
    u = poisson.poisson_solve_dirichlet(torch.from_numpy(f), spacings=(0.25,)).numpy()
    lap = (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
           + np.diag(np.ones(n - 1), -1)) / 0.0625
    np.testing.assert_allclose(lap @ u, f, rtol=0, atol=1e-11)
