"""repro_torch compensated reductions and dense CG held against repro (CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compensated as jcm  # noqa: E402
from repro.hpc import cg as jcg, spmv_formats  # noqa: E402
from repro_torch.core import compensated as tcm  # noqa: E402
from repro_torch.hpc import cg as tcg  # noqa: E402
from repro_torch.kernels import carry_fold  # noqa: E402

RNG = np.random.default_rng(3)


def _ulps(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b))))


@pytest.mark.parametrize("n", [1, 7, 513, 4096, 70001])
@pytest.mark.parametrize("scale", [1.0, 1e-200, 1e200])
def test_compensated_reductions_bitwise(n, scale):
    x = RNG.standard_normal(n) * scale
    y = RNG.standard_normal(n)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    assert float(tcm.neumaier_sum(tx)) == float(jcm.neumaier_sum(jx))
    assert float(tcm.compensated_dot(tx, ty)) == float(jcm.compensated_dot(jx, jy))
    assert float(tcm.compensated_norm(tx)) == float(jcm.compensated_norm(jx))


def test_compensated_reductions_batched_axis_and_edge_cases():
    x = RNG.standard_normal((5, 300))
    y = RNG.standard_normal((5, 300))
    for axis in (0, 1, -1):    # axis 0: 300 norms of length 5
        np.testing.assert_array_equal(
            tcm.compensated_dot(torch.from_numpy(x), torch.from_numpy(y), axis=axis).numpy(),
            np.asarray(jcm.compensated_dot(jnp.asarray(x), jnp.asarray(y), axis=axis)))
        np.testing.assert_array_equal(
            tcm.neumaier_sum(torch.from_numpy(x), axis=axis).numpy(),
            np.asarray(jcm.neumaier_sum(jnp.asarray(x), axis=axis)))
        np.testing.assert_array_equal(
            tcm.compensated_norm(torch.from_numpy(x), axis=axis).numpy(),
            np.asarray(jcm.compensated_norm(jnp.asarray(x), axis=axis)))
    edge = np.array([[0.0, 0.0], [np.inf, 1.0], [np.nan, np.inf], [3.0, -4.0]])
    np.testing.assert_array_equal(tcm.compensated_norm(torch.from_numpy(edge), axis=1).numpy(),
                                  np.array([0.0, np.inf, np.nan, 5.0]))


def test_blocked_reductions_within_one_ulp_of_scan_references():
    x = RNG.standard_normal(600) * np.exp(RNG.uniform(-10, 10, 600))
    y = RNG.standard_normal(600)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert _ulps(tcm.neumaier_sum(tx), tcm.neumaier_sum_scan(tx)) <= 1
    assert _ulps(tcm.compensated_dot(tx, ty), tcm.compensated_dot_scan(tx, ty)) <= 1
    assert float(tcm.compensated_dot_scan(tx, ty)) == \
        float(jcm.compensated_dot_scan(jnp.asarray(x), jnp.asarray(y)))
    assert float(tcm.neumaier_sum_scan(tx)) == float(jcm.neumaier_sum_scan(jnp.asarray(x)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_carry_scan_equals_the_sequential_loop(dtype, batch):
    """The vectorised carry fold gives the bits of the plain loop of two_sums,
    signed zeros, inf and NaN included."""
    def loop(s_b, c_b):
        s = torch.zeros_like(s_b[0])
        c = torch.zeros_like(s_b[0])
        for sb, cb in zip(s_b, c_b):
            s, e = tcm.two_sum(s, sb)
            c = c + (e + cb)
        return s + c

    for nb in (1, 2, 37, 513):
        sb = (RNG.standard_normal((nb,) + batch)
              * np.exp(RNG.uniform(-30, 30, (nb,) + batch))).astype(dtype)
        cb = (RNG.standard_normal((nb,) + batch) * 1e-17).astype(dtype)
        cases = [(sb, cb), (np.full_like(sb, -0.0), np.full_like(cb, -0.0))]
        if nb > 2:
            special = sb.copy()
            special[1], special[-1] = np.inf, np.nan
            cases.append((special, cb))
        for s_b, c_b in cases:
            want = loop(torch.from_numpy(s_b), torch.from_numpy(c_b))
            got = carry_fold.carry_fold(torch.from_numpy(s_b), torch.from_numpy(c_b))
            assert got.dtype == want.dtype and got.shape == want.shape
            g, w = got.numpy(), want.numpy()
            np.testing.assert_array_equal(g, w)          # NaN equals NaN here
            np.testing.assert_array_equal(np.signbit(g[~np.isnan(g)]), np.signbit(w[~np.isnan(w)]))


def test_carry_fold_wrapper_on_the_host():
    """On CPU tensors the wrapper is its plain version and launches nothing; no
    blocks fold to +0; mismatched partials raise."""
    sb = torch.from_numpy(RNG.standard_normal((9, 2, 3)))
    cb = torch.from_numpy(RNG.standard_normal((9, 2, 3)) * 1e-17)
    before = carry_fold.carry_fold.launches
    got = carry_fold.carry_fold(sb, cb)
    assert carry_fold.carry_fold.launches == before and tuple(got.shape) == (2, 3)
    np.testing.assert_array_equal(got.numpy(), carry_fold.carry_fold_ref(sb, cb).numpy())
    empty = carry_fold.carry_fold(sb[:0], cb[:0])
    assert tuple(empty.shape) == (2, 3) and not np.signbit(empty.numpy()).any()
    assert not empty.numpy().any()
    with pytest.raises(ValueError):
        carry_fold.carry_fold(sb, cb[:, :1])
    with pytest.raises(ValueError):
        carry_fold.carry_fold(sb, cb.to(torch.float32))


def _rbf_spd(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, (n, 2))
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return np.exp(-d2 / (2 * 0.3 ** 2)) + 1e-2 * np.eye(n)


@pytest.mark.parametrize("name", ["laplacian", "rbf"])
def test_cg_solve_dense_retraces_reference(name):
    a = spmv_formats.laplacian_2d(6, 6) if name == "laplacian" else _rbf_spd(48, 9)
    b = RNG.standard_normal(a.shape[0])
    want = jcg.cg_solve_dense(jnp.asarray(a), jnp.asarray(b), tol=1e-10, maxiter=300,
                              mode="xla")
    got = tcg.cg_solve_dense(torch.from_numpy(a), torch.from_numpy(b), tol=1e-10,
                             maxiter=300)
    assert got.converged and want.converged
    assert got.iters == want.iters
    assert got.history == want.history
    np.testing.assert_allclose(got.history_plain, want.history_plain, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-12)
    assert np.linalg.norm(a @ got.x.numpy() - b) / np.linalg.norm(b) < 1e-9


def test_cg_record_plain_off():
    a = spmv_formats.laplacian_1d(32)
    b = torch.from_numpy(RNG.standard_normal(32))
    res = tcg.cg_solve(lambda x: torch.from_numpy(a) @ x, b, tol=1e-10, record_plain=False)
    assert res.converged and res.history_plain == []
    assert len(res.history) == res.iters + 1
