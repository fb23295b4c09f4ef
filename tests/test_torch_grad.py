"""The emulated dots' gradients (``Ozaki2Dot``, ``Ozaki1Dot`` behind
``Policy.dot``) against ``jax.grad`` of the reference's custom VJPs, on the CPU.

Bitwise under all three emulated policies, with leading dims and in float32
compute; against native float64 within 16 u of |g|·|Bᵀ| and |Aᵀ|·|g|.  Inputs
keep off right-hand-side widths 9 and 13 (the reference's jitted product is
wrong there, ROADMAP queue 3 item 9), row maxima just below a power of two
(item 1) and subnormals (item 6).  Also: the backward runs under the forward's
dispatch and telemetry modes wherever it runs, and ``kahan_sum`` is bitwise.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import numerics as jnumerics  # noqa: E402
from repro.core.policy import Policy as JPolicy  # noqa: E402
from repro_torch.core import dispatch, numerics  # noqa: E402
from repro_torch.core.policy import Policy  # noqa: E402
from repro_torch.obs import telemetry as obs  # noqa: E402

U = 2.0 ** -53
EMULATED = ("ozaki2_int8", "ozaki2_fp8", "ozaki1_int8")
# (x's shape, w's shape): leading dims, a GEMV-width forward, a float32-sized
# contraction; every right-hand-side width (n, and k for dA) avoids 9 and 13
SHAPES = [((2, 3, 48), (48, 20)), ((5, 32), (32, 3)), ((2, 2, 2, 40), (40, 64))]


def _operands(xs, ws, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(dtype)
    w = rng.standard_normal(ws).astype(dtype)
    c = rng.standard_normal(xs[:-1] + ws[-1:]).astype(dtype)
    return x, w, c


def _torch_grads(name, x, w, c):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = Policy(name).dot(xt, wt)
    (out * torch.from_numpy(c)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


def _jax_grads(name, x, w, c):
    def loss(xj, wj):
        return jnp.sum(JPolicy(name).dot(xj, wj) * jnp.asarray(c))

    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("name", EMULATED)
@pytest.mark.parametrize("shapes", SHAPES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gradients_bitwise_equal_jax_grad(name, shapes, dtype):
    x, w, c = _operands(*shapes, dtype, seed=sum(shapes[0]) + len(name))
    _, dx, dw = _torch_grads(name, x, w, c)
    jdx, jdw = _jax_grads(name, x, w, c)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    assert dx.shape == x.shape and dw.shape == w.shape
    np.testing.assert_array_equal(dx, jdx)
    np.testing.assert_array_equal(dw, jdw)


@pytest.mark.parametrize("name", EMULATED)
@pytest.mark.parametrize("shapes", SHAPES)
def test_gradients_within_16u_of_float64(name, shapes):
    x, w, c = _operands(*shapes, np.float64, seed=7)
    _, dx, dw = _torch_grads(name, x, w, c)
    x2, c2 = x.reshape(-1, x.shape[-1]), c.reshape(-1, c.shape[-1])
    # dA = g·Wᵀ and dB = Aᵀ·g with g = c
    err_x = np.abs(dx.reshape(x2.shape) - c2 @ w.T) / (np.abs(c2) @ np.abs(w.T))
    err_w = np.abs(dw - x2.T @ c2) / (np.abs(x2.T) @ np.abs(c2))
    assert err_x.max() <= 16 * U and err_w.max() <= 16 * U
    if name == "ozaki2_fp8":   # the same integers on both substrates
        _, dx8, dw8 = _torch_grads("ozaki2_int8", x, w, c)
        np.testing.assert_array_equal(dx, dx8)
        np.testing.assert_array_equal(dw, dw8)


def test_short_contraction_error_is_the_schemes():
    """dW = xᵀ g contracts over x's rows.  Over 16 rows with a widely ranging g,
    the error of both schemes exceeds 16 u of |xᵀ||g| (Phase 1 rounds every
    element to its column's largest, and a short sum cannot average that out),
    in the port and the reference alike, and stays within
    u (α_i ||g_j||_1 + ||xᵀ_i||_1 β_j) + 16 u (|xᵀ||g|)_ij (α_i, β_j: the largest
    magnitudes of row i and column j)."""
    rng = np.random.default_rng(15)
    x = rng.standard_normal((16, 48))
    w = rng.standard_normal((48, 40))
    c = rng.standard_normal((16, 40)) * np.exp(2 * rng.standard_normal((16, 40)))
    exact = (x.T.astype(np.longdouble) @ c.astype(np.longdouble))
    absxy = np.abs(x.T) @ np.abs(c)
    bound = U * (np.abs(x.T).max(1, keepdims=True) * np.abs(c).sum(0, keepdims=True)
                 + np.abs(x.T).sum(1, keepdims=True) * np.abs(c).max(0, keepdims=True)) \
        + 16 * U * absxy
    for name in ("ozaki2_int8", "ozaki1_int8"):
        _, _, dw = _torch_grads(name, x, w, c)
        np.testing.assert_array_equal(dw, _jax_grads(name, x, w, c)[1])
        err = np.abs(dw - exact)
        assert (err / absxy).max() > 16 * U
        assert (err <= bound).all()


def test_backward_follows_the_forwards_modes_on_another_thread():
    """The forward's dispatch mode and telemetry mode ride in the autograd
    context: a backward run on a thread (or in a scope) that sees neither still
    runs their route and records its products."""
    x, w, c = _operands((3, 24), (24, 20), np.float64, seed=11)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    obs.reset()
    try:
        with dispatch.mode_scope("ref"), obs.telemetry_scope("trace"):
            out = Policy("ozaki2_int8").dot(xt, wt)
        loss = (out * torch.from_numpy(c)).sum()
        errors = []

        def backward():
            try:
                with dispatch.mode_scope("kernel"):   # raises on CPU tensors, if seen
                    loss.backward()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        th = threading.Thread(target=backward)
        th.start()
        th.join(timeout=120)
        assert not th.is_alive() and errors == []
        evs = obs.trace_snapshot()
    finally:
        obs.reset()
    assert [(e.kind, e.shape_class, e.route) for e in evs] == [
        ("gemm", "4x32x32", "ref"), ("gemm", "4x32x32", "ref"), ("gemm", "32x4x32", "ref")]
    plans = [dispatch.get_plan(24), dispatch.get_plan(20), dispatch.get_plan(3)]
    assert [e.r for e in evs] == [p.r for p in plans]
    _, dx, dw = _torch_grads("ozaki2_int8", x, w, c)
    np.testing.assert_array_equal(xt.grad.numpy(), dx)
    np.testing.assert_array_equal(wt.grad.numpy(), dw)


def test_backward_computes_only_the_gradients_needed():
    x, w, c = _operands((4, 16), (16, 24), np.float64, seed=12)
    obs.reset()
    try:
        with obs.telemetry_scope("counters"):
            xt = torch.from_numpy(x).requires_grad_(True)
            (Policy("ozaki2_int8").dot(xt, torch.from_numpy(w)) * torch.from_numpy(c)).sum() \
                .backward()
            wt = torch.from_numpy(w).requires_grad_(True)
            (Policy("ozaki2_int8").dot(torch.from_numpy(x), wt) * torch.from_numpy(c)).sum() \
                .backward()
        calls = sum(v["calls"] for v in obs.counters_snapshot().values())
    finally:
        obs.reset()
    assert calls == 4          # two forwards, one product in each backward
    _, dx, dw = _torch_grads("ozaki2_int8", x, w, c)
    np.testing.assert_array_equal(xt.grad.numpy(), dx)
    np.testing.assert_array_equal(wt.grad.numpy(), dw)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_kahan_sum_bitwise_equal_reference(dtype, axis):
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((6, 37, 5)) * np.exp(rng.uniform(-8, 8, (6, 37, 5)))).astype(dtype)
    got = numerics.kahan_sum(torch.from_numpy(x), axis=axis)
    want = np.asarray(jnumerics.kahan_sum(jnp.asarray(x), axis=axis))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_numerics_compensated_dot_alias():
    rng = np.random.default_rng(14)
    x, y = rng.standard_normal(1000), rng.standard_normal(1000)
    got = numerics.compensated_dot(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnumerics.compensated_dot(
        jnp.asarray(x), jnp.asarray(y))))
