"""repro_torch.core.dispatch: shape contract, routing and modes (CPU)."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dispatch as jd  # noqa: E402
from repro_torch.core import dispatch, ozaki2  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RNG = np.random.default_rng(5)


def _ab(m, k, n):
    return (torch.from_numpy(RNG.standard_normal((m, k))),
            torch.from_numpy(RNG.standard_normal((k, n))))


@pytest.mark.parametrize("mkn", [(24, 48, 16), (24, 48, 17), (40, 70, 24), (33, 97, 1)])
def test_matmul_matches_reference_seam(mkn):
    a, b = _ab(*mkn)
    got = dispatch.matmul(a, b)
    want = jd.matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), mode="xla")
    assert got.dtype == torch.float64 and tuple(got.shape) == (mkn[0], mkn[2])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dot_leading_dims():
    x = torch.from_numpy(RNG.standard_normal((2, 3, 40)))
    w = torch.from_numpy(RNG.standard_normal((40, 6)))
    out = dispatch.dot(x, w)
    assert tuple(out.shape) == (2, 3, 6)
    np.testing.assert_array_equal(out.reshape(6, 6).numpy(),
                                  dispatch.matmul(x.reshape(6, 40), w).numpy())


@pytest.mark.parametrize("n,kind", [(1, "gemv"), (16, "gemv"), (17, "gemm"), (24, "gemm")])
def test_kernel_route_split_and_padding_bitwise(monkeypatch, n, kind):
    """The kernel route's gemv/gemm split at GEMV_MAX_B, with ragged padding,
    run through the kernel wrappers' plain versions on the CPU, is bitwise equal
    to the reference route."""
    calls = []
    for name in ("ozaki_gemm", "ozaki_gemv"):
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(ops, name, spy)
    a, b = _ab(37, 75, n)
    plan = dispatch.get_plan(75)
    got = dispatch._kernel_matmul(a, b, plan)
    assert calls == [f"ozaki_{kind}"]
    np.testing.assert_array_equal(got.numpy(), dispatch.matmul(a, b, mode="ref").numpy())


def test_auto_resolves_by_device_and_kernel_mode_needs_cuda():
    plan = dispatch.get_plan(64)
    for kind in ("gemm", "gemv"):
        assert dispatch.choose_route(plan, kind, device=torch.device("cpu")) == "ref"
        assert dispatch.choose_route(plan, kind, device=torch.device("cuda")) == "kernel"
        assert dispatch.choose_route(plan, kind, mode="ref",
                                     device=torch.device("cuda")) == "ref"
        assert dispatch.choose_route(plan, kind, mode="kernel") == "kernel"
    # the compensated reductions route like the kernels, with or without a plan
    for p in (plan, None):
        assert dispatch.choose_route(p, "reduce", device=torch.device("cpu")) == "ref"
        assert dispatch.choose_route(p, "reduce", device=torch.device("cuda")) == "kernel"
        assert dispatch.choose_route(p, "reduce", mode="kernel") == "kernel"
        assert dispatch.choose_route(p, "reduce", mode="ref",
                                     device=torch.device("cuda")) == "ref"
    assert dispatch.choose_route(dispatch.get_plan(64, substrate="fp8"), "gemm",
                                 mode="kernel") == "ref"
    a, b = _ab(8, 64, 4)
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.matmul(a, b, mode="kernel")
    with dispatch.mode_scope("kernel"), pytest.raises(ValueError, match="CUDA"):
        dispatch.matmul(a, b)
    with pytest.raises(ValueError):
        dispatch.matmul(a, b, mode="pallas")
    with pytest.raises(ValueError):
        dispatch.choose_route(plan, "fft")
    for kind in ("spmv_bell", "stencil7", "attention"):
        assert dispatch.choose_route(plan, kind, device=torch.device("cpu")) == "ref"
        assert dispatch.choose_route(plan, kind, device=torch.device("cuda")) == "kernel"
        assert dispatch.choose_route(plan, kind, mode="kernel") == "kernel"
    u, c = torch.zeros((3, 4, 5), dtype=torch.float64), torch.ones(7, dtype=torch.float64)
    val, col = torch.ones((6, 3), dtype=torch.float64), torch.zeros((6, 3), dtype=torch.int32)
    x = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.stencil7(u, c, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.spmv(val, col, x, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.attention(u, u, u, mode="kernel")
    with dispatch.mode_scope("kernel"):
        with pytest.raises(ValueError, match="CUDA"):
            ops.ozaki_stencil7(u, c)
        with pytest.raises(ValueError, match="CUDA"):
            ops.ozaki_spmv_bell(val, col, x)
        with pytest.raises(ValueError, match="CUDA"):
            ops.ozaki_attention(u, u, u)


@pytest.mark.parametrize("mkn", [(1, 1, 1), (1000, 1537, 777), (1000, 1537, 5),
                                 (130, 65, 16), (130, 65, 17), (8192, 8192, 8192)])
def test_choose_blocks_legal_for_the_kernels(mkn):
    m, k, n = mkn
    bm, bn, bk = dispatch.choose_blocks(m, k, n)
    assert bk % 32 == 0
    if n <= dispatch.GEMV_MAX_B:
        assert bm % 8 == 0 and bn == n
    else:
        assert bm % 128 == 0 and bn % 128 == 0 and bk % 64 == 0
    a, b = torch.zeros((m, k)), torch.zeros((k, n))
    ap, bp, _ = dispatch.pad_operands(a, b, (bm, bn, bk))
    assert ap.shape[0] % bm == 0 and ap.shape[1] % bk == 0
    assert bp.shape[0] == ap.shape[1] and bp.shape[1] % bn == 0


def test_mode_scope_is_thread_local():
    seen = {}
    entered, release = threading.Event(), threading.Event()

    def worker():
        with dispatch.mode_scope("kernel"):
            seen["inside"] = dispatch.get_mode()
            entered.set()
            release.wait(10)
        seen["after"] = dispatch.get_mode()

    t = threading.Thread(target=worker)
    t.start()
    assert entered.wait(10)
    seen["main"] = dispatch.get_mode()
    release.set()
    t.join(10)
    assert not t.is_alive()
    assert seen == {"inside": "kernel", "main": "auto", "after": "auto"}
    with dispatch.mode_scope("ref"):
        with dispatch.mode_scope(None):
            assert dispatch.get_mode() == "ref"
    assert dispatch.get_mode() == "auto"


def test_plan_cache_and_tuning():
    assert dispatch.get_plan(96) is dispatch.get_plan(96)
    assert dispatch.get_plan(96) == ozaki2.make_plan(96)
    assert dispatch.get_plan(8192, margin_bits=4).r == 16 == dispatch.get_plan(8192).r
    assert dispatch.plan_cache_info().hits >= 1
    assert dispatch.shape_class((100, 64, 24)) == "128x64x32"
    assert dispatch.reduce_block(8192) == 512
    assert dispatch.reduce_block(40000) == 256
    with pytest.raises(ValueError):
        dispatch.get_tuning("fft", (8,))


def test_tuning_of_the_sparse_and_stencil_kinds():
    assert dispatch.get_tuning("spmv_bell", (1124864, 27)) == {"br": 128}
    assert dispatch.get_tuning("stencil7", (256, 256, 256)) == {"bz": 32, "by": 8, "bx": 64}
    for kind in ("spmv_bell", "stencil7"):
        assert kind in dispatch.KINDS and kind in dispatch.AUTO_ROUTE
        assert dispatch.kernel_supported(dispatch.get_plan(8, margin_bits=4), kind)
    assert dispatch.get_plan(8, margin_bits=4).r == 15 == dispatch.get_plan(27, margin_bits=4).r
