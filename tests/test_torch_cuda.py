"""The CUDA kernels held bitwise against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  This file imports
no JAX, so it also runs where only torch is installed:
    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spectral  # noqa: E402
from repro_torch.core import compensated, dispatch, ozaki1, ozaki2, splitting  # noqa: E402
from repro_torch.core.policy import Policy  # noqa: E402
from repro_torch.hpc import cg, jacobi, poisson  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build, carry_fold, ozaki_attention, ozaki_gemm, ozaki_gemv, ozaki_spmv, ozaki_stencil)
from repro_torch.models.transformer import Model  # noqa: E402

RNG = np.random.default_rng(17)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _hilo(x, plan, axis):
    xi, _ = splitting.scale_to_int(x, plan.payload_bits, axis)
    return splitting.split_hi_lo(xi)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [
    (128, 64, 128), (256, 192, 384), (64, 96, 5), (8, 32, 1),
    (128, (1 << 17) + 64, 128),     # gemm: accumulators reduced inside the K loop
    (8, (1 << 21) + 32, 1),         # gemv: lane sums reduced inside the K loop
    (384, 320, 640),                # gemm: K past the last 128-deep stage, N / 128 odd
    (1024, 256, 2048),              # gemm: more work items than 132 SMs
    (16, 64, 2), (24, 96, 7), (40, 128, 8), (40, 1024, 9), (256, 192, 16),  # gemv widths
])
@pytest.mark.parametrize("out_rep", ["f64", "digits", "ds"])
def test_cuda_kernel_matches_plain_version(cuda_device, mkn, out_rep):
    m, k, n = mkn
    plan = dispatch.get_plan(k)
    a = torch.from_numpy(RNG.standard_normal((m, k))).to(cuda_device)
    a[0] *= 1e-300                  # a row scaled by more than 2^1023
    b = torch.from_numpy(RNG.standard_normal((k, n))).to(cuda_device)
    ah, al = _hilo(a, plan, -1)
    bh, bl = _hilo(b, plan, 0)
    gemv = n <= ozaki_gemv.MAX_B
    wrapper = ozaki_gemv.gemv_hilo if gemv else ozaki_gemm.gemm_hilo
    plain = ozaki_gemv.gemv_hilo_ref if gemv else ozaki_gemm.gemm_hilo_ref
    before = wrapper.launches
    got = wrapper(ah, al, bh, bl, plan, out_rep)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got, plain(ah, al, bh, bl, plan, out_rep), rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(1000, 1537, 777), (1000, 1537, 5), (33, 70, 16), (33, 70, 17)])
def test_cuda_dispatch_routes_bitwise(cuda_device, mkn):
    m, k, n = mkn
    a = torch.from_numpy(RNG.standard_normal((m, k))).to(cuda_device)
    b = torch.from_numpy(RNG.standard_normal((k, n))).to(cuda_device)
    got = dispatch.matmul(a, b)                      # auto: the kernel on CUDA
    want = dispatch.matmul(a, b, mode="ref")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_kernel_mode_raises_on_bad_shapes(cuda_device):
    plan = dispatch.get_plan(64)
    h = torch.zeros((100, 64), dtype=torch.int32, device=cuda_device)
    x = torch.zeros((64, 128), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        ozaki_gemm.gemm_hilo(h, h, x, x, plan)       # M = 100 does not tile by 128
    with pytest.raises(ValueError):
        ozaki_gemm.gemm_hilo(h[:, :32].t(), h[:, :32].t(), x, x, plan)  # not contiguous


def _randn(dev, *shape):
    return torch.from_numpy(RNG.standard_normal(shape)).to(dev)


def _random_bell(dev, m, n, bw, zero_frac=0.2):
    val = RNG.standard_normal((m, bw)) * np.exp(RNG.uniform(-8, 8, (m, 1)))
    val[RNG.random((m, bw)) < zero_frac] = 0.0
    col = RNG.integers(0, n, (m, bw)).astype(np.int32)
    return (torch.from_numpy(val).to(dev), torch.from_numpy(col).to(dev),
            torch.from_numpy(RNG.standard_normal(n)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 29, 51), (2, 3, 300), (1, 1, 1), (70, 9, 8)])
@pytest.mark.parametrize("block", [(64, 4), (32, 8), (7, 3)])
@pytest.mark.parametrize("out_rep", ["f64", "digits", "ds"])
def test_cuda_stencil_matches_plain_version(cuda_device, shape, block, out_rep):
    plan = dispatch.get_plan(8, margin_bits=4)
    u, c = _randn(cuda_device, *shape), _randn(cuda_device, 7)
    before = ozaki_stencil.stencil7.launches
    got = ozaki_stencil.stencil7(u, c, plan, out_rep, bz=block[0], by=block[1])
    torch.cuda.synchronize()
    assert ozaki_stencil.stencil7.launches == before + 1
    torch.testing.assert_close(got, ozaki_stencil.stencil7_ref(u, c, plan, out_rep),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mnbw", [(1000, 1200, 27), (37, 50, 5), (1, 3, 1), (300, 20, 70)])
@pytest.mark.parametrize("br", [128, 256, 33])
@pytest.mark.parametrize("out_rep", ["f64", "digits", "ds"])
def test_cuda_spmv_matches_plain_version(cuda_device, mnbw, br, out_rep):
    val, col, x = _random_bell(cuda_device, *mnbw)
    plan = dispatch.get_plan(mnbw[2], margin_bits=4)
    before = ozaki_spmv.spmv_bell.launches
    got = ozaki_spmv.spmv_bell(val, col, x, plan, out_rep, br=br)
    torch.cuda.synchronize()
    assert ozaki_spmv.spmv_bell.launches == before + 1
    torch.testing.assert_close(got, ozaki_spmv.spmv_bell_ref(val, col, x, plan, out_rep),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_cuda_spmv_long_rows_reduced_in_the_loop(cuda_device):
    """Rows of 2^17 + 64 slots whose products mod 256 are all 2^14: the kernel's
    int32 sums pass 2^31 unless it reduces them inside the loop."""
    bw = (1 << 17) + 64
    v = 1.0 + 2.0 ** -45
    val = torch.full((3, bw), v, dtype=torch.float64, device=cuda_device)
    col = torch.from_numpy(RNG.integers(0, 5, (3, bw)).astype(np.int32)).to(cuda_device)
    x = torch.full((5,), v, dtype=torch.float64, device=cuda_device)
    plan = dispatch.get_plan(bw, margin_bits=4)
    got = ozaki_spmv.spmv_bell(val, col, x, plan, **dispatch.get_tuning("spmv_bell", val.shape))
    torch.testing.assert_close(got, ozaki_spmv.spmv_bell_ref(val, col, x, plan), rtol=0, atol=0)
    assert float(got[0]) == float(Fraction(bw) * Fraction(v) ** 2)   # correctly rounded


@pytest.mark.cuda
@pytest.mark.parametrize("out_rep", ["f64", "digits", "ds"])
def test_cuda_stencil_and_spmv_routes_bitwise(cuda_device, out_rep):
    u, c = _randn(cuda_device, 33, 17, 65), _randn(cuda_device, 7)
    torch.testing.assert_close(dispatch.stencil7(u, c, out_rep=out_rep),
                               dispatch.stencil7(u, c, out_rep=out_rep, mode="ref"),
                               rtol=0, atol=0)
    val, col, x = _random_bell(cuda_device, 513, 400, 9)
    torch.testing.assert_close(dispatch.spmv(val, col, x, out_rep=out_rep),
                               dispatch.spmv(val, col, x, out_rep=out_rep, mode="ref"),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_solvers_routes_bitwise(cuda_device):
    f = _randn(cuda_device, 12, 10, 9)
    kj = jacobi.jacobi_solve(f, spacings=[0.5, 1.0, 2.0], omega=2.0 / 3.0, tol=0.0, maxiter=20)
    rj = jacobi.jacobi_solve(f, spacings=[0.5, 1.0, 2.0], omega=2.0 / 3.0, tol=0.0, maxiter=20,
                             mode="ref")
    assert kj.history == rj.history
    torch.testing.assert_close(kj.u, rj.u, rtol=0, atol=0)
    n = 10
    idx = torch.arange(n * n, device=cuda_device)
    i, j = idx // n, idx % n
    nbr = torch.stack([idx, idx - n, idx + n, idx - 1, idx + 1], dim=1)
    ok = torch.stack([i >= 0, i > 0, i < n - 1, j > 0, j < n - 1], dim=1)
    col = torch.where(ok, nbr, idx[:, None]).to(torch.int32)
    val = torch.where(ok, torch.tensor([4.0, -1, -1, -1, -1], dtype=torch.float64,
                                       device=cuda_device), 0.0)
    b = _randn(cuda_device, n * n)
    kc = cg.cg_solve_bell(val, col, b, tol=1e-10)
    rc = cg.cg_solve_bell(val, col, b, tol=1e-10, mode="ref")
    assert kc.converged and kc.iters == rc.iters and kc.history == rc.history


@pytest.mark.cuda
def test_cuda_stencil_and_spmv_raise_on_bad_input(cuda_device):
    plan = dispatch.get_plan(8, margin_bits=4)
    u, c = _randn(cuda_device, 4, 5, 6), _randn(cuda_device, 7)
    with pytest.raises(ValueError):
        ozaki_stencil.stencil7(u, c, plan, bz=64, by=8)          # 512 threads a block
    with pytest.raises(ValueError):
        ozaki_stencil.stencil7(u[0], c, plan, bz=64, by=4)        # not 3-D
    with pytest.raises(TypeError):
        ozaki_stencil.stencil7(u.to(torch.int32), c, plan, bz=64, by=4)
    with pytest.raises(ValueError):
        ozaki_stencil.stencil7(u, c.cpu(), plan, bz=64, by=4)     # two devices
    val, col, x = _random_bell(cuda_device, 20, 10, 4)
    plan = dispatch.get_plan(4, margin_bits=4)
    with pytest.raises(ValueError):
        ozaki_spmv.spmv_bell(val, col + 10, x, plan, br=128)      # column past N
    with pytest.raises(ValueError):
        ozaki_spmv.spmv_bell(val, col, x, plan, br=0)
    with pytest.raises(TypeError):
        ozaki_spmv.spmv_bell(val, col.to(torch.float32), x, plan, br=128)
    with pytest.raises(ValueError):                               # not a DEFAULT_MODULI prefix
        ozaki_spmv.spmv_bell(val, col, x, ozaki2.Plan(moduli=(251, 241, 239), payload_bits=53),
                             br=128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(32768,), (2197,), (16,), (1,), (0,), (37, 45), (3, 1),
                                   (1000, 33), (5, 2, 3)])
def test_cuda_carry_fold_matches_plain_version(cuda_device, dtype, shape):
    """The fold on the card against its plain version on the host: wide
    exponents, signed zeros, inf and NaN, one lane and many."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    span = 200 if dtype == torch.float64 else 30
    sb = (RNG.standard_normal(shape) * np.exp(RNG.uniform(-span, span, shape))).astype(npd)
    cb = (RNG.standard_normal(shape) * 1e-17).astype(npd)
    cases = [(sb, cb), (np.full_like(sb, -0.0), np.full_like(cb, -0.0))]
    if shape[0] > 2:
        special = sb.copy()
        special[1], special[-1] = np.inf, np.nan
        cases.append((special, cb))
    for s_b, c_b in cases:
        s_t, c_t = torch.from_numpy(s_b), torch.from_numpy(c_b)
        want = carry_fold.carry_fold_ref(s_t, c_t)
        before = carry_fold.carry_fold.launches
        got = carry_fold.carry_fold(s_t.to(cuda_device), c_t.to(cuda_device))
        assert carry_fold.carry_fold.launches == before + 1
        assert got.dtype == dtype and tuple(got.shape) == shape[1:]
        g, w = got.cpu().numpy(), want.numpy()
        np.testing.assert_array_equal(g, w)                      # NaN equals NaN here
        np.testing.assert_array_equal(np.signbit(g[~np.isnan(g)]), np.signbit(w[~np.isnan(w)]))


@pytest.mark.cuda
def test_cuda_compensated_reductions_equal_the_host(cuda_device):
    """compensated_dot and compensated_norm on the card (the tree as torch ops,
    the fold as the kernel) give the host's bits, one fold launch each."""
    x = RNG.standard_normal((70001,)) * np.exp(RNG.uniform(-20, 20, 70001))
    y = RNG.standard_normal((70001,))
    xb = RNG.standard_normal((40, 600))
    for fn, args in ((compensated.compensated_dot, (x, y)), (compensated.compensated_norm, (x,)),
                     (lambda a: compensated.compensated_norm(a, axis=1), (xb,)),
                     (lambda a, b: compensated.compensated_dot(a, b, axis=0), (xb, xb))):
        host = fn(*(torch.from_numpy(a) for a in args))
        before = carry_fold.carry_fold.launches
        card = fn(*(torch.from_numpy(a).to(cuda_device) for a in args))
        assert carry_fold.carry_fold.launches == before + 1
        np.testing.assert_array_equal(card.cpu().numpy(), host.numpy())


@pytest.mark.cuda
def test_cuda_carry_fold_raises_on_bad_input(cuda_device):
    s = torch.zeros((4, 3), dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        carry_fold.carry_fold(s.to(torch.float16), s.to(torch.float16))
    with pytest.raises(ValueError):
        carry_fold.carry_fold(s, s[:, :2])
    with pytest.raises(ValueError):
        carry_fold.carry_fold(s, s.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 29, 51), (3, 9, 70), (65, 2, 5)])
@pytest.mark.parametrize("scale", [1e-300, 1.0, 1e300])
@pytest.mark.parametrize("tile", [(32, 8, 64), (16, 4, 5)])
def test_cuda_stencil_fused_phase1_at_extreme_scales(cuda_device, shape, scale, tile):
    """The kernel's own Phase 1 (shifts past 2^1023 either way, the too-big
    guard, the split) and its unscale, in every representation, at two tiles,
    against the plain version."""
    plan = dispatch.get_plan(8, margin_bits=4)
    u = _randn(cuda_device, *shape) * scale
    u[0, 0, 0] = 0.0
    c = _randn(cuda_device, 7) * np.exp(RNG.uniform(-30, 30))
    bz, by, bx = tile
    for out_rep in ("f64", "digits", "ds"):
        got = ozaki_stencil.stencil7(u, c, plan, out_rep, bz=bz, by=by, bx=bx)
        torch.testing.assert_close(got, ozaki_stencil.stencil7_ref(u, c, plan, out_rep),
                                   rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_cuda_stencil_zero_grid_and_power_of_two_maximum(cuda_device):
    plan = dispatch.get_plan(8, margin_bits=4)
    c = torch.tensor([-6.0, 1, 1, 1, 1, 1, 1], dtype=torch.float64, device=cuda_device)
    zero = torch.zeros((5, 6, 7), dtype=torch.float64, device=cuda_device)
    for u in (zero, -zero, _randn(cuda_device, 5, 6, 7)):
        if u is not zero and bool(u.any()):
            u = u / u.abs().max() * 2.0 ** 40            # absmax exactly 2^40
        for out_rep in ("f64", "digits", "ds"):
            torch.testing.assert_close(
                ozaki_stencil.stencil7(u, c, plan, out_rep, bz=8, by=4),
                ozaki_stencil.stencil7_ref(u, c, plan, out_rep), rtol=0, atol=0)


def _reduction_operand(n, lead=(), dtype=np.float64, special=False):
    span = 200 if dtype == np.float64 else 30
    x = (RNG.standard_normal(lead + (n,)) * np.exp(RNG.uniform(-span, span, lead + (n,))))
    x = x.astype(dtype)
    if special and n > 3:
        x[..., 1], x[..., 2] = -0.0, 0.0
        x.reshape(-1, n)[0, 3] = np.inf
        x.reshape(-1, n)[-1, -1] = np.nan
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (256 ** 3, (), np.float64, False), (104 ** 3, (), np.float64, False),
    (8192, (), np.float64, False), (100003, (), np.float64, True), (7, (), np.float64, False),
    (1, (), np.float64, False), (513, (3, 5), np.float64, True), (70001, (3,), np.float32, True),
    (300, (2,), np.float32, False)])
def test_cuda_reduction_kernels_match_plain_route(cuda_device, case):
    """neumaier_sum, compensated_dot and compensated_norm on the kernel route
    against the plain route (torch tree, host fold), and each kernel against its
    plain version, at the main paths' lengths (a 256^3 norm, an HPCG 104^3 dot,
    a dense-CG dot), ragged, batched, in float32 and with special values."""
    n, lead, dtype, special = case
    x = torch.from_numpy(_reduction_operand(n, lead, dtype, special)).to(cuda_device)
    y = torch.from_numpy(_reduction_operand(n, lead, dtype)).to(cuda_device)
    def same(got, want):
        g, w = got.cpu().numpy(), want.cpu().numpy()
        np.testing.assert_array_equal(g, w)                      # NaN equals NaN here
        np.testing.assert_array_equal(np.signbit(g[~np.isnan(g)]), np.signbit(w[~np.isnan(w)]))

    for name in ("sum", "dot", "norm", "norm, axis -1"):
        def fn(mode):
            if name == "sum":
                return compensated.neumaier_sum(x, mode=mode)
            if name == "dot":
                return compensated.compensated_dot(x, y, mode=mode)
            return compensated.compensated_norm(x, axis=-1 if "axis" in name else None,
                                                mode=mode)
        before = (carry_fold.carry_fold.launches, carry_fold.block_tree.launches)
        got = fn("kernel")
        assert (carry_fold.carry_fold.launches, carry_fold.block_tree.launches) == \
            (before[0] + 1, before[1] + 1)
        same(got, fn("ref"))
    lanes = x.reshape(-1, n)
    bits, flags = carry_fold.norm_scale(lanes)
    wb, wf = carry_fold.norm_scale_ref(lanes)
    assert torch.equal(bits, wb) and torch.equal(flags, wf)
    for block in (512, 256, 300, 7, 1, 1024, 4096):
        for other, scale in ((None, None), (y.reshape(-1, n), None), (None, bits)):
            got = carry_fold.block_tree(lanes, other, block, scale)
            want = carry_fold.block_tree_ref(lanes, other, block, scale)
            for g, w in zip(got, want):
                same(g, w)


@pytest.mark.cuda
def test_cuda_reduction_kernel_route_raises_on_what_it_cannot_take(cuda_device):
    x = torch.ones(1000, dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError):
        compensated.neumaier_sum(x, mode="kernel")
    with pytest.raises(ValueError):
        compensated.compensated_dot(x.cpu().double(), x.cpu().double(), mode="kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1024, 4096, 10000])
def test_cuda_reduction_kernel_route_takes_any_block(cuda_device, block):
    """Blocks past 512 elements (pieces of 512 joined in order) on the kernel
    route against the plain route, batched and with special values."""
    x = torch.from_numpy(_reduction_operand(100003, (3,), special=True)).to(cuda_device)
    y = torch.from_numpy(_reduction_operand(100003, (3,))).to(cuda_device)
    for fn in (lambda m: compensated.neumaier_sum(x, block=block, mode=m),
               lambda m: compensated.compensated_dot(x, y, block=block, mode=m)):
        got, want = fn("kernel").cpu().numpy(), fn("ref").cpu().numpy()
        np.testing.assert_array_equal(got, want)                  # NaN equals NaN here
        num = ~np.isnan(want)
        np.testing.assert_array_equal(np.signbit(got[num]), np.signbit(want[num]))


@pytest.mark.cuda
def test_cuda_fold_chain_probe_adds_in_order(cuda_device):
    out = torch.empty(1, dtype=torch.float64, device=cuda_device)
    err = _build.library("dadd_chain").dadd_chain(
        out.device.index, 0.1, 1000, out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    assert err == 0
    s = 0.0
    for _ in range(1000):
        s += 0.1
    assert float(out[0]) == s


@pytest.mark.cuda
def test_cuda_three_sweeps_and_iterations_routes_bitwise(cuda_device):
    """Jacobi, the sparse CG and the dense CG with every kernel (stencil or
    matvec, tree, fold) against every plain version, three steps each."""
    f = _randn(cuda_device, 19, 23, 31)
    kj = jacobi.jacobi_solve(f, omega=2.0 / 3.0, tol=0.0, maxiter=3, mode="kernel")
    rj = jacobi.jacobi_solve(f, omega=2.0 / 3.0, tol=0.0, maxiter=3, mode="ref")
    assert kj.history == rj.history and len(kj.history) == 4
    torch.testing.assert_close(kj.u, rj.u, rtol=0, atol=0)
    n = 30                                            # the 2-D Laplacian, 900 rows
    idx = torch.arange(n * n, device=cuda_device)
    i, j = idx // n, idx % n
    nbr = torch.stack([idx, idx - n, idx + n, idx - 1, idx + 1], dim=1)
    ok = torch.stack([i >= 0, i > 0, i < n - 1, j > 0, j < n - 1], dim=1)
    col = torch.where(ok, nbr, idx[:, None]).to(torch.int32)
    val = torch.where(ok, torch.tensor([4.0, -1, -1, -1, -1], dtype=torch.float64,
                                       device=cuda_device), 0.0)
    b = _randn(cuda_device, n * n)
    kc = cg.cg_solve_bell(val, col, b, tol=0.0, maxiter=3, mode="kernel")
    rc = cg.cg_solve_bell(val, col, b, tol=0.0, maxiter=3, mode="ref")
    assert kc.history == rc.history and len(kc.history) == 4
    a = _randn(cuda_device, 96, 96)
    a = a @ a.T + 96 * torch.eye(96, dtype=torch.float64, device=cuda_device)
    kd = cg.cg_solve_dense(a, b[:96], tol=0.0, maxiter=3, mode="kernel")
    rd = cg.cg_solve_dense(a, b[:96], tol=0.0, maxiter=3, mode="ref")
    assert kd.history == rd.history and len(kd.history) == 4
    torch.testing.assert_close(kd.x, rd.x, rtol=0, atol=0)


def _attention_case(dev, B, S, T, D, kind):
    q, k, v = _randn(dev, B, S, D), _randn(dev, B, T, D), _randn(dev, B, T, D)
    if kind == "causal":
        mask = torch.tril(torch.ones((S, T), dtype=torch.int8, device=dev), diagonal=T - S)
        mask = mask.expand(B, S, T)
    elif kind == "window":
        i, j = torch.arange(S, device=dev)[:, None] + T - S, torch.arange(T, device=dev)[None]
        mask = ((j <= i) & (i - j < 7)).to(torch.int8).expand(B, S, T).clone()
        mask[:, S // 2] = 0                                       # a fully masked row
    else:
        mask = (torch.from_numpy(RNG.random((B, S, T))) < 0.7).to(torch.int8).to(dev)
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 37, 301, 80), (2, 1, 29, 128), (4, 70, 130, 16),
                                   (1, 33, 8, 256), (5, 16, 128, 3),
                                   (3, 10, 40, 1)])               # D = 1: rq 14 < rp 15
@pytest.mark.parametrize("kind", ["causal", "window", "random"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_cuda_attention_matches_plain_version(cuda_device, shape, kind, softcap):
    B, S, T, D = shape
    q, k, v, mask = _attention_case(cuda_device, B, S, T, D, kind)
    bkv = min(128, -(-T // 8) * 8)
    pq, pp = dispatch.get_plan(D), dispatch.get_plan(bkv)
    want = ozaki_attention.attention_ref(q, k, v, mask, pq, pp, softcap, bkv)
    for bq in (16, 8, 5):
        before = ozaki_attention.attention_fused.launches
        got = ozaki_attention.attention_fused(q, k, v, mask, pq, pp, softcap, bq=bq, bkv=bkv)
        torch.cuda.synchronize()
        assert ozaki_attention.attention_fused.launches == before + 1
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_cuda_attention_routes_bitwise(cuda_device, lead):
    S, T, D = 21, 260, 128
    q = _randn(cuda_device, *lead, S, D)
    k, v = _randn(cuda_device, *lead, T, D), _randn(cuda_device, *lead, T, D)
    for mask in (None, torch.rand((S, T), device=cuda_device) < 0.5):
        got = dispatch.attention(q, k, v, mask=mask, softcap=20.0)
        torch.testing.assert_close(got, dispatch.attention(q, k, v, mask=mask, softcap=20.0,
                                                           mode="ref"), rtol=0, atol=0)
        assert tuple(got.shape) == tuple(lead) + (S, D)


@pytest.mark.cuda
def test_cuda_attention_raises_on_bad_input(cuda_device):
    q, k, v, mask = _attention_case(cuda_device, 2, 9, 20, 16, "causal")
    pq, pp = dispatch.get_plan(16), dispatch.get_plan(24)
    with pytest.raises(ValueError):
        ozaki_attention.attention_fused(q, k, v, mask, pq, pp, bq=33, bkv=24)
    with pytest.raises(ValueError):
        ozaki_attention.attention_fused(q, k, v, mask, pq, pp, bq=16, bkv=20)   # bkv % 8
    with pytest.raises(TypeError):
        ozaki_attention.attention_fused(q.to(torch.int32), k, v, mask, pq, pp, bq=16, bkv=24)
    with pytest.raises(ValueError):
        ozaki_attention.attention_fused(q, k, v.cpu(), mask, pq, pp, bq=16, bkv=24)
    with pytest.raises(ValueError):
        ozaki_attention.attention_fused(q, k, v, mask[:, :, :19], pq, pp, bq=16, bkv=24)
    big = _randn(cuda_device, 1, 4, 300)
    with pytest.raises(ValueError):                               # D above the kernel's 256
        ozaki_attention.attention_fused(big, big, big, torch.ones((1, 4, 4), dtype=torch.int8,
                                                                  device=cuda_device),
                                        dispatch.get_plan(300), dispatch.get_plan(8), bq=8, bkv=8)
    with pytest.raises(ValueError):                               # not a DEFAULT_MODULI prefix
        ozaki_attention.attention_fused(q, k, v, mask, ozaki2.Plan((251, 241), 20), pp, bq=16,
                                        bkv=24)


def _ring(dev, B, T, lo, hi):
    """Decode masks: (B, 1, T) with keys lo .. hi - 1 real."""
    m = torch.zeros((B, 1, T), dtype=torch.int8, device=dev)
    m[:, :, lo:hi] = 1
    return m


ATTN_PATH_CASES = {
    # name: (B, S, T, D, mask)
    "decode 64 x 1 x 32": (64, 1, 32, 128, "ring"),
    "decode 64 x 1 x 4096": (64, 1, 4096, 128, "ring"),
    "decode, T not a multiple of bkv": (5, 1, 1000, 64, "ring"),
    "decode, real keys in the last block only": (4, 1, 700, 128, "last block"),
    "causal prefill": (3, 200, 200, 128, "causal"),
    "window prefill": (2, 150, 300, 80, "window"),
    "ragged prefill": (3, 37, 301, 80, "random"),
    "wide head": (2, 40, 260, 256, "causal"),
    "decode, odd head_dim": (3, 1, 300, 37, "ring"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ATTN_PATH_CASES))
def test_cuda_attention_paths_match_plain_version(cuda_device, name):
    """Both paths over the key axis (the one-pass sweep, and the row path where
    S = 1), at every tile size, against the plain version; the wrapper's own
    choice too.  Above S = 1 the row path also takes each query row as its own
    problem, which gives it the prefill masks' rows."""
    B, S, T, D, kind = ATTN_PATH_CASES[name]
    if kind in ("causal", "window", "random"):
        q, k, v, mask = _attention_case(cuda_device, B, S, T, D, kind)
    else:
        q, k, v = _randn(cuda_device, B, S, D), _randn(cuda_device, B, T, D), \
            _randn(cuda_device, B, T, D)
        mask = _ring(cuda_device, B, T, 0, T - 2) if kind == "ring" else \
            _ring(cuda_device, B, T, T - 50, T - 3)
    bkv = min(128, -(-T // 8) * 8)
    pq, pp = dispatch.get_plan(D), dispatch.get_plan(bkv)
    want = ozaki_attention.attention_ref(q, k, v, mask, pq, pp, 0.0, bkv)
    ops = ozaki_attention._decompose(q, k, v, pq, pp, bkv)
    for bq in sorted({ozaki_attention.max_bq(D), 16, 8, 5}):
        for path in ozaki_attention.PATHS if S == 1 else ("sweep",):
            got = ozaki_attention._launch(*ops, mask, pq, pp, 0.0, bq, bkv, path=path)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    if S > 1:
        with pytest.raises(ValueError):
            ozaki_attention._launch(*ops, mask, pq, pp, 0.0, 8, bkv, path="row")
        rows = [x[:, None].expand(B, S, T, D).reshape(B * S, T, D) for x in (k, v)]
        row_ops = ozaki_attention._decompose(q.reshape(B * S, 1, D), *rows, pq, pp, bkv)
        got = ozaki_attention._launch(*row_ops, mask.reshape(B * S, 1, T), pq, pp, 0.0, 1, bkv,
                                      path="row")
        torch.testing.assert_close(got, want.reshape(B * S, 1, D), rtol=0, atol=0)
    before = ozaki_attention.attention_fused.launches
    got = ozaki_attention.attention_fused(q, k, v, mask, pq, pp, bq=8, bkv=bkv)
    assert ozaki_attention.attention_fused.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_attention_wide_head_takes_16_row_tiles(cuda_device):
    q, k, v, mask = _attention_case(cuda_device, 1, 20, 40, 256, "causal")
    pq, pp = dispatch.get_plan(256), dispatch.get_plan(40)
    with pytest.raises(ValueError):
        ozaki_attention.attention_fused(q, k, v, mask, pq, pp, bq=32, bkv=40)
    torch.testing.assert_close(dispatch.attention(q, k, v, mask=mask),
                               dispatch.attention(q, k, v, mask=mask, mode="ref"), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("bw", [2, 16, 17, 32, 33, 64])
@pytest.mark.parametrize("br", [32, 96, 200])
def test_cuda_spmv_odd_and_even_widths(cuda_device, bw, br):
    """The staged walk at even and odd bw, one and several 16-slot segments,
    M not a multiple of the block or of a warp."""
    val, col, x = _random_bell(cuda_device, 1013, 700, bw)
    plan = dispatch.get_plan(bw, margin_bits=4)
    for out_rep in ("f64", "digits"):
        got = ozaki_spmv.spmv_bell(val, col, x, plan, out_rep, br=br)
        torch.testing.assert_close(got, ozaki_spmv.spmv_bell_ref(val, col, x, plan, out_rep),
                                   rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_yi6b_width_decode_step_routes_bitwise(cuda_device):
    cfg = registry.get_config("yi-6b", num_layers=2, policy_name="ozaki2_int8",
                              compute_dtype="float32")
    model = Model(cfg).init(torch.Generator(device=cuda_device).manual_seed(3))
    tokens = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 1))).to(cuda_device)
    caches = {m: model.init_cache(2, 16) for m in ("kernel", "ref")}
    for pos in range(3):
        out = {}
        for m in caches:
            with dispatch.mode_scope(m):
                out[m], caches[m] = model.decode_step(caches[m], tokens, pos)
        torch.testing.assert_close(out["kernel"], out["ref"], rtol=0, atol=0)
        assert bool(torch.isfinite(out["kernel"]).all())


def _crandn(device, *shape):
    x = RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)
    return torch.from_numpy(x).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis", [((120, 3), 0), ((2, 1024), -1), ((97, 4), 0),
                                        ((4093,), 0), ((5, 256), 1)])
def test_cuda_fft_routes_bitwise(cuda_device, shape, axis):
    """Kernel route (gemm_hilo above 16 columns, gemv_hilo otherwise) against the
    reference route on the card, and within two dft_error_bound of torch.fft."""
    x = _crandn(cuda_device, *shape)
    before = ozaki_gemm.gemm_hilo.launches + ozaki_gemv.gemv_hilo.launches
    got = spectral.fft(x, axis=axis)
    assert ozaki_gemm.gemm_hilo.launches + ozaki_gemv.gemv_hilo.launches > before
    torch.testing.assert_close(got, spectral.fft(x, axis=axis, mode="ref"), rtol=0, atol=0)
    want = torch.fft.fft(x, dim=axis)
    n = shape[axis]
    assert float((got - want).abs().max()) <= 2 * spectral.dft_error_bound(n) * float(
        want.abs().max())
    back = spectral.ifft(got, axis=axis)
    torch.testing.assert_close(back, spectral.ifft(got, axis=axis, mode="ref"), rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_fftn_and_poisson_routes_bitwise(cuda_device):
    x = _crandn(cuda_device, 16, 24, 20)
    torch.testing.assert_close(spectral.fftn(x), spectral.fftn(x, mode="ref"), rtol=0, atol=0)
    f, u = poisson.manufactured_rhs((16, 20, 24), seed=4)
    f = f.to(cuda_device)
    got = poisson.poisson_solve_periodic(f)
    torch.testing.assert_close(got, poisson.poisson_solve_periodic(f, mode="ref"), rtol=0,
                               atol=0)
    assert float((got.cpu() - u).abs().max()) <= 1e-10
    res = poisson.poisson_solve_checked(f)
    assert res.residual <= 1e-12
    assert res.residual == poisson.poisson_solve_checked(f, mode="ref").residual
    fi = torch.from_numpy(RNG.standard_normal((7, 9, 11))).to(cuda_device)
    ud = poisson.poisson_solve_dirichlet(fi)
    torch.testing.assert_close(ud, poisson.poisson_solve_dirichlet(fi, mode="ref"), rtol=0,
                               atol=0)
    torch.testing.assert_close(jacobi.apply_dirichlet_laplacian(ud), fi, rtol=0, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(16, 64), (128, 128), (5, 40)])
@pytest.mark.parametrize("k", [64, 4096, 1 << 16])
def test_cuda_fp8_plane_products_exact(cuda_device, rows, cols, k):
    """The port's FP8 plane product (runs of FP8_CUDA_K_CHUNK in their own
    blocks) is exact where one call over the whole contraction is not: constant
    odd products need every bit of their sums."""
    ones = torch.ones((rows, k), dtype=torch.int32)
    cases = [(torch.randint(-16, 17, (rows, k)), torch.randint(-16, 17, (k, cols))),
             (13 * ones, torch.full((k, cols), 15)),
             (torch.full((rows, k), 16), torch.full((k, cols), 16)),
             (torch.randint(-8, 9, (rows, k)), torch.full((k, cols), -8))]
    for a, b in cases:
        a, b = a.to(cuda_device, torch.int32), b.to(cuda_device, torch.int32)
        want = torch.matmul(a.double(), b.double())
        got = ozaki2._dot_fp8(a, b)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(64, 96, 80), (130, 200, 5), (7, 33, 17),
                                 (33, (1 << 16) + 48, 20)])
def test_cuda_fp8_dgemm_equals_int8(cuda_device, mkn):
    """The FP8 substrate (reference route, torch._scaled_mm) and the int8 kernel
    route give the same bits; the last shape has k above the committed chunk."""
    m, k, n = mkn
    a = torch.from_numpy(RNG.standard_normal((m, k))).to(cuda_device)
    a[0] *= 1e-300
    b = torch.from_numpy(RNG.standard_normal((k, n))).to(cuda_device)
    got = dispatch.matmul(a, b, substrate="fp8")
    torch.testing.assert_close(got, dispatch.matmul(a, b), rtol=0, atol=0)
    torch.testing.assert_close(got, dispatch.matmul(a, b, mode="ref"), rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_fp8_chunks_change_no_bit(cuda_device, monkeypatch):
    a = torch.from_numpy(RNG.standard_normal((24, 200))).to(cuda_device)
    b = torch.from_numpy(RNG.standard_normal((200, 40))).to(cuda_device)
    plan = dispatch.get_plan(200, substrate="fp8")
    whole = ozaki2.emulated_matmul(a, b, plan)
    monkeypatch.setattr(ozaki2, "FP8_CUDA_K_CHUNK", 48)
    torch.testing.assert_close(ozaki2.emulated_matmul(a, b, plan), whole, rtol=0, atol=0)
    x = torch.from_numpy(RNG.standard_normal((2, 3, 5, 200))).to(cuda_device)   # batched
    torch.testing.assert_close(ozaki2.emulated_matmul(x, b, plan),
                               ozaki2.emulated_matmul(x, b, dispatch.get_plan(200)), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(1, 1, 1), (3, 13, 5), (17, 8, 8), (20, 37, 9), (300, 257, 31)])
def test_cuda_ozaki1_int_mm_padding(cuda_device, mkn):
    """torch._int_mm takes more than 16 rows and multiples of 8: the slices are
    zero-padded, and the product is exact, so the card gives the CPU's bits."""
    m, k, n = mkn
    a8 = torch.from_numpy(RNG.integers(-64, 65, (m, k)).astype(np.int8)).to(cuda_device)
    b8 = torch.from_numpy(RNG.integers(-64, 65, (k, n)).astype(np.int8)).to(cuda_device)
    pa, pb = ozaki1._slice_operands(a8[None], b8[None])
    assert pa.shape[1] > 16 and pa.shape[2] % 8 == 0 and pb.shape[2] % 8 == 0
    assert pb.stride(1) == 1                     # B column-major
    got = ozaki1._dot_int8(pa[0], pb[0], m, n)
    assert tuple(got.shape) == (m, n) and got.dtype == torch.float64
    torch.testing.assert_close(got, torch.matmul(a8.double(), b8.double()), rtol=0, atol=0)
    a = torch.from_numpy(RNG.standard_normal((m, k)))
    b = torch.from_numpy(RNG.standard_normal((k, n)))
    torch.testing.assert_close(ozaki1.emulated_matmul(a.to(cuda_device), b.to(cuda_device)).cpu(),
                               ozaki1.emulated_matmul(a, b), rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_emulated_policies(cuda_device):
    x = torch.from_numpy(RNG.standard_normal((2, 3, 96)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(RNG.standard_normal((96, 40)).astype(np.float32)).to(cuda_device)
    int8 = Policy("ozaki2_int8").dot(x, w)
    torch.testing.assert_close(Policy("ozaki2_fp8").dot(x, w), int8, rtol=0, atol=0)
    oz1 = Policy("ozaki1_int8").dot(x, w)
    torch.testing.assert_close(oz1.cpu(), Policy("ozaki1_int8").dot(x.cpu(), w.cpu()), rtol=0,
                               atol=0)
