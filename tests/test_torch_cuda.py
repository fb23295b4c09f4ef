"""The CUDA kernels held bitwise against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  This file imports
no JAX, so it also runs where only torch is installed:
    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dispatch, splitting  # noqa: E402
from repro_torch.kernels import ozaki_gemm, ozaki_gemv  # noqa: E402

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
])
@pytest.mark.parametrize("out_rep", ["f64", "digits", "ds"])
def test_cuda_kernel_matches_plain_version(cuda_device, mkn, out_rep):
    m, k, n = mkn
    plan = dispatch.get_plan(k)
    a = torch.from_numpy(RNG.standard_normal((m, k))).to(cuda_device)
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
