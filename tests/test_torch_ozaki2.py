"""repro_torch.core.ozaki2 held bitwise against repro.core.ozaki2 (CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ozaki2 as jo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ozaki2 as to  # noqa: E402

RNG = np.random.default_rng(11)


def _operands(m, k, n, dtype=np.float64):
    a = RNG.standard_normal((m, k)) * np.exp(RNG.uniform(-20, 20, (m, 1)))
    b = RNG.standard_normal((k, n)) * np.exp(RNG.uniform(-20, 20, (1, n)))
    return a.astype(dtype), b.astype(dtype)


def test_make_plan_matches_reference():
    for k, p, r in ((48, 53, None), (8192, 53, None), (64, 24, None), (128, 53, 8)):
        jp = jo.make_plan(k, p, r=r)
        tp = to.make_plan(k, p, r=r)
        assert (tp.moduli, tp.payload_bits, tp.r, tp.alpha) == \
            (jp.moduli, jp.payload_bits, jp.r, jp.alpha)
        assert convert.plan_from_fields(jp.moduli, jp.payload_bits) == tp


@pytest.mark.parametrize("mkn,payload,dtype", [
    ((32, 32, 32), 53, np.float64),      # square
    ((40, 70, 24), 53, np.float64),      # ragged
    ((33, 128, 5), 53, np.float64),      # narrow RHS
    ((16, 32, 16), 24, np.float32),      # payload-24 f32
])
def test_emulated_matmul_bitwise(mkn, payload, dtype):
    m, k, n = mkn
    a, b = _operands(m, k, n, dtype)
    jp = jo.make_plan(k, payload_bits=payload)
    tp = convert.plan_from_fields(jp.moduli, jp.payload_bits)
    if dtype == np.float32:
        want = jo.emulated_matmul(jnp.asarray(a), jnp.asarray(b), jp, out_dtype=jnp.float32)
        got = to.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b), tp,
                                 out_dtype=torch.float32)
    else:
        want = jo.emulated_matmul(jnp.asarray(a), jnp.asarray(b), jp)
        got = to.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b), tp)
    assert got.dtype == (torch.float32 if dtype == np.float32 else torch.float64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int64_oracle_path_bitwise():
    a, b = _operands(12, 40, 9)
    plan = to.make_plan(40)
    got = to.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b), plan, via_hilo=False)
    want = jo.emulated_matmul(jnp.asarray(a), jnp.asarray(b), jo.make_plan(40), via_hilo=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k_chunk_path_matches_unchunked(monkeypatch):
    a, b = _operands(20, 70, 18)
    plan = to.make_plan(70)
    whole = to.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b), plan)
    monkeypatch.setattr(to, "_INT8_K_CHUNK", 16)   # 5 chunks, the last ragged
    chunked = to.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b), plan)
    want = jo.emulated_matmul(jnp.asarray(a), jnp.asarray(b), jo.make_plan(70))
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    np.testing.assert_array_equal(chunked.numpy(), np.asarray(want))


def test_emulated_matmul_batched_bitwise():
    a = RNG.standard_normal((2, 3, 8, 24))
    b = RNG.standard_normal((2, 3, 24, 6))
    jp = jo.make_plan(24)
    got = to.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             convert.plan_from_fields(jp.moduli, jp.payload_bits))
    want = jo.emulated_matmul_batched(jnp.asarray(a), jnp.asarray(b), jp)
    assert tuple(got.shape) == (2, 3, 8, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fp8_substrate_not_ported():
    """The FP8 substrate is ported now: the same bits as the int8 substrate."""
    a, b = _operands(4, 8, 4)
    got = to.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b),
                             to.make_plan(8, substrate="fp8"))
    want = to.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b), to.make_plan(8))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
