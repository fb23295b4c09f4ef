"""The FP8 substrate, Ozaki Scheme I and their policies, held against repro (CPU).

Tolerances: bitwise throughout.  The FP8 substrate gives the same integers mod
m as the int8 one (every plane product is an exact integer), so its products
equal ``repro``'s and the port's own int8 substrate's bits.  Ozaki I's slice
products are exact and each product times its power-of-two weight is exact, so
the reference's FMA contraction of ``out + dot·w`` changes no bit.

Shapes avoid batch widths 9 and 13, where ``repro``'s jitted ``emulated_matmul``
is wrong (ROADMAP queue 3, item 9).  ``test_port_exact_on_reference_falsifying_inputs``
holds the port to exact oracles on the reference's falsifying inputs instead.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fp8_quant as jfp8  # noqa: E402
from repro.core import moduli as jmoduli  # noqa: E402
from repro.core import ozaki1 as jo1  # noqa: E402
from repro.core import ozaki2 as jo2  # noqa: E402
from repro.core.policy import Policy as JPolicy  # noqa: E402
from repro_torch import spectral  # noqa: E402
from repro_torch.core import compensated, dispatch, fp8_quant, ozaki1, ozaki2  # noqa: E402
from repro_torch.core.policy import Policy  # noqa: E402

RNG = np.random.default_rng(41)
U = 2.0 ** -53


def _operands(m, k, n, spread=20.0):
    a = RNG.standard_normal((m, k)) * np.exp(RNG.uniform(-spread, spread, (m, 1)))
    b = RNG.standard_normal((k, n)) * np.exp(RNG.uniform(-spread, spread, (1, n)))
    return a, b


def test_is_exact_e4m3_matches_jax_float8():
    """Against JAX's float8_e4m3fn: ``repro``'s ``is_exact_e4m3`` reads
    ``np.float8_e4m3fn``, which this numpy does not have (ROADMAP queue 3)."""
    xs = np.arange(-600, 601)
    back = np.asarray(jnp.asarray(xs.astype(np.float64), jnp.float8_e4m3fn).astype(jnp.float64))
    assert [fp8_quant.is_exact_e4m3(int(x)) for x in xs] == list(back == xs)
    assert all(fp8_quant.is_exact_e4m3(x) for x in range(-16, 17))
    if not hasattr(np, "float8_e4m3fn"):
        with pytest.raises(AttributeError):
            jfp8.is_exact_e4m3(1)


def test_fp8_split_every_int8_residue():
    res = np.arange(-128, 128, dtype=np.int8)
    hi, lo = fp8_quant.fp8_split(torch.from_numpy(res))
    jhi, jlo = jfp8.fp8_split(jnp.asarray(res))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    assert hi.dtype == lo.dtype == torch.int32
    np.testing.assert_array_equal(16 * hi.numpy() + lo.numpy(), res)
    assert np.abs(hi.numpy()).max() <= 8 and np.abs(lo.numpy()).max() <= 8


def test_karatsuba_combine_every_modulus():
    """Every residue pair of every modulus, as exact plane products, recombines to
    the balanced residue of the product, bitwise as ``repro``."""
    r = np.arange(-128, 128, dtype=np.int32)
    x, y = (v.reshape(-1) for v in np.meshgrid(r, r))
    xh, xl = (t.numpy() for t in fp8_quant.fp8_split(torch.from_numpy(x)))
    yh, yl = (t.numpy() for t in fp8_quant.fp8_split(torch.from_numpy(y)))
    # sums of products as a k = 300 contraction would give them
    H, L, Mid = xh * yh * 300, xl * yl * 300, (xh + xl) * (yh + yl) * 300
    for m in jmoduli.DEFAULT_MODULI:
        got = fp8_quant.fp8_karatsuba_combine(*(torch.from_numpy(v) for v in (H, Mid, L)), m)
        want = jfp8.fp8_karatsuba_combine(*(jnp.asarray(v) for v in (H, Mid, L)), m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        u = np.remainder(x.astype(np.int64) * y * 300, m)
        np.testing.assert_array_equal(got.numpy(), np.where(u > (m - 1) // 2, u - m, u))


@pytest.mark.parametrize("mkn,payload", [((33, 128, 5), 53), ((20, 300, 17), 53),
                                         ((16, 64, 24), 24)])
def test_fp8_emulated_matmul_bitwise(mkn, payload):
    m, k, n = mkn
    a, b = _operands(m, k, n)
    jp = jo2.make_plan(k, payload_bits=payload, substrate="fp8")
    tp = ozaki2.make_plan(k, payload_bits=payload, substrate="fp8")
    assert (tp.moduli, tp.payload_bits, tp.alpha) == (jp.moduli, jp.payload_bits, jp.alpha)
    got = ozaki2.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b), tp)
    want = jo2.emulated_matmul(jnp.asarray(a), jnp.asarray(b), jp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    int8 = ozaki2.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                  ozaki2.make_plan(k, payload_bits=payload))
    np.testing.assert_array_equal(got.numpy(), int8.numpy())


def test_fp8_chunk_changes_no_bit(monkeypatch):
    """A contraction cut into k-chunks, each reduced mod m, gives the same bits."""
    assert 32 <= ozaki2.FP8_CUDA_K_CHUNK <= ozaki2._FP8_K_CHUNK
    a, b = _operands(6, 200, 5)
    plan = ozaki2.make_plan(200, substrate="fp8")
    whole = ozaki2.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b), plan)
    monkeypatch.setattr(ozaki2, "_FP8_K_CHUNK", 48)
    chunked = ozaki2.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b), plan)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())


@pytest.mark.parametrize("mkn", [(3, 130, 5), (16, 64, 16), (1, 1, 1), (20, 300, 33)])
def test_fp8_blocked_layout(mkn):
    """The card's FP8 operands: each run of FP8_CUDA_K_CHUNK contraction entries
    heads its own block of _FP8_CUDA_BLOCK, zeros elsewhere; the product of the
    two blocked operands is the plain product (checked in float64 here)."""
    m, k, n = mkn
    a = torch.randint(-16, 17, (m, k), dtype=torch.int32)
    b = torch.randint(-16, 17, (k, n), dtype=torch.int32)
    ab = ozaki2._fp8_blocked(a, 32, 1)
    bb = ozaki2._fp8_blocked(b, 48, 0)
    c, blk = ozaki2.FP8_CUDA_K_CHUNK, ozaki2._FP8_CUDA_BLOCK
    nb = -(-k // c)
    assert ab.dtype == torch.float8_e4m3fn and tuple(ab.shape) == (32, nb * blk)
    assert tuple(bb.shape) == (48, nb * blk)
    for t in (ab, bb):
        assert not bool(t.to(torch.float32).view(-1, nb, blk)[:, :, c:].any())
    got = torch.matmul(ab.to(torch.float64), bb.to(torch.float64).t())
    np.testing.assert_array_equal(got[:m, :n].numpy(), (a.double() @ b.double()).numpy())
    assert not bool(got[m:].any()) and not bool(got[:, n:].any())


def test_fp8_through_the_seam_takes_the_reference_route():
    a, b = _operands(24, 96, 20)
    plan = dispatch.get_plan(96, substrate="fp8")
    assert plan.substrate == "fp8" and plan is dispatch.get_plan(96, substrate="fp8")
    assert dispatch.choose_route(plan, "gemm", "kernel") == "ref"
    got = dispatch.matmul(torch.from_numpy(a), torch.from_numpy(b), substrate="fp8")
    np.testing.assert_array_equal(got.numpy(),
                                  dispatch.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy())
    x = torch.from_numpy(RNG.standard_normal((2, 3, 96)))
    out = dispatch.dot(x, torch.from_numpy(b), substrate="fp8")
    np.testing.assert_array_equal(out.numpy(), dispatch.dot(x, torch.from_numpy(b)).numpy())


@pytest.mark.parametrize("name", ["ozaki2_fp8", "ozaki1_int8"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_policy_dot_bitwise(name, dtype):
    x = RNG.standard_normal((2, 5, 48)).astype(dtype)
    w = RNG.standard_normal((48, 20)).astype(dtype)
    got = Policy(name).dot(torch.from_numpy(x), torch.from_numpy(w))
    want = np.asarray(JPolicy(name).dot(jnp.asarray(x), jnp.asarray(w)))
    assert got.dtype == torch.from_numpy(x).dtype and tuple(got.shape) == (2, 5, 20)
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "ozaki2_fp8":
        np.testing.assert_array_equal(
            got.numpy(), Policy("ozaki2_int8").dot(torch.from_numpy(x), torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("name", ["ozaki2_int8", "ozaki2_fp8", "ozaki1_int8"])
def test_emulated_gradient_raises_naming_slice_10(name):
    """Slice 10's VJP is ported: every emulated dot has a gradient.  ozaki2_fp8's
    is bitwise ozaki2_int8's (the same integers on both substrates); ozaki1_int8's
    is within 16 u of g·Wᵀ against |g|·|Wᵀ|."""
    x_np = RNG.standard_normal((2, 4))
    w_np = RNG.standard_normal((4, 3))
    g_np = RNG.standard_normal((2, 3))

    def grad_x(policy):
        x = torch.from_numpy(x_np).requires_grad_(True)
        Policy(policy).dot(x, torch.from_numpy(w_np)).backward(torch.from_numpy(g_np))
        return x.grad.numpy()

    got = grad_x(name)
    assert got.shape == (2, 4)
    if name == "ozaki1_int8":
        err = np.abs(got - g_np @ w_np.T) / (np.abs(g_np) @ np.abs(w_np.T))
        assert err.max() <= 16 * 2.0 ** -53
    else:
        np.testing.assert_array_equal(got, grad_x("ozaki2_int8"))
    x = torch.ones((2, 4), dtype=torch.float64, requires_grad=True)
    w = torch.ones((4, 3), dtype=torch.float64)
    with torch.no_grad():
        assert tuple(Policy(name).dot(x, w).shape) == (2, 3)
    assert tuple(Policy(name).dot(x.detach(), w).shape) == (2, 3)


@pytest.mark.parametrize("k", [2, 48, 4096, 8192, 1 << 20])
def test_ozaki1_plan_matches_reference(k):
    assert ozaki1.slice_width(k) == jo1.slice_width(k)
    assert ozaki1.slice_width(k, w_acc=24, input_bits=11) == jo1.slice_width(k, 24, 11)
    for full in (True, False):
        tp, jp = ozaki1.make_plan(k, full_cross=full), jo1.make_plan(k, full_cross=full)
        assert (tp.slice_bits, tp.num_slices, tp.payload_bits, tp.full_cross, tp.num_gemms) == \
            (jp.slice_bits, jp.num_slices, jp.payload_bits, jp.full_cross, jp.num_gemms)
    assert ozaki1.make_plan(8192).num_gemms == 64


@pytest.mark.parametrize("axis", [-1, 0])
def test_ozaki1_slices_bitwise(axis):
    x, _ = _operands(10, 64, 1)
    plan = ozaki1.make_plan(64)
    sl, sh = ozaki1.slice_decompose(torch.from_numpy(x), plan, axis)
    jsl, jsh = jo1.slice_decompose(jnp.asarray(x), jo1.make_plan(64), axis)
    assert sl.dtype == torch.int8 and sh.dtype == torch.int32
    np.testing.assert_array_equal(sl.numpy(), np.asarray(jsl))
    np.testing.assert_array_equal(sh.numpy(), np.asarray(jsh))


@pytest.mark.parametrize("mkn,full", [((12, 40, 7), True), ((33, 128, 5), True),
                                      ((20, 300, 17), False), ((8, 64, 24), True)])
def test_ozaki1_emulated_matmul_bitwise(mkn, full):
    m, k, n = mkn
    a, b = _operands(m, k, n)
    got = ozaki1.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                 ozaki1.make_plan(k, full_cross=full))
    want = jo1.emulated_matmul(jnp.asarray(a), jnp.asarray(b), jo1.make_plan(k, full_cross=full))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if full:
        err = np.abs(got.numpy() - a @ b) / (np.abs(a) @ np.abs(b))
        assert err.max() <= 16 * U                 # tests/test_ozaki1.py's bound


def _ozaki2_case(m, k, n, scale_exp, seed, substrate):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)) * 2.0 ** scale_exp
    b = rng.standard_normal((k, n)) * 2.0 ** -scale_exp
    c = ozaki2.emulated_matmul(torch.from_numpy(a), torch.from_numpy(b),
                               ozaki2.make_plan(k, substrate=substrate)).numpy()
    denom = np.abs(a) @ np.abs(b) + 1e-300
    assert np.max(np.abs(c - a @ b) / denom) <= 32 * U


def _fft_case(n):
    x = np.random.default_rng(n).standard_normal((n, 9)) + 1j * np.random.default_rng(
        n + 1).standard_normal((n, 9))
    got = spectral.fft(torch.from_numpy(x), axis=0).numpy()
    want = np.fft.fft(x, axis=0)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-12


def _subnormal_sum_case():
    vals = [2.225073858507e-311]
    got = float(compensated.neumaier_sum(torch.tensor(vals, dtype=torch.float64)))
    assert got == math.fsum(vals) == vals[0]


@pytest.mark.parametrize("case", [
    ("ozaki2", (2, 71, 9, 0, 0, "int8")),
    ("ozaki2", (2, 54, 13, 0, 0, "int8")),
    ("ozaki2", (5, 146, 13, 19, 788962510, "int8")),
    ("ozaki2", (24, 64, 13, -20, 1208344264, "int8")),
    ("ozaki2", (2, 71, 9, 0, 0, "fp8")),
    ("fft", (32,)), ("fft", (64,)), ("fft", (97,)),
    ("neumaier_sum", ()),
], ids=lambda c: c[0] + "-" + "-".join(map(str, c[1])))
def test_port_exact_on_reference_falsifying_inputs(case):
    """The inputs on which ``repro`` is wrong (ROADMAP queue 3, items 6 and 9):
    its jitted int8 product at batch widths 9 and 13, the batch-9 transforms that
    reach it, and the subnormal that XLA-CPU flushes.  The port is held to exact
    oracles there: numpy's product within 32 u of |A||B| (the property test's
    bound), ``numpy.fft`` within 1e-12, ``math.fsum`` exactly."""
    kind, args = case
    {"ozaki2": _ozaki2_case, "fft": _fft_case, "neumaier_sum": _subnormal_sum_case}[kind](*args)
