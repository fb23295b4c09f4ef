"""repro_torch.spectral held against repro.spectral, numpy.fft and an exact DFT (CPU).

Tolerances:
  * The DFT tables, the realified operators, the twiddles and ``dft_dense``
    (n <= 64, and the dense fallback of a prime length) are bitwise equal to
    ``repro``: the same numpy tables and one correctly rounded seam GEMM.
  * Composite lengths differ from ``repro`` in the twiddle product (XLA-CPU
    fuses it into two FMAs, ROADMAP queue 3, item 2): within
    ``dft_error_bound(n)·max|X|`` of ``repro`` and of an exact DFT (long double).
  * Against ``numpy.fft``, whose own error is up to ~0.54 of that bound here,
    within twice the bound: the distance between two transforms, each within
    one bound of the exact DFT.
Batch widths avoid 9 and 13, where ``repro``'s jitted emulated GEMM is wrong
(ROADMAP queue 3, item 9); ``tests/test_torch_fp8.py`` holds the port to
exact oracles there.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import spectral as jspec  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.spectral import dft as jdft  # noqa: E402
from repro_torch import spectral  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.spectral import bailey, dft  # noqa: E402

RNG = np.random.default_rng(23)
SIZES = (8, 30, 97, 120, 384, 1024)
PI = np.longdouble("3.14159265358979323846264338327950288")


def _complex(*shape):
    return RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)


def _exact_dft(x, inverse=False):
    """DFT along axis 0 in long double (64-bit significand), exact argument reduction."""
    n = x.shape[0]
    j = np.arange(n)
    ang = (2 if inverse else -2) * PI * np.mod(np.outer(j, j), n).astype(np.longdouble) / n
    c, s = np.cos(ang), np.sin(ang)
    xr, xi = x.real.astype(np.longdouble), x.imag.astype(np.longdouble)
    return c @ xr - s @ xi, s @ xr + c @ xi


def _err(got, want_re, want_im):
    """max |got - want| over real and imaginary parts / max |want|."""
    got = np.asarray(got)
    scale = float(np.max(np.hypot(np.asarray(want_re, np.float64), np.asarray(want_im, np.float64))))
    d = max(float(np.max(np.abs(got.real - want_re))), float(np.max(np.abs(got.imag - want_im))))
    return d / scale


def _ref(fn, *args, **kw):
    with jdispatch.mode_scope("xla"):
        return np.asarray(fn(*args, **kw))


@pytest.mark.parametrize("n", [1, 2, 8, 30, 64, 97, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_dft_tables_bitwise(n, inverse):
    np.testing.assert_array_equal(dft.dft_matrix(n, inverse), jdft.dft_matrix(n, inverse))
    np.testing.assert_array_equal(dft.realified_dft(n, inverse).numpy(),
                                  np.asarray(jdft.realified_dft(n, inverse)))
    f = bailey.choose_factors(n)
    assert f == jspec.choose_factors(n)
    if f is not None:
        n1, n2 = f
        np.testing.assert_array_equal(dft.twiddle(n, n1, n2, inverse).numpy(),
                                      np.asarray(jdft.twiddle(n, n1, n2, inverse)))


def test_tables_cached_per_device_and_bounded():
    dft.cache_clear()
    a = dft.realified_dft(16)
    assert dft.realified_dft(16) is a and dft.realified_dft(16, device="cpu") is a
    assert dft.realified_dft(dft.CACHE_MAX + 1) is not dft.realified_dft(dft.CACHE_MAX + 1)
    w = dft.twiddle(256, 16, 16)
    assert dft.twiddle(256, 16, 16) is w and w.dtype == torch.complex128
    with pytest.raises(ValueError, match="dense DFT fallback refused"):
        dft.realified_dft(dft.DENSE_HARD_MAX + 1)
    assert (dft.DENSE_MAX, dft.DENSE_HARD_MAX, dft.CACHE_MAX, dft.TWIDDLE_CACHE_MAX) == \
        (jdft.DENSE_MAX, jdft.DENSE_HARD_MAX, jdft.CACHE_MAX, jdft.TWIDDLE_CACHE_MAX)


@pytest.mark.parametrize("n,batch,inverse", [(8, 5, False), (64, 20, True)])
def test_dft_dense_bitwise(n, batch, inverse):
    x = _complex(n, batch)
    got = dft.dft_dense(torch.from_numpy(x), inverse=inverse)
    want = _ref(jdft.dft_dense, jnp.asarray(x), inverse=inverse)
    assert got.dtype == torch.complex128
    np.testing.assert_array_equal(got.numpy(), want)


# Lengths compared with ``repro`` (each new GEMM shape costs it a jit compile):
# dense, the prime fallback (one dense GEMM), and two composites.
REF_SIZES = (30, 97, 120, 1024)


@pytest.mark.parametrize("n", SIZES)
def test_fft_and_ifft_within_bound(n):
    x = _complex(n, 3)
    bound = spectral.dft_error_bound(n)
    got = spectral.fft(torch.from_numpy(x), axis=0)
    if n in REF_SIZES:
        want = _ref(jspec.fft, jnp.asarray(x), axis=0)
        if n <= dft.DENSE_MAX or bailey.choose_factors(n) is None:
            np.testing.assert_array_equal(got.numpy(), want)
        assert _err(got, want.real, want.imag) <= bound
    assert _err(got, *_exact_dft(x)) <= bound
    ref = np.fft.fft(x, axis=0)
    assert _err(got, ref.real, ref.imag) <= 2 * bound
    # ifft along the last axis of the transposed operand: the 1/n normalisation
    xt = np.ascontiguousarray(x.T)
    inv = spectral.ifft(torch.from_numpy(xt))
    if n in REF_SIZES:
        want = _ref(jspec.ifft, jnp.asarray(xt))
        assert _err(inv, want.real, want.imag) <= bound
    er, ei = _exact_dft(x, inverse=True)
    assert _err(inv, (er / n).T, (ei / n).T) <= bound
    ref_inv = np.fft.ifft(xt)
    assert _err(inv, ref_inv.real, ref_inv.imag) <= 2 * bound


@pytest.mark.parametrize("n", [8, 30, 97, 120, 384])
def test_rfft_and_irfft(n):
    x = RNG.standard_normal((3, n))
    bound = spectral.dft_error_bound(n)
    half = spectral.rfft(torch.from_numpy(x))
    assert tuple(half.shape) == (3, n // 2 + 1)
    ref = np.fft.rfft(x)
    assert _err(half, ref.real, ref.imag) <= 2 * bound
    back = spectral.irfft(half, n=n)
    assert back.dtype == torch.float64
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=4 * bound * np.abs(x).max())
    for m in (n - 3, n + 4):    # numpy's truncation (m < n) and zero padding (m > n)
        got = spectral.irfft(torch.from_numpy(ref), n=m).numpy()
        want = np.fft.irfft(ref, n=m)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 2 * spectral.dft_error_bound(m) * np.abs(want).max()
    with pytest.raises(ValueError, match="real input"):
        spectral.rfft(torch.from_numpy(_complex(8)))


def test_rfft_and_irfft_against_reference():
    x = RNG.standard_normal((3, 30))
    bound = spectral.dft_error_bound(30)
    half = spectral.rfft(torch.from_numpy(x))
    want = _ref(jspec.rfft, jnp.asarray(x))
    np.testing.assert_array_equal(half.numpy(), want)      # one dense GEMM
    # the half spectra of lengths 34 and 26 (18 and 14 coefficients) truncated
    # and zero-padded to the 16 that a length-30 inverse uses
    for m in (34, 26):
        h = np.fft.rfft(RNG.standard_normal((3, m)))
        got = spectral.irfft(torch.from_numpy(h), n=30).numpy()
        want_m = _ref(jspec.irfft, jnp.asarray(h), n=30)
        assert got.shape == want_m.shape == (3, 30)
        assert np.abs(got - want_m).max() <= bound * np.abs(want_m).max()
        ref = np.fft.irfft(h, n=30)
        assert np.abs(got - ref).max() <= 2 * bound * np.abs(ref).max()


def test_irfft_default_length_and_axis():
    x = RNG.standard_normal((6, 16))
    h = np.fft.rfft(x, axis=0)                    # (4, 16): default n = 2·(4 − 1) = 6
    got = spectral.irfft(torch.from_numpy(h), axis=0).numpy()
    assert got.shape == (6, 16)
    np.testing.assert_allclose(got, x, rtol=0, atol=2 * spectral.dft_error_bound(6) * 16)


@pytest.mark.parametrize("axes", [None, (0, 2), (1,), (-1, 0)])
def test_fftn_and_ifftn_axis_subsets(axes):
    x = _complex(6, 8, 10)
    got = spectral.fftn(torch.from_numpy(x), axes=axes)
    ref = np.fft.fftn(x, axes=axes)
    bound = sum(spectral.dft_error_bound(x.shape[a]) for a in (axes or range(3)))
    assert _err(got, ref.real, ref.imag) <= 2 * bound
    back = spectral.ifftn(got, axes=axes).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=4 * bound * np.abs(x).max())


@pytest.mark.parametrize("fn,axes", [("fftn", None), ("fftn", (1,)), ("fft2", (-2, -1)),
                                     ("ifftn", (0,)), ("ifft2", (-2, -1))])
def test_multi_axis_against_reference(fn, axes):
    """(3, 30): its axes are one dense GEMM each (every length <= 64), so bitwise."""
    x = _complex(3, 30)
    got = getattr(spectral, fn)(torch.from_numpy(x), axes=axes)
    want = _ref(getattr(jspec, fn), jnp.asarray(x), axes=axes)
    if fn.startswith("i"):      # the 1/n scaling: a complex division in both packages
        bound = sum(spectral.dft_error_bound(x.shape[a]) for a in axes)
        assert _err(got, want.real, want.imag) <= bound
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_every_multiplication_routes_through_dispatch(monkeypatch):
    """Each GEMM goes through dispatch.matmul: two for 256 = 16·16, two per axis
    for a 2-D 16 x 256 (the 16 axis is one dense GEMM), and a count that does
    not depend on the batch."""
    calls = []
    real = dispatch.matmul

    def counting(a, b, *args, **kw):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b, *args, **kw)

    monkeypatch.setattr(dispatch, "matmul", counting)
    spectral.fft(torch.from_numpy(_complex(256)))
    assert calls == [((32, 32), (32, 16)), ((32, 32), (32, 16))]
    calls.clear()
    spectral.fftn(torch.from_numpy(_complex(16, 256)))
    assert len(calls) == 3
    calls.clear()
    spectral.fft(torch.from_numpy(_complex(4, 1024)))    # 1024 = 32·32, 32 dense
    assert calls == [((64, 64), (64, 128)), ((64, 64), (64, 128))]


def test_no_raw_matmul_in_spectral_source():
    pkg = pathlib.Path(spectral.__file__).parent
    forbidden = re.compile(r"torch\.(matmul|mm|bmm|einsum|tensordot|inner|dot|vdot|mv|addmm)\("
                           r"|np\.(dot|matmul|einsum)\(|\S @ \S|(?<!dispatch)\.(mm|matmul|bmm)\(")
    files = sorted(pkg.glob("*.py"))
    assert len(files) == 4
    for py in files:
        hits = forbidden.findall(py.read_text())
        assert not hits, f"raw matmul in {py.name}: {hits}"


def test_routes_and_kernel_mode_needs_cuda():
    x = torch.from_numpy(_complex(120, 2))
    np.testing.assert_array_equal(spectral.fft(x, axis=0).numpy(),
                                  spectral.fft(x, axis=0, mode="ref").numpy())
    with dispatch.mode_scope("ref"):
        np.testing.assert_array_equal(spectral.fft(x, axis=0).numpy(),
                                      spectral.fft(x, axis=0, mode="auto").numpy())
    with pytest.raises(ValueError, match="CUDA"):
        spectral.fft(x, axis=0, mode="kernel")


def test_dft_error_bound_matches_reference():
    for n in (1, 8, 64, 65, 97, 256, 4093, 1 << 20, 12 * 32):
        assert spectral.dft_error_bound(n) == jspec.dft_error_bound(n)
