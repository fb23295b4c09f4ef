"""repro_torch core (moduli, EFTs, Phase-1 splitting) held bitwise against repro."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import moduli as jmod, numerics as jnum, splitting as jspl  # noqa: E402
from repro_torch.core import moduli as tmod, numerics as tnum  # noqa: E402
from repro_torch.core import ozaki2 as toz, splitting as tspl  # noqa: E402

U64 = 2.0 ** -53
RNG = np.random.default_rng(2026)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_moduli_constants_match_reference():
    assert tmod.DEFAULT_MODULI == jmod.DEFAULT_MODULI
    assert tmod.SPLIT_BITS == jmod.SPLIT_BITS == 26
    for r in (1, 7, 15, 16, 20):
        gt = tmod.garner_constants(tmod.DEFAULT_MODULI[:r])
        gj = jmod.garner_constants(jmod.DEFAULT_MODULI[:r])
        for field in ("inv_pref", "pref_mod", "pref_f64", "pref_f64_lo"):
            _eq(getattr(gt, field), getattr(gj, field))
        assert gt.prod == gj.prod
    for k in (1, 48, 1537, 8192, 1 << 20):
        for p in (24, 53):
            for margin in (2, 4):
                assert tmod.required_r(k, p, margin) == jmod.required_r(k, p, margin)
    for r in (4, 7, 16):
        for k in (32, 8192):
            assert tmod.max_payload_bits(r, k) == jmod.max_payload_bits(r, k)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_eft_bitwise(dtype):
    x = (RNG.standard_normal(4096) * np.exp(RNG.uniform(-20, 20, 4096))).astype(dtype)
    y = (RNG.standard_normal(4096) * np.exp(RNG.uniform(-20, 20, 4096))).astype(dtype)
    big = np.where(np.abs(x) >= np.abs(y), x, y)
    small = np.where(np.abs(x) >= np.abs(y), y, x)
    for fn in ("two_sum", "two_prod"):
        for got, want in zip(getattr(tnum, fn)(_t(x), _t(y)),
                             getattr(jnum, fn)(jnp.asarray(x), jnp.asarray(y))):
            _eq(got, want)
    for got, want in zip(tnum.fast_two_sum(_t(big), _t(small)),
                         jnum.fast_two_sum(jnp.asarray(big), jnp.asarray(small))):
        _eq(got, want)


def _operand(shape, axis):
    """Random operand with per-slice scales over e^±30, a zero slice, and one
    slice each near 1e-300 and 1e+200 (shifts far outside [-1022, 1023]).  No
    entry is denormal: the reference's CPU backend flushes denormals."""
    x = RNG.standard_normal(shape)
    scale_shape = [1, 1]
    scale_shape[1 - axis] = shape[1 - axis]
    x = x * np.exp(RNG.uniform(-30, 30, scale_shape))
    idx = [slice(None)] * 2
    for i, s in ((0, 0.0), (1, 1e-300), (2, 1e200)):
        idx[1 - axis] = i
        x[tuple(idx)] = RNG.uniform(0.5, 2.0, shape[axis]) * s
    return x


@pytest.mark.parametrize("axis", [-1, 0])
def test_scale_split_residues_bitwise(axis):
    x = _operand((24, 40), axis % 2)
    moduli = tmod.DEFAULT_MODULI[:16]
    xi_t, sh_t = tspl.scale_to_int(_t(x), 53, axis)
    xi_j, sh_j = jspl.scale_to_int(jnp.asarray(x), 53, axis)
    _eq(xi_t, xi_j)
    _eq(sh_t, sh_j)
    hi_t, lo_t = tspl.split_hi_lo(xi_t)
    hi_j, lo_j = jspl.split_hi_lo(xi_j)
    _eq(hi_t, hi_j)
    _eq(lo_t, lo_j)
    assert hi_t.dtype == lo_t.dtype == torch.int32
    _eq(tspl.merge_hi_lo(hi_t, lo_t), jspl.merge_hi_lo(hi_j, lo_j))
    _eq(tspl.residues_from_hilo(hi_t, lo_t, moduli),
        jspl.residues_from_hilo(hi_j, lo_j, moduli))
    _eq(tspl.residues_direct(xi_t, moduli), jspl.residues_direct(xi_j, moduli))


def test_scale_to_int_f32_payload24_bitwise():
    x = (RNG.standard_normal((16, 32)) * np.exp(RNG.uniform(-30, 30, (16, 1)))
         ).astype(np.float32)
    xi_t, sh_t = tspl.scale_to_int(_t(x), 24, -1)
    xi_j, sh_j = jspl.scale_to_int(jnp.asarray(x), 24, -1)
    _eq(xi_t, xi_j)
    _eq(sh_t, sh_j)


def test_ldexp_and_unscale_match_reference_at_extreme_shifts():
    c = RNG.standard_normal((6, 5)) * 2.0 ** 100
    sr = np.array([-1100, -700, 0, 300, 1000, 1060], np.int32)
    sc = np.array([1050, 40, -30, 0, -900], np.int32)
    got = tspl.apply_unscale(_t(c), _t(sr), _t(sc)).numpy()
    want = np.asarray(jspl.apply_unscale(jnp.asarray(c), jnp.asarray(sr), jnp.asarray(sc)))
    normal = np.abs(want) >= np.finfo(np.float64).tiny  # the reference flushes denormals
    np.testing.assert_array_equal(got[normal], want[normal])
    x = np.array([1e-300, -3e-310, 0.0, np.inf, -np.inf, 5.0])
    n = np.array([1049, 1070, 7, 3, -2, -1080], np.int32)
    got = tspl.ldexp(_t(x), _t(n)).numpy()
    np.testing.assert_array_equal(got, np.ldexp(x, n))  # exact, denormals included


def test_scale_to_int_accurate_just_below_powers_of_two():
    """absmax = nextafter(2^e, 0): torch's and XLA's log2 may round to different
    exponents here (so the bits may differ), but the product stays accurate."""
    exps = np.arange(-480, 480, 37)
    a = RNG.uniform(-0.5, 0.5, (len(exps), 48))
    a[:, 0] = 1.0
    a = a * np.nextafter(2.0 ** exps, 0)[:, None]
    b = RNG.standard_normal((48, 12))
    xi, _ = tspl.scale_to_int(_t(a), 53, -1)
    assert float(xi.abs().max()) < 2.0 ** 53
    c = toz.emulated_matmul(_t(a), _t(b), toz.make_plan(48)).numpy()
    exact = a @ b
    err = np.abs(c - exact) / (np.abs(a) @ np.abs(b))
    assert err.max() <= 16 * U64
