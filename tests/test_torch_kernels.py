"""repro_torch.kernels: plain versions held bitwise against repro.kernels (CPU).
The CUDA kernels are held against their plain versions in test_torch_cuda.py.

The two interpret-mode Pallas calls of this file (one gemm, one gemv) pin the f64
output of the port's ``ops`` to the TPU kernels' own semantics; the digits and ds
representations are pinned against ``repro.kernels.common`` applied to
``repro.core.ozaki2.modular_matmul``'s residues, which needs no further Pallas call.
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ozaki2 as jo  # noqa: E402
from repro.kernels import common as jc, ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dispatch, moduli, splitting  # noqa: E402
from repro_torch.kernels import _build, ops, ozaki_gemm, ozaki_gemv  # noqa: E402

RNG = np.random.default_rng(7)


def _operands(m, k, n):
    a = RNG.standard_normal((m, k)) * np.exp(RNG.uniform(-10, 10, (m, 1)))
    b = RNG.standard_normal((k, n)) * np.exp(RNG.uniform(-10, 10, (1, n)))
    return a, b


def _plans(k):
    jp = jo.make_plan(k)
    return jp, convert.plan_from_fields(jp.moduli, jp.payload_bits)


def _hilo(x, plan, axis):
    xi, _ = splitting.scale_to_int(x, plan.payload_bits, axis)
    return splitting.split_hi_lo(xi)


def test_ops_gemm_f64_matches_pallas_interpret():
    a, b = _operands(24, 48, 20)
    jp, tp = _plans(48)
    want = jops.ozaki_gemm(jnp.asarray(a), jnp.asarray(b), plan=jp, out_rep="f64",
                           bm=8, bn=8, bk=16, interpret=True)
    got = ops.ozaki_gemm(torch.from_numpy(a), torch.from_numpy(b), plan=tp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ops_gemv_f64_matches_pallas_interpret():
    a, x = _operands(16, 40, 3)
    jp, tp = _plans(40)
    want = jops.ozaki_gemv(jnp.asarray(a), jnp.asarray(x), plan=jp, out_rep="f64",
                           interpret=True)
    got = ops.ozaki_gemv(torch.from_numpy(a), torch.from_numpy(x), plan=tp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mkn", [(24, 48, 20), (17, 64, 1)])
@pytest.mark.parametrize("out_rep", ["digits", "ds", "f64"])
def test_kernel_plain_versions_match_reference_garner(mkn, out_rep):
    m, k, n = mkn
    a, b = _operands(m, k, n)
    jp, tp = _plans(k)
    ar, _ = jo.decompose(jnp.asarray(a), jp, scale_axis=-1)
    br, _ = jo.decompose(jnp.asarray(b), jp, scale_axis=0)
    cres = jo.modular_matmul(ar, br, jp)
    digits = jc.garner_digits([cres[i] for i in range(jp.r)], jp)
    if out_rep == "digits":
        want = np.asarray(jc.stack_digits_int8(digits))
    elif out_rep == "ds":
        want = np.stack([np.asarray(v) for v in jc.digits_to_ds(digits, jp)])
    else:
        want = np.asarray(jc.digits_to_f64(digits, jp))
    ah, al = _hilo(torch.from_numpy(a), tp, -1)
    bh, bl = _hilo(torch.from_numpy(b), tp, 0)
    wrapper = ozaki_gemv.gemv_hilo if n <= ozaki_gemv.MAX_B else ozaki_gemm.gemm_hilo
    got = wrapper(ah, al, bh, bl, tp, out_rep)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_output_representations_agree():
    a, b = _operands(20, 64, 24)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    f64 = ops.ozaki_gemm(ta, tb, out_rep="f64")
    np.testing.assert_array_equal(ops.ozaki_gemm(ta, tb, out_rep="digits").numpy(),
                                  f64.numpy())
    ds = ops.ozaki_gemm(ta, tb, out_rep="ds")
    denom = np.abs(a) @ np.abs(b)
    assert np.max(np.abs(ds.numpy() - f64.numpy()) / denom) <= 2.0 ** -44
    y = ops.ozaki_gemv(ta, tb[:, :3], out_rep="digits")
    np.testing.assert_array_equal(y.numpy(), ops.ozaki_gemv(ta, tb[:, :3]).numpy())


def test_wrappers_validate_and_count_only_launches():
    plan = dispatch.get_plan(64)
    h = torch.zeros((8, 64), dtype=torch.int32)
    x = torch.zeros((64, 17), dtype=torch.int32)
    before = (ozaki_gemm.gemm_hilo.launches, ozaki_gemv.gemv_hilo.launches)
    ozaki_gemm.gemm_hilo(h, h, x, x, plan)           # CPU: the plain version, no launch
    assert (ozaki_gemm.gemm_hilo.launches, ozaki_gemv.gemv_hilo.launches) == before
    with pytest.raises(ValueError):
        ozaki_gemv.gemv_hilo(h, h, x, x, plan)        # 17 columns: too wide for the GEMV
    with pytest.raises(TypeError):
        ozaki_gemm.gemm_hilo(h.to(torch.int64), h, x, x, plan)
    with pytest.raises(ValueError):
        ozaki_gemm.gemm_hilo(h, h, x, x, plan, out_rep="f32")


def test_cuda_sources_agree_with_python_side():
    """The moduli table compiled into the kernels, and the parameter block's
    layout, are those of the Python side."""
    text = (pathlib.Path(_build.CSRC) / "ozaki_common.cuh").read_text()
    table = dict((int(i), int(m)) for i, m in re.findall(r"case (\d+): return (\d+);", text))
    tail = int(re.search(r"default: return (\d+);", text).group(1))
    compiled = tuple(table.get(i, tail) for i in range(_build.MAX_R))
    assert compiled == moduli.DEFAULT_MODULI
    assert f"kMaxR = {_build.MAX_R};" in text
    assert ctypes.sizeof(_build.GarnerParams) == (4 + 4 * 20 * 2 + 4 * 400 + 4 + 16 * 20
                                                  + 8 * 20 + 16 * 20)
    p = _build.garner_params(dispatch.get_plan(8192))
    gc = dispatch.get_plan(8192).garner
    assert p.r == 16 and list(p.moduli[:16]) == list(moduli.DEFAULT_MODULI[:16])
    assert list(p.pref_f64[:16]) == list(gc.pref_f64)
    assert p.pref_mod[1 * 20 + 5] == gc.pref_mod[1, 5]
    # digits_to_f64's split of each prefix product, as the plain version splits it
    for j in range(16):
        ph = np.float64(gc.pref_f64[j])
        c = np.float64(2.0 ** 27 + 1.0) * ph
        assert p.pref_f64_h[j] == c - (c - ph) and p.pref_f64_l[j] == ph - (c - (c - ph))
    assert "double pref_f64_h[kMaxR];" in text and "double pref_f64_l[kMaxR];" in text


def test_ctypes_argtypes_match_the_c_entry_points():
    """Every source's entry points take, in order, what ``_build.ENTRY_POINTS``
    declares: c_int for an int, c_int64 for an int64_t, c_double for a double,
    c_void_p for every pointer and the stream."""
    assert set(_build.ENTRY_POINTS) == set(_build.SOURCES + _build.PROBES)
    for name in _build.SOURCES + _build.PROBES:
        text = (pathlib.Path(_build.CSRC) / f"{name}.cu").read_text()
        entries = _build.ENTRY_POINTS[name]
        assert len(re.findall(r'extern "C" int ', text)) == len(entries), name
        for entry, argtypes in entries:
            sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
            assert sig, entry
            params = [p.strip() for p in sig.group(1).split(",")]
            want = [ctypes.c_void_p if "*" in p else
                    ctypes.c_int64 if p.startswith("int64_t ") else
                    ctypes.c_double if p.startswith("double ") else ctypes.c_int for p in params]
            assert all(p.startswith(("int ", "int64_t ", "double ", "const ", "void*", "int8_t*",
                                     "int*", "double*"))
                       for p in params), params
            assert argtypes == want, entry
