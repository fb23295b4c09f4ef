"""The port's TME model (``repro_torch.core.tme``) against the reference's.

Every function is held equal (``==``) to ``repro.core.tme``'s on the same
arguments, with the chip passed explicitly; route names map ``kernel`` to the
reference's ``pallas`` (β = 1) and ``ref`` to its ``xla`` (β = r).
"""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import tme as jtme  # noqa: E402
from repro_torch.core import tme  # noqa: E402

CHIP_NAMES = ("H100", "B200", "B300", "R200", "TPUv5e")
ROUTES = {"kernel": "pallas", "ref": "xla"}
KIND_DIMS = {
    "gemm": [(8192, 8192, 8192), (100, 64, 24)],
    "gemv": [(8192, 8192, 1), (64, 64, 16)],
    "spmv_bell": [(1124864, 27, 1124864), (32, 4)],
    "stencil7": [(256, 256, 256), (8, 9, 10)],
    "reduce": [(16777216,), (4096,)],
    "attention": [(32, 512, 128, 512), (64, 1, 128, 4096), (16, 8, 16)],
}


def _fields(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("name", CHIP_NAMES)
def test_chips_and_ridges_equal_reference(name):
    spec, jspec = tme.CHIPS[name], jtme.CHIPS[name]
    assert _fields(spec) == _fields(jspec)
    assert spec.native_ridge == jspec.native_ridge
    assert spec.fp64_matrix_native() == jspec.fp64_matrix_native()
    for r in (8, 10, 16):
        for substrate in ("int8", "fp8", "bf16"):
            for fused in (True, False):
                for planes in (True, False):
                    p = tme.EmulationParams.ozaki2(r, substrate, fused, planes)
                    jp = jtme.EmulationParams.ozaki2(r, substrate, fused, planes)
                    assert _fields(p) == _fields(jp)
                    assert tme.crossover_oi(spec, p) == jtme.crossover_oi(jspec, jp)
                    assert tme.emulation_ridge(spec, p) == jtme.emulation_ridge(jspec, jp)
                    for oi in (0.2, 1.5, 10.0, 100.0):
                        assert tme.emulated_perf(oi, spec, p) == jtme.emulated_perf(oi, jspec, jp)
                        for matrix in (True, False):
                            assert tme.speedup(oi, spec, p, matrix) == \
                                jtme.speedup(oi, jspec, jp, matrix)
                            assert tme.native_perf(oi, spec, matrix) == \
                                jtme.native_perf(oi, jspec, matrix)
        assert tme.garner_gamma(spec, r) == jtme.garner_gamma(jspec, r)
    p = tme.EmulationParams(alpha=13.0, beta=2.0, gamma=1e-12, substrate="int8")
    jp = jtme.EmulationParams(alpha=13.0, beta=2.0, gamma=1e-12, substrate="int8")
    for W, Q, n in ((1e12, 1e9, 1e6), (3.0, 7e10, 0.0)):
        for matrix in (True, False):
            assert tme.native_time(W, Q, spec, matrix) == jtme.native_time(W, Q, jspec, matrix)
        assert tme.emulated_time(W, Q, n, spec, p) == jtme.emulated_time(W, Q, n, jspec, jp)


def test_tables_equal_reference():
    for r in (10, 12, 16):
        assert tme.table3_speedups(r) == jtme.table3_speedups(r)
        assert tme.table4_h100_baseline(r) == jtme.table4_h100_baseline(r)
        assert tme.table5_substrates(r) == jtme.table5_substrates(r)
    for chip in ("H100", "B200", "B300", "R200"):
        assert tme.moduli_sensitivity(chip) == jtme.moduli_sensitivity(chip)
    assert tme.moduli_sensitivity() == jtme.moduli_sensitivity()
    assert [_fields(w) for w in tme.WORKLOADS] == [_fields(w) for w in jtme.WORKLOADS]
    assert tme.REDUCE_EFT_ALPHA == jtme.REDUCE_EFT_ALPHA


@pytest.mark.parametrize("kind", sorted(KIND_DIMS))
def test_op_costs_and_predictions_equal_reference(kind):
    for dims in KIND_DIMS[kind]:
        assert tme.op_costs(kind, dims) == jtme.op_costs(kind, dims)
        for name in CHIP_NAMES:
            spec, jspec = tme.CHIPS[name], jtme.CHIPS[name]
            for route, jroute in ROUTES.items():
                for r, alpha, substrate in ((16, None, "int8"), (10, None, "fp8"),
                                            (15, 48.0, "fp8"), (7, 7.0, "int8")):
                    got = tme.predict_op_time(kind, dims, r=r, alpha=alpha,
                                              substrate=substrate, route=route, spec=spec)
                    want = jtme.predict_op_time(kind, dims, r=r, alpha=alpha,
                                                substrate=substrate, route=jroute, spec=jspec)
                    assert got == want
                    if kind == "attention":
                        assert tme.attention_emulated_time(
                            dims, r=r, alpha=alpha, substrate=substrate, route=route,
                            spec=spec) == jtme.attention_emulated_time(
                            dims, r=r, alpha=alpha, substrate=substrate, route=jroute,
                            spec=jspec)
    with pytest.raises(ValueError):
        tme.op_costs("conv", (1, 2, 3))


def test_defaults_to_h100_and_reads_no_environment(monkeypatch):
    """The port's default chip is the H100 whatever the environment holds; the
    reference's is the one its variable names."""
    monkeypatch.setenv(jtme.CHIP_VAR, "H100")
    dims = (8192, 8192, 8192)
    assert tme.predict_op_time("gemm", dims, r=16) == jtme.predict_op_time("gemm", dims, r=16)
    monkeypatch.setenv(jtme.CHIP_VAR, "TPUv5e")
    assert tme.predict_op_time("gemm", dims, r=16) == \
        jtme.predict_op_time("gemm", dims, r=16, spec=jtme.H100)
    assert tme.DEFAULT_CHIP is tme.H100
    assert tme.predict_op_time("stencil7", (64, 64, 64), r=15, route="kernel") == \
        tme.predict_op_time("stencil7", (64, 64, 64), r=15, route="kernel", spec=tme.H100)
    src = open(tme.__file__).read()
    assert "os.environ" not in src and "REPRO_" not in src


@pytest.mark.parametrize("n", [64, 256, 4096, (1 << 10) * 3, 1 << 20])
def test_bailey_fft_stages_equal_reference(n):
    for batch in (1, 8):
        got = [_fields(s) for s in tme.bailey_fft_stages(n, batch)]
        want = [_fields(s) for s in jtme.bailey_fft_stages(n, batch)]
        assert got == want
    for name in ("H100", "B300"):
        spec, jspec = tme.CHIPS[name], jtme.CHIPS[name]
        p = dataclasses.replace(tme.EmulationParams.ozaki2(12), gamma=tme.garner_gamma(spec, 12))
        jp = dataclasses.replace(jtme.EmulationParams.ozaki2(12),
                                 gamma=jtme.garner_gamma(jspec, 12))
        assert tme.fft_emulated_time(n, spec, p, 4) == jtme.fft_emulated_time(n, jspec, jp, 4)
        assert tme.fft_native_time(n, spec, 4) == jtme.fft_native_time(n, jspec, 4)
        for s, js in zip(tme.bailey_fft_stages(n), jtme.bailey_fft_stages(n)):
            assert s.emulated_s(spec, p) == js.emulated_s(jspec, jp)


def test_table_fft_equal_reference():
    assert tme.table_fft() == jtme.table_fft()
    sizes = (1 << 12, 3 << 10)
    assert tme.table_fft(r=14, batch=16, sizes=sizes) == jtme.table_fft(r=14, batch=16,
                                                                       sizes=sizes)


def test_roofline_terms_equal_reference_with_explicit_constants():
    for args in ((1e15, 1e12, 1e10, 4), (3e12, 0.0, 0.0, 1), (1.0, 2.0, 3.0, 512)):
        for consts in ((197e12, 819e9, 50e9), (989e12, 3.35e12, 450e9), (1e12, 1e12, 1e9)):
            got = tme.roofline_terms(*args, *consts)
            want = jtme.roofline_terms(*args, *consts)
            assert _fields(got) == _fields(want)
            assert got.dominant == want.dominant and got.bound_s == want.bound_s
            assert got.fraction_of_roofline() == want.fraction_of_roofline()


def test_roofline_defaults_are_the_h100s():
    assert tme.PEAK_BF16_FLOPS == 989e12 and tme.HBM_BW == 3.35e12 and tme.ICI_BW == 450e9
    t = tme.roofline_terms(989e12, 3.35e12, 450e9, 1)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 1.0)
    assert tme.RooflineTerms(0.0, 0.0, 0.0).fraction_of_roofline() == 0.0
