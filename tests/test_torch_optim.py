"""repro_torch's optimizer, schedule, gradient compressor and data pipeline held
against repro's (CPU).

Inputs come from numpy seeds.  Bitwise: ``synth_batch`` and ``Pipeline``
(tokens, labels and the bfloat16 embeddings), ``adamw_update`` with float32
and bfloat16 moments from the same state at any step, ``compress_decompress``
and ``compression_ratio``.  Within stated bounds (ROADMAP queue 3, item 18):
``linear_warmup_cosine`` within SCHEDULE_TOL (torch's float32 ``cos`` differs
from XLA-CPU's in the last bit at some arguments), ``global_norm`` and
``clip_by_global_norm`` within NORM_TOL of the norm (their float32 sums run in
other orders).  Also the port's counterparts of the reference's optimizer,
compression and data tests (``tests/test_substrate.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import DataConfig, Pipeline, synth_batch  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402

# One float32 ulp of 1.0, absolute: the schedule is at most 1 and its cos term
# at most 0.45 (measured at most 2^-24 over steps 0..2999).
SCHEDULE_TOL = 2.0 ** -23
# Relative to the norm: float32 sums of squares in other orders (measured 0 at
# these sizes, 4.1 x 2^-24 over 10^6 terms).
NORM_TOL = 2.0 ** -20

CFG = registry.get_config("yi-6b", smoke=True)
JCFG = jreg.get_config("yi-6b", smoke=True)


def _same(got, want):
    """Bits and dtype of a torch tensor against a numpy or JAX array."""
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    if want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    else:
        got = convert.to_numpy(got)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# --- data pipeline -------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "whisper-medium", "qwen2-vl-72b"])
def test_synth_batch_bitwise_equal_reference(arch):
    """Tokens and labels (decoder), the encoder's bfloat16 frame embeddings
    (encdec) and the vision stub's bfloat16 embeddings and positions."""
    cfg, jcfg = registry.get_config(arch, smoke=True), jreg.get_config(arch, smoke=True)
    dc = DataConfig(global_batch=4, seq_len=16, seed=7)
    jdc = jpipe.DataConfig(global_batch=4, seq_len=16, seed=7)
    for step in (0, 3):
        got = synth_batch(dc, cfg, step, device="cpu")
        want = jpipe.synth_batch(jdc, jcfg, step)
        assert set(got) == set(want)
        for key in want:
            _same(got[key], want[key])


def test_pipeline_deterministic_given_step():
    dc = DataConfig(global_batch=4, seq_len=16, seed=7)
    b1 = synth_batch(dc, CFG, step=3, device="cpu")
    b2 = synth_batch(dc, CFG, step=3, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], synth_batch(dc, CFG, step=4, device="cpu")["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:].numpy(), b1["labels"][:, :-1].numpy())


def test_pipeline_host_sharding_bitwise_and_disjoint():
    shards = []
    for host in (0, 1):
        dc = DataConfig(global_batch=8, seq_len=16, num_hosts=2, host_id=host)
        jdc = jpipe.DataConfig(global_batch=8, seq_len=16, num_hosts=2, host_id=host)
        got = synth_batch(dc, CFG, 0, device="cpu")
        assert got["tokens"].shape == (4, 16)
        _same(got["tokens"], jpipe.synth_batch(jdc, JCFG, 0)["tokens"])
        shards.append(got["tokens"])
    assert not torch.equal(*shards)


def test_pipeline_prefetch_and_resume_bitwise_equal_reference():
    dc = DataConfig(global_batch=2, seq_len=8)
    p = Pipeline(dc, CFG, start_step=0, device="cpu")
    a, b = next(p), next(p)
    p.close()
    assert p.step == 2
    p2 = Pipeline(dc, CFG, start_step=1, device="cpu")
    b_resumed = next(p2)
    p2.close()
    assert torch.equal(b["tokens"], b_resumed["tokens"])
    jp = jpipe.Pipeline(jpipe.DataConfig(global_batch=2, seq_len=8), JCFG, start_step=0)
    ja, jb = next(jp), next(jp)
    jp.close()
    for got, want in ((a, ja), (b, jb)):
        for key in want:
            _same(got[key], want[key])


def test_pipeline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        synth_batch(DataConfig(global_batch=2, seq_len=8), CFG, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        Pipeline(DataConfig(global_batch=2, seq_len=8), CFG)


# --- optimizer --------------------------------------------------------------------

def _adamw_inputs(moment_dtype, step, seed):
    rng = np.random.default_rng(seed)
    shapes = {"a.w": (16, 24), "b.scale": (24,), "c.table": (40, 8)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (0.3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    mdt = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    m = {k: jnp.asarray(0.1 * rng.standard_normal(s), mdt) for k, s in shapes.items()}
    v = {k: jnp.asarray(0.01 * rng.random(s), mdt) for k, s in shapes.items()}
    jstate = {"m": m, "v": v, "step": jnp.asarray(step, jnp.int32)}
    state = {"m": {k: convert.from_numpy(np.array(x), "cpu") for k, x in m.items()},
             "v": {k: convert.from_numpy(np.array(x), "cpu") for k, x in v.items()},
             "step": torch.tensor(step, dtype=torch.int32)}
    return params, grads, jstate, state


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 1, 37, 840, 1750])
def test_adamw_update_bitwise_equal_reference(moment_dtype, step):
    """From the same params, grads and state, at steps whose 0.9^t and 0.95^t
    are normal and subnormal float32 (XLA flushes the latter to 0; 1 - either
    rounds to 1), with a scheduled lr_scale."""
    params, grads, jstate, state = _adamw_inputs(moment_dtype, step, seed=step + 1)
    assert (0.9 ** step < 1.2e-38) == (step == 840) or step == 1750
    cfg = adamw.AdamWConfig(moment_dtype=moment_dtype)
    jcfg = jadamw.AdamWConfig(moment_dtype=moment_dtype)
    for lr_scale in (1.0, 0.25):
        jp, js = jadamw.adamw_update({k: jnp.asarray(v) for k, v in params.items()},
                                     {k: jnp.asarray(v) for k, v in grads.items()},
                                     jstate, jcfg, jnp.asarray(lr_scale, jnp.float32))
        tp, ts = adamw.adamw_update({k: torch.from_numpy(v) for k, v in params.items()},
                                    {k: torch.from_numpy(v) for k, v in grads.items()},
                                    state, cfg, torch.tensor(lr_scale))
        assert list(tp) == list(params)
        for k in params:
            _same(tp[k], jp[k])
            _same(ts["m"][k], js["m"][k])
            _same(ts["v"][k], js["v"][k])
        _same(ts["step"], js["step"])


def test_adamw_init_and_opt_state_from_jax():
    params = {"w": torch.ones((4, 4)), "b": torch.ones(3)}
    for mdt, tdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        st = adamw.adamw_init(params, adamw.AdamWConfig(moment_dtype=mdt))
        assert all(st[key][k].dtype == tdt and not st[key][k].any()
                   for key in ("m", "v") for k in params)
        assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert dataclasses.asdict(adamw.AdamWConfig()) == dataclasses.asdict(jadamw.AdamWConfig())
    # repro's state for a stacked model comes across as the port's names, bit for bit
    jcfg = jreg.get_config("yi-6b", smoke=True)
    from repro.models.transformer import Model as JModel
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    jstate = jadamw.adamw_init(jparams, jadamw.AdamWConfig(moment_dtype="bfloat16"))
    jstate = {"m": jax.tree.map(lambda p: (p * 3).astype(jnp.bfloat16), jparams),
              "v": jstate["v"], "step": jnp.asarray(7, jnp.int32)}
    state = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    names = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert set(state["m"]) == set(state["v"]) == set(names)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 7
    assert state["m"]["layers.1.mixer.wq.w"].dtype == torch.bfloat16
    _same(state["m"]["layers.1.mixer.wq.w"], jstate["m"]["stack"]["b0"]["mixer"]["wq"]["w"][1])


def test_linear_warmup_cosine_within_schedule_tol():
    steps = np.arange(0, 1200, dtype=np.int32)
    for warmup, total in ((100, 1000), (0, 500), (1, 3)):
        want = np.asarray(jax.vmap(lambda s: jsched.linear_warmup_cosine(s, warmup, total))(
            jnp.asarray(steps)))
        got = np.array([float(schedules.linear_warmup_cosine(torch.tensor(int(s)), warmup, total))
                        for s in steps], np.float32)
        assert got.dtype == want.dtype == np.float32
        assert np.abs(got.astype(np.float64) - want).max() <= SCHEDULE_TOL
        assert np.mean(got == want) > 0.9
    assert schedules.constant(5) == jsched.constant(5) == 1.0


def test_global_norm_and_clip_within_norm_tol():
    rng = np.random.default_rng(3)
    for shapes in ([(3,)], [(64, 64), (128,), (64, 256)], [(700, 300), (5,)]):
        g = {f"t{i}": (10 * rng.standard_normal(s)).astype(np.float32)
             for i, s in enumerate(shapes)}
        want = float(jadamw.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        got = adamw.global_norm(tg)
        assert got.dtype == torch.float32 and abs(float(got) - want) <= NORM_TOL * want
        for max_norm in (1.0, 1e6):
            clipped, norm = adamw.clip_by_global_norm(tg, max_norm)
            jclipped, jnorm = jadamw.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()},
                                                         max_norm)
            assert abs(float(norm) - float(jnorm)) <= NORM_TOL * float(jnorm)
            for k in g:
                want_k = np.asarray(jclipped[k])
                assert np.all(np.abs(clipped[k].numpy() - want_k) <= 2 * NORM_TOL * np.abs(want_k))
            if max_norm > want:
                for k in g:
                    _same(clipped[k], jclipped[k])      # scale 1 exactly


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = adamw.AdamWConfig(lr=0.3, weight_decay=0.0)
    state = adamw.adamw_init(params, cfg)
    for _ in range(200):
        params, state = adamw.adamw_update(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_bf16_moments():
    params = {"w": torch.ones((4, 4))}
    cfg = adamw.AdamWConfig(moment_dtype="bfloat16")
    st = adamw.adamw_init(params, cfg)
    p2, st2 = adamw.adamw_update(params, {"w": torch.ones((4, 4))}, st, cfg)
    assert st2["m"]["w"].dtype == torch.bfloat16 and bool(torch.isfinite(p2["w"]).all())


def test_clip_by_global_norm():
    clipped, norm = adamw.clip_by_global_norm({"a": torch.full((3,), 10.0)}, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(300), rel=1e-5)
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


# --- gradient compression ------------------------------------------------------------

def test_compress_decompress_bitwise_equal_reference():
    """Five steps of error feedback on three tensors (one all zeros, one
    bfloat16), from no state and from the reference's state."""
    rng = np.random.default_rng(5)
    shapes = {"a": (64, 64), "b": (33,), "z": (4, 4)}
    jstate = state = None
    for _ in range(5):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        g["z"][:] = 0
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        jg["b"] = jg["b"].astype(jnp.bfloat16)
        tg = {k: convert.from_numpy(np.array(v), "cpu") for k, v in jg.items()}
        jout, jstate = jcomp.compress_decompress(jg, jstate)
        out, state = compression.compress_decompress(tg, state)
        for k in shapes:
            _same(out[k], jout[k])
            _same(state[k], jstate[k])
    q, s = compression._quantize(torch.from_numpy(np.array(jstate["a"])))
    jq, js = jcomp._quantize(jstate["a"])
    _same(q, jq)
    _same(s, js)
    _same(compression._dequantize(q, s), jcomp._dequantize(jq, js))


def test_compression_ratio_equals_reference():
    for shapes in ([(1024, 1024)], [(3,), (5, 7)]):
        g = {f"t{i}": np.zeros(s, np.float32) for i, s in enumerate(shapes)}
        got = compression.compression_ratio({k: torch.from_numpy(v) for k, v in g.items()})
        assert got == jcomp.compression_ratio({k: jnp.asarray(v) for k, v in g.items()})
        if len(shapes) == 1:
            assert 3.5 < got <= 4.0


def test_compression_error_feedback_preserves_mean():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))}
    state = None
    total_raw = np.zeros((64, 64), np.float32)
    total_comp = np.zeros((64, 64), np.float32)
    for _ in range(50):
        comp, state = compression.compress_decompress(g, state)
        total_raw += g["w"].numpy()
        total_comp += comp["w"].numpy()
    rel = np.abs(total_comp - total_raw).max() / np.abs(total_raw).max()
    assert rel < 0.01


def test_training_with_compression_converges():
    cfg = CFG
    model = Model(cfg).init(torch.Generator().manual_seed(1))
    step = make_train_step(model, compress_grads=True, opt_cfg=adamw.AdamWConfig(lr=1e-3))
    opt = adamw.adamw_init(dict(model.named_parameters()))
    dc = DataConfig(global_batch=4, seq_len=16)
    comp_state = None
    losses = []
    for i in range(8):
        opt, metrics, _, comp_state = step(opt, synth_batch(dc, cfg, i % 2, device="cpu"),
                                           comp_state)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]


def test_compression_over_stacked_leaves_equals_reference():
    """repro scales each leaf of its parameter tree, and a leaf stacks a
    block's tensor over the pattern periods: grouped by
    ``Model.stacked_groups`` (two periods of two blocks and a tail layer
    here), the port's per-layer gradients give the reference's bits and
    wire ratio."""
    from repro.configs.base import BlockCfg as JBlockCfg
    from repro.models.transformer import Model as JModel
    from repro_torch.configs.base import BlockCfg

    jcfg = jreg.get_config("yi-6b", smoke=True, num_layers=5,
                           pattern=(JBlockCfg(), JBlockCfg(window=4)))
    cfg = registry.get_config("yi-6b", smoke=True, num_layers=5,
                              pattern=(BlockCfg(), BlockCfg(window=4)))
    jparams = JModel(jcfg).init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(8)
    jgrads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                          jparams)
    grads = convert.params_from_jax(jax.tree.map(np.array, jgrads), device="cpu")
    groups = Model(cfg).load(grads).stacked_groups()
    assert sorted(map(len, groups)) == [2] * len(groups)
    assert ["layers.0.mixer.wq.w", "layers.2.mixer.wq.w"] in groups
    assert not any("layers.4." in k for g in groups for k in g)      # the tail
    jout, jstate = jcomp.compress_decompress(jgrads)
    out, state = compression.compress_decompress(grads, None, groups)
    want_out = convert.params_from_jax(jax.tree.map(np.array, jout), device="cpu")
    want_state = convert.params_from_jax(jax.tree.map(np.array, jstate), device="cpu")
    for k in grads:
        assert torch.equal(out[k], want_out[k]) and torch.equal(state[k], want_state[k]), k
    assert compression.compression_ratio(grads, groups) == jcomp.compression_ratio(jgrads)
    assert compression.compression_ratio(grads) != jcomp.compression_ratio(jgrads)
