"""repro_torch's dense decoders (gemma-7b, minitron-4b, gemma3-4b), its registry
and its weight converter held against repro's (CPU).

Logits are held within LOGIT_TOL of their scale, as in
``tests/test_torch_models.py``: torch and XLA differ in the last bits of
float32 rsqrt, sin/cos, gelu and exp.  Inputs come from numpy seeds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import dispatch as jd  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

LOGIT_TOL = 64 * 2.0 ** -23
PORTED = ["minitron-4b", "yi-6b", "gemma-7b", "gemma3-4b", "deepseek-moe-16b",
          "llama4-scout-17b-a16e", "whisper-medium", "qwen2-vl-72b"]


def _models(arch, policy):
    jcfg = jreg.get_config(arch, smoke=True, policy_name=policy, compute_dtype="float32")
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(11))
    cfg = registry.get_config(arch, smoke=True, policy_name=policy, compute_dtype="float32")
    state = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg).load(state)


@pytest.mark.parametrize("arch,policy", [
    ("gemma-7b", "fp64"), ("gemma-7b", "ozaki2_int8"),     # GeGLU, tied, head_dim 2·d/H
    ("minitron-4b", "fp64"),                                 # squared ReLU, GQA 3/1
    ("gemma3-4b", "fp64"),                                   # windows of 8 over 12 tokens
])
def test_decoder_forward_and_decode_match_reference(arch, policy):
    jmodel, jparams, model = _models(arch, policy)
    S = 12
    tokens = np.random.default_rng(61).integers(0, model.cfg.vocab_size, (2, S))
    got, aux = model.apply({"tokens": torch.from_numpy(tokens)})
    with jd.mode_scope("xla"):
        want = np.asarray(jmodel.apply(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})[0])
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, S, model.cfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
    cache = model.init_cache(batch=2, seq_len=S)
    with jd.mode_scope("xla"):
        jstep = jax.jit(jmodel.decode_step)
        jcache = jmodel.init_cache(batch=2, seq_len=S)
        for t in range(S):
            lg, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
            jlg, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                                jnp.asarray(t, jnp.int32))
            jlg = np.asarray(jlg)
            np.testing.assert_allclose(lg.numpy(), jlg, rtol=0,
                                       atol=LOGIT_TOL * np.abs(jlg).max())
    if model.cfg.pattern[0].window:
        # the local layers' ring caches hold the window, the global layer's all S
        assert [c["kv"]["k"].shape[1] for c in cache[:6]] == [8] * 5 + [S]


def _fields(cfg):
    """A config's fields as plain values (nested dataclasses as dicts)."""
    return {f.name: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else
            [dataclasses.asdict(b) for b in v] if f.name == "pattern" else v
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_the_reference(arch):
    """CONFIG and SMOKE_CONFIG equal repro's on every field the port has."""
    for smoke in (False, True):
        cfg, jcfg = registry.get_config(arch, smoke=smoke), jreg.get_config(arch, smoke=smoke)
        got = _fields(cfg)
        assert got == {k: v for k, v in _fields(jcfg).items() if k in got}
        assert (cfg.param_count(), cfg.active_param_count()) == \
            (jcfg.param_count(), jcfg.active_param_count())


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "gemma3-4b", "whisper-medium",
                                  "qwen2-vl-72b"])
def test_params_from_jax_round_trips_every_leaf_of(arch):
    """deepseek's stacked experts ((periods, E, d, f) leaves), gemma3's
    period-6 stack with its 2-layer tail (8 = 6 + 2), whisper's encoder stack
    (``"encoder"`` -> ``encoder.{i}``, beside ``enc_pos``, ``enc_norm`` and its
    decoder layers' ``cross`` and ``norm_cross``) and qwen2-vl's untied head."""
    cfg = registry.get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, JModel(jreg.get_config(arch, smoke=True))
                        .init(jax.random.PRNGKey(13)))
    state = convert.params_from_jax(tree, device="cpu")
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    n = 0
    for path, leaf in leaves:
        keys = [p.key for p in path]
        if keys[0] == "stack":
            for i in range(leaf.shape[0]):
                name = ".".join(["layers", str(cfg.period * i + int(keys[1][1:]))] + keys[2:])
                np.testing.assert_array_equal(state[name].numpy(), leaf[i])
                n += 1
        elif keys[0] == "encoder":
            assert leaf.shape[0] == cfg.encoder_layers
            for i in range(leaf.shape[0]):
                np.testing.assert_array_equal(
                    state[".".join(["encoder", str(i)] + keys[1:])].numpy(), leaf[i])
                n += 1
        elif keys[0].startswith("tail"):
            layer = cfg.num_periods * cfg.period + int(keys[0][4:])
            np.testing.assert_array_equal(
                state[".".join(["layers", str(layer)] + keys[1:])].numpy(), leaf)
            n += 1
        else:
            np.testing.assert_array_equal(state[".".join(keys)].numpy(), leaf)
            n += 1
    assert n == len(state)
    if cfg.moe is not None:
        assert tuple(state["layers.1.mlp.experts.wi_gate"].shape) == \
            (cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert)
    else:
        assert {k.split(".")[1] for k in state if k.startswith("layers.")} == \
            {str(i) for i in range(cfg.num_layers)}
        assert ("tail1" in tree) == (arch == "gemma3-4b")
    if cfg.family == "encdec":
        assert {k.split(".")[1] for k in state if k.startswith("encoder.")} == \
            {str(i) for i in range(cfg.encoder_layers)}
        assert {"enc_pos", "enc_norm.scale", "layers.0.cross.wo.w",
                "layers.0.norm_cross.scale"} <= set(state)
    assert set(Model(cfg).load(state).state_dict()) == set(state)


def test_runnable_cells_are_the_references_restricted():
    got = [(a, s.name) for a, s in registry.runnable_cells()]
    want = [(a, s.name) for a, s in jreg.runnable_cells() if a in registry.ARCHS]
    assert got == want and ("gemma3-4b", "long_500k") in got
    assert list(registry.ARCHS) == list(jreg.ARCHS) and len(got) == 33
    assert registry.SUBQUADRATIC == tuple(a for a in jreg.SUBQUADRATIC if a in registry.ARCHS)
    long = base.SHAPES[-1]
    assert registry.cell_is_runnable("yi-6b", long)[0] is False
    assert registry.cell_is_runnable("gemma3-4b", long) == (True, "")


def test_concrete_batch_is_the_references():
    cfg = registry.get_config("deepseek-moe-16b", smoke=True)
    shape = base.SHAPES[0]
    got = registry.concrete_batch(cfg, shape, batch=2, seq=16, seed=5, device="cpu")
    want = jreg.concrete_batch(jreg.get_config("deepseek-moe-16b", smoke=True),
                               jreg.SHAPES_BY_NAME[shape.name], batch=2, seq=16, seed=5)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # whisper's frame embeddings and qwen2-vl's patch embeddings and M-RoPE
    # streams, bfloat16 bit for bit
    for arch, keys in (("whisper-medium", {"tokens", "enc_embeds", "labels"}),
                       ("qwen2-vl-72b", {"embeds", "positions", "labels"})):
        got = registry.concrete_batch(registry.get_config(arch, smoke=True), shape, batch=2,
                                      seq=16, seed=5, device="cpu")
        want = jreg.concrete_batch(jreg.get_config(arch, smoke=True),
                                   jreg.SHAPES_BY_NAME[shape.name], batch=2, seq=16, seed=5)
        assert set(got) == set(want) == keys
        for k in got:
            w = np.asarray(want[k])
            assert tuple(got[k].shape) == w.shape
            if got[k].dtype == torch.bfloat16:
                np.testing.assert_array_equal(got[k].view(torch.int16).numpy(), w.view(np.int16))
            else:
                np.testing.assert_array_equal(got[k].numpy(), w)


def test_serve_cli_serves_deepseek_on_the_host(capsys):
    serve_cli.main(["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
                    "--requests", "2", "--max-new", "3", "--policy", "ozaki2_int8",
                    "--compute-dtype", "float32"])
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "on cpu" in out
