"""repro_torch's recurrent-mixer models, xlstm-350m (mLSTM and sLSTM, no MLP)
and jamba-1.5-large-398b (attention and Mamba, dense and MoE MLPs), held
against repro's at their smoke configs (CPU).

Inputs come from numpy seeds; repro's parameters are carried across with
``convert.params_from_jax``.  Logits are held within LOGIT_TOL of their scale,
as in ``tests/test_torch_models.py``: the mixers' float32 exp, tanh, sigmoid
and einsums differ from XLA's in the last bits (ROADMAP queue 3, item 14).
repro's ozaki2_int8 forward compiles for ~25 s (xlstm) and ~33 s (jamba at 2
layers) here, so each runs once.
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
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine  # noqa: E402

EPS = 2.0 ** -23
LOGIT_TOL = 64 * EPS
# jamba's decode against its forward, in units of 2⁻²³·max|logit|: Mamba's
# chunk scan associates otherwise than its decode steps (queue 3, item 14).
JAMBA_DECODE_TOL = 16
ARCHS = ["xlstm-350m", "jamba-1.5-large-398b"]
# jamba-smoke's x_proj is 2·4 + 1 = 9 columns wide, where repro's emulated
# product is wrong (queue 3, item 9; tests/test_torch_ssm.py holds the port's to
# the exact product there): its ozaki2_int8 case runs at state width 8, and on
# its first 2 layers (attention with a dense MLP, Mamba with MoE), which halves
# repro's compile; the fp64 case runs all 4.
OZAKI_OVER = {"jamba-1.5-large-398b": {"ssm_state_dim": 8, "num_layers": 2}}
S = 12


def _models(arch, policy, seed=3, **over):
    jcfg = jreg.get_config(arch, smoke=True, policy_name=policy, compute_dtype="float32",
                           **over)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    cfg = registry.get_config(arch, smoke=True, policy_name=policy, compute_dtype="float32",
                              **over)
    state = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg).load(state)


def _tokens(cfg, seed=67):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, S))


def _decode(model, tokens):
    cache = model.init_cache(batch=tokens.shape[0], seq_len=tokens.shape[1])
    steps = []
    for t in range(tokens.shape[1]):
        lg, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        steps.append(lg[:, 0])
    return torch.stack(steps, dim=1).numpy(), cache


def _fields(cfg):
    return {f.name: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else
            [dataclasses.asdict(b) for b in v] if f.name == "pattern" else v
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    """CONFIG and SMOKE_CONFIG equal repro's on every field the port has, the
    chunks and the conv width among them."""
    for smoke in (False, True):
        cfg, jcfg = registry.get_config(arch, smoke=smoke), jreg.get_config(arch, smoke=smoke)
        got = _fields(cfg)
        assert {"ssm_chunk", "lstm_chunk", "ssm_conv_width"} <= set(got)
        assert got == {k: v for k, v in _fields(jcfg).items() if k in got}
        assert (cfg.param_count(), cfg.active_param_count()) == \
            (jcfg.param_count(), jcfg.active_param_count())
    mixers = {b.mixer for b in registry.get_config(arch).pattern}
    assert mixers == ({"mlstm", "slstm"} if arch == "xlstm-350m" else {"attn", "mamba"})


@pytest.mark.parametrize("policy", ["fp64", "ozaki2_int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch, policy):
    """Forward logits and aux within LOGIT_TOL of the reference's; under fp64
    also each decode step against the reference's jitted decode step."""
    over = OZAKI_OVER.get(arch, {}) if policy == "ozaki2_int8" else {}
    jmodel, jparams, model = _models(arch, policy, **over)
    tokens = _tokens(model.cfg)
    got, aux = model.apply({"tokens": torch.from_numpy(tokens)})
    with jd.mode_scope("xla"):
        want, jaux = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, S, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
    if model.cfg.moe is None:
        assert float(aux) == float(jaux) == 0.0
    else:
        assert abs(float(aux) - float(jaux)) <= 8 * EPS * float(jaux) and float(aux) > 0
    if policy != "fp64":
        return
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


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, chunked):
    """Token-by-token decode against the port's own forward under ozaki2_int8,
    in one chunk or in chunks of 4, at the reference's no-drop capacity factor
    (16): within its 2e-2; xlstm bitwise (the LSTMs' decode step is the
    forward's step, and every product row is exact), jamba within
    JAMBA_DECODE_TOL (Mamba's scan).  The caches keep the shapes and dtypes of
    ``init_cache``: float32 states, KV in the compute dtype."""
    base_cfg = registry.get_config(arch, smoke=True)
    over = {"ssm_chunk": 4, "lstm_chunk": 4} if chunked else {}
    if base_cfg.moe is not None:
        over["moe"] = dataclasses.replace(base_cfg.moe, capacity_factor=16.0)
    cfg = registry.get_config(arch, smoke=True, policy_name="ozaki2_int8",
                              compute_dtype="float32", **over)
    model = Model(cfg).init(torch.Generator().manual_seed(29))
    tokens = _tokens(cfg, seed=71)
    full = model.apply({"tokens": torch.from_numpy(tokens)})[0].numpy()
    dec, cache = _decode(model, tokens)
    np.testing.assert_allclose(dec, full, rtol=2e-2, atol=2e-2)
    if arch == "xlstm-350m":
        np.testing.assert_array_equal(dec, full)
    else:
        np.testing.assert_allclose(dec, full, rtol=0,
                                   atol=JAMBA_DECODE_TOL * EPS * np.abs(full).max())

    def layout(c):
        return [{kind: {k: (tuple(v.shape), v.dtype) for k, v in st.items()}
                 for kind, st in layer.items()} for layer in c]

    assert layout(cache) == layout(model.init_cache(batch=2, seq_len=S))
    kinds = [next(iter(layer)) for layer in cache]
    assert kinds == ["kv" if cfg.block_at(i).mixer == "attn" else "ssm"
                     for i in range(cfg.num_layers)]
    assert all(v.dtype == torch.float32 for layer in cache for st in layer.values()
               for v in st.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trips_every_leaf(arch):
    """bfloat16 storage: every leaf of the reference's tree bit for bit at its
    layer's name (xlstm's period 2, jamba-smoke's period 4 with two MoE
    layers), Mamba's a_log float32 in both; ``Model.init`` makes the same
    names, shapes and dtypes, and its MLP-less layers have no norm2."""
    jcfg = jreg.get_config(arch, smoke=True, param_dtype="bfloat16")
    cfg = registry.get_config(arch, smoke=True, param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(13)))
    state = convert.params_from_jax(tree, device="cpu")
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        assert keys[0] != "tail0"
        for i in range(leaf.shape[0] if keys[0] == "stack" else 1):
            if keys[0] == "stack":
                name = ".".join(["layers", str(cfg.period * i + int(keys[1][1:]))] + keys[2:])
                want = leaf[i]
            else:
                name, want = ".".join(keys), leaf
            got = state[name]
            assert str(got.dtype).split(".")[1] == want.dtype.name
            if got.dtype == torch.bfloat16:
                got, want = got.view(torch.int16), want.view(np.int16)
            np.testing.assert_array_equal(got.numpy(), want)
            n += 1
    assert n == len(state)
    a_logs = [k for k in state if k.endswith("a_log")]
    assert len(a_logs) == (3 if arch != "xlstm-350m" else 0)
    assert all(state[k].dtype == torch.float32 for k in a_logs)
    model = Model(cfg).load(state)
    assert set(model.state_dict()) == set(state)
    made = Model(cfg).init(torch.Generator().manual_seed(0)).state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in made.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in state.items()}
    none = [i for i in range(cfg.num_layers) if cfg.block_at(i).mlp == "none"]
    assert not any(k.startswith(f"layers.{i}.norm2") or k.startswith(f"layers.{i}.mlp")
                   for i in none for k in made)
    assert len(none) == (cfg.num_layers if arch == "xlstm-350m" else 0)


def test_serve_engine_gives_the_reference_tokens():
    """xlstm-smoke under fp64: the port's batcher serves repro's tokens for the
    same 3 requests through 2 slots.  Prefill steps every slot with token 0 (the
    reference's engine does too), so admitting a request advances the
    recurrent state of the slot already serving (ROADMAP queue 3, item 15)."""
    jmodel, jparams, model = _models("xlstm-350m", "fp64")
    prompts = [np.random.default_rng(73 + i).integers(0, model.cfg.vocab_size, 5)
               for i in range(3)]

    def run(batcher, request):
        for uid, p in enumerate(prompts):
            batcher.submit(request(uid=uid, prompt=p.astype(np.int32), max_new_tokens=4))
        return {r.uid: r.generated for r in batcher.run_to_completion()}

    got = run(ContinuousBatcher(ServeEngine(model, batch_slots=2, max_seq=16)), Request)
    want = run(jengine.ContinuousBatcher(jengine.ServeEngine(
        jmodel, jparams, batch_slots=2, max_seq=16, dispatch_mode="xla")), jengine.Request)
    assert got == want and len(got) == 3 and all(len(g) == 4 for g in got.values())
    engine = ServeEngine(model, batch_slots=2, max_seq=16)
    engine.prefill_slot(0, prompts[0])
    before = [c["ssm"]["h"][0].clone() for c in engine.cache[1::2]]
    engine.prefill_slot(1, prompts[1])
    assert all(not torch.equal(b, c["ssm"]["h"][0]) for b, c in zip(before, engine.cache[1::2]))


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_and_batches_are_the_references(arch):
    """Both archs run the long_500k cell; their concrete batches are repro's."""
    assert registry.SUBQUADRATIC == jreg.SUBQUADRATIC
    long = base.SHAPES[-1]
    assert long.name == "long_500k"
    assert registry.cell_is_runnable(arch, long) == (True, "")
    assert (arch, long) in registry.runnable_cells()
    cfg = registry.get_config(arch, smoke=True)
    got = registry.concrete_batch(cfg, base.SHAPES[2], batch=2, seq=16, seed=9, device="cpu")
    want = jreg.concrete_batch(jreg.get_config(arch, smoke=True),
                               jreg.SHAPES_BY_NAME[base.SHAPES[2].name], batch=2, seq=16, seed=9)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_serve_cli_serves_xlstm_on_the_host(capsys):
    serve_cli.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu", "--requests", "2",
                    "--max-new", "3", "--policy", "ozaki2_int8", "--compute-dtype", "float32"])
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "on cpu" in out
