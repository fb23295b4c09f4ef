"""repro_torch's encoder-decoder family, whisper-medium, held against repro's at
its smoke config (CPU).

Inputs come from numpy seeds (the stub frontend's frame embeddings from
``registry.concrete_batch``); repro's parameters are carried across with
``convert.params_from_jax``.  Logits are held within LOGIT_TOL of their scale,
as in ``tests/test_torch_models.py``: torch and XLA differ in the last bits of
float32 rsqrt, sin/cos, gelu and exp.  repro's ozaki2_int8 forward compiles for
~65 s here (its encoder and decoder scans), so it runs once; decode and the
rest run under fp64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import dispatch as jd  # noqa: E402
from repro.core.policy import Policy as JPolicy  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.core.policy import Policy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine  # noqa: E402

EPS = 2.0 ** -23
LOGIT_TOL = 64 * EPS
ARCH = "whisper-medium"
S = 12


def _models(policy, seed=11):
    jcfg = jreg.get_config(ARCH, smoke=True, policy_name=policy, compute_dtype="float32")
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    cfg = registry.get_config(ARCH, smoke=True, policy_name=policy, compute_dtype="float32")
    state = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg).load(state)


def _batches(cfg, seed=3):
    """The same concrete batch for both packages (labels dropped)."""
    got = registry.concrete_batch(cfg, base.SHAPES[0], batch=2, seq=S, seed=seed, device="cpu")
    want = jreg.concrete_batch(jreg.get_config(ARCH, smoke=True),
                               jreg.SHAPES_BY_NAME["train_4k"], batch=2, seq=S, seed=seed)
    del got["labels"], want["labels"]
    return got, want


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


@pytest.mark.parametrize("policy", ["fp64", "ozaki2_int8"])
def test_whisper_forward_matches_reference(policy):
    """Encoder over the stub's bfloat16 frame embeddings, decoder with
    cross-attention: logits within LOGIT_TOL, aux 0."""
    jmodel, jparams, model = _models(policy)
    batch, jbatch = _batches(model.cfg)
    assert set(batch) == {"tokens", "enc_embeds"}
    assert tuple(batch["enc_embeds"].shape) == (2, model.cfg.encoder_seq, model.cfg.d_model)
    got, aux = model.apply(batch)
    with jd.mode_scope("xla"):
        want, jaux = jmodel.apply(jparams, jbatch)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, S, model.cfg.vocab_size)
    assert float(aux) == float(jaux) == 0.0
    _close(got.numpy(), want)


def test_whisper_decode_matches_reference():
    """12 decode steps against repro's jitted decode_step (fp64): the cross
    cache is zeros of (B, encoder_seq, Hkv, D) in the compute dtype, in both."""
    jmodel, jparams, model = _models("fp64")
    tokens = np.random.default_rng(67).integers(0, model.cfg.vocab_size, (2, S))
    cache = model.init_cache(batch=2, seq_len=S)
    with jd.mode_scope("xla"):
        jstep = jax.jit(jmodel.decode_step)
        jcache = jmodel.init_cache(batch=2, seq_len=S)
        for t in range(S):
            lg, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
            jlg, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                                jnp.asarray(t, jnp.int32))
            _close(lg.numpy(), jlg)
    cfg = model.cfg
    shape = (2, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    jcross = jcache["stack"]["b0"]["cross_kv"]["k"]
    assert tuple(jcross.shape[1:]) == shape and jcross.dtype == jnp.float32
    for layer in cache:
        assert set(layer) == {"kv", "cross_kv"}
        for t in layer["cross_kv"].values():
            assert tuple(t.shape) == shape and t.dtype == torch.float32
            assert not bool(t.any())


@pytest.mark.parametrize("policy", ["fp64", "fp32"])
def test_cross_attn_apply_matches_reference(policy):
    """Cross attention alone, queries over 7 rows against 12 encoder rows, no
    RoPE and no mask, on the native softmax path (the emulated path, through
    ``dispatch.attention``, runs in the ozaki2_int8 forward above)."""
    jcfg = jreg.get_config(ARCH, smoke=True, compute_dtype="float32")
    cfg = registry.get_config(ARCH, smoke=True, compute_dtype="float32")
    jparams = jax.tree.map(np.asarray, jattention.attn_init(jax.random.PRNGKey(5), jcfg,
                                                            cross=True))
    params = {k: {"w": torch.from_numpy(np.array(v["w"]))} for k, v in jparams.items()}
    assert set(params) == {"wq", "wk", "wv", "wo"}
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    got = attention.cross_attn_apply(params, torch.from_numpy(x), torch.from_numpy(enc), cfg,
                                     Policy(policy))
    want = np.asarray(jattention.cross_attn_apply(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(x), jnp.asarray(enc), jcfg,
        JPolicy(policy)))
    assert tuple(got.shape) == (2, 7, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=16 * EPS * np.abs(want).max())
    # every query row attends to all 12 encoder rows: permuting them changes nothing
    perm = torch.from_numpy(enc[:, ::-1].copy())
    again = attention.cross_attn_apply(params, torch.from_numpy(x), perm, cfg, Policy(policy))
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0,
                               atol=16 * EPS * np.abs(want).max())


def _scale_cross(tree, key, factor):
    """A copy of a parameter tree with every leaf under ``key`` (the
    cross-attention's four weights) times ``factor``."""
    def walk(node, inside):
        if not isinstance(node, dict):
            return node * factor if inside else node
        return {k: walk(v, inside or k == key) for k, v in node.items()}
    return walk(tree, False)


def test_decode_cross_attention_adds_exactly_zero_in_both_packages(monkeypatch):
    """ROADMAP queue 3, item 16: decode never fills the cross cache, so every
    decode step's cross-attention adds exactly 0 to the residual stream, in
    repro as in the port (logits bitwise unchanged when the cross weights
    change), while the forward's logits change with ``enc_embeds``."""
    jmodel, jparams, model = _models("fp64")
    tokens = np.random.default_rng(71).integers(0, model.cfg.vocab_size, (2, 4))
    outs = []
    real = attention.cross_decode_step

    def spy(*args):
        outs.append(real(*args))
        return outs[-1]

    monkeypatch.setattr(attention, "cross_decode_step", spy)
    state = dict(model.state_dict())
    scaled = Model(model.cfg).load({k: v * 3 if ".cross." in k else v for k, v in state.items()})
    jscaled = _scale_cross(jparams, "cross", 3.0)
    jstep = jax.jit(jmodel.decode_step)
    caches = [m.init_cache(2, 4) for m in (model, scaled)]
    jcaches = [jmodel.init_cache(2, 4) for _ in range(2)]
    for t in range(4):
        tok = tokens[:, t:t + 1]
        lg = []
        for i, m in enumerate((model, scaled)):
            out, caches[i] = m.decode_step(caches[i], torch.from_numpy(tok), t)
            lg.append(out.numpy())
        jlg = []
        for i, p in enumerate((jparams, jscaled)):
            out, jcaches[i] = jstep(p, jcaches[i], jnp.asarray(tok, jnp.int32),
                                    jnp.asarray(t, jnp.int32))
            jlg.append(np.asarray(out))
        np.testing.assert_array_equal(lg[0], lg[1])
        np.testing.assert_array_equal(jlg[0], jlg[1])
    assert len(outs) == 2 * 4 * model.cfg.num_layers
    assert all(not bool(o.any()) for o in outs)
    # the forward reads the frames
    batch, jbatch = _batches(model.cfg)
    other = dict(batch, enc_embeds=batch["enc_embeds"].flip(1))
    jother = dict(jbatch, enc_embeds=jbatch["enc_embeds"][:, ::-1])
    assert not np.array_equal(model.apply(batch)[0].numpy(), model.apply(other)[0].numpy())
    with jd.mode_scope("xla"):
        assert not np.array_equal(np.asarray(jmodel.apply(jparams, jbatch)[0]),
                                  np.asarray(jmodel.apply(jparams, jother)[0]))


def test_the_cross_cache_goes_through_the_batcher():
    """The engine's cache holds each layer's cross cache beside its KV cache;
    serving 3 requests through 2 slots keeps it zeros of its shape while the
    KV cache fills (the batcher gives repro's tokens for the same requests)."""
    from repro.serve import engine as jengine

    jmodel, jparams, model = _models("fp64")
    prompts = [np.random.default_rng(73 + i).integers(0, model.cfg.vocab_size, 5)
               for i in range(3)]

    def run(batcher, request):
        for uid, p in enumerate(prompts):
            batcher.submit(request(uid=uid, prompt=p.astype(np.int32), max_new_tokens=4))
        return {r.uid: r.generated for r in batcher.run_to_completion()}

    engine = ServeEngine(model, batch_slots=2, max_seq=16)
    got = run(ContinuousBatcher(engine), Request)
    want = run(jengine.ContinuousBatcher(jengine.ServeEngine(
        jmodel, jparams, batch_slots=2, max_seq=16, dispatch_mode="xla")), jengine.Request)
    assert got == want and len(got) == 3 and all(len(g) == 4 for g in got.values())
    cfg = model.cfg
    for layer in engine.cache:
        assert tuple(layer["cross_kv"]["k"].shape) == (2, cfg.encoder_seq, cfg.num_kv_heads,
                                                        cfg.head_dim)
        assert not bool(layer["cross_kv"]["k"].any() or layer["cross_kv"]["v"].any())
        assert bool(layer["kv"]["k"].any())


def test_whisper_state_names_and_init():
    """``Model.init`` makes the names, shapes and dtypes ``params_from_jax``
    carries across: encoder layers ``encoder.{i}`` (no cross-attention),
    ``enc_norm``, ``enc_pos`` (encoder_seq, d), and each decoder layer's
    ``norm_cross`` and ``cross``."""
    cfg = registry.get_config(ARCH, smoke=True)
    tree = jax.tree.map(np.asarray, JModel(jreg.get_config(ARCH, smoke=True))
                        .init(jax.random.PRNGKey(13)))
    state = convert.params_from_jax(tree, device="cpu")
    made = Model(cfg).init(torch.Generator().manual_seed(0)).state_dict()
    assert {k: (tuple(v.shape), v.dtype) for k, v in made.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in state.items()}
    assert tuple(made["enc_pos"].shape) == (cfg.encoder_seq, cfg.d_model)
    for i in range(cfg.encoder_layers):
        assert not any(k.startswith((f"encoder.{i}.cross", f"encoder.{i}.norm_cross"))
                       for k in made)
    for i in range(cfg.num_layers):
        assert f"layers.{i}.cross.wq.w" in made and f"layers.{i}.norm_cross.scale" in made
    n = sum(v.numel() for v in made.values())
    norms = cfg.d_model * (3 * cfg.num_layers + 2 * cfg.encoder_layers + 2)
    assert n == cfg.param_count() + norms + cfg.encoder_seq * cfg.d_model


def test_serve_cli_serves_whisper_on_the_host(capsys):
    serve_cli.main(["--arch", "whisper-medium", "--smoke", "--device", "cpu", "--requests", "2",
                    "--max-new", "3", "--policy", "ozaki2_int8", "--compute-dtype", "float32"])
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "on cpu" in out
