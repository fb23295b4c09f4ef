"""repro_torch's policies, yi-6b model and serving engine held against repro's (CPU).

Inputs come from numpy seeds and repro's parameters are carried across with
``convert.params_from_jax``, so both packages compute the same model.  The
emulated weight products are bitwise (``Policy.dot`` under ozaki2_int8); the
models' own float32 arithmetic is not: torch and XLA differ in the last bits of
float32 rsqrt, sin/cos, silu and exp, so logits are held within LOGIT_TOL of
their scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.base import BlockCfg as JBlockCfg  # noqa: E402
from repro.core import dispatch as jd  # noqa: E402
from repro.core.policy import Policy as JPolicy  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import BlockCfg  # noqa: E402
from repro_torch.core.policy import POLICIES, Policy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve.engine import ContinuousBatcher, Request, ServeEngine  # noqa: E402

RNG = np.random.default_rng(31)
# float32 ulps of rsqrt, sin/cos, silu and exp over two layers and the LM head,
# relative to max |logit|: 64 float32 epsilons.
LOGIT_TOL = 64 * 2.0 ** -23


def _models(policy, **over):
    jcfg = jreg.get_config("yi-6b", smoke=True, policy_name=policy, compute_dtype="float32",
                           **over)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    cfg = registry.get_config("yi-6b", smoke=True, policy_name=policy, compute_dtype="float32",
                              **over)
    state = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg).load(state)


@pytest.mark.parametrize("name", ["bf16", "fp32", "fp64", "ozaki2_int8"])
def test_policy_dot_matches_reference(name):
    x = RNG.standard_normal((2, 3, 48))
    w = RNG.standard_normal((48, 20))
    for dt, jdt in ((np.float32, jnp.float32), (np.float64, jnp.float64)):
        got = Policy(name).dot(torch.from_numpy(x.astype(dt)), torch.from_numpy(w.astype(dt)))
        with jd.mode_scope("xla"):
            want = np.asarray(JPolicy(name).dot(jnp.asarray(x, jdt), jnp.asarray(w, jdt)))
        assert got.dtype == torch.from_numpy(np.zeros(1, dt)).dtype
        if name == "ozaki2_int8":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            # the native products differ only in summation order: 48 terms of
            # the operand type's (bf16: float32 accumulation) rounding
            eps = 2.0 ** -23 if name in ("bf16", "fp32") or dt == np.float32 else 2.0 ** -52
            scale = np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64)
            assert np.all(np.abs(got.numpy() - want) <= 48 * eps * scale)
    assert Policy("ozaki2_int8").is_emulated and not Policy("fp64").is_emulated
    assert [Policy(n).matmul_flops_multiplier() for n in POLICIES] == \
        [JPolicy(n).matmul_flops_multiplier() for n in POLICIES]


@pytest.mark.parametrize("name", ["ozaki2_fp8", "ozaki1_int8"])
def test_unported_policies_raise(name):
    """Both policies are ported, the forward and (slice 10) the gradient: in
    float32, ozaki2_fp8's gradient is bitwise ozaki2_int8's, ozaki1_int8's within
    16 u of the float64 gradient before its rounding to float32."""
    out = Policy(name).dot(torch.ones((2, 4)), torch.ones((4, 3)))
    assert out.dtype == torch.float32 and bool((out == 4.0).all())
    w = torch.from_numpy(RNG.standard_normal((4, 3)).astype(np.float32))

    def grad_x(policy):
        x = torch.ones((2, 4), requires_grad=True)
        Policy(policy).dot(x, w).sum().backward()
        return x.grad

    got = grad_x(name)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4)
    if name == "ozaki2_fp8":
        assert torch.equal(got, grad_x("ozaki2_int8"))
    else:
        exact = w.double().sum(dim=1).expand(2, 4)        # g = 1: dA = 1·Wᵀ
        bound = 16 * 2.0 ** -53 * w.double().abs().sum(dim=1) + 2.0 ** -24 * exact.abs()
        assert bool(((got.double() - exact).abs() <= bound).all())
    with pytest.raises(ValueError):
        Policy("fp16")


@pytest.mark.parametrize("policy,over", [
    ("fp64", {}), ("ozaki2_int8", {}),
    ("fp32", {"attn_chunk": 4}),            # native attention over q-blocks of 4 rows
])
def test_model_apply_and_decode_match_reference(policy, over):
    jmodel, jparams, model = _models(policy, **over)
    S = 12
    tokens = RNG.integers(0, model.cfg.vocab_size, (2, S))
    got, aux = model.apply({"tokens": torch.from_numpy(tokens)})
    with jd.mode_scope("xla"):
        want = np.asarray(jmodel.apply(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})[0])
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, S, model.cfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
    # decode reproduces the teacher-forced forward (test_models_smoke's bound) ...
    cache = model.init_cache(batch=2, seq_len=S)
    steps = []
    for t in range(S):
        lg, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        steps.append(lg[:, 0])
    dec = torch.stack(steps, dim=1)
    np.testing.assert_allclose(dec.numpy(), got.numpy(), rtol=2e-2, atol=2e-2)
    if policy == "ozaki2_int8":
        # ... bitwise on the emulated path: every product is exact per row, and a
        # decode step's attention has the forward pass's key blocks
        np.testing.assert_array_equal(dec.numpy(), got.numpy())


def test_serve_engine_gives_the_reference_tokens():
    jmodel, jparams, model = _models("ozaki2_int8")
    prompts = [RNG.integers(0, model.cfg.vocab_size, 4) for _ in range(3)]

    def run(batcher, request):
        for uid, p in enumerate(prompts):
            batcher.submit(request(uid=uid, prompt=p.astype(np.int32), max_new_tokens=4))
        return {r.uid: r.generated for r in batcher.run_to_completion()}

    got = run(ContinuousBatcher(ServeEngine(model, batch_slots=2, max_seq=16)), Request)
    want = run(jengine.ContinuousBatcher(jengine.ServeEngine(
        jmodel, jparams, batch_slots=2, max_seq=16, dispatch_mode="xla")), jengine.Request)
    assert got == want and len(got) == 3 and all(len(g) == 4 for g in got.values())


def test_params_from_jax_round_trips_every_leaf():
    """Five layers of a two-block pattern: two stacked periods and one tail block."""
    jcfg = jreg.get_config("yi-6b", smoke=True, num_layers=5,
                           pattern=(JBlockCfg(), JBlockCfg(window=4)))
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(5)))
    assert set(tree) >= {"stack", "tail0"}
    state = convert.params_from_jax(tree, device="cpu")
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(state) == sum(leaf.shape[0] if path[0].key == "stack" else 1
                             for path, leaf in leaves)
    for path, leaf in leaves:
        keys = [p.key for p in path]
        if keys[0] == "stack":
            for i in range(leaf.shape[0]):
                name = ".".join(["layers", str(2 * i + int(keys[1][1:]))] + keys[2:])
                np.testing.assert_array_equal(state[name].numpy(), leaf[i])
        elif keys[0] == "tail0":
            np.testing.assert_array_equal(state[".".join(["layers", "4"] + keys[1:])].numpy(),
                                          leaf)
        else:
            np.testing.assert_array_equal(state[".".join(keys)].numpy(), leaf)
    cfg = registry.get_config("yi-6b", smoke=True, num_layers=5,
                              pattern=(BlockCfg(), BlockCfg(window=4)))
    assert set(Model(cfg).load(state).state_dict()) == set(state)


def test_registry_init_and_unported_layers():
    cfg = registry.get_config("yi-6b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size) == (32, 4096, 32, 4, 128, 11008, 64000)
    assert cfg.param_count() == jreg.get_config("yi-6b").param_count()
    assert registry.list_archs() == jreg.list_archs() == [
        "whisper-medium", "qwen2-vl-72b", "minitron-4b", "yi-6b", "gemma-7b", "gemma3-4b",
        "jamba-1.5-large-398b", "deepseek-moe-16b", "llama4-scout-17b-a16e", "xlstm-350m"]
    with pytest.raises(ValueError):
        registry.get_config("no-such-arch")
    small = registry.get_config("yi-6b", smoke=True, compute_dtype="float32")
    model = Model(small).init(torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in model.parameters())
    assert n == small.param_count() + small.d_model * (2 * small.num_layers + 1)   # + norms
    with pytest.raises(ValueError, match="unknown family"):
        Model(registry.get_config("yi-6b", smoke=True, family="no-such-family"))


@pytest.mark.parametrize("field", ["remat", "force_unroll"])
def test_get_config_reads_the_training_fields(field):
    """remat (a checkpoint per layer under autograd) and force_unroll (the
    reference's Python loop over layers, which the port always runs), with the
    reference's value in every config, published and smoke."""
    for arch in registry.list_archs():
        for smoke in (False, True):
            assert getattr(registry.get_config(arch, smoke=smoke), field) == \
                getattr(jreg.get_config(arch, smoke=smoke), field)
    default = getattr(registry.get_config("yi-6b"), field)
    assert getattr(registry.get_config("yi-6b", **{field: not default}), field) is not default


@pytest.mark.parametrize("field", ["mrope_sections", "encoder_seq", "frontend"])
def test_get_config_reads_the_encdec_and_mrope_fields(field):
    """M-RoPE's sections, the encoder's frames and the stub frontend, with the
    reference's value in every config, published and smoke."""
    for arch in registry.list_archs():
        for smoke in (False, True):
            assert getattr(registry.get_config(arch, smoke=smoke), field) == \
                getattr(jreg.get_config(arch, smoke=smoke), field)
    assert getattr(registry.get_config("yi-6b", **{field: 5}), field) == 5


@pytest.mark.parametrize("field", ["ssm_chunk", "lstm_chunk", "ssm_conv_width"])
def test_get_config_reads_the_recurrent_mixers_fields(field):
    """The recurrent mixers' chunks and conv width, with the reference's value
    in every config, published and smoke."""
    for arch in registry.list_archs():
        for smoke in (False, True):
            assert getattr(registry.get_config(arch, smoke=smoke), field) == \
                getattr(jreg.get_config(arch, smoke=smoke), field)
    assert getattr(registry.get_config("yi-6b", **{field: 5}), field) == 5


def test_serve_cli_on_the_host(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--requests", "2", "--max-new", "3",
                    "--policy", "ozaki2_int8", "--compute-dtype", "float32"])
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and "on cpu" in out
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--smoke"])
