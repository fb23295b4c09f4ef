"""repro_torch's MoE layer and MoE decoders held against repro's (CPU).

Inputs come from numpy seeds; repro's parameters are carried across with
``convert.params_from_jax``.  The routing itself is exact: softmax, a stable
top-k, the capacity cumsum and the one-hot dispatch.  Its float32 inputs are
not bitwise across packages (XLA and torch sum the router product in other
orders, and their exp differs in the last bits: ROADMAP queue 3, items 3 and
13), so routes agree wherever the top-k margin exceeds those few ulps; the
tests check that their tokens' margins do (MARGIN_ULPS), so that a routing
flip would show as itself.  The routed experts are float32 einsums in both
packages, in other summation orders: held within k·d float32 epsilons of the
scale Σ|x||w|, never bitwise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import dispatch as jd  # noqa: E402
from repro.core.policy import Policy as JPolicy  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.policy import Policy  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

EPS = 2.0 ** -23
LOGIT_TOL = 64 * EPS           # as tests/test_torch_models.py
MARGIN_ULPS = 64               # least top-k margin, in float32 ulps of the k-th probability
ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e"]


def _models(arch, policy, seed=3, **over):
    jcfg = jreg.get_config(arch, smoke=True, policy_name=policy, compute_dtype="float32",
                           **over)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    cfg = registry.get_config(arch, smoke=True, policy_name=policy, compute_dtype="float32",
                              **over)
    state = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg).load(state)


def _margins(probs, k):
    """float32 ulps between each row's k-th and (k+1)-th probability."""
    p = -np.sort(-np.asarray(probs, np.float32), axis=-1)
    return (p[:, k - 1] - p[:, k]) / np.spacing(p[:, k - 1])


@pytest.fixture
def routes(monkeypatch):
    """Record the routing of every MoE call: the port's (indices, probabilities)
    and the reference's indices (through a host callback, inside its scan)."""
    got, want = [], []
    real, jreal = moe._topk_gating, jmoe._topk_gating

    def port(logits, m):
        out = real(logits, m)
        got.append((out[1].numpy().copy(), torch.softmax(logits.float(), -1).numpy()))
        return out

    def ref(logits, m):
        out = jreal(logits, m)
        jax.debug.callback(lambda i: want.append(np.asarray(i)), out[1], ordered=True)
        return out

    monkeypatch.setattr(moe, "_topk_gating", port)
    monkeypatch.setattr(jmoe, "_topk_gating", ref)
    return got, want


def _check_routes(got, want, k):
    assert len(got) == len(want) > 0
    for (idx, probs), jidx in zip(got, want):
        np.testing.assert_array_equal(idx, jidx)
        assert _margins(probs, k).min() > MARGIN_ULPS


@pytest.mark.parametrize("arch", ARCHS)
def test_gating_matches_reference(arch):
    """Fed the reference's own router logits: the same experts, weights within
    4 float32 ulps, aux (all its terms positive) within 8 ulps of itself."""
    m = registry.get_config(arch, smoke=True).moe
    rng = np.random.default_rng(41)
    logits = (rng.standard_normal((40, m.num_experts)) * 0.6).astype(np.float32)
    order = np.argsort(-logits[3], kind="stable")
    logits[3, order[m.top_k]] = logits[3, order[m.top_k - 1]]   # a tie at the k-th place
    w, idx, aux = moe._topk_gating(torch.from_numpy(logits), m)
    jw, jidx, jaux = jmoe._topk_gating(jnp.asarray(logits), jreg.get_config(arch, smoke=True).moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    jw = np.asarray(jw)
    assert np.all(np.abs(w.numpy() - jw) <= 4 * np.spacing(jw))
    assert abs(float(aux) - float(jaux)) <= 8 * EPS * float(jaux)
    probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
    assert _margins(probs, m.top_k)[3] == 0              # the lower index wins in both


@pytest.mark.parametrize("policy", ["fp64", "ozaki2_int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, policy, routes):
    """One MoE layer on carried-over parameters, float32 compute: the same routes,
    out within k·d·2⁻²³ of Σ|x||w| through the chosen and shared experts."""
    jcfg = jreg.get_config(arch, smoke=True, policy_name=policy, compute_dtype="float32")
    cfg = registry.get_config(arch, smoke=True, policy_name=policy, compute_dtype="float32")
    jparams = jmoe.moe_init(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    params = convert.from_numpy(tree, "cpu")
    m = cfg.moe
    x = np.random.default_rng(43).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    got, aux = moe.moe_apply(params, torch.from_numpy(x), cfg, Policy(policy))
    with jd.mode_scope("xla"):
        want, jaux = jmoe.moe_apply(jparams, jnp.asarray(x), jcfg, JPolicy(policy))
    want = np.asarray(want)
    jax.effects_barrier()
    _check_routes(*routes, m.top_k)
    idx = routes[0][0][0]
    xt = x.reshape(-1, cfg.d_model)
    # the scale: |x| through |w| of each token's experts, and the shared MLP
    e = tree["experts"]
    xa = np.abs(xt).astype(np.float64)
    scale = np.zeros_like(xa)
    for t in range(xt.shape[0]):
        for j in idx[t]:
            h = (xa[t] @ np.abs(e["wi_gate"][j])) * (xa[t] @ np.abs(e["wi_up"][j]))
            scale[t] += h @ np.abs(e["wo"][j])
    if m.num_shared:
        s = tree["shared"]
        h = (xa @ np.abs(s["wi_gate"]["w"])) * (xa @ np.abs(s["wi_up"]["w"]))
        scale += h @ np.abs(s["wo"]["w"])
    err = np.abs(got.numpy().reshape(xt.shape) - want.reshape(xt.shape))
    assert np.all(err <= m.top_k * cfg.d_model * EPS * scale)
    assert abs(float(aux) - float(jaux)) <= 8 * EPS * float(jaux)


@pytest.mark.parametrize("policy", ["fp64", "ozaki2_int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_matches_reference(arch, policy, routes):
    """Forward logits and aux, and decode against the reference's decode, at
    the smoke config (capacity factor 1.25: the forward drops tokens)."""
    jmodel, jparams, model = _models(arch, policy)
    S = 10
    tokens = np.random.default_rng(47).integers(0, model.cfg.vocab_size, (2, S))
    got, aux = model.apply({"tokens": torch.from_numpy(tokens)})
    with jd.mode_scope("xla"):
        want, jaux = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
        jax.effects_barrier()
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, S, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())
    assert abs(float(aux) - float(jaux)) <= 8 * EPS * float(jaux) and float(aux) > 0
    _check_routes(*routes, model.cfg.moe.top_k)
    # decode, step by step against the reference's decode
    routes[0].clear()
    routes[1].clear()
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
        jax.effects_barrier()
    _check_routes(*routes, model.cfg.moe.top_k)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_matches_forward_without_drops(arch):
    """At the reference's no-drop capacity factor (16) decode reproduces the
    teacher-forced forward: within the reference's 2e-2, and within 4 float32
    epsilons of the scale.  Bitwise at top-1 (llama4), where each token's
    combine has one term; at top-3 (deepseek) not, since the float32 combine
    sums over an (E, C) slot axis whose length C differs between the two."""
    base = registry.get_config(arch, smoke=True)
    _, _, model = _models(arch, "ozaki2_int8",
                          moe=dataclasses.replace(base.moe, capacity_factor=16.0))
    S = 12
    tokens = np.random.default_rng(53).integers(0, model.cfg.vocab_size, (2, S))
    full, _ = model.apply({"tokens": torch.from_numpy(tokens)})
    cache = model.init_cache(batch=2, seq_len=S)
    steps = []
    for t in range(S):
        lg, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]), t)
        steps.append(lg[:, 0])
    dec, full = torch.stack(steps, dim=1).numpy(), full.numpy()
    np.testing.assert_allclose(dec, full, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(dec, full, rtol=0, atol=4 * EPS * np.abs(full).max())
    if base.moe.top_k == 1:
        np.testing.assert_array_equal(dec, full)


def test_capacity_drops_tokens_as_the_reference():
    """Eight tokens all routed to expert 0 at capacity max(ceil(8·1/4·1.25), 1)
    = 3: the first three in token order keep their slot, the rest get only the
    shared expert, in both packages."""
    arch = "llama4-scout-17b-a16e"
    jcfg = jreg.get_config(arch, smoke=True, policy_name="fp64", compute_dtype="float32")
    cfg = registry.get_config(arch, smoke=True, policy_name="fp64", compute_dtype="float32")
    jparams = jmoe.moe_init(jax.random.PRNGKey(9), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    tree["router"]["w"] = np.zeros_like(tree["router"]["w"])
    tree["router"]["w"][:, 0] = 1.0
    x = np.abs(np.random.default_rng(59).standard_normal((1, 8, cfg.d_model))).astype(np.float32)
    params = convert.from_numpy(tree, "cpu")
    got, _ = moe.moe_apply(params, torch.from_numpy(x), cfg, Policy("fp64"))
    want, _ = jmoe.moe_apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jcfg,
                             JPolicy("fp64"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=cfg.d_model * EPS * np.abs(np.asarray(want)).max())
    no_shared = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_shared=0))
    routed, _ = moe.moe_apply({k: v for k, v in params.items() if k != "shared"},
                              torch.from_numpy(x), no_shared, Policy("fp64"))
    routed = routed.numpy()[0]
    assert np.all(routed[:3] != 0) and np.all(routed[3:] == 0)


def test_moe_config_and_counts():
    cfg = registry.get_config("deepseek-moe-16b")
    jcfg = jreg.get_config("deepseek-moe-16b")
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    assert (cfg.param_count(), cfg.active_param_count()) == \
        (jcfg.param_count(), jcfg.active_param_count()) and cfg.param_count() == 16_879_452_160
    for arch in registry.list_archs():
        assert registry.get_config(arch).active_param_count() == \
            jreg.get_config(arch).active_param_count()
    small = registry.get_config("deepseek-moe-16b", smoke=True, compute_dtype="float32")
    model = Model(small).init(torch.Generator().manual_seed(0))
    n = sum(p.numel() for p in model.parameters())
    assert n == small.param_count() + small.d_model * (2 * small.num_layers + 1)   # + norms
    router = model.layers[0].tree()["mlp"]["router"]["w"]
    assert router.dtype == torch.float32 and tuple(router.shape) == (64, 8)
