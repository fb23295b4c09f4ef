"""repro_torch's training step held against repro's (CPU).

``make_train_step`` on yi-6b-smoke (float32 compute) against repro's jitted
step from the same parameters (``convert.params_from_jax``) and the same
``synth_batch``: plainly, with ``microbatch=2`` and with ``compress_grads``.
The policy is ``fp64``: repro's ``ozaki2_int8`` step takes 100-245 s to build
on this CPU (ROADMAP, Testing), so that step is checked by its parts.

Bounds, each relative to the largest magnitude in the tensor (ROADMAP queue 3,
items 3 and 18): torch and XLA differ in the last bits of float32 rsqrt, sin,
cos, silu and exp and sum in other orders, and XLA contracts multiply-adds
inside the jitted step.  So the loss is within LOSS_TOL, every gradient
within GRAD_TOL, the first moments within M_TOL and the second within V_TOL
(v is quadratic in the gradient).  The updated parameters move by
lr·m̂/(√v̂ + eps) ≈ lr·sign(g) on a first step, which a gradient near 0 can
turn: each is held within ``_param_bound``, which follows that update from
GRAD_TOL.  Under compression the int8 rounding of g / scale can go the other
way where it lies within GRAD_TOL·127 of a half-integer: the test allows
that flip there and nowhere else.

Port-only: the ``ozaki2_int8`` step's query, key and value gradients are
exactly zero (queue 3, item 17), in both packages through
``dispatch.attention``; remat changes no bit; a frozen model records no
graph; every arch's smoke config takes a finite step that moves it.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import dispatch as jdispatch  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import dispatch  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synth_batch  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import loop  # noqa: E402

U = 2.0 ** -23
LOSS_TOL = 8 * U          # measured at most 2.8 u over 3 seeds
GRAD_TOL = 16 * U         # measured at most 4.0 u
M_TOL = 16 * U            # measured at most 4.6 u
V_TOL = 32 * U            # measured at most 7.6 u
SEED = 4
MODES = {"plain": {}, "microbatch": {"microbatch": 2}, "compress": {"compress_grads": True}}
# ozaki2_int8 against fp64 in the port at 1 layer: wo, the MLP and the LM head
# see the same products to FP64 accuracy, and float32 activations from two
# attention paths (emulated and native softmax) that differ in the last bits
# (measured at most 2.0 u over 3 seeds).
POLICY_TOL = 16 * U


def _cfgs(policy="fp64", **over):
    kw = dict(smoke=True, policy_name=policy, compute_dtype="float32", **over)
    return jreg.get_config("yi-6b", **kw), registry.get_config("yi-6b", **kw)


def _tree(jtree):
    return convert.params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")


@pytest.fixture(scope="module")
def reference():
    """repro's jitted steps in the three modes and its jitted gradients (on the
    batch and on each strided microbatch), from one init and one batch."""
    jcfg, _ = _cfgs()
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(SEED))
    jbatch = jpipe.synth_batch(jpipe.DataConfig(global_batch=4, seq_len=16, seed=SEED), jcfg, 0)
    grad_fn = jax.jit(jax.value_and_grad(jloop.make_loss_fn(jmodel), has_aux=True))
    grads = _tree(grad_fn(jparams, jbatch)[1])
    halves = [grad_fn(jparams, {k: v[i::2] for k, v in jbatch.items()})[1] for i in range(2)]
    mean = jax.tree.map(lambda a, b: (jnp.zeros(a.shape, jnp.float32) + a + b) / 2, *halves)
    out = {"params": _tree(jparams), "grads": {"plain": grads, "compress": grads,
                                               "microbatch": _tree(mean)}}
    for mode, kw in MODES.items():
        res = jax.jit(jloop.make_train_step(jmodel, **kw))(jparams, jadamw.adamw_init(jparams),
                                                           jbatch)
        out[mode] = {"params": _tree(res[0]), "opt": convert.opt_state_from_jax(
            jax.tree.map(np.asarray, res[1]), device="cpu"),
            "metrics": {k: float(v) for k, v in res[2].items()},
            "ef": _tree(res[3]) if len(res) > 3 else None}
    return out


def _port_step(reference, mode):
    _, cfg = _cfgs()
    model = Model(cfg).load({k: v.clone() for k, v in reference["params"].items()})
    batch = synth_batch(DataConfig(global_batch=4, seq_len=16, seed=SEED), cfg, 0, device="cpu")
    opt = adamw.adamw_init(dict(model.named_parameters()))
    res = loop.make_train_step(model, **MODES[mode])(opt, batch)
    return model, res


def _within(got, want, tol):
    got, want = got.numpy().astype(np.float64), want.numpy().astype(np.float64)
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _param_bound(p0, m_ref, lr_t, cfg=adamw.AdamWConfig()):
    """How far a first step's parameter may move off the reference's: the
    update lr_t·r, r = m̂/(√v̂ + eps) = g/(|g| + eps) from a zero state, moves
    by at most min(2, 2δ/(|g| + eps)) when g moves by δ = GRAD_TOL·max|g|,
    plus an ulp of each rounding of p."""
    g = np.abs(m_ref.numpy().astype(np.float64)) / (1 - cfg.b1)
    delta = GRAD_TOL * g.max() + U * g
    p = np.abs(p0.numpy().astype(np.float64))
    return lr_t * np.minimum(2.0, 2 * delta / (g + cfg.eps)) + 2 * U * (p + lr_t)


@pytest.mark.parametrize("mode", list(MODES))
def test_fp64_step_matches_reference(reference, mode):
    model, res = _port_step(reference, mode)
    opt, metrics, grads = res[:3]
    want = reference[mode]
    assert set(metrics) == set(want["metrics"])
    ref_loss = want["metrics"]["loss"]
    assert abs(float(metrics["loss"]) - ref_loss) <= LOSS_TOL * ref_loss
    assert float(metrics["lr_scale"]) == want["metrics"]["lr_scale"]
    ref_grads = reference["grads"][mode]
    state = model.state_dict()
    assert set(grads) == set(ref_grads) == set(state) == set(opt["m"])
    assert int(opt["step"]) == int(want["opt"]["step"]) == 1
    lr_t = adamw.AdamWConfig().lr * float(metrics["lr_scale"])
    flipped = {}
    if mode == "compress":
        flipped = _check_error_feedback(model, grads, res[3], want["ef"], ref_grads)
    for k in state:
        keep = ~flipped.get(k, np.zeros(tuple(state[k].shape), bool))
        kt = torch.from_numpy(keep)
        assert _within(grads[k], ref_grads[k], GRAD_TOL), k
        assert _within(opt["m"][k][kt], want["opt"]["m"][k][kt], M_TOL), k
        assert _within(opt["v"][k][kt], want["opt"]["v"][k][kt], V_TOL), k
        bound = _param_bound(reference["params"][k], want["opt"]["m"][k], lr_t)
        diff = np.abs(state[k].numpy().astype(np.float64) - want["params"][k].numpy())
        assert np.all(diff[keep] <= bound[keep]), k
        assert np.all(diff <= 2 * lr_t + 4 * U * np.abs(want["params"][k].numpy())), k
    # the gradients' norm before clipping sums squares in other orders
    # (measured 0.8 u, 2.4 u after compression)
    ref_norm = want["metrics"]["grad_norm"]
    assert abs(float(metrics["grad_norm"]) - ref_norm) <= 8 * GRAD_TOL * ref_norm


def _check_error_feedback(model, grads, ef, ref_ef, ref_grads):
    """The error-feedback state against the reference's, one int8 scale per
    reference leaf: within 2·GRAD_TOL of max|g| except where the int8 rounding
    flipped, which must lie within 127·2·GRAD_TOL of a half-integer of
    g / scale and moves e by one quantum; returns {name: flipped mask}."""
    groups = model.stacked_groups()
    assert sorted(len(g) for g in groups) == [2] * len(groups) and groups
    grouped = {k for g in groups for k in g}
    leaves = groups + [[k] for k in grads if k not in grouped]
    flipped = {}
    for leaf in leaves:
        gmax = max(float(ref_grads[k].abs().max()) for k in leaf)
        quantum = gmax / 127
        for k in leaf:
            d = np.abs(ef[k].numpy().astype(np.float64) - ref_ef[k].numpy())
            t = ref_grads[k].numpy().astype(np.float64) / quantum
            near = np.abs(np.abs(t - np.floor(t)) - 0.5) <= 127 * 2 * GRAD_TOL
            flip = d > 2 * GRAD_TOL * gmax
            assert np.all(near[flip]), k
            assert np.all(np.abs(d[flip] - quantum) <= 4 * GRAD_TOL * gmax), k
            flipped[k] = flip
    assert sum(int(f.sum()) for f in flipped.values()) <= 4
    return flipped


def test_step_reads_state_dict_names_and_eval_step(reference):
    _, cfg = _cfgs()
    model = Model(cfg).load(reference["params"])
    assert not any(p.requires_grad for p in model.parameters())
    batch = synth_batch(DataConfig(global_batch=4, seq_len=16, seed=SEED), cfg, 0, device="cpu")
    logits, _ = model.apply(batch)
    assert logits.grad_fn is None                     # frozen: no graph recorded
    ev = loop.make_eval_step(model)(batch)
    assert set(ev) == {"loss", "ce", "aux"} and ev["loss"].grad_fn is None
    loop.make_train_step(model)
    assert all(p.requires_grad for p in model.parameters())
    logits, _ = model.apply(batch)
    assert logits.grad_fn is not None


def test_cross_entropy_gold_logit_is_exact():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 11)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 11, (2, 5)).astype(np.int32))
    got = loop.cross_entropy_loss(logits, labels, z_loss=0.0)
    logz = torch.logsumexp(logits[:, :-1], -1)
    gold = torch.gather(logits[:, :-1], -1, labels[:, 1:, None].long())[..., 0]
    assert float(got) == float(torch.mean(logz - gold))
    want = jloop.cross_entropy_loss(jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy()))
    assert abs(float(loop.cross_entropy_loss(logits, labels)) - float(want)) <= 4 * U * float(want)


# --- the ozaki2_int8 step, by its parts ------------------------------------------------

def test_attention_gradient_is_exactly_zero_in_both_packages():
    """The one repro attention gradient in the suite: jax.grad through
    repro's emulated attention (the xla route) is exactly zero, and so is the
    port's on the CPU's reference route."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s) for s in ((1, 4, 8), (1, 6, 8), (1, 6, 8)))
    w = rng.standard_normal((1, 4, 8))

    def jloss(q, k, v):
        return jnp.sum(jdispatch.attention(q, k, v, mode="xla") * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = dispatch.attention(tq, tk, tv)
    want = np.asarray(jdispatch.attention(q, k, v, mode="xla"))
    assert np.abs(out.detach().numpy() - want).max() <= 1e-12 * np.abs(v).max()   # item 3
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in zip((tq, tk, tv), jgrads):
        assert not np.asarray(want).any() and not got.grad.numpy().any()
        assert got.grad.shape == got.shape and got.grad.dtype == got.dtype


def _ozaki_step(num_layers, policy="ozaki2_int8", remat=True):
    _, cfg = _cfgs(policy, num_layers=num_layers, remat=remat)
    model = Model(cfg).init(torch.Generator().manual_seed(11))
    batch = synth_batch(DataConfig(global_batch=2, seq_len=16, seed=SEED), cfg, 0, device="cpu")
    opt = adamw.adamw_init(dict(model.named_parameters()))
    return loop.make_train_step(model)(opt, batch)


def test_ozaki2_int8_step_trains_no_query_key_or_value():
    """Item 17 in a model: every wq, wk and wv gradient is exactly zero, and
    so is norm1's, whose only path to the loss is through them.  Every other
    gradient is finite and non-zero, and remat off gives the same bits."""
    opt, metrics, grads = _ozaki_step(2)
    zero = ("mixer.wq.w", "mixer.wk.w", "mixer.wv.w", "norm1.scale")
    assert {k for k in grads if k.endswith(zero)} == {
        f"layers.{i}.{n}" for i in range(2) for n in zero}
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
        assert bool((g == 0).all()) == k.endswith(zero), k
    assert np.isfinite(float(metrics["loss"]))
    _, metrics2, grads2 = _ozaki_step(2, remat=False)
    assert float(metrics2["loss"]) == float(metrics["loss"])
    for k in grads:
        assert torch.equal(grads2[k], grads[k]), k


def test_ozaki2_int8_gradients_agree_with_fp64_at_one_layer():
    _, _, g8 = _ozaki_step(1)
    _, _, g64 = _ozaki_step(1, policy="fp64")
    for k in ("layers.0.mixer.wo.w", "layers.0.mlp.wi_gate.w", "layers.0.mlp.wi_up.w",
              "layers.0.mlp.wo.w", "lm_head.w"):
        assert _within(g8[k], g64[k], POLICY_TOL), k
    assert g64["layers.0.mixer.wq.w"].abs().max() > 0


# --- port-only ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fp64", "bf16"])
def test_remat_changes_no_bit(policy, monkeypatch):
    """remat recomputes each layer in the backward (under the forward's
    modes) and changes no bit of the step."""
    from repro_torch.models import transformer

    recomputed = []
    real = transformer.recompute_scope

    @contextlib.contextmanager
    def counted(modes):
        recomputed.append(modes)          # entered when the backward recomputes
        with real(modes):
            yield

    monkeypatch.setattr(transformer, "recompute_scope", counted)
    steps = []
    for remat in (True, False):
        recomputed.clear()
        steps.append(_ozaki_step(2, policy=policy, remat=remat))
        assert recomputed == ([("auto", "off")] * 2 if remat else [])
    for k in steps[0][2]:
        assert torch.equal(steps[0][2][k], steps[1][2][k]), k
    assert float(steps[0][1]["loss"]) == float(steps[1][1]["loss"])


@pytest.mark.parametrize("arch", registry.list_archs())
def test_train_step_no_nans(arch):
    """The counterpart of the reference's smoke test: one step at the smoke
    config's own policy and dtypes, finite, and the parameters moved."""
    cfg = registry.get_config(arch, smoke=True)
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = synth_batch(DataConfig(global_batch=2, seq_len=16), cfg, 0, device="cpu")
    opt, metrics, grads = loop.make_train_step(model)(adamw.adamw_init(before), batch)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items())
