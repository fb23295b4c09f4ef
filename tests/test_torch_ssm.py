"""repro_torch's recurrent mixers (Mamba, mLSTM, sLSTM) held against repro's (CPU).

Inputs come from numpy seeds; repro's parameters are carried across with
``convert.from_numpy``.  Bitwise: the associative scan's association, the causal
conv, the weight products under ozaki2_int8, the states' shapes and dtypes.
Not bitwise: the recurrences' float32 exp, tanh, sigmoid and einsums (torch and
XLA differ in their last bits, and XLA contracts multiply-adds inside its
scans: ROADMAP queue 3, items 3 and 8), so each mixer's output is held within
a stated multiple of 2⁻²³·max|y| (queue 3, item 14).
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
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.policy import Policy  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402

EPS = 2.0 ** -23
U = 2.0 ** -53
# A mixer's output against the reference's, in units of 2⁻²³·max|y| (queue 3,
# item 14): measured at most 3.0 under fp64 and 13.6 under fp32 over 8 seeds
# and inputs up to 8 in scale (the fp32 products' own roundings reach the
# exponential gates).
MIXER_TOL = {"fp64": 8, "fp32": 32}
# Mamba's decode against its chunked forward, in the same units: the scan's
# association differs (measured at most 0.6 under fp64).
MAMBA_DECODE_TOL = 4
MIXERS = {"mamba": "jamba-1.5-large-398b", "mlstm": "xlstm-350m", "slstm": "xlstm-350m"}
# The epsilon of what feeds each decode state at bfloat16 compute.  Mamba's h
# sums dt·x·B, whose x (silu of the conv) and B (x_proj's output) are bfloat16
# values: a last-bit difference there moves h by 2⁻⁸ of its scale (measured at
# most 4.7·2⁻⁸·max|h| over 8 seeds).  Its conv state holds bfloat16 inputs
# bitwise.  The LSTM states are float32 arithmetic on float32 gates (measured at
# most 2.1·2⁻²³ of their scale over 8 seeds).
STATE_EPS = {("mamba", "h"): 2.0 ** -8, ("mamba", "conv"): 0.0,
             **{(m, k): EPS for m, ks in (("mlstm", "Cnm"), ("slstm", "cnmh")) for k in ks}}


def _mixer(mixer, policy, seed=5, **over):
    """(port's params, reference's params, port's cfg, reference's cfg)."""
    arch = MIXERS[mixer]
    jcfg = jreg.get_config(arch, smoke=True, policy_name=policy, compute_dtype="float32", **over)
    cfg = registry.get_config(arch, smoke=True, policy_name=policy, compute_dtype="float32",
                              **over)
    jparams = getattr(jssm, f"{mixer}_init")(jax.random.PRNGKey(seed), jcfg)
    return convert.from_numpy(jax.tree.map(np.array, jparams), "cpu"), jparams, cfg, jcfg


def _decode(mixer, params, x, cfg, policy):
    """Token-by-token decode of x (B, S, d) from a fresh state: (outputs, state)."""
    state = getattr(ssm, f"{mixer}_state_init")(cfg, x.shape[0], device="cpu")
    outs = []
    for t in range(x.shape[1]):
        o, state = getattr(ssm, f"{mixer}_decode_step")(params, x[:, t:t + 1], state, cfg,
                                                        Policy(policy))
        outs.append(o)
    return torch.cat(outs, dim=1), state


def _mamba_combine(a, b):
    return a[0] * b[0], b[0] * a[1] + b[1]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 12, 13, 16])
def test_associative_scan_is_lax_associative_scan(n):
    """Mamba's combine over a time axis of n: bitwise equal to eager
    ``jax.lax.associative_scan`` (its pairing at odd lengths included), where a
    sequential scan associates otherwise."""
    rng = np.random.default_rng(100 + n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
    got = ssm._associative_scan(_mamba_combine, (torch.from_numpy(a), torch.from_numpy(b)), 1)
    want = jax.lax.associative_scan(_mamba_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == a.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if n >= 5:
        seq = [(a[:, 0], b[:, 0])]
        for t in range(1, n):
            seq.append(_mamba_combine(seq[-1], (a[:, t], b[:, t])))
        assert not np.array_equal(got[1].numpy(), np.stack([s[1] for s in seq], axis=1))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_is_the_references(with_state):
    """The K taps summed left to right, with a zero or a carried state: bitwise,
    and the next state is the last K - 1 inputs."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32) if with_state else None
    y, nxt = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                              None if st is None else torch.from_numpy(st))
    jy, jnxt = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 None if st is None else jnp.asarray(st))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    np.testing.assert_array_equal(nxt.numpy(), x[:, -3:])


@pytest.mark.parametrize("mixer,weight", [
    ("mamba", "in_proj"), ("mamba", "x_proj"), ("mamba", "out_proj"),
    ("mlstm", "up_proj"), ("mlstm", "wq"), ("mlstm", "w_if"), ("mlstm", "down_proj"),
    ("slstm", "w_in"),
])
def test_projections_are_bitwise_under_ozaki2(mixer, weight):
    """Each mixer's weight product under ozaki2_int8 at its smoke shape, bitwise
    equal to the reference's.  Mamba's x_proj is 2·4 + 1 = 9 columns wide, where
    the reference's emulated product is wrong (ROADMAP queue 3, item 9): there
    the port is held to the exact product, within 16 u of |x||w| and then the
    rounding to float32.  mLSTM's w_if (4 columns) is a GEMV."""
    params, jparams, cfg, _ = _mixer(mixer, "ozaki2_int8")
    w = jparams[weight]["w"]
    x = np.random.default_rng(11).standard_normal((2, 3, w.shape[0])).astype(np.float32)
    got = layers.dense_apply(params[weight], torch.from_numpy(x), Policy("ozaki2_int8"))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, w.shape[1])
    if w.shape[1] in (9, 13):
        x64, w64 = x.astype(np.float64), np.asarray(w, np.float64)
        exact = x64 @ w64
        bound = 16 * U * (np.abs(x64) @ np.abs(w64)) + EPS / 2 * np.abs(exact)
        assert np.all(np.abs(got.numpy() - exact) <= bound)
        return
    with jd.mode_scope("xla"):
        want = jlayers.dense_apply(jparams[weight], jnp.asarray(x), JPolicy("ozaki2_int8"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("policy", ["fp64", "fp32"])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_apply_matches_reference(mixer, policy, chunked):
    """The chunked forward over S = 12, in one chunk or in chunks of 4 (the
    association of the state update changes at each chunk bound), within
    MIXER_TOL of the reference's scale."""
    over = {"ssm_chunk": 4, "lstm_chunk": 4} if chunked else {}
    params, jparams, cfg, jcfg = _mixer(mixer, policy, **over)
    x = (np.random.default_rng(13).standard_normal((2, 12, cfg.d_model)) * 3).astype(np.float32)
    got = getattr(ssm, f"{mixer}_apply")(params, torch.from_numpy(x), cfg, Policy(policy))
    with jd.mode_scope("xla"):
        want = np.asarray(getattr(jssm, f"{mixer}_apply")(jparams, jnp.asarray(x), jcfg,
                                                          JPolicy(policy)))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=MIXER_TOL[policy] * EPS * np.abs(want).max())


@pytest.mark.parametrize("policy", ["fp64", "ozaki2_int8"])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_decode_matches_forward(mixer, chunked, policy):
    """Decode from a fresh state against the port's own forward.  The LSTMs are
    bitwise: a decode step does the forward's step on the same shapes, and
    under both policies a product row does not depend on the other rows.
    Mamba's chunk scan associates otherwise: within MAMBA_DECODE_TOL."""
    over = {"ssm_chunk": 4, "lstm_chunk": 4} if chunked else {}
    params, _, cfg, _ = _mixer(mixer, policy, **over)
    x = torch.from_numpy(
        np.random.default_rng(17).standard_normal((2, 12, cfg.d_model)).astype(np.float32))
    full = getattr(ssm, f"{mixer}_apply")(params, x, cfg, Policy(policy)).numpy()
    dec = _decode(mixer, params, x, cfg, policy)[0].numpy()
    if mixer == "mamba":
        np.testing.assert_allclose(dec, full, rtol=0,
                                   atol=MAMBA_DECODE_TOL * EPS * np.abs(full).max())
        assert not np.array_equal(dec, full)
    else:
        np.testing.assert_array_equal(dec, full)


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_decode_step_matches_reference_and_keeps_its_state(mixer):
    """Six decode steps against the reference's, under fp64 at bfloat16
    compute: outputs within MIXER_TOL of their scale in bfloat16's epsilon,
    each float32 state within MIXER_TOL of its scale in the epsilon of what
    feeds it (STATE_EPS); every state keeps the shapes and the float32 dtype of
    ``*_state_init``, which equal the reference's."""
    params, jparams, cfg, jcfg = _mixer(mixer, "fp64")
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    x = np.random.default_rng(19).standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    state = getattr(ssm, f"{mixer}_state_init")(cfg, 2, device="cpu")
    jstate = getattr(jssm, f"{mixer}_state_init")(jcfg, 2)
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in state.items()}
    assert {k: s for k, (s, _) in shapes.items()} == \
        {k: tuple(v.shape) for k, v in jstate.items()}
    assert all(dt == torch.float32 for _, dt in shapes.values())
    assert all(v.dtype == jnp.float32 for v in jstate.values())
    step, jstep = getattr(ssm, f"{mixer}_decode_step"), getattr(jssm, f"{mixer}_decode_step")
    for t in range(x.shape[1]):
        xt = torch.from_numpy(x[:, t:t + 1]).to(torch.bfloat16)
        out, state = step(params, xt, state, cfg, Policy("fp64"))
        with jd.mode_scope("xla"):
            jout, jstate = jstep(jparams, jnp.asarray(x[:, t:t + 1], jnp.bfloat16), jstate, jcfg,
                                 JPolicy("fp64"))
        assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 1, cfg.d_model)
        assert {k: (tuple(v.shape), v.dtype) for k, v in state.items()} == shapes
        jo = np.asarray(jout, np.float32)
        np.testing.assert_allclose(out.float().numpy(), jo, rtol=0,
                                   atol=MIXER_TOL["fp64"] * 2.0 ** -8 * np.abs(jo).max())
        for k, v in state.items():
            jv = np.asarray(jstate[k])
            np.testing.assert_allclose(v.numpy(), jv, rtol=0,
                                       atol=MIXER_TOL["fp64"] * STATE_EPS[mixer, k] *
                                       np.abs(jv).max())


def test_activations_are_the_references():
    """softplus as logaddexp(x, 0), silu as x·sigmoid(x): within 3 float32 ulps
    of jax.nn's (their exp and log1p differ in the last bits), and softplus
    keeps log1p(e^-x) above F.softplus's threshold of 20 (seen in float64)."""
    x = (np.random.default_rng(23).standard_normal(100_000) * 8).astype(np.float32)
    for fn, jfn in ((ssm.softplus, jax.nn.softplus), (ssm.silu, jax.nn.silu)):
        got, want = fn(torch.from_numpy(x)).numpy(), np.asarray(jfn(jnp.asarray(x)))
        assert np.all(np.abs(got - want) <= 3 * np.spacing(np.abs(want)))
    big = torch.tensor([20.5, 25.0], dtype=torch.float64)
    np.testing.assert_array_equal(ssm.softplus(big).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(big.numpy()))))
    assert bool((ssm.softplus(big) > torch.nn.functional.softplus(big)).all())


def test_mamba_init_keeps_a_log_in_float32():
    """A's log is float32 whatever the parameter dtype, as the reference's."""
    cfg = registry.get_config("jamba-1.5-large-398b", smoke=True, param_dtype="bfloat16")
    p = ssm.mamba_init(torch.Generator().manual_seed(0), cfg)
    jp = jssm.mamba_init(jax.random.PRNGKey(0), jreg.get_config("jamba-1.5-large-398b",
                                                                 smoke=True,
                                                                 param_dtype="bfloat16"))
    assert p["a_log"].dtype == torch.float32 and p["in_proj"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["a_log"].numpy(), np.asarray(jp["a_log"]))
    assert {k: tuple(v["w"].shape if isinstance(v, dict) else v.shape) for k, v in p.items()} \
        == {k: tuple(v["w"].shape if isinstance(v, dict) else v.shape) for k, v in jp.items()}
