"""repro_torch's M-RoPE and qwen2-vl-72b's stub vision path, held against
repro's at its smoke config (CPU).

Inputs come from numpy seeds (the stub frontend's patch embeddings from
``registry.concrete_batch``); repro's parameters are carried across with
``convert.params_from_jax``.  Logits are held within LOGIT_TOL of their scale,
as in ``tests/test_torch_models.py``.  M-RoPE's angles are not bitwise against
XLA's (ROADMAP queue 3, item 3): the float32 ``pow`` of its frequencies differs
by 1 ulp at 1 of the 64 frequencies of θ = 10⁶ (none at the smoke config's θ =
10⁴), which a position p carries into the angle, and ``sin``/``cos`` of one
angle differ by 1 in 2⁻²⁴.  So sin and cos are held within ANGLE_TOL·(1 +
max|angle|) absolute; the stream assignment and gathered positions, and the
product given the same frequencies, are exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import dispatch as jd  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

EPS = 2.0 ** -23
LOGIT_TOL = 64 * EPS
# |sin - XLA's sin| and |cos - XLA's cos| in units of 2⁻²³·(1 + max|angle|):
# measured at most 0.31 eager and 0.50 jitted at θ = 10⁶ over positions < 4096
# (8 seeds of 2 x 3 x 300 and one of 2 x 3 x 4096), 0.008 and 0.031 at the smoke's.
ANGLE_TOL = EPS
ARCH = "qwen2-vl-72b"
S = 12


def _models(policy="fp64", seed=11):
    jcfg = jreg.get_config(ARCH, smoke=True, policy_name=policy, compute_dtype="float32")
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    cfg = registry.get_config(ARCH, smoke=True, policy_name=policy, compute_dtype="float32")
    state = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg).load(state)


def _grid(batch, rows, cols):
    """An image's merged patches as Qwen2-VL lays them out: t = 0, h = row,
    w = column, (batch, 3, rows * cols) int32."""
    i = np.arange(rows * cols)
    return np.broadcast_to(np.stack([0 * i, i // cols, i % cols]), (batch, 3, rows * cols)
                           ).astype(np.int32)


@pytest.mark.parametrize("head_dim,theta,sections,top", [
    (16, 1e4, (2, 3, 3), 64),              # the smoke config's
    (128, 1e6, (16, 24, 24), 4096),        # qwen2-vl-72b's
])
def test_mrope_angles_match_reference(head_dim, theta, sections, top):
    pos = np.random.default_rng(5).integers(0, top, (2, 3, 300)).astype(np.int32)
    half = head_dim // 2
    # each frequency takes its stream's positions, exactly
    got = layers.mrope_positions(torch.from_numpy(pos), sections).numpy()
    owner = np.repeat(np.arange(3), sections)
    np.testing.assert_array_equal(got, pos[:, owner, :].transpose(0, 2, 1).astype(np.float32))
    sin, cos = layers.mrope_angles(torch.from_numpy(pos), head_dim, theta, sections)
    assert tuple(sin.shape) == (2, 300, half) and sin.dtype == torch.float32
    inv = np.array(1.0 / (theta ** (jnp.arange(0, half, dtype=jnp.float32) / half)))
    bound = ANGLE_TOL * (1 + float(np.abs(got * inv).max()))
    for fn in (jlayers.mrope_angles, jax.jit(jlayers.mrope_angles, static_argnums=(1, 2, 3))):
        jsin, jcos = fn(jnp.asarray(pos), head_dim, theta, sections)
        assert float(np.abs(sin.numpy() - np.asarray(jsin)).max()) <= bound
        assert float(np.abs(cos.numpy() - np.asarray(jcos)).max()) <= bound
    # given the reference's frequencies, the angle is the same product
    ang = torch.from_numpy(got) * torch.from_numpy(inv)
    np.testing.assert_array_equal(ang.numpy(), got * inv)
    # text-only positions: three equal streams are standard RoPE
    text = np.broadcast_to(pos[:1, :1], (1, 3, 300)).copy()
    s3, c3 = layers.mrope_angles(torch.from_numpy(text), head_dim, theta, sections)
    s1, c1 = layers.rope_angles(torch.from_numpy(text[0, 0]), head_dim, theta)
    np.testing.assert_array_equal(s3[0].numpy(), s1.numpy())
    np.testing.assert_array_equal(c3[0].numpy(), c1.numpy())
    with pytest.raises(ValueError):
        layers.mrope_angles(torch.from_numpy(pos), head_dim + 2, theta, sections)


def test_vision_forward_matches_reference():
    """The stub's bfloat16 patch embeddings with a 3 x 4 grid's three distinct
    position streams: logits within LOGIT_TOL of repro's."""
    jmodel, jparams, model = _models()
    batch = registry.concrete_batch(model.cfg, base.SHAPES[0], batch=2, seq=S, seed=7,
                                    device="cpu")
    assert set(batch) == {"embeds", "positions", "labels"}
    assert batch["embeds"].dtype == torch.bfloat16
    pos = _grid(2, 3, 4)
    got, aux = model.apply({"embeds": batch["embeds"], "positions": torch.from_numpy(pos)})
    with jd.mode_scope("xla"):
        emb = jnp.asarray(batch["embeds"].float().numpy(), jnp.bfloat16)
        want, jaux = jmodel.apply(jparams, {"embeds": emb, "positions": jnp.asarray(pos)})
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, S, model.cfg.vocab_size)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL * np.abs(want).max())


def test_text_decode_matches_reference_and_forward():
    """Text only: 12 decode steps (positions broadcast to three equal streams
    of batch B) against repro's jitted decode_step and the port's own forward
    over the same tokens."""
    jmodel, jparams, model = _models()
    tokens = np.random.default_rng(67).integers(0, model.cfg.vocab_size, (2, S))
    full = model.apply({"tokens": torch.from_numpy(tokens)})[0].numpy()
    cache = model.init_cache(batch=2, seq_len=S)
    steps = []
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
            steps.append(lg[:, 0].numpy())
    np.testing.assert_allclose(np.stack(steps, 1), full, rtol=0,
                               atol=LOGIT_TOL * np.abs(full).max())
    # text positions given as three equal streams are the same forward
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, 3, S)).copy()
    again = model.apply({"tokens": torch.from_numpy(tokens), "positions": torch.from_numpy(pos)})
    np.testing.assert_array_equal(again[0].numpy(), full)


def test_mrope_positions_affect_output():
    """The reference's ``tests/test_models_smoke.py::test_mrope_positions_affect_output``
    on the port: a different h stream moves the logits."""
    cfg = registry.get_config(ARCH, smoke=True, compute_dtype="float32")
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    n = 8
    emb = torch.from_numpy(rng.standard_normal((1, n, cfg.d_model)).astype(np.float32))
    p1 = torch.from_numpy(np.broadcast_to(np.arange(n), (1, 3, n)).astype(np.int32))
    p2 = p1.clone()
    p2[0, 1] = torch.arange(n) * 3                     # different h-stream positions
    l1, _ = model.apply({"embeds": emb, "positions": p1})
    l2, _ = model.apply({"embeds": emb, "positions": p2})
    assert float((l1 - l2).abs().max()) > 0


@pytest.mark.parametrize("name", ["ozaki2_int8", "ozaki2_fp8", "ozaki1_int8"])
def test_policy_dot_column_blocks_are_the_whole_product(name, monkeypatch):
    """An emulated product whose weight has more than DOT_MAX_W elements (the
    served qwen2-vl-72b's 8192 x 152064 LM head) runs over column blocks of it:
    bitwise the whole product; with a gradient the product stays whole."""
    from repro_torch.core import dispatch, ozaki1
    from repro_torch.core import policy as policy_mod

    assert policy_mod.column_blocks(8192, 152064) == \
        [(j, min(j + 32768, 152064)) for j in range(0, 152064, 32768)]
    assert len(policy_mod.column_blocks(8192, 65536)) == 2          # jamba's head
    assert policy_mod.column_blocks(4096, 64000) == [(0, 64000)]     # yi-6b's head
    monkeypatch.setattr(policy_mod, "DOT_MAX_W", 40 * 300)
    assert policy_mod.column_blocks(40, 700) == [(0, 256), (256, 512), (512, 700)]
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.standard_normal((2, 3, 40)))
    w = torch.from_numpy(rng.standard_normal((40, 700)))
    got = policy_mod.Policy(name).dot(x, w)
    if name == "ozaki1_int8":
        want = ozaki1.emulated_matmul(x.reshape(6, 40), w).reshape(2, 3, 700)
    else:
        want = dispatch.dot(x, w, substrate=name.split("_")[1])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    calls = []
    monkeypatch.setattr(policy_mod, "column_blocks", lambda *a: calls.append(a))
    xg = x.clone().requires_grad_(True)
    np.testing.assert_array_equal(policy_mod.Policy(name).dot(xg, w).detach().numpy(),
                                  want.numpy())
    assert calls == []
