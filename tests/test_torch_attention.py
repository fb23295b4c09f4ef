"""repro_torch's emulated attention held against repro's (CPU).

The QKᵀ and PV products, the scaling and the masking are held bitwise.  The
softmax is held within 1e-12 of the output's scale: torch's CPU exp differs from
XLA-CPU's in up to 2 ulp on ~15% of inputs and its tanh on ~58% (ROADMAP queue 3,
item 3), and the port fixes the row-sum order (a pairwise tree) and divides by
the softcap as a multiply by its reciprocal, so that its kernel can repeat both.
repro runs on its ``xla`` route.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dispatch as jd  # noqa: E402
from repro.core import ozaki2 as jo  # noqa: E402
from repro.kernels import ozaki_attention as ja  # noqa: E402
from repro_torch.core import dispatch, ozaki2  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ozaki_attention as ta  # noqa: E402

RNG = np.random.default_rng(23)
TOL = 1e-12   # of max|v|, the bound tests/test_attention.py holds repro to


def _qkv(S, T, D, lead=()):
    return (RNG.standard_normal(lead + (S, D)), RNG.standard_normal(lead + (T, D)),
            RNG.standard_normal(lead + (T, D)))


def _window(S, T, w):
    i, j = np.arange(S)[:, None] + (T - S), np.arange(T)[None, :]
    return ((j <= i) & (i - j < w)).astype(np.int8)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


CASES = {
    # name: (S, T, D, lead, mask, softcap)
    "ragged": (9, 21, 8, (), "causal", 0.0),
    "d16 two blocks": (20, 150, 16, (), "causal", 0.0),
    "d80 ragged batched": (13, 37, 80, (2,), "random", 0.0),
    "softcap": (16, 16, 8, (), "causal", 30.0),
    "window, fully masked row": (12, 40, 16, (), "window", 0.0),
    "batched leading dims": (8, 12, 8, (2, 2), "shared", 0.0),
    "no mask": (8, 12, 8, (), None, 0.0),
}


def _mask(kind, S, T, lead):
    if kind == "causal":
        return np.tril(np.ones((S, T), np.int8), k=T - S)
    if kind == "random":
        return (RNG.random(lead + (S, T)) < 0.7).astype(np.int8)
    if kind == "window":
        m = _window(S, T, 5)
        m[3] = 0                              # a fully masked row
        return m
    if kind == "shared":
        return (RNG.random((S, T)) < 0.8).astype(np.int8)
    return None


@pytest.mark.parametrize("name", list(CASES))
def test_dispatch_attention_matches_reference(name):
    S, T, D, lead, kind, softcap = CASES[name]
    q, k, v = _qkv(S, T, D, lead)
    mask = _mask(kind, S, T, lead)
    got = dispatch.attention(_t(q), _t(k), _t(v), mask=_t(mask), softcap=softcap)
    want = np.asarray(jd.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   mask=None if mask is None else jnp.asarray(mask),
                                   softcap=softcap, mode="xla"))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(v).max())
    via_ops = ops.ozaki_attention(_t(q), _t(k), _t(v), mask=_t(mask), softcap=softcap)
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


def test_attention_ref_matches_reference_and_the_fp64_oracle():
    S, T, D, bkv = 24, 40, 16, 16             # three key blocks, the last one ragged
    q, k, v = _qkv(S, T, D)
    mask = np.tril(np.ones((S, T), np.int8), k=T - S)
    pq, pp = dispatch.get_plan(D), dispatch.get_plan(bkv)
    got = ta.attention_ref(_t(q), _t(k), _t(v), _t(mask), pq, pp, 0.0, bkv).numpy()
    jpq, jpp = jo.make_plan(D), jo.make_plan(bkv)
    want = np.asarray(ja.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(mask), jpq, jpp, bkv=bkv))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(v).max())
    s = np.where(mask != 0, q @ k.T / math.sqrt(D), -1e30)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    oracle = (p / p.sum(axis=-1, keepdims=True)) @ v
    np.testing.assert_allclose(got, oracle, rtol=0, atol=TOL * np.abs(v).max())


def test_block_products_and_scores_are_bitwise():
    """With the exp and the sum order taken out, every part is bitwise: the QKᵀ
    product of a key block, the scaled and masked scores (no softcap), and the
    PV product with the block's probabilities as an input."""
    S, D, bkv = 11, 80, 24
    q, k, v = _qkv(S, bkv, D)
    mask = (RNG.random((S, bkv)) < 0.6)
    pq, pp = dispatch.get_plan(D), dispatch.get_plan(bkv)
    jpq, jpp = jo.make_plan(D), jo.make_plan(bkv)
    s_prod = ozaki2.emulated_matmul(_t(q), _t(k).T, pq)
    want = np.asarray(jo.emulated_matmul(jnp.asarray(q), jnp.asarray(k).T, jpq))
    np.testing.assert_array_equal(s_prod.numpy(), want)
    inv = 1.0 / math.sqrt(D)
    s = ta._masked_scores(s_prod, _t(mask), 0.0, inv)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(ja._masked_scores(jnp.asarray(want), jnp.asarray(mask), 0.0, inv)))
    # probabilities as the scan makes them: in [0, 1], exactly 1 at each row max
    p = np.exp(np.minimum(RNG.standard_normal((S, bkv)) * 3, 0.0))
    p[RNG.random((S, bkv)) < 0.2] = 0.0
    pv = ozaki2.emulated_matmul(_t(p), _t(v), pp)
    np.testing.assert_array_equal(
        pv.numpy(), np.asarray(jo.emulated_matmul(jnp.asarray(p), jnp.asarray(v), jpp)))


def test_batched_emulated_matmul_is_each_problem_alone():
    a, b = RNG.standard_normal((3, 7, 40)), RNG.standard_normal((3, 40, 9))
    plan = dispatch.get_plan(40)
    got = ozaki2.emulated_matmul(_t(a), _t(b), plan)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(),
                                      ozaki2.emulated_matmul(_t(a[i]), _t(b[i]), plan).numpy())


@pytest.mark.parametrize("n", [1, 8, 24, 128])
def test_row_sum_is_the_pairwise_tree(n):
    p = np.exp(-np.abs(RNG.standard_normal((5, n))) * 4)

    def tree(x):
        w = 1 << (len(x) - 1).bit_length()
        x = list(x) + [0.0] * (w - len(x))
        while len(x) > 1:
            x = [x[i] + x[i + 1] for i in range(0, len(x), 2)]
        return x[0]

    got = ta._row_sum(_t(p)).numpy()
    np.testing.assert_array_equal(got, [tree(row) for row in p])
    np.testing.assert_allclose(got, p.sum(axis=-1), rtol=4 * n * 2.0 ** -53)


def test_online_update_matches_reference():
    s = RNG.standard_normal((6, 16)) * 4
    s[2] = ta.NEG_INF                                          # fully masked so far
    m = np.array([-1e30, 0.5, -1e30, 3.0, 9.0, -2.0])
    l = np.abs(RNG.standard_normal(6))
    got = ta._online_update(_t(s), _t(m), _t(l))
    want = ja._online_update(jnp.asarray(s), jnp.asarray(m), jnp.asarray(l))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))     # m_new: exact
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=8 * 2.0 ** -52)


def test_kernel_wrapper_on_the_host_and_its_checks():
    q, k, v = (_t(x) for x in _qkv(9, 21, 16, (3,)))
    mask = torch.ones((3, 9, 21), dtype=torch.int8)
    pq, pp = dispatch.get_plan(16), dispatch.get_plan(24)
    before = ta.attention_fused.launches
    got = ta.attention_fused(q, k, v, mask, pq, pp, 0.0, bq=16, bkv=24)
    assert ta.attention_fused.launches == before           # the plain version ran
    np.testing.assert_array_equal(got.numpy(),
                                  ta.attention_ref(q, k, v, mask, pq, pp, 0.0, 24).numpy())
    with pytest.raises(ValueError):
        ta.attention_fused(q[0], k[0], v[0], mask[0], pq, pp, bq=16, bkv=24)
    with pytest.raises(ValueError):
        ta.attention_fused(q, k[:, :20], v, mask, pq, pp, bq=16, bkv=24)
    with pytest.raises(TypeError):
        ta.attention_fused(q.to(torch.int32), k, v, mask, pq, pp, bq=16, bkv=24)


def test_attention_kind_routes_and_kernel_mode_needs_cuda():
    q, k, v = (_t(x) for x in _qkv(4, 6, 8))
    with pytest.raises(ValueError, match="CUDA"):
        dispatch.attention(q, k, v, mode="kernel")
    with dispatch.mode_scope("kernel"), pytest.raises(ValueError, match="CUDA"):
        ops.ozaki_attention(q, k, v)
    assert dispatch.get_tuning("attention", (1, 4, 8, 6)) == {"bq": 16, "bkv": 128}
