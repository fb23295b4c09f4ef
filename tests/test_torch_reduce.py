"""The compensated reductions' kernels (csrc/carry_fold.cu) transcribed on the
CPU, and the ``reduce`` route held against repro.

The tree kernel pads every block to a power of two with (+0, +0) leaves, sums
a lane's contiguous leaves in registers and pairs lanes by shuffles (a block
of more than 512 elements in pieces of 512, joined in order); the fold
kernel runs its s chain in chunks of 32, forms each step's two_sum error and
c_b term a chunk at once, and runs the c chain a chunk behind; the norm's
pre-pass keeps the largest finite |x| as bits.  Each transcription is held
bitwise against the plain versions (``compensated._block_partials``,
``carry_fold_ref``, ``compensated_norm``'s scale), signed zeros, inf and NaN
included.  The kernels are held against the plain versions on the card
(test_torch_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compensated as jcm  # noqa: E402
from repro.hpc import cg as jcg, jacobi as jj, spmv_formats as jsf  # noqa: E402
from repro_torch.core import compensated as tcm, dispatch  # noqa: E402
from repro_torch.hpc import cg as tcg, jacobi  # noqa: E402
from repro_torch.kernels import carry_fold  # noqa: E402

RNG = np.random.default_rng(29)


def _same(got, want):
    """Bitwise, NaN equal to NaN, and the sign of every number equal."""
    g, w = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.signbit(g[~np.isnan(g)]), np.signbit(w[~np.isnan(w)]))


def _combine(pl, cl, pr, cr):
    s, e = tcm.two_sum(pl, pr)
    return s, (cl + cr) + e


def _tree_schedule(p, c, block):
    """The tree kernel's schedule over leaves (p, c) of shape (L, n): each block
    zero-padded to next_pow2(block) leaves (the tail block too) and cut into M
    pieces of P = min(next_pow2(block), 512) leaves; in a piece, Q = P / 32
    contiguous leaves a lane reduced in registers level by level, then the
    lanes paired by __shfl_down at offsets 1, 2, ... (a lane past the warp reads
    its own value), lane 0 holding the piece's node; the pieces joined in order
    through a stack of open nodes, piece t closing as many levels as t has
    trailing ones.  The partials are (L, nb)."""
    L, n = p.shape
    P = 1 << (block - 1).bit_length()
    M = max(1, P // 512)
    P //= M
    Q = 1 if P <= 32 else P // 32
    U = P // Q
    nb = -(-n // block)
    pad = torch.zeros((L, nb * block), dtype=p.dtype)
    pp, cc = pad.clone(), pad.clone()
    pp[:, :n], cc[:, :n] = p, c
    shape = (L, nb, M, U, Q)
    pp = torch.nn.functional.pad(pp.reshape(L, nb, block), (0, M * P - block)).reshape(shape)
    cc = torch.nn.functional.pad(cc.reshape(L, nb, block), (0, M * P - block)).reshape(shape)
    w = Q
    while w > 1:                                   # in registers: pairs (2i, 2i + 1)
        pp, cc = _combine(pp[..., 0:w:2], cc[..., 0:w:2], pp[..., 1:w:2], cc[..., 1:w:2])
        w //= 2
    s, c = pp[..., 0], cc[..., 0]                  # (L, nb, M, U)
    off = 1
    while off < U:                                 # lane j takes lane j + off
        idx = torch.arange(U)
        src = torch.where(idx + off < U, idx + off, idx)
        s, c = _combine(s, c, s[..., src], c[..., src])
        off *= 2
    open_nodes = []
    for t in range(M):
        node, k = (s[..., t, 0], c[..., t, 0]), t
        while k & 1:
            node = _combine(*open_nodes.pop(), *node)
            k >>= 1
        open_nodes.append(node)
    return open_nodes[0]


def _leaves(kind, x, y):
    if kind == "sum":
        return x, torch.zeros_like(x)
    if kind == "dot":
        return tcm.two_prod(x, y)
    bits, _ = carry_fold.norm_scale_ref(x)
    m, e = tcm._decompose(torch.where(torch.isfinite(x), x, torch.zeros_like(x)))
    xs = m * tcm._pow2(e - carry_fold.scale_exp_ref(bits, x.dtype)[:, None], x.dtype)
    return tcm.two_prod(xs, xs)


def _operand(shape, dtype=np.float64, special=True):
    x = RNG.standard_normal(shape) * np.exp(RNG.uniform(-40, 40, shape))
    x = x.astype(dtype)
    n = shape[-1]
    if special and n > 4:
        x[..., 1], x[..., 2] = -0.0, 0.0
        x[0, 3] = np.inf
        x[-1, -1] = np.nan
    return x


@pytest.mark.parametrize("n", [1, 511, 513, 8192, 100003])
@pytest.mark.parametrize("block", [512, 256, 300, 7, 1, 513, 1024, 4096, 10000])
@pytest.mark.parametrize("kind", ["sum", "dot", "norm"])
def test_tree_schedule_equals_block_partials(n, block, kind):
    """The power-of-two padding is the torch tree's zero lane at every odd width,
    and a block past 512 elements is its pieces of 512 joined in order: the same
    partials, bit for bit, for every block size and tail."""
    x = torch.from_numpy(_operand((2, n)))
    y = torch.from_numpy(_operand((2, n), special=False))
    p, c = _leaves(kind, x, y)
    got = _tree_schedule(p, c, block)
    want = tcm._block_partials(p, c, block)
    for g, w in zip(got, want):
        _same(g.numpy(), w.t().numpy())
    ref = carry_fold.block_tree_ref(x, y if kind == "dot" else None, block,
                                    carry_fold.norm_scale_ref(x)[0] if kind == "norm" else None)
    for g, w in zip(got, ref):
        _same(g.numpy(), w.numpy())


def test_tree_schedule_signed_zero_blocks():
    """A block of -0.0 alone keeps its sign only where the torch tree does: its
    zero lanes are +0, and two_sum(-0, +0) = +0."""
    for n, block in ((1, 1), (3, 4), (5, 7), (2, 2), (600, 700), (1, 2048)):
        x = -torch.zeros((1, n), dtype=torch.float64)
        p, c = _leaves("sum", x, None)
        got = _tree_schedule(p, c, block)
        for g, w in zip(got, tcm._block_partials(p, c, block)):
            _same(g.numpy(), w.t().numpy())


def _fold_schedule(s_b, c_b):
    """The fold kernel's schedule for one lane: chunks of 32 steps of the s
    chain, each step's s recorded; then each step's two_sum error from the
    recorded s (the chunk's first from the s before it) plus its c_b; the c chain
    over those terms a chunk later; s + c."""
    s = torch.zeros((), dtype=s_b.dtype)
    c = torch.zeros((), dtype=s_b.dtype)
    for i in range(0, len(s_b), 32):
        xs, cs = s_b[i:i + 32], c_b[i:i + 32]
        s0, hist = s, []
        for xk in xs:
            s = s + xk
            hist.append(s)
        hist = torch.stack(hist)
        prev = torch.cat([s0[None], hist[:-1]])
        v = hist - prev
        t = ((prev - (hist - v)) + (xs - v)) + cs
        for tk in t:
            c = c + tk
    return s + c


@pytest.mark.parametrize("nb", [0, 1, 31, 32, 33, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fold_schedule_equals_carry_fold_ref(nb, dtype):
    for special in (False, True):
        s_b = torch.from_numpy(RNG.standard_normal(nb) * np.exp(RNG.uniform(-30, 30, nb))
                               ).to(dtype)
        c_b = torch.from_numpy(RNG.standard_normal(nb) * 1e-17).to(dtype)
        if special and nb > 3:
            s_b[1], s_b[2], c_b[2] = -0.0, float("inf"), float("nan")
        if special and nb <= 3:
            s_b, c_b = -torch.zeros_like(s_b), -torch.zeros_like(c_b)
        _same(_fold_schedule(s_b, c_b).numpy(), carry_fold.carry_fold_ref(s_b, c_b).numpy())


def _norm_epilogue(d, bits, flags, dtype):
    """The fold kernel's norm epilogue (norm_finish) as scalar torch ops."""
    it, mb, eb, _ = tcm._ieee_layout(dtype)
    es = carry_fold.scale_exp_ref(bits, dtype)
    r = tcm.sqrt(d)
    half = es >> 1
    big = (r * tcm._pow2(half, dtype)) * tcm._pow2(es - half, dtype)
    t = r * tcm._pow2(es + (eb + mb - 1), dtype)
    tiny = t < 2.0 ** (mb + 1)
    out = torch.where(tiny, torch.round(torch.where(tiny, t, 0)).to(it).view(dtype), big)
    out = torch.where((flags & 2) != 0, torch.full_like(out, float("inf")), out)
    return torch.where((flags & 1) != 0, torch.full_like(out, float("nan")), out)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_norm_prepass_tree_fold_compose_to_compensated_norm(dtype):
    """The pre-pass's bits give compensated_norm's scale; with the tree's
    partials, the fold and its epilogue they give its bits, denormals, zero
    lanes, inf and NaN included."""
    tiny = np.finfo(dtype).smallest_subnormal
    x = _operand((6, 777), dtype)
    x[1] = 0.0
    x[2] *= tiny                                      # denormal and zero entries
    x[3, :5] = [tiny, 3 * tiny, 0.0, -tiny, 2 * tiny]
    x[3, 5:] = 0.0
    x[4] = np.abs(x[4]) * 1e-30
    tx = torch.from_numpy(x)
    bits, flags = carry_fold.norm_scale_ref(tx)
    it, mb, eb, _ = tcm._ieee_layout(tx.dtype)
    m, e = tcm._decompose(torch.where(torch.isfinite(tx), tx, torch.zeros_like(tx)))
    _, mex = torch.frexp(m)
    elog = torch.where(m > 0, e + mex - 1, torch.full_like(e, -(1 << 30))).amax(dim=1)
    np.testing.assert_array_equal(carry_fold.scale_exp_ref(bits, tx.dtype).numpy(),
                                  torch.where(elog == -(1 << 30), 0, elog).numpy())
    s_b, c_b = carry_fold.block_tree_ref(tx, None, 256, bits)
    d = torch.stack([carry_fold.carry_fold_ref(s_b[i], c_b[i]) for i in range(6)])
    _same(_norm_epilogue(d, bits, flags, tx.dtype).numpy(),
          tcm.compensated_norm(tx, axis=1).numpy())


# ---------------------------------------------------------------------------
# The reduce route
# ---------------------------------------------------------------------------

def test_reduce_route_ref_is_the_default_on_the_host_and_kernel_needs_cuda():
    x = torch.from_numpy(_operand((3, 1000), special=False))
    y = torch.from_numpy(_operand((3, 1000), special=False))
    for fn, args in ((tcm.neumaier_sum, (x,)), (tcm.compensated_dot, (x, y)),
                     (tcm.compensated_norm, (x,))):
        _same(fn(*args, mode="ref").numpy(), fn(*args).numpy())
        with dispatch.mode_scope("ref"):
            _same(fn(*args).numpy(), fn(*args, mode="auto").numpy())
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args, mode="kernel")
        with dispatch.mode_scope("kernel"), pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    launches = (carry_fold.carry_fold.launches, carry_fold.block_tree.launches,
                carry_fold.norm_scale.launches)
    tcm.compensated_norm(x, axis=0)
    assert (carry_fold.carry_fold.launches, carry_fold.block_tree.launches,
            carry_fold.norm_scale.launches) == launches


def test_reduce_route_plain_versions_match_reference():
    x = RNG.standard_normal(70001) * np.exp(RNG.uniform(-20, 20, 70001))
    y = RNG.standard_normal(70001)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert float(tcm.compensated_dot(tx, ty, mode="ref")) == float(
        jcm.compensated_dot(jnp.asarray(x), jnp.asarray(y)))
    assert float(tcm.compensated_norm(tx, mode="ref")) == float(
        jcm.compensated_norm(jnp.asarray(x)))
    assert float(tcm.neumaier_sum(tx, block=300, mode="ref")) == float(
        jcm.neumaier_sum(jnp.asarray(x), block=300))


@pytest.mark.parametrize("mode", [None, "ref"])
def test_solvers_on_the_reduce_route_retrace_reference(mode):
    """Jacobi, the dense CG and the sparse CG pass their mode to the
    reductions; on the host both modes retrace repro."""
    f = RNG.standard_normal((6, 5, 4))
    want = jj.jacobi_solve(jnp.asarray(f), omega=2.0 / 3.0, tol=0.0, maxiter=6, mode="xla")
    got = jacobi.jacobi_solve(torch.from_numpy(f), omega=2.0 / 3.0, tol=0.0, maxiter=6,
                              mode=mode)
    assert got.history == want.history
    np.testing.assert_array_equal(got.u.numpy(), np.asarray(want.u))
    a = jsf.laplacian_2d(6, 6)
    b = RNG.standard_normal(36)
    want = jcg.cg_solve_dense(jnp.asarray(a), jnp.asarray(b), tol=1e-10, maxiter=100, mode="xla")
    got = tcg.cg_solve_dense(torch.from_numpy(a), torch.from_numpy(b), tol=1e-10, maxiter=100,
                             mode=mode)
    assert got.iters == want.iters and got.history == want.history
    val, col = jsf.to_blocked_ell(a, bw=8)
    want = jcg.cg_solve_bell(jnp.asarray(val), jnp.asarray(col), jnp.asarray(b), tol=1e-10,
                             mode="xla")
    got = tcg.cg_solve_bell(torch.from_numpy(val), torch.from_numpy(col), torch.from_numpy(b),
                            tol=1e-10, mode=mode)
    assert got.iters == want.iters and got.history == want.history
