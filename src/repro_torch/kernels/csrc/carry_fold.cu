// The compensated reductions for Hopper (sm_90a): the blocked two_sum tree, the
// in-order carry fold, and the 2-norm's pre-pass (repro_torch/core/compensated.py).
//
// A reduction over n elements of each of L lanes cuts a lane into nb blocks of
// `block` elements (the last zero-padded) and runs three stages:
//   norm pre-pass  per lane, the largest finite |x| as IEEE bits and the NaN and
//                  inf flags, from which the 2-norm's exact power-of-two scale
//                  es comes (compensated_norm: m * 2^(e - es) by bit fields);
//   tree           per block, the pairwise two_sum tree of compensated._block_tree
//                  over its leaves: x (neumaier_sum), two_prod(x, y)
//                  (compensated_dot) or two_prod(xs, xs) of the scaled x
//                  (compensated_norm), giving the partials (s_b, c_b);
//   fold           per lane, the partials strictly in block order,
//                    s, e = two_sum(s, s_b[k]);  c = c + (e + c_b[k]);  from s = c = +0,
//                  and s + c; for the norm also its scalar epilogue (sqrt and the
//                  power-of-two unscale, the denormal path, inf and NaN).
// The fold replaces the reference's lax.scan (repro/core/compensated.py::_carry_scan,
// line 111), the tree its _block_tree (:96) and the pre-pass its scale (:268-286);
// none of them is a TPU kernel (no pallas_call), but on the card they run on
// every dot and norm of the solvers.  The build passes --fmad=false and every
// operation is the plain version's, so the results are its bits.
//
// Bounds on the H100.  Tree and pre-pass: the operands read once at 3.35 TB/s
// (a 256^3 norm reads 134 MB twice, ~0.04 ms each).  Fold: its bytes (16 B a
// partial) take ~0.16 us at 32,768 partials, but the order fixes the bits, so
// s and c are two chains of nb dependent additions each: the fold takes at
// least nb times the FP64 add latency however wide the card.
//
// Design.
//   tree   A warp per block of P = next_pow2(block) <= 512 leaves (several
//          blocks a warp when P < 32): the warp reads the block's operands
//          coalesced into shared memory, a lane reduces Q = P / 32 contiguous leaves in
//          registers, then log2(P / Q) levels pair lanes (2i, 2i + 1) by
//          __shfl_down.  Padding every block to P with (+0, +0) leaves is the
//          torch tree's zero lane at every odd width: the node j of level k
//          covers leaves [j 2^k, (j + 1) 2^k) in both, a node past the data is
//          (+0, +0) in both, and two_sum(+0, +0) = (+0, +0).  A larger block
//          is pieces of 512 leaves, each such a tree, joined in order by the
//          same combine.
//   fold   A warp per lane.  Each lane copies one partial of every chunk of 32
//          into shared memory by cp.async, four chunks ahead.  All 32
//          lanes run the s chain redundantly (one FP64 add on the chain a step),
//          its operands loaded into registers a group of 8 steps ahead, and
//          keep s after each step, stored a group at a time; each lane forms
//          the two_sum error of its own step and its c_b term at once, a chunk
//          later and inside the next chunk's chain, and the c chain folds those
//          terms (one add a step) interleaved with the s chain two chunks on.
//          No barrier but __syncwarp, no load on either chain's dependency
//          path, and no shared-memory load behind a store inside a group.
//   pre-pass  A block per 16,384 elements of a lane; a max and an or across
//          the block, then one atomicMax and one atomicOr a block (order-free).
#include <cstdint>
#include <cuda_runtime.h>

namespace carry {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTreeThreads = 128;   // four warps a block
constexpr int kTreePiece = 512;     // leaves a warp reduces at once
constexpr int kTreeMaxBlock = 1 << 30;
constexpr int kTreeMaxLevels = 22;  // open nodes of a block: log2(2^30 / 512) + 1
constexpr int kFoldThreads = 128;   // four lanes (warps) a block
constexpr int kFoldAhead = 4;       // chunks of 32 partials loaded ahead
constexpr int kScaleThreads = 256;
constexpr int kScaleChunk = 16384;  // elements of a lane per pre-pass block
enum Kind { kSum = 0, kDot = 1, kNorm = 2 };

// IEEE layouts (compensated._IEEE): bit type, mantissa bits, exponent bias and
// the Veltkamp split constant of numerics.two_prod.
template <typename T>
struct Ieee;
template <>
struct Ieee<double> {
  using U = unsigned long long;
  using S = long long;
  static constexpr int kMant = 52, kBias = 1023, kExpMax = 2047;
  static constexpr double kSplit = 134217729.0;  // 2^27 + 1
  static __device__ __forceinline__ U bits(double x) { return (U)__double_as_longlong(x); }
  static __device__ __forceinline__ double from(U b) { return __longlong_as_double((S)b); }
};
template <>
struct Ieee<float> {
  using U = unsigned int;
  using S = int;
  static constexpr int kMant = 23, kBias = 127, kExpMax = 255;
  static constexpr float kSplit = 4097.0f;  // 2^12 + 1
  static __device__ __forceinline__ U bits(float x) { return __float_as_uint(x); }
  static __device__ __forceinline__ float from(U b) { return __uint_as_float(b); }
};

// numerics.two_sum (Knuth) and numerics.two_prod (Veltkamp / Dekker).
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  const T v = s - a;
  e = (a - (s - v)) + (b - v);
}

template <typename T>
__device__ __forceinline__ void two_prod(T a, T b, T& p, T& e) {
  p = a * b;
  const T ca = Ieee<T>::kSplit * a;
  const T ah = ca - (ca - a);
  const T al = a - ah;
  const T cb = Ieee<T>::kSplit * b;
  const T bh = cb - (cb - b);
  const T bl = b - bh;
  e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
}

// compensated._pow2: 2^p with p clamped to the normal range, from bit fields.
template <typename T>
__device__ __forceinline__ T pow2(int p) {
  using I = Ieee<T>;
  p = max(1 - I::kBias, min(p, I::kBias));
  return I::from((typename I::U)(p + I::kBias) << I::kMant);
}

// es of compensated_norm from the largest finite |x| as bits: floor(log2 |x|)
// by bit fields, 0 for an all-zero lane.
template <typename T>
__device__ __forceinline__ int scale_exp(typename Ieee<T>::U b) {
  using I = Ieee<T>;
  if (b == 0) return 0;
  const int expf = (int)(b >> I::kMant);
  if (expf != 0) return expf - I::kBias;
  const typename I::U mant = b & ((typename I::U(1) << I::kMant) - 1);
  const int lz = sizeof(T) == 8 ? __clzll((long long)mant) : __clz((int)mant);
  return (1 - I::kBias - I::kMant) + (int)(8 * sizeof(T) - 1) - lz;
}

// compensated._decompose and the pre-scale: |x| = m 2^e, xs = m * _pow2(e - es),
// with a non-finite x taken as 0.
template <typename T>
__device__ __forceinline__ T norm_scaled(T x, int es) {
  using I = Ieee<T>;
  using U = typename I::U;
  U b = I::bits(x) & ~(U(1) << (8 * sizeof(T) - 1));
  if ((int)(b >> I::kMant) == I::kExpMax) b = 0;
  const int expf = (int)(b >> I::kMant);
  const U mant = b & ((U(1) << I::kMant) - 1);
  const T m = (T)(expf == 0 ? mant : (mant | (U(1) << I::kMant)));
  const int e = (expf == 0 ? 1 : expf) - (I::kBias + I::kMant);
  return m * pow2<T>(e - es);
}

// The tree's combine: s, e = two_sum(p_l, p_r); c = (c_l + c_r) + e.
template <typename T>
__device__ __forceinline__ void combine(T pl, T cl, T pr, T cr, T& p, T& c) {
  T s, e;
  two_sum(pl, pr, s, e);
  c = (cl + cr) + e;
  p = s;
}

// The levels of the tree over a lane's W leaves, pairs (2i, 2i + 1), into
// p[0], c[0]; a level at a time, each fully unrolled.
template <int W, typename T, int N>
__device__ __forceinline__ void reduce_lane(T (&p)[N], T (&c)[N]) {
  if constexpr (W > 1) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      combine(p[2 * i], c[2 * i], p[2 * i + 1], c[2 * i + 1], p[i], c[i]);
    }
    reduce_lane<W / 2>(p, c);
  }
}

// The leaf (p, c) of operands x (and y): x (sum), two_prod(x, y) (dot) or
// two_prod(xs, xs) of the scaled x (norm).  Past the data x = y = +0, whose
// leaf is (+0, +0) in all three, as the torch tree's zero padding.
template <typename T, int K>
__device__ __forceinline__ void leaf(T xv, T yv, int es, T& p, T& c) {
  if (K == kSum) {
    p = xv;
    c = T(0);
  } else if (K == kDot) {
    two_prod(xv, yv, p, c);
  } else {
    const T xs = norm_scaled<T>(xv, es);
    two_prod(xs, xs, p, c);
  }
}

// The tree of one piece of P <= 512 leaves, `left` of them data, into (s, c)
// of lane j = 0 of its U = P / Q lanes.  With Q > 1 the warp reads the piece's
// operands coalesced (lane l, elements l + 32 k) into its shared-memory stage
// sx, sy, element i at i + i / 16 (no bank conflict either way), and each lane
// takes its Q contiguous elements from there.  Every load is predicated, none
// branched around, and all are issued before the first store, so a warp has
// its whole piece in flight at once.
template <typename T, int Q, int K>
__device__ __forceinline__ void piece_tree(const T* xb, const T* yb, int64_t left, int es,
                                           int lane, int j, int U, T* sx, T* sy, T& s,
                                           T& cc) {
  T p[Q], c[Q];
  if constexpr (Q == 1) {
    const bool in = j < left;
    leaf<T, K>(in ? __ldg(xb + j) : T(0), (K == kDot && in) ? __ldg(yb + j) : T(0), es, p[0],
               c[0]);
  } else {
    // every load issued before the first store, which would wait on its load
    T xv[Q], yv[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int i = lane + 32 * k;
      xv[k] = i < left ? __ldg(xb + i) : T(0);
      yv[k] = (K == kDot && i < left) ? __ldg(yb + i) : T(0);
    }
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int i = lane + 32 * k;
      sx[i + i / 16] = xv[k];
      if (K == kDot) sy[i + i / 16] = yv[k];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int i = j * Q + q;
      leaf<T, K>(sx[i + i / 16], K == kDot ? sy[i + i / 16] : T(0), es, p[q], c[q]);
    }
  }
  reduce_lane<Q>(p, c);
  s = p[0];
  cc = c[0];
  for (int off = 1; off < U; off *= 2) {
    // Lane j takes lane j + off's node; only lanes j that are multiples of
    // 2 off hold nodes of this level, and their partners lie in the piece.
    const T sr = __shfl_down_sync(kFull, s, off);
    const T cr = __shfl_down_sync(kFull, cc, off);
    combine(s, cc, sr, cr, s, cc);
  }
}

// x, y (L, n) contiguous; scale_bits (L) for the norm.  sb, cb (L, nb): the
// partials of block b of lane l at l * nb + b.  A block's tree has
// next_pow2(block) leaves, cut into M pieces of P = min(next_pow2(block), 512)
// leaves, Q = P / 32 of them a lane (Q = 1: 32 / P blocks a warp).  kPieces
// (M > 1, so P = 512 and a warp a block): the warp runs the pieces in order
// and joins them by the same (2i, 2i + 1) combine, a stack of the open nodes
// (piece t closes as many levels as t has trailing ones); piece t
// covers leaves [512 t, 512 (t + 1)), the node of level 9 there.
template <typename T, int Q, int K, bool kPieces>
__global__ void __launch_bounds__(kTreeThreads) tree_kernel(
    const T* __restrict__ x, const T* __restrict__ y,
    const typename Ieee<T>::U* __restrict__ scale_bits, int64_t n, int64_t L, int block,
    int P, int M, int64_t nb, T* __restrict__ sb, T* __restrict__ cb) {
  constexpr int kStage = Q > 1 ? 32 * Q + 2 * Q : 1;
  __shared__ T sx[kTreeThreads / 32][kStage];
  __shared__ T sy[kTreeThreads / 32][K == kDot ? kStage : 1];
  const int U = P / Q;  // lanes a piece, a power of two <= 32
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t warp = (blockIdx.x * (int64_t)kTreeThreads + threadIdx.x) >> 5;
  const int64_t item = warp * (32 / U) + lane / U;
  const int j = lane % U;
  const bool active = item < L * nb;
  const int64_t ell = active ? item / nb : 0, b = active ? item % nb : 0;
  int es = 0;
  if (K == kNorm && active) es = scale_exp<T>(scale_bits[ell]);
  const T* xb = x + ell * n + b * block;
  const T* yb = K == kDot ? y + ell * n + b * block : nullptr;
  const int64_t left = active ? min(n - b * block, (int64_t)block) : 0;  // elements here
  T s, cc;
  if constexpr (!kPieces) {
    piece_tree<T, Q, K>(xb, yb, left, es, lane, j, U, sx[w], sy[w], s, cc);
  } else {
    T ns[kTreeMaxLevels], nc[kTreeMaxLevels];
    int depth = 0;
    for (int t = 0; t < M; ++t) {
      const int64_t lt = max((int64_t)0, min(left - (int64_t)t * P, (int64_t)P));
      const int64_t at = lt > 0 ? (int64_t)t * P : 0;  // a piece past the data loads nothing
      piece_tree<T, Q, K>(xb + at, K == kDot ? yb + at : nullptr, lt, es, lane, j, U, sx[w],
                          sy[w], s, cc);
      __syncwarp();  // the next piece rewrites this warp's stage
      for (int k = t; k & 1; k >>= 1) {
        --depth;
        combine(ns[depth], nc[depth], s, cc, s, cc);
      }
      ns[depth] = s;
      nc[depth] = cc;
      ++depth;
    }
    s = ns[0];
    cc = nc[0];
  }
  if (active && j == 0) {
    sb[item] = s;
    cb[item] = cc;
  }
}

// compensated_norm's epilogue on the folded sum d of xs * xs (one lane).
template <typename T>
__device__ __forceinline__ T norm_finish(T d, typename Ieee<T>::U bits, int flags) {
  using I = Ieee<T>;
  using U = typename I::U;
  const T r = sqrt(d);  // correctly rounded, as torch's CUDA sqrt and numpy's
  const int es = scale_exp<T>(bits);
  const int half = es >> 1;  // floor(es / 2)
  const T big = (r * pow2<T>(half)) * pow2<T>(es - half);
  const T t = r * pow2<T>(es + (I::kBias + I::kMant - 1));
  T nrm = big;
  if (t < (T)(U(1) << (I::kMant + 1))) nrm = I::from((U)(typename I::S)rint(t));
  if (flags & 2) nrm = I::from(U(I::kExpMax) << I::kMant);                              // +inf
  if (flags & 1) nrm = I::from((U(I::kExpMax) << I::kMant) | (U(1) << (I::kMant - 1)));  // NaN
  return nrm;
}

// Two values of T in one 8- or 16-byte word (shared-memory traffic of the fold).
template <typename T>
struct Pair;
template <>
struct Pair<double> {
  using V = double2;
};
template <>
struct Pair<float> {
  using V = float2;
};

// cp.async of one element (4 or 8 bytes) into shared memory, zero-filled when
// `in` is false; a thread waits for its own groups with cp_async_wait.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* smem, const T* gmem, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(gmem),
               "n"(sizeof(T)), "r"(in ? (int)sizeof(T) : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The c chain's terms of one chunk, a step a lane: the two_sum error of step k,
// from the recorded s after it (hist) and before it, plus its c_b.
template <typename T>
__device__ __forceinline__ T chunk_term(const T* hist, int lane, T s_before, T x, T c_b) {
  const T sk = hist[lane];
  T sp = __shfl_up_sync(kFull, sk, 1);
  if (lane == 0) sp = s_before;
  const T v = sk - sp;
  return ((sp - (sk - v)) + (x - v)) + c_b;
}

// s_b, c_b (L, nb) contiguous; out (L).  kNorm: out is the norm from scale_bits
// and flags (L).  A warp a lane; chunks of 32 steps in groups of kGroup.  The
// chunk's partials arrive in shared memory by cp.async kFoldAhead - 1 chunks
// ahead.  Chunk i runs the s chain over its own steps and the c chain over the
// terms of chunk i - 2, and forms chunk i - 1's terms between its first and
// second group, so that work fills the chain's latency.  The operands of a
// group (s_b[k] and the terms t[k], read by every lane at one address) are
// loaded while the group before runs, and the group's s values are stored
// after it: no load waits on a store inside the chain, and each step's two
// additions wait only on their own chains.
template <typename T, bool kNorm>
__global__ void __launch_bounds__(kFoldThreads) carry_fold_kernel(
    const T* __restrict__ sb, const T* __restrict__ cb, int64_t nb, int64_t L,
    const typename Ieee<T>::U* __restrict__ scale_bits, const int* __restrict__ flags,
    T* __restrict__ out) {
  using V = typename Pair<T>::V;
  constexpr int kGroup = 8, kGroups = 32 / kGroup, kWarps = kFoldThreads / 32;
  __shared__ V xbuf[kWarps][kFoldAhead][16];  // the partials s_b of kFoldAhead chunks
  __shared__ T cbuf[kWarps][kFoldAhead][32];  // and their c_b
  __shared__ V hist[kWarps][2][16];           // s after each step, by chunk parity
  __shared__ V tbuf[kWarps][2][16];           // the c chain's terms, by chunk parity
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t ell = blockIdx.x * (int64_t)kWarps + w;
  if (ell >= L) return;  // a whole warp
  const T* ps = sb + ell * nb;
  const T* pc = cb + ell * nb;
  const int64_t nch = (nb + 31) / 32;
  auto fetch = [&](int64_t chunk) {  // one commit group per chunk, empty past the end
    const int64_t k = 32 * chunk + lane;
    const int slot = (int)(chunk % kFoldAhead);
    cp_async_elem(reinterpret_cast<T*>(xbuf[w][slot]) + lane, ps + (k < nb ? k : 0), k < nb);
    cp_async_elem(cbuf[w][slot] + lane, pc + (k < nb ? k : 0), k < nb);
    cp_async_commit();
  };
#pragma unroll
  for (int d = 0; d + 1 < kFoldAhead; ++d) fetch(d);
  T s = T(0), c = T(0);
  // chunk i - 1: this lane's s_b and c_b, the s before it, its steps; chunk i - 2's steps
  T x1 = T(0), c1 = T(0), s1 = T(0);
  int steps1 = 0, steps2 = 0;
  for (int64_t i = 0; i < nch; ++i) {
    fetch(i + kFoldAhead - 1);
    cp_async_wait<kFoldAhead - 1>();  // this lane's part of chunk i has landed
    __syncwarp();
    const int slot = (int)(i % kFoldAhead);
    const V* xb = xbuf[w][slot];
    const T xv = reinterpret_cast<const T*>(xb)[lane], cv = cbuf[w][slot][lane];
    const int steps = (int)(nb - 32 * i < 32 ? nb - 32 * i : 32);
    const V* tb = tbuf[w][i & 1];  // chunk i - 2's terms
    V* hc = hist[w][i & 1];
    const T* hp = reinterpret_cast<const T*>(hist[w][(i + 1) & 1]);  // chunk i - 1's s
    T* tp = reinterpret_cast<T*>(tbuf[w][(i + 1) & 1]);              // chunk i - 1's terms
    const T s0 = s;
    if (steps == 32 && steps2 == 32) {
      T xg[kGroup], tg[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup / 2; ++k) {
        const V x2 = xb[k], t2 = tb[k];
        xg[2 * k] = x2.x;
        xg[2 * k + 1] = x2.y;
        tg[2 * k] = t2.x;
        tg[2 * k + 1] = t2.y;
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        T xn[kGroup], tn[kGroup], sh[kGroup];
        if (g + 1 < kGroups) {
#pragma unroll
          for (int k = 0; k < kGroup / 2; ++k) {
            const V x2 = xb[kGroup / 2 * (g + 1) + k], t2 = tb[kGroup / 2 * (g + 1) + k];
            xn[2 * k] = x2.x;
            xn[2 * k + 1] = x2.y;
            tn[2 * k] = t2.x;
            tn[2 * k + 1] = t2.y;
          }
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          s = s + xg[k];
          sh[k] = s;
          c = c + tg[k];
        }
#pragma unroll
        for (int k = 0; k < kGroup / 2; ++k) {
          V v2;
          v2.x = sh[2 * k];
          v2.y = sh[2 * k + 1];
          hc[kGroup / 2 * g + k] = v2;
        }
        if (g == 0) tp[lane] = chunk_term(hp, lane, s1, x1, c1);
        if (g + 1 < kGroups) {
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            xg[k] = xn[k];
            tg[k] = tn[k];
          }
        }
      }
    } else {
      if (steps1 > 0) tp[lane] = chunk_term(hp, lane, s1, x1, c1);
      const T* xt = reinterpret_cast<const T*>(xb);
      const T* tt = reinterpret_cast<const T*>(tb);
      T* ht = reinterpret_cast<T*>(hc);
      for (int k = 0; k < 32; ++k) {
        if (k < steps) {
          s = s + xt[k];
          ht[k] = s;
        }
        if (k < steps2) c = c + tt[k];
      }
    }
    __syncwarp();
    steps2 = steps1;
    steps1 = steps;
    x1 = xv;
    c1 = cv;
    s1 = s0;
  }
  cp_async_wait<0>();
  if (nch > 0) {  // the last chunk's terms, then the c chain's last two chunks
    const int64_t i = nch - 1;
    reinterpret_cast<T*>(tbuf[w][i & 1])[lane] =
        chunk_term(reinterpret_cast<const T*>(hist[w][i & 1]), lane, s1, x1, c1);
    __syncwarp();
    const T* t2 = reinterpret_cast<const T*>(tbuf[w][(i + 1) & 1]);
    for (int k = 0; k < steps2; ++k) c = c + t2[k];
    const T* t1 = reinterpret_cast<const T*>(tbuf[w][i & 1]);
    for (int k = 0; k < steps1; ++k) c = c + t1[k];
  }
  if (lane == 0) {
    T r = s + c;
    if (kNorm) r = norm_finish<T>(r, scale_bits[ell], flags[ell]);
    out[ell] = r;
  }
}

// x (L, n): per lane the largest finite |x| as bits, and flags (1 NaN, 2 inf);
// both zeroed before the launch.
template <typename T>
__global__ void __launch_bounds__(kScaleThreads) norm_scale_kernel(
    const T* __restrict__ x, int64_t n, int64_t chunks, typename Ieee<T>::U* __restrict__ bits,
    int* __restrict__ flags) {
  using I = Ieee<T>;
  using U = typename I::U;
  __shared__ U smax[kScaleThreads / 32];
  __shared__ int sflag[kScaleThreads / 32];
  const int64_t ell = blockIdx.x / chunks, ch = blockIdx.x % chunks;
  const int64_t i1 = min(n, (ch + 1) * (int64_t)kScaleChunk);
  const T* xl = x + ell * n;
  U mb = 0;
  int fl = 0;
  for (int64_t i = ch * (int64_t)kScaleChunk + threadIdx.x; i < i1; i += kScaleThreads) {
    const U b = I::bits(__ldg(xl + i)) & ~(U(1) << (8 * sizeof(T) - 1));
    if ((int)(b >> I::kMant) == I::kExpMax) {
      fl |= (b & ((U(1) << I::kMant) - 1)) ? 1 : 2;
    } else {
      mb = b > mb ? b : mb;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const U o = __shfl_down_sync(kFull, mb, off);
    mb = o > mb ? o : mb;
    fl |= __shfl_down_sync(kFull, fl, off);
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) {
    smax[w] = mb;
    sflag[w] = fl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kScaleThreads / 32; ++k) {
      mb = smax[k] > mb ? smax[k] : mb;
      fl |= sflag[k];
    }
    if (mb) atomicMax(bits + ell, mb);
    if (fl) atomicOr(flags + ell, fl);
  }
}

template <typename T>
cudaError_t tree(int kind, const void* x, const void* y, const void* scale_bits, int64_t n,
                 int64_t L, int block, void* sb, void* cb, cudaStream_t s) {
  int P = 1;
  while (P < block) P *= 2;
  const int M = P > kTreePiece ? P / kTreePiece : 1;
  P /= M;
  const int Q = P <= 32 ? 1 : P / 32;
  const int64_t nb = (n + block - 1) / block;
  const int64_t warps = (L * nb + (32 / (P / Q)) - 1) / (32 / (P / Q));
  const int64_t blocks = (warps * 32 + kTreeThreads - 1) / kTreeThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const auto* bt = static_cast<const typename Ieee<T>::U*>(scale_bits);
  T* st = static_cast<T*>(sb);
  T* ct = static_cast<T*>(cb);
#define CARRY_TREE(Q_, K_, B_)                                                                \
  tree_kernel<T, Q_, K_, B_><<<(unsigned)blocks, kTreeThreads, 0, s>>>(xt, yt, bt, n, L, block, \
                                                                      P, M, nb, st, ct)
#define CARRY_TREE_K(Q_, B_)  \
  if (kind == kSum) {         \
    CARRY_TREE(Q_, kSum, B_); \
  } else if (kind == kDot) {  \
    CARRY_TREE(Q_, kDot, B_); \
  } else {                    \
    CARRY_TREE(Q_, kNorm, B_); \
  }
#define CARRY_TREE_Q(Q_)   \
  case Q_:                 \
    CARRY_TREE_K(Q_, false) \
    break;
  if (M > 1) {
    CARRY_TREE_K(kTreePiece / 32, true)
  } else {
    switch (Q) {
      CARRY_TREE_Q(1) CARRY_TREE_Q(2) CARRY_TREE_Q(4) CARRY_TREE_Q(8) CARRY_TREE_Q(16)
      default: return cudaErrorInvalidValue;
    }
  }
#undef CARRY_TREE_Q
#undef CARRY_TREE_K
#undef CARRY_TREE
  return cudaGetLastError();
}

template <typename T>
cudaError_t fold(const void* sb, const void* cb, int64_t nb, int64_t L, const void* scale_bits,
                 const int* flags, void* out, cudaStream_t s) {
  const int64_t blocks = (L + kFoldThreads / 32 - 1) / (kFoldThreads / 32);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const T* st = static_cast<const T*>(sb);
  const T* ct = static_cast<const T*>(cb);
  const auto* bt = static_cast<const typename Ieee<T>::U*>(scale_bits);
  if (scale_bits != nullptr) {
    carry_fold_kernel<T, true><<<(unsigned)blocks, kFoldThreads, 0, s>>>(st, ct, nb, L, bt, flags,
                                                                       static_cast<T*>(out));
  } else {
    carry_fold_kernel<T, false><<<(unsigned)blocks, kFoldThreads, 0, s>>>(st, ct, nb, L, bt, flags,
                                                                        static_cast<T*>(out));
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t norm_scale(const void* x, int64_t n, int64_t L, void* bits, int* flags,
                       cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(bits, 0, sizeof(typename Ieee<T>::U) * L, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(flags, 0, sizeof(int) * L, s);
  if (err != cudaSuccess || n == 0) return err;
  const int64_t chunks = (n + kScaleChunk - 1) / kScaleChunk;
  if (chunks * L > 0x7fffffff) return cudaErrorInvalidValue;
  norm_scale_kernel<T><<<(unsigned)(chunks * L), kScaleThreads, 0, s>>>(
      static_cast<const T*>(x), n, chunks, static_cast<typename Ieee<T>::U*>(bits), flags);
  return cudaGetLastError();
}

}  // namespace carry

// C interface, loaded with ctypes.  Every array is contiguous on the card, of
// float64 (dtype_bytes 8) or float32 (4); the bits of a lane are uint64 or
// uint32 alike.  Each launches on `stream`, never synchronises, and returns the
// first CUDA error (0 on success).

// s_b, c_b (lanes, nb); out (lanes).  With scale_bits and flags (lanes) from
// carry_norm_scale, out is the norm of the lane (the fold of xs * xs).
extern "C" int carry_fold(int device, int dtype_bytes, const void* s_b, const void* c_b,
                          int64_t nb, int64_t lanes, const void* scale_bits, const int* flags,
                          void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 0 || lanes < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (lanes == 0) return cudaSuccess;
  if (dtype_bytes == 8) return carry::fold<double>(s_b, c_b, nb, lanes, scale_bits, flags, out, s);
  if (dtype_bytes == 4) return carry::fold<float>(s_b, c_b, nb, lanes, scale_bits, flags, out, s);
  return cudaErrorInvalidValue;
}

// kind 0 (sum of x), 1 (dot of x and y) or 2 (norm of x, with scale_bits);
// x, y (lanes, n); s_b, c_b (lanes, ceil(n / block)); block in 1 .. 2^30.
extern "C" int carry_tree(int device, int dtype_bytes, int kind, const void* x, const void* y,
                          const void* scale_bits, int64_t n, int64_t lanes, int block, void* s_b,
                          void* c_b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || lanes < 0 || block < 1 || block > carry::kTreeMaxBlock || kind < 0 || kind > 2) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (lanes == 0 || n == 0) return cudaSuccess;
  if (dtype_bytes == 8) {
    return carry::tree<double>(kind, x, y, scale_bits, n, lanes, block, s_b, c_b, s);
  }
  if (dtype_bytes == 4) {
    return carry::tree<float>(kind, x, y, scale_bits, n, lanes, block, s_b, c_b, s);
  }
  return cudaErrorInvalidValue;
}

// x (lanes, n); bits (lanes) uint64 / uint32 and flags (lanes) int32 written.
extern "C" int carry_norm_scale(int device, int dtype_bytes, const void* x, int64_t n,
                                int64_t lanes, void* bits, int* flags, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || lanes < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (lanes == 0) return cudaSuccess;
  if (dtype_bytes == 8) return carry::norm_scale<double>(x, n, lanes, bits, flags, s);
  if (dtype_bytes == 4) return carry::norm_scale<float>(x, n, lanes, bits, flags, s);
  return cudaErrorInvalidValue;
}
