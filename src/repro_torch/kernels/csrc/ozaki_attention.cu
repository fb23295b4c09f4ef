// attention_fused for Hopper (sm_90a): out = softmax(mask(Q K^T / sqrt(D))) V with
// both products rebuilt exactly from int8 residue products (Ozaki-II), in one
// online-softmax sweep over the keys.
//
// Replaces the TPU kernel repro/kernels/ozaki_attention.py::attention_fused (body
// _attn_kernel, pallas_call at line 261).  It computes what that kernel computes,
// not the TPU's blocking: there the grid is (S / bq, T / bkv) with the kv axis
// run in order on one core, the (m, l, acc) state in VMEM scratch between grid
// steps, and batch and heads mapped outside the kernel.
//
// Bound on the H100: the larger of the bytes (the (hi, lo) int32 pairs of q, k
// and v read once, the f64 output written once, at 3.35 TB/s) and the int8
// operations (2 * 2 * S * T * D * r per problem, Q K^T and P V, at 1979 TOPS).
// At 32 problems of 512 x 512, D = 128, r = 15 that is ~0.033 ms of operations
// against ~0.02 ms of bytes.  This first version is far from either: per
// product element it runs an r-digit Garner reconstruction and an exact
// power-of-two unscale in FP64 on the CUDA cores.
//
// Design.  One block of 256 threads per (problem, tile of bq <= 16 q rows); the
// TPU's sequential kv axis is a loop inside the block, and m, l and the f64
// accumulator of the tile stay in shared memory across it, so only out = acc / l
// is stored.  Grid (ceil(S / bq), problems): the batch and heads are a grid axis.
//   0. residue_planes turns the (hi, lo) pairs into int8 residue planes once:
//      q as (B, rq, S, Dp), k as (B, rq, Tq, Dp), v transposed per column as
//      (B, rp, Dp, Tq), zero beyond D, T (Dp = D rounded up to 64, Tq = T
//      rounded up to bkv).  Rebuilding them inside the sweep would cost r * ~20
//      integer operations per element for every q tile that reads them.
//   1. Per kv block and modulus: the q tile's and the k block's residues into
//      shared memory (a k block's residues for all r moduli would need
//      bkv * D * r bytes, 245,760 at 128, 128, 15: more than a block may use),
//      one mma.sync.m16n8k32 s8 product per 16 x 8 output tile and 64-deep step,
//      and the balanced residue of each int32 sum into an int8 plane.
//   2. Garner over the r planes into the same compensated double-double sum as
//      ozaki2.garner_reconstruct, the exact unscale by the q-row and k-row
//      shifts, then 1/sqrt(D), the tanh softcap and the mask, in FP64.
//   3. A warp per row: the row max, exp, the row sum in the pairwise-tree order
//      of _online_update (columns zero-padded to a power of two), l and the
//      correction factor, and p's Phase-1 scaling per row over the block exactly
//      as splitting.scale_to_int does it (floor(log2(absmax)), the frexp-based
//      ldexp, the too_big guard, round-half-even) and its (hi, lo) split.
//   4. Per modulus: p's residues and the block of v's residues into shared
//      memory, the P V products as in 1, then Garner, the unscale by p's row
//      shift and v's (block, column) shift, and acc = acc * corr + pv.
// Every step repeats the plain version's float operations in its order; the
// build passes --fmad=false, and exp, tanh and log2 are the CUDA math library's
// double functions, which PyTorch's CUDA kernels call too.  So the kernel is
// bitwise equal to attention_ref on the same card, for any bq.  A simple kernel
// first: mma.sync from shared memory, no wgmma, no TMA, and fully masked blocks
// are computed like any other.
#include <cmath>

#include "ozaki_common.cuh"

namespace ozaki {

constexpr int kAttnThreads = 256;
constexpr int kAttnRows = 16;      // rows of a block's tile: one m16 MMA tile
constexpr double kNegInf = -1e30;  // kernels/ozaki_attention.py NEG_INF
constexpr double kSplitRadix = 67108864.0;  // 2^26, the (hi, lo) split

// Launch description.  Mirrored by repro_torch.kernels.ozaki_attention.AttnShape.
struct AttnShape {
  int B, S, T, D, Dp, Tq, bq, bkv, bkvp, nblk, rq, rp, payload_pv;
  int64_t mask_sb, mask_ss, mask_st;
  double inv_sqrt_d, softcap, inv_cap, two_pow_payload;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 2^e built from its bit fields (splitting.exact_pow2): exact over the whole
// range, 0 below the smallest denormal, inf above the largest finite power.
__device__ __forceinline__ double exact_pow2(int e) {
  e = e < -1075 ? -1075 : (e > 1024 ? 1024 : e);
  long long bits;
  if (e > -1023) {
    bits = (long long)(e + 1023) << 52;
  } else {
    bits = e < -1074 ? 0LL : (1LL << (e + 1074));
  }
  return __longlong_as_double(bits);
}

// x * 2^n with one rounding (splitting.ldexp): frexp, fold the exponent, one
// multiply by an exact power of two.
__device__ __forceinline__ double ldexp_ref(double x, int n) {
  int e;
  double m = frexp(x, &e);
  e = e + n;
  if (e > 0) {
    m = m * 2.0;
    e = e - 1;
  }
  const double y = m * exact_pow2(e);
  return (isinf(x) || x == 0.0) ? x : y;
}

// The float of the first n <= R digits as ozaki2.garner_reconstruct sums them:
// a compensated double-double Horner whose correction term is comp + (e_sum +
// e_prod).  (common.digits_to_f64 adds the two errors one at a time.)
template <int R>
__device__ __forceinline__ double garner_f64(const int (&t)[R], const GarnerParams& p, int n) {
  const double split = 134217729.0;  // 2^27 + 1
  double out = 0.0, comp = 0.0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (j >= n) break;
    const double tf = (double)t[j];
    const double ph = p.pref_f64[j];
    const double pr = tf * ph;
    const double c1 = split * tf;
    const double tf_h = c1 - (c1 - tf);
    const double tf_l = tf - tf_h;
    const double c2 = split * ph;
    const double ph_h = c2 - (c2 - ph);
    const double ph_l = ph - ph_h;
    double e = ((tf_h * ph_h - pr) + tf_h * ph_l + tf_l * ph_h) + tf_l * ph_l;
    e = e + tf * p.pref_f64_lo[j];
    const double s = out + pr;
    const double v = s - out;
    const double e_sum = (out - (s - v)) + (pr - v);
    comp = comp + (e_sum + e);
    out = s;
  }
  return out + comp;
}

// Garner of one element over the first n <= R moduli, its balanced residues in
// planes of `plane` bytes.  The plan of n moduli is the prefix of the plan of R
// (moduli and Garner constants), and digit j depends on residues 0 .. j only, so
// the first n of R digits are the n-modulus plan's digits.
template <int R>
__device__ __forceinline__ double reconstruct(const int8_t* res, int plane,
                                              const GarnerParams& p, int n) {
  int r[R], t[R];
#pragma unroll
  for (int j = 0; j < R; ++j) r[j] = j < n ? res[j * plane] : 0;
  garner_digits<R>(r, p, t);
  return garner_f64<R>(t, p, n);
}

__device__ __forceinline__ int4 lds16(const int8_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

// out[b][j][x][y] = the balanced residue mod modulus(j) of src[b][row][col],
// with (row, col) = (x, y), or (y, x) when `transpose`; 0 where row >= rows or
// col >= D.  src: (B, rows, D) int32 hi/lo.
template <int R>
__global__ void __launch_bounds__(256) residue_planes(const int* __restrict__ hi,
                                                      const int* __restrict__ lo, int B,
                                                      int rows, int D, int X, int Y,
                                                      int transpose, int8_t* __restrict__ out) {
  const int64_t xy = (int64_t)X * Y, n = (int64_t)B * xy;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = e / xy;
    const int64_t f = e - b * xy;
    const int x = (int)(f / Y), y = (int)(f - (int64_t)x * Y);
    const int row = transpose ? y : x, col = transpose ? x : y;
    int h = 0, l = 0;
    if (row < rows && col < D) {
      const int64_t idx = (b * rows + row) * D + col;
      h = hi[idx];
      l = lo[idx];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) out[(b * R + j) * xy + f] = (int8_t)residue(h, l, modulus(j));
  }
}

// Shared memory of one block, in bytes (attention_kernel carves it in this order).
struct AttnSmem {
  int qs, qsv, nc;                    // row strides of the staged tiles; res plane width
  int acc, sbuf, stats, ints, stage_a, stage_b, res, total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Row strides of 64 mod 128 bytes keep the 16-byte fragment loads free of bank
// conflicts (the eight lanes of a phase read two rows, 64 bytes each).
__host__ __device__ inline int fragment_stride(int width) {
  return width % 128 == 0 ? width + 64 : width;
}

__host__ __device__ inline AttnSmem attn_smem(const AttnShape& sh, int rmax) {
  AttnSmem m;
  m.qs = fragment_stride(sh.Dp);
  m.qsv = fragment_stride(sh.bkvp);
  m.nc = sh.bkv > sh.Dp ? sh.bkv : sh.Dp;
  int off = 0;
  m.acc = off;     off += align16(kAttnRows * sh.Dp * 8);             // acc, f64
  m.sbuf = off;    off += align16(kAttnRows * sh.bkv * 8);            // s, p, then p's (hi, lo)
  m.stats = off;   off += align16(3 * kAttnRows * 8);                 // m, l, corr
  m.ints = off;    off += align16((2 * kAttnRows + sh.bkv + sh.Dp) * 4);  // sq, sp, sk, sv
  m.stage_a = off; off += align16(kAttnRows * (m.qs > m.qsv ? m.qs : m.qsv));
  const int sb_qk = sh.bkv * m.qs, sb_pv = sh.Dp * m.qsv;
  m.stage_b = off; off += align16(sb_qk > sb_pv ? sb_qk : sb_pv);
  m.res = off;     off += align16(rmax * kAttnRows * m.nc);
  m.total = off;
  return m;
}

// One block: q rows row0 .. row0 + bq - 1 of problem blockIdx.y, over all keys.
// R = max(rq, rp): Q K^T runs over sh.rq moduli and P V over sh.rp.
template <int R>
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(
    const int8_t* __restrict__ qres, const int8_t* __restrict__ kres,
    const int8_t* __restrict__ vres, const int* __restrict__ sq, const int* __restrict__ sk,
    const int* __restrict__ sv, const int8_t* __restrict__ mask, double* __restrict__ out,
    const AttnShape sh, const __grid_constant__ GarnerParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const AttnSmem L = attn_smem(sh, R);
  double* acc = reinterpret_cast<double*>(smem + L.acc);
  double* sbuf = reinterpret_cast<double*>(smem + L.sbuf);
  int2* phl = reinterpret_cast<int2*>(smem + L.sbuf);
  double* m_s = reinterpret_cast<double*>(smem + L.stats);
  double* l_s = m_s + kAttnRows;
  double* corr_s = l_s + kAttnRows;
  int* sq_s = reinterpret_cast<int*>(smem + L.ints);
  int* sp_s = sq_s + kAttnRows;
  int* sk_s = sp_s + kAttnRows;
  int* sv_s = sk_s + sh.bkv;
  int8_t* stage_a = reinterpret_cast<int8_t*>(smem + L.stage_a);
  int8_t* stage_b = reinterpret_cast<int8_t*>(smem + L.stage_b);
  int8_t* res = reinterpret_cast<int8_t*>(smem + L.res);
  const int plane = kAttnRows * L.nc;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * sh.bq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int S = sh.S, T = sh.T, D = sh.D, Dp = sh.Dp, bkv = sh.bkv, bkvp = sh.bkvp;

  for (int e = tid; e < kAttnRows * Dp; e += kAttnThreads) acc[e] = 0.0;
  if (tid < kAttnRows) {
    const int grow = row0 + tid;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0;
    sq_s[tid] = (tid < sh.bq && grow < S) ? sq[(int64_t)b * S + grow] : 0;
  }

  // Pairwise-tree row sums: lane l holds columns [l * E, (l + 1) * E) of the
  // block zero-padded to `width`, a power of two (E = 1 below 32 columns; the
  // surplus lanes add zeros, which is exact for p >= 0).
  int width = 1;
  while (width < bkv) width <<= 1;
  const int E = width > 32 ? width / 32 : 1;

  for (int kb = 0; kb < sh.nblk; ++kb) {
    const int t0 = kb * bkv;
    for (int c = tid; c < bkv; c += kAttnThreads) sk_s[c] = sk[(int64_t)b * sh.Tq + t0 + c];
    for (int d = tid; d < Dp; d += kAttnThreads)
      sv_s[d] = d < D ? sv[((int64_t)b * sh.nblk + kb) * D + d] : 0;

    // ---- 1. Q K^T residues, one modulus at a time
#pragma unroll 1
    for (int j = 0; j < sh.rq; ++j) {
      const int mj = p.moduli[j];
      const int cw = Dp / 16;
      const int8_t* qp = qres + ((int64_t)b * sh.rq + j) * S * Dp;
      const int8_t* kp = kres + (((int64_t)b * sh.rq + j) * sh.Tq + t0) * Dp;
      for (int idx = tid; idx < kAttnRows * cw; idx += kAttnThreads) {
        const int r = idx / cw, c = idx - r * cw, grow = row0 + r;
        int4 v = make_int4(0, 0, 0, 0);
        if (r < sh.bq && grow < S) v = __ldg(reinterpret_cast<const int4*>(qp + (int64_t)grow * Dp) + c);
        *reinterpret_cast<int4*>(stage_a + r * L.qs + 16 * c) = v;
      }
      for (int idx = tid; idx < bkv * cw; idx += kAttnThreads) {
        const int r = idx / cw, c = idx - r * cw;
        *reinterpret_cast<int4*>(stage_b + r * L.qs + 16 * c) =
            __ldg(reinterpret_cast<const int4*>(kp + (int64_t)r * Dp) + c);
      }
      __syncthreads();
      for (int nt = warp; nt < bkv / 8; nt += kAttnThreads / 32) {
        int c4[4] = {0, 0, 0, 0};
        for (int k0 = 0; k0 < Dp; k0 += 64) {
          const int4 a0 = lds16(stage_a + g * L.qs + k0 + 16 * t4);
          const int4 a1 = lds16(stage_a + (g + 8) * L.qs + k0 + 16 * t4);
          const int4 bb = lds16(stage_b + (nt * 8 + g) * L.qs + k0 + 16 * t4);
          mma_s8(c4, a0.x, a1.x, a0.y, a1.y, bb.x, bb.y);
          mma_s8(c4, a0.z, a1.z, a0.w, a1.w, bb.z, bb.w);
        }
        int8_t* rp = res + j * plane;
        const int col = nt * 8 + 2 * t4;
        rp[g * bkv + col] = (int8_t)bmod(c4[0], mj);
        rp[g * bkv + col + 1] = (int8_t)bmod(c4[1], mj);
        rp[(g + 8) * bkv + col] = (int8_t)bmod(c4[2], mj);
        rp[(g + 8) * bkv + col + 1] = (int8_t)bmod(c4[3], mj);
      }
      __syncthreads();
    }

    // ---- 2. Garner, unscale, scale, softcap, mask (_masked_scores)
    for (int e = tid; e < kAttnRows * bkv; e += kAttnThreads) {
      const int r = e / bkv, c = e - r * bkv;
      const double s_int = reconstruct<R>(res + e, plane, p, sh.rq);
      double s = ldexp_ref(s_int, -(sq_s[r] + sk_s[c]));
      s = s * sh.inv_sqrt_d;
      if (sh.softcap > 0.0) s = sh.softcap * tanh(s * sh.inv_cap);
      const int grow = row0 + r, t = t0 + c;
      const bool keep = r < sh.bq && grow < S && t < T &&
                        mask[b * sh.mask_sb + grow * sh.mask_ss + t * sh.mask_st] != 0;
      sbuf[e] = keep ? s : kNegInf;
    }
    __syncthreads();

    // ---- 3. Online update (_online_update) and p's Phase 1, a warp per row
    for (int r = warp; r < kAttnRows; r += kAttnThreads / 32) {
      const double* srow = sbuf + r * bkv;
      double x[4];
      double mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane * E + i;
        x[i] = (i < E && c < bkv) ? srow[c] : 0.0;
        if (i < E && c < bkv) mx = fmax(mx, x[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const double m_old = m_s[r];
      const double m_new = m_old < mx ? mx : m_old;
      const double corr = exp(m_old - m_new);
      double am = 0.0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane * E + i;
        x[i] = (i < E && c < bkv) ? exp(x[i] - m_new) : 0.0;
        am = fmax(am, fabs(x[i]));
      }
      double sum = E == 1 ? x[0] : (E == 2 ? x[0] + x[1] : (x[0] + x[1]) + (x[2] + x[3]));
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) sum = sum + __shfl_xor_sync(0xffffffffu, sum, off);
      const double l_new = l_s[r] * corr + sum;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) am = fmax(am, __shfl_xor_sync(0xffffffffu, am, off));
      // splitting.scale_to_int(p, payload_bits, axis=-1), then split_hi_lo
      int shift = (sh.payload_pv - 1) - (int)floor(log2(am > 0.0 ? am : 1.0));
      double big = 0.0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = ldexp_ref(x[i], shift);
        big = fmax(big, fabs(x[i]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) big = fmax(big, __shfl_xor_sync(0xffffffffu, big, off));
      const bool too_big = big >= sh.two_pow_payload;
      if (too_big) shift = shift - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = lane * E + i;
        if (i < E && c < bkv) {
          const double pi = rint(too_big ? x[i] * 0.5 : x[i]);
          const double hi = rint(pi / kSplitRadix);
          const double lo = pi - hi * kSplitRadix;
          phl[r * bkv + c] = make_int2((int)hi, (int)lo);
        }
      }
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_new;
        corr_s[r] = corr;
        sp_s[r] = shift;
      }
    }
    __syncthreads();

    // ---- 4. P V residues, one modulus at a time
#pragma unroll 1
    for (int j = 0; j < sh.rp; ++j) {
      const int mj = p.moduli[j];
      for (int idx = tid; idx < kAttnRows * bkvp; idx += kAttnThreads) {
        const int r = idx / bkvp, c = idx - r * bkvp;
        int v = 0;
        if (c < bkv) {
          const int2 hl = phl[r * bkv + c];
          v = residue(hl.x, hl.y, mj);
        }
        stage_a[r * L.qsv + c] = (int8_t)v;
      }
      const int8_t* vp = vres + ((int64_t)b * sh.rp + j) * Dp * sh.Tq + t0;
      const int cw = bkv / 8, cz = (bkvp - bkv) / 8;
      for (int idx = tid; idx < Dp * cw; idx += kAttnThreads) {
        const int d = idx / cw, c = idx - d * cw;
        *reinterpret_cast<int2*>(stage_b + d * L.qsv + 8 * c) =
            __ldg(reinterpret_cast<const int2*>(vp + (int64_t)d * sh.Tq) + c);
      }
      for (int idx = tid; idx < Dp * cz; idx += kAttnThreads) {
        const int d = idx / cz, c = idx - d * cz;
        *reinterpret_cast<int2*>(stage_b + d * L.qsv + bkv + 8 * c) = make_int2(0, 0);
      }
      __syncthreads();
      for (int nt = warp; nt < Dp / 8; nt += kAttnThreads / 32) {
        int c4[4] = {0, 0, 0, 0};
        for (int k0 = 0; k0 < bkvp; k0 += 64) {
          const int4 a0 = lds16(stage_a + g * L.qsv + k0 + 16 * t4);
          const int4 a1 = lds16(stage_a + (g + 8) * L.qsv + k0 + 16 * t4);
          const int4 bb = lds16(stage_b + (nt * 8 + g) * L.qsv + k0 + 16 * t4);
          mma_s8(c4, a0.x, a1.x, a0.y, a1.y, bb.x, bb.y);
          mma_s8(c4, a0.z, a1.z, a0.w, a1.w, bb.z, bb.w);
        }
        int8_t* rp = res + j * plane;
        const int col = nt * 8 + 2 * t4;
        rp[g * Dp + col] = (int8_t)bmod(c4[0], mj);
        rp[g * Dp + col + 1] = (int8_t)bmod(c4[1], mj);
        rp[(g + 8) * Dp + col] = (int8_t)bmod(c4[2], mj);
        rp[(g + 8) * Dp + col + 1] = (int8_t)bmod(c4[3], mj);
      }
      __syncthreads();
    }

    // ---- 5. Garner, unscale, acc = acc * corr + pv
    for (int e = tid; e < kAttnRows * Dp; e += kAttnThreads) {
      const int r = e / Dp, d = e - r * Dp;
      const double pv_int = reconstruct<R>(res + e, plane, p, sh.rp);
      const double pv = ldexp_ref(pv_int, -(sp_s[r] + sv_s[d]));
      acc[e] = acc[e] * corr_s[r] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < kAttnRows * Dp; e += kAttnThreads) {
    const int r = e / Dp, d = e - r * Dp, grow = row0 + r;
    if (r < sh.bq && grow < S && d < D) out[((int64_t)b * S + grow) * D + d] = acc[e] / l_s[r];
  }
}

inline unsigned grid_for(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  return (unsigned)(blocks < 1 ? 1 : (blocks > (1 << 30) ? (1 << 30) : blocks));
}

inline cudaError_t launch_planes(int r, const int* hi, const int* lo, int B, int rows, int D,
                                 int X, int Y, int transpose, int8_t* out, cudaStream_t s) {
  const unsigned grid = grid_for((int64_t)B * X * Y, 256);
  switch (r) {
#define OZAKI_CASE(R_)                                                                 \
  case R_:                                                                             \
    residue_planes<R_><<<grid, 256, 0, s>>>(hi, lo, B, rows, D, X, Y, transpose, out); \
    break;
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_attention(const int8_t* qres, const int8_t* kres, const int8_t* vres,
                             const int* sq, const int* sk, const int* sv, const int8_t* mask,
                             double* out, const AttnShape& sh, const GarnerParams& p,
                             cudaStream_t s) {
  const int bytes = attn_smem(sh, R).total;
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.S + sh.bq - 1) / sh.bq, sh.B);
  attention_kernel<R><<<grid, kAttnThreads, bytes, s>>>(qres, kres, vres, sq, sk, sv, mask, out,
                                                        sh, p);
  return cudaGetLastError();
}

}  // namespace ozaki

using ozaki::AttnShape;
using ozaki::GarnerParams;

// C interface, loaded with ctypes.  q_hi/q_lo (B, S, D), k_hi/k_lo (B, T, D),
// v_hi/v_lo (B, Tq, D) int32, contiguous, from the Phase-1 scaling; sq (B, S),
// sk (B, Tq), sv (B, nblk, D) int32 shifts; mask int8 with element strides
// (mask_sb, mask_ss, mask_st) over (B, S, T), nonzero = attend.  Scratch from
// the caller: qres (B, rq, S, Dp), kres (B, rq, Tq, Dp), vres (B, rp, Dp, Tq)
// int8.  out: f64 (B, S, D).  `params` holds the Garner constants of the plan
// with more moduli (those of the other are its prefix).  rp in 1..20 and
// |rq - rp| <= 1, 1 <= bq <= 16, bkv % 8 == 0, bkv <= 128, D <= 256, B <= 65535.
// Launches on `stream`, never synchronises, returns the first CUDA error (0 on
// success).
extern "C" int ozaki_attention_fused(int device, const int* q_hi, const int* q_lo,
                                     const int* k_hi, const int* k_lo, const int* v_hi,
                                     const int* v_lo, const int* sq, const int* sk,
                                     const int* sv, const int8_t* mask, void* out,
                                     int8_t* qres, int8_t* kres, int8_t* vres,
                                     const AttnShape* shape, const GarnerParams* params,
                                     void* stream) {
  const AttnShape& sh = *shape;
  const GarnerParams& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.bq < 1 || sh.bq > ozaki::kAttnRows || sh.bkv < 8 || sh.bkv % 8 || sh.bkv > 128 ||
      sh.D < 1 || sh.D > 256 || sh.B > 65535 || sh.rq - sh.rp > 1 || sh.rp - sh.rq > 1 ||
      p.r != (sh.rq > sh.rp ? sh.rq : sh.rp)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (sh.B == 0 || sh.S == 0) return cudaSuccess;
  err = ozaki::launch_planes(sh.rq, q_hi, q_lo, sh.B, sh.S, sh.D, sh.S, sh.Dp, 0, qres, s);
  if (err != cudaSuccess) return err;
  err = ozaki::launch_planes(sh.rq, k_hi, k_lo, sh.B, sh.T, sh.D, sh.Tq, sh.Dp, 0, kres, s);
  if (err != cudaSuccess) return err;
  err = ozaki::launch_planes(sh.rp, v_hi, v_lo, sh.B, sh.Tq, sh.D, sh.Dp, sh.Tq, 1, vres, s);
  if (err != cudaSuccess) return err;
  double* o = static_cast<double*>(out);
  switch (p.r) {
#define OZAKI_CASE(R_) \
  case R_:             \
    return ozaki::launch_attention<R_>(qres, kres, vres, sq, sk, sv, mask, o, sh, p, s);
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
}
