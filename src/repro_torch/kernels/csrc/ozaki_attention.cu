// attention_fused for Hopper (sm_90a): out = softmax(mask(Q K^T / sqrt(D))) V with
// both products rebuilt exactly from int8 residue products (Ozaki-II).
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
// At 32 problems of 512 x 512, D = 128, r = 15 that is ~0.033 ms of operations;
// at decode, 64 x 1 x 4096, ~0.16 ms of bytes.  What the kernel spends its time
// on is CUDA-core work per product element: an r-digit Garner reconstruction
// and an exact power-of-two unscale in FP64, and the residues of k and v.
//
// Residue planes (the one-pass sweep).  planes_rows turns q and k into
// int8 planes (B, r, rows, Dp), zero beyond D and T (Dp = D rounded up to 64);
// planes_cols turns v into planes transposed per column, (B, r, Dp, Tq) (Tq =
// T rounded up to bkv), through a 32 x 32 shared-memory tile, so that both its
// reads of the (hi, lo) pairs and its writes are coalesced; the residues come
// from residue_f64.  At causal prefill 32 x 512 x 512 k's and v's planes are
// 2 * 32 * 15 * 512 * 128 B = 63 MB, written and read once more beside the 34 MB
// of (hi, lo) pairs, and each k block is then read by 16 q tiles, which is why
// they are made once and not per tile.  At decode (S = 1) every key is read
// once, and the row path below makes no planes: 64 x 1 x 4096 reads k's and
// v's 0.537 GB of (hi, lo) pairs once, where planes would add 1.007 GB written
// and read again.
//
// A tile is bq <= 32 q rows of one problem (one or two m16 MMA tiles, 512
// threads).  Its steps for one key block kb of bkv keys:
//   1. Q K^T: per modulus, the q tile's and the k block's residues are staged in
//      shared memory by cp.async, double-buffered (the next modulus's copies are
//      in flight during this one's products), multiplied by mma.sync.m16n8k32 s8
//      (one B fragment serves both m16 tiles), and the balanced residue of each
//      int32 sum kept as int8.
//   2. On the tile's real rows only (r < bq, row0 + r < S): Garner (the
//      lazy-carry digits, equal to garner_digits'), the compensated sum as
//      ozaki2.garner_reconstruct does it, the exact unscale by the q-row and
//      k-row shifts, 1/sqrt(D), the tanh softcap and the mask.
//   3. A warp per real row: the row max, exp, the row sum in the pairwise-tree
//      order of _online_update (columns zero-padded to a power of two), and p's
//      Phase-1 scaling per row exactly as splitting.scale_to_int does it
//      (floor(log2(absmax)), the frexp-based ldexp, the too_big guard,
//      round-half-even) and its (hi, lo) split.
//   4. P V: per modulus, p's residues and the block of v's residues staged as in
//      1 (v's by cp.async, double-buffered), the products, then Garner and the
//      unscale by p's row shift and v's (block, column) shift on real rows.
// Skipping, exactly.  A key block with no unmasked key for any real row of the
// tile has s = NEG_INF everywhere, whatever the products are, so steps 1-2 are
// replaced by that fill.  If then every real row's running max m is above
// NEG_INF (a row that has seen a real key), exp(NEG_INF - m) is 0, so p = 0,
// its row sum is 0, corr = exp(m - m) = 1 and P V is +0.0 in every element: the
// products of step 4 are skipped and acc = acc * 1 + 0.0 is applied as the plain
// version does.  A row that has not yet seen a real key accumulates p = 1 over
// masked keys, which a later corr = 0 erases: such blocks are not skipped.
//
// Two paths over the key axis, all the plain version's operations in order:
//   one-pass  grid (ceil(S / bq), problems), every S > 1 (prefill): each tile
//             sweeps its key blocks in order, m, l and the f64 accumulator in
//             shared memory, only out = acc / l stored.
//   row       one query row (S = 1, every decode step): the key axis split
//             across blocks, grid (nblk, problems), in three launches.  In
//             attention_ref a block's scores depend only on q and k, and the
//             running max after block j is the prefix max M_j of the block
//             maxima, so given M_j a block's p, row sum, p's Phase 1 and P V no
//             longer depend on the other blocks:
//             scores  per (block, problem) the scores and the block max;
//             pv      M_{j-1} and M_j from the block maxima, then step 3 and
//                     P V -> the row sum and P V per block;
//             combine per (problem, column), in block order, corr =
//                     exp(M_{j-1} - M_j), l = l * corr + sum_j, acc = acc * corr
//                     + pv_j, and out = acc / l, with M_{-1} = NEG_INF: the
//                     recurrence of the plain version, element for element.
//             No MMA (a 16-row tile would be 15 rows of padding) and no
//             residues of k or v.  As in the SpMV, sum_d res(q_d) res(k_td) is
//             congruent to (2^26 mod m) H + L with H = sum_d res(q_d) hi_td,
//             L = sum_d res(q_d) lo_td, summed in int64 from k's (hi, lo) words
//             against q's residue table; a thread per key for Q K^T, a thread
//             per column for P V against p's residue table.  The balanced
//             residues are those of the products.  64 x 1 x 4096 is 2,048
//             blocks, where the one-pass grid has 64.
// At S > 1 the one-pass grid already has ceil(S / bq) * B tiles: 512 at the
// served causal prefill (32 x 512 x 512), and the batcher's prompts fit one key
// block, so the key axis is not split there.
// Every step repeats the plain version's float operations in its order; the
// build passes --fmad=false, and exp, tanh and log2 are the CUDA math library's
// double functions, which PyTorch's CUDA kernels call too.  So every path is
// bitwise equal to attention_ref on the same card, for any bq.
#include <cmath>

#include "ozaki_common.cuh"

namespace ozaki {

constexpr int kAttnThreads = 512;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kAttnMaxRows = 32;   // rows of a tile: two m16 MMA tiles
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr double kNegInf = -1e30;  // kernels/ozaki_attention.py NEG_INF

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
  garner_digits_lazy<R>(r, p, t);
  return garner_f64<R>(t, p, n);
}

__device__ __forceinline__ int4 lds16(const int8_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

// ---------------------------------------------------------------------------
// Residue planes
// ---------------------------------------------------------------------------

// The residues of four (hi, lo) pairs mod m as four int8 in one word.
__device__ __forceinline__ unsigned pack_residues(const double (&h)[4], const double (&l)[4],
                                                  int m) {
  return (unsigned)(residue_f64(h[0], l[0], m) & 0xff) |
         (unsigned)(residue_f64(h[1], l[1], m) & 0xff) << 8 |
         (unsigned)(residue_f64(h[2], l[2], m) & 0xff) << 16 |
         (unsigned)(residue_f64(h[3], l[3], m) & 0xff) << 24;
}

// out[b][j][x][y] = the balanced residue mod modulus(j) of src[b][x][y] for
// x < rows, y < D, else 0; X rows of Y (a multiple of 4) columns.  A thread
// makes 4 consecutive columns: coalesced reads, one 4-byte write per modulus.
// The residues go through residue_f64 (five FP64 operations each).
template <int R>
__global__ void __launch_bounds__(256) planes_rows(const int* __restrict__ hi,
                                                   const int* __restrict__ lo, int B, int rows,
                                                   int D, int X, int Y,
                                                   int8_t* __restrict__ out) {
  const int yq = Y / 4;
  const int64_t per = (int64_t)X * yq, n = (int64_t)B * per;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = e / per;
    const int64_t f = e - b * per;
    const int x = (int)(f / yq), y0 = (int)(f - (int64_t)x * yq) * 4;
    double h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool ok = x < rows && y0 + k < D;
      const int64_t idx = (b * rows + x) * D + y0 + k;
      h[k] = ok ? hi[idx] : 0;
      l[k] = ok ? lo[idx] : 0;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      *reinterpret_cast<unsigned*>(out + ((b * R + j) * X + x) * (int64_t)Y + y0) =
          pack_residues(h, l, modulus(j));
    }
  }
}

// out[b][j][d][t] = the balanced residue mod modulus(j) of src[b][t][d] for
// d < D (0 beyond, up to Dp), t < rows; src (B, rows, D) with rows a multiple of
// 4.  One block per 32 x 32 tile (grid ceil(rows / 32), Dp / 32, B): the pairs
// are read along d into shared memory, then each thread makes the residues of 4
// consecutive t of one d and writes them as one word per modulus, a warp
// covering 4 rows of 32 bytes.
template <int R>
__global__ void __launch_bounds__(256) planes_cols(const int* __restrict__ hi,
                                                   const int* __restrict__ lo, int rows, int D,
                                                   int Dp, int8_t* __restrict__ out) {
  __shared__ int sh[32][33], sl[32][33];
  const int t0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 31;
  for (int i = tid >> 5; i < 32; i += 8) {
    const int t = t0 + i, d = d0 + tx;
    const bool ok = t < rows && d < D;
    const int64_t idx = (b * rows + t) * D + d;
    sh[i][tx] = ok ? hi[idx] : 0;
    sl[i][tx] = ok ? lo[idx] : 0;
  }
  __syncthreads();
  const int dd = tid >> 3, tg = 4 * (tid & 7);
  if (t0 + tg >= rows) return;
  double h[4], l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h[k] = sh[tg + k][dd];
    l[k] = sl[tg + k][dd];
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    *reinterpret_cast<unsigned*>(out + ((b * R + j) * Dp + d0 + dd) * (int64_t)rows + t0 + tg) =
        pack_residues(h, l, modulus(j));
  }
}

// ---------------------------------------------------------------------------
// A tile's shared memory and steps
// ---------------------------------------------------------------------------

// Shared memory of one block, in bytes, carved in this order.  Mirrored by
// the host's choice of rows and buffers (attn_layout).
struct AttnSmem {
  int rows, nbuf;                     // tile rows (16 or 32); staging buffers (1 or 2)
  int qs, qsv, nc, sa, sb;            // row strides; res plane width; one stage buffer
  int acc, sbuf, stats, ints, stage_a, stage_b, res, total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Row strides of 64 mod 128 bytes keep the 16-byte fragment loads free of bank
// conflicts (the eight lanes of a phase read two rows, 64 bytes each).
__host__ __device__ inline int fragment_stride(int width) {
  return width % 128 == 0 ? width + 64 : width;
}

inline AttnSmem attn_smem(const AttnShape& sh, int rows, int rmax, int nbuf) {
  AttnSmem m;
  m.rows = rows;
  m.nbuf = nbuf;
  m.qs = fragment_stride(sh.Dp);
  m.qsv = fragment_stride(sh.bkvp);
  m.nc = sh.bkv > sh.Dp ? sh.bkv : sh.Dp;
  m.sa = align16(rows * (m.qs > m.qsv ? m.qs : m.qsv));
  const int sb_qk = sh.bkv * m.qs, sb_pv = sh.Dp * m.qsv;
  m.sb = align16(sb_qk > sb_pv ? sb_qk : sb_pv);
  int off = 0;
  m.acc = off;     off += align16(rows * sh.Dp * 8);     // acc, f64
  m.sbuf = off;    off += align16(rows * sh.bkv * 8);     // s, then p's integers
  m.stats = off;   off += align16(4 * rows * 8);          // m, l, corr, row sum
  m.ints = off;    off += align16((2 * rows + sh.bkv + sh.Dp) * 4);  // sq, sp, sk, sv
  m.stage_a = off; off += nbuf * m.sa;
  m.stage_b = off; off += nbuf * m.sb;
  m.res = off;     off += align16(rmax * rows * m.nc);
  m.total = off;
  return m;
}

// The layout for bq rows: double-buffered where it fits, else single; total 0
// if neither fits.
inline AttnSmem attn_layout(const AttnShape& sh, int rmax) {
  const int rows = sh.bq > 16 ? 32 : 16;
  for (int nbuf = 2; nbuf >= 1; --nbuf) {
    const AttnSmem m = attn_smem(sh, rows, rmax, nbuf);
    if (m.total <= kSmemLimit) return m;
  }
  AttnSmem none = attn_smem(sh, rows, rmax, 1);
  none.total = 0;
  return none;
}

struct TileMem {
  double *acc, *sbuf, *m_s, *l_s, *corr_s, *sum_s;
  int *sq_s, *sp_s, *sk_s, *sv_s;
  int8_t *stage_a, *stage_b, *res;
};

__device__ __forceinline__ TileMem carve(unsigned char* smem, const AttnSmem& L,
                                         const AttnShape& sh) {
  TileMem t;
  t.acc = reinterpret_cast<double*>(smem + L.acc);
  t.sbuf = reinterpret_cast<double*>(smem + L.sbuf);
  t.m_s = reinterpret_cast<double*>(smem + L.stats);
  t.l_s = t.m_s + L.rows;
  t.corr_s = t.l_s + L.rows;
  t.sum_s = t.corr_s + L.rows;
  t.sq_s = reinterpret_cast<int*>(smem + L.ints);
  t.sp_s = t.sq_s + L.rows;
  t.sk_s = t.sp_s + L.rows;
  t.sv_s = t.sk_s + sh.bkv;
  t.stage_a = reinterpret_cast<int8_t*>(smem + L.stage_a);
  t.stage_b = reinterpret_cast<int8_t*>(smem + L.stage_b);
  t.res = reinterpret_cast<int8_t*>(smem + L.res);
  return t;
}

// Where a tile is: problem b, rows row0 .. row0 + nreal - 1 real.
struct TilePos {
  int b, row0, nreal;
};

__device__ __forceinline__ TilePos tile_pos(const AttnShape& sh, int tile, int b) {
  TilePos t;
  t.b = b;
  t.row0 = tile * sh.bq;
  const int left = sh.S - t.row0;
  t.nreal = left < sh.bq ? left : sh.bq;
  return t;
}

__device__ __forceinline__ bool kept(const int8_t* mask, const AttnShape& sh, const TilePos& tp,
                                     int r, int t) {
  return t < sh.T &&
         mask[tp.b * sh.mask_sb + (int64_t)(tp.row0 + r) * sh.mask_ss + t * sh.mask_st] != 0;
}

// Does any real row of the tile attend to a key of block kb?  (A barrier.)
__device__ __forceinline__ bool block_has_key(const int8_t* mask, const AttnShape& sh,
                                              const TilePos& tp, int t0) {
  int any = 0;
  for (int e = threadIdx.x; e < tp.nreal * sh.bkv && !any; e += kAttnThreads) {
    const int r = e / sh.bkv;
    if (kept(mask, sh, tp, r, t0 + e - r * sh.bkv)) any = 1;
  }
  return __syncthreads_or(any) != 0;
}

// The residues of the tile's int32 products, one modulus j < n at a time:
// stage(j, buf) starts the copies of modulus j into stage buffer buf (and
// commits them); mma(j, buf) multiplies them into res plane j.  With two
// buffers, one barrier per modulus: after it, modulus j is staged for every
// thread and every thread is done with j - 1's buffer, which then receives
// j + 1's copies while j is multiplied.  With one buffer, a second barrier
// before each refill.  Ends with a barrier.
template <typename Stage, typename Mma>
__device__ __forceinline__ void staged_moduli(const AttnSmem& L, int n, Stage stage, Mma mma) {
  stage(0, 0);
  for (int j = 0; j < n; ++j) {
    const int buf = L.nbuf == 2 ? (j & 1) : 0;
    cp_async_wait<0>();
    __syncthreads();
    if (L.nbuf == 2 && j + 1 < n) stage(j + 1, buf ^ 1);
    mma(j, buf);
    if (L.nbuf == 1 && j + 1 < n) {
      __syncthreads();
      stage(j + 1, 0);
    }
  }
  __syncthreads();
}

// Products of the staged A (rows x width, stride sa_stride) and B (ntiles * 8
// rows x width, stride sb_stride) for modulus j, each int32 sum reduced to its
// balanced residue into res plane j (row stride `cols`).  Warps take 8-column
// tiles; each loads a B fragment once for both m16 tiles.
__device__ __forceinline__ void tile_mma(const int8_t* sa, int sa_stride, const int8_t* sb,
                                         int sb_stride, int width, int ntiles, int mtiles,
                                         const ModRT& M, int8_t* rp, int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  for (int nt = threadIdx.x >> 5; nt < ntiles; nt += kAttnWarps) {
    int c4[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    for (int k0 = 0; k0 < width; k0 += 64) {
      const int4 bb = lds16(sb + (nt * 8 + g) * sb_stride + k0 + 16 * t4);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < mtiles) {
          const int4 a0 = lds16(sa + (mt * 16 + g) * sa_stride + k0 + 16 * t4);
          const int4 a1 = lds16(sa + (mt * 16 + g + 8) * sa_stride + k0 + 16 * t4);
          mma_s8(c4[mt], a0.x, a1.x, a0.y, a1.y, bb.x, bb.y);
          mma_s8(c4[mt], a0.z, a1.z, a0.w, a1.w, bb.z, bb.w);
        }
      }
    }
    const int col = nt * 8 + 2 * t4;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt < mtiles) {
        const int r = mt * 16 + g;
        rp[r * cols + col] = (int8_t)bmod_rt(c4[mt][0], M);
        rp[r * cols + col + 1] = (int8_t)bmod_rt(c4[mt][1], M);
        rp[(r + 8) * cols + col] = (int8_t)bmod_rt(c4[mt][2], M);
        rp[(r + 8) * cols + col + 1] = (int8_t)bmod_rt(c4[mt][3], M);
      }
    }
  }
}

// Steps 1-2: the scores of key block kb into sbuf (real rows; row stride bkv).
// sq_s and sk_s must be loaded.  Ends with a barrier.
template <int R>
__device__ void tile_scores(const TileMem& tm, const AttnSmem& L, const AttnShape& sh,
                            const TilePos& tp, int kb, const int8_t* __restrict__ qres,
                            const int8_t* __restrict__ kres, const int8_t* __restrict__ mask,
                            const GarnerParams& p) {
  const int t0 = kb * sh.bkv, bkv = sh.bkv, tid = threadIdx.x;
  if (!block_has_key(mask, sh, tp, t0)) {           // s = NEG_INF whatever the products
    for (int e = tid; e < tp.nreal * bkv; e += kAttnThreads) tm.sbuf[e] = kNegInf;
    __syncthreads();
    return;
  }
  const int cw = sh.Dp / 16, plane = L.rows * L.nc;
  auto stage = [&](int j, int buf) {
    const int8_t* qp = qres + ((int64_t)tp.b * sh.rq + j) * sh.S * sh.Dp;
    const int8_t* kp = kres + (((int64_t)tp.b * sh.rq + j) * sh.Tq + t0) * sh.Dp;
    int8_t* sa = tm.stage_a + buf * L.sa;
    int8_t* sb = tm.stage_b + buf * L.sb;
    for (int idx = tid; idx < L.rows * cw; idx += kAttnThreads) {
      const int r = idx / cw, c = idx - r * cw;
      const bool ok = r < tp.nreal;
      cp_async16(sa + r * L.qs + 16 * c, qp + (int64_t)(ok ? tp.row0 + r : tp.row0) * sh.Dp + 16 * c,
                 ok ? 16 : 0);
    }
    for (int idx = tid; idx < bkv * cw; idx += kAttnThreads) {
      const int r = idx / cw, c = idx - r * cw;
      cp_async16(sb + r * L.qs + 16 * c, kp + (int64_t)r * sh.Dp + 16 * c, 16);
    }
    cp_async_commit();
  };
  auto mma = [&](int j, int buf) {
    tile_mma(tm.stage_a + buf * L.sa, L.qs, tm.stage_b + buf * L.sb, L.qs, sh.Dp, bkv / 8,
             L.rows / 16, mod_rt(j), tm.res + j * plane, bkv);
  };
  staged_moduli(L, sh.rq, stage, mma);

  for (int e = tid; e < tp.nreal * bkv; e += kAttnThreads) {
    const int r = e / bkv, c = e - r * bkv;
    const double s_int = reconstruct<R>(tm.res + e, plane, p, sh.rq);
    double s = ldexp_ref(s_int, -(tm.sq_s[r] + tm.sk_s[c]));
    s = s * sh.inv_sqrt_d;
    if (sh.softcap > 0.0) s = sh.softcap * tanh(s * sh.inv_cap);
    tm.sbuf[e] = kept(mask, sh, tp, r, t0 + c) ? s : kNegInf;
  }
  __syncthreads();
}

// Step 3 for the real rows, a warp per row (_online_update and p's Phase 1):
// from m_s (the running max before the block) and l_s, writes m_s = m_new,
// l_s = l * corr + sum, corr_s, sum_s, sp_s (p's row shift) and p's scaled
// integers over sbuf.  Returns, after a barrier, whether some real row has p != 0
// somewhere (false: every row has m > NEG_INF and a block max of NEG_INF, so
// p = 0 and P V = +0.0).
__device__ bool tile_softmax(const TileMem& tm, const AttnShape& sh, const TilePos& tp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, bkv = sh.bkv;
  // Pairwise-tree row sums: lane l holds columns [l * E, (l + 1) * E) of the
  // block zero-padded to `width`, a power of two (E = 1 below 32 columns; the
  // surplus lanes add zeros, which is exact for p >= 0).
  int width = 1;
  while (width < bkv) width <<= 1;
  const int E = width > 32 ? width / 32 : 1;
  int dense = 0;
  for (int r = warp; r < tp.nreal; r += kAttnWarps) {
    const double* srow = tm.sbuf + r * bkv;
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
    const double m_old = tm.m_s[r];
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
    const double l_new = tm.l_s[r] * corr + sum;
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
        // p's integer pi = hi * 2^26 + lo exactly (split_hi_lo), |pi| < 2^53: its
        // residues are those of the (hi, lo) pair, so pi is kept whole.
        tm.sbuf[r * bkv + c] = rint(too_big ? x[i] * 0.5 : x[i]);
      }
    }
    if (lane == 0) {
      tm.m_s[r] = m_new;
      tm.l_s[r] = l_new;
      tm.corr_s[r] = corr;
      tm.sum_s[r] = sum;
      tm.sp_s[r] = shift;
      if (!(m_old > kNegInf && mx <= kNegInf)) dense = 1;
    }
  }
  return __syncthreads_or(dense) != 0;
}

// Step 4's products: the residues of P V for block kb into the res planes (row
// stride Dp).  sbuf holds p's scaled integers.  Ends with a barrier.
template <int R>
__device__ void tile_pv(const TileMem& tm, const AttnSmem& L, const AttnShape& sh,
                        const TilePos& tp, int kb, const int8_t* __restrict__ vres,
                        const GarnerParams& p) {
  const int t0 = kb * sh.bkv, bkv = sh.bkv, bkvp = sh.bkvp, tid = threadIdx.x;
  const int plane = L.rows * L.nc, cw = bkv / 8, cz = (bkvp - bkv) / 8;
  auto stage = [&](int j, int buf) {
    const int8_t* vp = vres + ((int64_t)tp.b * sh.rp + j) * sh.Dp * sh.Tq + t0;
    int8_t* sb = tm.stage_b + buf * L.sb;
    for (int idx = tid; idx < sh.Dp * cw; idx += kAttnThreads) {
      const int d = idx / cw, c = idx - d * cw;
      cp_async8(sb + d * L.qsv + 8 * c, vp + (int64_t)d * sh.Tq + 8 * c);
    }
    cp_async_commit();
    for (int idx = tid; idx < sh.Dp * cz; idx += kAttnThreads) {
      const int d = idx / cz, c = idx - d * cz;
      *reinterpret_cast<int2*>(sb + d * L.qsv + bkv + 8 * c) = make_int2(0, 0);
    }
    const ModRT M = mod_rt(j);
    int8_t* sa = tm.stage_a + buf * L.sa;
    for (int idx = tid; idx < L.rows * bkvp; idx += kAttnThreads) {
      const int r = idx / bkvp, c = idx - r * bkvp;
      int v = 0;
      if (r < tp.nreal && c < bkv) v = bmod_f64(tm.sbuf[r * bkv + c], M.m, M.inv, M.half_hi,
                                                  M.half_lo);
      sa[r * L.qsv + c] = (int8_t)v;
    }
  };
  auto mma = [&](int j, int buf) {
    tile_mma(tm.stage_a + buf * L.sa, L.qsv, tm.stage_b + buf * L.sb, L.qsv, bkvp, sh.Dp / 8,
             L.rows / 16, mod_rt(j), tm.res + j * plane, sh.Dp);
  };
  staged_moduli(L, sh.rp, stage, mma);
}

// P V of element (r, d) from the res planes: Garner and the unscale.
template <int R>
__device__ __forceinline__ double tile_pv_value(const TileMem& tm, const AttnSmem& L,
                                                const AttnShape& sh, int r, int d,
                                                const GarnerParams& p) {
  const double pv_int = reconstruct<R>(tm.res + r * sh.Dp + d, L.rows * L.nc, p, sh.rp);
  return ldexp_ref(pv_int, -(tm.sp_s[r] + tm.sv_s[d]));
}

// The key and value shifts of block kb: sk (B, Tq), sv (B, nblk, D).
__device__ __forceinline__ void load_block_shifts(const TileMem& tm, const AttnShape& sh, int b,
                                                  int kb, const int* __restrict__ sk,
                                                  const int* __restrict__ sv) {
  for (int c = threadIdx.x; c < sh.bkv; c += kAttnThreads)
    tm.sk_s[c] = sk[(int64_t)b * sh.Tq + kb * sh.bkv + c];
  for (int d = threadIdx.x; d < sh.Dp; d += kAttnThreads)
    tm.sv_s[d] = d < sh.D ? sv[((int64_t)b * sh.nblk + kb) * sh.D + d] : 0;
}

// ---------------------------------------------------------------------------
// The one-pass sweep: grid (ceil(S / bq), B), all key blocks in order
// ---------------------------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kAttnThreads) attention_sweep(
    const int8_t* __restrict__ qres, const int8_t* __restrict__ kres,
    const int8_t* __restrict__ vres, const int* __restrict__ sq, const int* __restrict__ sk,
    const int* __restrict__ sv, const int8_t* __restrict__ mask, double* __restrict__ out,
    const AttnShape sh, const AttnSmem L, const __grid_constant__ GarnerParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileMem tm = carve(smem, L, sh);
  // the last tiles first: under a causal mask they sweep the most key blocks
  const TilePos tp = tile_pos(sh, gridDim.x - 1 - blockIdx.x, blockIdx.y);
  const int tid = threadIdx.x, Dp = sh.Dp;

  for (int e = tid; e < L.rows * Dp; e += kAttnThreads) tm.acc[e] = 0.0;
  if (tid < L.rows) {
    tm.m_s[tid] = kNegInf;
    tm.l_s[tid] = 0.0;
    tm.sq_s[tid] = tid < tp.nreal ? sq[(int64_t)tp.b * sh.S + tp.row0 + tid] : 0;
  }
  for (int kb = 0; kb < sh.nblk; ++kb) {
    load_block_shifts(tm, sh, tp.b, kb, sk, sv);
    __syncthreads();
    tile_scores<R>(tm, L, sh, tp, kb, qres, kres, mask, p);
    const bool dense = tile_softmax(tm, sh, tp);
    if (dense) tile_pv<R>(tm, L, sh, tp, kb, vres, p);
    // acc = acc * corr + pv; pv = +0.0 exactly where the products were skipped
    for (int e = tid; e < tp.nreal * Dp; e += kAttnThreads) {
      const int r = e / Dp, d = e - r * Dp;
      const double pv = dense ? tile_pv_value<R>(tm, L, sh, r, d, p) : 0.0;
      tm.acc[e] = tm.acc[e] * tm.corr_s[r] + pv;
    }
    __syncthreads();
  }
  for (int e = tid; e < tp.nreal * Dp; e += kAttnThreads) {
    const int r = e / Dp, d = e - r * Dp;
    if (d < sh.D) out[((int64_t)tp.b * sh.S + tp.row0 + r) * sh.D + d] = tm.acc[e] / tm.l_s[r];
  }
}

// ---------------------------------------------------------------------------
// The row path (S = 1, decode): grid (nblk, B) for scores and pv, then combine
// ---------------------------------------------------------------------------

// out[b][d] by the plain version's recurrence over the blocks, one thread per
// (problem, column).
__global__ void __launch_bounds__(256) attention_combine(const double* __restrict__ pv,
                                                         const double* __restrict__ stats,
                                                         double* __restrict__ out, int64_t rows,
                                                         int nblk, int D) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < rows * D;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = e / D;
    const int d = (int)(e - row * D);
    const double* st = stats + row * nblk * 2;
    double m = kNegInf, l = 0.0, acc = 0.0;
    for (int kb = 0; kb < nblk; ++kb) {
      const double mx = st[2 * kb];
      const double m_new = m < mx ? mx : m;
      const double corr = exp(m - m_new);
      l = l * corr + st[2 * kb + 1];
      acc = acc * corr + pv[(row * nblk + kb) * D + d];
      m = m_new;
    }
    out[e] = acc / l;
  }
}

constexpr int kRowThreads = 256;  // >= bkv (keys) and >= D (columns)

// Scores of block kb for the one query row of problem b: a thread per key sums
// its row of k's (hi, lo) words against q's residue table (accumulate_row);
// the balanced residues of those sums are those of the products of residues.
// Writes s (B, Tq) and the block max, stats[.][0] of (B, nblk, 2).
template <int R>
__global__ void __launch_bounds__(kRowThreads) attention_row_scores(
    const int* __restrict__ q_hi, const int* __restrict__ q_lo, const int* __restrict__ sq,
    const int* __restrict__ k_hi, const int* __restrict__ k_lo, const int* __restrict__ sk,
    const int8_t* __restrict__ mask, double* __restrict__ s_out, double* __restrict__ stats,
    const AttnShape sh, const __grid_constant__ GarnerParams p) {
  constexpr int W = (R + 15) / 16;
  __shared__ int4 qtab[256 * W];
  __shared__ double wmax[kRowThreads / 32];
  const int kb = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, D = sh.D;
  for (int d = tid; d < D; d += kRowThreads) {
    int w[4 * W];
    residue_row<R, W>(q_hi[(int64_t)b * D + d], q_lo[(int64_t)b * D + d], w);
#pragma unroll
    for (int q = 0; q < W; ++q) qtab[d * W + q] = make_int4(w[4 * q], w[4 * q + 1],
                                                            w[4 * q + 2], w[4 * q + 3]);
  }
  __syncthreads();
  const int t = kb * sh.bkv + tid;
  double s = kNegInf;
  if (tid < sh.bkv && t < sh.T && mask[b * sh.mask_sb + t * sh.mask_st] != 0) {
    long long H[R], L[R];
#pragma unroll
    for (int i = 0; i < R; ++i) H[i] = L[i] = 0;
    const int* kh = k_hi + ((int64_t)b * sh.T + t) * D;
    const int* kl = k_lo + ((int64_t)b * sh.T + t) * D;
    auto step = [&](int d, int hi, int lo) {
      int xw[4 * W];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const int4 v = qtab[d * W + q];
        xw[4 * q] = v.x;
        xw[4 * q + 1] = v.y;
        xw[4 * q + 2] = v.z;
        xw[4 * q + 3] = v.w;
      }
      accumulate_row<R, W>(hi, lo, xw, H, L);
    };
    if (D % 8 == 0) {  // rows 32-byte aligned: a lane reads whole sectors
      for (int d = 0; d < D; d += 8) {
        const int4 h0 = __ldg(reinterpret_cast<const int4*>(kh + d));
        const int4 h1 = __ldg(reinterpret_cast<const int4*>(kh + d + 4));
        const int4 l0 = __ldg(reinterpret_cast<const int4*>(kl + d));
        const int4 l1 = __ldg(reinterpret_cast<const int4*>(kl + d + 4));
        step(d, h0.x, l0.x);
        step(d + 1, h0.y, l0.y);
        step(d + 2, h0.z, l0.z);
        step(d + 3, h0.w, l0.w);
        step(d + 4, h1.x, l1.x);
        step(d + 5, h1.y, l1.y);
        step(d + 6, h1.z, l1.z);
        step(d + 7, h1.w, l1.w);
      }
    } else {
      for (int d = 0; d < D; ++d) step(d, __ldg(kh + d), __ldg(kl + d));
    }
    int res[R], dig[R];
    fold_rows<R>(H, L, res);
#pragma unroll
    for (int i = 0; i < R; ++i) res[i] = i < sh.rq ? res[i] : 0;
    garner_digits_lazy<R>(res, p, dig);
    s = ldexp_ref(garner_f64<R>(dig, p, sh.rq), -(sq[b] + sk[(int64_t)b * sh.Tq + t]));
    s = s * sh.inv_sqrt_d;
    if (sh.softcap > 0.0) s = sh.softcap * tanh(s * sh.inv_cap);
  }
  if (tid < sh.bkv) s_out[(int64_t)b * sh.Tq + t] = s;
  double mx = tid < sh.bkv ? s : -INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) wmax[tid >> 5] = mx;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kRowThreads / 32; ++w) mx = fmax(mx, wmax[w]);
    stats[((int64_t)b * sh.nblk + kb) * 2] = mx;
  }
}

// P V of block kb for the one row of problem b, given the block maxima: step 3
// by a warp (tile_softmax), p's residue table, then a thread per column sums
// that column of v's (hi, lo) words against it.  Writes pv (B, nblk, D) and the
// row sum, stats[.][1].
template <int R>
__global__ void __launch_bounds__(kRowThreads) attention_row_pv(
    const int* __restrict__ v_hi, const int* __restrict__ v_lo, const int* __restrict__ sv,
    const double* __restrict__ s_in, double* __restrict__ pv_out, double* __restrict__ stats,
    const AttnShape sh, const __grid_constant__ GarnerParams p) {
  constexpr int W = (R + 15) / 16;
  __shared__ double sbuf[128];
  __shared__ int4 ptab[128 * W];
  __shared__ double stat[4];
  __shared__ int sp;
  const int kb = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, bkv = sh.bkv, D = sh.D;
  TileMem tm{};
  tm.sbuf = sbuf;
  tm.m_s = stat;
  tm.l_s = stat + 1;
  tm.corr_s = stat + 2;
  tm.sum_s = stat + 3;
  tm.sp_s = &sp;
  const TilePos tp{b, 0, 1};
  if (tid == 0) {                    // the running max before this block: M_{kb-1}
    const double* st = stats + (int64_t)b * sh.nblk * 2;
    double m = kNegInf;
    for (int i = 0; i < kb; ++i) m = m < st[2 * i] ? st[2 * i] : m;
    stat[0] = m;
    stat[1] = 0.0;
  }
  for (int c = tid; c < bkv; c += kRowThreads) sbuf[c] = s_in[(int64_t)b * sh.Tq + kb * bkv + c];
  __syncthreads();
  const bool dense = tile_softmax(tm, sh, tp);
  if (dense) {
    for (int c = tid; c < bkv; c += kRowThreads) {
      int w[4 * W];
      residue_row<R, W>(0.0, sbuf[c], w);    // p's integer, |pi| < 2^53
#pragma unroll
      for (int q = 0; q < W; ++q) ptab[c * W + q] = make_int4(w[4 * q], w[4 * q + 1],
                                                              w[4 * q + 2], w[4 * q + 3]);
    }
    __syncthreads();
  }
  if (tid < D) {
    double pv = 0.0;
    if (dense) {
      long long H[R], L[R];
#pragma unroll
      for (int i = 0; i < R; ++i) H[i] = L[i] = 0;
      const int64_t base = ((int64_t)b * sh.Tq + kb * bkv) * D + tid;
      for (int c = 0; c < bkv; ++c) {
        int xw[4 * W];
#pragma unroll
        for (int q = 0; q < W; ++q) {
          const int4 v = ptab[c * W + q];
          xw[4 * q] = v.x;
          xw[4 * q + 1] = v.y;
          xw[4 * q + 2] = v.z;
          xw[4 * q + 3] = v.w;
        }
        accumulate_row<R, W>(__ldg(v_hi + base + (int64_t)c * D), __ldg(v_lo + base + (int64_t)c * D),
                             xw, H, L);
      }
      int res[R], dig[R];
      fold_rows<R>(H, L, res);
#pragma unroll
      for (int i = 0; i < R; ++i) res[i] = i < sh.rp ? res[i] : 0;
      garner_digits_lazy<R>(res, p, dig);
      pv = ldexp_ref(garner_f64<R>(dig, p, sh.rp),
                     -(sp + sv[((int64_t)b * sh.nblk + kb) * D + tid]));
    }
    pv_out[((int64_t)b * sh.nblk + kb) * D + tid] = pv;
  }
  if (tid == 0) stats[((int64_t)b * sh.nblk + kb) * 2 + 1] = stat[3];
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

inline unsigned grid_for(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  return (unsigned)(blocks < 1 ? 1 : (blocks > (1 << 30) ? (1 << 30) : blocks));
}

inline cudaError_t launch_planes(int r, const int* hi, const int* lo, int B, int rows, int D,
                                 int X, int Y, int8_t* out, cudaStream_t s) {
  const unsigned grid = grid_for((int64_t)B * X * (Y / 4), 256);
  switch (r) {
#define OZAKI_CASE(R_)                                                              \
  case R_:                                                                          \
    planes_rows<R_><<<grid, 256, 0, s>>>(hi, lo, B, rows, D, X, Y, out); \
    break;
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

inline cudaError_t launch_planes_t(int r, const int* hi, const int* lo, int B, int rows, int D,
                                   int Dp, int8_t* out, cudaStream_t s) {
  const dim3 grid((rows + 31) / 32, Dp / 32, B);
  switch (r) {
#define OZAKI_CASE(R_)                                                       \
  case R_:                                                                   \
    planes_cols<R_><<<grid, 256, 0, s>>>(hi, lo, rows, D, Dp, out); \
    break;
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Lets `kernel` take up to kSmemLimit bytes of dynamic shared memory, once per
// device (each instance keeps its own record).
template <typename K>
inline cudaError_t allow_smem(K kernel) {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (done >> dev & 1))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

enum AttnPath { kSweep = 0, kRow = 1 };

template <int R>
cudaError_t launch_row(const int* q_hi, const int* q_lo, const int* k_hi, const int* k_lo,
                       const int* v_hi, const int* v_lo, const int* sq, const int* sk,
                       const int* sv, const int8_t* mask, double* out, double* s_buf,
                       double* pv_buf, double* stats, const AttnShape& sh,
                       const GarnerParams& p, cudaStream_t s) {
  const dim3 grid(sh.nblk, sh.B);
  attention_row_scores<R><<<grid, kRowThreads, 0, s>>>(q_hi, q_lo, sq, k_hi, k_lo, sk, mask,
                                                       s_buf, stats, sh, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_row_pv<R><<<grid, kRowThreads, 0, s>>>(v_hi, v_lo, sv, s_buf, pv_buf, stats, sh, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_combine<<<grid_for((int64_t)sh.B * sh.D, 256), 256, 0, s>>>(pv_buf, stats, out,
                                                                          sh.B, sh.nblk, sh.D);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_sweep(const int8_t* qres, const int8_t* kres, const int8_t* vres,
                         const int* sq, const int* sk, const int* sv, const int8_t* mask,
                         double* out, const AttnShape& sh, const GarnerParams& p,
                         cudaStream_t s) {
  const AttnSmem L = attn_layout(sh, R);
  if (L.total == 0) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(attention_sweep<R>);
  if (err != cudaSuccess) return err;
  attention_sweep<R><<<dim3((sh.S + sh.bq - 1) / sh.bq, sh.B), kAttnThreads, L.total, s>>>(
      qres, kres, vres, sq, sk, sv, mask, out, sh, L, p);
  return cudaGetLastError();
}

}  // namespace ozaki

using ozaki::AttnShape;
using ozaki::GarnerParams;

// C interface, loaded with ctypes.  q_hi/q_lo (B, S, D), k_hi/k_lo (B, T, D),
// v_hi/v_lo (B, Tq, D) int32, contiguous, from the Phase-1 scaling; sq (B, S),
// sk (B, Tq), sv (B, nblk, D) int32 shifts; mask int8 with element strides
// (mask_sb, mask_ss, mask_st) over (B, S, T), nonzero = attend.  path: 0 the
// one-pass sweep, 1 the row path (S = 1 only).  Scratch from the caller: for
// the sweep qres (B, rq, S, Dp), kres (B, rq, Tq, Dp) and vres (B, rp, Dp, Tq)
// int8; for the row path s_buf (B, Tq), pv_buf (B, nblk, D) and stats
// (B, nblk, 2) f64; what a path does not use may be null.  out: f64 (B, S, D).
// `params` holds the Garner constants of the plan with more moduli (those of
// the other are its prefix).  rp in 1..20 and
// |rq - rp| <= 1, 1 <= bq <= 32, bkv % 8 == 0, bkv <= 128, D <= 256,
// B <= 65535, and the tile's shared memory must fit (D > 128 needs bq <= 16).
// Launches on `stream`, never synchronises, returns the first CUDA error (0 on
// success).
extern "C" int ozaki_attention_fused(int device, const int* q_hi, const int* q_lo,
                                     const int* k_hi, const int* k_lo, const int* v_hi,
                                     const int* v_lo, const int* sq, const int* sk,
                                     const int* sv, const int8_t* mask, void* out,
                                     int8_t* qres, int8_t* kres, int8_t* vres, void* s_buf,
                                     void* pv_buf, void* stats, int path,
                                     const AttnShape* shape, const GarnerParams* params,
                                     void* stream) {
  using ozaki::kRow;
  using ozaki::kSweep;
  const AttnShape& sh = *shape;
  const GarnerParams& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sh.bq < 1 || sh.bq > ozaki::kAttnMaxRows || sh.bkv < 8 || sh.bkv % 8 ||
      sh.bkv > 128 || sh.D < 1 || sh.D > 256 || sh.B > 65535 || sh.rq - sh.rp > 1 ||
      sh.rp - sh.rq > 1 || p.r != (sh.rq > sh.rp ? sh.rq : sh.rp) || path < kSweep ||
      path > kRow || (path == kRow && sh.S != 1) ||
      (path == kRow && (!s_buf || !pv_buf || !stats)) ||
      (path == kSweep && (!qres || !kres || !vres))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (sh.B == 0 || sh.S == 0) return cudaSuccess;
  double* o = static_cast<double*>(out);
  if (path == kRow) {
    double* sb = static_cast<double*>(s_buf);
    double* pb = static_cast<double*>(pv_buf);
    double* st = static_cast<double*>(stats);
    switch (p.r) {
#define OZAKI_CASE(R_)                                                                       \
  case R_:                                                                                   \
    return ozaki::launch_row<R_>(q_hi, q_lo, k_hi, k_lo, v_hi, v_lo, sq, sk, sv, mask, o, sb, \
                                 pb, st, sh, p, s);
      OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
      default: return cudaErrorInvalidValue;
    }
  }
  err = ozaki::launch_planes(sh.rq, q_hi, q_lo, sh.B, sh.S, sh.D, sh.S, sh.Dp, qres, s);
  if (err != cudaSuccess) return err;
  err = ozaki::launch_planes(sh.rq, k_hi, k_lo, sh.B, sh.T, sh.D, sh.Tq, sh.Dp, kres, s);
  if (err != cudaSuccess) return err;
  err = ozaki::launch_planes_t(sh.rp, v_hi, v_lo, sh.B, sh.Tq, sh.D, sh.Dp, vres, s);
  if (err != cudaSuccess) return err;
  switch (p.r) {
#define OZAKI_CASE(R_)                                                                     \
  case R_:                                                                                 \
    return ozaki::launch_sweep<R_>(qres, kres, vres, sq, sk, sv, mask, o, sh, p, s);
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
}
