// gemv_hilo for Hopper (sm_90a): Y~ = A~ . X~ exactly for a narrow right-hand
// side X (K, B <= 16), from (hi, lo) int32 operands.
//
// Replaces the TPU kernel repro/kernels/ozaki_gemv.py::gemv_hilo (pallas_call at
// line 90): the same residue -> int8 dot -> Garner pipeline as gemm_hilo, with
// the small batch B on the MXU's minor dimension.
//
// Bound on the H100: the 8 bytes of (hi, lo) per element of A, at 3.35 TB/s
// (8192^2 at B = 1: ~0.16 ms); its 2*M*K*B*r int8 operations take ~1 us at
// 1979 TOPS, so it is bound by bytes.  Every CG matvec has B = 1.
//
// Design.  A's (hi, lo) words are read once, and A's residues never reach
// device memory; what is left is the residue arithmetic, r per element of A.
//   1. gemv_x_table writes X's residues once per call, in the order of the MMA
//      fragments that read them: (r, K / 32, 32 lanes) entries of 8 bytes (B <=
//      8) or 16 (B > 8), r * K * 16 bytes at most (2 MB at K = 8192, r = 16),
//      which stays in L2 and is shared through L1 by a block's warps.
//   2. gemv_kernel: one warp per 8 rows of A, four warps a block, each warp
//      over the whole of K.  Per 32-deep step a lane reads 8 consecutive (hi,
//      lo) words of its row with 16-byte loads (a row's 4 lanes read 128
//      contiguous bytes; the next step's words are loaded before this step's
//      arithmetic) and forms their residues in registers, per modulus, with
//      residue_hilo: three FP64 and two integer operations, no fix-up, and for
//      m = 256 the low byte of lo.  They are the B operand of two
//      mma.sync.m16n8k16 s8 products whose A operand is X's residues transposed
//      (16 columns of X, zero-padded, by 16 k), so one MMA serves 8 rows of A
//      and any B <= 16 at the same cost.  Lane t holds k = 8t .. 8t + 7 of each
//      step in both operands: a permutation of the step's k that leaves every
//      dot product unchanged.  The int32 sums of int8 products are exact up to
//      2^17 terms; they are reduced every 2^16 k, so any K is exact.
//   3. The lane that holds an output's r sums reduces them to balanced residues
//      (unique, so the bits are those of the plain version's exact sums mod m)
//      and runs Garner (garner_digits_lazy) and the output representation in
//      registers: no residue of the product reaches device memory either.
// The MMA work is ~17 G int8 operations at 8192^2 whatever B is, and the kernel
// takes the same time at B = 1, 8 and 16 on the H100 (PERF.md); the residues
// of A, r - 1 per element, are most of its arithmetic.
#include "ozaki_common.cuh"

namespace ozaki {

constexpr int kGemvWarps = 4;       // warps per block, 8 rows of A each
constexpr int kGemvMaxB = 16;       // widest right-hand side (dispatch.GEMV_MAX_B)
constexpr int kGemvFold = 1 << 16;  // k between reductions of the int32 sums

// d += a . b for a 16 x 16 s8 tile a (rows g and g + 8: a0, a1) and a 16 x 8
// s8 tile b (column g: b0), int32 accumulators (rows g, g + 8; columns 2t, 2t + 1).
__device__ __forceinline__ void mma_k16(int (&d)[4], unsigned a0, unsigned a1, unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// X (K, B) int32 hi/lo -> the fragment-order table of its residues.  Entry (i,
// c, lane), lane = 4g + t, is W words: word w holds the residues mod modulus i
// of X[k][g + 8 (w / 2)] for k = 32c + 8t + 4 (w % 2) + q in byte q; zero for
// columns >= B.  W = 2 when B <= 8 (columns g + 8 are all zero), else 4.
__global__ void __launch_bounds__(256) gemv_x_table(const int* __restrict__ x_hi,
                                                     const int* __restrict__ x_lo, int K, int B,
                                                     int r, int W, unsigned* __restrict__ table) {
  const int nc = K / 32;
  const int64_t n = (int64_t)r * nc * 32;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int lane = (int)(e & 31);
    const int64_t ic = e >> 5;
    const int i = (int)(ic / nc), c = (int)(ic % nc);
    const ModRT md = mod_rt(i);
    const double c26 = (double)((1 << kSplitBits) % md.m);
    const int g = lane >> 2, t = lane & 3;
    for (int w = 0; w < W; ++w) {
      const int col = g + 8 * (w >> 1);
      int v[4] = {0, 0, 0, 0};
      if (col < B) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int64_t idx = (int64_t)(32 * c + 8 * t + 4 * (w & 1) + q) * B + col;
          // residue_f64 with the modulus known at run time
          v[q] = bmod_f64(__fma_rn((double)x_hi[idx], c26, (double)x_lo[idx]), md.m, md.inv,
                          md.half_hi, md.half_lo);
        }
      }
      table[e * W + w] = pack4(v[0], v[1], v[2], v[3]);
    }
  }
}

// a_hi/a_lo (M, K) int32, M % 8 == 0, K % 32 == 0; table from gemv_x_table.
// out: f64 (M, B), ds f32 (2, M, B) or digits int8 (R, M, B).
template <int R>
__global__ void __launch_bounds__(32 * kGemvWarps) gemv_kernel(
    const int* __restrict__ a_hi, const int* __restrict__ a_lo,
    const unsigned* __restrict__ table, int M, int K, int B, int W, int out_rep,
    void* __restrict__ out, const __grid_constant__ GarnerParams p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x * kGemvWarps + warp) * 8;
  if (row0 >= M) return;  // the whole warp: M is a multiple of 8
  const int4* ah = reinterpret_cast<const int4*>(a_hi + (size_t)(row0 + g) * K + 8 * t);
  const int4* al = reinterpret_cast<const int4*>(a_lo + (size_t)(row0 + g) * K + 8 * t);
  const int nc = K / 32;

  int acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0;

  // the next step's words are loaded before this step's residues are formed
  int4 nh0 = make_int4(0, 0, 0, 0), nh1 = nh0, nl0 = nh0, nl1 = nh0;
  if (nc > 0) {
    nh0 = __ldg(ah);
    nh1 = __ldg(ah + 1);
    nl0 = __ldg(al);
    nl1 = __ldg(al + 1);
  }
  for (int c = 0; c < nc; ++c) {
    const int4 h0 = nh0, h1 = nh1, l0 = nl0, l1 = nl1;
    if (c + 1 < nc) {
      nh0 = __ldg(ah + 8 * (c + 1));
      nh1 = __ldg(ah + 8 * (c + 1) + 1);
      nl0 = __ldg(al + 8 * (c + 1));
      nl1 = __ldg(al + 8 * (c + 1) + 1);
    }
    const int hi[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
    const int lo[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
    double hd[8], ld[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      hd[q] = (double)hi[q];
      ld[q] = (double)lo[q];
    }
    const unsigned* xe = table + ((size_t)c * 32 + lane) * W;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = residue_hilo(hi[q], lo[q], hd[q], ld[q], modulus(i));
      const unsigned b0 = pack4(v[0], v[1], v[2], v[3]), b1 = pack4(v[4], v[5], v[6], v[7]);
      const unsigned* x = xe + (size_t)i * nc * 32 * W;
      unsigned x0, x1, x2 = 0, x3 = 0;
      if (W == 4) {
        const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x));
        x0 = xv.x; x1 = xv.y; x2 = xv.z; x3 = xv.w;
      } else {
        const uint2 xv = __ldg(reinterpret_cast<const uint2*>(x));
        x0 = xv.x; x1 = xv.y;
      }
      mma_k16(acc[i], x0, x2, b0);  // k = 32c + 8t + 0..3
      mma_k16(acc[i], x1, x3, b1);  // k = 32c + 8t + 4..7
    }
    if ((((c + 1) * 32) & (kGemvFold - 1)) == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = bmod(acc[i][q], modulus(i));
    }
  }

  // acc[i][q] is output (row0 + 2t + (q & 1), column g + 8 (q >> 1)) mod modulus i.
  const int64_t count = (int64_t)M * B;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = g + 8 * (q >> 1);
    if (col >= B) continue;
    const int64_t e = (int64_t)(row0 + 2 * t + (q & 1)) * B + col;
    int res[R], dig[R];
#pragma unroll
    for (int i = 0; i < R; ++i) res[i] = bmod(acc[i][q], modulus(i));
    garner_digits_lazy<R>(res, p, dig);
    if (out_rep == kOutF64) {
      static_cast<double*>(out)[e] = digits_to_f64<R>(dig, p);
    } else if (out_rep == kOutDs) {
      float h, l;
      digits_to_ds<R>(dig, p, h, l);
      static_cast<float*>(out)[e] = h;
      static_cast<float*>(out)[count + e] = l;
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) static_cast<int8_t*>(out)[j * count + e] = (int8_t)dig[j];
    }
  }
}

template <int R>
cudaError_t launch_gemv(const int* a_hi, const int* a_lo, const int* x_hi, const int* x_lo,
                        int M, int K, int B, int out_rep, void* out, unsigned* xres,
                        const GarnerParams& p, cudaStream_t s) {
  const int W = B > 8 ? 4 : 2;
  const int64_t entries = (int64_t)R * K;  // R * (K / 32) * 32
  const int64_t tblocks = (entries + 255) / 256;
  if (tblocks > 0) {
    gemv_x_table<<<(unsigned)(tblocks > (1 << 30) ? (1 << 30) : tblocks), 256, 0, s>>>(
        x_hi, x_lo, K, B, R, W, xres);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = 8 * kGemvWarps;
  gemv_kernel<R><<<(unsigned)((M + rows - 1) / rows), 32 * kGemvWarps, 0, s>>>(
      a_hi, a_lo, xres, M, K, B, W, out_rep, out, p);
  return cudaGetLastError();
}

}  // namespace ozaki

using ozaki::GarnerParams;

// C interface, loaded with ctypes.  a_hi/a_lo (M, K), x_hi/x_lo (K, B) int32,
// contiguous, M % 8 == 0, K % 32 == 0, 1 <= B <= 16.  xres: scratch from the
// caller for X's residue table, r * K * 8 bytes (16 when B > 8), 16-byte
// aligned.  out: f64 (M, B), digits int8 (r, M, B) or ds f32 (2, M, B) by
// out_rep.  Launches on `stream`, never synchronises, returns the first CUDA
// error (0 on success).
extern "C" int ozaki_gemv_hilo(int device, const int* a_hi, const int* a_lo, const int* x_hi,
                               const int* x_lo, int M, int K, int B, int out_rep, void* out,
                               void* xres, const GarnerParams* params, void* stream) {
  const GarnerParams& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > ozaki::kGemvMaxB || M % 8 || K % 32) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M == 0) return cudaSuccess;
  unsigned* table = static_cast<unsigned*>(xres);
  switch (p.r) {
#define OZAKI_CASE(R_) \
  case R_:             \
    return ozaki::launch_gemv<R_>(a_hi, a_lo, x_hi, x_lo, M, K, B, out_rep, out, table, p, s);
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
}
