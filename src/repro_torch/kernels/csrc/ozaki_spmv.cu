// spmv_bell for Hopper (sm_90a): y~ = A~ x~ exactly for A in Blocked-ELL form,
// from the (hi, lo) int32 split of the row-scaled values of A and of the
// globally scaled x, rebuilt by Garner into f64, ds or digits.
//
// Replaces the TPU kernel repro/kernels/ozaki_spmv.py::spmv_bell (body
// _spmv_kernel, pallas_call at line 160).  The TPU kernel keeps all of x's
// (hi, lo) resident in VMEM (ozaki_spmv.py:9-11); here a pre-pass turns x into
// a residue table that the gather reads from L2.
//
// Bound on the H100: the bytes the function must move, each read once: A's
// (hi, lo) and its int32 columns (12 B per slot), x's (hi, lo) (8 B per
// element) and the f64 output (8 B per row), at 3.35 TB/s (HPCG 104^3, bw = 27:
// 382,453,760 B, ~0.114 ms).  The kernel adds the residue table, written once
// and gathered from L2 (16 B per x, 18 MB at HPCG 104^3).
//
// Design.  The contraction is bw long per row and has no reuse of A, so it runs
// on the CUDA cores with no MMA.
//   1. x_residue_table writes, once per call, the balanced residues of every x_j
//      for all r moduli as one row of 16 int8 (32 when r > 16; zero-padded),
//      through the exact FP64 reduction residue_f64.
//      Each slot then gathers one 16-byte row instead of computing r residues,
//      and the 27 rows of HPCG's operator that read x_j share its row in L2.
//   2. A is read coalesced.  Each warp owns 32 consecutive rows (one per lane)
//      and stages their slots 16 at a time into shared memory with 4-byte
//      cp.async copies (lanes 0-15 and 16-31 copy the 16-slot segments of two
//      rows: consecutive addresses), double-buffered so that the next segment
//      arrives while this one is used.  A lane then walks its row in shared
//      memory.  The shared row stride is 17 words whatever bw is, so the walk
//      is free of bank conflicts for odd and even bw alike (the 32 lanes read
//      banks 17 * lane + s mod 32, all distinct).  Warps stage and compute on
//      their own (__syncwarp only), so one warp's copies overlap another's
//      arithmetic.
//   3. A's residues are never formed.  For modulus m, sum_s res(a_s) res(x_s) is
//      congruent to 2^26 * H + L with H = sum_s hi_s * xr_s and L = sum_s lo_s *
//      xr_s (xr_s the table's residue of x at slot s), accumulated in int64:
//      two 32 x 32 -> 64-bit multiply-adds per slot and modulus, where the plain
//      version's residues cost ~40 integer operations.  |hi * xr| <= 2^34, so
//      every 2^16 slots (2^50 at most) the pair is folded into L as the balanced
//      residue of (2^26 mod m) * H + L, which keeps any bw exact; at the row's
//      end the same fold gives the row's balanced residue.  That residue is
//      unique, so it equals the plain version's int64 row sum reduced mod m.
// Then Garner (the lazy-carry digits, equal to garner_digits') and the output
// representation, as before.
#include "ozaki_common.cuh"

namespace ozaki {

constexpr int kSpmvMaxRows = 256;          // rows per block (warps of 32 rows)
constexpr int kSpmvReduceEvery = 1 << 16;  // slots between folds of the int64 sums
constexpr int kSpmvChunk = 16;             // slots a warp stages per row and step
constexpr int kSpmvStride = kSpmvChunk + 1;               // shared row stride (words), odd
constexpr int kSpmvArray = 32 * kSpmvStride;              // one array of one buffer (words)
constexpr int kSpmvWarpWords = 2 * 3 * kSpmvArray;        // 2 buffers x (hi, lo, cols)

// Row j of the table: the balanced residues of x_hi[j] * 2^26 + x_lo[j] for
// moduli 0 .. R-1 as int8, zero-padded to W int4.
template <int R>
__global__ void __launch_bounds__(256) x_residue_table(const int* __restrict__ x_hi,
                                                        const int* __restrict__ x_lo, int n,
                                                        int4* __restrict__ table) {
  constexpr int W = (R + 15) / 16;
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    int w[4 * W];
    residue_row<R, W>(x_hi[j], x_lo[j], w);
#pragma unroll
    for (int q = 0; q < W; ++q) table[j * W + q] = make_int4(w[4 * q], w[4 * q + 1],
                                                             w[4 * q + 2], w[4 * q + 3]);
  }
}

// a_hi/a_lo/cols (M, bw) int32, every column in 0..N-1; xres the table above.
// Blocks of br rows; warp w of a block owns rows blockIdx.x * br + 32 w + lane.
// out: f64 (M), ds f32 (2, M) or digits int8 (R, M).
template <int R>
__global__ void __launch_bounds__(kSpmvMaxRows) spmv_kernel(
    const int* __restrict__ a_hi, const int* __restrict__ a_lo, const int* __restrict__ cols,
    const int4* __restrict__ xres, int M, int bw, int br, int out_rep, void* __restrict__ out,
    const __grid_constant__ GarnerParams p) {
  constexpr int W = (R + 15) / 16;
  extern __shared__ int spmv_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* wbuf = spmv_smem + warp * kSpmvWarpWords;
  const int64_t blk0 = (int64_t)blockIdx.x * br;
  const int64_t row0 = blk0 + 32 * warp;
  const int64_t end = blk0 + br < M ? blk0 + br : M;
  if (row0 >= end) return;                       // the whole warp: nothing of ours
  const int nrows = end - row0 < 32 ? (int)(end - row0) : 32;
  const bool active = lane < nrows;

  // Slots [c0, c0 + 16) of the warp's rows into buffer `buf`: lane l copies slot
  // l % 16 of rows l / 16, l / 16 + 2, ...
  const int sub = lane & 15, half = lane >> 4;
  auto stage = [&](int c0, int buf) {
    const int len = bw - c0 < kSpmvChunk ? bw - c0 : kSpmvChunk;
    int* dst = wbuf + buf * 3 * kSpmvArray;
    if (sub < len) {
      for (int r = half; r < nrows; r += 2) {
        const int64_t g = (row0 + r) * bw + c0 + sub;
        const int o = r * kSpmvStride + sub;
        cp_async4(dst + o, a_hi + g);
        cp_async4(dst + kSpmvArray + o, a_lo + g);
        cp_async4(dst + 2 * kSpmvArray + o, cols + g);
      }
    }
    cp_async_commit();
  };

  long long H[R], L[R];
#pragma unroll
  for (int i = 0; i < R; ++i) H[i] = L[i] = 0;
  int since = 0;
  const int nchunks = (bw + kSpmvChunk - 1) / kSpmvChunk;
  stage(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < nchunks) {
      stage((c + 1) * kSpmvChunk, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int len = bw - c * kSpmvChunk < kSpmvChunk ? bw - c * kSpmvChunk : kSpmvChunk;
    if (active) {
      const int* sh = wbuf + buf * 3 * kSpmvArray + lane * kSpmvStride;
#pragma unroll 4
      for (int s = 0; s < len; ++s) {
        const int ah = sh[s], al = sh[kSpmvArray + s];
        const int4* xp = xres + (int64_t)sh[2 * kSpmvArray + s] * W;
        int xw[4 * W];
#pragma unroll
        for (int q = 0; q < W; ++q) {
          const int4 v = __ldg(xp + q);
          xw[4 * q] = v.x;
          xw[4 * q + 1] = v.y;
          xw[4 * q + 2] = v.z;
          xw[4 * q + 3] = v.w;
        }
        accumulate_row<R, W>(ah, al, xw, H, L);
      }
      since += len;
      if (since >= kSpmvReduceEvery) {
        since = 0;
        int res[R];
        fold_rows<R>(H, L, res);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          L[i] = res[i];
          H[i] = 0;
        }
      }
    }
    __syncwarp();  // buffer `buf` is staged again at step c + 2
  }
  if (!active) return;

  const int64_t row = row0 + lane;
  int res[R], dig[R];
  fold_rows<R>(H, L, res);
  garner_digits_lazy<R>(res, p, dig);
  if (out_rep == kOutF64) {
    static_cast<double*>(out)[row] = digits_to_f64<R>(dig, p);
  } else if (out_rep == kOutDs) {
    float hi, lo;
    digits_to_ds<R>(dig, p, hi, lo);
    static_cast<float*>(out)[row] = hi;
    static_cast<float*>(out)[M + row] = lo;
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) static_cast<int8_t*>(out)[(int64_t)i * M + row] = (int8_t)dig[i];
  }
}

template <int R>
cudaError_t launch_spmv(const int* a_hi, const int* a_lo, const int* cols, const int* x_hi,
                        const int* x_lo, int M, int N, int bw, int br, int out_rep, void* out,
                        int8_t* xres, const GarnerParams& p, cudaStream_t s) {
  const int64_t tblocks = ((int64_t)N + 255) / 256;
  if (tblocks > 0) {
    x_residue_table<R><<<(unsigned)(tblocks > (1 << 30) ? (1 << 30) : tblocks), 256, 0, s>>>(
        x_hi, x_lo, N, reinterpret_cast<int4*>(xres));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = (br + 31) / 32 * 32;
  const int bytes = threads / 32 * kSpmvWarpWords * (int)sizeof(int);
  err = cudaFuncSetAttribute(spmv_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(((int64_t)M + br - 1) / br);
  spmv_kernel<R><<<grid, threads, bytes, s>>>(a_hi, a_lo, cols,
                                              reinterpret_cast<const int4*>(xres), M, bw, br,
                                              out_rep, out, p);
  return cudaGetLastError();
}

}  // namespace ozaki

using ozaki::GarnerParams;

// C interface, loaded with ctypes.  a_hi/a_lo/cols (M, bw) int32 and x_hi/x_lo
// (N,) int32, contiguous, every column index in 0..N-1 (checked by the caller);
// br rows per block, 1..256.  xres: scratch from the caller, N * 16 bytes (N *
// 32 when r > 16), 16-byte aligned.  out: f64 (M), digits int8 (r, M) or ds
// f32 (2, M) by out_rep.  Launches on `stream`, never synchronises, returns
// the first CUDA error (0 on success).
extern "C" int ozaki_spmv_hilo(int device, const int* a_hi, const int* a_lo, const int* cols,
                               const int* x_hi, const int* x_lo, int M, int N, int bw, int br,
                               int out_rep, void* out, int8_t* xres, const GarnerParams* params,
                               void* stream) {
  const GarnerParams& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (br < 1 || br > ozaki::kSpmvMaxRows) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M == 0) return cudaSuccess;
  switch (p.r) {
#define OZAKI_CASE(R_)                                                                      \
  case R_:                                                                                  \
    return ozaki::launch_spmv<R_>(a_hi, a_lo, cols, x_hi, x_lo, M, N, bw, br, out_rep, out, \
                                  xres, p, s);
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
}
