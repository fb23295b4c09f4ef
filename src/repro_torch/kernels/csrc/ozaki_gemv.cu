// gemv_hilo for Hopper (sm_90a): Y~ = A~ . X~ exactly for a narrow right-hand
// side X (N, B <= 16), from (hi, lo) int32 operands.
//
// Replaces the TPU kernel repro/kernels/ozaki_gemv.py::gemv_hilo (pallas_call at
// line 90): the same residue -> int8 dot -> Garner pipeline as gemm_hilo, with
// the small batch B on the MXU's minor dimension.
//
// Bound on the H100: the 8 bytes of (hi, lo) per element of A, at 3.35 TB/s
// (8192^2 at B = 1: ~0.16 ms); its 2*M*N*B*r int8 operations take ~1 us at
// 1979 TOPS, so it is bound by bytes.  Every CG matvec has B = 1.
//
// Design.  An MMA is at least 8 columns wide, so at B = 1 it would waste 7/8 of
// its work; the product runs on the CUDA cores with __dp4a (four int8 products
// and an int32 add per instruction):
//   1. residues_rows / residues_cols (ozaki_product.cuh) make the int8 residue
//      planes of A, (r, M, N), and of X transposed, (r, B, N).  The residues cost
//      r * ~20 integer operations per element of A, which, not the bytes, is what
//      limits this first version.
//   2. gemv_modprod: one block per 8 rows and modulus, one warp per row.  A lane
//      reads 16 residues of its row per step and keeps one dp4a accumulator per
//      column of X; each lane reduces its sums to balanced residues (at least
//      every 2^16 terms, so any N is exact), the warp adds them with shuffles
//      and reduces once more.  The balanced residue is unique, so the bits are
//      those of the TPU kernel's per-step reduction.
//   3. garner_epilogue turns the (r, M, B) residues into f64, ds or digits.
#include "ozaki_product.cuh"

namespace ozaki {

constexpr int kGemvRows = 8;   // rows per block, one warp each
constexpr int kGemvMaxB = 16;  // widest right-hand side (dispatch.GEMV_MAX_B)
constexpr int kGemvReduceEvery = 1 << 12;  // lane steps of 16 k between reductions

// ares (r, M, K), xres (r, B, K) int8; cres (r, M, B) int8 balanced residues.
__global__ void __launch_bounds__(256) gemv_modprod(const int8_t* __restrict__ ares,
                                                    const int8_t* __restrict__ xres, int M,
                                                    int K, int B, int8_t* __restrict__ cres,
                                                    const __grid_constant__ GarnerParams p) {
  const int i = blockIdx.y;
  const int m = p.moduli[i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kGemvRows + warp;
  const int8_t* A = ares + ((size_t)i * M + row) * K;
  const int8_t* X = xres + (size_t)i * B * K;

  int acc[kGemvMaxB];
#pragma unroll
  for (int b = 0; b < kGemvMaxB; ++b) acc[b] = 0;
  int steps = 0;
  for (int k = lane * 16; k < K; k += 32 * 16) {
    const int4 a = ldg16(A + k);
#pragma unroll
    for (int b = 0; b < kGemvMaxB; ++b) {
      if (b < B) {
        const int4 x = ldg16(X + (size_t)b * K + k);
        acc[b] = __dp4a(a.x, x.x, acc[b]);
        acc[b] = __dp4a(a.y, x.y, acc[b]);
        acc[b] = __dp4a(a.z, x.z, acc[b]);
        acc[b] = __dp4a(a.w, x.w, acc[b]);
      }
    }
    if (++steps == kGemvReduceEvery) {
      steps = 0;
#pragma unroll
      for (int b = 0; b < kGemvMaxB; ++b) acc[b] = bmod(acc[b], m);
    }
  }

  int mine = 0;
#pragma unroll
  for (int b = 0; b < kGemvMaxB; ++b) {
    if (b < B) {
      int v = bmod(acc[b], m);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == b) mine = bmod(v, m);
    }
  }
  if (lane < B) cres[((size_t)i * M + row) * B + lane] = (int8_t)mine;
}

}  // namespace ozaki

using ozaki::GarnerParams;

// C interface, loaded with ctypes.  a_hi/a_lo (M, K), x_hi/x_lo (K, B) int32,
// contiguous, M % 8 == 0, K % 32 == 0, 1 <= B <= 16.  Scratch from the caller:
// ares (r, M, K), xres (r, B, K), cres (r, M, B) int8.  out: f64 (M, B), digits
// int8 (r, M, B) or ds f32 (2, M, B) by out_rep.  Launches on `stream`, never
// synchronises, returns the first CUDA error (0 on success).
extern "C" int ozaki_gemv_hilo(int device, const int* a_hi, const int* a_lo, const int* x_hi,
                               const int* x_lo, int M, int K, int B, int out_rep, void* out,
                               int8_t* ares, int8_t* xres, int8_t* cres,
                               const GarnerParams* params, void* stream) {
  const GarnerParams& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = ozaki::launch_residues_rows(p.r, a_hi, a_lo, (int64_t)M * K, ares, s);
  if (err != cudaSuccess) return err;
  err = ozaki::launch_residues_cols(p.r, x_hi, x_lo, K, B, xres, s);
  if (err != cudaSuccess) return err;
  const dim3 grid(M / ozaki::kGemvRows, p.r);
  ozaki::gemv_modprod<<<grid, 256, 0, s>>>(ares, xres, M, K, B, cres, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ozaki::launch_garner_epilogue(cres, (int64_t)M * B, out_rep, out, p, s);
}
