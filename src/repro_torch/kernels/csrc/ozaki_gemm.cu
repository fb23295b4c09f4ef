// gemm_hilo for Hopper (sm_90a): C~ = A~ . B~ exactly, from (hi, lo) int32 operands.
//
// Replaces the TPU kernel repro/kernels/ozaki_gemm.py::gemm_hilo (pallas_call at
// line 99), which computes the residues of each (hi, lo) tile, one int8 x int8 ->
// int32 MXU dot per modulus accumulated in VMEM across the K grid axis, and the
// Garner epilogue before a single store.
//
// Bound on the H100: 2*M*N*K*r int8 operations at 1979 TOPS (8192^3 at r = 16:
// ~8.9 ms, against ~0.16 ms for moving the 8-byte inputs and outputs), so it is
// bound by operations.
//
// Design.  The TPU keeps r accumulator tiles of 128 x 128 int32 in VMEM (1 MiB at
// r = 16); an SM has 256 KB of registers, and blocks run in no order, so the K
// axis becomes a loop inside a block and the moduli become a grid axis:
//   1. residues_rows / residues_cols (ozaki_product.cuh) turn the operands into
//      int8 residue planes once, A as (r, M, K) and B transposed as (r, N, K).
//      Recomputing them inside the product loop would cost r * ~20 integer
//      operations per element for every output tile that reads it, more than
//      the tensor-core work; computing them once costs r bytes per element of
//      extra traffic (about 1 ms at 8192^2).
//   2. gemm_modprod: one block per 128 x 128 output tile and modulus.  Eight
//      warps of 64 x 32, each a 4 x 4 grid of mma.sync.m16n8k32 s8 tiles with
//      int32 accumulators in registers; fragments come straight from global
//      memory through the read-only path, 16 bytes a lane.  The K order inside
//      a 64-deep step is permuted identically for A and B (lane t holds k =
//      16t..16t+15), which leaves every dot product unchanged.  int32 sums of
//      balanced int8 products are exact up to 2^17 terms; the accumulators are
//      reduced every 2^16 k, so any K is exact.  The balanced residue is unique,
//      so reducing once after the loop gives the bits the TPU kernel's per-step
//      reduction gives.
//   3. garner_epilogue turns the (r, M, N) int8 residues into f64, ds or digits.
// A simple kernel first: no shared-memory staging, no wgmma, no TMA.
#include "ozaki_product.cuh"

namespace ozaki {

constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 64;
constexpr int kGemmChunk = 1 << 16;  // reduce the accumulators at least this often

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One block: a 128 x 128 tile of the product for modulus blockIdx.z.
// ares (r, M, K), bres (r, N, K) int8; cres (r, M, N) int8 balanced residues.
__global__ void __launch_bounds__(256) gemm_modprod(const int8_t* __restrict__ ares,
                                                    const int8_t* __restrict__ bres, int M,
                                                    int N, int K, int8_t* __restrict__ cres,
                                                    const __grid_constant__ GarnerParams p) {
  const int i = blockIdx.z;
  const int m = p.moduli[i];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * kGemmBM + (warp >> 2) * 64;
  const int col0 = blockIdx.x * kGemmBN + (warp & 3) * 32;
  const int8_t* A = ares + (size_t)i * M * K + 16 * t;
  const int8_t* B = bres + (size_t)i * N * K + 16 * t;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0;

  for (int k0 = 0; k0 < K; k0 += kGemmBK) {
    int4 a[4][2], b[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      a[mi][0] = ldg16(A + (size_t)(row0 + mi * 16 + g) * K + k0);
      a[mi][1] = ldg16(A + (size_t)(row0 + mi * 16 + g + 8) * K + k0);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) b[ni] = ldg16(B + (size_t)(col0 + ni * 8 + g) * K + k0);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_s8(acc[mi][ni], a[mi][0].x, a[mi][1].x, a[mi][0].y, a[mi][1].y, b[ni].x, b[ni].y);
        mma_s8(acc[mi][ni], a[mi][0].z, a[mi][1].z, a[mi][0].w, a[mi][1].w, b[ni].z, b[ni].w);
      }
    }
    if (((k0 + kGemmBK) & (kGemmChunk - 1)) == 0) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mi][ni][c] = bmod(acc[mi][ni][c], m);
    }
  }

  int8_t* C = cres + (size_t)i * M * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = row0 + mi * 16 + g + (c >> 1) * 8;
        const int col = col0 + ni * 8 + 2 * t + (c & 1);
        C[(size_t)row * N + col] = (int8_t)bmod(acc[mi][ni][c], m);
      }
    }
  }
}

}  // namespace ozaki

using ozaki::GarnerParams;

// C interface, loaded with ctypes.  a_hi/a_lo (M, K), b_hi/b_lo (K, N) int32,
// contiguous, M % 128 == N % 128 == K % 64 == 0.  Scratch from the caller:
// ares (r, M, K), bres (r, N, K), cres (r, M, N) int8.  out: f64 (M, N),
// digits int8 (r, M, N) or ds f32 (2, M, N) by out_rep.  Launches on `stream`,
// never synchronises, returns the first CUDA error (0 on success).
extern "C" int ozaki_gemm_hilo(int device, const int* a_hi, const int* a_lo, const int* b_hi,
                               const int* b_lo, int M, int N, int K, int out_rep, void* out,
                               int8_t* ares, int8_t* bres, int8_t* cres,
                               const GarnerParams* params, void* stream) {
  const GarnerParams& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = ozaki::launch_residues_rows(p.r, a_hi, a_lo, (int64_t)M * K, ares, s);
  if (err != cudaSuccess) return err;
  err = ozaki::launch_residues_cols(p.r, b_hi, b_lo, K, N, bres, s);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / ozaki::kGemmBN, M / ozaki::kGemmBM, p.r);
  ozaki::gemm_modprod<<<grid, 256, 0, s>>>(ares, bres, M, N, K, cres, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ozaki::launch_garner_epilogue(cres, (int64_t)M * N, out_rep, out, p, s);
}
