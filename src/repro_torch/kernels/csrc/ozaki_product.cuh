// The stages of the Ozaki-II products (ozaki_gemm.cu, ozaki_gemv.cu).
//
// Both kernels run the same three stages as the TPU kernels' single grid:
//   1. residues: (hi, lo) int32 operands -> balanced int8 residue planes, one per
//      modulus (residues_rows for the left operand, residues_cols for the right
//      one, transposed so that the contraction index is contiguous);
//   2. the modular products: int32 sums of int8 products per modulus, reduced to
//      balanced residues (gemm_modprod / gemv_modprod, in the .cu files);
//   3. garner_epilogue: balanced Garner digits and the output representation.
// Stages 1 and 3 and their launchers live here, so that only the two sources
// that run them compile their 60 instances.
#pragma once

#include "ozaki_common.cuh"

namespace ozaki {

__device__ __forceinline__ int4 ldg16(const int8_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// (rows, K) int32 hi/lo, row-major -> (R, rows, K) int8 residues.  n4 is
// rows * K / 4: a thread turns 4 consecutive elements into one packed word per
// modulus (little-endian: byte j is element 4w + j).
template <int R>
__global__ void __launch_bounds__(256) residues_rows(const int* __restrict__ hi,
                                                     const int* __restrict__ lo,
                                                     int64_t n4, int8_t* __restrict__ out) {
  unsigned* words = reinterpret_cast<unsigned*>(out);
  for (int64_t w = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; w < n4;
       w += (int64_t)gridDim.x * blockDim.x) {
    const int4 h = __ldg(reinterpret_cast<const int4*>(hi) + w);
    const int4 l = __ldg(reinterpret_cast<const int4*>(lo) + w);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = modulus(i);
      const unsigned b0 = residue(h.x, l.x, m) & 0xff, b1 = residue(h.y, l.y, m) & 0xff;
      const unsigned b2 = residue(h.z, l.z, m) & 0xff, b3 = residue(h.w, l.w, m) & 0xff;
      words[i * n4 + w] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
    }
  }
}

// (K, C) int32 hi/lo, row-major -> (R, C, K) int8 residues, transposed through
// shared memory in 32 x 32 tiles.  Block (32, 8); grid (K / 32, ceil(C / 32)):
// K on x, whose limit is 2^31 - 1 tiles.  K % 32 == 0; C may be ragged.
template <int R>
__global__ void __launch_bounds__(256) residues_cols(const int* __restrict__ hi,
                                                     const int* __restrict__ lo,
                                                     int K, int C, int8_t* __restrict__ out) {
  __shared__ __align__(16) int8_t tile[R][32][36];  // [modulus][column][k], padded rows
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = c0 + tx;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int kk = ty + 8 * q;
    int h = 0, l = 0;
    if (c < C) {
      const size_t idx = (size_t)(k0 + kk) * C + c;
      h = hi[idx];
      l = lo[idx];
    }
#pragma unroll
    for (int i = 0; i < R; ++i) tile[i][tx][kk] = (int8_t)residue(h, l, modulus(i));
  }
  __syncthreads();
  const int tid = ty * 32 + tx;
  const int cc = tid >> 3, wq = tid & 7;  // 32 columns x 8 words of 4 k's
  if (c0 + cc < C) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const unsigned word = *reinterpret_cast<const unsigned*>(&tile[i][cc][4 * wq]);
      reinterpret_cast<unsigned*>(out + ((size_t)i * C + c0 + cc) * K + k0)[wq] = word;
    }
  }
}

// Garner digits and the output representation for `count` outputs whose
// balanced residues lie in cres (R, count) int8.  Outputs: f64 (count), ds f32
// (2, count) or digits int8 (R, count), each flat in the (M, N) order of cres.
template <int R>
__global__ void __launch_bounds__(256) garner_epilogue(const int8_t* __restrict__ cres,
                                                       int64_t count, int out_rep,
                                                       void* __restrict__ out,
                                                       const __grid_constant__ GarnerParams p) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < count;
       e += (int64_t)gridDim.x * blockDim.x) {
    int res[R], dig[R];
#pragma unroll
    for (int j = 0; j < R; ++j) res[j] = cres[j * count + e];
    garner_digits<R>(res, p, dig);
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

inline unsigned grid_for(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  return (unsigned)(blocks < 1 ? 1 : (blocks > (1 << 30) ? (1 << 30) : blocks));
}

// Stage 1 for the left operand: residues of (rows, K) into (r, rows, K).
inline cudaError_t launch_residues_rows(int r, const int* hi, const int* lo, int64_t n,
                                        int8_t* out, cudaStream_t s) {
  const int64_t n4 = n / 4;
  const unsigned grid = grid_for(n4, 256);
  switch (r) {
#define OZAKI_CASE(R_) \
  case R_: residues_rows<R_><<<grid, 256, 0, s>>>(hi, lo, n4, out); break;
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Stage 1 for the right operand: residues of (K, C) into (r, C, K).
inline cudaError_t launch_residues_cols(int r, const int* hi, const int* lo, int K, int C,
                                        int8_t* out, cudaStream_t s) {
  const dim3 grid(K / 32, (C + 31) / 32), block(32, 8);
  switch (r) {
#define OZAKI_CASE(R_) \
  case R_: residues_cols<R_><<<grid, block, 0, s>>>(hi, lo, K, C, out); break;
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Stage 3: Garner over `count` outputs.
inline cudaError_t launch_garner_epilogue(const int8_t* cres, int64_t count, int out_rep,
                                          void* out, const GarnerParams& p, cudaStream_t s) {
  const unsigned grid = grid_for(count, 256);
  switch (p.r) {
#define OZAKI_CASE(R_) \
  case R_: garner_epilogue<R_><<<grid, 256, 0, s>>>(cres, count, out_rep, out, p); break;
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace ozaki
