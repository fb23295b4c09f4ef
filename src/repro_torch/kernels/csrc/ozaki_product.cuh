// The residue and Garner stages of the Ozaki-II GEMM (ozaki_gemm.cu).
//
// The GEMM runs three stages where the TPU kernel runs one grid:
//   1. residues: (hi, lo) int32 operands -> balanced int8 residue planes, one per
//      modulus (residues_rows for the left operand, residues_cols for the right
//      one, transposed so that the contraction index is contiguous: the K-major
//      layout that integer wgmma needs for both operands);
//   2. the modular products (gemm_product, in ozaki_gemm.cu);
//   3. garner_epilogue: Garner digits and the output representation.
// Bound: stage 1 reads the 8-byte (hi, lo) words once and writes r bytes per
// element (3 GiB of traffic at 8192^2, r = 16: ~1 ms at 3.35 TB/s); each
// residue is residue_hilo, three FP64 and two integer operations (the signed
// low byte of lo for m = 256), where the integer residue took ~20.  Stage 3
// reads r bytes and writes the output per element; its compensated f64
// Horner, ~23 FP64 operations per digit, bounds it.  Its digits are
// garner_digits_lazy's: one reduction per digit, equal to the fully reduced
// ones.  The float steps are the plain version's operations in its order
// (--fmad=false).
#pragma once

#include "ozaki_common.cuh"

namespace ozaki {

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
    const double h0 = h.x, h1 = h.y, h2 = h.z, h3 = h.w;
    const double l0 = l.x, l1 = l.y, l2 = l.z, l3 = l.w;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = modulus(i);
      words[i * n4 + w] =
          pack4(residue_hilo(h.x, l.x, h0, l0, m), residue_hilo(h.y, l.y, h1, l1, m),
                residue_hilo(h.z, l.z, h2, l2, m), residue_hilo(h.w, l.w, h3, l3, m));
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
    const double hd = h, ld = l;
#pragma unroll
    for (int i = 0; i < R; ++i) tile[i][tx][kk] = (int8_t)residue_hilo(h, l, hd, ld, modulus(i));
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
// residues lie in cres (R, count) uint8 as gemm_product stores them, (sum +
// 2^31) mod m: the sum is congruent to that minus 2^31 mod m, a value in (-m,
// m), which garner_digits_lazy takes as it takes a balanced residue (|res| <=
// 256 keeps its products inside int32) and whose digits are the same, since a
// digit is the balanced residue of a congruent value.  Outputs: f64 (count),
// ds f32 (2, count) or digits int8 (R, count), each flat in the (M, N) order.
// A persistent grid: each thread loads the next output's R residues before it
// works on the current one, so that the loads of one overlap the arithmetic of
// the other.
template <int R>
__global__ void __launch_bounds__(256) garner_epilogue(const uint8_t* __restrict__ cres,
                                                       int64_t count, int out_rep,
                                                       void* __restrict__ out,
                                                       const __grid_constant__ GarnerParams p) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  int next[R];
  if (e < count) {
#pragma unroll
    for (int j = 0; j < R; ++j) next[j] = __ldg(cres + j * count + e);
  }
  for (; e < count; e += stride) {
    int res[R], dig[R];
#pragma unroll
    for (int j = 0; j < R; ++j) res[j] = next[j] - (int)((1u << 31) % (unsigned)modulus(j));
    if (e + stride < count) {
#pragma unroll
      for (int j = 0; j < R; ++j) next[j] = __ldg(cres + j * count + e + stride);
    }
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

// Stage 3: Garner over `count` outputs, on as many blocks as fit the card at once.
template <int R>
inline cudaError_t launch_garner_r(const uint8_t* cres, int64_t count, int out_rep, void* out,
                                   const GarnerParams& p, cudaStream_t s) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, garner_epilogue<R>, 256, 0);
  }
  if (err != cudaSuccess) return err;
  const unsigned need = grid_for(count, 256);
  const unsigned fit = (unsigned)(sms * (per_sm > 0 ? per_sm : 1));
  garner_epilogue<R><<<need < fit ? need : fit, 256, 0, s>>>(cres, count, out_rep, out, p);
  return cudaGetLastError();
}

inline cudaError_t launch_garner_epilogue(const uint8_t* cres, int64_t count, int out_rep,
                                          void* out, const GarnerParams& p, cudaStream_t s) {
  switch (p.r) {
#define OZAKI_CASE(R_) \
  case R_: return launch_garner_r<R_>(cres, count, out_rep, out, p, s);
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ozaki
