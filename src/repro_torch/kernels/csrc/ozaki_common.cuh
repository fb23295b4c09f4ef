// Device code shared by the Ozaki-II Hopper kernels (ozaki_gemm.cu, ozaki_gemv.cu).
//
// Both kernels run the same three stages as the TPU kernels' single grid:
//   1. residues: (hi, lo) int32 operands -> balanced int8 residue planes, one per
//      modulus (residues_rows for the left operand, residues_cols for the right
//      one, transposed so that the contraction index is contiguous);
//   2. the modular products: int32 sums of int8 products per modulus, reduced to
//      balanced residues (gemm_modprod / gemv_modprod, in the .cu files);
//   3. garner_epilogue: balanced Garner digits and the output representation.
// Every step repeats a plain torch function of repro_torch/kernels/common.py op
// for op.  The build passes --fmad=false so that the Veltkamp two_prod and the
// Knuth two_sum of the epilogue are never contracted into FMAs: a kernel's
// output is bitwise equal to its plain version on the same card.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ozaki {

constexpr int kMaxR = 20;
constexpr int kSplitBits = 26;

// repro_torch.core.moduli.DEFAULT_MODULI.  The wrappers check that a plan's
// moduli are its first r entries, so after unrolling every modulus is a
// compile-time constant and `%` compiles to a multiply-high.
__host__ __device__ constexpr int modulus(int i) {
  switch (i) {
    case 0: return 256;  case 1: return 251;  case 2: return 241;  case 3: return 239;
    case 4: return 233;  case 5: return 229;  case 6: return 227;  case 7: return 223;
    case 8: return 211;  case 9: return 199;  case 10: return 197; case 11: return 193;
    case 12: return 191; case 13: return 181; case 14: return 179; case 15: return 173;
    case 16: return 167; case 17: return 163; case 18: return 157; default: return 151;
  }
}

// Launch-parameter block: the plan's moduli and Garner constants
// (repro_torch.core.moduli.garner_constants).  Mirrored by
// repro_torch.kernels._build.GarnerParams; passed by value as a
// __grid_constant__ kernel parameter (2.2 KB of the 4 KB parameter space).
struct GarnerParams {
  int r;
  int moduli[kMaxR];
  int inv_pref[kMaxR];
  int pref_mod[kMaxR][kMaxR];
  double pref_f64[kMaxR];
  double pref_f64_lo[kMaxR];
  float pref_f32[kMaxR];
  float pref_f32_lo[kMaxR];
};

enum OutRep { kOutF64 = 0, kOutDigits = 1, kOutDs = 2 };

// Balanced representative of v mod m, in [-(m/2), (m-1)/2] (common.balanced_mod).
// C's % truncates toward zero, so t lies in (-m, m) and one fix-up either side
// gives the balanced value for negative v as well.
__device__ __forceinline__ int bmod(int v, int m) {
  int t = v % m;
  if (t > (m - 1) / 2) {
    t -= m;
  } else if (t < -(m / 2)) {
    t += m;
  }
  return t;
}

// Balanced residue of x = hi * 2^26 + lo (common.residue).  hi is reduced first
// so that hi * (2^26 mod m) + lo stays inside int32 (|lo| <= 2^25); the balanced
// residue of x is unique, so the bits equal the plain version's.
__device__ __forceinline__ int residue(int hi, int lo, int m) {
  return bmod(bmod(hi, m) * ((1 << kSplitBits) % m) + lo, m);
}

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

// Balanced mixed-radix digits from the balanced residues (common.garner_digits).
template <int R>
__device__ __forceinline__ void garner_digits(const int (&res)[R], const GarnerParams& p,
                                              int (&t)[R]) {
  int carry[R];
#pragma unroll
  for (int l = 0; l < R; ++l) carry[l] = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    t[j] = bmod((res[j] - carry[j]) * p.inv_pref[j], modulus(j));
#pragma unroll
    for (int l = j + 1; l < R; ++l) {
      carry[l] = bmod(carry[l] + t[j] * p.pref_mod[j][l], modulus(l));
    }
  }
}

// Compensated double-double Horner over the digits (common.digits_to_f64).
template <int R>
__device__ __forceinline__ double digits_to_f64(const int (&t)[R], const GarnerParams& p) {
  const double split = 134217729.0;  // 2^27 + 1
  double out = 0.0, comp = 0.0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
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
    comp = comp + ((out - (s - v)) + (pr - v)) + e;
    out = s;
  }
  return out + comp;
}

// Double-single (f32, f32) Horner over the digits (common.digits_to_ds).
template <int R>
__device__ __forceinline__ void digits_to_ds(const int (&t)[R], const GarnerParams& p,
                                             float& hi_out, float& lo_out) {
  const float split = 4097.0f;  // 2^12 + 1
  float hi = 0.0f, lo = 0.0f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float tf = (float)t[j];
    const float ph = p.pref_f32[j];
    const float pr = tf * ph;
    const float c1 = split * tf;
    const float tf_h = c1 - (c1 - tf);
    const float tf_l = tf - tf_h;
    const float c2 = split * ph;
    const float ph_h = c2 - (c2 - ph);
    const float ph_l = ph - ph_h;
    float e = ((tf_h * ph_h - pr) + tf_h * ph_l + tf_l * ph_h) + tf_l * ph_l;
    e = e + tf * p.pref_f32_lo[j];
    const float s = hi + pr;
    const float v = s - hi;
    lo = lo + ((hi - (s - v)) + (pr - v)) + e;
    hi = s;
  }
  const float s = hi + lo;
  lo_out = lo - (s - hi);
  hi_out = s;
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

#define OZAKI_FOR_EACH_R(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) \
  F(11) F(12) F(13) F(14) F(15) F(16) F(17) F(18) F(19) F(20)

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
