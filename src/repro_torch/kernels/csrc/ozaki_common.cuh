// Device code shared by the Ozaki-II Hopper kernels (ozaki_gemm.cu, ozaki_gemv.cu,
// ozaki_stencil.cu, ozaki_spmv.cu): the moduli, the launch-parameter block, the
// balanced residues, the Garner digits and the output representations.  The
// stages only the GEMM and GEMV run are in ozaki_product.cuh.
//
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

#define OZAKI_FOR_EACH_R(F) \
  F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9) F(10) \
  F(11) F(12) F(13) F(14) F(15) F(16) F(17) F(18) F(19) F(20)

}  // namespace ozaki
