// Device code shared by the Ozaki-II Hopper kernels (ozaki_gemm.cu, ozaki_gemv.cu,
// ozaki_stencil.cu, ozaki_spmv.cu, ozaki_attention.cu): the moduli, the
// launch-parameter block, the balanced residues, the lazy Garner digits, the
// output representations and the cp.async wrappers.  The stages only the GEMM
// runs are in ozaki_product.cuh.
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
  double pref_f64_h[kMaxR];  // Veltkamp split of pref_f64 (2^27 + 1), as the plain
  double pref_f64_l[kMaxR];  // version splits the constant: digits_to_f64's ph_h, ph_l
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

// Balanced residue of an int64 v: v = hi32 * 2^32 + lo32 with lo32 unsigned.
__device__ __forceinline__ int bmod64(long long v, int m) {
  const int hi = (int)(v >> 32);
  const unsigned lo = (unsigned)v;
  const int c32 = (int)((1ull << 32) % (unsigned long long)m);
  return bmod(bmod(hi, m) * c32 + (int)(lo % (unsigned)m), m);
}

// Balanced mixed-radix digits (common.garner_digits) with the carries left
// unreduced: carry[l] sums at most 19 terms t_j * pref_mod[j][l] with |t_j| <=
// 128 and 0 <= pref_mod < 256, so it stays below 2^20, and with |res| < 2^20
// (a balanced residue, or any sum congruent to one) (res - carry) * inv_pref
// stays below 2^29.  Each digit is the balanced residue of a value congruent to
// common.garner_digits' argument, and the balanced residue is unique, so the
// digits are equal; one bmod per digit instead of R(R+1)/2.
template <int R>
__device__ __forceinline__ void garner_digits_lazy(const int (&res)[R], const GarnerParams& p,
                                                   int (&t)[R]) {
  int carry[R];
#pragma unroll
  for (int l = 0; l < R; ++l) carry[l] = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    t[j] = bmod((res[j] - carry[j]) * p.inv_pref[j], modulus(j));
#pragma unroll
    for (int l = j + 1; l < R; ++l) carry[l] += t[j] * p.pref_mod[j][l];
  }
}

// A modulus whose index is known only at run time, with what a multiply-high
// reduction needs; kModRT[j] is modulus(j)'s, built at compile time.
struct ModRT {
  int m, half_hi, half_lo;
  unsigned magic, k31;  // floor(2^32 / m); 2^31 mod m
  double inv;           // 1 / m, rounded
};

__host__ __device__ constexpr ModRT make_mod_rt(int m) {
  return ModRT{m, (m - 1) / 2, -(m / 2), (unsigned)(0x100000000ull / (unsigned)m),
               (1u << 31) % (unsigned)m, 1.0 / m};
}

static __constant__ ModRT kModRT[kMaxR] = {
    make_mod_rt(modulus(0)),  make_mod_rt(modulus(1)),  make_mod_rt(modulus(2)),
    make_mod_rt(modulus(3)),  make_mod_rt(modulus(4)),  make_mod_rt(modulus(5)),
    make_mod_rt(modulus(6)),  make_mod_rt(modulus(7)),  make_mod_rt(modulus(8)),
    make_mod_rt(modulus(9)),  make_mod_rt(modulus(10)), make_mod_rt(modulus(11)),
    make_mod_rt(modulus(12)), make_mod_rt(modulus(13)), make_mod_rt(modulus(14)),
    make_mod_rt(modulus(15)), make_mod_rt(modulus(16)), make_mod_rt(modulus(17)),
    make_mod_rt(modulus(18)), make_mod_rt(modulus(19))};

__device__ __forceinline__ ModRT mod_rt(int j) { return kModRT[j]; }

// bmod(v, M.m) without a division: v + 2^31 as an unsigned u, whose quotient
// estimate __umulhi(u, floor(2^32/m)) is floor(u/m) or one less, so one
// conditional subtraction gives u mod m; minus 2^31 mod m puts t in (-m, m),
// congruent to v, and bmod's fix-ups make it balanced.  Exact for every int32.
__device__ __forceinline__ int bmod_rt(int v, const ModRT& M) {
  const unsigned u = (unsigned)v ^ 0x80000000u;
  unsigned r = u - __umulhi(u, M.magic) * (unsigned)M.m;
  if (r >= (unsigned)M.m) r -= (unsigned)M.m;
  int t = (int)r - (int)M.k31;
  if (t > M.half_hi) {
    t -= M.m;
  } else if (t < M.half_lo) {
    t += M.m;
  }
  return t;
}

// (v + 2^31) mod M.m in [0, m) for any int32 v: bmod_rt without its balancing,
// half its operations.  v is congruent to the result minus 2^31 mod m (M.k31).
__device__ __forceinline__ unsigned umod_rt(int v, const ModRT& M) {
  const unsigned u = (unsigned)v ^ 0x80000000u;
  const unsigned r = u - __umulhi(u, M.magic) * (unsigned)M.m;
  return r >= (unsigned)M.m ? r - (unsigned)M.m : r;
}

// The balanced residue mod m of an integer-valued double z with |z| <= 2^53,
// in FP64: q = rint(z / m) by adding and subtracting 1.5 * 2^52 (|z / m| <
// 2^51), where z * fl(1/m) is within 2^53 / 151 * 2^-52 < 0.02 of z / m; then
// r = z - q m is exact (one fma of an integer result) and lies within one of
// the balanced range [-(m/2), (m-1)/2], read off the low word of r + 1.5 * 2^52
// and fixed up as in bmod.  Five FP64 operations where bmod(hi) * c + lo and a
// second bmod take ~20 integer ones, on another pipe.
__device__ __forceinline__ int bmod_f64(double z, int m, double inv, int half_hi, int half_lo) {
  const double kRound = 6755399441055744.0;  // 1.5 * 2^52
  const double q = (z * inv + kRound) - kRound;
  const double r = __fma_rn(-q, (double)m, z);
  int t = __double2loint(r + kRound);
  if (t > half_hi) {
    t -= m;
  } else if (t < half_lo) {
    t += m;
  }
  return t;
}

// common.residue(hi, lo, m) through FP64 for any int32 hi and lo (converted once by the
// caller): z = hi * (2^26 mod m) + lo is exact (|z| < 2^40) and congruent to
// hi * 2^26 + lo.  m a compile-time constant after unrolling.
__device__ __forceinline__ int residue_f64(double hi, double lo, int m) {
  const double z = __fma_rn(hi, (double)((1 << kSplitBits) % m), lo);
  return bmod_f64(z, m, 1.0 / m, (m - 1) / 2, -(m / 2));
}

// common.residue(hi, lo, m) for any int32 hi and lo, given also as doubles, with m a
// compile-time constant after unrolling: three FP64 and two integer operations,
// and no fix-up.  z = hi (2^26 mod m) + lo is exact in FP64 (|z| < 2^40) and
// congruent to hi 2^26 + lo.  y = z * fl(1/m) lies within 2^-19 of z / m, and
// for an odd m, z / m lies at least 1/(2m) > 2^-9 from a half-integer, so q =
// rint(y), read as the low word of y + 1.5 * 2^52 (q mod 2^32), is the nearest
// integer to z / m and z - q m is the balanced residue itself; it is small, so
// the int32 wrap-around of z's low word, hi (2^26 mod m) + lo, minus q m gives
// it exactly.  For m = 256 (the one even modulus) it is the signed low byte of
// lo: 2^26 is a multiple of 256, and the balanced range [-128, 127] is int8's.
__device__ __forceinline__ int residue_hilo(int hi, int lo, double hd, double ld, int m) {
  if (m == 256) return (int)(signed char)lo;
  const unsigned c = (1u << kSplitBits) % (unsigned)m;
  const double y = __fma_rn(hd, (double)c, ld) * (1.0 / m);
  const unsigned q = (unsigned)__double2loint(y + 6755399441055744.0);
  return (int)((unsigned)hi * c + (unsigned)lo - q * (unsigned)m);
}

// The low bytes of v0 .. v3 as one word, byte j from v_j (int8 residues packed
// for an int8 MMA operand or a plane store).
__device__ __forceinline__ unsigned pack4(int v0, int v1, int v2, int v3) {
  return __byte_perm(__byte_perm(v0, v1, 0x0040), __byte_perm(v2, v3, 0x0040), 0x5410);
}

// The residue table row of (hi, lo) pairs' integer x = hi * 2^26 + lo (or of an
// integer-valued double): the balanced residues mod moduli 0 .. R-1 as int8,
// four to a word, zero-padded to 4 * W words.
template <int R, int W>
__device__ __forceinline__ void residue_row(double hi, double lo, int (&w)[4 * W]) {
#pragma unroll
  for (int k = 0; k < 4 * W; ++k) w[k] = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) w[i / 4] |= (residue_f64(hi, lo, modulus(i)) & 0xff) << (8 * (i % 4));
}

// Sums of one row against a residue table (the SpMV's and single-row
// attention's contraction): H[i] += hi * xr_i and L[i] += lo * xr_i, 32 x 32 ->
// 64-bit multiply-adds, with xr_i the int8 residue i of a table row.  The
// balanced residue of (2^26 mod m_i) * H[i] + L[i] is that of the sum of
// residue products.
template <int R, int W>
__device__ __forceinline__ void accumulate_row(int hi, int lo, const int (&xw)[4 * W],
                                               long long (&H)[R], long long (&L)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int xr = (int)(signed char)(xw[i / 4] >> (8 * (i % 4)));
    H[i] += (long long)hi * xr;
    L[i] += (long long)lo * xr;
  }
}

// The balanced residues of the sums above.
template <int R>
__device__ __forceinline__ void fold_rows(const long long (&H)[R], const long long (&L)[R],
                                          int (&res)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = modulus(i);
    res[i] = bmod64(H[i] * ((1 << kSplitBits) % m) + L[i], m);
  }
}

// cp.async: global -> shared copies that bypass registers; a thread waits for
// its own groups, so a barrier must follow the wait before others read.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}
// 16 bytes, of which the first src_bytes (0 or 16) are read and the rest zeroed.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Compensated double-double Horner over the digits (common.digits_to_f64); the
// constant's split comes from the host, computed as the plain version does.
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
    const double ph_h = p.pref_f64_h[j];
    const double ph_l = p.pref_f64_l[j];
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
