// stencil7 for Hopper (sm_90a): the 7-point stencil v = S[c] u of a float64
// grid with a zero halo, emulated exactly: one global power-of-two scale each
// for u and c, the (hi, lo) split, the residues over the plan's moduli, seven
// residue products per modulus, Garner, and the f64, ds or digits output.
//
// Replaces the TPU kernel repro/kernels/ozaki_stencil.py::stencil7 (body
// _stencil_kernel, pallas_call at line 144).  It computes what that kernel
// computes with its Phase 1 fused in, not the TPU's blocking: there a program
// holds whole X x Y planes of a z-slab and its two neighbouring slabs in VMEM.
//
// Bound on the H100.  Bytes: u read once and the f64 output written once, 16 B
// a point at 3.35 TB/s (256^3: 268,435,456 B, 0.080 ms).  Operations: the
// epilogue is the plain version's compensated Horner, 23 FP64 operations a
// digit, none of them fusable (--fmad=false keeps its roundings); 7 of them
// split an 8-bit digit, whose split is exact (low half 0), so the bits need 16
// a digit, plus ~8 of Phase 1 and the unscale: 16 r + 8 a point, 248 at r =
// 15, 4.1 G at 256^3.  The FP64 pipe issues 132 SMs x 64 lanes x 1.98 GHz =
// 16.7 T of them a second (34 TFLOP/s counts an FMA as two), so ~0.25 ms (the
// 23 r + 8 = 353 this kernel issues: ~0.35 ms): the FP64 operations, not the
// bytes, bound this kernel.  The integer work (residues, the contraction,
// Garner) runs on other pipes beside them.
//
// Design.
//   1. Phase 1 fused.  The wrapper takes one amax pass over u and floor(log2)
//      of the two absolute maxima in torch (on the card, no host sync).  Every
//      block derives from them the shifts and the too-big guard (the maximum of
//      |ldexp(u_i)| is ldexp of the maximum: ldexp rounds once and is
//      monotone), the residues of the seven scaled coefficients, and per
//      element repeats splitting.ldexp, the x0.5, rint and split_hi_lo op for
//      op.  u is read as float64, 8 B a point, as many as its (hi, lo) pair.
//   2. Residues once a point.  A block of bz x by threads owns a bz x by tile
//      of the (y, z) plane and marches along X over bx planes.  At each step
//      it forms the residues of plane x + 1 for its tile and the tile's edge
//      halo (2 bz + 2 by points; no corners) into one of three shared-memory
//      planes; a thread keeps its own column's residues at x - 1, x and x + 1
//      in registers and reads the plane's +-y and +-z neighbours from shared
//      memory.  One barrier a step: a plane is rewritten three steps after it
//      was filled.  u of plane x + 2 is loaded a step ahead.
//   3. Residues four to a word (int8 lanes).  Per modulus the seven products
//      are two __dp4a: the words of the seven neighbours are byte-transposed
//      (__byte_perm) so that one word holds one modulus of four neighbours.
//      The sums (|acc| <= 7 * 128^2) go unreduced into garner_digits_lazy: a
//      digit is the balanced residue of a value congruent to the plain
//      version's, so the digits are equal.
//   4. Residues on the FP64 pipe (residue_hilo: three FP64 and two integer
//      operations, the doubles of hi and lo are those of the split), beside
//      the integer pipe's Garner; the balanced residue is unique.
//   5. The epilogue is digits_to_f64 (with the constant's split from the host)
//      and, for f64, the unscale ldexp(v, -shift); ds and digits leave the
//      unscale to the wrapper, which reads the shift the first block writes.
// Every integer step is exact, and the float steps are the plain version's, so
// the result depends on neither the block nor bx.  A neighbour past a global
// face reads u = 0, whose residues are 0: the zero halo.
#include "ozaki_common.cuh"

namespace ozaki {

constexpr int kStencilMaxThreads = 256;
// Two blocks an SM: the register cap (128) this sets is worth the few spills,
// the latency of the Garner and Horner chains needs the second block's warps.
constexpr int kStencilMinBlocks = 2;

// splitting.exact_pow2 for float64: 2^e from bit fields, exact over the whole
// range, 0 below the smallest denormal, inf above the largest finite power.
__device__ __forceinline__ double exact_pow2_f64(int e) {
  e = max(-1075, min(e, 1024));
  long long bits = 0;
  if (e > -1023) {
    bits = (long long)(e + 1023) << 52;
  } else if (e >= -1074) {
    bits = 1ll << (e + 1074);
  }
  return __longlong_as_double(bits);
}

// splitting.ldexp: x * 2^n with one rounding (frexp, the e > 0 fix-up, one
// multiply by an exact power of two); zeros and infinities pass through.
__device__ __forceinline__ double ldexp_ref(double x, int n) {
  int e;
  double m = frexp(x, &e);
  e += n;
  if (e > 0) {
    m = m * 2.0;
    e -= 1;
  }
  const double y = m * exact_pow2_f64(e);
  return (isinf(x) || x == 0.0) ? x : y;
}

// One element of Phase 1 (ozaki_stencil._global_scale_to_int, then
// splitting.split_hi_lo): the scaled integer's halves as doubles.  x * 2^-26 is
// x / 2^26 exactly.
__device__ __forceinline__ void scale_split(double x, int shift, bool too_big, double& hd,
                                            double& ld) {
  double y = ldexp_ref(x, shift);
  if (too_big) y = y * 0.5;
  const double xi = rint(y);
  hd = rint(xi * 1.4901161193847656e-08);
  ld = xi - hd * 67108864.0;
}

// The residues of one grid value, mod moduli 0 .. R-1, four to a word.
template <int R>
__device__ __forceinline__ void residue_words(double x, int shift, bool too_big,
                                              int (&w)[(R + 3) / 4]) {
  constexpr int W = (R + 3) / 4;
  double hd, ld;
  scale_split(x, shift, too_big, hd, ld);
  const int hi = (int)hd, lo = (int)ld;
  int r[4 * W];
#pragma unroll
  for (int i = 0; i < 4 * W; ++i) {
    r[i] = i < R ? residue_hilo(hi, lo, hd, ld, modulus(i)) : 0;
  }
#pragma unroll
  for (int g = 0; g < W; ++g) w[g] = pack4(r[4 * g], r[4 * g + 1], r[4 * g + 2], r[4 * g + 3]);
}

// Byte transpose: t[k] holds byte k of w0, w1, w2, w3 in its bytes 0 .. 3.
__device__ __forceinline__ void transpose4(int w0, int w1, int w2, int w3, int (&t)[4]) {
  const int a = __byte_perm(w0, w1, 0x5140), b = __byte_perm(w0, w1, 0x7362);
  const int c = __byte_perm(w2, w3, 0x5140), d = __byte_perm(w2, w3, 0x7362);
  t[0] = __byte_perm(a, c, 0x5410);
  t[1] = __byte_perm(a, c, 0x7632);
  t[2] = __byte_perm(b, d, 0x5410);
  t[3] = __byte_perm(b, d, 0x7632);
}

// u (X, Y, Z) float64 and c (7,) float64 [centre, -x, +x, -y, +y, -z, +z];
// absmax (2,) the absolute maxima of u and c, elog (2,) int32 floor(log2) of
// each (1 for a zero maximum), as the wrapper computes them.  out: f64 (X, Y,
// Z) unscaled, ds f32 (2, X, Y, Z) or digits int8 (R, X, Y, Z) of the scaled
// integer stencil; shift_out (if not null) gets the total shift.
template <int R>
__global__ void __launch_bounds__(kStencilMaxThreads, kStencilMinBlocks) stencil7_kernel(
    const double* __restrict__ u, const double* __restrict__ c,
    const double* __restrict__ absmax, const int* __restrict__ elog, int payload, int X,
    int Y, int Z, int bx, int out_rep, void* __restrict__ out, int* __restrict__ shift_out,
    const __grid_constant__ GarnerParams p) {
  constexpr int W = (R + 3) / 4;
  extern __shared__ int planes[];     // [3][W][NP]: residue words of three planes
  __shared__ int cw[2 * kMaxR];       // coefficient residues, [i][centre..-y], [i][+y..+z, 0]
  const int bz = blockDim.x, by = blockDim.y, tz = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * bz + tz;
  const int TW = bz + 2, NP = TW * (by + 2);

  // Phase 1's scalars (_global_scale_to_int), in every block.
  const int sh_u = (payload - 1) - elog[0], sh_c = (payload - 1) - elog[1];
  const double lim = exact_pow2_f64(payload);
  const bool tb_u = ldexp_ref(absmax[0], sh_u) >= lim;
  const bool tb_c = ldexp_ref(absmax[1], sh_c) >= lim;
  const int total = (sh_u - (int)tb_u) + (sh_c - (int)tb_c);
  if (tid < 8) {
    signed char* cb = reinterpret_cast<signed char*>(cw);
    double hd = 0.0, ld = 0.0;
    if (tid < 7) scale_split(c[tid], sh_c, tb_c, hd, ld);
    const int hi = (int)hd, lo = (int)ld;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      cb[8 * i + tid] = (signed char)residue_hilo(hi, lo, hd, ld, modulus(i));
    }
  }
  if (shift_out != nullptr && tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0) {
    *shift_out = total;
  }

  const int y0 = blockIdx.y * by, z0 = blockIdx.x * bz;
  const int xa = blockIdx.z * bx, xb = min(X, xa + bx);
  const int64_t sx = (int64_t)Y * Z;
  const int own_y = y0 + ty, own_z = z0 + tz;
  const bool own_in = own_y < Y && own_z < Z;
  const int64_t own_off = (int64_t)own_y * Z + own_z;
  const int own_p = (ty + 1) * TW + tz + 1;
  // This thread's halo point, if any: the rows above and below the tile, then
  // the columns either side of it.
  const int NH = 2 * bz + 2 * by;
  const bool has_h = tid < NH;
  int hty = 0, htz = 0;
  if (tid < bz) {
    htz = tid + 1;
  } else if (tid < 2 * bz) {
    hty = by + 1;
    htz = tid - bz + 1;
  } else {
    hty = 1 + (tid - 2 * bz) / 2;
    htz = ((tid - 2 * bz) & 1) ? bz + 1 : 0;
  }
  const int hy = y0 + hty - 1, hz = z0 + htz - 1;
  const bool h_in = has_h && hy >= 0 && hy < Y && hz >= 0 && hz < Z;
  const int64_t h_off = h_in ? (int64_t)hy * Z + hz : 0;
  const int h_p = hty * TW + htz;

  auto load = [&](int x, bool in, int64_t off) -> double {
    return (in && x >= 0 && x < X) ? __ldg(u + x * sx + off) : 0.0;
  };
  auto store = [&](int buf, int pt, const int (&w)[W]) {
#pragma unroll
    for (int g = 0; g < W; ++g) planes[(buf * W + g) * NP + pt] = w[g];
  };
  auto fetch = [&](int buf, int pt, int (&w)[W]) {
#pragma unroll
    for (int g = 0; g < W; ++g) w[g] = planes[(buf * W + g) * NP + pt];
  };

  __syncthreads();  // cw
  int cwr[2 * R];
#pragma unroll
  for (int i = 0; i < 2 * R; ++i) cwr[i] = cw[i];

  int rm[W], rc[W], rp[W];
  residue_words<R>(load(xa - 1, own_in, own_off), sh_u, tb_u, rm);
  residue_words<R>(load(xa, own_in, own_off), sh_u, tb_u, rc);
  int bc = xa % 3;
  store(bc, own_p, rc);
  if (has_h) {
    int hw[W];
    residue_words<R>(load(xa, h_in, h_off), sh_u, tb_u, hw);
    store(bc, h_p, hw);
  }
  double u_own = load(xa + 1, own_in, own_off);
  double u_h = load(xa + 1, h_in, h_off);
  const int64_t count = (int64_t)X * sx;

  for (int x = xa; x < xb; ++x) {
    const int bn = bc == 2 ? 0 : bc + 1;
    // (a) plane x + 1, and u of plane x + 2 on its way
    const double un = u_own, uh = u_h;
    u_own = load(x + 2, own_in, own_off);
    u_h = load(x + 2, h_in, h_off);
    residue_words<R>(un, sh_u, tb_u, rp);
    store(bn, own_p, rp);
    if (has_h) {
      int hw[W];
      residue_words<R>(uh, sh_u, tb_u, hw);
      store(bn, h_p, hw);
    }
    __syncthreads();
    // (b) the point (x, own_y, own_z)
    if (own_in) {
      int ym[W], yp[W], zm[W], zq[W];
      fetch(bc, own_p - TW, ym);
      fetch(bc, own_p + TW, yp);
      fetch(bc, own_p - 1, zm);
      fetch(bc, own_p + 1, zq);
      int acc[R];
#pragma unroll
      for (int g = 0; g < W; ++g) {
        int ta[4], tb[4];
        transpose4(rc[g], rm[g], rp[g], ym[g], ta);
        transpose4(yp[g], zm[g], zq[g], 0, tb);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int i = 4 * g + k;
          if (i < R) acc[i] = __dp4a(ta[k], cwr[2 * i], __dp4a(tb[k], cwr[2 * i + 1], 0));
        }
      }
      int dig[R];
      garner_digits_lazy<R>(acc, p, dig);
      const int64_t e = x * sx + own_off;
      if (out_rep == kOutF64) {
        static_cast<double*>(out)[e] = ldexp_ref(digits_to_f64<R>(dig, p), -total);
      } else if (out_rep == kOutDs) {
        float hi, lo;
        digits_to_ds<R>(dig, p, hi, lo);
        static_cast<float*>(out)[e] = hi;
        static_cast<float*>(out)[count + e] = lo;
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) static_cast<int8_t*>(out)[j * count + e] = (int8_t)dig[j];
      }
    }
#pragma unroll
    for (int g = 0; g < W; ++g) {
      rm[g] = rc[g];
      rc[g] = rp[g];
    }
    bc = bn;
  }
}

template <int R>
cudaError_t launch(const double* u, const double* c, const double* absmax, const int* elog,
                   int payload, int X, int Y, int Z, int bz, int by, int bx, int out_rep,
                   void* out, int* shift_out, const GarnerParams& p, cudaStream_t s) {
  constexpr int W = (R + 3) / 4;
  const dim3 grid((Z + bz - 1) / bz, (Y + by - 1) / by, (X + bx - 1) / bx), block(bz, by);
  const size_t smem = sizeof(int) * 3 * W * (size_t)(bz + 2) * (by + 2);
  stencil7_kernel<R><<<grid, block, smem, s>>>(u, c, absmax, elog, payload, X, Y, Z, bx,
                                                out_rep, out, shift_out, p);
  return cudaGetLastError();
}

}  // namespace ozaki

using ozaki::GarnerParams;

// C interface, loaded with ctypes.  u (X, Y, Z) and c (7) float64, contiguous;
// absmax (2) float64 and elog (2) int32 on the card; a block of bz x by threads
// (at most 256, with 2 bz + 2 by <= bz by), bx planes a block, ceil(Y / by) and
// ceil(X / bx) at most 65535.  out: f64 (X, Y, Z), digits int8 (r, X, Y, Z) or
// ds f32 (2, X, Y, Z) by out_rep; shift_out an int32 on the card, or null.
// Launches on `stream`, never synchronises, returns the first CUDA error (0 on
// success).
extern "C" int ozaki_stencil7(int device, const double* u, const double* c,
                              const double* absmax, const int* elog, int payload_bits, int X,
                              int Y, int Z, int bz, int by, int bx, int out_rep, void* out,
                              int* shift_out, const GarnerParams* params, void* stream) {
  const GarnerParams& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bz < 1 || by < 1 || bx < 1 || bz * by > ozaki::kStencilMaxThreads ||
      2 * bz + 2 * by > bz * by) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (X == 0 || Y == 0 || Z == 0) return cudaSuccess;
  switch (p.r) {
#define OZAKI_CASE(R_)                                                                    \
  case R_:                                                                                \
    return ozaki::launch<R_>(u, c, absmax, elog, payload_bits, X, Y, Z, bz, by, bx,       \
                             out_rep, out, shift_out, p, s);
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
}
