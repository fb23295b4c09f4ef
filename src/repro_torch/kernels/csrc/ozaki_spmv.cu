// spmv_bell for Hopper (sm_90a): y~ = A~ x~ exactly for A in Blocked-ELL form,
// from the (hi, lo) int32 split of the row-scaled values of A and of the
// globally scaled x, rebuilt by Garner into f64, ds or digits.
//
// Replaces the TPU kernel repro/kernels/ozaki_spmv.py::spmv_bell (body
// _spmv_kernel, pallas_call at line 160).  The TPU kernel keeps all of x's
// (hi, lo) resident in VMEM (ozaki_spmv.py:9-11); here the gather reads x from
// global memory through the read-only path and L2: at HPCG's 104^3 grid x's
// (hi, lo) is 9 MB, well inside the H100's 50 MB L2.
//
// Bound on the H100: the bytes the function must move, each read once: A's
// (hi, lo) and its int32 columns (12 B per slot), x's (hi, lo) (8 B per
// element) and the f64 output (8 B per row), at 3.35 TB/s (HPCG 104^3, bw = 27:
// 382,453,760 B, ~0.114 ms).  Its 2 * bw * r int8 operations per row would take
// microseconds at the int8 rate, so the bound is the bytes.
//
// Design.  The contraction is bw long per row and has no reuse of A, so it runs
// on the CUDA cores with no MMA: one thread per row, blocks of br rows.  A
// thread walks its row's slots; per slot it takes the balanced residues of the
// value and of the gathered x for every modulus and adds their product to that
// modulus's int32 accumulator, reduced to a balanced residue every 2^16 slots
// (|product| <= 2^14), so any bw is exact; the balanced residue is unique, so the
// bits are those of the plain version's int64 row sums.  Then Garner and the
// output representation.  The residues cost 2 * r * ~20 integer operations per
// slot, which, not the bytes, is what limits this first version: each x_j's
// residues are recomputed by every row that reads it (27 times in HPCG's
// operator), and consecutive threads read A with a stride of bw words, not
// consecutive words.
#include "ozaki_common.cuh"

namespace ozaki {

constexpr int kSpmvMaxRows = 256;         // rows (threads) per block
constexpr int kSpmvReduceEvery = 1 << 16;  // slots between reductions

// a_hi/a_lo/cols (M, bw) int32, x_hi/x_lo (N,) int32, every column in 0..N-1.
// out: f64 (M), ds f32 (2, M) or digits int8 (R, M).
template <int R>
__global__ void __launch_bounds__(kSpmvMaxRows) spmv_kernel(
    const int* __restrict__ a_hi, const int* __restrict__ a_lo,
    const int* __restrict__ cols, const int* __restrict__ x_hi,
    const int* __restrict__ x_lo, int M, int bw, int out_rep, void* __restrict__ out,
    const __grid_constant__ GarnerParams p) {
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= M) return;
  const int64_t base = row * bw;

  int acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;
  int steps = 0;
  for (int j = 0; j < bw; ++j) {
    const int ah = __ldg(a_hi + base + j), al = __ldg(a_lo + base + j);
    const int c = __ldg(cols + base + j);
    const int xh = __ldg(x_hi + c), xl = __ldg(x_lo + c);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int m = modulus(i);
      acc[i] += residue(ah, al, m) * residue(xh, xl, m);
    }
    if (++steps == kSpmvReduceEvery) {
      steps = 0;
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = bmod(acc[i], modulus(i));
    }
  }

  int res[R], dig[R];
#pragma unroll
  for (int i = 0; i < R; ++i) res[i] = bmod(acc[i], modulus(i));
  garner_digits<R>(res, p, dig);
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

}  // namespace ozaki

using ozaki::GarnerParams;

// C interface, loaded with ctypes.  a_hi/a_lo/cols (M, bw) int32 and x_hi/x_lo
// (N,) int32, contiguous, every column index in 0..N-1 (checked by the caller);
// br rows per block, 1..256.  out: f64 (M), digits int8 (r, M) or ds f32 (2, M)
// by out_rep.  Launches on `stream`, never synchronises, returns the first CUDA
// error (0 on success).
extern "C" int ozaki_spmv_hilo(int device, const int* a_hi, const int* a_lo, const int* cols,
                               const int* x_hi, const int* x_lo, int M, int bw, int br,
                               int out_rep, void* out, const GarnerParams* params,
                               void* stream) {
  const GarnerParams& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (br < 1 || br > ozaki::kSpmvMaxRows) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M == 0) return cudaSuccess;
  const unsigned grid = (unsigned)(((int64_t)M + br - 1) / br);
  switch (p.r) {
#define OZAKI_CASE(R_)                                                                   \
  case R_:                                                                               \
    ozaki::spmv_kernel<R_><<<grid, br, 0, s>>>(a_hi, a_lo, cols, x_hi, x_lo, M, bw,     \
                                               out_rep, out, p);                        \
    break;
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
