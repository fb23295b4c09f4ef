// stencil7 for Hopper (sm_90a): the exact 7-point stencil v~ = S[c~] u~ of a
// globally scaled grid, from the (hi, lo) int32 split of u~ and the residues of
// the scaled coefficients c~, rebuilt by Garner into f64, ds or digits.
//
// Replaces the TPU kernel repro/kernels/ozaki_stencil.py::stencil7 (body
// _stencil_kernel, pallas_call at line 144).  It computes what that kernel
// computes, not the TPU's blocking: there a program holds whole X x Y planes of
// a z-slab and its two neighbouring slabs in VMEM.
//
// Bound on the H100: 16 bytes per point, the 8 of u's (hi, lo) read once and
// the 8 of the f64 output written once, at 3.35 TB/s (256^3: 268,435,456 B,
// ~0.080 ms).  Its 7 int8 products per point and modulus (2 * 7 * r operations)
// would take microseconds at the int8 rate, so the bound is the bytes.
//
// Design.  The contraction is 7 terms long, too short for an MMA, so it runs on
// the CUDA cores: one thread per grid point, blocks of bz threads along z by by
// threads along y, grid (ceil(Z / bz), ceil(Y / by), X).  Z is the fastest axis
// of u, so consecutive threads read consecutive words.  A thread loads the
// (hi, lo) of its point and of its six neighbours (a neighbour past a global
// face is the zero halo), and per modulus takes the seven balanced residues,
// their products with the coefficients' residues (from shared memory) and one
// balanced reduction; then Garner and the output representation.  It masks the
// ragged edge itself: there is no padding, and the result does not depend on
// the block.  The residues cost 7 * r * ~20 integer operations per point, which,
// not the bytes, is what limits this first version; each neighbour's residues
// are recomputed by all seven points that read it.  Halo'd shared-memory tiles
// and marching along X would compute them once.
#include "ozaki_common.cuh"

namespace ozaki {

constexpr int kStencilMaxThreads = 256;

// u_hi/u_lo (X, Y, Z) int32; c_res (R, 7) int32 balanced residues of the
// coefficients [centre, -x, +x, -y, +y, -z, +z].  out: f64 (X, Y, Z), ds f32
// (2, X, Y, Z) or digits int8 (R, X, Y, Z).
template <int R>
__global__ void __launch_bounds__(kStencilMaxThreads) stencil7_kernel(
    const int* __restrict__ u_hi, const int* __restrict__ u_lo,
    const int* __restrict__ c_res, int X, int Y, int Z, int out_rep,
    void* __restrict__ out, const __grid_constant__ GarnerParams p) {
  __shared__ int cs[R * 7];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < R * 7; i += blockDim.x * blockDim.y) cs[i] = c_res[i];
  __syncthreads();

  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= Z || y >= Y) return;
  const int64_t sy = Z, sx = (int64_t)Y * Z;
  const int64_t e = x * sx + y * sy + z;

  // [centre, -x, +x, -y, +y, -z, +z]; a neighbour outside the grid is 0.
  const bool inside[7] = {true, x > 0, x < X - 1, y > 0, y < Y - 1, z > 0, z < Z - 1};
  const int64_t offset[7] = {0, -sx, sx, -sy, sy, -1, 1};
  int h[7], l[7];
#pragma unroll
  for (int d = 0; d < 7; ++d) {
    h[d] = inside[d] ? __ldg(u_hi + e + offset[d]) : 0;
    l[d] = inside[d] ? __ldg(u_lo + e + offset[d]) : 0;
  }

  int res[R], dig[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = modulus(i);
    int acc = 0;  // |acc| <= 7 * 128 * 128
#pragma unroll
    for (int d = 0; d < 7; ++d) acc += cs[i * 7 + d] * residue(h[d], l[d], m);
    res[i] = bmod(acc, m);
  }
  garner_digits<R>(res, p, dig);

  const int64_t count = (int64_t)X * sx;
  if (out_rep == kOutF64) {
    static_cast<double*>(out)[e] = digits_to_f64<R>(dig, p);
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

}  // namespace ozaki

using ozaki::GarnerParams;

// C interface, loaded with ctypes.  u_hi/u_lo (X, Y, Z) int32 and c_res (r, 7)
// int32, contiguous; a block of bz x by threads (at most 256), X and
// ceil(Y / by) at most 65535.  out: f64 (X, Y, Z), digits int8 (r, X, Y, Z) or
// ds f32 (2, X, Y, Z) by out_rep.  Launches on `stream`, never synchronises,
// returns the first CUDA error (0 on success).
extern "C" int ozaki_stencil_hilo(int device, const int* u_hi, const int* u_lo,
                                  const int* c_res, int X, int Y, int Z, int bz, int by,
                                  int out_rep, void* out, const GarnerParams* params,
                                  void* stream) {
  const GarnerParams& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bz < 1 || by < 1 || bz * by > ozaki::kStencilMaxThreads) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (X == 0 || Y == 0 || Z == 0) return cudaSuccess;
  const dim3 grid((Z + bz - 1) / bz, (Y + by - 1) / by, X), block(bz, by);
  switch (p.r) {
#define OZAKI_CASE(R_)                                                                   \
  case R_:                                                                               \
    ozaki::stencil7_kernel<R_><<<grid, block, 0, s>>>(u_hi, u_lo, c_res, X, Y, Z,        \
                                                      out_rep, out, p);                 \
    break;
    OZAKI_FOR_EACH_R(OZAKI_CASE)
#undef OZAKI_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
