// carry_fold for Hopper (sm_90a): the in-order carry fold that ends every
// compensated reduction (repro_torch/core/compensated.py).
//
// After the blocked two_sum tree each reduction lane has one partial (s_b, c_b)
// per block.  The fold takes them strictly in block order:
//   s, e = two_sum(s, s_b[k]);  c = c + (e + c_b[k]);   from s = c = +0,
// and returns s + c.  It replaces the reference's lax.scan in
// repro/core/compensated.py::_carry_scan (line 111); that is not a TPU kernel
// (no pallas_call), but on the card it runs on every dot and norm of the
// solvers.  The order fixes the bits, so each lane is one dependent chain.
//
// Bound on the H100: the partials read once (2 * 8 B per block and lane for
// float64) and the result written once, at 3.35 TB/s; a 256^3 norm has 32,768
// blocks, 524,288 B, ~0.16 us.  Its ~8 floating-point operations per partial
// take less.  Neither bound sees the chain: nb dependent additions per lane, so
// the fold takes at least nb times the FP64 add latency however wide the card.
//
// Design.  One block per 32 lanes (per lane when there are fewer).  Warp 0
// folds, one thread per lane, from a shared-memory tile of partials while
// warps 1-7 stage the next tile from global memory (two buffers), so the loads
// overlap the chain.  The build passes --fmad=false and the fold has no
// multiply, so every operation rounds as in the plain version on the host.
#include <cstdint>
#include <cuda_runtime.h>

namespace carry {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 32;   // lanes per block: warp 0 folds one each
constexpr int kTile = 1024;     // partials of each stream per buffer

// Stage steps [k0, k0 + tk) of lanes [lane0, lane0 + g) into the tile, laid
// out [step][lane] with stride G (consecutive lanes are consecutive words).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ sb, const T* __restrict__ cb,
                                      int64_t k0, int64_t nb, int64_t L, int64_t lane0,
                                      int G, int tk, T* s_tile, T* c_tile, int tid,
                                      int nthreads) {
  for (int j = tid; j < tk * G; j += nthreads) {
    const int64_t k = k0 + j / G;
    const int64_t lane = lane0 + j % G;
    if (k < nb && lane < L) {
      s_tile[j] = sb[k * L + lane];
      c_tile[j] = cb[k * L + lane];
    }
  }
}

// s_b, c_b (nb, L) row-major; out (L).  G lanes per block, G <= kMaxLanes.
template <typename T>
__global__ void __launch_bounds__(kThreads) carry_fold_kernel(const T* __restrict__ sb,
                                                              const T* __restrict__ cb,
                                                              int64_t nb, int64_t L, int G,
                                                              T* __restrict__ out) {
  __shared__ T s_buf[2][kTile];
  __shared__ T c_buf[2][kTile];
  const int tid = threadIdx.x;
  const int64_t lane0 = blockIdx.x * (int64_t)G;
  const int g = (int)(L - lane0 < G ? L - lane0 : G);
  const int tk = kTile / G;
  const int64_t ntiles = (nb + tk - 1) / tk;

  stage(sb, cb, 0, nb, L, lane0, G, tk, s_buf[0], c_buf[0], tid, kThreads);
  __syncthreads();
  T s = 0, c = 0;
  for (int64_t t = 0; t < ntiles; ++t) {
    const int b = (int)(t & 1);
    if (tid >= 32) {
      if (t + 1 < ntiles) {
        stage(sb, cb, (t + 1) * tk, nb, L, lane0, G, tk, s_buf[b ^ 1], c_buf[b ^ 1],
              tid - 32, kThreads - 32);
      }
    } else if (tid < g) {
      const int steps = (int)(nb - t * tk < tk ? nb - t * tk : tk);
      const T* st = s_buf[b];
      const T* ct = c_buf[b];
#pragma unroll 8
      for (int k = 0; k < steps; ++k) {
        const T x = st[k * G + tid];
        const T sn = s + x;          // two_sum(s, x), Knuth
        const T v = sn - s;
        const T e = (s - (sn - v)) + (x - v);
        c = c + (e + ct[k * G + tid]);
        s = sn;
      }
    }
    __syncthreads();
  }
  if (tid < g) out[lane0 + tid] = s + c;
}

template <typename T>
cudaError_t launch(const void* sb, const void* cb, int64_t nb, int64_t L, void* out,
                   cudaStream_t s) {
  const int G = L < kMaxLanes ? (int)L : kMaxLanes;
  const int64_t blocks = (L + G - 1) / G;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  carry_fold_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(sb), static_cast<const T*>(cb), nb, L, G, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace carry

// C interface, loaded with ctypes.  s_b/c_b (nb, lanes) contiguous, of float64
// (dtype_bytes 8) or float32 (4); out (lanes) of the same type.  Launches on
// `stream`, never synchronises, returns the first CUDA error (0 on success).
extern "C" int carry_fold(int device, int dtype_bytes, const void* s_b, const void* c_b,
                          int64_t nb, int64_t lanes, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 0 || lanes < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (lanes == 0) return cudaSuccess;
  if (dtype_bytes == 8) return carry::launch<double>(s_b, c_b, nb, lanes, out, s);
  if (dtype_bytes == 4) return carry::launch<float>(s_b, c_b, nb, lanes, out, s);
  return cudaErrorInvalidValue;
}
