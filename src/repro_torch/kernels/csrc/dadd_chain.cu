// A probe, not a kernel of the package: n dependent float64 additions in one
// thread, whose time over n is the latency of a dependent FP64 add on the card.
// chip_smoke.py times it at two lengths to give carry_fold's chain bound (the
// fold is two chains of dependent adds, one step a partial).
#include <cstdint>
#include <cuda_runtime.h>

__global__ void dadd_chain_kernel(double x, int64_t n, double* out) {
  double s = 0.0;
  for (int64_t i = 0; i < n; ++i) s = s + x;
  *out = s;
}

// out (1) float64 on the card: n dependent additions of x in one thread.
// Launches on `stream`, never synchronises, returns the first CUDA error.
extern "C" int dadd_chain(int device, double x, int64_t n, double* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  dadd_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(x, n, out);
  return cudaGetLastError();
}
