// gemm_hilo for Hopper (sm_90a): C~ = A~ . B~ exactly, from (hi, lo) int32 operands.
//
// Replaces the TPU kernel repro/kernels/ozaki_gemm.py::gemm_hilo (pallas_call at
// line 99), which computes the residues of each (hi, lo) tile, one int8 x int8 ->
// int32 MXU dot per modulus accumulated in VMEM across the K grid axis, and the
// Garner epilogue before a single store.
//
// Bound on the H100: 2*M*N*K*r int8 operations at 1979 TOPS (8192^3 at r = 16:
// ~8.9 ms, against ~0.16 ms for moving the 8-byte inputs and outputs), so it is
// bound by operations: the product stage has to run on the tensor cores at
// their full rate, which only wgmma fed from shared memory reaches.
//
// Design.  The TPU keeps r accumulator tiles of 128 x 128 int32 in VMEM (1 MiB at
// r = 16); an SM has 256 KB of registers, and blocks run in no order, so the K
// axis becomes a loop inside a block and the moduli an axis of the work items:
//   1. residues_rows / residues_cols (ozaki_product.cuh) turn the operands into
//      int8 residue planes once, A as (r, M, K) and B transposed as (r, N, K):
//      both K-major, the only layout integer wgmma takes.  Recomputing the
//      residues inside the product would cost r FP64 residues per element for
//      every output tile that reads it, more than the tensor-core work.
//   2. gemm_product: one persistent block per SM walks the work items (modulus,
//      128 x 256 output tile), modulus-major and, inside a modulus, 8 tile rows
//      at a time, so that the A and B panels in flight stay in L2.  A warp after
//      the two consumer warpgroups is the producer: one thread keeps a ring of
//      4 stages in shared memory filled by TMA (cp.async.bulk.tensor on a 3-D
//      map of the planes, 128-byte swizzle; a stage holds 128 rows of A's plane
//      and 256 of B's by 128 k, 48 KB), completing on an mbarrier per stage;
//      TMA zero-fills a stage past K and, where N / 128 is odd, the half tile
//      past N, whose columns are not stored.  Each consumer warpgroup runs
//      wgmma.mma_async.m64n256k32 s8 on its 64 rows of the stage against all
//      256 columns, four per stage, keeps one stage's products in flight
//      (wait_group 1) and releases each stage to the producer with an mbarrier
//      once its products are done, so loads overlap products, and the next
//      item's first stages load during an item's epilogue.  The 128 x 256 tile
//      does 85 int8 products per byte it loads from L2 (64 at 128 x 128).  The
//      int32 sums of int8 products are exact up to 2^17 terms; they are
//      reduced (bmod_rt, the modulus a run-time value) every 2^16 k and once
//      at the end, so any K is exact and the order in which wgmma sums cannot
//      change a bit; the residue mod m is unique, so the bits are those of the
//      plain version's exact sums mod m.
//   3. garner_epilogue turns the (r, M, N) residues into f64, ds or digits.  The
//      product stores each sum as (sum + 2^31) mod m (umod_rt), half the
//      integer work of the balanced residue in the epilogue that keeps the
//      tensor cores waiting; Garner subtracts the constant 2^31 mod m.
// The tensor map of each plane stack comes from libcuda's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no -lcuda).
#include <cuda.h>

#include "ozaki_product.cuh"

namespace ozaki {

constexpr int kGemmBM = 128, kGemmBN = 256;  // output tile (rows of A's, B's plane)
constexpr int kGemmGranule = 128;            // M and N granule (a ragged half tile of N)
constexpr int kGemmBK = 128;                 // k per stage: one 128-byte swizzle row
constexpr int kGemmStages = 4;
constexpr int kGemmTileA = kGemmBM * kGemmBK;  // 16 KB
constexpr int kGemmTileB = kGemmBN * kGemmBK;  // 32 KB
constexpr int kGemmStageBytes = kGemmTileA + kGemmTileB;
constexpr int kGemmSmem = kGemmStages * kGemmStageBytes + 2 * kGemmStages * 8 + 1024;
constexpr int kGemmThreads = 288;  // two consumer warpgroups, then the producer warp
constexpr int kGemmFoldSteps = (1 << 16) / kGemmBK;  // stages between reductions
constexpr int kGemmGroupM = 8;                       // tile rows walked together

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Returns once the phase of parity `parity` has completed; traps (a launch
// error, not a hang) if it has not after 2^30 polls.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0, polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (k, row, modulus) of a 3-D tensor map into shared memory,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int k, int row, int i) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row), "r"(i)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle
// TMA writes: start address, leading offset 16 B (unused by this layout),
// stride 1024 B between groups of 8 rows, swizzle mode 1.  A 1024-byte aligned
// tile; +2 in the descriptor advances k by 32 bytes inside the swizzle row.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  return ((uint64_t)(smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int j = 0; j < 128; ++j) asm volatile("" : "+r"(d[j])::"memory");
}

// d (64 x 256 int32, the warpgroup's fragment) = A . B^T (+ d if scale_d): A
// 64 x 32 and B 256 x 32 int8, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Work item q: modulus i, tile row tm, tile column tn.  Modulus-major; inside a
// modulus, groups of kGemmGroupM tile rows, walked column by column.
struct GemmItem {
  int i, tm, tn;
};
__device__ __forceinline__ GemmItem gemm_item(int q, int tiles_m, int tiles_n) {
  GemmItem it;
  const int per_mod = tiles_m * tiles_n;
  it.i = q / per_mod;
  const int rem = q - it.i * per_mod;
  const int span = kGemmGroupM * tiles_n;
  const int group = rem / span;
  const int first = group * kGemmGroupM;
  const int rows = tiles_m - first < kGemmGroupM ? tiles_m - first : kGemmGroupM;
  const int in = rem - group * span;
  it.tm = first + in % rows;
  it.tn = in / rows;
  return it;
}

// The planes' tensor maps: A's (r, M, K) and B's (r, N, K) int8, K innermost.
// cres (r, M, N) uint8: each sum as (sum + 2^31) mod m.  M % 128 == N % 128 ==
// 0, K % 16 == 0.
// A tile's columns past N (N / 128 odd) are zero-filled by TMA and not stored.
__global__ void __launch_bounds__(kGemmThreads, 1) gemm_product(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b, int r,
    int M, int N, int K, uint8_t* __restrict__ cres) {
  extern __shared__ uint8_t gemm_smem_raw[];
  // the swizzled tiles need 1024-byte alignment in the shared window
  uint8_t* smem = gemm_smem_raw + ((1024 - (smem_u32(gemm_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGemmStages * kGemmStageBytes);
  uint64_t* empty = full + kGemmStages;
  const int tiles_m = M / kGemmBM, tiles_n = (N + kGemmBN - 1) / kGemmBN;
  const int items = r * tiles_m * tiles_n;
  const int nk = (K + kGemmBK - 1) / kGemmBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the stage's bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: one thread issues every load
    if (threadIdx.x != 256) return;
    int stage = 0;
    unsigned phase = 0;
    for (int q = blockIdx.x; q < items; q += gridDim.x) {
      const GemmItem it = gemm_item(q, tiles_m, tiles_n);
      for (int ks = 0; ks < nk; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* st = smem + stage * kGemmStageBytes;
        mbar_expect_tx(&full[stage], kGemmStageBytes);
        tma_load_3d(st, &map_a, &full[stage], ks * kGemmBK, it.tm * kGemmBM, it.i);
        tma_load_3d(st + kGemmTileA, &map_b, &full[stage], ks * kGemmBK, it.tn * kGemmBN, it.i);
        if (++stage == kGemmStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 of the tile
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int d[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) d[j] = 0;
  int stage = 0;
  unsigned phase = 0;
  for (int q = blockIdx.x; q < items; q += gridDim.x) {
    const GemmItem it = gemm_item(q, tiles_m, tiles_n);
    const ModRT md = mod_rt(it.i);
    int prev = -1;
    for (int ks = 0; ks < nk; ++ks) {
      mbar_wait(&full[stage], phase);
      const uint8_t* st = smem + stage * kGemmStageBytes;
      const uint64_t da = wgmma_desc(st + wg * 64 * kGemmBK);
      const uint64_t db = wgmma_desc(st + kGemmTileA);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 32; ++kk) {
        wgmma_m64n256k32(d, da + 2 * kk, db + 2 * kk, (ks | kk) != 0);
      }
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == kGemmStages) {
        stage = 0;
        phase ^= 1;
      }
      if ((ks + 1) % kGemmFoldSteps == 0 && ks + 1 < nk) {
        wgmma_wait<0>();
        fence_acc(d);
#pragma unroll
        for (int j = 0; j < 128; ++j) d[j] = bmod_rt(d[j], md);
      }
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

    // d[4j + e]: row 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1) of the
    // warpgroup's 64 x 256; stored as (d + 2^31) mod m (see umod_rt)
    uint8_t* C = cres + (size_t)it.i * M * N;
    const size_t row = (size_t)it.tm * kGemmBM + wg * 64 + 16 * w + g;
    const int col0 = it.tn * kGemmBN + 2 * t;
    const int jmax = N - it.tn * kGemmBN >= kGemmBN ? 32 : 16;  // N % 128 == 0
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j < jmax) {
        const int col = col0 + 8 * j;
        const unsigned top = umod_rt(d[4 * j], md) | (umod_rt(d[4 * j + 1], md) << 8);
        const unsigned bot = umod_rt(d[4 * j + 2], md) | (umod_rt(d[4 * j + 3], md) << 8);
        *reinterpret_cast<uint16_t*>(C + row * N + col) = (uint16_t)top;
        *reinterpret_cast<uint16_t*>(C + (row + 8) * N + col) = (uint16_t)bot;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, or nullptr.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// Tensor map of an (r, rows, K) int8 plane stack: boxes of box_rows rows by
// 128 k of one plane, the 128-byte swizzle, zero fill past K and past rows.
inline bool plane_map(CUtensorMap* map, const int8_t* base, int r, int rows, int K, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)r};
  const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)K * rows};
  const cuuint32_t box[3] = {(cuuint32_t)kGemmBK, (cuuint32_t)box_rows, 1};
  const cuuint32_t elems[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(base), dims, strides, box,
            elems, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace ozaki

using ozaki::GarnerParams;

// C interface, loaded with ctypes.  a_hi/a_lo (M, K), b_hi/b_lo (K, N) int32,
// contiguous, M % 128 == N % 128 == K % 64 == 0, K > 0.  Scratch from the
// caller: ares (r, M, K), bres (r, N, K), cres (r, M, N) int8, 16-byte aligned.
// out: f64 (M, N), digits int8 (r, M, N) or ds f32 (2, M, N) by out_rep.
// Launches on `stream`, never synchronises, returns the first CUDA error (0 on
// success).
extern "C" int ozaki_gemm_hilo(int device, const int* a_hi, const int* a_lo, const int* b_hi,
                               const int* b_lo, int M, int N, int K, int out_rep, void* out,
                               int8_t* ares, int8_t* bres, int8_t* cres,
                               const GarnerParams* params, void* stream) {
  const GarnerParams& p = *params;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M % ozaki::kGemmGranule || N % ozaki::kGemmGranule || K % 64 || K <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M == 0 || N == 0) return cudaSuccess;
  err = ozaki::launch_residues_rows(p.r, a_hi, a_lo, (int64_t)M * K, ares, s);
  if (err != cudaSuccess) return err;
  err = ozaki::launch_residues_cols(p.r, b_hi, b_lo, K, N, bres, s);
  if (err != cudaSuccess) return err;
  CUtensorMap map_a, map_b;
  if (!ozaki::plane_map(&map_a, ares, p.r, M, K, ozaki::kGemmBM) ||
      !ozaki::plane_map(&map_b, bres, p.r, N, K, ozaki::kGemmBN)) {
    return cudaErrorNotSupported;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ozaki::gemm_product, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ozaki::kGemmSmem);
  if (err != cudaSuccess) return err;
  const int items =
      p.r * (M / ozaki::kGemmBM) * ((N + ozaki::kGemmBN - 1) / ozaki::kGemmBN);
  ozaki::gemm_product<<<items < sms ? items : sms, ozaki::kGemmThreads, ozaki::kGemmSmem, s>>>(
      map_a, map_b, p.r, M, N, K, reinterpret_cast<uint8_t*>(cres));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return ozaki::launch_garner_epilogue(reinterpret_cast<const uint8_t*>(cres), (int64_t)M * N,
                                       out_rep, out, p, s);
}
