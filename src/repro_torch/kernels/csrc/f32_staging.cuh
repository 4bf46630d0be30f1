// Staging of f32 operands into shared memory, shared by the IEEE-f32 FFMA
// kernels (quadform.cu, fd_gram.cu, fd_project.cu, levscore.cu):
// shared-memory addresses, the 128-byte swizzle, mbarriers, TMA box loads of
// 3-D (tenant-stacked) tensors and the tensor maps they read, and 4-byte
// cp.async copies for the operands TMA cannot take (a row stride or base
// pointer off 16 bytes).  Beside them, what the kernels that
// split a contraction share: the split's size (summed in a thread block
// cluster, or in a second pass), the fixed-order sum of a cluster's
// partials, the masked float4 store, and the cluster launch.
//
// Each source includes this header into its own translation unit and library;
// kernels/_build.py keys every library on the source and all csrc/*.cuh, so a
// change here rebuilds them all.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

// Floats in one 128-byte row of a swizzled stage: the span of the swizzle.
constexpr int kSlab = 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element (r, k) of a staged tile, rows of kSlab floats with the 16-byte chunks
// of row r permuted as the TMA's 128-byte swizzle lays them out: chunk c at
// c ^ (r % 8).  Eight rows r with distinct r % 8 read at one k fall in
// distinct banks.
__device__ __forceinline__ int swizzled(int r, int k) {
  return r * kSlab + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (column, row, tenant) into shared memory,
// completing on `bar`; rows and columns out of bounds arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col0, int row0,
                                         int t, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col0), "r"(row0), "r"(t), "r"(bar)
      : "memory");
}

// 4-byte asynchronous copy global -> shared; `valid` false zero-fills.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The path for operands TMA cannot take: the d slab [k0, k0 + kSlab) of rows
// row0 .. row0 + kRows - 1 of `src` (`rows` of them exist, each d long) by
// 4-byte copies from all kThreads threads, in the swizzled layout a 128-byte
// swizzled TMA box gives; rows past `rows` and columns past d zero-filled.
template <int kRows, int kThreads>
__device__ __forceinline__ void stage_scalar(float* dst, const float* src, int row0, int rows,
                                             int k0, int d, int tid) {
  static_assert(kRows * kSlab % kThreads == 0, "whole copies per thread");
#pragma unroll 1  // unrolled, the address arithmetic spills registers
  for (int i = 0; i < kRows * kSlab / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kSlab;
    const int c = e % kSlab;
    const int row = row0 + r;
    const int k = k0 + c;
    const bool ok = row < rows && k < d;
    cp_async4(dst + swizzled(r, c), ok ? src + static_cast<size_t>(row) * d + k : src, ok);
  }
}

// The float4 at `part + offset` summed over blocks 0 .. csize - 1 of the
// cluster in rank order, through distributed shared memory: the fixed-order
// reduction of a split contraction.  Unrolled, so that the loads from all
// ranks are in flight together.
template <int kMaxCluster>
__device__ __forceinline__ float4 cluster_sum4(cg::cluster_group& cluster, float* part,
                                               int offset, int csize) {
  float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, 0) + offset);
#pragma unroll
  for (int p = 1; p < kMaxCluster; ++p) {
    if (p < csize) {
      const float4 q = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, p) + offset);
      v.x += q.x;
      v.y += q.y;
      v.z += q.z;
      v.w += q.w;
    }
  }
  return v;
}

// Store v to dst[0..3], columns col .. col + 3 of a row n long: one 16-byte
// store where `vec` (rows and base on 16 bytes) and all four columns exist,
// else the columns below n one by one.
__device__ __forceinline__ void store4(float* dst, float4 v, int col, int n, bool vec) {
  if (vec && col + 3 < n) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    dst[0] = v.x;
    if (col + 1 < n) dst[1] = v.y;
    if (col + 2 < n) dst[2] = v.z;
    if (col + 3 < n) dst[3] = v.w;
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 3-D map (cols, rows, T) of a (T, rows, cols) f32 tensor, in boxes of
// `box_cols` columns x `box_rows` rows of one tenant.  TMA needs the base
// pointer and the row stride (cols * 4 bytes) on 16 bytes; with the 128-byte
// swizzle a box row is at most kSlab floats.
bool make_map(CUtensorMap* map, const float* ptr, int T, int rows, int cols, int box_cols,
              int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(rows) * cols * 4};  // bytes
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch settings every FFMA kernel here needs: `smem_bytes` of dynamic
// shared memory and clusters above the portable 8 blocks.  Returns the SM
// count of the current device through `sms`.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem_bytes, int* sms) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return err;
}

// How many blocks of a cluster share the contraction of each of `tiles`
// output tiles (`slabs` steps long) on `sms` SMs: the split, up to
// `max_split`, with the least makespan.  The busiest SM runs
// ceil(tiles * split / sms) blocks, and takes as long for fewer than `busy`
// blocks as for `busy` (fewer do not keep it busy); a block costs its slabs
// plus about 1.5 slabs of pipeline fill and reduction.  Ties go to the
// smaller split.  With busy = 1 and `sms` the blocks the card holds at once
// (the SMs times the blocks an SM holds), the cost counts waves of blocks,
// for a split whose blocks need not be co-scheduled (levscore.cu).
inline int choose_split(long long tiles, int slabs, int sms, int max_split, int busy) {
  int best = 1;
  long long best_cost = -1;
  for (int split = 1; split <= max_split && split <= slabs; ++split) {
    long long per_sm = (tiles * split + sms - 1) / sms;
    if (per_sm < busy) per_sm = busy;
    const long long cost = per_sm * (2 * ((slabs + split - 1) / split) + 3);  // half slabs
    if (best_cost < 0 || cost < best_cost) {
      best = split;
      best_cost = cost;
    }
  }
  return best;
}

// Launch `kernel` on `grid` blocks of `threads`, in clusters of `csize`
// blocks along x.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, dim3 grid, int threads, int csize, int smem_bytes,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
