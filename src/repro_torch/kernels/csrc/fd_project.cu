// Stacked FD shrink projection  B'_t = diag(w_t) U_t^T B_t :
//   w (T, L) f32, U (T, L, L) f32, B (T, L, d) f32 -> B' (T, L, d) f32 (B's dtype).
//
// Replaces the Pallas kernels
//   src/repro/kernels/fd_project.py:49        fd_project_pallas          (T = 1)
//   src/repro/kernels/fd_shrink_fused.py:99   fd_project_batched_pallas  (T = sites or tenants)
// and serves both of their callers: the FD shrink (w = sqrt((lam - delta)+ / lam))
// and the spectrum refresh (w = 1/s, rows below 1e-7 s_max weighted 0).
//
// On the TPU, U and w stayed resident in VMEM while B streamed through in
// d-blocks.  Here a block owns a 40 (rows i of B') x 128 (columns c) output
// tile of one B'_t and walks its share of the contraction axis k = 0..L.
//
// What bounds it on an H100: operations.  2 T L^2 d FLOPs: 2.6 GFLOP at the
// site shrink (T = 8, L = 400, d = 1024) on 18 MB, 39 us at the 67 TFLOP/s of
// IEEE f32 FMAs on the CUDA cores.  The products are plain fmaf, with no TF32
// and no tensor cores: the port is held to the reference at 1e-5.  What the
// design does about each limit of the kernel it replaces (32 x 32 tiles, a
// 2 x 2 register tile read by scalar shared loads, staging that stalled the
// FFMAs):
//
//  * Shared-memory loads.  The contraction runs down the rows of both
//    operands, and each is contiguous along an output axis: U[k, i0 : i0 + 40]
//    along the output rows, B[k, c0 : c0 + 128] along the output columns.  So
//    this is the outer-product form of an SGEMM, and U^T is read as stored:
//    at one k each of the 128 threads (8 row groups x 16 column groups) reads
//    rows 4ty .. 4ty + 3 of U as one float4 and row 32 + ty, and columns
//    4tx + c and 64 + 4tx + c of B as two float4s: four shared loads (three
//    LDS.128) for a 5 x 8 register tile, 10 FFMAs a load.  The eight threads
//    of a quarter warp read one run of U (a broadcast) and eight consecutive
//    16-byte runs of B: no bank conflicts, with no swizzle.
//  * Balance over the SMs.  At T = 8, L = 400, d = 1024 the work is 2.4
//    tiles of 80 x 128 an SM: 320 such tiles (a 10 x 8 register tile on four
//    warps) put three on 56 SMs and two on the rest, and measured no faster
//    than the library call.  A 40 x 128 tile on four warps (95 registers, 43
//    KB of shared memory) fits five blocks an SM, so its 640 tiles all run
//    at once, 4.8 an SM; four warps a block keep the SM's four schedulers
//    evenly loaded.  Each U slab is read 8 times and each B slab 10 (the
//    kernel it replaces read them 32 and 13 times), and 40-row tiles cover
//    L = 200, 400 and 600 exactly.
//  * Blocks to fill the card.  k is split across the k_split blocks of a
//    thread block cluster (up to 8) where the tiles leave SMs idle.
//    choose_split (f32_staging.cuh) picks k_split from the tile count, the k
//    slabs and the SM count, for the least makespan with four blocks an SM:
//    80 x 5 = 400 blocks at T = 1, L = 400; 640 x 1 at T = 8; 320 x 2 at
//    the refresh shape (T = 8, L = 200).
//  * Reduction in a fixed order.  Each block leaves its partial tile in its
//    shared memory; after a cluster barrier block rank p sums the rows
//    [p * 40 / k_split, (p + 1) * 40 / k_split) over the cluster's partials in
//    rank order, through distributed shared memory, then applies w_i.  No
//    second launch, no scratch, no atomics: two runs are bit-equal.  A block
//    that holds the whole contraction (k_split = 1, as at T = 8) scales and
//    stores its registers directly.
//  * The rescale by w_i in the epilogue, as fd_project.py fuses it, so the
//    (L, d) product makes one trip to device memory, in coalesced rows.
//  * Staging.  A ring of 4 stages of 16-row k slabs (80 floats of U and 128
//    of B a row), each filled by two TMA box loads issued by one thread three
//    slabs ahead of the FFMAs and completing on the stage's mbarrier; one
//    __syncthreads a slab.  Rows past L and columns past L or d arrive as
//    zeros.
//
// Any L and d.  Where TMA cannot take U or B (L % 4 != 0 or d % 4 != 0, whose
// rows are then off 16 bytes, or a base pointer off 16-byte alignment, as in
// an offset view), the same kernel stages by 4-byte cp.async copies,
// zero-filled past the edges, into the same layout; nothing is copied to fix
// alignment.

#include "f32_staging.cuh"

namespace {

constexpr int kTy = 8;             // row groups of threads
constexpr int kTx = 16;            // column groups of threads
constexpr int kThreads = kTy * kTx;
constexpr int kRowsPer = 5;        // rows a thread holds: 4ty + a (a < 4) and 4kTy + ty
constexpr int kColsPer = 8;        // columns a thread holds: 4tx + c + 64h, h < kColsPer / 4
constexpr int kBM = kTy * kRowsPer;  // rows of B' per tile: 40
constexpr int kBN = kTx * kColsPer;  // columns of B' per tile: 128
constexpr int kBK = 16;            // k rows staged per step
constexpr int kStages = 4;         // ring of k slabs
constexpr int kMinBlocks = 5;      // blocks an SM holds: caps registers at 102
constexpr int kMaxCluster = 8;     // blocks of a cluster at most
constexpr int kBusyBlocks = 4;     // blocks that keep an SM busy (measured)
constexpr int kUFloats = kBK * kBM;  // a stage: the U slab [k][i], then the B slab [k][c]
constexpr int kStageFloats = kUFloats + kBK * kBN;
constexpr int kStageBytes = kStageFloats * 4;  // also what one stage's TMA brings
constexpr int kRingFloats =
    kStages * kStageFloats > kBM * kBN ? kStages * kStageFloats : kBM * kBN;
// Dynamic shared memory: the ring (which then takes the partial tile), its
// full barriers, and slack to align the ring to 1024 bytes.
constexpr int kSmemBytes = kRingFloats * 4 + 8 * kStages + 1024;
static_assert(kUFloats * 4 % 128 == 0 && kStageBytes % 128 == 0, "TMA boxes on 128 bytes");
static_assert(kRowsPer == 5 && kColsPer % 4 == 0, "the runs that row_of and 4tx + c + 64h lay out");

// The row of the tile that register row a (0..4) of row group ty holds: a
// float4 run and one more row of U at each k.
__device__ __forceinline__ int row_of(int a, int ty) { return a < 4 ? 4 * ty + a : 4 * kTy + ty; }

// The path for operands TMA cannot take: rows k0 .. k0 + kBK - 1 of `src`
// (L rows of `cols` floats), columns col0 .. col0 + kW - 1, by 4-byte copies
// into a [kBK][kW] slab; rows past L and columns past `cols` zero-filled.
template <int kW>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int col0, int cols,
                                           int k0, int L, int tid) {
#pragma unroll 1
  for (int e = tid; e < kBK * kW; e += kThreads) {
    const int k = k0 + e / kW;
    const int col = col0 + e % kW;
    const bool ok = k < L && col < cols;
    cp_async4(dst + e, ok ? src + static_cast<size_t>(k) * cols + col : src, ok);
  }
}

// Grid: (clusters of k_split blocks) x output tiles along x, tenants along y.
// Block rank p of a cluster takes the p-th share of the k slabs.
template <bool kTma>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fd_project_kernel(const __grid_constant__ CUtensorMap map_u,
                  const __grid_constant__ CUtensorMap map_b, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ b,
                  float* __restrict__ out, int L, int d) {
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = smem_addr(raw);
  const uint32_t ring_addr = (raw_addr + 1023) & ~1023u;
  float* ring = reinterpret_cast<float*>(raw + (ring_addr - raw_addr));
  const uint32_t full = ring_addr + kRingFloats * 4;  // kStages mbarriers

  cg::cluster_group cluster = cg::this_cluster();
  const int k_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int n_col_tiles = (d + kBN - 1) / kBN;
  const int tile = static_cast<int>(blockIdx.x) / k_split;
  const int i0 = tile / n_col_tiles * kBM;
  const int c0 = tile % n_col_tiles * kBN;
  const int t = blockIdx.y;
  const float* ut = u + static_cast<size_t>(t) * L * L;
  const float* bt = b + static_cast<size_t>(t) * L * d;

  const int n_slabs = (L + kBK - 1) / kBK;
  const int slab0 = rank * n_slabs / k_split;  // this block's share of k
  const int steps = (rank + 1) * n_slabs / k_split - slab0;

  if (kTma && tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int s) {
    const int st = s % kStages;
    float* stage = ring + st * kStageFloats;
    const int k0 = (slab0 + s) * kBK;
    if constexpr (kTma) {
      if (tid == 0 && s < steps) {
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, kStageBytes);
        tma_load(smem_addr(stage), &map_u, i0, k0, t, bar);
        tma_load(smem_addr(stage + kUFloats), &map_b, c0, k0, t, bar);
      }
    } else {
      if (s < steps) {
        stage_rows<kBM>(stage, ut, i0, L, k0, L, tid);
        stage_rows<kBN>(stage + kUFloats, bt, c0, d, k0, L, tid);
      }
      cp_async_commit();  // an empty group past the end keeps the count uniform
    }
  };

  float acc[kRowsPer][kColsPer];
#pragma unroll
  for (int a = 0; a < kRowsPer; ++a)
#pragma unroll
    for (int c = 0; c < kColsPer; ++c) acc[a][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    const int st = s % kStages;
    if constexpr (kTma) {
      mbar_wait(full + 8 * st, (s / kStages) & 1);  // slab s has landed
    } else {
      cp_async_wait<kStages - 2>();  // this thread's copies of slab s have landed
    }
    __syncthreads();         // everyone's have; everyone is done with slab s - 1
    issue(s + kStages - 1);  // refill the stage slab s - 1 was read from
    const float* us = ring + st * kStageFloats;
    const float* bs = ring + st * kStageFloats + kUFloats + 4 * tx;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[kRowsPer];
      *reinterpret_cast<float4*>(av) =
          *reinterpret_cast<const float4*>(us + k * kBM + row_of(0, ty));
      av[4] = us[k * kBM + row_of(4, ty)];
      float4 bv[kColsPer / 4];
#pragma unroll
      for (int h = 0; h < kColsPer / 4; ++h)
        bv[h] = *reinterpret_cast<const float4*>(bs + k * kBN + 4 * kTx * h);
#pragma unroll
      for (int a = 0; a < kRowsPer; ++a)
#pragma unroll
        for (int c = 0; c < kColsPer; ++c)
          acc[a][c] = fmaf(av[a], reinterpret_cast<const float*>(bv)[c], acc[a][c]);
    }
  }
  if constexpr (!kTma) cp_async_wait<0>();
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  float* ot = out + static_cast<size_t>(t) * L * d;
  if (k_split == 1) {
    // The block holds the whole contraction: scale and store its registers.
#pragma unroll
    for (int a = 0; a < kRowsPer; ++a) {
      const int i = i0 + row_of(a, ty);
      if (i >= L) continue;
      const float wi = w[static_cast<size_t>(t) * L + i];
#pragma unroll
      for (int h = 0; h < kColsPer / 4; ++h) {
        const int col = c0 + 4 * kTx * h + 4 * tx;
        if (col < d)
          store4(ot + static_cast<size_t>(i) * d + col,
                 make_float4(wi * acc[a][4 * h], wi * acc[a][4 * h + 1], wi * acc[a][4 * h + 2],
                             wi * acc[a][4 * h + 3]),
                 col, d, vec);
      }
    }
    return;
  }
  __syncthreads();  // the ring is idle: it takes the partial tile

  // The partial tile [kBM][kBN]: this thread's rows row_of(a, ty) and columns
  // 4tx + 64h .. 4tx + 64h + 3, as float4s.
  float* part = ring;
#pragma unroll
  for (int a = 0; a < kRowsPer; ++a) {
    const int r = row_of(a, ty);
#pragma unroll
    for (int h = 0; h < kColsPer / 4; ++h)
      *reinterpret_cast<float4*>(part + r * kBN + 4 * kTx * h + 4 * tx) =
          make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2], acc[a][4 * h + 3]);
  }
  cluster.sync();  // every partial of the cluster is written and visible

  // Rows [r_lo, r_hi) of the tile, four columns a thread at a time, summed
  // over the cluster in rank order and scaled by w_i.
  const int r_lo = rank * kBM / k_split;
  const int r_hi = (rank + 1) * kBM / k_split;
  for (int e = tid; e < (r_hi - r_lo) * (kBN / 4); e += kThreads) {
    const int r = r_lo + e / (kBN / 4);
    const int c = 4 * (e % (kBN / 4));
    const int i = i0 + r;
    const int col = c0 + c;
    if (i >= L || col >= d) continue;
    const float4 v = cluster_sum4<kMaxCluster>(cluster, part, r * kBN + c, k_split);
    const float wi = w[static_cast<size_t>(t) * L + i];
    store4(ot + static_cast<size_t>(i) * d + col,
           make_float4(wi * v.x, wi * v.y, wi * v.z, wi * v.w), col, d, vec);
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

template <bool kTma>
cudaError_t launch(const float* w, const float* u, const float* b, float* out, int T, int L,
                   int d, cudaStream_t stream) {
  CUtensorMap map_u = {}, map_b = {};
  if (kTma && !(make_map(&map_u, u, T, L, L, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_NONE) &&
                make_map(&map_b, b, T, L, d, kBN, kBK, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorInvalidValue;
  auto kernel = fd_project_kernel<kTma>;
  int sms = 0;
  const cudaError_t err = prepare(kernel, kSmemBytes, &sms);
  if (err != cudaSuccess) return err;
  // k across the blocks of a cluster where the tiles leave SMs idle.
  const int tiles = ((L + kBM - 1) / kBM) * ((d + kBN - 1) / kBN);
  const int n_slabs = (L + kBK - 1) / kBK;
  const int csize =
      choose_split(static_cast<long long>(tiles) * T, n_slabs, sms, kMaxCluster, kBusyBlocks);
  return launch_clusters(kernel, dim3(csize * tiles, T), kThreads, csize, kSmemBytes, stream,
                         map_u, map_b, w, u, b, out, L, d);
}

}  // namespace

// w: (T, L), u: (T, L, L), b: (T, L, d), out: (T, L, d); all f32 contiguous.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int fd_project_launch(const float* w, const float* u, const float* b, float* out,
                                 int T, int L, int d, cudaStream_t stream) {
  cudaError_t launched = cudaSuccess;
  if (T > 0 && L > 0 && d > 0) {
    const bool tma = L % 4 == 0 && d % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
    launched = tma ? launch<true>(w, u, b, out, T, L, d, stream)
                   : launch<false>(w, u, b, out, T, L, d, stream);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}
