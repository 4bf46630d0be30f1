// Stacked FD Gram product  G_t = B_t B_t^T :  (T, L, d) f32 -> (T, L, L) f32.
//
// Replaces the Pallas kernels
//   src/repro/kernels/fd_gram.py:52          fd_gram_pallas          (T = 1)
//   src/repro/kernels/fd_shrink_fused.py:60  fd_gram_batched_pallas  (T = sites or tenants)
//
// On the TPU one core walked a sequential grid over d-blocks and carried the
// (L, L) sum in VMEM from step to step.  Here a block owns one square 80 x 80
// tile of one G_t on or above the diagonal, and carries its sum over its share
// of d in registers.
//
// What bounds it on an H100: operations.  G is symmetric, so the function
// needs T L (L + 1) d FLOPs: 1.3 GFLOP at the site shrink (T = 8, L = 400,
// d = 1024) on 13 MB of input and output, 19.6 us at the 67 TFLOP/s of IEEE
// f32 FMAs on the CUDA cores.  The products are plain fmaf, with no TF32 and
// no tensor cores: the port is held to the reference at 1e-5.  What the design
// does about each limit of the kernel it replaces (a block per 32 x 32 tile, a
// 2 x 2 register tile read by scalar shared loads, both triangles of G):
//
//  * Shared-memory loads.  Each of the 128 threads (16 row groups x 8 column
//    groups, four warps, so the SM's four schedulers are evenly loaded)
//    holds a 5 x 10 register tile: rows ty + 16a and columns tx + 8c of the
//    output tile.  Both operands are rows of B, staged along d, so one float4
//    read (LDS.128) brings four d steps of one row: 15 reads feed 200 FFMAs,
//    13.3 FFMAs a shared-load instruction.  The stages are laid out in the
//    TMA's 128-byte swizzle; the eight threads of a quarter warp read one
//    row of the i operand (a broadcast) and eight rows of the j operand with
//    distinct swizzles (tx = 0..7), so their reads fall in distinct banks.
//  * Half the work.  Only the n (n + 1) / 2 tiles with i-tile <= j-tile are
//    launched (n = ceil(L / 80)), and an off-diagonal tile is stored at (i, j)
//    and, transposed, at (j, i).  The transposed store reads the finished
//    rows back from shared memory (rows padded to 81 words), so both stores
//    are coalesced, and both write the same sums: G is exactly symmetric.
//    Inside a diagonal tile G[i][j] and G[j][i] are the same products (fmaf
//    commutes) in the same order.
//  * Blocks to fill the card.  At T = 1, L = 400 there are 15 tiles for 132
//    SMs, so d is split across the k_split blocks of a thread block cluster
//    (up to 8).  choose_split (f32_staging.cuh) picks k_split from the tile
//    count, the d slabs and the SM count, for the least makespan with three
//    blocks an SM: 15 x 8 = 120 blocks at T = 1, 120 x 3 at T = 8, 48 x 8 at
//    the refresh shape (T = 8, L = 200).
//  * Reduction in a fixed order.  Each block leaves its partial tile in its
//    shared memory; after a cluster barrier block rank p sums the rows
//    [p * 80 / k_split, (p + 1) * 80 / k_split) of the tile over the
//    cluster's partials in rank order, through distributed shared memory,
//    stores them, and stores their transpose from its own shared memory.  No
//    second launch, no scratch, no atomics: two runs are bit-equal.
//  * Staging.  A ring of 3 stages of 32-wide d slabs (one 128-byte row of each
//    of the tile's 80 + 80 rows of B), each filled by two TMA box loads issued
//    by one thread two slabs ahead of the FFMAs and completing on the stage's
//    mbarrier; one __syncthreads a slab.  Rows past L and columns past d
//    arrive as zeros.
//
// Any L and d.  Where TMA cannot take B (d % 4 != 0, or a base pointer off
// 16-byte alignment, as in an offset view), the same kernel stages by 4-byte
// cp.async copies, zero-filled past the edges, into the same layout; nothing
// is copied to fix alignment.

#include "f32_staging.cuh"

namespace {

constexpr int kTy = 16;            // row groups of threads
constexpr int kTx = 8;             // column groups of threads
constexpr int kThreads = kTy * kTx;
constexpr int kRowsPer = 5;        // rows a thread holds: ty + kTy * a
constexpr int kColsPer = 10;       // columns a thread holds: tx + 8c
constexpr int kS = kTy * kRowsPer;  // edge of an output tile: 80
constexpr int kBK = kSlab;         // d slab staged per step: one 128-byte row
constexpr int kStages = 3;         // ring of d slabs
constexpr int kMinBlocks = 3;      // blocks an SM holds: caps registers at 170
constexpr int kMaxCluster = 8;     // blocks of a cluster at most
constexpr int kBusyBlocks = 3;     // blocks that keep an SM busy (measured)
constexpr int kOperandFloats = kS * kBK;  // one operand's rows in a stage
constexpr int kStageFloats = 2 * kOperandFloats;
constexpr int kStageBytes = kStageFloats * 4;  // also what one stage's TMA brings
constexpr int kPartStride = kS + 4;  // row stride of a partial tile: float4 rows
constexpr int kFinStride = kS + 1;   // row stride of the finished rows: columns read conflict-free
// Dynamic shared memory: the ring, its full barriers, and slack to align the
// ring to 1024 bytes (the period of the 128-byte swizzle).
constexpr int kSmemBytes = kStages * kStageBytes + 8 * kStages + 1024;
static_assert(kS == kTx * kColsPer, "square tiles");
static_assert(kTy % 8 == 0 && kTx == 8, "rows ty + 16a and columns tx + 8c share a swizzle");
static_assert(kOperandFloats * 4 % 1024 == 0, "each operand starts a swizzle period");
static_assert(kS * (kPartStride + kFinStride) <= kStages * kStageFloats,
              "the partial tile and the finished rows fit in the ring");

// Grid: (clusters of k_split blocks) x upper tiles along x, tenants along y.
// Block rank p of a cluster takes the p-th share of the d slabs.
template <bool kTma>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fd_gram_kernel(const __grid_constant__ CUtensorMap map_b, const float* __restrict__ b,
               float* __restrict__ g, int L, int d) {
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = smem_addr(raw);
  const uint32_t ring_addr = (raw_addr + 1023) & ~1023u;
  float* ring = reinterpret_cast<float*>(raw + (ring_addr - raw_addr));
  const uint32_t full = ring_addr + kStages * kStageBytes;  // kStages mbarriers

  cg::cluster_group cluster = cg::this_cluster();
  const int k_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int t = blockIdx.y;
  const float* bt = b + static_cast<size_t>(t) * L * d;

  // The upper tile (ti, tj), ti <= tj, of this cluster: row ti holds n - ti.
  const int n = (L + kS - 1) / kS;
  int ti = 0, u = static_cast<int>(blockIdx.x) / k_split;
  while (u >= n - ti) {
    u -= n - ti;
    ++ti;
  }
  const int tj = ti + u;
  const int i0 = ti * kS;
  const int j0 = tj * kS;

  const int n_slabs = (d + kBK - 1) / kBK;
  const int slab0 = rank * n_slabs / k_split;  // this block's share of d
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
        tma_load(smem_addr(stage), &map_b, k0, i0, t, bar);
        tma_load(smem_addr(stage + kOperandFloats), &map_b, k0, j0, t, bar);
      }
    } else {
      if (s < steps) {
        stage_scalar<kS, kThreads>(stage, bt, i0, L, k0, d, tid);
        stage_scalar<kS, kThreads>(stage + kOperandFloats, bt, j0, L, k0, d, tid);
      }
      cp_async_commit();  // an empty group past the end keeps the count uniform
    }
  };

  // This thread's float offsets of its rows (ty + 16a, all with swizzle
  // ty % 8) and columns (tx + 8c, all with swizzle tx) in a stage.
  const int a_off = ty * kBK;
  const int a_swz = ty & 7;
  const int b_off = kOperandFloats + tx * kBK;

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
    const float* stage = ring + st * kStageFloats;
#pragma unroll
    for (int kk = 0; kk < kBK / 4; ++kk) {
      float4 av[kRowsPer], bv[kColsPer];
#pragma unroll
      for (int a = 0; a < kRowsPer; ++a)
        av[a] = *reinterpret_cast<const float4*>(stage + a_off + a * kTy * kBK +
                                                 ((kk ^ a_swz) << 2));
#pragma unroll
      for (int c = 0; c < kColsPer; ++c)
        bv[c] = *reinterpret_cast<const float4*>(stage + b_off + c * kTx * kBK + ((kk ^ tx) << 2));
      // One d step at a time over the whole register tile, so that an FFMA's
      // accumulator was last written 50 FFMAs earlier.
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < kRowsPer; ++a)
#pragma unroll
          for (int c = 0; c < kColsPer; ++c)
            acc[a][c] = fmaf(reinterpret_cast<const float*>(&av[a])[e],
                             reinterpret_cast<const float*>(&bv[c])[e], acc[a][c]);
    }
  }
  if constexpr (!kTma) cp_async_wait<0>();
  __syncthreads();  // the ring is idle: it takes the partial tile

  float* part = ring;
  float* fin = ring + kS * kPartStride;
#pragma unroll
  for (int a = 0; a < kRowsPer; ++a)
#pragma unroll
    for (int c = 0; c < kColsPer; ++c)
      part[(ty + kTy * a) * kPartStride + tx + kTx * c] = acc[a][c];
  cluster.sync();  // every partial of the cluster is written and visible

  // Rows r_lo .. r_lo + rows - 1 of the tile, four columns a thread at a
  // time, summed over the cluster in rank order, to G[i0 + r][j0 + c] and to
  // `fin`.
  const int r_lo = rank * kS / k_split;
  const int rows = (rank + 1) * kS / k_split - r_lo;
  const bool vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  float* gt = g + static_cast<size_t>(t) * L * L;
  for (int e = tid; e < rows * (kS / 4); e += kThreads) {
    const int r = e / (kS / 4);
    const int c = 4 * (e % (kS / 4));
    const float4 v = cluster_sum4<kMaxCluster>(cluster, part, (r_lo + r) * kPartStride + c,
                                               k_split);
    float* f = fin + r * kFinStride + c;
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
    const int i = i0 + r_lo + r;
    const int j = j0 + c;
    if (i >= L || j >= L) continue;
    store4(gt + static_cast<size_t>(i) * L + j, v, j, L, vec);
  }
  if (ti != tj) {
    // Off the diagonal the same sums, transposed: G[j0 + c][i0 + r_lo + r]
    // from the finished rows, in runs of `rows` along each row of G.
    __syncthreads();
    for (int e = tid; e < kS * rows; e += kThreads) {
      const int c = e / rows;
      const int r = e % rows;
      const int i = i0 + r_lo + r;
      const int j = j0 + c;
      if (i < L && j < L) gt[static_cast<size_t>(j) * L + i] = fin[r * kFinStride + c];
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

template <bool kTma>
cudaError_t launch(const float* b, float* g, int T, int L, int d, cudaStream_t stream) {
  CUtensorMap map_b = {};
  if (kTma && !make_map(&map_b, b, T, L, d, kBK, kS, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  auto kernel = fd_gram_kernel<kTma>;
  int sms = 0;
  const cudaError_t err = prepare(kernel, kSmemBytes, &sms);
  if (err != cudaSuccess) return err;
  // d across the blocks of a cluster where the tiles leave SMs idle.
  const int n = (L + kS - 1) / kS;
  const int upper = n * (n + 1) / 2;
  const int n_slabs = (d + kBK - 1) / kBK;
  const int csize =
      choose_split(static_cast<long long>(upper) * T, n_slabs, sms, kMaxCluster, kBusyBlocks);
  return launch_clusters(kernel, dim3(csize * upper, T), kThreads, csize, kSmemBytes, stream,
                         map_b, b, g, L, d);
}

}  // namespace

// b: (T, L, d) f32 contiguous; g: (T, L, L) f32 contiguous.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int fd_gram_launch(const float* b, float* g, int T, int L, int d,
                              cudaStream_t stream) {
  cudaError_t launched = cudaSuccess;
  if (T > 0 && L > 0) {
    const bool tma = d > 0 && d % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
    launched = tma ? launch<true>(b, g, T, L, d, stream) : launch<false>(b, g, T, L, d, stream);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}
