// Packed batched quadratic form  q_tj = ||B_t x_tj||^2 = sum_l (sum_k B_tlk X_tjk)^2 :
//   B (T, L, d) f32, X (T, N, d) f32 -> q (T, N) f32.
//
// Replaces the Pallas kernels
//   src/repro/kernels/quadform.py:127  quadform_pallas         (T = 1)
//   src/repro/kernels/quadform.py:92   quadform_packed_pallas  (T = tenants)
//
// As on the TPU, the (L, N) product B X^T never reaches device memory.  On
// the TPU the grid's innermost d axis carried a (L, BLOCK_N) accumulator in
// VMEM and squared it on the last step.  Here a block owns a tile of 128
// directions and one 40-row tile of B at a time, accumulates that product
// over its share of d in registers, and squares it once the tile is summed
// over all of d.
//
// What bounds it on an H100: operations.  2 T L N d FLOPs on about 5 MB of
// inputs a tenant: at the serving shape (L = 200, N = 1024, d = 1024) 0.42
// GFLOP a tenant, 6.3 us at the 67 TFLOP/s of IEEE f32 FMAs on the CUDA
// cores.  The products are plain fmaf, with no TF32 and no tensor cores: the
// port is held to the reference at 1e-5.  What the design does about each
// limit of the kernel it replaces:
//
//  * Shared-memory loads.  Each of the 128 threads (8 row groups x 16
//    direction groups) holds a 5 x 8 register tile of the product: rows
//    ty + 8a of the B tile, directions tx + 16c.  Its operands lie in shared
//    memory along k, so one float4 read (LDS.128) brings four k steps of one
//    row or direction: 13 reads feed 160 FFMAs, 12.3 FFMAs a shared-load
//    instruction.  A warp holds 4 row groups x 8 direction groups, and the
//    stages are laid out in the TMA's 128-byte swizzle, so the 4 rows and 8
//    directions a warp reads at one k fall in distinct banks.
//  * Blocks to fill the card.  A thread block cluster of l_split x k_split
//    blocks shares one direction tile.  L is split across l_split =
//    min(8, ceil(L / 40)) of them (rank r takes the L tiles r % l_split,
//    r % l_split + l_split, ...); where that grid leaves SMs idle, d is
//    split across k_split of them as well (up to a cluster of 16, H100's
//    non-portable limit).  At L = 200, N = 1024: T = 1 runs 8 clusters of
//    5 x 3 = 120 blocks, T = 8 runs 64 clusters of 5 x 1 = 320.
//  * Reduction in a fixed order.  The k_split partial products of an L tile
//    meet through distributed shared memory: block k-rank p adds, in k-rank
//    order, the elements i % k_split == p of every partial and squares them.
//    Each block sums its squares per direction (in row order, then over the
//    8 row groups in order), and after a cluster barrier the cluster's
//    block sums are added in rank order.  No second launch, no scratch, no
//    atomics: two runs are bit-equal.
//  * Padding of L.  40-row tiles cover L = 200 exactly: no padded rows (the
//    64-row tiles of the kernel it replaces padded it to 256, 28 %).
//  * Staging.  A ring of 3 stages of 32-wide d slabs (one 128-byte row of
//    each B row and direction), each filled by two TMA box loads issued by
//    one thread two slabs ahead of the FFMAs and completing on the stage's
//    mbarrier; one __syncthreads a slab.  Rows past L, directions past N and
//    columns past d arrive as zeros.  B is read once per direction tile and
//    X once per L tile, from L2.
//
// Any L, N and d.  Only directions below N are stored; L = 0 (an empty
// sketch) stores zeros.  Where TMA cannot take the operands (d % 4 != 0, a
// base pointer off 16-byte alignment, as in an offset view, or L or d = 0),
// the same kernel stages by 4-byte cp.async copies, zero-filled past the
// edges, into the same layout; nothing is copied to fix alignment.

#include "f32_staging.cuh"

namespace {

constexpr int kTy = 8;             // row groups of threads
constexpr int kTx = 16;            // direction groups of threads
constexpr int kThreads = kTy * kTx;
constexpr int kRowsPer = 5;        // rows a thread holds: ty + kTy * a
constexpr int kDirsPer = 8;        // directions a thread holds: tx + kTx * c
constexpr int kTile = kRowsPer * kDirsPer;
constexpr int kLT = kTy * kRowsPer;  // rows of B per L tile: 40
constexpr int kNT = kTx * kDirsPer;  // directions per block: 128
constexpr int kBK = kSlab;         // d slab staged per step: one 128-byte row
constexpr int kStages = 3;         // ring of d slabs
constexpr int kMinBlocks = 3;      // blocks an SM holds: caps registers at 168
constexpr int kMaxLSplit = 8;      // blocks of a cluster along L
constexpr int kMaxCluster = 16;    // the largest (non-portable) cluster on an H100
constexpr int kTileBytes = (kLT + kNT) * kBK * 4;  // what one stage's TMA brings
// A stage holds the B tile, then the directions at the next 1024-byte
// boundary (the period of the 128-byte swizzle).
constexpr int kXFloats = (kLT * kBK * 4 + 1023) / 1024 * 1024 / 4;
constexpr int kStageFloats = kXFloats + kNT * kBK;
constexpr int kStageBytes = kStageFloats * 4;
// Dynamic shared memory: the ring, its full barriers, and slack to align the
// ring to 1024 bytes.
constexpr int kSmemBytes = kStages * kStageBytes + 8 * kStages + 1024;
static_assert(kTy == 8 && kTx % 8 == 0, "warps of 4 x 8 threads; rows ty + 8a share a swizzle");
static_assert(kNT <= kThreads && kStageBytes % 1024 == 0, "layout");
static_assert(kTile * kThreads <= kStages * kStageFloats, "partial products fit in the ring");
static_assert(kTy * kNT <= kStages * kStageFloats, "row sums fit in the ring");

// Grid: (clusters of l_split x k_split blocks) x direction tiles along x,
// tenants along y.  Block rank r of a cluster takes the L tiles
// r % l_split + i * l_split and the r / l_split-th share of the d slabs.
template <bool kTma>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
quadform_kernel(const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_x, const float* __restrict__ b,
                const float* __restrict__ x, float* __restrict__ q, int L, int N, int d,
                int l_split) {
  extern __shared__ unsigned char raw[];
  __shared__ float block_sums[kNT];
  const uint32_t raw_addr = smem_addr(raw);
  const uint32_t ring_addr = (raw_addr + 1023) & ~1023u;
  float* ring = reinterpret_cast<float*>(raw + (ring_addr - raw_addr));
  const uint32_t full = ring_addr + kStages * kStageBytes;  // kStages mbarriers

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int k_split = csize / l_split;
  const int l_rank = rank % l_split;
  const int k_rank = rank / l_split;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ty = warp / (kTx / 8) * 4 + (lane >> 3);
  const int tx = warp % (kTx / 8) * 8 + (lane & 7);
  const int j0 = static_cast<int>(blockIdx.x / csize) * kNT;
  const int t = blockIdx.y;
  const float* bt = b + static_cast<size_t>(t) * L * d;
  const float* xt = x + static_cast<size_t>(t) * N * d;

  const int n_tiles = (L + kLT - 1) / kLT;
  const int n_slabs = (d + kBK - 1) / kBK;
  const int slab0 = k_rank * n_slabs / k_split;  // this block's share of d
  const int my_slabs = (k_rank + 1) * n_slabs / k_split - slab0;
  const int rounds = (n_tiles + l_split - 1) / l_split;  // the same for the whole cluster
  uint64_t mine = 0;  // the elements of the register tile this block completes
  for (int i = k_rank; i < kTile; i += k_split) mine |= uint64_t{1} << i;
  static_assert(kTile <= 64, "one bit an element");

  if (kTma && tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // This thread's float offsets of its rows and directions in a stage, and
  // the swizzle of its 16-byte chunks (the same for all its rows, ty + 8a,
  // and all its directions, tx + 16c).
  const int b_off = ty * kBK;
  const int x_off = kXFloats + tx * kBK;
  const int b_swz = ty & 7;
  const int x_swz = tx & 7;

  float acc[kRowsPer][kDirsPer];
  float sum[kDirsPer];
#pragma unroll
  for (int c = 0; c < kDirsPer; ++c) sum[c] = 0.f;
  int used = 0;  // slabs through the ring so far: stage and barrier phase

  for (int round = 0; round < rounds; ++round) {
    const int tile = l_rank + round * l_split;
    const int steps = tile < n_tiles ? my_slabs : 0;
    auto issue = [&](int s) {
      const int st = (used + s) % kStages;
      float* stage = ring + st * kStageFloats;
      const int k0 = (slab0 + s) * kBK;
      if constexpr (kTma) {
        if (tid == 0 && s < steps) {
          const uint32_t bar = full + 8 * st;
          mbar_expect_tx(bar, kTileBytes);
          tma_load(smem_addr(stage), &map_b, k0, tile * kLT, t, bar);
          tma_load(smem_addr(stage + kXFloats), &map_x, k0, j0, t, bar);
        }
      } else {
        if (s < steps) {
          stage_scalar<kLT, kThreads>(stage, bt, tile * kLT, L, k0, d, tid);
          stage_scalar<kNT, kThreads>(stage + kXFloats, xt, j0, N, k0, d, tid);
        }
        cp_async_commit();  // an empty group past the end keeps the count uniform
      }
    };

#pragma unroll
    for (int c = 0; c < kDirsPer; ++c)
#pragma unroll
      for (int a = 0; a < kRowsPer; ++a) acc[a][c] = 0.f;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue(s);
    for (int s = 0; s < steps; ++s) {
      const int st = (used + s) % kStages;
      if constexpr (kTma) {
        mbar_wait(full + 8 * st, ((used + s) / kStages) & 1);  // slab s has landed
      } else {
        cp_async_wait<kStages - 2>();  // this thread's copies of slab s have landed
      }
      __syncthreads();         // everyone's have; everyone is done with slab s - 1
      issue(s + kStages - 1);  // refill the stage slab s - 1 was read from
      const float* stage = ring + st * kStageFloats;
#pragma unroll
      for (int kk = 0; kk < kBK / 4; ++kk) {
        float4 bv[kRowsPer], xv[kDirsPer];
#pragma unroll
        for (int a = 0; a < kRowsPer; ++a)
          bv[a] = *reinterpret_cast<const float4*>(stage + b_off + a * kTy * kBK +
                                                   ((kk ^ b_swz) << 2));
#pragma unroll
        for (int c = 0; c < kDirsPer; ++c)
          xv[c] = *reinterpret_cast<const float4*>(stage + x_off + c * kTx * kBK +
                                                   ((kk ^ x_swz) << 2));
        // One k step at a time over the whole register tile, so that an
        // FFMA's accumulator was last written kTile FFMAs earlier.
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int a = 0; a < kRowsPer; ++a)
#pragma unroll
            for (int c = 0; c < kDirsPer; ++c)
              acc[a][c] = fmaf(reinterpret_cast<const float*>(&bv[a])[e],
                               reinterpret_cast<const float*>(&xv[c])[e], acc[a][c]);
      }
    }
    used += steps;
    if constexpr (!kTma) cp_async_wait<0>();
    __syncthreads();  // the ring is idle until the next round's first issue

    if (k_split > 1) {
      // Each of the k_split blocks of this L tile holds its partial product
      // over its share of d.  Block k-rank p completes the elements i with
      // i % k_split == p, adding the k_split partials in k-rank order through
      // distributed shared memory; the other elements become zeros.
#pragma unroll
      for (int i = 0; i < kTile; ++i) ring[i * kThreads + tid] = acc[i / kDirsPer][i % kDirsPer];
      cluster.sync();
#pragma unroll
      for (int i = 0; i < kTile; ++i) acc[i / kDirsPer][i % kDirsPer] = 0.f;
      for (int p = 0; p < k_split; ++p) {
        const float* part = cluster.map_shared_rank(ring, l_rank + p * l_split);
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          if (mine >> i & 1) acc[i / kDirsPer][i % kDirsPer] += part[i * kThreads + tid];
      }
      cluster.sync();  // no block refills its ring while a peer still reads it
    }
    if (tile < n_tiles) {  // square the tile and sum its rows
#pragma unroll
      for (int c = 0; c < kDirsPer; ++c)
#pragma unroll
        for (int a = 0; a < kRowsPer; ++a) sum[c] = fmaf(acc[a][c], acc[a][c], sum[c]);
    }
  }

  // Sum the 8 row groups in order through the ring, then the blocks of the
  // cluster through distributed shared memory, in rank order.
  auto row_sums = reinterpret_cast<float (*)[kNT]>(ring);
#pragma unroll
  for (int c = 0; c < kDirsPer; ++c) row_sums[ty][tx + kTx * c] = sum[c];
  __syncthreads();
  if (tid < kNT) {
    float v = 0.f;
#pragma unroll
    for (int g = 0; g < kTy; ++g) v += row_sums[g][tid];
    block_sums[tid] = v;
  }
  cluster.sync();  // every block's sums are written and visible to the cluster
  if (tid < kNT && tid % csize == rank) {
    float v = 0.f;
    for (int r = 0; r < csize; ++r) v += cluster.map_shared_rank(block_sums, r)[tid];
    const int j = j0 + tid;
    if (j < N) q[static_cast<size_t>(t) * N + j] = v;
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

template <bool kTma>
cudaError_t launch(const float* b, const float* x, float* q, int T, int L, int N, int d,
                   cudaStream_t stream) {
  CUtensorMap map_b = {}, map_x = {};
  if (kTma && !(make_map(&map_b, b, T, L, d, kBK, kLT, CU_TENSOR_MAP_SWIZZLE_128B) &&
                make_map(&map_x, x, T, N, d, kBK, kNT, CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  auto kernel = quadform_kernel<kTma>;
  int sms = 0;
  const cudaError_t err = prepare(kernel, kSmemBytes, &sms);
  if (err != cudaSuccess) return err;
  // L tiles across up to 8 blocks; where that leaves SMs idle, d across
  // k_split of them as well, as far as the cluster size and the slabs allow.
  const int n_tiles = (L + kLT - 1) / kLT;
  const int n_slabs = (d + kBK - 1) / kBK;
  const int l_split = n_tiles < 1 ? 1 : (n_tiles < kMaxLSplit ? n_tiles : kMaxLSplit);
  const long long blocks = static_cast<long long>(l_split) * ((N + kNT - 1) / kNT) * T;
  long long k_split = sms / blocks;
  if (k_split > kMaxCluster / l_split) k_split = kMaxCluster / l_split;
  if (k_split > n_slabs) k_split = n_slabs;
  if (k_split < 1) k_split = 1;
  const int csize = l_split * static_cast<int>(k_split);
  return launch_clusters(kernel, dim3(csize * ((N + kNT - 1) / kNT), T), kThreads, csize,
                         kSmemBytes, stream, map_b, map_x, b, x, q, L, N, d, l_split);
}

}  // namespace

// b: (T, L, d), x: (T, N, d), q: (T, N); all f32 contiguous.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int quadform_launch(const float* b, const float* x, float* q, int T, int L, int N,
                               int d, cudaStream_t stream) {
  cudaError_t launched = cudaSuccess;
  if (T > 0 && N > 0) {
    const bool tma = L > 0 && d > 0 && d % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
    launched = tma ? launch<true>(b, x, q, T, L, N, d, stream)
                   : launch<false>(b, x, q, T, L, N, d, stream);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}
