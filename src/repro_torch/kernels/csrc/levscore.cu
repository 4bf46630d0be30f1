// Batched ridge leverage scores  tau_j = x_j^T M x_j = sum_k x_jk (sum_i M_ki x_ji) :
//   M (d, d) f32, X (N, d) f32 -> tau (N,) f32.
//
// Replaces the Pallas kernel
//   src/repro/kernels/levscore.py:71  levscore_pallas
//
// M is a pseudo-inverse, symmetric only to rounding: the kernel contracts
// M[k, i] with x_ji and then with x_jk, which is x^T M x, and never reads M^T
// in its place.  Only the order of the f32 sums differs from the reference's
// (x @ M * x).sum(1).
//
// On the TPU the grid (N / BLOCK_N, d / BLOCK_D) ran d innermost and in
// order, adding each column slab's y * X_slab into one resident output
// block, so the (N, d) product X M never reached device memory.  Here it
// never does either.  tau is bilinear in the product's pieces, so any piece
// of sum_i M_ki x_ji (some rows k of M, summed over some of the columns i)
// can be multiplied by x_jk and added into a per-direction partial score by
// whichever block computed it; only 40 partial scores a block remain, and a
// second launch adds them in a fixed order.
//
// What bounds it on an H100: operations.  2 N d^2 FLOPs: 2.15 GFLOP at the
// served score queries (N = 1024, d = 1024) on 8.4 MB of inputs, 32 us at the
// 67 TFLOP/s of IEEE f32 FMAs on the CUDA cores.  The products are plain
// fmaf, with no TF32 and no tensor cores: the port is held to the reference
// at 1e-5.  What the design does about each limit of the kernel it replaces
// (scalar staging into one buffer, a 4 x 4 register tile read by scalar
// shared loads, too few blocks at small N):
//
//  * The form of the product.  sum_i M_ki x_ji contracts along i, and both
//    M's rows and X's rows are contiguous along i: this is quadform.cu's
//    product with M in the place of B, with the epilogue multiplying each
//    dot product by x_jk where quadform squares it.  Both operands are read
//    as float4s along the contraction from stages in the TMA's 128-byte
//    swizzle.  (fd_project.cu's outer-product form, Y = X M down M's rows
//    with X read as float4s along k, measured no faster on the card.)
//  * Shared-memory loads.  Each of the 128 threads (8 direction groups x 16
//    row groups) holds a 5 x 8 register tile: directions ty + 8a and rows
//    tx + 16c of M.  One float4 read brings four i steps of one direction or
//    row: 13 reads feed 160 FFMAs, 12.3 FFMAs a shared-load instruction.  A
//    warp holds 4 direction groups x 8 row groups, and the 4 directions and
//    8 rows it reads at one i fall in distinct banks through the swizzle.
//  * Blocks to fill the card, evenly.  A tile of 40 directions keeps small N
//    in many tiles (N = 300: 8, N = 1024: 26); 128 directions would leave
//    N = 300 three.  A tile's work is the ceil(d / 128) tiles of 128 rows of
//    M times the ceil(d / 32) slabs of i, taken in that order as one range
//    of units, which `split` blocks share in contiguous pieces.  A piece may
//    end inside a row tile (the i sum is split) or cross into the next one
//    (the block folds the finished row tile into its partial scores and
//    goes on).  choose_split (f32_staging.cuh), with busy = 1 on the 396
//    blocks the SMs hold at once (three each), picks the split for the
//    fewest waves: N = 1024 runs 26 x 15 = 390 blocks (three on 126 SMs,
//    two on 6) and N = 300 8 x 43 = 344 (three on 80 SMs, two on 52), all
//    resident at once.  The model is coarse (it prices neither the blocks
//    whose piece crosses a row tile nor how busy two blocks keep an SM);
//    PERF.md §6 holds fixed splits measured against its choice.
//  * A second launch, not a cluster.  The pieces' partials could meet
//    through distributed shared memory if a tile's blocks formed a thread
//    block cluster, as in quadform.cu, but a cluster is placed whole inside
//    one GPC: at three blocks an SM fewer clusters of 15 or 16 blocks fit on
//    an H100 at once than the 26 that N = 1024 needs
//    (cudaOccupancyMaxActiveClusters), so they ran in two waves, and
//    clusters small enough to fit left SMs with three blocks beside SMs
//    with two.  Both measured slower than this design with its second pass,
//    which reads split x N partial scores and adds them in piece order.  It
//    is launched as a programmatic dependent (PDL), so that its launch
//    overlaps the first kernel and it starts as soon as that grid is done.
//    With split = 1 (large N) the first kernel stores the scores itself and
//    there is no second launch.
//  * Reduction in a fixed order.  Each thread's five partial scores are
//    summed over the 16 row groups in order through shared memory, and the
//    pieces of a tile in piece order by the second pass.  No atomics: two
//    runs are bit-equal.
//  * Staging.  A ring of 3 stages, each one 32-wide i slab of the 40
//    directions and of the 128 rows of M, filled by two TMA box loads issued
//    by one thread two units ahead of the FFMAs and completing on the
//    stage's mbarrier; one __syncthreads a unit.  Directions past N and rows
//    and columns past d arrive as zeros.  The x_jk of the epilogue are read
//    from global memory (L2), 40 a thread for each row tile a block
//    finishes, all issued before the first of them is used (read one by one
//    into a reused register, they stalled the block for forty trips to L2).
//
// Any N >= 1 and d >= 1 (the wrapper answers N = 0 and d = 0).  Only
// directions below N are stored.  Where TMA cannot take the operands
// (d % 4 != 0, or a base pointer off 16-byte alignment, as in an offset
// view), the same kernel stages by 4-byte cp.async copies, zero-filled past
// the edges, into the same layout; nothing is copied to fix alignment.

#include <algorithm>
#include <mutex>

#include "f32_staging.cuh"

namespace {

constexpr int kTy = 8;             // direction groups of threads
constexpr int kTx = 16;            // row groups of threads
constexpr int kThreads = kTy * kTx;
constexpr int kDirsPer = 5;        // directions a thread holds: ty + kTy * a
constexpr int kRowsPer = 8;        // rows of M a thread holds: tx + kTx * c
constexpr int kNT = kTy * kDirsPer;  // directions per tile: 40
constexpr int kMT = kTx * kRowsPer;  // rows of M per row tile: 128
constexpr int kBK = kSlab;         // i slab staged per unit: one 128-byte row
constexpr int kStages = 3;         // ring of units
constexpr int kMinBlocks = 3;      // blocks an SM holds: caps registers at 168
constexpr int kMaxSplit = 64;      // blocks sharing one tile at most
constexpr int kMaxBlocks = 2048;   // blocks of a split launch at most (N x split partials)
constexpr int kTileBytes = (kNT + kMT) * kBK * 4;  // what one stage's TMA brings
// A stage holds the directions, then the rows of M at the next 1024-byte
// boundary (the period of the 128-byte swizzle).
constexpr int kXFloats = (kNT * kBK * 4 + 1023) / 1024 * 1024 / 4;
constexpr int kStageFloats = kXFloats + kMT * kBK;
constexpr int kStageBytes = kStageFloats * 4;
// Dynamic shared memory: the ring, its full barriers, and slack to align the
// ring to 1024 bytes.
constexpr int kSmemBytes = kStages * kStageBytes + 8 * kStages + 1024;
static_assert(kTy == 8 && kTx % 8 == 0, "warps of 4 x 8 threads; rows ty + 8a share a swizzle");
static_assert(kStageBytes % 1024 == 0, "layout");
static_assert(kTx * kNT <= kStages * kStageFloats, "row-group sums fit in the ring");

// Grid: split blocks for each direction tile along x, the tile's pieces
// adjacent.  Piece p of a tile takes units [p * units / split, (p + 1) *
// units / split) of the tile's range, unit u being slab u % n_slabs of row
// tile u / n_slabs.  With split = 1 it stores the scores to `out`, else its
// partial scores to part[p * N + j].
template <bool kTma>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
levscore_kernel(const __grid_constant__ CUtensorMap map_m,
                const __grid_constant__ CUtensorMap map_x, const float* __restrict__ m,
                const float* __restrict__ x, float* __restrict__ out, float* __restrict__ part,
                int N, int d, int split) {
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = smem_addr(raw);
  const uint32_t ring_addr = (raw_addr + 1023) & ~1023u;
  float* ring = reinterpret_cast<float*>(raw + (ring_addr - raw_addr));
  const uint32_t full = ring_addr + kStages * kStageBytes;  // kStages mbarriers

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ty = warp / (kTx / 8) * 4 + (lane >> 3);
  const int tx = warp % (kTx / 8) * 8 + (lane & 7);
  const int piece = static_cast<int>(blockIdx.x % split);
  const int j0 = static_cast<int>(blockIdx.x / split) * kNT;

  const int n_slabs = (d + kBK - 1) / kBK;
  const int units = (d + kMT - 1) / kMT * n_slabs;
  const int u0 = static_cast<int>(static_cast<long long>(piece) * units / split);
  const int steps = static_cast<int>(static_cast<long long>(piece + 1) * units / split) - u0;

  // Let the second pass launch now: it waits for this grid to finish.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (kTma && tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int s) {
    const int st = s % kStages;
    float* stage = ring + st * kStageFloats;
    const int u = u0 + s;
    const int i0 = u % n_slabs * kBK;  // the slab of i
    const int r0 = u / n_slabs * kMT;  // the tile of rows of M
    if constexpr (kTma) {
      if (tid == 0 && s < steps) {
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, kTileBytes);
        tma_load(smem_addr(stage), &map_x, i0, j0, 0, bar);
        tma_load(smem_addr(stage + kXFloats), &map_m, i0, r0, 0, bar);
      }
    } else {
      if (s < steps) {
        stage_scalar<kNT, kThreads>(stage, x, j0, N, i0, d, tid);
        stage_scalar<kMT, kThreads>(stage + kXFloats, m, r0, d, i0, d, tid);
      }
      cp_async_commit();  // an empty group past the end keeps the count uniform
    }
  };

  // This thread's float offsets of its directions and rows in a stage, and
  // the swizzle of its 16-byte chunks (the same for all its directions,
  // ty + 8a, and all its rows, tx + 16c).
  const int x_off = ty * kBK;
  const int m_off = kXFloats + tx * kBK;
  const int x_swz = ty & 7;
  const int m_swz = tx & 7;

  float acc[kDirsPer][kRowsPer];
  float score[kDirsPer];
#pragma unroll
  for (int a = 0; a < kDirsPer; ++a) {
    score[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kRowsPer; ++c) acc[a][c] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    const int st = s % kStages;
    if constexpr (kTma) {
      mbar_wait(full + 8 * st, (s / kStages) & 1);  // unit s has landed
    } else {
      cp_async_wait<kStages - 2>();  // this thread's copies of unit s have landed
    }
    __syncthreads();         // everyone's have; everyone is done with unit s - 1
    issue(s + kStages - 1);  // refill the stage unit s - 1 was read from
    const float* stage = ring + st * kStageFloats;
#pragma unroll
    for (int kk = 0; kk < kBK / 4; ++kk) {
      float4 xv[kDirsPer], mv[kRowsPer];
#pragma unroll
      for (int a = 0; a < kDirsPer; ++a)
        xv[a] = *reinterpret_cast<const float4*>(stage + x_off + a * kTy * kBK +
                                                 ((kk ^ x_swz) << 2));
#pragma unroll
      for (int c = 0; c < kRowsPer; ++c)
        mv[c] = *reinterpret_cast<const float4*>(stage + m_off + c * kTx * kBK +
                                                 ((kk ^ m_swz) << 2));
      // One i step at a time over the whole register tile, so that an
      // FFMA's accumulator was last written 40 FFMAs earlier.
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < kDirsPer; ++a)
#pragma unroll
          for (int c = 0; c < kRowsPer; ++c)
            acc[a][c] = fmaf(reinterpret_cast<const float*>(&xv[a])[e],
                             reinterpret_cast<const float*>(&mv[c])[e], acc[a][c]);
    }
    const int u = u0 + s;
    if (s == steps - 1 || (u + 1) % n_slabs == 0) {
      // This block's share of the i sum of row tile u / n_slabs is done:
      // fold it into the partial scores, sum_k x_jk * acc, in row order.
      // All 40 loads are issued before the first FMA that needs one, so
      // that the block waits out one trip to L2, not forty.
      const int r0 = u / n_slabs * kMT;
      float xk[kDirsPer][kRowsPer];
#pragma unroll
      for (int a = 0; a < kDirsPer; ++a) {
        const int j = j0 + ty + kTy * a;
        const float* xj = x + static_cast<size_t>(j < N ? j : 0) * d;
#pragma unroll
        for (int c = 0; c < kRowsPer; ++c) {
          const int k = r0 + tx + kTx * c;
          xk[a][c] = j < N && k < d ? __ldg(xj + k) : 0.f;
        }
      }
#pragma unroll
      for (int a = 0; a < kDirsPer; ++a)
#pragma unroll
        for (int c = 0; c < kRowsPer; ++c) {
          score[a] = fmaf(acc[a][c], xk[a][c], score[a]);
          acc[a][c] = 0.f;
        }
    }
  }
  if constexpr (!kTma) cp_async_wait<0>();
  __syncthreads();  // the ring is idle: it takes the row-group sums

  // Sum the 16 row groups in order through the ring.
  auto row_sums = reinterpret_cast<float (*)[kNT]>(ring);
#pragma unroll
  for (int a = 0; a < kDirsPer; ++a) row_sums[tx][ty + kTy * a] = score[a];
  __syncthreads();
  const int j = j0 + tid;
  if (tid < kNT && j < N) {
    float v = 0.f;
#pragma unroll
    for (int g = 0; g < kTx; ++g) v += row_sums[g][tid];
    if (split == 1) {
      out[j] = v;
    } else {
      part[static_cast<size_t>(piece) * N + j] = v;
    }
  }
}

// tau_j = the partial scores of direction j summed over the pieces in order.
// Launched as a programmatic dependent of levscore_kernel: it waits here
// until that grid has finished and its stores are visible.
__global__ void levscore_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int N, int split) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  float v = 0.f;
  for (int p = 0; p < split; ++p) v += part[static_cast<size_t>(p) * N + j];
  out[j] = v;
}

// The SM count and the blocks of levscore_kernel<kTma> an SM holds on the
// current device: queried, and the kernel's shared memory set, once a device.
template <bool kTma>
cudaError_t residency(int* sms, int* per_sm) {
  constexpr int kDevices = 64;
  static std::mutex lock;
  static int known_sms[kDevices], known_per_sm[kDevices];  // 0: not yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool cached = device < kDevices;
  std::lock_guard<std::mutex> hold(lock);
  if (cached && known_per_sm[device] > 0) {
    *sms = known_sms[device];
    *per_sm = known_per_sm[device];
    return cudaSuccess;
  }
  auto kernel = levscore_kernel<kTma>;
  err = prepare(kernel, kSmemBytes, sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, kSmemBytes);
  if (err == cudaSuccess && cached) {
    known_sms[device] = *sms;
    known_per_sm[device] = *per_sm;
  }
  return err;
}

// How a launch runs these operands: staged by TMA or by 4-byte copies, and
// each tile of 40 directions over `split` blocks, for the fewest waves of the
// blocks the card holds at once (choose_split with busy = 1 on that many
// slots), at most kMaxBlocks in all.
struct Plan {
  bool tma;
  int split;
};

cudaError_t plan(const float* m, const float* x, int N, int d, Plan* p) {
  p->tma = d % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(x) % 16 == 0;
  int sms = 0, per_sm = 0;
  const cudaError_t err =
      p->tma ? residency<true>(&sms, &per_sm) : residency<false>(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  const long long tiles = (N + kNT - 1) / kNT;
  const int units = (d + kMT - 1) / kMT * ((d + kBK - 1) / kBK);
  const int max_split =
      static_cast<int>(std::min<long long>(kMaxSplit, std::max(1LL, kMaxBlocks / tiles)));
  p->split = choose_split(tiles, units, sms * per_sm, max_split, 1);
  return cudaSuccess;
}

template <bool kTma>
cudaError_t launch(const float* m, const float* x, float* out, float* part, int N, int d,
                   int split, cudaStream_t stream) {
  CUtensorMap map_m = {}, map_x = {};
  if (kTma && !(make_map(&map_m, m, 1, d, d, kBK, kMT, CU_TENSOR_MAP_SWIZZLE_128B) &&
                make_map(&map_x, x, 1, N, d, kBK, kNT, CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  const long long tiles = (N + kNT - 1) / kNT;
  levscore_kernel<kTma><<<static_cast<unsigned>(tiles * split), kThreads, kSmemBytes, stream>>>(
      map_m, map_x, m, x, out, part, N, d, split);
  if (split == 1) return cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, levscore_sum_kernel, static_cast<const float*>(part), out, N,
                            split);
}

}  // namespace

// Floats of scratch levscore_launch needs for the partial scores of these
// operands: split x N where it splits, else 0; or minus a CUDA error.
extern "C" long long levscore_scratch_floats(const float* m, const float* x, int N, int d) {
  if (N <= 0 || d <= 0) return 0;
  Plan p;
  const cudaError_t err = plan(m, x, N, d, &p);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return p.split > 1 ? static_cast<long long>(p.split) * N : 0;
}

// m: (d, d), x: (N, d), out: (N,); all f32 contiguous.  part: part_len
// floats of scratch, at least levscore_scratch_floats(m, x, N, d).  Launches
// on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int levscore_launch(const float* m, const float* x, float* out, float* part,
                               long long part_len, int N, int d, cudaStream_t stream) {
  cudaError_t launched = cudaSuccess;
  if (N > 0 && d > 0) {
    Plan p;
    launched = plan(m, x, N, d, &p);
    if (launched == cudaSuccess && p.split > 1 && part_len < static_cast<long long>(p.split) * N)
      launched = cudaErrorInvalidValue;
    if (launched == cudaSuccess)
      launched = p.tma ? launch<true>(m, x, out, part, N, d, p.split, stream)
                       : launch<false>(m, x, out, part, N, d, p.split, stream);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}
