// Stacked FD Gram product  G_t = B_t B_t^T :  (T, L, d) f32 -> (T, L, L) f32.
//
// Replaces the Pallas kernels
//   src/repro/kernels/fd_gram.py          fd_gram_pallas          (T = 1)
//   src/repro/kernels/fd_shrink_fused.py  fd_gram_batched_pallas  (T = sites or tenants)
//
// On the TPU one core walked a sequential grid over d-blocks and carried the
// (L, L) sum in VMEM from step to step.  Here each block owns one 32 x 32
// output tile of one G_t and carries that sum itself: a loop over d inside
// the block stages a 32-wide slab of the tile's row strip and of its column
// strip in shared memory and accumulates in registers.  Every element is
// summed by one thread in one fixed order, so runs are repeatable (no
// atomics), and G is exactly symmetric: G[i][j] and G[j][i] see the same
// products in the same order.
//
// What bounds it on an H100: operations.  At the main shapes (T = 8,
// L = 2l = 400, d = 1024) the kernel does 2.6 GFLOP on 13 MB of input, far
// above the f32 ridge point of 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte, and
// TF32 is deliberately not used (the port is held to the reference at
// 1e-5), so the ceiling is the CUDA cores' f32 FMA rate.  The design does
// about that: each thread keeps a 2 x 2 register tile, reads its operands
// from shared memory without bank conflicts (rows padded to 33 words,
// threads laid out so a warp reads consecutive banks), and the loads from
// device memory are coalesced along d.  It does not yet reach the f32 peak:
// the register tile is small, and wgmma/TMA are later work.  It also
// computes both triangles of the symmetric G, twice the L (L + 1) / 2 dot
// products the function needs (1.3 GFLOP at the main shapes, which is what
// its bound counts); launching only the upper tiles and mirroring them is
// later work too.
//
// Blocks in flight: ceil(L/32)^2 * T.  At T = 1 that is 169 blocks at
// L = 400 and 9 at the reference's default eps = 0.1 (L = 80), on 132 SMs;
// at T = 8 and L = 400, 1352.  No split over d (partials, then a reduce) is
// used: at L = 400 the 169 blocks already cover the card, and the L = 80
// case is too small to be worth a second pass.
//
// Any L and d: rows past L and columns past d load as zeros (exact for a
// sum of products), and the store is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;    // output tile edge
constexpr int kChunk = 32;   // d-slab staged per step
constexpr int kSide = 16;    // 16 x 16 threads; each owns rows ty, ty+16 and cols tx, tx+16

__global__ void __launch_bounds__(kSide * kSide)
fd_gram_kernel(const float* __restrict__ b, float* __restrict__ g, int L, int d) {
  __shared__ float rows_i[kTile][kChunk + 1];
  __shared__ float rows_j[kTile][kChunk + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const float* bt = b + static_cast<size_t>(blockIdx.z) * L * d;

  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = 0; k0 < d; k0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kSide * kSide) {
      const int r = e / kChunk;
      const int c = e % kChunk;
      const int k = k0 + c;
      const int ri = i0 + r;
      const int rj = j0 + r;
      rows_i[r][c] = (ri < L && k < d) ? bt[static_cast<size_t>(ri) * d + k] : 0.f;
      rows_j[r][c] = (rj < L && k < d) ? bt[static_cast<size_t>(rj) * d + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float a0 = rows_i[ty][c];
      const float a1 = rows_i[ty + kSide][c];
      const float b0 = rows_j[tx][c];
      const float b1 = rows_j[tx + kSide][c];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }

  float* gt = g + static_cast<size_t>(blockIdx.z) * L * L;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = i0 + ty + a * kSide;
      const int j = j0 + tx + c * kSide;
      if (i < L && j < L) gt[static_cast<size_t>(i) * L + j] = acc[a][c];
    }
  }
}

}  // namespace

// b: (T, L, d) f32 contiguous; g: (T, L, L) f32 contiguous.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int fd_gram_launch(const float* b, float* g, int T, int L, int d,
                              cudaStream_t stream) {
  if (T > 0 && L > 0) {
    const dim3 grid((L + kTile - 1) / kTile, (L + kTile - 1) / kTile, T);
    const dim3 block(kSide, kSide);
    fd_gram_kernel<<<grid, block, 0, stream>>>(b, g, L, d);
  }
  return static_cast<int>(cudaGetLastError());
}
