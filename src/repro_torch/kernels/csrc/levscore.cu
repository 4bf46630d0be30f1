// Batched ridge leverage scores  tau_j = x_j^T M x_j :
//   M (d, d) f32, X (N, d) f32 -> tau (N,) f32.
//
// Replaces the Pallas kernel
//   src/repro/kernels/levscore.py  levscore_pallas
//
// It computes o_j = sum_i (sum_k x_jk M_ki) x_ji, contracting with M[k, i]
// exactly as the reference does: M is a pseudo-inverse, symmetric only to
// rounding, so M^T is never used in its place.
//
// On the TPU the grid (N / BLOCK_N, d / BLOCK_D) ran d innermost and in
// order, adding each column slab's y * X_slab into one resident output
// block.  Blocks on the card run in no order, so the slabs become a grid
// axis of their own and a second pass sums them:
//
//   pass 1, block (j-tile, i-slab): 32 query rows x 128 columns of M.  It
//     accumulates y = X[j-tile, :] @ M[:, i-slab] over k in 32-wide steps,
//     staging X[j-tile, k-step] and M[k-step, i-slab] in shared memory; each
//     thread holds a 4 x 4 register tile of y (rows ty + 8a, columns
//     tx + 32b), so every k step costs 8 shared-memory reads for 16 FMAs.
//     It then multiplies y by the same X entries, read again as the (j, i)
//     slab, sums each row over its 128 columns (a fixed butterfly of warp
//     shuffles) and stores one partial per (slab, row).  The (N, d) product
//     X M never reaches device memory: only N x ceil(d / 128) partials do.
//   pass 2: tau_j = sum over slabs of the partials, in slab order.
//
// No atomics and no order that depends on scheduling, so two runs are
// bit-equal.  At the serving shape (N = 1024, d = 1024) pass 1 runs
// 32 x 8 = 256 blocks on the 132 SMs.
//
// What bounds it on an H100: operations.  2 N d^2 = 2.15 GFLOP on 8.4 MB of
// inputs, far above the f32 ridge point, with TF32 off (the port is held
// to 1e-5).  Each block reads its 128-column slab of M once per 32 query
// rows (from L2, where the 4 MB factor stays resident).
//
// Any N and d: rows past N and columns past d load as zeros, only rows
// below N are stored, and no padding copies are made.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;     // query rows per block
constexpr int kCols = 128;    // columns of M per block (one slab)
constexpr int kStep = 32;     // k depth staged per step
constexpr int kTx = 32;       // threads along the slab's columns
constexpr int kTy = 8;        // threads along the query rows
constexpr int kRowsPer = kRows / kTy;  // 4: rows ty, ty+8, ty+16, ty+24
constexpr int kColsPer = kCols / kTx;  // 4: columns tx, tx+32, tx+64, tx+96

__global__ void __launch_bounds__(kTx * kTy)
levscore_partial_kernel(const float* __restrict__ m, const float* __restrict__ x,
                        float* __restrict__ part, int N, int d) {
  __shared__ float x_tile[kRows][kStep + 1];
  __shared__ float m_tile[kStep][kCols];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTx + tx;
  const int j0 = blockIdx.x * kRows;
  const int i0 = blockIdx.y * kCols;

  float y[kRowsPer][kColsPer];
#pragma unroll
  for (int a = 0; a < kRowsPer; ++a)
#pragma unroll
    for (int b = 0; b < kColsPer; ++b) y[a][b] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kStep) {
    for (int e = tid; e < kRows * kStep; e += kTx * kTy) {
      const int r = e / kStep;
      const int c = e % kStep;
      const int j = j0 + r;
      const int k = k0 + c;
      x_tile[r][c] = (j < N && k < d) ? x[static_cast<size_t>(j) * d + k] : 0.f;
    }
    for (int e = tid; e < kStep * kCols; e += kTx * kTy) {
      const int r = e / kCols;
      const int c = e % kCols;
      const int k = k0 + r;
      const int i = i0 + c;
      m_tile[r][c] = (k < d && i < d) ? m[static_cast<size_t>(k) * d + i] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kStep; ++c) {
      float xv[kRowsPer];
      float mv[kColsPer];
#pragma unroll
      for (int a = 0; a < kRowsPer; ++a) xv[a] = x_tile[ty + a * kTy][c];
#pragma unroll
      for (int b = 0; b < kColsPer; ++b) mv[b] = m_tile[c][tx + b * kTx];
#pragma unroll
      for (int a = 0; a < kRowsPer; ++a)
#pragma unroll
        for (int b = 0; b < kColsPer; ++b) y[a][b] = fmaf(xv[a], mv[b], y[a][b]);
    }
    __syncthreads();
  }

  // Reduce: row sums of y * X over this slab's columns.  One warp is one ty
  // (all 32 tx), so each row's 128 products live in one warp.
#pragma unroll
  for (int a = 0; a < kRowsPer; ++a) {
    const int j = j0 + ty + a * kTy;
    float s = 0.f;
    if (j < N) {
#pragma unroll
      for (int b = 0; b < kColsPer; ++b) {
        const int i = i0 + tx + b * kTx;
        if (i < d) s = fmaf(y[a][b], x[static_cast<size_t>(j) * d + i], s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (tx == 0 && j < N) part[static_cast<size_t>(blockIdx.y) * N + j] = s;
  }
}

__global__ void levscore_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int N, int slabs) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  float s = 0.f;
  for (int t = 0; t < slabs; ++t) s += part[static_cast<size_t>(t) * N + j];
  out[j] = s;
}

}  // namespace

// m: (d, d), x: (N, d), out: (N,), part: part_len floats of scratch, at
// least ceil(d / 128) * N (one partial per column slab and query row); all
// f32 contiguous, N > 0 and d > 0 (the wrapper answers the empty cases).
// Launches both passes on `stream`, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for short scratch.
extern "C" int levscore_launch(const float* m, const float* x, float* out, float* part, int N,
                               int d, long long part_len, cudaStream_t stream) {
  if (N > 0 && d > 0) {
    const int slabs = (d + kCols - 1) / kCols;
    if (part_len < static_cast<long long>(slabs) * N) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((N + kRows - 1) / kRows, slabs);
    const dim3 block(kTx, kTy);
    levscore_partial_kernel<<<grid, block, 0, stream>>>(m, x, part, N, d);
    levscore_sum_kernel<<<(N + 255) / 256, 256, 0, stream>>>(part, out, N, slabs);
  }
  return static_cast<int>(cudaGetLastError());
}
