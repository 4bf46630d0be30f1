// Packed batched quadratic form  q_tj = ||B_t x_tj||^2 :
//   B (T, L, d) f32, X (T, N, d) f32 -> q (T, N) f32.
//
// Replaces the Pallas kernels
//   src/repro/kernels/quadform.py  quadform_pallas         (T = 1)
//   src/repro/kernels/quadform.py  quadform_packed_pallas  (T = tenants)
//
// As on the TPU, the (L, N) product B X^T never reaches device memory.  On
// the TPU the grid's innermost d axis carried a (L, BLOCK_N) accumulator in
// VMEM and squared it on the last step.  Here each block owns a tile of 16
// directions of one tenant and loops over all of L and d itself: for each
// 64-row tile of B it accumulates the (64, 16) product over d in registers
// (4 rows per thread), then squares it and adds it into one running sum per
// thread.  After the last L tile the 16 row-group sums of each direction are
// added in a fixed order through shared memory.  No block reads another
// block's result, so there is no reduction across blocks and runs are
// repeatable.
//
// What bounds it on an H100: operations.  At the serving shape (N = 1024,
// L = 200, d = 1024) it does 0.42 GFLOP per tenant on under 5 MB, far above
// the f32 ridge point, with TF32 off.  Each block re-reads B (from L2, where
// the 0.8 MB sketch stays resident) once per 16 directions and its own
// direction slab once per L tile; the shared-memory slabs are padded to 33
// words so the 16 directions of a half-warp read 16 different banks.  With
// 16 directions a block there are ceil(N/16) * T blocks in flight: 64 for
// one 1024-direction batch, 512 for 8 packed tenants.
//
// Any L, N and d: rows past L, directions past N and columns past d load as
// zeros, and only directions below N are stored.  L = 0 (an empty sketch)
// stores zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kDirs = 16;    // directions per block (threadIdx.x)
constexpr int kGroups = 16;  // row groups per block (threadIdx.y)
constexpr int kRowsPer = 4;  // rows per thread: ty, ty+16, ty+32, ty+48
constexpr int kRows = kGroups * kRowsPer;  // 64-row tile of B
constexpr int kChunk = 32;   // d-slab staged per step

__global__ void __launch_bounds__(kDirs * kGroups)
quadform_kernel(const float* __restrict__ b, const float* __restrict__ x,
                float* __restrict__ q, int L, int N, int d) {
  __shared__ float b_slab[kRows][kChunk + 1];
  __shared__ float x_slab[kDirs][kChunk + 1];
  __shared__ float partial[kGroups][kDirs + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kDirs + tx;
  const int j0 = blockIdx.x * kDirs;
  const size_t t = blockIdx.y;
  const float* bt = b + t * L * d;
  const float* xt = x + t * N * d;

  float sum = 0.f;
  for (int l0 = 0; l0 < L; l0 += kRows) {
    float acc[kRowsPer] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < d; k0 += kChunk) {
      for (int e = tid; e < kRows * kChunk; e += kDirs * kGroups) {
        const int r = e / kChunk;
        const int c = e % kChunk;
        const int row = l0 + r;
        const int k = k0 + c;
        b_slab[r][c] = (row < L && k < d) ? bt[static_cast<size_t>(row) * d + k] : 0.f;
      }
      for (int e = tid; e < kDirs * kChunk; e += kDirs * kGroups) {
        const int r = e / kChunk;
        const int c = e % kChunk;
        const int j = j0 + r;
        const int k = k0 + c;
        x_slab[r][c] = (j < N && k < d) ? xt[static_cast<size_t>(j) * d + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float xv = x_slab[tx][c];
#pragma unroll
        for (int a = 0; a < kRowsPer; ++a) acc[a] = fmaf(b_slab[ty + a * kGroups][c], xv, acc[a]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < kRowsPer; ++a) sum = fmaf(acc[a], acc[a], sum);
  }

  partial[ty][tx] = sum;
  __syncthreads();
  const int j = j0 + tx;
  if (ty == 0 && j < N) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) total += partial[g][tx];
    q[t * N + j] = total;
  }
}

}  // namespace

// b: (T, L, d), x: (T, N, d), q: (T, N); all f32 contiguous.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int quadform_launch(const float* b, const float* x, float* q, int T, int L, int N,
                               int d, cudaStream_t stream) {
  if (T > 0 && N > 0) {
    const dim3 grid((N + kDirs - 1) / kDirs, T);
    const dim3 block(kDirs, kGroups);
    quadform_kernel<<<grid, block, 0, stream>>>(b, x, q, L, N, d);
  }
  return static_cast<int>(cudaGetLastError());
}
