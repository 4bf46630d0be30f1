// Stacked FD shrink projection  B'_t = diag(w_t) U_t^T B_t :
//   w (T, L) f32, U (T, L, L) f32, B (T, L, d) f32 -> B' (T, L, d) f32 (B's dtype).
//
// Replaces the Pallas kernels
//   src/repro/kernels/fd_project.py       fd_project_pallas          (T = 1)
//   src/repro/kernels/fd_shrink_fused.py  fd_project_batched_pallas  (T = sites or tenants)
// and serves both of their callers: the FD shrink (w = sqrt((lam - delta)+ / lam))
// and the spectrum refresh (w = 1/s, rows below 1e-7 s_max weighted 0).
//
// On the TPU, U and w stayed resident in VMEM while B streamed through in
// d-blocks.  Here each block owns a 32 (rows i of B') x 32 (columns c) output
// tile of one B'_t and loops over the contraction axis k = 0..L in 32-wide
// slabs.  U is read transposed straight from device memory: the slab
// U[k0:k0+32, i0:i0+32] is loaded row by row, coalesced along i, and used as
// U^T without a transpose pass.  The rescale by w[i] is folded into the
// epilogue, as fd_project.py does, so the (L, d) product never makes a
// second trip through device memory.
//
// What bounds it on an H100: operations.  At the main shapes (T = 8, L = 400,
// d = 1024) it does 2.6 GFLOP on 18 MB, above the f32 ridge point of
// 20 FLOP/byte; with TF32 off the ceiling is the CUDA cores' f32 FMA rate.
// Each thread keeps a 2 x 2 register tile, shared-memory reads are free of
// bank conflicts (the 16 threads of a half-warp read 16 consecutive words of
// the B slab and one broadcast word of the U slab), and global loads and
// stores are coalesced along i for U and along c for B and B'.
//
// Blocks in flight: ceil(d/32) * ceil(L/32) * T: 416 at T = 1 and 3328 at
// T = 8 (L = 400, d = 1024).  Each output element is summed by one thread in
// one fixed order, so runs are repeatable.
//
// Any L and d: rows past L and columns past d load as zeros, and the store
// is masked.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;   // output tile edge (rows of B', columns of B')
constexpr int kChunk = 32;  // contraction slab over k
constexpr int kSide = 16;   // 16 x 16 threads; each owns rows ty, ty+16 and cols tx, tx+16

__global__ void __launch_bounds__(kSide * kSide)
fd_project_kernel(const float* __restrict__ w, const float* __restrict__ u,
                  const float* __restrict__ b, float* __restrict__ out, int L, int d) {
  __shared__ float u_slab[kChunk][kTile + 1];  // u_slab[k][i] = U[k0 + k][i0 + i]
  __shared__ float b_slab[kChunk][kTile + 1];  // b_slab[k][c] = B[k0 + k][c0 + c]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int c0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * kTile;
  const size_t t = blockIdx.z;
  const float* ut = u + t * L * L;
  const float* bt = b + t * L * d;

  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = 0; k0 < L; k0 += kChunk) {
    for (int e = tid; e < kChunk * kTile; e += kSide * kSide) {
      const int r = e / kTile;
      const int c = e % kTile;
      const int k = k0 + r;
      u_slab[r][c] = (k < L && i0 + c < L) ? ut[static_cast<size_t>(k) * L + i0 + c] : 0.f;
      b_slab[r][c] = (k < L && c0 + c < d) ? bt[static_cast<size_t>(k) * d + c0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float a0 = u_slab[k][ty];
      const float a1 = u_slab[k][ty + kSide];
      const float b0 = b_slab[k][tx];
      const float b1 = b_slab[k][tx + kSide];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }

  float* ot = out + t * L * d;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = i0 + ty + a * kSide;
    if (i >= L) continue;
    const float wi = w[t * L + i];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = c0 + tx + c * kSide;
      if (col < d) ot[static_cast<size_t>(i) * d + col] = wi * acc[a][c];
    }
  }
}

}  // namespace

// w: (T, L), u: (T, L, L), b: (T, L, d), out: (T, L, d); all f32 contiguous.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int fd_project_launch(const float* w, const float* u, const float* b, float* out,
                                 int T, int L, int d, cudaStream_t stream) {
  if (T > 0 && L > 0 && d > 0) {
    const dim3 grid((d + kTile - 1) / kTile, (L + kTile - 1) / kTile, T);
    const dim3 block(kSide, kSide);
    fd_project_kernel<<<grid, block, 0, stream>>>(w, u, b, out, L, d);
  }
  return static_cast<int>(cudaGetLastError());
}
