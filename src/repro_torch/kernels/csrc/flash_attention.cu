// Causal self-attention with GQA, a sliding window and a logit soft-cap,
// computed with an online softmax:
//   q (b, hq, s, dh), k and v (b, hkv, s, dh), all f32 or all bf16
//   -> o (b, hq, s, dh) in q's type; all arithmetic in f32.
//
// Replaces the Pallas kernel
//   src/repro/kernels/flash_attention.py  flash_attention_pallas (_flash_kernel)
//
// For query row i of head h it computes, with j over the keys of kv head
// h / (hq / hkv) that the row may see (j <= i, and j > i - window when
// window > 0):
//   x_ij = softcap * tanh((scale q_i . k_j) / softcap)   (x_ij = scale q_i . k_j without a cap)
//   o_i  = sum_j exp(x_ij - m_i) v_j / sum_j exp(x_ij - m_i)
// as the reference does: q is scaled in f32 before the product, the cap is
// applied before the mask, masked logits are -1e30 and their exp weights 0,
// and a row whose weights sum to 0 divides by 1.
//
// On the TPU the grid (b hq, q blocks, kv blocks) ran the kv axis in order,
// carrying the running max m, the running sum l and the (BQ, dh) accumulator
// in VMEM scratch from one grid step to the next.  Blocks on the card run in
// no order, so the kv axis becomes a loop inside the block:
//
//   block (b hq, q tile): 64 query rows of one head, 256 threads as 16 x 16.
//     The q tile is staged once in shared memory (f32, pre-scaled).  For each
//     64-key tile that some row of the q tile can see, it stages K, forms the
//     64 x 64 logits (each thread a 4 x 4 register tile: rows ty + 16 a, keys
//     tx + 16 b, read as float4 along dh from rows padded by 4 floats, so the
//     16 keys a half-warp reads fall in distinct banks), applies cap and mask,
//     updates m and l per row (the 16 threads of a row are one half-warp:
//     a fixed butterfly of shuffles), writes the weights to shared memory,
//     then stages V in the same buffer and adds P V to the accumulator (each
//     thread 4 rows x dh / 16 columns in registers).  K and V share one
//     buffer, so a block needs 83 KB of shared memory at dh = 128 and two
//     blocks fit on an SM.
//   Key tiles that no row of the q tile can see are never visited (the loop
//   runs from the first tile the window reaches to the tile holding the
//   diagonal), so a windowed layer costs O(s window), not O(s^2).
//   The grid's q-tile axis runs from the last tile to the first: the tiles
//   with the most keys start first, the short ones fill in at the end.
//
// GQA costs nothing: a block reads its kv head's rows directly; KV is never
// repeated.  No atomics and no order that depends on scheduling, so two runs
// are bit-equal.  Ragged s is masked in the kernel: rows past s load as
// zeros, keys past s are masked, and only rows below s are stored.
//
// What bounds it on an H100: operations.  At Qwen3-0.6B's prefill shape
// (b = 4, hq = 16, hkv = 8, s = 4096, dh = 128, bf16) the causal half needs
// 4 b hq dh s (s + 1) / 2 = 2.75e11 FLOPs on 201 MB: 4.1 ms on the CUDA
// cores in f32 (67 TFLOP/s), 0.28 ms on the tensor cores in bf16
// (989 TFLOP/s), 0.06 ms of memory traffic.  This kernel does its products
// as f32 FMAs on the CUDA cores; wgmma on bf16 tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                // query rows per block
constexpr int kBKV = 64;               // keys per tile
constexpr int kTx = 16;                // threads along keys / head columns
constexpr int kTy = 16;                // threads along query rows
constexpr int kThreads = kTx * kTy;    // 256
constexpr int kRowsPer = kBQ / kTy;    // 4: rows ty, ty + 16, ty + 32, ty + 48
constexpr int kKeysPer = kBKV / kTx;   // 4: keys tx, tx + 16, tx + 32, tx + 48
constexpr int kPStride = kBKV + 4;     // padded row of the weight tile
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF

template <int DH>
struct Tile {
  static constexpr int kStride = DH + 4;  // padded row of a q or k/v tile, in floats
  // Accumulator columns of one thread: kChunks chunks of kVec adjacent
  // columns, chunk c at c * 16 kVec + tx kVec (adjacent threads, adjacent
  // columns: conflict-free vector reads of V).
  static constexpr int kVec = DH >= 64 ? 4 : DH / kTx;
  static constexpr int kChunks = DH / (kTx * kVec);
  static constexpr int kCols = kVec * kChunks;  // dh / 16
  static constexpr size_t kSmemBytes =
      sizeof(float) * (static_cast<size_t>(kBQ + kBKV) * kStride + kBQ * kPStride);
};

// 16 bytes of the input type from global memory to f32 in shared memory.
__device__ __forceinline__ void load16(const float* src, float* dst, float mul) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x * mul, a.y * mul, a.z * mul, a.w * mul);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst, float mul) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]);
  const float2 d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x * mul, a.y * mul, b.x * mul, b.y * mul);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x * mul, c.y * mul, d.x * mul, d.y * mul);
}

__device__ __forceinline__ void store1(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16_rn(x); }

// Rows row0 .. row0 + 63 of one head (s rows of dh, contiguous) into a
// padded f32 tile, each value times `mul`; rows at or past s load as zeros.
template <int DH, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0, int s,
                                          float* __restrict__ dst, float mul, int tid) {
  constexpr int kElems = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kPerRow = DH / kElems;
#pragma unroll 4
  for (int e = tid; e < kBQ * kPerRow; e += kThreads) {
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * kElems;
    float* d = dst + r * Tile<DH>::kStride + c;
    if (row0 + r < s) {
      load16(src + static_cast<size_t>(row0 + r) * DH + c, d, mul);
    } else {
#pragma unroll
      for (int i = 0; i < kElems; i += 4) *reinterpret_cast<float4*>(d + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int hq, int hkv, int s, float scale, int window,
                       float softcap) {
  using Sh = Tile<DH>;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // (64, dh + 4), pre-scaled
  float* kv_s = q_s + kBQ * Sh::kStride;         // (64, dh + 4): K, then V
  float* p_s = kv_s + kBKV * Sh::kStride;        // (64, 68): the tile's weights

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTx + tx;
  const int bh = blockIdx.x;  // batch * hq + head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int kv_head = (bh % hq) / (hq / hkv);
  const size_t q_off = static_cast<size_t>(bh) * s * DH;
  const size_t kv_off = (static_cast<size_t>(bh / hq) * hkv + kv_head) * s * DH;

  load_tile<DH>(q + q_off, q0, s, q_s, scale, tid);

  float acc[kRowsPer][Sh::kCols];
  float m_run[kRowsPer];
  float l_run[kRowsPer];
#pragma unroll
  for (int a = 0; a < kRowsPer; ++a) {
    m_run[a] = kNegInf;
    l_run[a] = 0.f;
#pragma unroll
    for (int c = 0; c < Sh::kCols; ++c) acc[a][c] = 0.f;
  }

  // Keys some row of this tile can see: [k_lo, k_hi).
  const int k_hi = min(s, q0 + kBQ);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t = k_lo / kBKV; t * kBKV < k_hi; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();  // the previous tile's reads of kv_s and p_s are done
    load_tile<DH>(k + kv_off, k0, s, kv_s, 1.f, tid);
    __syncthreads();

    float x[kRowsPer][kKeysPer];
#pragma unroll
    for (int a = 0; a < kRowsPer; ++a)
#pragma unroll
      for (int b = 0; b < kKeysPer; ++b) x[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[kRowsPer];
      float4 kv[kKeysPer];
#pragma unroll
      for (int a = 0; a < kRowsPer; ++a)
        qv[a] = *reinterpret_cast<const float4*>(q_s + (ty + kTy * a) * Sh::kStride + d);
#pragma unroll
      for (int b = 0; b < kKeysPer; ++b)
        kv[b] = *reinterpret_cast<const float4*>(kv_s + (tx + kTx * b) * Sh::kStride + d);
#pragma unroll
      for (int a = 0; a < kRowsPer; ++a)
#pragma unroll
        for (int b = 0; b < kKeysPer; ++b) {
          x[a][b] = fmaf(qv[a].x, kv[b].x, x[a][b]);
          x[a][b] = fmaf(qv[a].y, kv[b].y, x[a][b]);
          x[a][b] = fmaf(qv[a].z, kv[b].z, x[a][b]);
          x[a][b] = fmaf(qv[a].w, kv[b].w, x[a][b]);
        }
    }

#pragma unroll
    for (int a = 0; a < kRowsPer; ++a) {
      const int qpos = q0 + ty + kTy * a;
      bool seen[kKeysPer];
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < kKeysPer; ++b) {
        const int kpos = k0 + tx + kTx * b;
        float xv = x[a][b];
        if (softcap > 0.f) xv = softcap * tanhf(xv / softcap);
        seen[b] = kpos < s && kpos <= qpos && (window <= 0 || kpos > qpos - window);
        x[a][b] = seen[b] ? xv : kNegInf;
        mx = fmaxf(mx, x[a][b]);
      }
      // The 16 threads of row a are lanes differing only in tx's four bits.
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[a], mx);
      const float alpha = expf(m_run[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < kKeysPer; ++b) {
        const float p = seen[b] ? expf(x[a][b] - m_new) : 0.f;
        sum += p;
        p_s[(ty + kTy * a) * kPStride + tx + kTx * b] = p;
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[a] = alpha * l_run[a] + sum;
      m_run[a] = m_new;
#pragma unroll
      for (int c = 0; c < Sh::kCols; ++c) acc[a][c] *= alpha;
    }

    __syncthreads();  // every read of K is done and every weight is written
    load_tile<DH>(v + kv_off, k0, s, kv_s, 1.f, tid);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBKV; j += 4) {
      float p[kRowsPer][4];
#pragma unroll
      for (int a = 0; a < kRowsPer; ++a) {
        const float4 pv = *reinterpret_cast<const float4*>(p_s + (ty + kTy * a) * kPStride + j);
        p[a][0] = pv.x;
        p[a][1] = pv.y;
        p[a][2] = pv.z;
        p[a][3] = pv.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = kv_s + (j + jj) * Sh::kStride + tx * Sh::kVec;
#pragma unroll
        for (int ch = 0; ch < Sh::kChunks; ++ch) {
          float vv[Sh::kVec];
          if constexpr (Sh::kVec == 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(vrow + ch * kTx * 4);
            vv[0] = t4.x;
            vv[1] = t4.y;
            vv[2] = t4.z;
            vv[3] = t4.w;
          } else if constexpr (Sh::kVec == 2) {
            const float2 t2 = *reinterpret_cast<const float2*>(vrow + ch * kTx * 2);
            vv[0] = t2.x;
            vv[1] = t2.y;
          } else {
#pragma unroll
            for (int e = 0; e < Sh::kVec; ++e) vv[e] = vrow[ch * kTx * Sh::kVec + e];
          }
#pragma unroll
          for (int a = 0; a < kRowsPer; ++a)
#pragma unroll
            for (int e = 0; e < Sh::kVec; ++e)
              acc[a][ch * Sh::kVec + e] = fmaf(p[a][jj], vv[e], acc[a][ch * Sh::kVec + e]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kRowsPer; ++a) {
    const int qpos = q0 + ty + kTy * a;
    if (qpos >= s) continue;
    const float l = l_run[a] == 0.f ? 1.f : l_run[a];
    T* orow = o + q_off + static_cast<size_t>(qpos) * DH + tx * Sh::kVec;
#pragma unroll
    for (int ch = 0; ch < Sh::kChunks; ++ch)
#pragma unroll
      for (int e = 0; e < Sh::kVec; ++e)
        store1(orow + ch * kTx * Sh::kVec + e, acc[a][ch * Sh::kVec + e] / l);
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int s,
           float scale, int window, float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<DH, T>;
  const int smem = static_cast<int>(Tile<DH>::kSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (s + kBQ - 1) / kBQ);
  const dim3 block(kTx, kTy);
  kernel<<<grid, block, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, s,
                                        scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int s,
              int dh, float scale, int window, float softcap, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<32, T>(q, k, v, o, b, hq, hkv, s, scale, window, softcap, stream);
    case 64: return launch<64, T>(q, k, v, o, b, hq, hkv, s, scale, window, softcap, stream);
    case 128: return launch<128, T>(q, k, v, o, b, hq, hkv, s, scale, window, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (b, hq, s, dh); k, v: (b, hkv, s, dh); o: (b, hq, s, dh); contiguous,
// 16-byte aligned, all of one type: dtype 0 = f32, 1 = bf16.  dh is 32, 64
// or 128; hq a multiple of hkv; b hq < 2^31 and ceil(s / 64) <= 65535.
// Keys after the query are masked; window > 0 masks keys window or more
// positions behind it; softcap > 0 caps the logits.  Launches on
// `stream`, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these limits.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int b,
                                      int hq, int hkv, int s, int dh, int dtype, float scale,
                                      int window, float softcap, cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  if (hkv <= 0 || hq % hkv != 0 || (s + kBQ - 1) / kBQ > 65535 ||
      static_cast<long long>(b) * hq > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0)
    return launch_dh<float>(q, k, v, o, b, hq, hkv, s, dh, scale, window, softcap, stream);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, o, b, hq, hkv, s, dh, scale, window, softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
