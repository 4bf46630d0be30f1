// Causal self-attention with GQA, a sliding window and a logit soft-cap,
// computed with an online softmax on f32 inputs:
//   q (b, hq, s, dh), k and v (b, hkv, s, dh), all f32 -> o (b, hq, s, dh) f32.
//
// Replaces the Pallas kernel
//   src/repro/kernels/flash_attention.py  flash_attention_pallas (_flash_kernel)
// for f32 inputs; bf16 inputs go to csrc/flash_attention_wgmma.cu, on the
// tensor cores.
//
// For query row i of head h it computes, with j over the keys of kv head
// h / (hq / hkv) that the row may see (j <= i, and j > i - window when
// window > 0):
//   x_ij = softcap * tanh((scale q_i . k_j) / softcap)   (x_ij = scale q_i . k_j without a cap)
//   o_i  = sum_j exp(x_ij - m_i) v_j / sum_j exp(x_ij - m_i)
// as the reference does: q is scaled in f32 before the product, the cap is
// applied before the mask, masked logits weigh 0, and a row whose weights
// sum to 0 divides by 1.  The products are IEEE f32 FMAs on the CUDA cores
// (no tensor cores), and the exponentials are taken in base 2 on logits
// multiplied by log2(e).
//
// On the TPU the grid (b hq, q blocks, kv blocks) ran the kv axis in order,
// carrying the running max m, the running sum l and the (BQ, dh) accumulator
// in VMEM scratch from one grid step to the next.  Blocks on the card run in
// no order, so the kv axis becomes a loop inside a block, and where that loop
// would be long it is cut into pieces whose partial (m, l, O) a second pass
// merges.
//
// What bounds it on an H100: operations.  At the f32 serving check's prefill
// (b = 1, hq = 16, hkv = 8, s = 512, dh = 128, causal) the function needs
// 4 b hq dh s (s + 1) / 2 = 1.08 GFLOP: 16.1 us at 67 TFLOP/s of f32 FMAs; at
// Qwen3-0.6B's 4096-token prefill (b = 4) 2.75e11 FLOPs, 4.1 ms.  What the
// design does about each limit of the kernel it replaces (one block a
// (head, 64-query tile), all key tiles in sequence, K and V staged by every
// thread into one buffer, four barriers a tile, the mask on every logit):
//
//  * Work items that fill the card.  A q tile of 64 rows sees up to
//    ceil(s / 64) key tiles of 64 keys; the last q tiles of a causal prompt
//    see the most, and one block walking them all set the time (at s = 512,
//    128 blocks on 132 SMs, the last walking 8 tiles).  The key range of a q
//    tile with more than `chunk` tiles is cut into ceil(n / chunk) pieces of
//    even length; each piece is one block, which writes its rows' partial
//    max m (log2 units), sum l and unnormalised O to scratch, and a second
//    kernel merges a q tile's pieces in piece order: m = max m_c,
//    O = sum_c 2^(m_c - m) O_c, l = sum_c 2^(m_c - m) l_c, O / l (l = 0
//    divides by 1; a piece in which a row sees no key has m_c = -1e30 and
//    weighs 0).  `chunk` is chosen per shape on the host (kernels/ops.py
//    flash_split: a model of the SMs' block slots in dispatch order); a q
//    tile of one piece stores its output directly.  The
//    second pass is launched as a programmatic dependent (PDL), as
//    levscore.cu's.  A block finds its item by walking the q tiles from the
//    last: items run from the last q tile to the first, and blockIdx.x is
//    the head, so the longest items start first.
//  * Loads under the math.  One thread issues TMA box loads (3-D maps
//    (dh, s, b h), so rows at or past s arrive as zeros, never the next
//    head's rows) of the q tile once and of each key tile's K and V, in
//    32-column panels in the 128-byte swizzle, each completing on its own
//    full mbarrier.  K and V have their own stages and their own empty
//    mbarriers, on which each warp arrives when it is done with a stage:
//    K of tile t + kStages is issued as soon as every warp has formed the
//    logits of tile t, V as soon as every warp has added P V of tile t, so
//    each load runs under the other half of the tile's FFMAs (one stage at
//    dh = 64 and 128, two at dh = 32; the other block on the SM covers a
//    wait).  No __syncthreads in the loop.
//  * Shared-memory loads, the limit of FFMA kernels.  A 16-byte shared load
//    costs the SM 4 cycles when each quarter-warp reads 8 distinct chunks,
//    whether or not other quarters read the same ones, and about 2.2 when a
//    quarter-warp reads one address (measured on the card), against 4 warp
//    FFMAs a cycle.  So a thread's rows come as quarter-warp broadcasts and
//    only its keys and columns as distinct reads: 256 threads as 16 row
//    groups x 16 column groups, a thread holding rows ty + 16a (a < 4) in
//    both products.  S = Q K^T: keys tx + 16b (b < 4), 4 Q loads
//    (broadcast) and 4 K loads feed 64 FFMAs; O += P V: columns
//    tx kVec + 16 kVec c, 4 P loads (broadcast) and dh / 16 V loads for 4
//    keys feed 128 FFMAs at dh = 128: 9.1 FFMAs a load over a tile.  A
//    tile of 8 rows x 4 keys (10.7 a load) needed 245 registers, so an SM
//    held 8 warps, and measured slower (PERF.md section 6).  Warp w holds
//    row groups 2w and 2w + 1, so a row's 16 threads are 16 adjacent lanes
//    (the softmax's shuffles), the running max, sum and rescale stay in the
//    registers of the threads that hold the row's O, and a warp writes and
//    reads only its own rows of P (__syncwarp, not __syncthreads).  The
//    loops over dh panels and keys are only partly unrolled: unrolled,
//    the dh = 128 kernel was 14,700 instructions and ran at half the rate
//    (the instruction cache).  Two blocks an SM, 128 registers, no spills.
//  * The mask only where it can bite.  A tile is masked only if it crosses
//    the diagonal, the window's edge or s; on every other tile no position
//    is compared.  The cap is one exp2 and one reciprocal a logit:
//    softcap tanh(x / softcap) = softcap - 2 softcap / (exp(2 x / softcap) + 1),
//    times log2(e) folded into the constants (kCapByExp; tanhf otherwise).
//
// Shared memory: q tile 64 dh floats, kStages (K, V) tiles of 64 dh floats,
// P (64 x 64), mbarriers and up to 896 bytes of alignment slack: 115,624
// bytes at dh = 128, 66,472 at dh = 64, 58,312 at dh = 32.
//
// GQA costs nothing: a block reads its kv head's rows at their coordinates;
// KV is never repeated.  No atomics and no order that depends on scheduling,
// so two runs are bit-equal.  Ragged s is masked in the kernel: rows and keys
// past s load as zeros, keys past s are masked, and only rows below s are
// stored.

#include "f32_staging.cuh"

namespace {

constexpr int kBQ = 64;            // query rows of a work item
constexpr int kBKV = 64;           // keys of a tile
constexpr int kCombineThreads = 256;  // the second pass
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF, as a row's max before any key
constexpr float kLog2e = 1.4426950408889634f;
// The cap through one exp2 and one reciprocal (true) or through tanhf (false).
constexpr bool kCapByExp = true;
// One thread layout for both products: kTy row groups x kTx column groups.
// A thread holds rows ty + kTy a; in S = Q K^T keys tx + kTx b, in
// O += P V columns tx kVec + kTx kVec c.  Warp w holds row groups
// w 32 / kTx .. + 32 / kTx - 1, so a row's threads are adjacent lanes and
// a warp writes and reads only its own rows of P.
constexpr int kTy = 16;
constexpr int kTx = 16;
constexpr int kThreads = kTy * kTx;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kBQ / kTy;    // 4
constexpr int kKeys = kBKV / kTx;   // 4

template <int DH>
struct Cfg {
  static constexpr int kPanels = DH / kSlab;      // 32-column panels of a row
  static constexpr int kStages = DH <= 32 ? 2 : 1;
  static constexpr int kMinBlocks = 2;
  static constexpr int kVec = DH >= 64 ? 4 : 2;   // adjacent columns a thread reads at once
  static constexpr int kChunks = DH / (kTx * kVec);
  static constexpr int kCols = kVec * kChunks;    // dh / 16 columns a thread
  static constexpr int kTile = kBKV * DH;         // floats of a K or V tile
  // Float offsets in shared memory, each TMA destination on 1024 bytes.
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * DH;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kP = kV + kStages * kTile;  // (64, 64) weights: two panels
  static constexpr int kBars = kP + kBQ * kBKV;    // q; K full, V full, K empty, V empty
  static constexpr int kNumBars = 1 + 4 * kStages;
  // The dynamic shared memory base is 128-byte aligned; up to 896 bytes of
  // slack bring the ring to 1024 (two blocks an SM fit at dh = 128 only so).
  static constexpr int kBytes = 4 * kBars + 8 * kNumBars + 896;
  static constexpr int kPart = kBQ * (DH + 2);  // a piece's scratch: m, l, then O
  static_assert(kChunks >= 1 && kCols == DH / kTx, "columns a thread");
};

// The key tiles [lo, hi) that some row of q tile qt can see.
__host__ __device__ inline void key_tiles(int qt, int s, int window, int* lo, int* hi) {
  const int q0 = qt * kBQ;
  const int k_hi = s < q0 + kBQ ? s : q0 + kBQ;
  const int k_lo = window > 0 && q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  *lo = k_lo / kBKV;
  *hi = (k_hi + kBKV - 1) / kBKV;
}

__host__ __device__ inline int pieces_of(int n, int chunk) { return (n + chunk - 1) / chunk; }

// Work items (pieces) of one head, and the most pieces of one q tile.
inline long long items_of(int s, int window, int chunk, int* max_pieces) {
  long long items = 0;
  *max_pieces = 0;
  for (int qt = 0; qt * kBQ < s; ++qt) {
    int lo, hi;
    key_tiles(qt, s, window, &lo, &hi);
    const int p = pieces_of(hi - lo, chunk);
    items += p;
    if (p > *max_pieces) *max_pieces = p;
  }
  return items;
}

// Float offset of (row r, column c) of a tile of `rows` rows held as panels
// of 32 columns in the 128-byte swizzle.
__device__ __forceinline__ int swz(int rows, int r, int c) {
  return (c / kSlab) * rows * kSlab + r * kSlab + ((((c % kSlab) >> 2) ^ r) & 7) * 4 + (c & 3);
}

// Scale by log2(e) and cap one tile of a thread's logits; with kMask, mask
// the keys its rows may not see (-1e30, and `seen` false).
template <bool kMask>
__device__ __forceinline__ void cap_and_mask(float (&x)[kRows][kKeys], bool (&seen)[kRows][kKeys],
                                             bool capped, float cap_in, float cap_out, int qrow0,
                                             int key0, int s, int window) {
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b < kKeys; ++b) {
      float v = x[a][b];
      if (capped) {
        if constexpr (kCapByExp) {
          // log2(e) softcap tanh(v / softcap), with cap_in = 2 log2(e) / softcap
          // and cap_out = log2(e) softcap.
          v = cap_out - __fdividef(2.f * cap_out, exp2f(v * cap_in) + 1.f);
        } else {
          v = cap_out * tanhf(v * (0.5f * cap_in * (1.f / kLog2e)));
        }
      } else {
        v *= kLog2e;
      }
      seen[a][b] = true;
      if constexpr (kMask) {
        const int qpos = qrow0 + kTy * a;
        const int kpos = key0 + kTx * b;
        seen[a][b] = kpos < s && kpos <= qpos && (window <= 0 || kpos > qpos - window);
        if (!seen[a][b]) v = kNegInf;
      }
      x[a][b] = v;
    }
}

// Grid (b hq, items): block (bh, y) runs piece y of head bh's items, which
// run from the last q tile to the first, each q tile's pieces in order.  A
// q tile of one piece stores o; a piece of a split q tile stores m, l and O
// to part[(bh items + y) kPart ...].
template <int DH>
__global__ void __launch_bounds__(kThreads, Cfg<DH>::kMinBlocks)
flash_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, float* __restrict__ o,
                       float* __restrict__ part, int hq, int hkv, int s, float scale, int window,
                       float softcap, int chunk, int items) {
  using C = Cfg<DH>;
  extern __shared__ unsigned char raw[];
  const uint32_t raw_addr = smem_addr(raw);
  if (raw_addr & 127) __trap();  // kBytes counts on a 128-byte aligned base
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  float* sm = reinterpret_cast<float*>(raw + (base - raw_addr));
  float* q_s = sm + C::kQ;
  float* k_s = sm + C::kK;
  float* v_s = sm + C::kV;
  float* p_s = sm + C::kP;
  const uint32_t bar_q = base + 4 * C::kBars;
  const uint32_t k_full = bar_q + 8;  // stage st at + 8 st
  const uint32_t v_full = k_full + 8 * C::kStages;
  const uint32_t k_empty = v_full + 8 * C::kStages;
  const uint32_t v_empty = k_empty + 8 * C::kStages;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = (tid >> 5) * (32 / kTx) + lane / kTx;
  const int tx = lane % kTx;
  const int bh = blockIdx.x;

  // This block's piece: walk the q tiles from the last.
  int qt = (s + kBQ - 1) / kBQ - 1;
  int piece = blockIdx.y;
  int lo = 0, hi = 0, pieces = 1;
  for (;; --qt) {
    key_tiles(qt, s, window, &lo, &hi);
    pieces = pieces_of(hi - lo, chunk);
    if (piece < pieces) break;
    piece -= pieces;
  }
  const int n = hi - lo;
  const int t0 = lo + static_cast<int>(static_cast<long long>(piece) * n / pieces);
  const int steps = lo + static_cast<int>(static_cast<long long>(piece + 1) * n / pieces) - t0;
  const int q0 = qt * kBQ;
  const int kv_t = (bh / hq) * hkv + (bh % hq) / (hq / hkv);  // K and V maps' third coordinate

  // Let the second pass launch now: it waits for this grid to finish.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, kWarps);
      mbar_init(v_empty + 8 * st, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // rows x dh at row0 of tenant t3 of `map`, as kPanels boxes of 32 columns.
  auto issue = [&](uint32_t bar, const CUtensorMap* map, float* dst, int row0, int rows, int t3) {
    mbar_expect_tx(bar, rows * DH * 4);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
      tma_load(smem_addr(dst + p * rows * kSlab), map, p * kSlab, row0, t3, bar);
  };
  if (tid == 0) {
    issue(bar_q, &map_q, q_s, q0, kBQ, bh);
    for (int i = 0; i < C::kStages && i < steps; ++i) {
      issue(k_full + 8 * i, &map_k, k_s + i * C::kTile, (t0 + i) * kBKV, kBKV, kv_t);
      issue(v_full + 8 * i, &map_v, v_s + i * C::kTile, (t0 + i) * kBKV, kBKV, kv_t);
    }
  }

  // The q tile, scaled in f32 as the reference does, before any product.
  mbar_wait(bar_q, 0);
  for (int e = tid; e < kBQ * DH / 4; e += kThreads) {
    float4 a = reinterpret_cast<float4*>(q_s)[e];
    a = make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale);
    reinterpret_cast<float4*>(q_s)[e] = a;
  }
  __syncthreads();

  float acc[kRows][C::kCols];
  float m_run[kRows], l_run[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    m_run[a] = kNegInf;
    l_run[a] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) acc[a][c] = 0.f;
  }
  const bool capped = softcap > 0.f;
  const float cap_in = capped ? 2.f * kLog2e / softcap : 0.f;
  const float cap_out = kLog2e * softcap;

  for (int i = 0; i < steps; ++i) {
    const int st = i % C::kStages;
    const uint32_t parity = (i / C::kStages) & 1;
    const int k0 = (t0 + i) * kBKV;
    const float* ks = k_s + st * C::kTile;
    const float* vs = v_s + st * C::kTile;

    // S = Q K^T over dh, 4 dh steps a float4: Q rows ty + 8a (one row a
    // quarter-warp: a broadcast), K rows tx + 16b (8 distinct rows a
    // quarter-warp, with distinct row % 8 through the swizzle).
    mbar_wait(k_full + 8 * st, parity);
    float x[kRows][kKeys];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int b = 0; b < kKeys; ++b) x[a][b] = 0.f;
#pragma unroll 1  // unrolled, the loop outgrows the instruction cache
    for (int p = 0; p < C::kPanels; ++p) {
      const float* qp = q_s + p * kBQ * kSlab + ty * kSlab;
      const float* kp = ks + p * kBKV * kSlab + tx * kSlab;
#pragma unroll
      for (int kk = 0; kk < kSlab / 4; ++kk) {
        float4 kv[kKeys];
#pragma unroll
        for (int b = 0; b < kKeys; ++b)
          kv[b] = *reinterpret_cast<const float4*>(kp + b * kTx * kSlab + (((kk ^ tx) & 7) << 2));
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qp + a * kTy * kSlab + (((kk ^ ty) & 7) << 2));
#pragma unroll
          for (int b = 0; b < kKeys; ++b) {
            x[a][b] = fmaf(qv.x, kv[b].x, x[a][b]);
            x[a][b] = fmaf(qv.y, kv[b].y, x[a][b]);
            x[a][b] = fmaf(qv.z, kv[b].z, x[a][b]);
            x[a][b] = fmaf(qv.w, kv[b].w, x[a][b]);
          }
        }
      }
    }
    // This warp is done with the K stage; its last reader hands it back.
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty + 8 * st);
    if (tid == 0 && i + C::kStages < steps) {
      mbar_wait(k_empty + 8 * st, parity);
      issue(k_full + 8 * st, &map_k, k_s + st * C::kTile, k0 + C::kStages * kBKV, kBKV, kv_t);
    }
    __syncwarp();  // lane 0 of warp 0 rejoins before the shuffles

    // Cap, mask (diagonal, window-edge and ragged tiles only), online
    // softmax; the row's 16 threads are adjacent lanes.
    bool seen[kRows][kKeys];
    const bool edge = k0 + kBKV - 1 > q0 || k0 + kBKV > s ||
                      (window > 0 && k0 <= q0 + kBQ - 1 - window);
    if (edge) {
      cap_and_mask<true>(x, seen, capped, cap_in, cap_out, q0 + ty, k0 + tx, s, window);
    } else {
      cap_and_mask<false>(x, seen, capped, cap_in, cap_out, q0 + ty, k0 + tx, s, window);
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      float mx = x[a][0];
#pragma unroll
      for (int b = 1; b < kKeys; ++b) mx = fmaxf(mx, x[a][b]);
#pragma unroll
      for (int off = 1; off < kTx; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[a], mx);
      const float alpha = exp2f(m_run[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < kKeys; ++b) {
        const float pv = seen[a][b] ? exp2f(x[a][b] - m_new) : 0.f;
        sum += pv;
        p_s[swz(kBQ, ty + kTy * a, tx + kTx * b)] = pv;
      }
#pragma unroll
      for (int off = 1; off < kTx; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[a] = fmaf(alpha, l_run[a], sum);
      m_run[a] = m_new;
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) acc[a][c] *= alpha;
    }
    __syncwarp();  // this warp's rows of P are written

    // O += P V: P rows ty + 8a (a broadcast a quarter-warp), V columns of
    // 8 distinct 16-byte chunks a quarter-warp.
    mbar_wait(v_full + 8 * st, parity);
#pragma unroll 2
    for (int j4 = 0; j4 < kBKV / 4; ++j4) {
      float4 pv[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
        pv[a] = *reinterpret_cast<const float4*>(p_s + swz(kBQ, ty + kTy * a, 4 * j4));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * j4 + jj;
        float vv[C::kChunks][C::kVec];
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          const float* src = vs + swz(kBKV, j, c * kTx * C::kVec + tx * C::kVec);
          if constexpr (C::kVec == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[c][0] = t.x;
            vv[c][1] = t.y;
            vv[c][2] = t.z;
            vv[c][3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[c][0] = t.x;
            vv[c][1] = t.y;
          }
        }
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
            for (int e = 0; e < C::kVec; ++e)
              acc[a][c * C::kVec + e] = fmaf(reinterpret_cast<const float*>(&pv[a])[jj],
                                             vv[c][e], acc[a][c * C::kVec + e]);
      }
    }
    // Every read of this warp's P and of the V stage is done.
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty + 8 * st);
    if (tid == 0 && i + C::kStages < steps) {
      mbar_wait(v_empty + 8 * st, parity);
      issue(v_full + 8 * st, &map_v, v_s + st * C::kTile, k0 + C::kStages * kBKV, kBKV, kv_t);
    }
    __syncwarp();
  }

  if (pieces == 1) {
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = ty + kTy * a;
      if (q0 + r >= s) continue;
      const float l = l_run[a] == 0.f ? 1.f : l_run[a];
      float* row = o + (static_cast<size_t>(bh) * s + q0 + r) * DH;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        float* dst = row + c * kTx * C::kVec + tx * C::kVec;
        const float* v = &acc[a][c * C::kVec];
        if constexpr (C::kVec == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0] / l, v[1] / l, v[2] / l, v[3] / l);
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0] / l, v[1] / l);
        }
      }
    }
  } else {
    float* dst = part + (static_cast<size_t>(bh) * items + blockIdx.y) * C::kPart;
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int r = ty + kTy * a;
      if (tx == 0) {
        dst[r] = m_run[a];
        dst[kBQ + r] = l_run[a];
      }
      float* row = dst + 2 * kBQ + r * DH;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        float* d = row + c * kTx * C::kVec + tx * C::kVec;
        const float* v = &acc[a][c * C::kVec];
        if constexpr (C::kVec == 4) {
          *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
          *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
        }
      }
    }
  }
}

// Grid (b hq, q tiles, 64 dh / 4 / kCombineThreads): merge the pieces of
// q tile y of head x in piece order, block z taking kCombineThreads / (dh / 4)
// of its rows, one thread for 4 columns of a row, and store the rows below
// s.  Launched as a programmatic dependent of flash_attention_kernel: it
// waits here until that grid has finished and its stores are visible.  A q
// tile of one piece was stored by its block.
template <int DH>
__global__ void __launch_bounds__(kCombineThreads)
flash_attention_combine_kernel(const float* __restrict__ part, float* __restrict__ o, int s,
                               int window, int chunk, int items) {
  using C = Cfg<DH>;
  constexpr int kQuads = DH / 4;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const int r = blockIdx.z * (kCombineThreads / kQuads) + threadIdx.x / kQuads;
  const int c = (threadIdx.x % kQuads) * 4;
  const int qpos = qt * kBQ + r;
  int lo, hi;
  key_tiles(qt, s, window, &lo, &hi);
  const int pieces = pieces_of(hi - lo, chunk);
  if (pieces == 1 || qpos >= s) return;
  int first = 0;  // the item of this q tile's piece 0
  for (int t = (s + kBQ - 1) / kBQ - 1; t > qt; --t) {
    key_tiles(t, s, window, &lo, &hi);
    first += pieces_of(hi - lo, chunk);
  }
  const float* src = part + (static_cast<size_t>(bh) * items + first) * C::kPart;
  float m = kNegInf;
#pragma unroll 4
  for (int p = 0; p < pieces; ++p) m = fmaxf(m, src[p * C::kPart + r]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int p = 0; p < pieces; ++p) {
    const float* pp = src + p * C::kPart;
    const float w = exp2f(pp[r] - m);
    l = fmaf(w, pp[kBQ + r], l);
    const float4 ov = *reinterpret_cast<const float4*>(pp + 2 * kBQ + r * DH + c);
    acc.x = fmaf(w, ov.x, acc.x);
    acc.y = fmaf(w, ov.y, acc.y);
    acc.z = fmaf(w, ov.z, acc.z);
    acc.w = fmaf(w, ov.w, acc.w);
  }
  if (l == 0.f) l = 1.f;
  *reinterpret_cast<float4*>(o + (static_cast<size_t>(bh) * s + qpos) * DH + c) =
      make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
}

// The arguments every entry takes, checked: the launch geometry's limits.
bool valid(int b, int hq, int s, int dh, int chunk) {
  return b > 0 && hq > 0 && s > 0 && chunk > 0 && (dh == 32 || dh == 64 || dh == 128) &&
         static_cast<long long>(b) * hq <= 0x7fffffffLL && (s + kBQ - 1) / kBQ <= 65535;
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* part, int b,
                   int hq, int hkv, int s, float scale, int window, float softcap, int chunk,
                   int items, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap map_q = {}, map_k = {}, map_v = {};
  if (!(make_map(&map_q, q, b * hq, s, DH, kSlab, kBQ, CU_TENSOR_MAP_SWIZZLE_128B) &&
        make_map(&map_k, k, b * hkv, s, DH, kSlab, kBKV, CU_TENSOR_MAP_SWIZZLE_128B) &&
        make_map(&map_v, v, b * hkv, s, DH, kSlab, kBKV, CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel<DH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(b * hq, items), kThreads, C::kBytes, stream>>>(
      map_q, map_k, map_v, o, part, hq, hkv, s, scale, window, softcap, chunk, items);
  return cudaGetLastError();
}

// Blocks of flash_attention_kernel<DH> an SM holds, its shared memory set.
template <int DH>
cudaError_t blocks_per_sm(int* n) {
  auto kernel = flash_attention_kernel<DH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<DH>::kBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, kThreads, Cfg<DH>::kBytes);
}

template <int DH>
cudaError_t combine(const float* part, float* o, int bhq, int s, int window, int chunk,
                    int items, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bhq, (s + kBQ - 1) / kBQ, kBQ * DH / 4 / kCombineThreads);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_attention_combine_kernel<DH>, part, o, s, window, chunk,
                            items);
}

}  // namespace

// How many blocks of the kernel for head dim dh an SM of the current
// device holds; or minus a CUDA error.
extern "C" long long flash_attention_blocks_per_sm(int dh) {
  int n = 0;
  const cudaError_t err = dh == 32 ? blocks_per_sm<32>(&n)
                          : dh == 64 ? blocks_per_sm<64>(&n)
                          : dh == 128 ? blocks_per_sm<128>(&n)
                                      : cudaErrorInvalidValue;
  return err == cudaSuccess ? n : -static_cast<long long>(err);
}

// Floats of scratch flash_attention_launch needs for the pieces' partial
// rows at this shape and chunk (key tiles a piece at most): b hq items
// 64 (dh + 2) where some q tile is split, else 0; or minus a CUDA error.
extern "C" long long flash_attention_scratch_floats(int b, int hq, int s, int dh, int window,
                                                    int chunk) {
  if (!valid(b, hq, s, dh, chunk)) return -static_cast<long long>(cudaErrorInvalidValue);
  int max_pieces = 0;
  const long long items = items_of(s, window, chunk, &max_pieces);
  if (max_pieces == 1) return 0;
  return static_cast<long long>(b) * hq * items * kBQ * (dh + 2);
}

// q: (b, hq, s, dh); k, v: (b, hkv, s, dh); o: (b, hq, s, dh); contiguous f32
// on 16 bytes.  dh is 32, 64 or 128; hq a multiple of hkv; b hq < 2^31,
// ceil(s / 64) <= 65535 and the items of a head (pieces of at most `chunk`
// 32-key tiles) <= 65535.  part: part_len floats of scratch, at least
// flash_attention_scratch_floats(b, hq, s, dh, window, chunk); where that is
// not 0, flash_attention_combine_launch must follow on the same stream.
// Keys after the query are masked; window > 0 masks keys window or more
// positions behind it; softcap > 0 caps the logits.  Launches on `stream`,
// allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these limits.
extern "C" int flash_attention_launch(const float* q, const float* k, const float* v, float* o,
                                      float* part, long long part_len, int b, int hq, int hkv,
                                      int s, int dh, float scale, int window, float softcap,
                                      int chunk, cudaStream_t stream) {
  if (!valid(b, hq, s, dh, chunk) || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int max_pieces = 0;
  const long long items = items_of(s, window, chunk, &max_pieces);
  const long long need =
      max_pieces > 1 ? static_cast<long long>(b) * hq * items * kBQ * (dh + 2) : 0;
  if (items > 65535 || part_len < need) return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(items);
  auto run = dh == 32 ? launch<32> : dh == 64 ? launch<64> : launch<128>;
  const cudaError_t err =
      run(q, k, v, o, part, b, hq, hkv, s, scale, window, softcap, chunk, n, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The second pass of a split launch: merges the pieces flash_attention_launch
// wrote to `part` (the same b, hq, s, dh, window and chunk) into o.
extern "C" int flash_attention_combine_launch(const float* part, float* o, int b, int hq, int s,
                                              int dh, int window, int chunk, cudaStream_t stream) {
  if (!valid(b, hq, s, dh, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  int max_pieces = 0;
  const int items = static_cast<int>(items_of(s, window, chunk, &max_pieces));
  auto run = dh == 32 ? combine<32> : dh == 64 ? combine<64> : combine<128>;
  const cudaError_t err = run(part, o, b * hq, s, window, chunk, items, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
