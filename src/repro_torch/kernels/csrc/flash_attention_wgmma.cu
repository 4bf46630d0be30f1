// Causal self-attention with GQA, a sliding window and a logit soft-cap on
// bf16 inputs, on Hopper's tensor cores (wgmma) with TMA loads:
//   q (b, hq, s, dh), k and v (b, hkv, s, dh), all bf16 -> o (b, hq, s, dh) bf16.
//
// Replaces the Pallas kernel
//   src/repro/kernels/flash_attention.py  flash_attention_pallas (_flash_kernel)
// for bf16 inputs; csrc/flash_attention.cu keeps the f32 path.
//
// The function is the one csrc/flash_attention.cu states: for query row i of
// head h, over the keys j of kv head h / (hq / hkv) with j <= i (and
// j > i - window when window > 0),
//   x_ij = softcap * tanh((scale q_i . k_j) / softcap)   (scale q_i . k_j without a cap)
//   o_i  = sum_j exp(x_ij - m_i) v_j / sum_j exp(x_ij - m_i),
// the cap before the mask, masked keys weighing 0, and a row whose weights
// sum to 0 dividing by 1.  The product q_i . k_j of bf16 values is exact in
// f32 and is summed in f32; the scale is applied to the f32 logit after it
// (the reference scales q in f32 before: one f32 rounding apart).
//
// What bounds it on an H100: tensor-core operations.  At Qwen3-0.6B's
// prefill shape (b = 4, hq = 16, hkv = 8, s = 4096, dh = 128, causal) the
// function needs 4 b hq dh s (s + 1) / 2 = 2.75e11 FLOPs on 201 MB: 278 us
// at the bf16 tensor-core rate (989 TFLOP/s), 60 us of memory traffic.
// This design does P V twice (below), 1.5 x the function's tensor-core
// work: its own floor is 417 us.
//
// The weights P = exp(x - m) are f32.  Rounded once to bf16 for the P V
// product they would put up to 2^-9 of relative error on every weight, many
// times the error one bf16 rounding of the output allows (measured on the
// CPU: tests/test_torch_flash_numerics.py).  So P is split into two bf16
// terms, P_hi = bf16(P) and P_lo = bf16(P - P_hi), and O += P_hi V + P_lo V
// runs as two wgmmas into one f32 accumulator: P_hi + P_lo holds P to about
// 2^-17, the error f32 arithmetic leaves.
//
// Design (sm_90a):
//   block (b hq, 128-query tile): three warpgroups.  Warpgroup 0 is the
//     producer: after setmaxnreg gives its registers to the others, one
//     thread issues TMA loads of the Q tile (once) and of K and V tiles of
//     128 keys into a ring of two shared-memory stages, each stage with a
//     full barrier for K, one for V and an empty barrier (mbarriers).
//     Warpgroups 1 and 2 are consumers, each owning 64 query rows (wgmma's
//     M).  For each key tile a consumer
//       S = Q K^T    dh / 16 wgmma m64n128k16, A = Q and B = K both
//                    K-major in shared memory; S in registers, f32;
//       softmax      on S's accumulator layout: each thread holds 2 rows x
//                    32 keys, a row is the 4 threads of a quad (shuffles 1
//                    and 2); scale, cap, mask, running max m, rescale of O
//                    and of the running sum l;
//       O += P V     P_hi and P_lo converted in registers straight into
//                    wgmma's A-fragment layout (the accumulator layout of S
//                    is the A layout of P: no shuffles), then 2 x 8 register-A
//                    wgmma m64n{dh}k16 with B = V, which lies MN-major in
//                    shared memory: bf16's transposed-B mode, no copy.
//     then releases the stage.  The epilogue divides by l and stores the
//     rows below s as bf16.
//   Tensor maps are 3-D (dh, s, b h), built on the host at each launch, so
//   rows at or past s load as zeros, never the next head's rows; the 128-byte
//   swizzle (64-byte at dh = 32) matches the wgmma descriptors.  A row of
//   dh = 128 is 256 bytes: a tile is two 64-column panels.
//   Key tiles no row of the block can see are never loaded; a consumer skips
//   the math of a tile none of its rows can see.  Masks are evaluated only on
//   diagonal, window-edge and ragged tiles.  Q tiles run from the last to the
//   first, so the blocks with the most keys start first.
//   Tile sizes: 128 keys a tile.  At dh = 128 a consumer thread holds 64 S,
//   64 O and 64 split-P registers; setmaxnreg gives the consumers 240 each and
//   the producer 24.  ptxas (nvcc 12.9) reports 168 registers at launch for
//   every dh (the cap of __launch_bounds__(384, 1), before setmaxnreg) and no
//   spills, so 64-key tiles are not needed.  Dynamic shared memory at
//   dh = 128: Q 32 KB + 2 stages x (K + V) 128 KB + barriers and 1 KB of
//   alignment slack = 164,920 bytes, one block per SM.
//
// GQA costs nothing: K and V are read at the kv head's coordinates.  No
// atomics and no order that depends on scheduling, so two runs are bit-equal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;  // consumer warpgroups (1: 64 rows a block, no setmaxnreg)
constexpr int kBQ = 64 * kConsumers;           // query rows per block
constexpr int kBKV = 128;                      // keys per tile
constexpr int kStages = 2;                     // K/V ring depth
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNegInf = -1e30f;              // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout for head dim DH.  Each tile is stored as panels of
// kPanelCols columns, a row of a panel being kRowBytes (64 or 128): the
// TMA box and the swizzle span.  8 rows of a panel are one swizzle atom.
template <int DH>
struct Smem {
  static constexpr int kPanelCols = DH >= 64 ? 64 : DH;
  static constexpr int kPanels = DH / kPanelCols;
  static constexpr int kRowBytes = kPanelCols * 2;
  static constexpr int kAtomBytes = 8 * kRowBytes;
  // The wgmma descriptors' swizzle mode: 1 = 128 B, 2 = 64 B.
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kQBytes = kBQ * DH * 2;
  static constexpr int kTileBytes = kBKV * DH * 2;  // one K or V tile
  static constexpr int kK = kQBytes;                // stage st: K at kK + st kTileBytes
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;  // full_q, full_k[], full_v[], empty[]
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A rows x DH tile (rows at row0 of head `head`) as kPanels panel loads.
template <int DH>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int rows, int row0,
                                         int head, uint32_t bar) {
  using L = Smem<DH>;
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
    tma_load(dst + p * rows * L::kRowBytes, map, p * L::kPanelCols, row0, head, bar);
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode.  Atoms are 1024-byte aligned,
// so the base offset is 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of `r` across the asynchronous wgmmas.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, f32) = A B^T, plus D when `accumulate`: A (64 x 16) and B
// (128 x 16) bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x 32, f32) = A B, plus D when `accumulate`: A (64 x 16) bf16 in
// registers, B (16 x 32) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 64, f32) = A B, plus D when `accumulate`: A (64 x 16) bf16 in
// registers, B (16 x 64) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x 128, f32) = A B, plus D when `accumulate`: A (64 x 16) bf16 in
// registers, B (16 x 128) bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// O (64 x DH) += P V for one 16-key slice: P from registers, V MN-major.
template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&p)[4],
                                         uint64_t desc_v) {
  if constexpr (DH == 128) {
    wgmma_rs_n128(o, p, desc_v, 1);
  } else if constexpr (DH == 64) {
    wgmma_rs_n64(o, p, desc_v, 1);
  } else {
    wgmma_rs_n32(o, p, desc_v, 1);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             __nv_bfloat16* __restrict__ o, int hq, int hkv, int s, float scale,
                             int window, float softcap) {
  using L = Smem<DH>;
  constexpr int kSub = L::kPanelCols / 16;  // k16 steps within one panel row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBars;
  const uint32_t bar_k = bar_q + 8;               // stage st: bar_k + 8 st
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_e = bar_v + 8 * kStages;

  const int bh = blockIdx.x;  // batch * hq + head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int kv_head = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // Key tiles some row of the block can see: keys [k_lo, k_hi).
  const int k_hi = min(s, q0 + kBQ);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_lo / kBKV;
  const int n_tiles = (k_hi - 1) / kBKV - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_k + 8 * st, 1);
      mbar_init(bar_v + 8 * st, 1);
      mbar_init(bar_e + 8 * st, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    if constexpr (kConsumers > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      tma_tile<DH>(base, &map_q, kBQ, q0, bh, bar_q);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) mbar_wait(bar_e + 8 * st, (i / kStages - 1) & 1);
        const int k0 = (t_first + i) * kBKV;
        mbar_expect_tx(bar_k + 8 * st, L::kTileBytes);
        tma_tile<DH>(base + L::kK + st * L::kTileBytes, &map_k, kBKV, k0, kv_head, bar_k + 8 * st);
        mbar_expect_tx(bar_v + 8 * st, L::kTileBytes);
        tma_tile<DH>(base + L::kV + st * L::kTileBytes, &map_v, kBKV, k0, kv_head, bar_v + 8 * st);
      }
    }
    return;
  }

  // Consumer warpgroup c: query rows row0 .. row0 + 63.
  if constexpr (kConsumers > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 64 * c;
  const int row_last = min(row0 + 63, s - 1);
  const int row_a = row0 + 16 * warp + lane / 4;  // this thread's rows: row_a, row_a + 8
  const uint64_t desc_q =
      make_desc(base + 64 * c * L::kRowBytes, 16, L::kAtomBytes, L::kLayout);

  float acc[DH / 2];  // O on the accumulator layout
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's part of the row sums

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = (t_first + i) * kBKV;
    mbar_wait(bar_k + 8 * st, parity);
    // Keys these rows can see lie in (row0 - window, row_last].
    const bool seen =
        row0 < s && k0 <= row_last && (window <= 0 || k0 + kBKV - 1 > row0 - window);
    if (!seen) {
      mbar_wait(bar_v + 8 * st, parity);
      mbar_arrive(bar_e + 8 * st);
      continue;
    }

    // S = Q K^T, f32.
    float sc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) sc[j] = 0.f;
    const uint64_t desc_k =
        make_desc(base + L::kK + st * L::kTileBytes, 16, L::kAtomBytes, L::kLayout);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off_q = (kk / kSub) * kBQ * L::kRowBytes + (kk % kSub) * 32;
      const uint32_t off_k = (kk / kSub) * kBKV * L::kRowBytes + (kk % kSub) * 32;
      wgmma_ss_n128(sc, desc_q + (off_q >> 4), desc_k + (off_k >> 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Scale, cap, mask; the running max of each row over its quad.  Masked
    // logits become -inf: with the running max starting at -1e30, as the
    // reference's, they weigh exactly 0 and never raise the max.
    const bool edge = k0 + kBKV - 1 > row0 || k0 + kBKV > s ||
                      (window > 0 && k0 <= row_last - window);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int h = (j >> 1) & 1;
      float x = sc[j] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      if (edge) {
        const int kpos = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const int qpos = row_a + 8 * h;
        if (kpos >= s || kpos > qpos || (window > 0 && kpos <= qpos - window))
          x = __uint_as_float(0xff800000u);  // -inf
      }
      sc[j] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f((m_run[h] - mx[h]) * kLog2e);
      m_run[h] = mx[h];
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // P = exp(x - m) as P_hi + P_lo, already in the A-fragment layout:
    // register r of key slice kk holds S elements 8 kk + 2 r and + 1.
    uint32_t p_hi[kBKV / 16][4], p_lo[kBKV / 16][4];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int h = j & 1;
      const float a = exp2f((sc[2 * j] - m_run[h]) * kLog2e);
      const float b = exp2f((sc[2 * j + 1] - m_run[h]) * kLog2e);
      l_run[h] += a + b;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[j >> 2][j & 3] = bf16x2_bits(hi);
      p_lo[j >> 2][j & 3] = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
    }

    // O += P_hi V + P_lo V.
    mbar_wait(bar_v + 8 * st, parity);
    const uint64_t desc_v = make_desc(base + L::kV + st * L::kTileBytes, kBKV * L::kRowBytes,
                                      L::kAtomBytes, L::kLayout);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      const uint64_t d = desc_v + ((kk * 16 * L::kRowBytes) >> 4);
      wgmma_pv<DH>(acc, p_hi[kk], d);
      wgmma_pv<DH>(acc, p_lo[kk], d);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bar_e + 8 * st);
  }

  // Epilogue: O / l as bf16, rows below s only.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = row_a + 8 * h;
    if (qpos >= s) continue;
    const float l = l_run[h] == 0.f ? 1.f : l_run[h];
    __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * s + qpos) * DH + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] / l, acc[4 * j + 2 * h + 1] / l);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// so that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 3-D map (dh, s, heads) of a (heads, s, dh) bf16 tensor, in boxes of
// one panel x `rows` rows of one head; out-of-bounds rows read as zeros.
template <int DH>
bool make_map(CUtensorMap* map, const void* ptr, int s, long long heads, int rows) {
  using L = Smem<DH>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {DH, static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {DH * 2, static_cast<cuuint64_t>(s) * DH * 2};  // bytes
  const cuuint32_t box[3] = {L::kPanelCols, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b, int hq, int hkv, int s,
           float scale, int window, float softcap, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!make_map<DH>(&map_q, q, s, static_cast<long long>(b) * hq, kBQ) ||
      !make_map<DH>(&map_k, k, s, static_cast<long long>(b) * hkv, kBKV) ||
      !make_map<DH>(&map_v, v, s, static_cast<long long>(b) * hkv, kBKV)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_attention_kernel_wgmma<DH>;
  const int smem = Smem<DH>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (s + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), hq,
                                           hkv, s, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (b, hq, s, dh); k, v: (b, hkv, s, dh); o: (b, hq, s, dh); contiguous,
// 16-byte aligned bf16.  dh is 32, 64 or 128; hq a multiple of hkv;
// b hq < 2^31 and ceil(s / 128) <= 65535.  Keys after the query are masked;
// window > 0 masks keys window or more positions behind it; softcap > 0 caps
// the logits.  Launches on `stream`, allocates nothing, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments outside these
// limits or a tensor map that cuTensorMapEncodeTiled refuses.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k, const void* v, void* o,
                                           int b, int hq, int hkv, int s, int dh, float scale,
                                           int window, float softcap, cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  if (hkv <= 0 || hq % hkv != 0 || (s + kBQ - 1) / kBQ > 65535 ||
      static_cast<long long>(b) * hq > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dh) {
    case 32: return launch<32>(q, k, v, o, b, hq, hkv, s, scale, window, softcap, stream);
    case 64: return launch<64>(q, k, v, o, b, hq, hkv, s, scale, window, softcap, stream);
    case 128: return launch<128>(q, k, v, o, b, hq, hkv, s, scale, window, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
