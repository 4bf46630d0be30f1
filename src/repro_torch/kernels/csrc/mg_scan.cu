// Weighted Misra--Gries over an item stream, for S summaries at once:
//   keys (S, k) i32 (-1 = empty), counts (S, k) f32, weight (S,), shrink (S,) f32,
//   items (S, b) i32 keys and f32 weights -> the updated keys, counts, weight, shrink.
//
// Replaces no Pallas kernel.  The reference runs this loop as XLA code:
//   src/repro/core/hh.py:98  mg_update_stream  (lax.scan of mg_update, one step an item)
// Written as plain PyTorch, each step is some twenty launches (ref_mg_scan in
// ref.py), and the heavy-hitter path scans tens of thousands of items a site.
//
// What bounds it on an H100: the chain of dependent steps.  The bytes (the
// state read and written once, the items read once) take a fraction of a
// microsecond and the operations (a compare and a subtraction a slot an
// item) less; but item t + 1 reads the slots item t wrote, so the b items of
// a summary run one after another.  What the design does about it:
//
//  * One warp, one block, one summary; the S summaries run in parallel, S
//    blocks.  Slot j belongs to lane j % 32.  Every step of an item is lanes
//    over their slots and warp-wide votes and shuffles (no __syncthreads).
//  * Route 1 (mg_scan_registers_launch, k <= 512): a lane keeps its slots in
//    registers, SPL = ceil(k / 32) keys and counts (a template parameter, so
//    the slot loops unroll and index registers; a slot is picked by a bit
//    mask, never by a computed index, which would put them in local memory).
//    An item's step is SPL integer compares, predicated additions and one
//    vote: a hit adds w in the owning lane, with no branch, and the next
//    item's compares wait only on the keys, which a hit leaves as they
//    were.  The first empty slot (a reduction of each lane's least empty
//    index) is sought only on a miss, and the first minimal slot (the least
//    (count, index) pair over the warp) only when there is no empty one.
//  * Route 2 (mg_scan_shared_launch, k > 512): the slots in shared memory,
//    walked by the lanes each item.  Chosen by k, never on a failure.
//  * The items arrive 32 at a time, one per lane in a coalesced load issued
//    a batch ahead, and are broadcast one by one with a shuffle issued an
//    item ahead, off the chain.
//
// The same f32 additions, subtractions and comparisons as ref_mg_scan, in
// the same order, and no multiplication: the kernel is bit-identical to the
// plain version, and its ties go where the reference's go (argmax / argmin
// take the first index).  An item key of -1 "hits" every empty slot, as
// `keys == key` does in the reference.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <utility>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxSlotsPerLane = 16;  // route 1 up to k = 512

// The least (count, index) pair over the warp, in every lane.
__device__ void warp_argmin(float& min_c, int& arg) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float c2 = __shfl_xor_sync(kFull, min_c, off);
    const int j2 = __shfl_xor_sync(kFull, arg, off);
    if (c2 < min_c || (c2 == min_c && j2 < arg)) {
      min_c = c2;
      arg = j2;
    }
  }
}

template <int SPL>
__global__ void __launch_bounds__(kWarp)
mg_scan_registers_kernel(const int* __restrict__ keys_in, const float* __restrict__ counts_in,
                         const float* __restrict__ weight_in, const float* __restrict__ shrink_in,
                         const int* __restrict__ item_keys, const float* __restrict__ item_w,
                         int* __restrict__ keys_out, float* __restrict__ counts_out,
                         float* __restrict__ weight_out, float* __restrict__ shrink_out, int k,
                         int b) {
  const int site = blockIdx.x, lane = threadIdx.x;
  const size_t slots = static_cast<size_t>(site) * k;
  // Only the last slot of a lane can lie past k (SPL = ceil(k / 32)).
  const bool last_valid = lane + kWarp * (SPL - 1) < k;
  int key_r[SPL];
  float cnt_r[SPL];
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    const int j = lane + kWarp * s;
    const bool valid = s < SPL - 1 || last_valid;
    key_r[s] = valid ? keys_in[slots + j] : -1;
    cnt_r[s] = valid ? counts_in[slots + j] : 0.0f;
  }
  float weight = weight_in[site], shrink = shrink_in[site];

  const int* ik = item_keys + static_cast<size_t>(site) * b;
  const float* iw = item_w + static_cast<size_t>(site) * b;
  int next_key = lane < b ? ik[lane] : 0;
  float next_w = lane < b ? iw[lane] : 0.0f;
  for (int base = 0; base < b; base += kWarp) {
    const int n = min(kWarp, b - base);
    const int my_key = next_key;
    const float my_w = next_w;
    if (base + kWarp + lane < b) {  // the next batch's load, in flight during this one
      next_key = ik[base + kWarp + lane];
      next_w = iw[base + kWarp + lane];
    }
    // Item t + 1's broadcast is issued before item t's step: off the chain.
    int key = __shfl_sync(kFull, my_key, 0);
    float w = __shfl_sync(kFull, my_w, 0);
    for (int t = 0; t < n; ++t) {
      const int key_next = __shfl_sync(kFull, my_key, t + 1);
      const float w_next = __shfl_sync(kFull, my_w, t + 1);
      // Case 1, the key's counter grows, without a branch: no slot of a lane
      // that holds no hit changes.
      bool hit = false;
#pragma unroll
      for (int s = 0; s < SPL; ++s) {
        const bool h = key_r[s] == key && (s < SPL - 1 || last_valid);
        cnt_r[s] = h ? cnt_r[s] + w : cnt_r[s];
        hit |= h;
      }
      if (!__any_sync(kFull, hit)) {
        int empty = INT_MAX;  // this lane's first empty slot
#pragma unroll
        for (int s = SPL - 1; s >= 0; --s)
          if (key_r[s] == -1 && (s < SPL - 1 || last_valid)) empty = lane + kWarp * s;
        const int first_empty = __reduce_min_sync(kFull, empty);
        if (first_empty != INT_MAX) {  // case 2: the first empty slot takes it
          // The slot as a bit of the owning lane's mask: selects a slot, where
          // an index would put the slots in local memory.
          const unsigned mine = lane == first_empty % kWarp ? 1u << (first_empty / kWarp) : 0u;
#pragma unroll
          for (int s = 0; s < SPL; ++s) {
            const bool take = (mine >> s) & 1u;
            key_r[s] = take ? key : key_r[s];
            cnt_r[s] = take ? w : cnt_r[s];
          }
        } else {  // case 3: every counter drops by delta = min(min count, w)
          float min_c = CUDART_INF_F;
          int arg = INT_MAX;  // this lane's first minimal slot
#pragma unroll
          for (int s = 0; s < SPL; ++s) {
            if ((s < SPL - 1 || last_valid) && cnt_r[s] < min_c) {
              min_c = cnt_r[s];
              arg = lane + kWarp * s;
            }
          }
          warp_argmin(min_c, arg);
          const float delta = fminf(min_c, w);
          const float w_left = w - delta;
          // The first minimal slot takes the rest, if any.
          const unsigned mine = w_left > 0.0f && lane == arg % kWarp ? 1u << (arg / kWarp) : 0u;
#pragma unroll
          for (int s = 0; s < SPL; ++s) {
            const bool take = (mine >> s) & 1u;
            cnt_r[s] = take ? w_left : fmaxf(cnt_r[s] - delta, 0.0f);
            key_r[s] = take ? key : key_r[s];
          }
          shrink = shrink + delta;
        }
      }
      weight = weight + w;
      key = key_next;
      w = w_next;
    }
  }
#pragma unroll
  for (int s = 0; s < SPL; ++s) {
    if (s < SPL - 1 || last_valid) {
      keys_out[slots + lane + kWarp * s] = key_r[s];
      counts_out[slots + lane + kWarp * s] = cnt_r[s];
    }
  }
  if (lane == 0) {
    weight_out[site] = weight;
    shrink_out[site] = shrink;
  }
}

__global__ void __launch_bounds__(kWarp)
mg_scan_shared_kernel(const int* __restrict__ keys_in, const float* __restrict__ counts_in,
                      const float* __restrict__ weight_in, const float* __restrict__ shrink_in,
                      const int* __restrict__ item_keys, const float* __restrict__ item_w,
                      int* __restrict__ keys_out, float* __restrict__ counts_out,
                      float* __restrict__ weight_out, float* __restrict__ shrink_out, int k,
                      int b) {
  extern __shared__ float smem[];
  float* s_counts = smem;
  int* s_keys = reinterpret_cast<int*>(smem + k);
  const int site = blockIdx.x, lane = threadIdx.x;
  const size_t slots = static_cast<size_t>(site) * k;
  for (int j = lane; j < k; j += kWarp) {
    s_keys[j] = keys_in[slots + j];
    s_counts[j] = counts_in[slots + j];
  }
  float weight = weight_in[site], shrink = shrink_in[site];
  __syncwarp();

  const int* ik = item_keys + static_cast<size_t>(site) * b;
  const float* iw = item_w + static_cast<size_t>(site) * b;
  for (int base = 0; base < b; base += kWarp) {
    const int n = min(kWarp, b - base);
    const int my_key = lane < n ? ik[base + lane] : 0;
    const float my_w = lane < n ? iw[base + lane] : 0.0f;
    for (int t = 0; t < n; ++t) {
      const int key = __shfl_sync(kFull, my_key, t);
      const float w = __shfl_sync(kFull, my_w, t);
      bool hit = false;
      int empty = INT_MAX;  // this lane's first empty slot
      float min_c = CUDART_INF_F;
      int arg = INT_MAX;  // this lane's first minimal slot
      for (int j = lane; j < k; j += kWarp) {
        const int kj = s_keys[j];
        const float cj = s_counts[j];
        hit |= kj == key;
        if (kj == -1 && empty == INT_MAX) empty = j;
        if (cj < min_c) {
          min_c = cj;
          arg = j;
        }
      }
      if (__any_sync(kFull, hit)) {  // case 1
        for (int j = lane; j < k; j += kWarp)
          if (s_keys[j] == key) s_counts[j] = s_counts[j] + w;
      } else {
        const int first_empty = __reduce_min_sync(kFull, empty);
        if (first_empty != INT_MAX) {  // case 2
          if (lane == first_empty % kWarp) {
            s_keys[first_empty] = key;
            s_counts[first_empty] = w;
          }
        } else {  // case 3
          warp_argmin(min_c, arg);
          const float delta = fminf(min_c, w);
          const float w_left = w - delta;
          const bool take = w_left > 0.0f;
          for (int j = lane; j < k; j += kWarp) {
            float c = fmaxf(s_counts[j] - delta, 0.0f);
            if (take && j == arg) {
              c = w_left;
              s_keys[j] = key;
            }
            s_counts[j] = c;
          }
          shrink = shrink + delta;
        }
      }
      weight = weight + w;
      __syncwarp();
    }
  }
  for (int j = lane; j < k; j += kWarp) {
    keys_out[slots + j] = s_keys[j];
    counts_out[slots + j] = s_counts[j];
  }
  if (lane == 0) {
    weight_out[site] = weight;
    shrink_out[site] = shrink;
  }
}

using Kernel = void (*)(const int*, const float*, const float*, const float*, const int*,
                        const float*, int*, float*, float*, float*, int, int);

template <int... SPL>
Kernel registers_kernel(int spl, std::integer_sequence<int, SPL...>) {
  Kernel kernel = nullptr;
  ((kernel = spl == SPL + 1 ? mg_scan_registers_kernel<SPL + 1> : kernel), ...);
  return kernel;
}

}  // namespace

// keys, counts: (S, k); weight, shrink: (S,); item_keys, item_w: (S, b); the
// outputs have the inputs' shapes and may not alias them.  All contiguous.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
// Route 1: 1 <= k <= 512.
extern "C" int mg_scan_registers_launch(const int* keys_in, const float* counts_in,
                                        const float* weight_in, const float* shrink_in,
                                        const int* item_keys, const float* item_w, int* keys_out,
                                        float* counts_out, float* weight_out, float* shrink_out,
                                        int S, int k, int b, cudaStream_t stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  if (k <= 0 || k > kWarp * kMaxSlotsPerLane || b < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = registers_kernel((k + kWarp - 1) / kWarp,
                                         std::make_integer_sequence<int, kMaxSlotsPerLane>());
  kernel<<<S, kWarp, 0, stream>>>(keys_in, counts_in, weight_in, shrink_in, item_keys, item_w,
                                  keys_out, counts_out, weight_out, shrink_out, k, b);
  return static_cast<int>(cudaGetLastError());
}

// As mg_scan_registers_launch, for any k whose slots fit in shared memory
// (route 2, taken for k > 512).
extern "C" int mg_scan_shared_launch(const int* keys_in, const float* counts_in,
                                     const float* weight_in, const float* shrink_in,
                                     const int* item_keys, const float* item_w, int* keys_out,
                                     float* counts_out, float* weight_out, float* shrink_out,
                                     int S, int k, int b, cudaStream_t stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(k) * (sizeof(float) + sizeof(int));
  if (k <= 0 || b < 0 || smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mg_scan_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mg_scan_shared_kernel<<<S, kWarp, smem, stream>>>(keys_in, counts_in, weight_in, shrink_in,
                                                    item_keys, item_w, keys_out, counts_out,
                                                    weight_out, shrink_out, k, b);
  return static_cast<int>(cudaGetLastError());
}
