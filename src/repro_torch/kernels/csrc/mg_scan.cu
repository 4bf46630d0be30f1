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
// a summary run one after another, each at least one round trip through
// shared memory.  What the design does about it:
//
//  * One warp, one block, one summary.  A summary's k slots live in shared
//    memory, slot j with lane j % 32.  Every step of an item is lanes over
//    their slots and warp-wide votes and shuffles (no __syncthreads): hit =
//    any lane holds the key; the first empty slot = the least empty index;
//    the first minimal slot = the least (count, index) pair.  The S summaries
//    run in parallel, S blocks.
//  * The items arrive 32 at a time, one per lane in a coalesced load, and
//    are broadcast one by one with a shuffle.
//  * The votes for the minimum are taken only when the item neither hits
//    nor finds an empty slot, which decides the step.
//
// The same f32 additions, subtractions and comparisons as ref_mg_scan, in
// the same order, and no multiplication: the kernel is bit-identical to the
// plain version, and its ties go where the reference's go (argmax / argmin
// take the first index).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 227 * 1024;

__global__ void __launch_bounds__(kWarp)
mg_scan_kernel(const int* __restrict__ keys_in, const float* __restrict__ counts_in,
               const float* __restrict__ weight_in, const float* __restrict__ shrink_in,
               const int* __restrict__ item_keys, const float* __restrict__ item_w,
               int* __restrict__ keys_out, float* __restrict__ counts_out,
               float* __restrict__ weight_out, float* __restrict__ shrink_out, int k, int b) {
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
      if (__any_sync(kFull, hit)) {  // case 1: the key's counter grows
        for (int j = lane; j < k; j += kWarp)
          if (s_keys[j] == key) s_counts[j] = s_counts[j] + w;
      } else {
        const int first_empty = __reduce_min_sync(kFull, empty);
        if (first_empty != INT_MAX) {  // case 2: the first empty slot takes it
          if (lane == first_empty % kWarp) {
            s_keys[first_empty] = key;
            s_counts[first_empty] = w;
          }
        } else {  // case 3: every counter drops by delta = min(min count, w)
          for (int off = kWarp / 2; off > 0; off >>= 1) {
            const float c2 = __shfl_xor_sync(kFull, min_c, off);
            const int j2 = __shfl_xor_sync(kFull, arg, off);
            if (c2 < min_c || (c2 == min_c && j2 < arg)) {
              min_c = c2;
              arg = j2;
            }
          }
          const float delta = fminf(min_c, w);
          const float w_left = w - delta;
          const bool take = w_left > 0.0f;  // the first minimal slot takes the rest
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

}  // namespace

// keys, counts: (S, k); weight, shrink: (S,); item_keys, item_w: (S, b); the
// outputs have the inputs' shapes and may not alias them.  All contiguous.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int mg_scan_launch(const int* keys_in, const float* counts_in, const float* weight_in,
                              const float* shrink_in, const int* item_keys, const float* item_w,
                              int* keys_out, float* counts_out, float* weight_out,
                              float* shrink_out, int S, int k, int b, cudaStream_t stream) {
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(k) * (sizeof(float) + sizeof(int));
  if (k <= 0 || b < 0 || smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mg_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mg_scan_kernel<<<S, kWarp, smem, stream>>>(keys_in, counts_in, weight_in, shrink_in, item_keys,
                                             item_w, keys_out, counts_out, weight_out, shrink_out,
                                             k, b);
  return static_cast<int>(cudaGetLastError());
}
