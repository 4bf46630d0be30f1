// Greedy GK compress of T rows of sorted interval tuples into cap slots:
//   v, rmin, rmax, wv (T, n) f32, each row sorted by v with +inf pads last,
//   thresh (T,) f32 -> out_v (+inf pads), out_g, out_d, out_wv (T, cap) f32.
//
// Replaces no Pallas kernel.  The reference runs this loop as XLA code:
//   src/repro/core/quantiles.py:468  _quant_pack  (lax.fori_loop, one step a tuple)
// It ends every quant_merge and quant_insert.  Written as plain PyTorch, each
// step is some twenty launches (ref_quant_pack in ref.py), and the quantile
// path's coordinator folds m shipped summaries a super-step, one after
// another, each a pack of 2 cap tuples.
//
// The rule, tuple by tuple: g_i = max(rmin_i - rmin_{i-1}, 0) joins the
// running acc; tuple i folds into i + 1 when their values are equal, or when
// the merged band ((acc + g_{i+1}) + d_{i+1}) - wv_{i+1} stays within thresh
// and something was emitted already; otherwise it is emitted at slot
// min(count, cap - 1) with g = acc (plus what that slot held, once count has
// reached cap), d_i and wv_i plus the own-value mass carried across equal
// values.
//
// What bounds it on an H100: the chain of dependent steps.  The bytes (four
// inputs read once, four outputs written once) take a fraction of a
// microsecond; but each step's fold decision reads the acc and count the
// step before left, so the n tuples of a row run one after another.  What
// the design does about it:
//
//  * One block a row; the T rows run in parallel.
//  * The walk reads shared memory, not device memory: the block's 256
//    threads stage the row's four inputs in chunks of kChunk tuples (plus the
//    next one) with coalesced loads, and one thread walks the chunk, so each
//    step's loads are shared-memory reads that do not wait on the step
//    before.  The outputs are written as they are decided.
//
// The same f32 additions, subtractions and comparisons as ref_quant_pack, in
// the same order, and no multiplication: the kernel is bit-identical to the
// plain version.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;

__global__ void __launch_bounds__(kThreads)
quant_pack_kernel(const float* __restrict__ v, const float* __restrict__ rmin,
                  const float* __restrict__ rmax, const float* __restrict__ wv,
                  const float* __restrict__ thresh, float* __restrict__ out_v,
                  float* __restrict__ out_g, float* __restrict__ out_d,
                  float* __restrict__ out_wv, int n, int cap) {
  __shared__ float s_v[kChunk + 1], s_rmin[kChunk + 1], s_rmax[kChunk + 1], s_wv[kChunk + 1];
  const int row = blockIdx.x;
  const size_t in = static_cast<size_t>(row) * n, out = static_cast<size_t>(row) * cap;
  for (int j = threadIdx.x; j < cap; j += kThreads) {
    out_v[out + j] = CUDART_INF_F;
    out_g[out + j] = 0.0f;
    out_d[out + j] = 0.0f;
    out_wv[out + j] = 0.0f;
  }
  const float th = thresh[row];
  // The walk's state, held by thread 0 across chunks.
  float acc = 0.0f, acc_wv = 0.0f, last_g = 0.0f, rmin_prev = 0.0f;
  int count = 0;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int len = min(kChunk + 1, n - c0);  // the chunk and the tuple after it
    __syncthreads();  // the walk of the previous chunk is done
    for (int j = threadIdx.x; j < len; j += kThreads) {
      s_v[j] = v[in + c0 + j];
      s_rmin[j] = rmin[in + c0 + j];
      s_rmax[j] = rmax[in + c0 + j];
      s_wv[j] = wv[in + c0 + j];
    }
    __syncthreads();
    if (threadIdx.x != 0) continue;
    const int steps = min(kChunk, n - c0);
    for (int li = 0; li < steps; ++li) {
      const int i = c0 + li;
      const float vi = s_v[li], rmin_i = s_rmin[li], wv_i = s_wv[li];
      const float g_i = fmaxf(rmin_i - rmin_prev, 0.0f);
      const float d_i = fmaxf(s_rmax[li] - rmin_i, 0.0f);
      const bool live_i = isfinite(vi);
      acc = acc + (live_i ? g_i : 0.0f);
      bool same = false, fold = false;
      if (i + 1 < n) {
        const float v_n = s_v[li + 1], rmin_n = s_rmin[li + 1];
        if (isfinite(v_n)) {  // has_next
          const float g_n = fmaxf(rmin_n - rmin_i, 0.0f);
          const float d_n = fmaxf(s_rmax[li + 1] - rmin_n, 0.0f);
          const float band = acc + g_n + d_n - s_wv[li + 1];
          same = v_n == vi;
          fold = same || (band <= th && count > 0);
        }
      }
      if (live_i && !fold) {  // emit
        const int idx = min(count, cap - 1);
        const float g_out = acc + (count >= cap ? last_g : 0.0f);
        out_v[out + idx] = vi;
        out_g[out + idx] = g_out;
        out_d[out + idx] = d_i;
        out_wv[out + idx] = wv_i + acc_wv;
        if (idx == cap - 1) last_g = g_out;
        count += 1;
        acc = 0.0f;
      }
      acc_wv = (same && live_i) ? acc_wv + wv_i : 0.0f;
      rmin_prev = rmin_i;
    }
  }
}

}  // namespace

// v, rmin, rmax, wv: (T, n); thresh: (T,); out_v, out_g, out_d, out_wv:
// (T, cap); all f32 contiguous.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int quant_pack_launch(const float* v, const float* rmin, const float* rmax,
                                 const float* wv, const float* thresh, float* out_v,
                                 float* out_g, float* out_d, float* out_wv, int T, int n, int cap,
                                 cudaStream_t stream) {
  if (T <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  quant_pack_kernel<<<T, kThreads, 0, stream>>>(v, rmin, rmax, wv, thresh, out_v, out_g, out_d,
                                                out_wv, n, cap);
  return static_cast<int>(cudaGetLastError());
}
