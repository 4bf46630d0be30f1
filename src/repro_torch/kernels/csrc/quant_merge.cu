// GK quantile merge and greedy pack, for T rows at once, and the coordinator's
// fold of m shipped summaries in one launch:
//   a: v, g, delta, wv (T, la) f32 and weight (T,);
//   b: v, g, delta, wv (T, lb) and weight (T,)  (quant_merge_pack_launch), or
//      (T, m, lb) and (T, m)                    (quant_fold_launch, la = cap)
//   -> out_v (+inf pads), out_g, out_d, out_wv (T, cap) and out_w (T,).
//
// Replaces no Pallas kernel.  The reference runs this as XLA code:
//   src/repro/core/quantiles.py:468  _quant_pack (a lax.fori_loop, one step a tuple),
//   which ends quant_merge (:523), and src/repro/core/distributed.py:521-524,
//   the coordinator's fold of its m shipped summaries, one quant_merge a site.
// In plain PyTorch (ref_quant_merge_pack, ref_quant_fold in ref.py) a merge is
// some thirty-five launches and its pack some twenty a tuple; the fold is m
// merges, one after another.
//
// What one merge computes, row by row (ref_quant_merge_pack):
//  * the stable merge of a and b by value, ties to a's entries;
//  * cum_a, cum_b: each list's prefix sum of g, and rmin = cum_a + cum_b at
//    each merged place (own inclusive rank plus the other list's mass before);
//  * the other list's next live entry and the certified upper bound it gives,
//    rmax = own_cum + d + upper_other;
//  * rmin = cummax(rmin), rmax = max(rmax, rmin), thresh = f32(2 eps) * (wa + wb);
//  * the greedy pack: tuple i folds into i + 1 when their values are equal, or
//    when ((acc + g_{i+1}) + d_{i+1}) - wv_{i+1} <= thresh and something was
//    emitted already; otherwise it is emitted at slot min(count, cap - 1), with
//    g = acc (plus what that slot held once count has reached cap).
//
// What bounds it on an H100: chains of dependent steps, not bytes (a merge
// reads and writes some 30 KB) nor operations.  Each list's prefix sum is one
// f64 addition a tuple; the pack's walk carries acc from tuple to tuple
// (four dependent f32 additions, a compare and a select); and in the fold
// the m merges depend on each other.  What the design does about it:
//
//  * One block a row (or a coordinator); the T rows run in parallel.  A
//    coordinator's m merges run in order inside its block, its running summary
//    in shared memory from one merge to the next: one launch, where the host
//    loop made m merges of some fifty-five launches each.
//  * Only live tuples enter the chains.  Both lists are compacted first (b's
//    zero-weight values are +inf holes anywhere in it: where the pads sit
//    among themselves changes no output), so a merge walks na + nb tuples,
//    not la + lb.
//  * Everything off the chains is made by the block's threads in parallel:
//    each tuple's merged place by binary search (i + #(b < a_i) for a,
//    j + #(a <= b_j) for b), its rank interval, the cummax (a block scan), g
//    and delta, packed as each tuple's walk operands.  The two prefix sums
//    run at once in two warps.
//  * The walk is cut into segments that threads walk at once.  acc only adds
//    nonnegative terms and rounded additions keep their order, so a tuple
//    that emits right after an emit (acc = 0) emits after any acc: after such
//    a certain emit the walk starts afresh.  A segment's thread carries only
//    acc and records acc at each emit; the block then ranks the emits, adds
//    the own-value mass carried across equal values and writes the packed
//    summary (past cap, the last slot's g sums the overflow in order).
//
// Bit parity with the plain version: each prefix sum is summed in f64, left to
// right, and each prefix rounded to f32 (what torch's CPU cumsum of f32
// does); then the f32 additions, subtractions, comparisons and the one product
// of ref_quant_merge_pack and ref_quant_pack in their order (the products are
// __fmul_rn, so no FMA contracts them).  Where a row does not fit in shared
// memory its arrays live in a scratch buffer in device memory that the wrapper
// allocates (quant_merge_scratch_floats): the same code, slower loads.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory a block may take (227 KB less the static arrays).
constexpr size_t kMaxDynamicSmem = 227 * 1024 - 1024;

// Floats of working space for one row: the walk's operands (4 a merged
// tuple); the running summary a (la_max = max(la, cap) a column) and b,
// compacted, 4 columns each; their prefix sums; and five columns of the
// merged list (value, wv, rmin, rmax, delta).  A multiple of 4, so that each
// row's operands stay 16-byte aligned in a scratch buffer.
__host__ __device__ inline size_t row_floats(int la, int lb, int cap) {
  const size_t la_max = static_cast<size_t>(la > cap ? la : cap), nmax = la_max + lb;
  return (4 * nmax + 5 * la_max + 5 * static_cast<size_t>(lb) + 5 * nmax + 3) / 4 * 4;
}

struct Params {
  const float *a_v, *a_g, *a_d, *a_wv, *a_w;
  const float *b_v, *b_g, *b_d, *b_wv, *b_w;
  float *out_v, *out_g, *out_d, *out_wv, *out_w;
  float* scratch;  // null: the row's arrays live in shared memory
  int m, la, lb, cap;
  float two_eps;
};

// Inclusive block scan of one value a thread with an associative `op`; also
// returns the block's total in *total.  All threads must call it.
template <class T, class Op>
__device__ T block_scan(T x, Op op, T identity, T* s_warp, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = op(y, x);
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  T before = identity, all = identity;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = op(before, s_warp[w]);
    all = op(all, s_warp[w]);
  }
  __syncthreads();  // s_warp is free again
  *total = all;
  return op(before, x);
}

struct Add {
  __device__ int operator()(int x, int y) const { return x + y; }
};
struct Max {
  __device__ float operator()(float x, float y) const { return fmaxf(x, y); }
};

// Copies the n tuples at (v, g, d, wv) whose value is finite, in order, to
// (ov, og, od, owv); returns how many.
__device__ int compact(const float* v, const float* g, const float* d, const float* wv, int n,
                       float* ov, float* og, float* od, float* owv, int* s_warp) {
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    const float x = i < n ? v[i] : CUDART_INF_F;
    const int live = isfinite(x) ? 1 : 0;
    int total;
    const int at = base + block_scan(live, Add(), 0, s_warp, &total) - live;
    if (live) {
      ov[at] = x;
      og[at] = g[i];
      od[at] = d[i];
      owv[at] = wv[i];
    }
    base += total;
  }
  return base;
}

// out[i] = f32(g[0] + ... + g[i]), the sum taken in f64 left to right by one
// thread (two lists run at once, in two warps); the loads and conversions
// run eight ahead of the f64 additions.
__device__ void prefix_sum(const float* __restrict__ g, float* __restrict__ out, int n) {
  double s = 0.0;
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    double x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = static_cast<double>(g[i + k]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s += x[k];
      out[i + k] = __double2float_rn(s);
    }
  }
  for (; i < n; ++i) {
    s += static_cast<double>(g[i]);
    out[i] = __double2float_rn(s);
  }
}

// The number of x[0..n) below y (strictly, or at or below).
template <bool kOrEqual>
__device__ int rank_in(const float* x, int n, float y) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kOrEqual ? x[mid] <= y : x[mid] < y) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// x = cummax(x) over n values, in place.
__device__ void cummax(float* x, int n, float* s_warp) {
  float carry = -CUDART_INF_F;
  for (int c0 = 0; c0 < n; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    const float xi = i < n ? x[i] : -CUDART_INF_F;
    float total;
    const float run = fmaxf(carry, block_scan(xi, Max(), -CUDART_INF_F, s_warp, &total));
    if (i < n) x[i] = run;
    carry = fmaxf(carry, total);
  }
}

// The pack's walk from tuple i, after an emit (or from the start), to the
// next certain emit, by one thread; w = W[i] = (g_i, g_{i+1}, d_{i+1},
// wv_{i+1}).  Tuple i folds into i + 1 when ((acc + g_i + g_{i+1}) + d_{i+1})
// - wv_{i+1} <= th and something was emitted already (an equal next value
// carries g_{i+1} = -inf, so it always folds; the last tuple +inf, so it never
// does).  e[i] gets acc at an emit, NaN at a fold.  Only acc is carried from
// step to step; the next tuple's operands load during this one.
__device__ void walk_segment(const float4* __restrict__ W, const int* __restrict__ certain, int i,
                             int n, float th, float* __restrict__ e) {
  float acc = 0.0f;
  bool emitted = i > 0;
  float4 w = W[i];
  int last = certain[i];
  for (;;) {
    const int k = min(i + 1, n - 1);
    const float4 w_next = W[k];
    const int last_next = certain[k];
    const float acc1 = acc + w.x;
    const bool fold = emitted ? ((acc1 + w.y) + w.z) - w.w <= th : w.y == -CUDART_INF_F;
    e[i] = fold ? CUDART_NAN_F : acc1;
    emitted = emitted || !fold;
    acc = fold ? acc1 : 0.0f;
    if (last) return;
    w = w_next;
    last = last_next;
    ++i;
  }
}

template <bool kScratch>
__global__ void __launch_bounds__(kThreads) quant_fold_kernel(Params p) {
  extern __shared__ float4 smem[];
  __shared__ int s_iwarp[kWarps];
  __shared__ float s_fwarp[kWarps];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int la_max = max(p.la, p.cap), nmax = la_max + p.lb;
  float* base = kScratch ? p.scratch + row * row_floats(p.la, p.lb, p.cap)
                         : reinterpret_cast<float*>(smem);
  float4* W = reinterpret_cast<float4*>(base);
  float *av = base + 4 * nmax, *ag = av + la_max, *ad = ag + la_max, *awv = ad + la_max;
  float *bv = awv + la_max, *bg = bv + p.lb, *bd = bg + p.lb, *bwv = bd + p.lb;
  float *pa = bwv + p.lb, *pb = pa + la_max;
  float *mv = pb + p.lb, *mwv = mv + nmax, *mrmin = mwv + nmax, *mrmax = mrmin + nmax;
  float* md = mrmax + nmax;
  // The walk's record (acc at each emit, NaN at a fold), its certain emits,
  // the segments' first tuples and the overflow slot's g terms, in columns
  // that are dead by then (pa and pb are nmax long together).
  float *e = mrmin, *over = mrmax;
  int *certain = reinterpret_cast<int*>(pa), *starts = reinterpret_cast<int*>(mrmax);

  const size_t ao = static_cast<size_t>(row) * p.la;
  int na = compact(p.a_v + ao, p.a_g + ao, p.a_d + ao, p.a_wv + ao, p.la, av, ag, ad, awv, s_iwarp);
  float aw = p.a_w[row];
  for (int j = 0; j < p.m; ++j) {
    const size_t site = static_cast<size_t>(row) * p.m + j, bo = site * p.lb;
    const int nb =
        compact(p.b_v + bo, p.b_g + bo, p.b_d + bo, p.b_wv + bo, p.lb, bv, bg, bd, bwv, s_iwarp);
    const float bw = p.b_w[site];
    __syncthreads();
    if (tid == 0) prefix_sum(ag, pa, na);
    if (tid == 32) prefix_sum(bg, pb, nb);
    __syncthreads();
    // Each tuple's merged place and rank interval.  f32 operations in
    // ref_quant_merge_pack's order: rmin = cum_a + cum_b, upper = (cum + d) -
    // wv * [v > x] at the other list's next entry (its weight when none),
    // rmax = (own_cum + d) + upper.
    for (int i = tid; i < na; i += kThreads) {
      const float x = av[i];
      const int jb = rank_in<false>(bv, nb, x);
      const float own = pa[i], rmin = own + (jb > 0 ? pb[jb - 1] : 0.0f);
      const float up = jb < nb ? (pb[jb] + bd[jb]) - __fmul_rn(bwv[jb], bv[jb] > x ? 1.0f : 0.0f)
                               : bw;
      const int at = i + jb;
      mv[at] = x;
      mwv[at] = awv[i];
      mrmin[at] = rmin;
      mrmax[at] = (own + ad[i]) + up;
    }
    for (int i = tid; i < nb; i += kThreads) {
      const float x = bv[i];
      const int ia = rank_in<true>(av, na, x);
      const float own = pb[i], rmin = (ia > 0 ? pa[ia - 1] : 0.0f) + own;
      const float up = ia < na ? (pa[ia] + ad[ia]) - __fmul_rn(awv[ia], av[ia] > x ? 1.0f : 0.0f)
                               : aw;
      const int at = i + ia;
      mv[at] = x;
      mwv[at] = bwv[i];
      mrmin[at] = rmin;
      mrmax[at] = (own + bd[i]) + up;
    }
    __syncthreads();
    const int n = na + nb;
    cummax(mrmin, n, s_fwarp);
    __syncthreads();
    // The pack's operands: g_i = max(rmin_i - rmin_{i-1}, 0), d_i =
    // max(max(rmax_i, rmin_i) - rmin_i, 0), and tuple i + 1's.  Tuple i is a
    // certain emit where it emits even after one (acc = 0): acc only adds
    // nonnegative terms, and rounded additions keep their order, so the band
    // after any acc is no smaller.  Certain emits cut the walk into segments
    // that run in parallel.
    const float weight = aw + bw, th = __fmul_rn(p.two_eps, weight);
    for (int i = tid; i < n; i += kThreads) {
      const float r = mrmin[i], prev = i > 0 ? mrmin[i - 1] : 0.0f;
      md[i] = fmaxf(fmaxf(mrmax[i], r) - r, 0.0f);
      float4 w = make_float4(fmaxf(r - prev, 0.0f), CUDART_INF_F, 0.0f, 0.0f);
      if (i + 1 < n) {
        const float rn = mrmin[i + 1];
        w.y = mv[i + 1] == mv[i] ? -CUDART_INF_F : fmaxf(rn - r, 0.0f);
        w.z = fmaxf(fmaxf(mrmax[i + 1], rn) - rn, 0.0f);
        w.w = mwv[i + 1];
      }
      W[i] = w;
      certain[i] = ((0.0f + w.x + w.y) + w.z) - w.w <= th ? 0 : 1;
    }
    __syncthreads();
    int segments = 0;
    for (int c0 = 0; c0 < n; c0 += kThreads) {
      const int i = c0 + tid;
      const int first = i < n && (i == 0 || certain[i - 1]) ? 1 : 0;
      int total;
      const int at = segments + block_scan(first, Add(), 0, s_iwarp, &total) - first;
      if (first) starts[at] = i;
      segments += total;
    }
    __syncthreads();
    for (int k = tid; k < segments; k += kThreads) walk_segment(W, certain, starts[k], n, th, e);
    __syncthreads();
    // The packed summary, the next merge's a: emit r takes slot r; past cap,
    // emits fold into the last slot, whose g then sums theirs in order.
    int emits = 0;
    for (int c0 = 0; c0 < n; c0 += kThreads)
      emits += __syncthreads_count(c0 + tid < n && !isnan(e[c0 + tid]));
    int ranked = 0;
    for (int c0 = 0; c0 < n; c0 += kThreads) {
      const int i = c0 + tid;
      const int emit = i < n && !isnan(e[i]) ? 1 : 0;
      int total;
      const int r = ranked + block_scan(emit, Add(), 0, s_iwarp, &total) - emit;
      ranked += total;
      if (!emit) continue;
      // The own-value mass carried across the equal values just before i.
      float acc_wv = 0.0f;
      int s = i;
      while (s > 0 && W[s - 1].y == -CUDART_INF_F) --s;
      for (; s < i; ++s) acc_wv = acc_wv + mwv[s];
      const int slot = min(r, p.cap - 1);
      const bool overflow = emits > p.cap;
      if (overflow && r >= p.cap - 1) over[r - (p.cap - 1)] = e[i];
      if (!overflow || r < p.cap - 1 || r == emits - 1) {
        av[slot] = mv[i];
        ag[slot] = e[i] + 0.0f;
        ad[slot] = md[i];
        awv[slot] = mwv[i] + acc_wv;
      }
    }
    __syncthreads();
    if (tid == 0 && emits > p.cap) {
      float g = over[0] + 0.0f;
      for (int r = 1; r <= emits - p.cap; ++r) g = over[r] + g;
      ag[p.cap - 1] = g;
    }
    na = min(emits, p.cap);
    aw = weight;
    __syncthreads();
  }
  const size_t oo = static_cast<size_t>(row) * p.cap;
  for (int s = tid; s < p.cap; s += kThreads) {
    const bool live = s < na;
    p.out_v[oo + s] = live ? av[s] : CUDART_INF_F;
    p.out_g[oo + s] = live ? ag[s] : 0.0f;
    p.out_d[oo + s] = live ? ad[s] : 0.0f;
    p.out_wv[oo + s] = live ? awv[s] : 0.0f;
  }
  if (tid == 0) p.out_w[row] = aw;
}

int launch(const Params& p, int T, cudaStream_t stream) {
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  if (p.cap <= 0 || p.la < 0 || p.lb < 0 || p.m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.scratch != nullptr) {
    quant_fold_kernel<true><<<T, kThreads, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = row_floats(p.la, p.lb, p.cap) * sizeof(float);
  if (smem > kMaxDynamicSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(quant_fold_kernel<false>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  quant_fold_kernel<false><<<T, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of device-memory scratch a launch of T rows needs: 0 where a row's
// working arrays fit in shared memory, else T of them.  Launches nothing.
extern "C" long long quant_merge_scratch_floats(int T, int la, int lb, int cap) {
  const size_t per_row = row_floats(la, lb, cap);
  if (per_row * sizeof(float) <= kMaxDynamicSmem) return 0;
  return static_cast<long long>(per_row) * T;
}

// a_*: (T, la), a_w (T,); b_*: (T, lb), b_w (T,); out_*: (T, cap), out_w
// (T,); scratch: quant_merge_scratch_floats(T, la, lb, cap) floats (null when
// that is 0).  All f32 contiguous.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int quant_merge_pack_launch(const float* a_v, const float* a_g, const float* a_d,
                                       const float* a_wv, const float* a_w, const float* b_v,
                                       const float* b_g, const float* b_d, const float* b_wv,
                                       const float* b_w, float* out_v, float* out_g, float* out_d,
                                       float* out_wv, float* out_w, float* scratch, int T, int la,
                                       int lb, int cap, float two_eps, cudaStream_t stream) {
  const Params p{a_v,   a_g,   a_d,    a_wv,  a_w,     b_v, b_g, b_d,  b_wv, b_w,    out_v,
                 out_g, out_d, out_wv, out_w, scratch, 1,   la,  lb,   cap,  two_eps};
  return launch(p, T, stream);
}

// As quant_merge_pack_launch with b_*: (T, m, lb) and b_w (T, m): row t
// merges its m summaries into a_t in order 0..m-1 (la must equal cap).
extern "C" int quant_fold_launch(const float* a_v, const float* a_g, const float* a_d,
                                 const float* a_wv, const float* a_w, const float* b_v,
                                 const float* b_g, const float* b_d, const float* b_wv,
                                 const float* b_w, float* out_v, float* out_g, float* out_d,
                                 float* out_wv, float* out_w, float* scratch, int T, int m, int la,
                                 int lb, int cap, float two_eps, cudaStream_t stream) {
  if (la != cap) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{a_v,   a_g,   a_d,    a_wv,  a_w,     b_v, b_g, b_d,  b_wv, b_w,    out_v,
                 out_g, out_d, out_wv, out_w, scratch, m,   la,  lb,   cap,  two_eps};
  return launch(p, T, stream);
}
