// Placement of one scheduling activation on the card, for Hopper (sm_90a).
//
// Two kernels run right after score_activation (sched_score.cu), on the same
// stream, and read its output buffer where it lies:
//
// * dada_place_kernel replaces DADA's lambda search, the jitted
//   _build_search_fn of repro/core/backend.py:633 (dada_lambda_search :522:
//   the probe verdict :655-786 and the speculative bisection :790-835),
//   together with the host try_build that rebuilds the placement at the
//   settled lambda (repro/core/dada.py:452-490). From the cost matrix C, the
//   affinity matrix S and the row maxima of X it computes each task's
//   preferred resource, the (-score, tid) order of the preferences, the
//   worst-case transfer sum, the upper bound and the bisection on lambda, and
//   writes the rid of every task, the loads, lambda and a status word (1:
//   lambda = upper was infeasible). On a machine that has lost resources
//   (flag kLive) it places as the reference's scalar path does there
//   (repro/core/dada.py:132-155, 203-218, 259-270, 282-310, 444-447): the
//   detached rids are not in the CPU and GPU lists, the preference scan
//   skips the columns the host marks (detached, and noticed under recover),
//   a noticed column of C pays the remaining notice window (C + pen, added
//   at every read of C, one rounding as the host's once-formed C), the area
//   bound counts the alive resources, and the
//   upper bound adds n * max(pen) after ((sum_max + max_off) + worst) +
//   1e-12.
// * heft_select_kernel replaces HEFT's earliest-finish-time scan, the jitted
//   _build_heft_fn of repro/core/backend.py:877 (heft_select :843): tasks in
//   priority order, each to the resource of least (start + X) + duration,
//   with the 1e-15 strict-improvement left fold (:885-911).
//
// Bit-exact f64 in the reference's op order. Every addition, product and
// division is __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn, so no FMA
// contraction moves a bit (the build must not use --use_fast_math). Loads
// accumulate in the host's order. A first-occurrence argmin (strict <) is a
// warp reduction over (value, index): the least value, then the least index
// holding it. The preference scan with its 1e-12 tolerance stays sequential
// over the resources in rid order (one thread per task); the affinity phase
// runs one lane per resource down that resource's chain of preferences, as
// the reference's per-resource chains do (backend.py:579-605).
//
// What bounds it on an H100. An activation of the main path reads a few KB
// (C, S and the row maxima of at most 128 x 14 entries) and writes less: the
// byte and operation bounds are nanoseconds. The work is a chain of dependent
// steps: a probe places the tasks one after another, each step's argmin
// needs the loads the previous step left, and each probe's lambda needs the
// previous probe's verdict. The designs shorten the chain and keep every
// step on shared memory and registers:
//
// * DADA: a speculative midpoint tree, as the reference's jitted search
//   (backend.py:796-830). One block of K = 2^d - 1 warps; each round every
//   warp derives the same heap of midpoints from (lower, upper), warp k
//   builds at midpoint k into its own state (loads in registers, one int16
//   rid a task in shared memory), and after one barrier every warp walks up
//   to d levels of the verdicts, re-checking the stopping rule before each
//   level and counting the probes as the serial loop does. So lambda and the
//   probe count are the serial bisection's, bit for bit, in ceil(probes / d)
//   rounds. The warp whose probe last lowered upper writes its placement out
//   (the plain version keeps that placement too); a build at upper runs only
//   when no probe was feasible. d is 5 where registers and shared memory
//   allow it (the launcher picks it from n and n_res, dada_plan). The whole
//   block stages the activation once with cp.async (C, p_cpu, p_gpu,
//   offsets, flex_order, tids, x_max) where it fits; where C, or the task
//   vectors too, do not fit, the kernel reads them from global memory
//   instead. The set-up is spread over the block: one thread per task for
//   the preference scan and for the chains (O(n) each); the worst-transfer
//   sum stays one in-order sum from +0.0, by one thread. A placement step
//   is one argmin, three dependent warp reductions (the 64-bit key's two
//   words, then the first place, which carries the rid); at d = 5 the 31
//   warps also share the SM's four schedulers, so a step costs more than at
//   d = 3 or 4, but the fewer rounds win (tools/place_time.py).
// * HEFT: the X and duration rows reach shared memory ahead of the scan. Where
//   the activation fits (X, the class durations and the order), the whole
//   block stages it in one pass; otherwise a double-buffered ring of up to 32
//   tasks' rows in priority order, filled by warps 1-7 with cp.async while
//   warp 0 scans the group before. Warp 0 keeps each lane's time stamps in
//   registers, reads the next task's rows during each fold and computes the
//   candidates in registers; the fold takes an exact fast path (heft_fold:
//   the first minimum, and one vote that no other candidate lies within the
//   margin) and writes the rids and finish times out 32 at a time.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr double kTiny = 1e-12;     // dada.py's _TINY
constexpr double kHeftTie = 1e-15;  // HEFT's strict-improvement margin
constexpr int kSmemLimit = 232448;  // shared memory one block can opt in to
constexpr int kMaxSlots = 8;        // DADA: rids per lane (n_res <= 256)
// DADA: the deepest tree per class of rids a lane (1, 2, 4, 8): d = 5 is 31
// warps (64 registers a thread), d = 4 is 15 (128)
constexpr int kDadaMaxDepth[4] = {5, 5, 5, 4};
constexpr int kHeftThreads = 256;   // HEFT: warp 0 scans, all stage
constexpr int kHeftMaxSlots = 16;   // HEFT: time stamps per lane (n_res <= 512)
constexpr int kHeftGroup = 32;      // HEFT: tasks a ring buffer holds at most

// flags of a DADA placement (sched_place.py's PLACE_*)
constexpr int kWantS = 1, kWantX = 2, kAreaBound = 4, kLive = 8;

// Slot offsets, in the order of sched_place.py's SCORE_REFS + PLACE_IN_SECTIONS
// + PLACE_OUT_SECTIONS: p_cpu and p_gpu in the input buffer; c, x, x_max and s
// in the scorer's output buffer; the placement section in the input buffer;
// the placement outputs in their own buffer.
struct Layout {
  int64_t p_cpu, p_gpu;
  int64_t c, x, x_max, s;
  int64_t offsets, flex_order, tids, max_off, sum_max, area, off_total, alpha, two_alpha,
      eps_rel, max_iters, cpu_rids, gpu_rids, pen, skip, n_alive, pen_top, order, durations,
      cls_of_res, load_ts, now;
  int64_t status, iters, lam, loads, rids, efts;
};

// ---- sizing: sched_place.py's PlaceSpec.plan / smem_bytes mirror these ----

int slot_class(int n_res) {  // rids a lane, rounded up to a power of two, as an index
  const int slots = (n_res + 31) / 32;
  int c = 0;
  while ((1 << c) < slots) ++c;
  return c;
}

// DADA's shared memory at tree depth d and staging level `stage` (0: nothing
// staged; 1: the task vectors; 2: those and C). f64 words: the worst sum,
// offsets, [the notice penalties, when live], the preference scores, [p_cpu,
// p_gpu, x_max, tids, flex_order], [C]; int32 words: next, the preferred
// rid, head, each rid's position in the CPU / GPU list, two rounds of 32
// verdicts; int16: each warp's rid a task.
size_t dada_smem(int n, int n_res, int depth, int stage, bool live) {
  const size_t N = n, NR = n_res, warps = (size_t(1) << depth) - 1;
  size_t f64 = 1 + NR + (live ? NR : 0) + N;
  if (stage >= 1) f64 += 5 * N;
  if (stage >= 2) f64 += N * NR;
  const size_t i32 = 2 * N + 3 * NR + 64;
  return 8 * f64 + 4 * i32 + 2 * warps * N;
}

struct DadaPlan {
  int depth, stage;
  size_t smem;
};

// The deepest tree whose unstaged layout fits, then the most staging that
// fits beside it. depth 0: beyond the kernel.
DadaPlan dada_plan(int n, int n_res, int n_cpu, int n_gpu, bool live) {
  DadaPlan p{0, 0, 0};
  if (n < 1 || n_res < 1 || n_res > 32 * kMaxSlots || n_cpu + n_gpu < 1) return p;
  for (int d = kDadaMaxDepth[slot_class(n_res)]; d >= 1; --d) {
    if (dada_smem(n, n_res, d, 0, live) <= size_t(kSmemLimit)) {
      p.depth = d;
      break;
    }
  }
  if (p.depth == 0) return p;
  for (int s = 2; s >= 0; --s) {
    p.smem = dada_smem(n, n_res, p.depth, s, live);
    if (p.smem <= size_t(kSmemLimit)) {
      p.stage = s;
      break;
    }
  }
  return p;
}

struct HeftPlan {
  int group, nbuf;  // tasks a buffer, buffers (1: the whole activation in one pass)
  size_t smem;
};

// One pass: X (n x n_res), the class durations (n_cls x n) and the order, as
// they lie. Otherwise two buffers of `group` tasks' X and duration rows, in
// priority order.
HeftPlan heft_plan(int n, int n_res, int n_cls) {
  HeftPlan p{0, 0, 0};
  if (n < 1 || n_res < 1 || n_res > 32 * kHeftMaxSlots || n_cls < 1) return p;
  const size_t one = 8 * (size_t(n) * n_res + size_t(n_cls) * n + size_t(n));
  if (one <= size_t(kSmemLimit)) return HeftPlan{n, 1, one};
  const size_t row = 16 * size_t(n_res);  // one task's X and duration rows
  size_t g = size_t(kSmemLimit) / (2 * row);
  if (g > size_t(kHeftGroup)) g = kHeftGroup;
  if (g < 1) return p;
  return HeftPlan{static_cast<int>(g), 2, 2 * g * row};
}

// ---- device helpers -----------------------------------------------------------

__device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `count` 8-byte words from src to dst, spread over `threads` threads
__device__ __forceinline__ void stage_words(void* dst, const void* src, int64_t count, int tid,
                                            int threads) {
  for (int64_t j = tid; j < count; j += threads)
    cp_async_8(static_cast<char*>(dst) + 8 * j, static_cast<const char*>(src) + 8 * j);
}

// An order-preserving 64-bit key of a double: a < b exactly when
// key(a) < key(b), for every double but NaN (and -0.0 sorts below +0.0,
// which the loads never hold: they are sums of non-negative terms from
// +0.0). Equal keys are equal doubles.
__device__ __forceinline__ unsigned long long order_key(double v) {
  const unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(v));
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double from_key(unsigned long long k) {
  return __longlong_as_double(static_cast<long long>((k >> 63) ? (k & ~0x8000000000000000ull) : ~k));
}

constexpr unsigned long long kNoKey = ~0ull;  // above every double's key

// The warp's least key, in two reductions (its high word, then its low word
// among the lanes at that high word).
__device__ __forceinline__ unsigned long long warp_min_key(unsigned long long key) {
  const unsigned hi = static_cast<unsigned>(key >> 32), lo = static_cast<unsigned>(key);
  const unsigned min_hi = __reduce_min_sync(kFull, hi);
  const unsigned min_lo = __reduce_min_sync(kFull, hi == min_hi ? lo : 0xffffffffu);
  return (static_cast<unsigned long long>(min_hi) << 32) | min_lo;
}

// The warp's first minimum. Each lane holds its own least (key, pos), pos =
// INT_MAX where it holds none; every lane returns the least value and the
// least pos holding it (a third reduction, among the lanes at that key).
__device__ __forceinline__ double argmin_first(unsigned long long key, int& pos) {
  const unsigned long long least = warp_min_key(key);
  pos = __reduce_min_sync(kFull, key == least ? pos : INT_MAX);
  return from_key(least);
}

// ---- DADA ------------------------------------------------------------------------

// A warp's loads live in registers: lane l holds the loads of rids l, l + 32,
// ... (R of them), with each rid's place in the CPU and in the GPU list: a
// place is (position << 8) | rid, so that the least place is the least
// position and carries its rid; INT_MAX: not in the list.
template <int R>
struct Lanes {
  double load[R];
  int cplace[R], gplace[R];
};

// C[t, r] from task t's cost row: plus the notice penalty of column r where
// `pen` is given (a live machine) and it is positive, as the host adds it
// once to each noticed column.
__device__ __forceinline__ double cost_at(const double* crow, const double* pen, int r) {
  const double c = crow[r];
  if (pen == nullptr) return c;
  const double p = pen[r];
  return p > 0.0 ? __dadd_rn(c, p) : c;
}

// The host's EFT loop over a pool of rids: best = inf at the pool's first
// rid, then best <- loads[r] (+ C[t, r]) wherever strictly smaller, in pool
// order. `crow` is task t's cost row. Returns the value and the rid in
// every lane.
template <int R>
__device__ __forceinline__ double pool_min(const Lanes<R>& w, const double* crow,
                                           const double* pen, bool gpu_pool, bool with_cost,
                                           int lane, int& rid) {
  unsigned long long key = kNoKey;
  int place = INT_MAX;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int p = gpu_pool ? w.gplace[s] : w.cplace[s];
    if (p == INT_MAX) continue;
    const unsigned long long k =
        order_key(with_cost ? __dadd_rn(w.load[s], cost_at(crow, pen, lane + 32 * s))
                            : w.load[s]);
    if (k < key || (k == key && p < place)) {
      key = k;
      place = p;
    }
  }
  const double v = argmin_first(key, place);
  rid = place & 0xff;
  return v;
}

// Place task t on rid r at load v: the lane that holds r takes the load.
template <int R>
__device__ __forceinline__ void assign(Lanes<R>& w, int16_t* rid_of, int t, int r, double v,
                                       int lane) {
#pragma unroll
  for (int s = 0; s < R; ++s)
    if (lane + 32 * s == r) w.load[s] = v;
  if (lane == 0) rid_of[t] = static_cast<int16_t>(r);
}

// What every probe reads: the activation (shared memory where staged, else
// global) and the block's set-up.
struct Dada {
  int n, n_res, n_cpu, n_gpu;
  bool area_bound, have_both, no_cpus, no_gpus;
  double alpha, two_alpha, area, off_total, max_off;
  double n_alive;             // the resources the area bound counts
  const double* C;            // n x n_res, the scorer's output (or staged)
  const double* pen;          // n_res notice penalties still to add to C, or null
  const double* p_cpu;        // n
  const double* p_gpu;        // n
  const double* offsets;      // n_res
  const int64_t* flex_order;  // n
  const int* next;            // n: the next task of the same preferred resource
  const int* head;            // n_res: the first task that prefers the resource
};

// try_build(lam) of dada.py: whether the guess is feasible. When it is,
// rid_of (this warp's) and the lanes' loads hold the placement. Loads only
// grow, so the first overflow of (2 + alpha) lam decides, whichever lane
// sees it.
template <int R>
__device__ __forceinline__ bool try_build(const Dada& d, Lanes<R>& w, int16_t* rid_of, double lam,
                                          int lane) {
  const double cap = __dadd_rn(__dmul_rn(d.two_alpha, lam), kTiny);
  if (d.max_off > cap) return false;
  if (d.area_bound) {
    const double capacity = __dsub_rn(__dmul_rn(lam, d.n_alive), d.off_total);
    if (d.area > __dadd_rn(capacity, kTiny)) return false;
  }
  for (int i = lane; i < d.n; i += 32) rid_of[i] = -1;
  __syncwarp();

  // local affinity phase: each lane down the chains of its rids
  bool bad = false;
  const double budget = __dadd_rn(__dmul_rn(d.alpha, lam), kTiny);
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = lane + 32 * s;
    double l = r < d.n_res ? d.offsets[r] : 0.0;
    if (r < d.n_res) {
      for (int e = d.head[r]; e >= 0 && l <= budget; e = d.next[e]) {
        rid_of[e] = static_cast<int16_t>(r);
        const double v = __dadd_rn(l, cost_at(d.C + static_cast<int64_t>(e) * d.n_res, d.pen, r));
        if (v > cap) {
          bad = true;
          break;
        }
        l = v;
      }
    }
    w.load[s] = l;
  }
  if (__any_sync(kFull, bad)) return false;
  __syncwarp();

  // a task larger than lam on every class rejects the guess
  for (int base = 0; base < d.n; base += 32) {
    const int i = base + lane;
    if (i < d.n && rid_of[i] < 0 && (d.no_cpus || d.p_cpu[i] > lam) &&
        (d.no_gpus || d.p_gpu[i] > lam))
      bad = true;
  }
  if (__any_sync(kFull, bad)) return false;

  if (d.have_both) {
    // dedicated tasks, in ready order, to the earliest finish in their class
    for (int base = 0; base < d.n; base += 32) {
      __syncwarp();
      const int i = base + lane;
      const bool free_task = i < d.n && rid_of[i] < 0;
      const bool to_gpu = free_task && d.p_cpu[i] > lam;
      const bool to_cpu = free_task && !to_gpu && d.p_gpu[i] > lam;
      unsigned mask = __ballot_sync(kFull, to_gpu || to_cpu);
      const unsigned gmask = __ballot_sync(kFull, to_gpu);
      while (mask) {
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        const int t = base + k;
        const bool g = (gmask >> k) & 1u;
        int r;
        const double v =
            pool_min(w, d.C + static_cast<int64_t>(t) * d.n_res, d.pen, g, true, lane, r);
        if (v > cap) return false;
        assign(w, rid_of, t, r, v, lane);
      }
    }
    // flexible tasks, largest speedup first: to the least-loaded GPU while
    // it is within lam, else to the CPU of earliest finish
    const double gpu_budget = __dadd_rn(lam, kTiny);
    for (int base = 0; base < d.n; base += 32) {
      __syncwarp();
      const int k2 = base + lane;
      const int i = k2 < d.n ? static_cast<int>(d.flex_order[k2]) : 0;
      const bool flex = k2 < d.n && rid_of[i] < 0 && !(d.p_cpu[i] > lam) && !(d.p_gpu[i] > lam);
      unsigned mask = __ballot_sync(kFull, flex);
      while (mask) {
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        const int t = __shfl_sync(kFull, i, k);
        const double* crow = d.C + static_cast<int64_t>(t) * d.n_res;
        int r;
        const double gl = pool_min(w, crow, d.pen, true, false, lane, r);
        const double v = gl <= gpu_budget ? __dadd_rn(gl, cost_at(crow, d.pen, r))
                                          : pool_min(w, crow, d.pen, false, true, lane, r);
        if (v > cap) return false;
        assign(w, rid_of, t, r, v, lane);
      }
    }
  } else {
    // one class: every remaining task, in ready order, to the earliest finish
    const bool gpus = d.n_cpu == 0;
    for (int base = 0; base < d.n; base += 32) {
      __syncwarp();
      const int i = base + lane;
      unsigned mask = __ballot_sync(kFull, i < d.n && rid_of[i] < 0);
      while (mask) {
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        const int t = base + k;
        int r;
        const double v =
            pool_min(w, d.C + static_cast<int64_t>(t) * d.n_res, d.pen, gpus, true, lane, r);
        if (v > cap) return false;
        assign(w, rid_of, t, r, v, lane);
      }
    }
  }
  return true;
}

// A warp's feasible build as the placement: its rids and its loads.
template <int R>
__device__ __forceinline__ void write_placement(const Dada& d, const Lanes<R>& w,
                                                const int16_t* rid_of, int64_t* out, double* out_f,
                                                const Layout& L, int lane) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = lane + 32 * s;
    if (r < d.n_res) out_f[L.loads + r] = w.load[s];
  }
  for (int i = lane; i < d.n; i += 32) out[L.rids + i] = rid_of[i];
}

// The midpoint at heap node k (0-based; children 2k + 1, feasible, and
// 2k + 2) of a tree rooted at (lower, upper): the probe the bisection makes
// on reaching k, by the same operations (backend.py:800-810).
__device__ __forceinline__ double node_mid(int k, double lower, double upper) {
  const int p = k + 1, level = 31 - __clz(p);
  double lo = lower, hi = upper;
  for (int j = level - 1; j >= 0; --j) {
    const double m = __ddiv_rn(__dadd_rn(hi, lo), 2.0);
    if ((p >> j) & 1)
      lo = m;
    else
      hi = m;
  }
  return __ddiv_rn(__dadd_rn(hi, lo), 2.0);
}

template <int R, int MAXD>
__global__ void __launch_bounds__(32 * ((1 << MAXD) - 1))
dada_place_kernel(const int64_t* __restrict__ in, const double* __restrict__ scores,
                  int64_t* __restrict__ out, Layout L, int n, int n_res, int n_cpu, int n_gpu,
                  int flags, int stage) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const int depth = 31 - __clz(warps + 1);
  const double* in_f = reinterpret_cast<const double*>(in);
  double* out_f = reinterpret_cast<double*>(out);
  const bool want_x = flags & kWantX, live = flags & kLive;

  // the layout of dada_smem
  double* f = smem;
  double* worst_s = f++;
  double* offsets = f;
  f += n_res;
  double* pen = nullptr;
  if (live) {
    pen = f;
    f += n_res;
  }
  double* pref_score = f;
  f += n;
  Dada d;
  d.p_cpu = in_f + L.p_cpu;
  d.p_gpu = in_f + L.p_gpu;
  d.flex_order = in + L.flex_order;
  d.C = scores + L.c;
  const double* x_max = scores + L.x_max;
  const int64_t* tids = in + L.tids;
  if (stage >= 1) {
    double* p_cpu = f;
    double* p_gpu = p_cpu + n;
    double* xm = p_gpu + n;
    int64_t* ti = reinterpret_cast<int64_t*>(xm + n);
    int64_t* fo = ti + n;
    f += 5 * static_cast<int64_t>(n);
    stage_words(p_cpu, d.p_cpu, n, tid, threads);
    stage_words(p_gpu, d.p_gpu, n, tid, threads);
    if (want_x) stage_words(xm, x_max, n, tid, threads);
    stage_words(ti, tids, n, tid, threads);
    stage_words(fo, d.flex_order, n, tid, threads);
    d.p_cpu = p_cpu;
    d.p_gpu = p_gpu;
    x_max = xm;
    tids = ti;
    d.flex_order = fo;
  }
  if (stage >= 2) {
    stage_words(f, d.C, static_cast<int64_t>(n) * n_res, tid, threads);
    d.C = f;
    f += static_cast<int64_t>(n) * n_res;
  }
  stage_words(offsets, in_f + L.offsets, n_res, tid, threads);
  if (live) stage_words(pen, in_f + L.pen, n_res, tid, threads);
  int* next = reinterpret_cast<int*>(f);
  int* pref_rid = next + n;
  int* head = pref_rid + n;
  int* cpos = head + n_res;
  int* gpos = cpos + n_res;
  int* feas = gpos + n_res;  // 2 x 32: the verdicts of this round and the last
  int16_t* rid_of = reinterpret_cast<int16_t*>(feas + 64) + static_cast<int64_t>(warp) * n;

  d.n = n;
  d.n_res = n_res;
  d.n_cpu = n_cpu;
  d.n_gpu = n_gpu;
  d.area_bound = flags & kAreaBound;
  d.have_both = n_cpu > 0 && n_gpu > 0;
  d.no_cpus = n_cpu == 0;
  d.no_gpus = n_gpu == 0;
  d.alpha = in_f[L.alpha];
  d.two_alpha = in_f[L.two_alpha];
  d.area = in_f[L.area];
  d.off_total = in_f[L.off_total];
  d.max_off = in_f[L.max_off];
  d.n_alive = live ? in_f[L.n_alive] : static_cast<double>(n_res);
  // a live machine's penalties, added at every read of C
  d.pen = live ? pen : nullptr;
  d.offsets = offsets;
  d.next = next;
  d.head = head;

  // while the copies fly: clear the lists' positions and the chains, and
  // find each task's preferred resource (the rid-ascending scan from
  // best = 0 with the 1e-12 tolerance, one thread per task, S read once)
  for (int r = tid; r < n_res; r += threads) {
    head[r] = -1;
    cpos[r] = gpos[r] = INT_MAX;
  }
  const bool prefs = (flags & kWantS) && d.alpha > 0.0;
  const double* S = scores + L.s;
  const int64_t* skip = in + L.skip;
  for (int i = tid; i < n; i += threads) {
    next[i] = -1;
    if (!prefs) continue;
    const double* srow = S + static_cast<int64_t>(i) * n_res;
    double best = 0.0;
    int br = -1;
    for (int r = 0; r < n_res; ++r) {
      if (live && skip[r]) continue;  // affinity to a dead or condemned memory
      const double sc = srow[r];
      if (sc > __dadd_rn(best, kTiny)) {
        best = sc;
        br = r;
      }
    }
    pref_score[i] = best;
    pref_rid[i] = br;
  }
  cp_async_wait_all();
  __syncthreads();

  for (int k = tid; k < n_cpu; k += threads) cpos[in[L.cpu_rids + k]] = k;
  for (int k = tid; k < n_gpu; k += threads) gpos[in[L.gpu_rids + k]] = k;
  if (prefs) {
    // the preferences of one resource in (-score, tid) order, as a chain:
    // its head and each task's successor (tids are unique, so the order is
    // total); one thread per task, over all tasks
    for (int i = tid; i < n; i += threads) {
      const int r = pref_rid[i];
      if (r < 0) continue;
      const double si = pref_score[i];
      const int64_t ti = tids[i];
      int succ = -1;
      double s_succ = 0.0;
      int64_t t_succ = 0;
      bool first = true;
      for (int q = 0; q < n; ++q) {
        if (q == i || pref_rid[q] != r) continue;
        const double sq = pref_score[q];
        const int64_t tq = tids[q];
        if (sq > si || (sq == si && tq < ti)) {
          first = false;
        } else if (succ < 0 || sq > s_succ || (sq == s_succ && tq < t_succ)) {
          succ = q;
          s_succ = sq;
          t_succ = tq;
        }
      }
      next[i] = succ;
      if (first) head[r] = i;
    }
  }
  // the bisection's upper bound: ((sum max(p) + max_off) + worst transfer) +
  // 1e-12, the worst transfer an in-order sum of the row maxima from +0.0,
  // by the block's last thread
  if (tid == threads - 1) {
    double worst = 0.0;
    if (want_x)
      for (int i = 0; i < n; ++i) worst = __dadd_rn(worst, x_max[i]);
    *worst_s = worst;
  }
  __syncthreads();

  Lanes<R> w;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = lane + 32 * s;
    w.cplace[s] = r < n_res && cpos[r] != INT_MAX ? (cpos[r] << 8) | r : INT_MAX;
    w.gplace[s] = r < n_res && gpos[r] != INT_MAX ? (gpos[r] << 8) | r : INT_MAX;
  }
  double upper0 = __dadd_rn(__dadd_rn(__dadd_rn(in_f[L.sum_max], d.max_off), *worst_s), kTiny);
  if (live) upper0 = __dadd_rn(upper0, in_f[L.pen_top]);  // + n * max(pen): 0.0 without
  const double eps_rel = in_f[L.eps_rel];
  const int64_t max_iters = in[L.max_iters];

  // the rounds: each warp probes its node of the tree, then every warp
  // walks the verdicts as the serial loop would
  const int level = 31 - __clz(warp + 1);
  double lower = 0.0, upper = upper0;
  int64_t it = 0;
  bool kept_any = false;
  for (int round = 0; __dsub_rn(upper, lower) > __dmul_rn(eps_rel, upper) && it < max_iters;
       ++round) {
    int* verdict = feas + 32 * (round & 1);
    bool ok = false;
    if (level < max_iters - it)  // a node the walk can reach
      ok = try_build(d, w, rid_of, node_mid(warp, lower, upper), lane);
    if (lane == 0) verdict[warp] = ok;
    __syncthreads();
    int idx = 0, kept = -1;
    for (int lev = 0; lev < depth; ++lev) {
      if (!(__dsub_rn(upper, lower) > __dmul_rn(eps_rel, upper) && it < max_iters)) break;
      const double lam = __ddiv_rn(__dadd_rn(upper, lower), 2.0);
      const bool feasible = verdict[idx];
      if (feasible) {
        upper = lam;
        kept = idx;
      } else {
        lower = lam;
      }
      ++it;
      idx = 2 * idx + (feasible ? 1 : 2);
    }
    if (kept >= 0) kept_any = true;
    // the last feasible probe's placement, before this warp builds again
    if (warp == kept) write_placement(d, w, rid_of, out, out_f, L, lane);
  }
  if (warp != 0) return;
  bool ok = kept_any;
  if (!kept_any) {  // no probe was feasible: build at the upper bound
    ok = try_build(d, w, rid_of, upper, lane);
    __syncwarp();
    if (ok) {
      write_placement(d, w, rid_of, out, out_f, L, lane);
    } else {
      for (int r = lane; r < n_res; r += 32) out_f[L.loads + r] = 0.0;
      for (int i = lane; i < n; i += 32) out[L.rids + i] = -1;
    }
  }
  if (lane == 0) {
    out[L.status] = ok ? 0 : 1;
    out[L.iters] = it;
    out_f[L.lam] = upper;
  }
}

// ---- HEFT ------------------------------------------------------------------------

// The 1e-15 left fold over the candidates e (lane l holds rids l, l + 32,
// ...): best = inf, then (e_r, r) wherever e_r < best - 1e-15, in rid order.
//
// Fast path. Let vm be the least candidate and m the least rid holding it.
// If vm != 0 and every candidate e != vm has vm < fl(e - 1e-15), the fold
// returns (vm, m). Proof: every rid r < m holds e_r != vm (m is the first),
// so the fold's best before m is inf or such an e_r, and fl(best - 1e-15) >
// vm (inf - 1e-15 = inf): m is taken. After m, a candidate equal to vm is
// not below fl(vm - 1e-15) <= vm, and any other e has e >= fl(e - 1e-15) >
// vm >= fl(vm - 1e-15): nothing replaces m. (vm != 0 keeps -0.0 and +0.0,
// equal as doubles but not as keys, out of the fast path; NaN never
// occurs.) The condition is one vote, beside the reduction that finds m.
// Otherwise the fold runs serially over the candidates, shuffled from their
// lanes in rid order.
//
// Detached resources. Their X columns arrive as +inf through the scorer's
// x_bias (pressure_rows_for's mask), so their candidates are (start + inf) +
// d = +inf; no other input is infinite, so no NaN (inf - inf, 0 * inf)
// arises. The proof holds with them: order_key(+inf) = 0xfff0000000000000
// is below kNoKey, so a lane of dead rids only still reduces to a real key;
// while one resource is alive, vm is finite and m is alive; an e = +inf is
// != vm with fl(inf - 1e-15) = inf > vm, so it votes no margin and never
// replaces m. In the serial fold a dead rid 0 is not taken either: +inf <
// fl(inf - 1e-15) = inf is false, as in the host loop. With every candidate
// +inf (no alive resource: the engine never detaches the last worker) both
// paths return (inf, 0), as the host loop does.
template <int RH>
__device__ __forceinline__ double heft_fold(const double (&e)[RH], int n_res, int lane, int& bj) {
  unsigned long long key = kNoKey;
  int pos = INT_MAX;
#pragma unroll
  for (int s = 0; s < RH; ++s) {
    const unsigned long long k = lane + 32 * s < n_res ? order_key(e[s]) : kNoKey;
    if (k < key) {  // strict: the lane's first rid at its least value
      key = k;
      pos = lane + 32 * s;
    }
  }
  const double vm = argmin_first(key, pos);
  bool near = false;  // a candidate within the margin above vm
#pragma unroll
  for (int s = 0; s < RH; ++s)
    if (lane + 32 * s < n_res && e[s] != vm && !(vm < __dsub_rn(e[s], kHeftTie))) near = true;
  if (vm != 0.0 && !__any_sync(kFull, near)) {
    bj = pos;
    return vm;
  }
  double bv = INFINITY;
  bj = 0;
#pragma unroll
  for (int s = 0; s < RH; ++s) {
    for (int l = 0; l < 32; ++l) {
      const int r = 32 * s + l;
      if (r >= n_res) break;
      const double v = __shfl_sync(kFull, e[s], l);
      if (v < __dsub_rn(bv, kHeftTie)) {
        bv = v;
        bj = r;
      }
    }
  }
  return bv;
}

template <int RH>
__global__ void __launch_bounds__(kHeftThreads)
heft_select_kernel(const int64_t* __restrict__ in, const double* __restrict__ scores,
                   int64_t* __restrict__ out, Layout L, int n, int n_res, int n_cls, int group,
                   int nbuf) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kHeftThreads / 32;
  const double* in_f = reinterpret_cast<const double*>(in);
  double* out_f = reinterpret_cast<double*>(out);
  const double* X = scores + L.x;
  const double* D = in_f + L.durations;
  const int64_t* order = in + L.order;
  const bool one_pass = nbuf == 1;
  // each lane's resources' classes; a duration is dptr[dsel[s]] for the task
  // at hand: one pass, dptr = Ds + i and dsel = cls * n; ring, dptr = the
  // task's staged duration row and dsel = r
  int cls[RH], dsel[RH];
#pragma unroll
  for (int s = 0; s < RH; ++s) {
    const int r = lane + 32 * s;
    cls[s] = r < n_res ? static_cast<int>(in[L.cls_of_res + r]) : 0;
    dsel[s] = one_pass ? cls[s] * n : r;
  }
  // one pass: X, the class durations and the order as they lie
  double* Xs = smem;
  double* Ds = Xs + static_cast<int64_t>(n) * n_res;
  int64_t* order_s = reinterpret_cast<int64_t*>(Ds + static_cast<int64_t>(n_cls) * n);
  // ring: nbuf buffers of `group` tasks' X rows, then as many duration rows
  const int64_t buf_words = static_cast<int64_t>(group) * n_res;
  double* xs = smem;
  double* ds = smem + nbuf * buf_words;
  const int n_groups = (n + group - 1) / group;

  // copy group g into buffer b, by warps first..kWarps-1: the group's order
  // in one load a lane, then each warp's tasks' rows, lanes across resources
  auto stage_group = [&](int g, int b, int first) {
    const int base = g * group, m = min(group, n - base);
    const int64_t my_i = lane < m ? order[base + lane] : 0;
    for (int k = warp - first; k < m; k += kWarps - first) {
      const int64_t i = __shfl_sync(kFull, my_i, k);
      const double* xsrc = X + i * n_res;
      double* xd = xs + b * buf_words + static_cast<int64_t>(k) * n_res;
      double* dd = ds + b * buf_words + static_cast<int64_t>(k) * n_res;
#pragma unroll
      for (int s = 0; s < RH; ++s) {
        const int r = lane + 32 * s;
        if (r < n_res) {
          cp_async_8(xd + r, xsrc + r);
          cp_async_8(dd + r, D + static_cast<int64_t>(cls[s]) * n + i);
        }
      }
    }
  };
  if (one_pass) {
    stage_words(Xs, X, static_cast<int64_t>(n) * n_res, tid, kHeftThreads);
    stage_words(Ds, D, static_cast<int64_t>(n_cls) * n, tid, kHeftThreads);
    stage_words(order_s, order, n, tid, kHeftThreads);
  } else {
    stage_group(0, 0, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  // warp 0's scan state: the time stamps of each lane's resources, and the
  // result of task base32 + lane until the 32 are written together
  const double now = in_f[L.now];
  double lts[RH];
#pragma unroll
  for (int s = 0; s < RH; ++s) {
    const int r = lane + 32 * s;
    lts[s] = r < n_res ? in_f[L.load_ts + r] : 0.0;
  }
  int my_rid = 0;
  double my_eft = 0.0;
  for (int g = 0; g < n_groups; ++g) {
    if (warp != 0) {
      if (g + 1 < n_groups) {  // the next group, while warp 0 scans this one
        stage_group(g + 1, (g + 1) & 1, 1);
        cp_async_wait_all();
      }
    } else {
      const int base = g * group, m = min(group, n - base);
      // task kk's transfers and durations at each lane's resources
      double xv[RH], dv[RH];
      auto fetch = [&](int kk) {
        const double* xrow;
        const double* dptr;
        if (one_pass) {
          const int64_t i = order_s[kk];
          xrow = Xs + i * n_res;
          dptr = Ds + i;
        } else {
          const int64_t slot = ((g & 1) * static_cast<int64_t>(group) + kk) * n_res;
          xrow = xs + slot;
          dptr = ds + slot;
        }
#pragma unroll
        for (int s = 0; s < RH; ++s) {
          const int r = lane + 32 * s;
          xv[s] = r < n_res ? xrow[r] : 0.0;
          dv[s] = r < n_res ? dptr[dsel[s]] : 0.0;
        }
      };
      fetch(0);
      for (int kk = 0; kk < m; ++kk) {
        double e[RH];
#pragma unroll
        for (int s = 0; s < RH; ++s) {
          const double lt = lts[s];
          const double start = now > lt ? now : lt;
          e[s] = __dadd_rn(__dadd_rn(start, xv[s]), dv[s]);
        }
        if (kk + 1 < m) fetch(kk + 1);  // the next task's rows, read during the fold
        int bj;
        const double bv = heft_fold(e, n_res, lane, bj);
#pragma unroll
        for (int s = 0; s < RH; ++s)
          if (lane + 32 * s == bj) lts[s] = bv;
        const int k = base + kk;
        if ((k & 31) == lane) {
          my_rid = bj;
          my_eft = bv;
        }
        if ((k & 31) == 31 || k == n - 1) {  // 32 results out together
          const int first = k & ~31;
          if (first + lane <= k) {
            out[L.rids + first + lane] = my_rid;
            out_f[L.efts + first + lane] = my_eft;
          }
        }
      }
    }
    if (g + 1 < n_groups) __syncthreads();
  }
}

// Above 48 KB a kernel's dynamic shared memory needs an opt-in, set once.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (bytes <= 48 * 1024 || done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  done = err == cudaSuccess;
  return err;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches one block on
// `stream` (DADA: 32 (2^d - 1) threads; HEFT: 256), does not synchronize,
// and returns cudaGetLastError() of the launch (0 = success). `layout` is a
// host array of the 34 slot offsets of struct Layout. A placement beyond the
// kernel (dada_plan / heft_plan) is refused (cudaErrorInvalidValue); the
// wrapper checks the same bound first.
extern "C" int repro_dada_place(const void* in, const void* scores, void* out,
                                const int64_t* layout, int n, int n_res, int n_cpu, int n_gpu,
                                int flags, int device, void* stream) {
  static bool smem_set[4] = {false, false, false, false};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DadaPlan plan = dada_plan(n, n_res, n_cpu, n_gpu, (flags & kLive) != 0);
  if (plan.depth == 0) return static_cast<int>(cudaErrorInvalidValue);
  Layout L;
  std::memcpy(&L, layout, sizeof(L));
  const int which = slot_class(n_res);
  void (*kernel)(const int64_t*, const double*, int64_t*, Layout, int, int, int, int, int, int) =
      which == 0   ? dada_place_kernel<1, kDadaMaxDepth[0]>
      : which == 1 ? dada_place_kernel<2, kDadaMaxDepth[1]>
      : which == 2 ? dada_place_kernel<4, kDadaMaxDepth[2]>
                   : dada_place_kernel<8, kDadaMaxDepth[3]>;
  err = allow_smem(kernel, plan.smem, smem_set[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, 32 * ((1 << plan.depth) - 1), plan.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<const double*>(scores),
      static_cast<int64_t*>(out), L, n, n_res, n_cpu, n_gpu, flags, plan.stage);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_heft_select(const void* in, const void* scores, void* out,
                                 const int64_t* layout, int n, int n_res, int device,
                                 void* stream) {
  static bool smem_set[5] = {false, false, false, false, false};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  Layout L;
  std::memcpy(&L, layout, sizeof(L));
  // the durations section is n_cls rows of n, right before cls_of_res
  const int n_cls = static_cast<int>((L.cls_of_res - L.durations) / n);
  const HeftPlan plan = heft_plan(n, n_res, n_cls);
  if (plan.group == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int which = slot_class(n_res);
  void (*kernel)(const int64_t*, const double*, int64_t*, Layout, int, int, int, int, int) =
      which == 0   ? heft_select_kernel<1>
      : which == 1 ? heft_select_kernel<2>
      : which == 2 ? heft_select_kernel<4>
      : which == 3 ? heft_select_kernel<8>
                   : heft_select_kernel<16>;
  err = allow_smem(kernel, plan.smem, smem_set[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kHeftThreads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<const double*>(scores),
      static_cast<int64_t*>(out), L, n, n_res, n_cls, plan.group, plan.nbuf);
  return static_cast<int>(cudaGetLastError());
}

// The launchers' plan for a placement (kind 0: DADA, 1: HEFT; n_cpu, n_gpu and
// live are DADA's, n_cls HEFT's), for checking sched_place.py's mirror of it:
// plan[0] the tree depth (DADA) or the tasks a buffer (HEFT), plan[1] the
// staging level or the buffers, plan[2] the shared memory, plan[3] the
// threads. Returns 0, or cudaErrorInvalidValue beyond the kernel.
extern "C" int repro_place_plan(int kind, int n, int n_res, int n_cpu, int n_gpu, int n_cls,
                                int live, int64_t* plan) {
  if (kind == 0) {
    const DadaPlan p = dada_plan(n, n_res, n_cpu, n_gpu, live != 0);
    if (p.depth == 0) return static_cast<int>(cudaErrorInvalidValue);
    plan[0] = p.depth;
    plan[1] = p.stage;
    plan[2] = static_cast<int64_t>(p.smem);
    plan[3] = 32 * ((1 << p.depth) - 1);
    return 0;
  }
  const HeftPlan p = heft_plan(n, n_res, n_cls);
  if (p.group == 0) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.group;
  plan[1] = p.nbuf;
  plan[2] = static_cast<int64_t>(p.smem);
  plan[3] = kHeftThreads;
  return 0;
}
