// Placement of one scheduling activation on the card, for Hopper (sm_90a).
//
// Two kernels run right after score_activation (sched_score.cu), on the same
// stream, and read its output buffer where it lies:
//
// * dada_place_kernel replaces DADA's lambda search, the jitted
//   _build_search_fn of repro/core/backend.py:633 (dada_lambda_search :522:
//   the probe verdict :655-786 and the bisection :790-835), together with the
//   host try_build that rebuilds the placement at the settled lambda
//   (repro/core/dada.py:452-490). From the cost matrix C, the affinity
//   matrix S and the row maxima of X it computes each task's preferred
//   resource, the (-score, tid) order of the preferences, the worst-case
//   transfer sum, the upper bound, the bisection on lambda (one probe at a
//   time) and one final build at the settled upper bound, and writes the rid
//   of every task, the loads, lambda and a status word (1: lambda = upper
//   was infeasible).
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
// holding it. The two folds that are not associative stay sequential over
// the resources in rid order: the preference scan with its 1e-12 tolerance
// (one lane per task) and HEFT's e < best - 1e-15 fold (lane 0, after the
// lanes computed the candidates). The affinity phase runs one lane per
// resource down that resource's chain of preferences, as the reference's
// per-resource chains do (backend.py:579-605).
//
// What bounds it on an H100. An activation of the main path reads a few KB
// (C, S and the row maxima of at most 128 x 14 entries) and writes less: the
// byte and operation bounds are nanoseconds. The work is a chain of
// dependent steps: every probe places the tasks one after another, and each
// step's argmin needs the loads the previous step left. So one warp does it
// all (one block, no block-wide barrier), with the resources across the
// lanes and their loads in registers (up to 8 rids a lane, so at most 256
// resources), the per-task state in shared memory, and each step one warp
// reduction: the time is the probes times the tasks times that reduction.
// HEFT's scan stages 32 tasks' rows in shared memory at a time, so its
// steps wait on shared memory only. Speculating several probes at once (the
// reference's midpoint tree) is left for later.
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

// flags of a DADA placement (sched_place.py's PLACE_*)
constexpr int kWantS = 1, kWantX = 2, kAreaBound = 4;

// Slot offsets, in the order of sched_place.py's SCORE_REFS + PLACE_IN_SECTIONS
// + PLACE_OUT_SECTIONS: p_cpu and p_gpu in the input buffer; c, x, x_max and s
// in the scorer's output buffer; the placement section in the input buffer;
// the placement outputs in their own buffer.
struct Layout {
  int64_t p_cpu, p_gpu;
  int64_t c, x, x_max, s;
  int64_t offsets, flex_order, tids, max_off, sum_max, area, off_total, alpha, two_alpha,
      eps_rel, max_iters, cpu_rids, gpu_rids, order, durations, cls_of_res, load_ts, now;
  int64_t status, iters, lam, loads, rids, efts;
};

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

// The warp's first minimum. Each lane holds its own least (key, pos), pos =
// INT_MAX where it holds none; every lane returns the least value and the
// least pos holding it, in three warp reductions (the key's high word, its
// low word among the lanes at that high word, then pos among the lanes at
// that key).
__device__ __forceinline__ double argmin_first(unsigned long long key, int& pos) {
  const unsigned hi = static_cast<unsigned>(key >> 32), lo = static_cast<unsigned>(key);
  const unsigned min_hi = __reduce_min_sync(kFull, hi);
  const unsigned min_lo = __reduce_min_sync(kFull, hi == min_hi ? lo : 0xffffffffu);
  pos = __reduce_min_sync(kFull, (hi == min_hi && lo == min_lo) ? pos : INT_MAX);
  return from_key((static_cast<unsigned long long>(min_hi) << 32) | min_lo);
}

// The loads live in registers: lane l holds the loads of rids l, l + 32, ...
// (R of them), with each rid's position in the CPU and in the GPU list.
template <int R>
struct Lanes {
  double load[R];
  double cost[R];  // the current task's C at each of the lane's rids
  int cpos[R], gpos[R];  // position in the CPU / GPU list; INT_MAX: not in it
};

// The host's EFT loop over a pool of rids: best = inf at the pool's first
// rid, then best <- loads[r] (+ C[t, r]) wherever strictly smaller, in pool
// order. Returns the value and the pool position in every lane.
template <int R>
__device__ __forceinline__ double pool_min(const Lanes<R>& w, bool gpu_pool, bool with_cost,
                                           int& pos) {
  unsigned long long key = kNoKey;
  pos = INT_MAX;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int p = gpu_pool ? w.gpos[s] : w.cpos[s];
    if (p == INT_MAX) continue;
    const unsigned long long k =
        order_key(with_cost ? __dadd_rn(w.load[s], w.cost[s]) : w.load[s]);
    if (k < key || (k == key && p < pos)) {
      key = k;
      pos = p;
    }
  }
  return argmin_first(key, pos);
}

// Load task t's cost row into the lanes' registers.
template <int R>
__device__ __forceinline__ void load_costs(Lanes<R>& w, const double* C, int t, int n_res,
                                           int lane) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = lane + 32 * s;
    w.cost[s] = r < n_res ? C[static_cast<int64_t>(t) * n_res + r] : 0.0;
  }
}

// Place task t on rid r at load v: the lane that holds r takes the load.
template <int R>
__device__ __forceinline__ void assign(Lanes<R>& w, int* rid_of, int t, int r, double v,
                                       int lane) {
#pragma unroll
  for (int s = 0; s < R; ++s)
    if (lane + 32 * s == r) w.load[s] = v;
  if (lane == 0) rid_of[t] = r;
}

// What every probe reads: the activation's inputs and the warp's shared state.
struct Dada {
  int n, n_res, n_cpu, n_gpu;
  bool area_bound, have_both, no_cpus, no_gpus;
  double alpha, two_alpha, area, off_total, max_off;
  const double* C;       // n x n_res, the scorer's output
  const double* p_cpu;   // n
  const double* p_gpu;   // n
  const double* offsets;  // n_res
  const int64_t* flex_order;  // n
  // shared memory
  double* pref_cost;  // n: C at the preferred resource
  int* rid_of;        // n: -1 while unplaced
  int* next;          // n: the next task of the same preferred resource
  int* head;          // n_res: the first task that prefers the resource
  const int* cpu;     // n_cpu rids
  const int* gpu;     // n_gpu rids
};

// try_build(lam) of dada.py: whether the guess is feasible. When it is,
// rid_of and the lanes' loads hold the placement. Loads only grow, so the
// first overflow of (2 + alpha) lam decides, whichever lane sees it.
template <int R>
__device__ __forceinline__ bool try_build(const Dada& d, Lanes<R>& w, double lam, int lane) {
  const double cap = __dadd_rn(__dmul_rn(d.two_alpha, lam), kTiny);
  if (d.max_off > cap) return false;
  if (d.area_bound) {
    const double capacity = __dsub_rn(__dmul_rn(lam, static_cast<double>(d.n_res)), d.off_total);
    if (d.area > __dadd_rn(capacity, kTiny)) return false;
  }
  for (int i = lane; i < d.n; i += 32) d.rid_of[i] = -1;
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
        d.rid_of[e] = r;
        const double v = __dadd_rn(l, d.pref_cost[e]);
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
    if (i < d.n && d.rid_of[i] < 0 && (d.no_cpus || d.p_cpu[i] > lam) &&
        (d.no_gpus || d.p_gpu[i] > lam))
      bad = true;
  }
  if (__any_sync(kFull, bad)) return false;

  if (d.have_both) {
    // dedicated tasks, in ready order, to the earliest finish in their class
    for (int base = 0; base < d.n; base += 32) {
      __syncwarp();
      const int i = base + lane;
      const bool free_task = i < d.n && d.rid_of[i] < 0;
      const bool to_gpu = free_task && d.p_cpu[i] > lam;
      const bool to_cpu = free_task && !to_gpu && d.p_gpu[i] > lam;
      unsigned mask = __ballot_sync(kFull, to_gpu || to_cpu);
      const unsigned gmask = __ballot_sync(kFull, to_gpu);
      while (mask) {
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        const int t = base + k;
        const bool g = (gmask >> k) & 1u;
        load_costs(w, d.C, t, d.n_res, lane);
        int pos;
        const double v = pool_min(w, g, true, pos);
        if (v > cap) return false;
        assign(w, d.rid_of, t, g ? d.gpu[pos] : d.cpu[pos], v, lane);
      }
    }
    // flexible tasks, largest speedup first: to the least-loaded GPU while
    // it is within lam, else to the CPU of earliest finish
    const double gpu_budget = __dadd_rn(lam, kTiny);
    for (int base = 0; base < d.n; base += 32) {
      __syncwarp();
      const int k2 = base + lane;
      const int i = k2 < d.n ? static_cast<int>(d.flex_order[k2]) : 0;
      const bool flex = k2 < d.n && d.rid_of[i] < 0 && !(d.p_cpu[i] > lam) && !(d.p_gpu[i] > lam);
      unsigned mask = __ballot_sync(kFull, flex);
      while (mask) {
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        const int t = __shfl_sync(kFull, i, k);
        load_costs(w, d.C, t, d.n_res, lane);
        int pos;
        const double gl = pool_min(w, true, false, pos);
        int r;
        double v;
        if (gl <= gpu_budget) {
          r = d.gpu[pos];
          double c = 0.0;
#pragma unroll
          for (int s = 0; s < R; ++s)
            if ((r >> 5) == s) c = w.cost[s];
          v = __dadd_rn(gl, __shfl_sync(kFull, c, r & 31));
        } else {
          v = pool_min(w, false, true, pos);
          r = d.cpu[pos];
        }
        if (v > cap) return false;
        assign(w, d.rid_of, t, r, v, lane);
      }
    }
  } else {
    // one class: every remaining task, in ready order, to the earliest finish
    const bool gpus = d.n_cpu == 0;
    for (int base = 0; base < d.n; base += 32) {
      __syncwarp();
      const int i = base + lane;
      unsigned mask = __ballot_sync(kFull, i < d.n && d.rid_of[i] < 0);
      while (mask) {
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        const int t = base + k;
        load_costs(w, d.C, t, d.n_res, lane);
        int pos;
        const double v = pool_min(w, gpus, true, pos);
        if (v > cap) return false;
        assign(w, d.rid_of, t, gpus ? d.gpu[pos] : d.cpu[pos], v, lane);
      }
    }
  }
  return true;
}

template <int R>
__global__ void __launch_bounds__(32)
dada_place_kernel(const int64_t* __restrict__ in, const double* __restrict__ scores,
                  int64_t* __restrict__ out, Layout L, int n, int n_res, int n_cpu, int n_gpu,
                  int flags) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x;
  const double* in_f = reinterpret_cast<const double*>(in);
  double* out_f = reinterpret_cast<double*>(out);

  Dada d;
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
  d.C = scores + L.c;
  d.p_cpu = in_f + L.p_cpu;
  d.p_gpu = in_f + L.p_gpu;
  d.offsets = in_f + L.offsets;
  d.flex_order = in + L.flex_order;
  double* pref_score = smem;          // n
  d.pref_cost = pref_score + n;       // n
  int* ints = reinterpret_cast<int*>(d.pref_cost + n);
  d.rid_of = ints;                    // n
  int* pref_rid = ints + n;           // n
  d.next = pref_rid + n;              // n
  d.head = d.next + n;                // n_res
  int* cpu = d.head + n_res;          // n_cpu
  int* gpu = cpu + n_cpu;             // n_gpu
  int* cpos = gpu + n_gpu;            // n_res: each rid's position in the CPU list
  int* gpos = cpos + n_res;           // n_res: and in the GPU list
  d.cpu = cpu;
  d.gpu = gpu;
  for (int r = lane; r < n_res; r += 32) {
    d.head[r] = -1;
    cpos[r] = gpos[r] = INT_MAX;
  }
  __syncwarp();
  for (int k = lane; k < n_cpu; k += 32) {
    cpu[k] = static_cast<int>(in[L.cpu_rids + k]);
    cpos[cpu[k]] = k;
  }
  for (int k = lane; k < n_gpu; k += 32) {
    gpu[k] = static_cast<int>(in[L.gpu_rids + k]);
    gpos[gpu[k]] = k;
  }
  __syncwarp();
  Lanes<R> w;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = lane + 32 * s;
    w.cpos[s] = r < n_res ? cpos[r] : INT_MAX;
    w.gpos[s] = r < n_res ? gpos[r] : INT_MAX;
  }

  // each task's preferred resource: the rid-ascending scan from best = 0
  // with the 1e-12 tolerance, one lane per task
  const bool prefs = (flags & kWantS) && d.alpha > 0.0;
  if (prefs) {
    const double* S = scores + L.s;
    for (int i = lane; i < n; i += 32) {
      const double* srow = S + static_cast<int64_t>(i) * n_res;
      double best = 0.0;
      int br = -1;
      for (int r = 0; r < n_res; ++r) {
        const double sc = srow[r];
        if (sc > __dadd_rn(best, kTiny)) {
          best = sc;
          br = r;
        }
      }
      pref_score[i] = best;
      pref_rid[i] = br;
      d.pref_cost[i] = br >= 0 ? d.C[static_cast<int64_t>(i) * n_res + br] : 0.0;
      d.next[i] = -1;
    }
  }
  __syncwarp();
  if (prefs) {
    // the preferences of one resource in (-score, tid) order, as a chain:
    // its head and each task's successor (tids are unique, so the order is
    // total)
    const int64_t* tids = in + L.tids;
    for (int i = lane; i < n; i += 32) {
      const int r = pref_rid[i];
      if (r < 0) continue;
      const double si = pref_score[i];
      const int64_t ti = tids[i];
      int succ = -1;
      bool first = true;
      for (int q = 0; q < n; ++q) {
        if (q == i || pref_rid[q] != r) continue;
        const double sq = pref_score[q];
        const int64_t tq = tids[q];
        if (sq > si || (sq == si && tq < ti)) {
          first = false;
        } else if (succ < 0 || sq > pref_score[succ] ||
                   (sq == pref_score[succ] && tq < tids[succ])) {
          succ = q;
        }
      }
      d.next[i] = succ;
      if (first) d.head[r] = i;
    }
  }
  __syncwarp();

  // the bisection's upper bound: ((sum max(p) + max_off) + worst transfer) + 1e-12,
  // the worst transfer an in-order sum of the row maxima from +0.0
  double worst = 0.0;
  if (flags & kWantX) {
    const double* x_max = scores + L.x_max;
    for (int i = 0; i < n; ++i) worst = __dadd_rn(worst, x_max[i]);
  }
  const double upper0 =
      __dadd_rn(__dadd_rn(__dadd_rn(in_f[L.sum_max], d.max_off), worst), kTiny);
  const double eps_rel = in_f[L.eps_rel];
  const int64_t max_iters = in[L.max_iters];
  double lower = 0.0, upper = upper0;
  int64_t it = 0;
  while (__dsub_rn(upper, lower) > __dmul_rn(eps_rel, upper) && it < max_iters) {
    const double lam = __ddiv_rn(__dadd_rn(upper, lower), 2.0);
    if (try_build(d, w, lam, lane))
      upper = lam;
    else
      lower = lam;
    ++it;
  }
  const bool ok = try_build(d, w, upper, lane);
  __syncwarp();
  if (lane == 0) {
    out[L.status] = ok ? 0 : 1;
    out[L.iters] = it;
    out_f[L.lam] = upper;
  }
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = lane + 32 * s;
    if (r < n_res) out_f[L.loads + r] = ok ? w.load[s] : 0.0;
  }
  for (int i = lane; i < n; i += 32) out[L.rids + i] = ok ? d.rid_of[i] : -1;
}

__global__ void __launch_bounds__(32)
heft_select_kernel(const int64_t* __restrict__ in, const double* __restrict__ scores,
                   int64_t* __restrict__ out, Layout L, int n, int n_res) {
  extern __shared__ double smem[];
  double* lts = smem;                 // n_res: the load time stamps as the scan moves them
  double* eft = lts + n_res;          // n_res: the current task's candidates
  double* xs = eft + n_res;           // 32 x n_res: transfers of the staged tasks
  double* ds = xs + 32 * n_res;       // 32 x n_res: their durations on each resource
  const int lane = threadIdx.x;
  const double* in_f = reinterpret_cast<const double*>(in);
  double* out_f = reinterpret_cast<double*>(out);
  const double now = in_f[L.now];
  const double* X = scores + L.x;
  const double* D = in_f + L.durations;
  const int64_t* cls = in + L.cls_of_res;
  const int64_t* order = in + L.order;
  for (int r = lane; r < n_res; r += 32) lts[r] = in_f[L.load_ts + r];
  for (int base = 0; base < n; base += 32) {
    // the next 32 tasks' rows, loaded together: the scan below then waits
    // on shared memory only
    const int m = min(32, n - base);
    __syncwarp();
    for (int e = lane; e < m * n_res; e += 32) {
      const int k = e / n_res, r = e - k * n_res;
      const int64_t i = order[base + k];
      xs[e] = X[i * n_res + r];
      ds[e] = D[cls[r] * n + i];
    }
    __syncwarp();
    for (int k = 0; k < m; ++k) {
      for (int r = lane; r < n_res; r += 32) {
        const double lt = lts[r];
        const double start = now > lt ? now : lt;
        eft[r] = __dadd_rn(__dadd_rn(start, xs[k * n_res + r]), ds[k * n_res + r]);
      }
      __syncwarp();
      if (lane == 0) {  // the left fold, in rid order
        double bv = INFINITY;
        int bj = 0;
        for (int r = 0; r < n_res; ++r) {
          const double e = eft[r];
          if (e < __dsub_rn(bv, kHeftTie)) {
            bv = e;
            bj = r;
          }
        }
        lts[bj] = bv;
        out[L.rids + base + k] = bj;
        out_f[L.efts + base + k] = bv;
      }
      __syncwarp();
    }
  }
}

size_t dada_smem(int n, int n_res, int n_cpu, int n_gpu) {
  return 16 * static_cast<size_t>(n) +
         4 * (3 * static_cast<size_t>(n) + 3 * static_cast<size_t>(n_res) + n_cpu + n_gpu);
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

// Plain C entry points (loaded with ctypes). Each launches one block of one
// warp on `stream`, does not synchronize, and returns cudaGetLastError() of
// the launch (0 = success). `layout` is a host array of the 30 slot offsets
// of struct Layout. Shared memory beyond the card's opt-in limit is refused
// (cudaErrorInvalidValue); the wrapper checks the same bound first.
extern "C" int repro_dada_place(const void* in, const void* scores, void* out,
                                const int64_t* layout, int n, int n_res, int n_cpu, int n_gpu,
                                int flags, int device, void* stream) {
  static bool smem_set[4] = {false, false, false, false};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = dada_smem(n, n_res, n_cpu, n_gpu);
  if (n < 1 || n_res < 1 || n_res > 32 * kMaxSlots || n_cpu + n_gpu < 1 || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout L;
  std::memcpy(&L, layout, sizeof(L));
  const int slots = (n_res + 31) / 32;  // rids per lane, rounded up to a power of two
  const int which = slots <= 1 ? 0 : slots <= 2 ? 1 : slots <= 4 ? 2 : 3;
  void (*kernel)(const int64_t*, const double*, int64_t*, Layout, int, int, int, int, int) =
      which == 0 ? dada_place_kernel<1>
      : which == 1 ? dada_place_kernel<2>
      : which == 2 ? dada_place_kernel<4>
                   : dada_place_kernel<8>;
  err = allow_smem(kernel, smem, smem_set[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<const double*>(scores),
      static_cast<int64_t*>(out), L, n, n_res, n_cpu, n_gpu, flags);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_heft_select(const void* in, const void* scores, void* out,
                                 const int64_t* layout, int n, int n_res, int device,
                                 void* stream) {
  static bool smem_set = false;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 16 * 33 * static_cast<size_t>(n_res);
  if (n < 1 || n_res < 1 || smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(heft_select_kernel, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  Layout L;
  std::memcpy(&L, layout, sizeof(L));
  heft_select_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<const double*>(scores),
      static_cast<int64_t*>(out), L, n, n_res);
  return static_cast<int>(cudaGetLastError());
}
