// The surrogate episode scan on the card, for Hopper (sm_90a).
//
// episode_scan_kernel replaces the jitted episode body of
// repro/core/episode.py::_build_episode_fn (:363, the step :404-635: a
// lax.scan over task steps, vmap-ed over configurations) together with the
// Pallas transfer fold that body calls at every step,
// repro/kernels/sched_score.py:121 transfer_matrix_pallas (through xfer_rows,
// episode.py:376-382, the configurations as the kernel's row axis). One
// launch runs every configuration of a (graph, machine template) group.
//
// Selection does not depend on the configuration. The reference picks each
// step's task as the ready set's greatest priority, the first index among
// equals (episode.py:423-427), and the ready set changes only by that choice:
// the task retires, its successors' indegrees fall, and a successor whose
// indegree reaches 0 joins with its priority. prio and indeg0 belong to the
// plan; noise, machine axes and strategy touch only times and placements. So
// every configuration selects the same tasks in the same order, and the host
// computes that order once per plan (sched_episode.py::selection_order,
// memoized with the plan by core/episode.py::build_plan: a heap keyed by
// (-f32 prio, index), a task pushed when its indegree reaches exactly 0, a
// task of prio -inf never taken). The kernel reads t = order[k]; a step past
// the order's end is inactive with t = 0, as the reference's max + first
// match gives on an all -inf ready set, and still writes its schedule row.
// The ready set (pready, indeg) is gone from the state, and with it the
// O(n_pad) scan and the block barriers of every step.
//
// Grid and state. One warp a configuration, kWarps (2) configurations a
// block (episode_plan; fewer only where their shared memory would not fit;
// at most kMaxRes resources, one lane each; PERF.md §6 gives the counts
// measured). The kernel reads the inputs it needs and the plan's
// tables (sched_episode.py::PlanTables: the order and the task records,
// built once per plan and device), never the plan's prio / indeg0 or its
// rows one by one. Every step runs on the configuration's warp with
// __syncwarp, shuffles and warp votes only: there is no block barrier, and
// a spare warp of the last block leaves at once. The state stays in a
// global scratch buffer (state_words: ready_t, res_mask, writer
// and, with a capacity, touch; QR NT 16 on the paper machine 9 288 B a
// configuration); the clocks, task counts and machine rows of the resources,
// the gathered masks and two row buffers sit in the warp's slice of shared
// memory (warp_words); lane u holds memory u's column bit, host flag and
// resident bytes. A step:
//   1. the task's record (sched_episode.py::task_records: its reads, writes,
//      successors and durations packed into 16-byte words), the
//      configuration's noise and the task's ready time were copied into a
//      row buffer (cp.async, one 16-byte copy a lane) during the previous
//      step, since the order names the next task in advance; the ready time
//      takes the last finish when the last task was a predecessor;
//   2. lane i loads the state of read i, write i and successor i (and the
//      first read's writer) into registers, one round trip, and the next
//      task's copies are issued behind the loads;
//   3. lane u folds the reads and writes for memory u, in index order: the
//      transfer row X (the hop fold of transfer_matrix_pallas), the bytes
//      and, with a capacity, the landed and two-hop bytes, and the write
//      affinity; the chosen memory's values are later shuffled out of its
//      lane, so no serial pass over the reads follows the choice;
//   4. lane r scores resource r, and two redux.sync minima with a ballot
//      pick the first least score and the first least task count (f32
//      scores as order-preserving int keys);
//   5. the start and finish; lane 0 updates the clocks; lane i scatters read
//      i's new mask (unless the task writes it too), write i's mask and
//      writer, and successor i's ready time, from its registers;
//   6. with a capacity, up to kEvict LRU eviction rounds, each a warp-wide
//      first argmin over the data slots;
//   7. lane 0 writes the step's schedule row when asked.
//
// Arithmetic: f32, bit for bit as the reference's compiled scan. XLA on the
// CPU contracts multiply-adds, so the score's base + use_cp*X and
// ... - alpha*aff and the finish (start + xfer_t) + dur*noise are
// __fmaf_rn; every other op is __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn, so nvcc contracts nothing else. Sums over reads and writes
// run in index order from +0.0 (the fold of each memory in its lane is the
// reference's advance for that memory, op for op). Scatters drop ids out of
// range and the dummy data slot (pads carry distinct dummy ids; the dummy
// slot stays host / -1, is never a victim, and gathers of pad ids clamp to
// it), ready_t has no extra slot (successor pads are dropped), inactive
// steps change no state.
//
// What bounds a step now. The function needs little: each input read once,
// a few numbers a configuration written, and per task and configuration the
// folds over the unique memories, the scores, the hops and the successors.
// What remains is one dependent chain a step on each warp: the state loads
// (one L1/L2 round trip), the folds (a few shared-memory loads a term), two
// warp minima, the clock reads and the scatters. Several warps of an SM
// interleave their chains; the grid is one wave for the paper's sweeps
// (1 200 and 2 400 configurations), so the time is steps x the chain's
// latency, not the card's rates (PERF.md row 6 gives the measured split).
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 2;           // configurations a block (fewer where they do not fit)
constexpr int kSmemLimit = 232448;  // shared memory one block can opt in to
constexpr int kNever = 1 << 30;     // touch sentinel (episode.py's _NEVER)
constexpr int kEvict = 8;           // LRU rounds per placement (episode.py's _K_EVICT)
constexpr int kMaxRes = 32;         // resources a configuration: one lane each
constexpr int kFlagGpu = 1, kFlagValid = 2;  // a resource's flags word
constexpr int kPtrs = 27;
constexpr int kDims = 12;

struct Args {
  const float* sizes;  // the inputs the kernel reads, from sizes on (the
                       // plan's rows come packed in rec, its ready set as order)
  const int* col_bits;
  const uint8_t* host_col;
  const uint8_t* is_gpu;
  const uint8_t* valid_res;
  const int* mem_col;
  const int* link_grp;
  const float* alpha;
  const float* use_cp;
  const uint8_t* ws_pref;
  const float* noise;
  const float* cap;
  const float* bandwidth;
  float* mk;
  float* total_b;
  int* npl;
  int* s_tid;
  int* s_rid;
  uint8_t* s_act;
  float* s_start;
  float* s_xfer_t;
  float* s_fin;
  float* s_xfer_b;
  float* s_evict_b;
  int* state;        // B x state_words
  const int* order;  // the tasks in the order every configuration selects them
  const int* rec;    // n_pad x record_words: each task's plan rows, packed
  int B, n_pad, r_pad, w_pad, s_pad, R, n_u, nd1, n_steps, use_cap, emit, n_order;
  int warps;  // configurations a block: the launcher's plan
};

// 4-byte words of one configuration's state: ready_t (n_pad), res_mask and
// writer (nd1 each) and, with a capacity, touch (n_u x nd1)
__host__ __device__ inline size_t state_words(int n_pad, int nd1, int n_u, int use_cap) {
  return static_cast<size_t>(n_pad) + 2 * static_cast<size_t>(nd1) +
         (use_cap ? static_cast<size_t>(n_u) * nd1 : 0);
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// 4-byte words of one task's record (sched_episode.py's task_records): read
// ids, one-hop times and sizes, write ids and sizes, successors, then dur_cpu
// and dur_gpu, each section padded to 16 bytes
__host__ __device__ inline int record_words(int r_pad, int w_pad, int s_pad) {
  return 3 * round4(r_pad) + 2 * round4(w_pad) + round4(s_pad) + 4;
}

// a row buffer: the task's record, then the configuration's noise and the
// task's ready time (16-byte aligned)
__host__ __device__ inline int row_words(int r_pad, int w_pad, int s_pad) {
  return record_words(r_pad, w_pad, s_pad) + 4;
}

// 4-byte words of shared memory a warp, each part 16-byte aligned: two row
// buffers, six words per resource (load, tcount, link_free, mem_col,
// link_grp, flags), the gathered masks of the reads and of the writes, and
// the successors' ready times (past the first 32)
__host__ __device__ inline size_t warp_words(int R, int r_pad, int w_pad, int s_pad) {
  return static_cast<size_t>(2 * row_words(r_pad, w_pad, s_pad) + round4(6 * R) + round4(r_pad) +
                             round4(w_pad) + round4(s_pad));
}

struct Plan {
  int warps;    // configurations a block (0: refused)
  size_t smem;  // dynamic shared memory a block
};

// kWarps configurations a block, fewer where their shared memory would not
// fit; none beyond kMaxRes resources
__host__ inline Plan episode_plan(int R, int r_pad, int w_pad, int s_pad) {
  if (R > kMaxRes) return {0, 0};
  const size_t per = 4 * warp_words(R, r_pad, w_pad, s_pad);
  int w = kWarps;
  const size_t fit = kSmemLimit / per;
  if (static_cast<size_t>(w) > fit) w = static_cast<int>(fit);
  return {w, w * per};
}

// (v, i) beats (w, j): lesser value, the lesser index among equals
template <typename T>
__device__ __forceinline__ void min_first(T& v, int& i, T w, int j) {
  if (w < v || (w == v && j < i)) {
    v = w;
    i = j;
  }
}

template <typename T>
__device__ __forceinline__ void warp_min_first(T& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const T w = __shfl_xor_sync(kFull, v, off);
    const int j = __shfl_xor_sync(kFull, i, off);
    min_first(v, i, w, j);
  }
}

// A monotone int key of an f32 (a < b exactly when key(a) < key(b); -0 and
// +0 share one key, as they compare equal)
__device__ __forceinline__ int f32_key(float f) {
  const int i = __float_as_int(__fadd_rn(f, 0.f));
  return i >= 0 ? i : i ^ 0x7fffffff;
}

// The first lane holding the warp's least key
__device__ __forceinline__ int first_min_lane(int key, int& least) {
  least = __reduce_min_sync(kFull, key);
  return __ffs(__ballot_sync(kFull, key == least)) - 1;
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Issue the copies of task t's record (16 bytes a lane), the configuration's
// noise and the task's ready time into a row buffer
__device__ __forceinline__ void fetch_task(const int* rec, int rec_w, int t, const float* noise,
                                           const float* ready_t, int* row, int lane) {
  const int* src = rec + static_cast<size_t>(t) * rec_w;
#pragma unroll 1
  for (int i = 4 * lane; i < rec_w; i += 128) cp16(row + i, src + i);
  if (lane == 0) {
    cp4(row + rec_w, noise + t);
    cp4(row + rec_w + 1, ready_t + t);
  }
  cp_commit();
}

// kCap: a capacity binds some configuration (touch, resident bytes, LRU
// rounds); kEmit: the schedule rows are written
template <bool kCap, bool kEmit>
__global__ void __launch_bounds__(kWarps * 32) episode_scan_kernel(const Args a) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int b = blockIdx.x * a.warps + wib;
  if (b >= a.B) return;  // a spare warp of the last block: no barrier waits for it
  const int n_pad = a.n_pad, r_pad = a.r_pad, w_pad = a.w_pad, s_pad = a.s_pad;
  const int R = a.R, n_u = a.n_u, nd1 = a.nd1, n_order = a.n_order, n_steps = a.n_steps;
  const int rec_w = record_words(r_pad, w_pad, s_pad), rw = row_words(r_pad, w_pad, s_pad);

  // the warp's slice of shared memory, in warp_words order
  const int rp4 = round4(r_pad), wp4 = round4(w_pad), sp4 = round4(s_pad);
  int* rows = smem + static_cast<size_t>(wib) * warp_words(R, r_pad, w_pad, s_pad);
  float* load = reinterpret_cast<float*>(rows + 2 * rw);
  int* tcount = reinterpret_cast<int*>(load + R);
  float* link_free = reinterpret_cast<float*>(tcount + R);
  int* mcol = reinterpret_cast<int*>(link_free + R);
  int* lgrp = mcol + R;
  int* rflag = lgrp + R;
  int* masks = reinterpret_cast<int*>(load) + round4(6 * R);
  int* wmasks = masks + rp4;
  float* succ_old = reinterpret_cast<float*>(wmasks + wp4);

  int* st = a.state + static_cast<size_t>(b) * state_words(n_pad, nd1, n_u, kCap);
  float* ready_t = reinterpret_cast<float*>(st);
  int* res_mask = st + n_pad;
  int* writer = res_mask + nd1;
  int* touch = writer + nd1;

  const float* noise = a.noise + static_cast<size_t>(b) * n_pad;
  const float alpha = a.alpha[b], use_cp = a.use_cp[b], cap = a.cap[b], bw = *a.bandwidth;
  const bool ws_pref = a.ws_pref[b] != 0;
  // lane u holds memory u's column bit, host flag and resident bytes
  const int my_cb = lane < n_u ? a.col_bits[lane] : 0;
  const int my_hc = lane < n_u && a.host_col[lane] != 0 ? 1 : 0;
  float my_rb = 0.f;

#pragma unroll 1
  for (int i = lane; i < n_pad; i += 32) ready_t[i] = 0.f;
#pragma unroll 1
  for (int i = lane; i < nd1; i += 32) {
    res_mask[i] = 1;  // everything starts on host
    writer[i] = -1;
  }
  if (kCap) {
#pragma unroll 1
    for (int i = lane; i < n_u * nd1; i += 32) touch[i] = -1;
  }
  if (lane < R) {
    const size_t br = static_cast<size_t>(b) * R + lane;
    load[lane] = 0.f;
    tcount[lane] = 0;
    link_free[lane] = 0.f;
    mcol[lane] = a.mem_col[br];
    lgrp[lane] = a.link_grp[br];
    rflag[lane] = (a.is_gpu[br] ? kFlagGpu : 0) | (a.valid_res[br] ? kFlagValid : 0);
  }
  // the order, 32 entries a warp register (lane i: entry chunk_at + i);
  // entries past its end read 0, the inactive steps' task
  int chunk_at = 0;
  int chunk = lane < n_order ? a.order[lane] : 0;
  int chunk_next = 32 + lane < n_order ? a.order[32 + lane] : 0;
  __syncwarp();  // the initial state before the first fetch reads ready_t
  int t = __shfl_sync(kFull, chunk, 0);
  fetch_task(a.rec, rec_w, t, noise, ready_t, rows, lane);

  float total_b = 0.f, mk = 0.f, fin_prev = 0.f;
  int npl = 0;
  bool patch = false;  // the last task was one of this task's predecessors
#pragma unroll 1
  for (int k = 0; k < n_steps; ++k) {
    const int* row = rows + (k & 1) * rw;
    cp_wait_all();
    __syncwarp();  // every lane's copies, and the last step's stores
    const bool act = k < n_order;

    const int* rids = row;
    const float* prt = reinterpret_cast<const float*>(row + rp4);
    const float* rsz = reinterpret_cast<const float*>(row + 2 * rp4);
    const int* wids = row + 3 * rp4;
    const float* wsz = reinterpret_cast<const float*>(wids + wp4);
    const int* succ = wids + 2 * wp4;
    const float* dur = reinterpret_cast<const float*>(succ + sp4);
    const float* tail = reinterpret_cast<const float*>(row + rec_w);

    // 2. the state gathers into registers, lane i: read, write and successor
    // i (gathers clamp; pads past the state's edge); the next task's copies
    // are issued behind them ---------------------------------------------------
    const int rid_l = lane < r_pad ? rids[lane] : INT_MAX;
    const int wid_l = lane < w_pad ? wids[lane] : INT_MAX;
    const int sj = lane < s_pad ? succ[lane] : n_pad;
    const int mv = lane < r_pad ? res_mask[min(rid_l, nd1 - 1)] : 0;
    const int wv = lane < w_pad ? res_mask[min(wid_l, nd1 - 1)] : 0;
    const float so = act && sj < n_pad ? ready_t[sj] : 0.f;
    const int pref = ws_pref ? writer[min(rids[0], nd1 - 1)] : -1;
    const int kn = k + 1;
    if (kn - chunk_at == 32) {
      chunk = chunk_next;
      chunk_at = kn;
      chunk_next = chunk_at + 32 + lane < n_order ? a.order[chunk_at + 32 + lane] : 0;
    }
    const int t_next = __shfl_sync(kFull, chunk, kn - chunk_at);
    if (kn < n_steps) fetch_task(a.rec, rec_w, t_next, noise, ready_t, rows + (kn & 1) * rw, lane);
    // a read the task also writes is left to the write's scatter
    bool written = false;
#pragma unroll 1
    for (int w0 = 0; w0 < w_pad; w0 += 4) {
      const int4 wi = *reinterpret_cast<const int4*>(wids + w0);
      written |= wi.x == rid_l || (w0 + 1 < w_pad && wi.y == rid_l) ||
                 (w0 + 2 < w_pad && wi.z == rid_l) || (w0 + 3 < w_pad && wi.w == rid_l);
    }
    if (lane < r_pad) masks[lane] = mv;
    if (lane < w_pad) wmasks[lane] = wv;
    // past 32 reads, writes or successors (wide tasks): a second pass
#pragma unroll 1
    for (int r = lane + 32; r < r_pad; r += 32) masks[r] = res_mask[min(rids[r], nd1 - 1)];
#pragma unroll 1
    for (int w = lane + 32; w < w_pad; w += 32) wmasks[w] = res_mask[min(wids[w], nd1 - 1)];
#pragma unroll 1
    for (int j = lane + 32; j < s_pad; j += 32)
      succ_old[j] = act && succ[j] < n_pad ? ready_t[succ[j]] : 0.f;
    const float d_cpu = dur[0], d_gpu = dur[1], noise_t = tail[0];
    // fetched a step early: the last step may have raised it since
    const float est = patch ? fmaxf(tail[1], fin_prev) : tail[1];
    __syncwarp();

    // 3. the folds of each unique memory, in its lane, in index order -------
    float x = 0.f, xb = 0.f, rdn = 0.f, hn = 0.f, af = 0.f, wd = 0.f;
    if (lane < n_u) {
      // four terms a pass from 16-byte loads (the sections are padded to
      // them); the sums take only the terms below r_pad / w_pad
      const auto read_term = [&](int m, float pt, float sz, bool on) {
        const bool skip = (m & my_cb) != 0 || m == 0;
        const float h = skip ? 0.f : ((my_hc || (m & 1) != 0) ? 1.f : 2.f);
        x = on ? __fadd_rn(x, __fmul_rn(h, pt)) : x;
        xb = on ? __fadd_rn(xb, __fmul_rn(h, sz)) : xb;
        if (kCap) {
          rdn = on ? __fadd_rn(rdn, h > 0.f ? sz : 0.f) : rdn;
          hn = on ? __fadd_rn(hn, h == 2.f ? sz : 0.f) : hn;
        }
      };
#pragma unroll 1
      for (int r0 = 0; r0 < r_pad; r0 += 4) {
        const int4 m = *reinterpret_cast<const int4*>(masks + r0);
        const float4 pt = *reinterpret_cast<const float4*>(prt + r0);
        const float4 sz = *reinterpret_cast<const float4*>(rsz + r0);
        read_term(m.x, pt.x, sz.x, true);
        read_term(m.y, pt.y, sz.y, r0 + 1 < r_pad);
        read_term(m.z, pt.z, sz.z, r0 + 2 < r_pad);
        read_term(m.w, pt.w, sz.w, r0 + 3 < r_pad);
      }
      float s = 0.f;
      const auto write_term = [&](int wm, float sz, bool on) {
        const bool hit = (wm & my_cb) != 0;
        s = on ? __fadd_rn(s, __fmul_rn(hit ? 1.f : 0.f, sz)) : s;
        if (kCap) wd = on ? __fadd_rn(wd, hit ? sz : 0.f) : wd;
      };
#pragma unroll 1
      for (int w0 = 0; w0 < w_pad; w0 += 4) {
        const int4 wm = *reinterpret_cast<const int4*>(wmasks + w0);
        const float4 sz = *reinterpret_cast<const float4*>(wsz + w0);
        write_term(wm.x, sz.x, true);
        write_term(wm.y, sz.y, w0 + 1 < w_pad);
        write_term(wm.z, sz.z, w0 + 2 < w_pad);
        write_term(wm.w, sz.w, w0 + 3 < w_pad);
      }
      // accel_write; the sum of non-negative terms from +0.0 is +0.0 or
      // positive, and +0.0 / bw is +0.0 (this keeps a zero dividend off the
      // division's slow path)
      af = my_hc || s == 0.f ? 0.f : __fdiv_rn(s, bw);
    }

    // 4. the score per resource, lane r resource r, and the first argmins of
    // the scores and of the task counts (a lane past R holds the greatest
    // key, an invalid resource the key of +inf; a task count one below) ------
    const bool in = lane < R;
    const int mc = in ? mcol[lane] : 0;
    const float xr = __shfl_sync(kFull, x, mc);
    const float ar = __shfl_sync(kFull, af, mc);
    int skey = INT_MAX, tkey = INT_MAX;
    if (in) {
      const int fl = rflag[lane];
      const float base = fmaxf(est, load[lane]);
      float sc = __fmaf_rn(use_cp, xr, base);
      sc = __fadd_rn(sc, (fl & kFlagGpu) ? d_gpu : d_cpu);
      sc = __fmaf_rn(-alpha, ar, sc);
      skey = f32_key((fl & kFlagValid) ? sc : INFINITY);
      tkey = (fl & kFlagValid) ? tcount[lane] : INT_MAX - 1;
    }
    int s_least, t_least;
    int r_sel = first_min_lane(skey, s_least);
    const int tsel = first_min_lane(tkey, t_least);
    if (ws_pref) {
      // work stealing: spread by count, keep a child on its parent's worker
      // unless that worker is clearly backlogged
      const float tbest = t_least == INT_MAX - 1 ? INFINITY : static_cast<float>(t_least);
      const int pc = min(max(pref, 0), R - 1);
      const bool pvalid = (rflag[pc] & kFlagValid) != 0;
      const float tpc = pvalid ? static_cast<float>(tcount[pc]) : INFINITY;
      const bool ok = pref >= 0 && pvalid && tpc <= __fadd_rn(tbest, 1.f);
      r_sel = ok ? pc : tsel;
    }

    // 5. the advance: the chosen memory's folds, out of its lane ----------------
    const int u = mcol[r_sel];
    const int dst_bit = __shfl_sync(kFull, my_cb, u);
    const bool dst_host = __shfl_sync(kFull, my_hc, u) != 0;
    const float xfer_t = __shfl_sync(kFull, x, u);
    const float xfer_b = __shfl_sync(kFull, xb, u);
    const float dur_sel = (rflag[r_sel] & kFlagGpu) ? d_gpu : d_cpu;
    const int grp = lgrp[r_sel];
    const bool has_x = xfer_t > 0.f;
    float start = fmaxf(est, load[r_sel]);
    start = fmaxf(start, has_x ? link_free[grp] : 0.f);
    const float sx = __fadd_rn(start, xfer_t);
    const float fin = __fmaf_rn(dur_sel, noise_t, sx);
    const float tb_in = total_b;
    __syncwarp();  // every lane has read the clocks
    if (act) {
      if (lane == 0) {
        // transfers serialize FIFO on the destination's link group
        if (has_x && grp < R) link_free[grp] = sx;
        load[r_sel] = fin;
        tcount[r_sel] += 1;
      }
      npl += 1;
      // the successors' ready times (pads dropped)
      if (sj < n_pad) ready_t[sj] = fmaxf(so, fin);
#pragma unroll 1
      for (int j = lane + 32; j < s_pad; j += 32)
        if (succ[j] < n_pad) ready_t[succ[j]] = fmaxf(succ_old[j], fin);
      // residency: reads land copies, writes invalidate (the dummy slot and
      // ids past the state's edge are not scattered)
      if (lane < r_pad && !written && rid_l < nd1 - 1) {
        const bool stay = (mv & dst_bit) != 0 || mv == 0;
        const float h = stay ? 0.f : ((dst_host || (mv & 1) != 0) ? 1.f : 2.f);
        res_mask[rid_l] = mv | (h > 0.f ? dst_bit : 0) | (h == 2.f ? 1 : 0);
        if (kCap) touch[static_cast<size_t>(u) * nd1 + rid_l] = k;
      }
#pragma unroll 1
      for (int r = lane + 32; r < r_pad; r += 32) {
        const int id = rids[r];
        bool wr = id >= nd1 - 1;
#pragma unroll 1
        for (int w = 0; w < w_pad; ++w) wr |= wids[w] == id;
        if (!wr) {
          const int m = masks[r];
          const bool stay = (m & dst_bit) != 0 || m == 0;
          const float h = stay ? 0.f : ((dst_host || (m & 1) != 0) ? 1.f : 2.f);
          res_mask[id] = m | (h > 0.f ? dst_bit : 0) | (h == 2.f ? 1 : 0);
          if (kCap) touch[static_cast<size_t>(u) * nd1 + id] = k;
        }
      }
#pragma unroll 1
      for (int w = lane; w < w_pad; w += 32) {
        const int id = w < 32 ? wid_l : wids[w];
        if (id < nd1 - 1) {
          res_mask[id] = dst_bit;
          writer[id] = r_sel;
          if (kCap) touch[static_cast<size_t>(u) * nd1 + id] = k;
        }
      }
    }
    mk = fmaxf(mk, act ? fin : 0.f);
    total_b = __fadd_rn(total_b, act ? xfer_b : 0.f);
    // the next task's ready time was fetched before this step's successors
    bool hit = sj == t_next;
#pragma unroll 1
    for (int j = lane + 32; j < s_pad; j += 32) hit |= succ[j] == t_next;
    patch = act && __any_sync(kFull, hit);
    fin_prev = fin;

    // 6. LRU eviction: the least recently touched resident copy at the chosen
    // memory, the first index among equals, until the memory fits -----------
    if (kCap) {
      // resident bytes per memory: the reads landed, the writes, the copies
      // the writes dropped elsewhere, the host copies of two-hop reads
      const float rd_new = __shfl_sync(kFull, rdn, u);
      const float host_new = __shfl_sync(kFull, hn, u);
      float w_tot = 0.f;
#pragma unroll 1
      for (int w = 0; w < w_pad; ++w) w_tot = __fadd_rn(w_tot, wsz[w]);
      if (lane < n_u) {
        float delta = __fmul_rn(lane == u ? 1.f : 0.f, __fadd_rn(rd_new, w_tot));
        delta = __fsub_rn(delta, wd);
        delta = __fadd_rn(delta, __fmul_rn(my_hc ? 1.f : 0.f, host_new));
        my_rb = __fadd_rn(my_rb, act ? delta : 0.f);
      }
      bool need = act && !dst_host && __shfl_sync(kFull, my_rb, u) > cap;
      __syncwarp();  // the scatters before the rounds read res_mask
      const int* touch_u = touch + static_cast<size_t>(u) * nd1;
#pragma unroll 1
      for (int round = 0; round < kEvict && need; ++round) {
        int key = INT_MAX, vi = INT_MAX;
#pragma unroll 1
        for (int i = lane; i < nd1; i += 32) {
          const bool cand = (res_mask[i] & dst_bit) != 0 && touch_u[i] < k && a.sizes[i] > 0.f;
          min_first(key, vi, cand ? touch_u[i] : kNever, i);
        }
        warp_min_first(key, vi);
        if (key >= kNever) break;  // no candidate: every later round is a no-op
        const float vsz = a.sizes[vi];
        const int vmask = res_mask[vi];
        const bool dirty = vmask == dst_bit;  // sole device copy: write back
        if (dirty) total_b = __fadd_rn(total_b, vsz);
        __syncwarp();  // every lane has read res_mask[vi]
        if (lane == 0) res_mask[vi] = (vmask | (dirty ? 1 : 0)) & ~dst_bit;
        if (lane == u) my_rb = __fsub_rn(my_rb, vsz);
        need = __shfl_sync(kFull, my_rb, u) > cap;
        __syncwarp();
      }
    }

    // 7. the step's schedule row ------------------------------------------------
    if (kEmit && lane == 0) {
      const size_t o = static_cast<size_t>(b) * n_steps + k;
      const float xb = act ? xfer_b : 0.f;
      a.s_tid[o] = t;
      a.s_rid[o] = r_sel;
      a.s_act[o] = act ? 1 : 0;
      a.s_start[o] = start;
      a.s_xfer_t[o] = xfer_t;
      a.s_fin[o] = fin;
      a.s_xfer_b[o] = xb;
      a.s_evict_b[o] = __fsub_rn(__fsub_rn(total_b, tb_in), xb);
    }
    t = t_next;
  }
  if (lane == 0) {
    a.mk[b] = mk;
    a.total_b[b] = total_b;
    a.npl[b] = npl;
  }
}

using KernelFn = void (*)(const Args);

// the kernel instance for (use_cap, emit)
KernelFn pick_kernel(bool cap, bool emit) {
  if (cap) return emit ? episode_scan_kernel<true, true> : episode_scan_kernel<true, false>;
  return emit ? episode_scan_kernel<false, true> : episode_scan_kernel<false, false>;
}

}  // namespace

// ptrs: the inputs from sizes on in the reference's argument order (sizes,
// col_bits, host_col, is_gpu, valid_res, mem_col, link_grp, alpha, use_cp,
// ws_pref, noise, cap, bandwidth), the three results, the eight schedule
// columns (null without emit), the state, the order and the task records.
// dims: B, n_pad, r_pad, w_pad, s_pad, R, n_u, nd1, n_steps, use_cap, emit,
// n_order. Does not synchronize; returns cudaGetLastError() of the launch.
extern "C" int repro_episode_scan(const int64_t* ptrs, const int* dims, int device,
                                  void* stream) {
  static bool smem_set[4] = {false, false, false, false};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  static_assert(sizeof(void*) == sizeof(int64_t), "64-bit pointers");
  std::memcpy(&a, ptrs, kPtrs * sizeof(int64_t));
  std::memcpy(&a.B, dims, kDims * sizeof(int));
  if (a.B < 1 || a.n_steps < 1 || a.n_pad < 1 || a.R < 1 || a.n_u < 1 || a.n_u > 31 ||
      a.nd1 < 1 || a.r_pad < 1 || a.w_pad < 1 || a.s_pad < 1 || a.state == nullptr ||
      a.rec == nullptr || a.n_order < 0 || a.n_order > a.n_pad ||
      (a.n_order > 0 && a.order == nullptr) || (a.emit && a.s_tid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = episode_plan(a.R, a.r_pad, a.w_pad, a.s_pad);
  if (p.warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.warps = p.warps;
  const KernelFn kernel = pick_kernel(a.use_cap != 0, a.emit != 0);
  const int which = (a.use_cap ? 2 : 0) + (a.emit ? 1 : 0);
  if (p.smem > 48 * 1024 && !smem_set[which]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[which] = true;
  }
  const int grid = (a.B + p.warps - 1) / p.warps;
  kernel<<<grid, 32 * p.warps, p.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The launcher's plan for (R, r_pad, w_pad, s_pad): plan[0] the
// configurations a block, plan[1] the dynamic shared bytes a block; refused
// (cudaErrorInvalidValue) beyond kMaxRes resources or where one warp's share
// does not fit.
extern "C" int repro_episode_plan(int R, int r_pad, int w_pad, int s_pad, int64_t* plan) {
  if (R < 1 || r_pad < 1 || w_pad < 1 || s_pad < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = episode_plan(R, r_pad, w_pad, s_pad);
  if (p.warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.warps;
  plan[1] = static_cast<int64_t>(p.smem);
  return 0;
}
