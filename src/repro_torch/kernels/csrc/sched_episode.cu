// The surrogate episode scan on the card, for Hopper (sm_90a).
//
// episode_scan_kernel replaces the jitted episode body of
// repro/core/episode.py::_build_episode_fn (:363, the step :404-635: a
// lax.scan over task steps, vmap-ed over configurations) together with the
// Pallas transfer fold that body calls at every step,
// repro/kernels/sched_score.py:121 transfer_matrix_pallas (through xfer_rows,
// episode.py:376-382, the configurations as the kernel's row axis). One
// launch runs every configuration of a (graph, machine template) group: one
// block per configuration, every step of its list-scheduling scan inside the
// block. Each step:
//   1. the block's threads scan the ready set (pready, n_pad f32) for its
//      maximum, the first index among equals (episode.py:424-427);
//   2. warp 0 does the per-read, per-write and per-resource work: the hop
//      fold of the transfer rows X and the affinity rows over the unique
//      memories (one lane a memory, reads and writes in order), the score
//      per resource and its first argmin, the work-stealing choice, the
//      hops, transfer time and bytes to the chosen memory, the start and
//      finish, the clocks, the successors (one lane a successor) and the
//      residency and writer scatters;
//   3. with a capacity, up to kEvict LRU eviction rounds, each a block-wide
//      first argmin over the data slots;
//   4. thread 0 writes the step's schedule row when asked.
// __syncthreads separates the phases where one reads what the last wrote.
//
// Arithmetic: f32, bit for bit as the reference's compiled scan. XLA on the
// CPU contracts multiply-adds, so the score's base + use_cp*X and
// ... - alpha*aff and the finish (start + xfer_t) + dur*noise are
// __fmaf_rn; every other op is __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn, so nvcc contracts nothing else. Sums over reads and writes
// run in index order from +0.0. Scatters drop ids out of range (pads carry
// distinct dummy ids, inactive steps are skipped), gathers clamp, indeg
// and ready_t carry the extra slot the first successor pad hits, and the
// dummy data slot is reset to host / -1 every step.
//
// Where the state lives. A configuration carries pready, ready_t, indeg
// (n_pad + 1 each but pready), res_mask and writer (nd1 each) and, with a
// capacity, touch (n_u x nd1), in a global scratch buffer (sched_episode.py's
// state_words a block: NT 16 on the paper machine is about 22 KB, NT 64 0.5-1
// MB); the per-resource clocks, the rows per memory and the step's reads and
// writes sit in shared memory. At NT 16 the state of the blocks an SM holds
// (5-8 by registers, 22 KB each) fits in its L1; keeping the state in shared
// memory instead took the same time (tools/episode_time.py), so there is one
// layout.
//
// What bounds it on an H100. The work the function needs is small: it reads
// its inputs once (the plan, the noise rows), writes a few numbers a
// configuration, and per step folds the reads and writes over the unique
// memories, scores the resources and updates the successors; with a heap for
// the ready set, selection is log(n_pad) compares. This kernel spends far
// more: each step scans the whole ready set (n_pad values, O(n_pad) where a
// heap needs O(log n_pad)), then runs a chain of dependent warp steps behind
// two block barriers. The design gives every configuration its own block so
// that several blocks interleave their chains on one SM (128 threads a block)
// and launches once per group. An incremental ready set in place of the scan
// is left for later.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kNever = 1 << 30;  // indegree / touch sentinel (episode.py's _NEVER)
constexpr int kEvict = 8;        // LRU rounds per placement (episode.py's _K_EVICT)
constexpr int kPtrs = 35;
constexpr int kDims = 11;

// scalar slots of the block (the last 16 words of the small arrays)
constexpr int kSlotU = 0, kSlotBit = 1, kSlotNeed = 2;

struct Args {
  const int* read_ids;
  const float* read_t;
  const float* read_sz;
  const int* write_ids;
  const float* write_sz;
  const int* succ_ids;
  const int* indeg0;
  const float* prio;
  const float* dur_cpu;
  const float* dur_gpu;
  const float* sizes;
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
  int* state;  // B x state_words
  int B, n_pad, r_pad, w_pad, s_pad, R, n_u, nd1, n_steps, use_cap, emit;
};

__host__ __device__ inline size_t state_words(int n_pad, int nd1, int n_u, int use_cap) {
  return static_cast<size_t>(n_pad) + 2 * (static_cast<size_t>(n_pad) + 1) + 2 * nd1 +
         (use_cap ? static_cast<size_t>(n_u) * nd1 : 0);
}

__host__ __device__ inline size_t small_words(int R, int n_u, int r_pad, int w_pad) {
  return 3 * static_cast<size_t>(R) + 3 * n_u + 4 * r_pad + 3 * w_pad + 2 * 32 + 16;
}

// (v, i) beats (w, j): greater value, the lesser index among equals
__device__ __forceinline__ void max_first(float& v, int& i, float w, int j) {
  if (w > v || (w == v && j < i)) {
    v = w;
    i = j;
  }
}

// (v, i) beats (w, j): lesser value, the lesser index among equals
template <typename T>
__device__ __forceinline__ void min_first(T& v, int& i, T w, int j) {
  if (w < v || (w == v && j < i)) {
    v = w;
    i = j;
  }
}

__device__ __forceinline__ void warp_max_first(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, off);
    const int j = __shfl_xor_sync(kFull, i, off);
    max_first(v, i, w, j);
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

__global__ void __launch_bounds__(kThreads) episode_scan_kernel(const Args a) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_pad = a.n_pad, r_pad = a.r_pad, w_pad = a.w_pad, s_pad = a.s_pad;
  const int R = a.R, n_u = a.n_u, nd1 = a.nd1;

  // the small arrays, in small_words order
  float* load = reinterpret_cast<float*>(smem);
  int* tcount = smem + R;
  float* link_free = reinterpret_cast<float*>(smem + 2 * R);
  float* resbytes = reinterpret_cast<float*>(smem + 3 * R);
  float* xrow = resbytes + n_u;
  float* aff = xrow + n_u;
  int* rids = reinterpret_cast<int*>(aff + n_u);
  float* prt = reinterpret_cast<float*>(rids + r_pad);
  float* rsz = prt + r_pad;
  int* masks = reinterpret_cast<int*>(rsz + r_pad);
  int* wids = masks + r_pad;
  float* wsz = reinterpret_cast<float*>(wids + w_pad);
  int* wmasks = reinterpret_cast<int*>(wsz + w_pad);
  int* red_i = wmasks + w_pad;
  float* red_v = reinterpret_cast<float*>(red_i + 32);
  int* slot = reinterpret_cast<int*>(red_v + 32);
  int* st = a.state + static_cast<size_t>(b) * state_words(n_pad, nd1, n_u, a.use_cap);
  float* pready = reinterpret_cast<float*>(st);
  float* ready_t = pready + n_pad;
  int* indeg = reinterpret_cast<int*>(ready_t + n_pad + 1);
  int* res_mask = indeg + n_pad + 1;
  int* writer = res_mask + nd1;
  int* touch = writer + nd1;

  // this configuration's row of every batch axis
  const uint8_t* is_gpu = a.is_gpu + static_cast<size_t>(b) * R;
  const uint8_t* valid = a.valid_res + static_cast<size_t>(b) * R;
  const int* mem_col = a.mem_col + static_cast<size_t>(b) * R;
  const int* link_grp = a.link_grp + static_cast<size_t>(b) * R;
  const float* noise = a.noise + static_cast<size_t>(b) * n_pad;
  const float alpha = a.alpha[b], use_cp = a.use_cp[b], cap = a.cap[b], bw = *a.bandwidth;
  const bool ws_pref = a.ws_pref[b] != 0;

  for (int i = tid; i < n_pad; i += kThreads)
    pready[i] = a.indeg0[i] == 0 ? a.prio[i] : -INFINITY;
  for (int i = tid; i <= n_pad; i += kThreads) {
    ready_t[i] = 0.f;
    indeg[i] = a.indeg0[i];
  }
  for (int i = tid; i < nd1; i += kThreads) {
    res_mask[i] = 1;  // everything starts on host
    writer[i] = -1;
  }
  if (a.use_cap)
    for (int i = tid; i < n_u * nd1; i += kThreads) touch[i] = -1;
  for (int r = tid; r < R; r += kThreads) {
    load[r] = 0.f;
    tcount[r] = 0;
    link_free[r] = 0.f;
  }
  for (int u = tid; u < n_u; u += kThreads) resbytes[u] = 0.f;
  // warp 0's running totals (every lane holds them; lane 0 writes them out)
  float total_b = 0.f, mk = 0.f;
  int npl = 0;
  __syncthreads();

  for (int k = 0; k < a.n_steps; ++k) {
    // 1. the ready set's maximum, the first index among equals -------------
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < n_pad; i += kThreads) {
      const float v = pready[i];
      if (bi == INT_MAX || v > bv) {
        bv = v;
        bi = i;
      }
    }
    warp_max_first(bv, bi);
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();

    float start = 0.f, xfer_t = 0.f, fin = 0.f, xfer_b = 0.f, tb_in = total_b;
    int t = 0, r_sel = 0;
    bool act = false;
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : -INFINITY;
      bi = lane < kWarps ? red_i[lane] : INT_MAX;
      warp_max_first(bv, bi);
      t = bi;
      act = bv > -INFINITY;  // padded steps: no-op

      // 2. the task's reads and writes, with their residency masks ----------
      for (int r = lane; r < r_pad; r += 32) {
        const int id = a.read_ids[static_cast<size_t>(t) * r_pad + r];
        rids[r] = id;
        prt[r] = a.read_t[static_cast<size_t>(t) * r_pad + r];
        rsz[r] = a.read_sz[static_cast<size_t>(t) * r_pad + r];
        masks[r] = res_mask[min(id, nd1 - 1)];  // gathers clamp
      }
      for (int w = lane; w < w_pad; w += 32) {
        const int id = a.write_ids[static_cast<size_t>(t) * w_pad + w];
        wids[w] = id;
        wsz[w] = a.write_sz[static_cast<size_t>(t) * w_pad + w];
        wmasks[w] = res_mask[min(id, nd1 - 1)];
      }
      __syncwarp();
      // transfer and affinity rows, one lane a unique memory: the hop fold of
      // transfer_matrix_pallas and the write-affinity sum, both in order
      for (int u = lane; u < n_u; u += 32) {
        const int cb = a.col_bits[u];
        const bool hc = a.host_col[u] != 0;
        float x = 0.f;
        for (int r = 0; r < r_pad; ++r) {
          const int m = masks[r];
          const bool skip = (m & cb) != 0 || m == 0;
          const float h = skip ? 0.f : ((hc || (m & 1) != 0) ? 1.f : 2.f);
          x = __fadd_rn(x, __fmul_rn(h, prt[r]));
        }
        xrow[u] = x;
        float s = 0.f;
        for (int w = 0; w < w_pad; ++w)
          s = __fadd_rn(s, __fmul_rn((wmasks[w] & cb) != 0 ? 1.f : 0.f, wsz[w]));
        aff[u] = hc ? 0.f : __fdiv_rn(s, bw);  // accel_write
      }
      __syncwarp();

      // the score per resource and its first argmin; the task counts' too
      const float est = ready_t[t];
      const float d_cpu = a.dur_cpu[t], d_gpu = a.dur_gpu[t];
      float best = INFINITY, tbest = INFINITY;
      int bsel = INT_MAX, tsel = INT_MAX;
      for (int r = lane; r < R; r += 32) {
        const int mc = mem_col[r];
        const float base = fmaxf(est, load[r]);
        float s = __fmaf_rn(use_cp, xrow[mc], base);
        s = __fadd_rn(s, is_gpu[r] ? d_gpu : d_cpu);
        s = __fmaf_rn(-alpha, aff[mc], s);
        if (!valid[r]) s = INFINITY;
        if (bsel == INT_MAX || s < best) {
          best = s;
          bsel = r;
        }
        const float ts = valid[r] ? static_cast<float>(tcount[r]) : INFINITY;
        if (tsel == INT_MAX || ts < tbest) {
          tbest = ts;
          tsel = r;
        }
      }
      warp_min_first(best, bsel);
      warp_min_first(tbest, tsel);
      r_sel = bsel;
      if (ws_pref) {
        // work stealing: spread by count, keep a child on its parent's
        // worker unless that worker is clearly backlogged
        const int pref = writer[min(rids[0], nd1 - 1)];
        const int pc = min(max(pref, 0), R - 1);
        const float tpc = valid[pc] ? static_cast<float>(tcount[pc]) : INFINITY;
        const bool ok = pref >= 0 && valid[pc] && tpc <= __fadd_rn(tbest, 1.f);
        r_sel = ok ? pc : tsel;
      }
      r_sel = __shfl_sync(kFull, r_sel, 0);  // lane 0 writes writer below
      const int u = mem_col[r_sel];
      const int dst_bit = a.col_bits[u];
      const bool dst_host = a.host_col[u] != 0;
      const float dur_sel = is_gpu[r_sel] ? d_gpu : d_cpu;
      const int grp = link_grp[r_sel];

      // 3. the advance: hops of every read to the chosen memory (lane 0) ----
      float rd_new = 0.f, host_new = 0.f;
      if (lane == 0) {
        for (int r = 0; r < r_pad; ++r) {
          const int m = masks[r];
          const bool stay = (m & dst_bit) != 0 || m == 0;
          const float h = stay ? 0.f : ((dst_host || (m & 1) != 0) ? 1.f : 2.f);
          xfer_t = __fadd_rn(xfer_t, __fmul_rn(h, prt[r]));
          xfer_b = __fadd_rn(xfer_b, __fmul_rn(h, rsz[r]));
          rd_new = __fadd_rn(rd_new, h > 0.f ? rsz[r] : 0.f);
          host_new = __fadd_rn(host_new, h == 2.f ? rsz[r] : 0.f);
          masks[r] = m | (h > 0.f ? dst_bit : 0) | (h == 2.f ? 1 : 0);  // the new mask
        }
        const bool has_x = xfer_t > 0.f;
        start = fmaxf(est, load[r_sel]);
        start = fmaxf(start, has_x ? link_free[grp] : 0.f);
        const float sx = __fadd_rn(start, xfer_t);
        fin = __fmaf_rn(dur_sel, noise[t], sx);
        if (act) {
          // transfers serialize FIFO on the destination's link group
          if (has_x && grp < R) link_free[grp] = sx;
          load[r_sel] = fin;
          tcount[r_sel] += 1;
          npl += 1;
          pready[t] = -INFINITY;  // retire the task
          // residency: reads land copies, then writes invalidate
          for (int r = 0; r < r_pad; ++r)
            if (rids[r] < nd1) res_mask[rids[r]] = masks[r];
          for (int w = 0; w < w_pad; ++w)
            if (wids[w] < nd1) {
              res_mask[wids[w]] = dst_bit;
              writer[wids[w]] = r_sel;
            }
          if (a.use_cap) {
            for (int r = 0; r < r_pad; ++r)
              if (rids[r] < nd1) touch[static_cast<size_t>(u) * nd1 + rids[r]] = k;
            for (int w = 0; w < w_pad; ++w)
              if (wids[w] < nd1) touch[static_cast<size_t>(u) * nd1 + wids[w]] = k;
          }
        }
        res_mask[nd1 - 1] = 1;  // the dummy slot stays host
        writer[nd1 - 1] = -1;
        mk = fmaxf(mk, act ? fin : 0.f);
        total_b = __fadd_rn(total_b, act ? xfer_b : 0.f);
      }
      fin = __shfl_sync(kFull, fin, 0);
      // successors, one lane each: decrement, light up, push the ready time
      if (act) {
        for (int j = lane; j < s_pad; j += 32) {
          const int s = a.succ_ids[static_cast<size_t>(t) * s_pad + j];
          if (s > n_pad) continue;  // pads past the extra slot: dropped
          const int d = indeg[s] - 1;
          indeg[s] = d;
          if (s < n_pad) pready[s] = fmaxf(pready[s], d == 0 ? a.prio[s] : -INFINITY);
          ready_t[s] = fmaxf(ready_t[s], fin);
        }
      }
      if (a.use_cap) {
        // resident bytes per memory: the reads landed, the writes, the copies
        // the writes dropped elsewhere, the host copies of two-hop reads
        rd_new = __shfl_sync(kFull, rd_new, 0);
        host_new = __shfl_sync(kFull, host_new, 0);
        float w_tot = 0.f;
        for (int w = 0; w < w_pad; ++w) w_tot = __fadd_rn(w_tot, wsz[w]);
        for (int v = lane; v < n_u; v += 32) {
          const int cb = a.col_bits[v];
          float w_drop = 0.f;
          for (int w = 0; w < w_pad; ++w) w_drop = __fadd_rn(w_drop, (wmasks[w] & cb) != 0 ? wsz[w] : 0.f);
          float delta = __fmul_rn(v == u ? 1.f : 0.f, __fadd_rn(rd_new, w_tot));
          delta = __fsub_rn(delta, w_drop);
          delta = __fadd_rn(delta, __fmul_rn(a.host_col[v] ? 1.f : 0.f, host_new));
          resbytes[v] = __fadd_rn(resbytes[v], act ? delta : 0.f);
        }
        __syncwarp();
        if (lane == 0) {
          slot[kSlotU] = u;
          slot[kSlotBit] = dst_bit;
          slot[kSlotNeed] = act && !dst_host && resbytes[u] > cap;
        }
      }
    }
    __syncthreads();

    // 4. LRU eviction: the least recently touched resident copy at the chosen
    // memory, the first index among equals, until the memory fits -----------
    if (a.use_cap) {
      const int u = slot[kSlotU], dst_bit = slot[kSlotBit];
      const int* touch_u = touch + static_cast<size_t>(u) * nd1;
      for (int round = 0; round < kEvict && slot[kSlotNeed]; ++round) {
        int key = INT_MAX, vi = INT_MAX;
        for (int i = tid; i < nd1; i += kThreads) {
          const bool cand = (res_mask[i] & dst_bit) != 0 && touch_u[i] < k && a.sizes[i] > 0.f;
          min_first(key, vi, cand ? touch_u[i] : kNever, i);
        }
        warp_min_first(key, vi);
        if (lane == 0) {
          red_v[warp] = __int_as_float(key);
          red_i[warp] = vi;
        }
        __syncthreads();
        if (tid == 0) {
          key = INT_MAX;
          vi = INT_MAX;
          for (int w = 0; w < kWarps; ++w) min_first(key, vi, __float_as_int(red_v[w]), red_i[w]);
          if (key >= kNever) {
            slot[kSlotNeed] = 0;  // no candidate: every later round is a no-op
          } else {
            const float vsz = a.sizes[vi];
            const int vmask = res_mask[vi];
            const bool dirty = vmask == dst_bit;  // sole device copy: write back
            if (dirty) total_b = __fadd_rn(total_b, vsz);
            res_mask[vi] = (vmask | (dirty ? 1 : 0)) & ~dst_bit;
            resbytes[u] = __fsub_rn(resbytes[u], vsz);
            slot[kSlotNeed] = resbytes[u] > cap;
          }
        }
        __syncthreads();
      }
    }

    if (a.emit && tid == 0) {
      const size_t o = static_cast<size_t>(b) * a.n_steps + k;
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
  }
  if (tid == 0) {
    a.mk[b] = mk;
    a.total_b[b] = total_b;
    a.npl[b] = npl;
  }
}

}  // namespace

// ptrs: the 23 inputs in the reference's argument order, the three results,
// the eight schedule columns (null without emit) and the state. dims: B,
// n_pad, r_pad, w_pad, s_pad, R, n_u, nd1, n_steps, use_cap, emit.
extern "C" int repro_episode_scan(const int64_t* ptrs, const int* dims, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  static_assert(sizeof(void*) == sizeof(int64_t), "64-bit pointers");
  std::memcpy(&a, ptrs, kPtrs * sizeof(int64_t));
  std::memcpy(&a.B, dims, kDims * sizeof(int));
  if (a.B < 1 || a.n_steps < 1 || a.n_pad < 1 || a.R < 1 || a.n_u < 1 || a.n_u > 31 ||
      a.nd1 < 1 || a.r_pad < 1 || a.w_pad < 1 || a.s_pad < 1 || a.state == nullptr ||
      (a.emit && a.s_tid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // a few hundred bytes: within the default dynamic shared-memory limit
  const size_t smem = 4 * small_words(a.R, a.n_u, a.r_pad, a.w_pad);
  episode_scan_kernel<<<a.B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
