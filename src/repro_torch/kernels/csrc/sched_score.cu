// Placement scoring of one scheduling activation, for Hopper (sm_90a).
//
// Two kernels share the hop fold below:
//
// * score_activation_kernel, the main path. It replaces the Pallas kernel
//   repro/kernels/sched_score.py:121 (transfer_matrix_pallas) together with
//   the rest of the jitted function around it, repro/core/backend.py:446
//   (_build_matrix_fn): per-read transfer times, the transfer fold X_u, the
//   col_of gather to resources, the additive x_bias, the row maxima, the
//   affinity fold S and the cost C = base + X, for every ready task of one
//   activation, in one launch. Under the missing_bytes affinity
//   (kSMissing) S is the same hop fold over the task's reads with their
//   sizes as the per-read value, negated:
//       S_u[i, u] = -(sum over reads r of hops(mask[i, r], u) * size[i, r])
//   (repro/core/affinity.py:193-220): integer byte counts times 0, 1 or 2,
//   exact in any order; a zero sum negates into -0.0, as the reference's.
// * transfer_matrix_kernel, the standalone counterpart of
//   transfer_matrix_pallas (the transfer fold alone, over dense padded
//   reads), kept for its own tests and checks.
//
// The fold. For every (ready task i, unique memory u):
//
//     X_u[i, u] = sum over reads r, in order, of hops(mask[i, r], u) * per_read[i, r]
//
// where mask is the full int64 residency mask of the read's datum (bit 0:
// a host copy exists; bit mem+1: a valid copy in device memory mem) and
// hops is the paper-era PCIe path length: 0 if the datum is resident at u
// or exists nowhere yet (mask 0, which is also every padded read); 1 if u
// is the host or a host copy exists; 2 otherwise (device -> host -> device).
//
// x_bias is the pressure channel (repro_torch/runtime/memory.py,
// pressure_rows_for): the memory pressure, +inf over a detached resource's
// column and the remaining notice window over a noticed one. The kernel adds
// it as it adds any value: x + inf = +inf in X, in the row maxima (fmax) and
// in C; no other input is infinite, so no NaN arises. DADA asks for the
// pressure without the fault columns (its row maxima feed the search's
// bound) and takes liveness in dada_place instead; HEFT reads the full rows.
//
// Bit-exact f64 in the reference's op order. Every fold runs in CSR order
// from +0.0, one (i, u) entry per thread, with no atomics and no split of a
// fold. Additions, the product and the division are written as
// __dadd_rn / __dmul_rn / __ddiv_rn, so no contraction into an FMA can move
// a bit; the build must not use --use_fast_math.
//
// What bounds it on an H100. An activation of the main path (n <= 128 ready
// tasks, a few reads and writes each, 9 memories, 14 resources) reads a few
// tens of KB and writes a few tens of KB: tens of nanoseconds of HBM time at
// 3.35 TB/s. In practice one launch and the copies around it (a few
// microseconds each) set the time. So the design minimises launches and
// copies, not operations: the caller packs an activation's CSR rows into one
// buffer (8-byte slots, offsets in the order of sched_score.py's sections),
// copies it to the card once, launches this kernel once and copies its one
// output buffer back once. One warp per ready task; its lanes stride over
// the unique memories (any n_u up to 63) and then over the resources, X_u
// and S_u pass through shared memory to the gather, and the row maxima are
// warp shuffles.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;   // ready tasks per block
constexpr int kMaxU = 64;   // unique memories held in shared memory (n_u <= 63)

// flags of one activation (sched_score.py's FLAG_*)
constexpr int kWantX = 1, kXRows = 2, kBias = 4, kWantS = 8, kAccelOnly = 16, kWantC = 32,
              kSMissing = 64;

// Slot offsets of each section, in the order of sched_score.py's
// IN_SECTIONS + MACHINE_SECTIONS + OUT_SECTIONS.
struct Layout {
  int64_t r_indptr, r_masks, r_sizes, w_indptr, w_masks, w_weights, p_cpu, p_gpu, x_bias;
  int64_t latency, bandwidth, mem_shift, host_col, col_of, accel_res;
  int64_t c, x, x_max, s;
};

// One step of the transfer fold: acc + hops(m, u) * p.
__device__ __forceinline__ double hop_fold(double acc, int64_t m, int64_t shift, bool host_col,
                                           double p) {
  const bool skip = (m == 0) || ((m >> shift) & 1);
  const double hops = skip ? 0.0 : ((host_col || (m & 1)) ? 1.0 : 2.0);
  return __dadd_rn(acc, __dmul_rn(hops, p));
}

__global__ void transfer_matrix_kernel(const int64_t* __restrict__ masks,
                                       const double* __restrict__ per_read,
                                       const int64_t* __restrict__ mem_shift,
                                       const bool* __restrict__ host_col,
                                       double* __restrict__ out, int n, int r,
                                       int n_u) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * n_u) return;
  const int i = idx / n_u;
  const int u = idx - i * n_u;
  const int64_t shift = mem_shift[u];
  const bool hc = host_col[u];
  const int64_t* row_m = masks + static_cast<int64_t>(i) * r;
  const double* row_p = per_read + static_cast<int64_t>(i) * r;
  double acc = 0.0;
  for (int k = 0; k < r; ++k) acc = hop_fold(acc, row_m[k], shift, hc, row_p[k]);
  out[idx] = acc;
}

__global__ void __launch_bounds__(kWarps * 32)
score_activation_kernel(const int64_t* __restrict__ in, const int64_t* __restrict__ mach,
                        double* __restrict__ out, Layout L, int n, int n_u, int n_res,
                        int flags) {
  __shared__ double xs[kWarps][kMaxU];
  __shared__ double ss[kWarps][kMaxU];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n) return;  // uniform across the warp; the block never synchronises
  const double* in_f = reinterpret_cast<const double*>(in);
  const double* mach_f = reinterpret_cast<const double*>(mach);
  const int64_t* mem_shift = mach + L.mem_shift;
  const int64_t* host_col = mach + L.host_col;
  const bool want_x = flags & kWantX, want_s = flags & kWantS;

  if (want_x) {  // X_u[i, :] over task i's reads
    const double latency = mach_f[L.latency];
    const double bandwidth = mach_f[L.bandwidth];
    const int64_t begin = in[L.r_indptr + i], end = in[L.r_indptr + i + 1];
    for (int u = lane; u < n_u; u += 32) {
      const int64_t shift = mem_shift[u];
      const bool hc = host_col[u] != 0;
      double acc = 0.0;
      for (int64_t k = begin; k < end; ++k) {
        const double size = in_f[L.r_sizes + k];
        const double p = size <= 0.0 ? 0.0 : __dadd_rn(latency, __ddiv_rn(size, bandwidth));
        acc = hop_fold(acc, in[L.r_masks + k], shift, hc, p);
      }
      xs[warp][u] = acc;
    }
  }
  if (want_s) {  // S_u[i, :] over task i's accesses (its reads under kSMissing)
    const bool missing = flags & kSMissing;
    const int64_t begin = in[L.w_indptr + i], end = in[L.w_indptr + i + 1];
    for (int u = lane; u < n_u; u += 32) {
      const int64_t shift = mem_shift[u];
      const bool hc = host_col[u] != 0;
      double acc = 0.0;
      for (int64_t k = begin; k < end; ++k) {
        const int64_t m = in[L.w_masks + k];
        const double w = in_f[L.w_weights + k];
        if (missing) {
          acc = hop_fold(acc, m, shift, hc, w);
        } else {
          acc = __dadd_rn(acc, ((m >> shift) & 1) ? w : 0.0);
        }
      }
      ss[warp][u] = missing ? -acc : acc;
    }
  }
  __syncwarp();

  // gather to resources: X, S and C of row i
  const int64_t* col_of = mach + L.col_of;
  const int64_t* accel_res = mach + L.accel_res;
  const bool x_rows = flags & kXRows, bias = flags & kBias;
  const bool accel_only = flags & kAccelOnly, want_c = flags & kWantC;
  const int64_t row = static_cast<int64_t>(i) * n_res;
  double row_max = -INFINITY;
  for (int r = lane; r < n_res; r += 32) {
    const int64_t u = col_of[r];
    const bool accel = accel_res[r] != 0;
    double x = 0.0;
    if (want_x) {
      x = xs[warp][u];
      if (bias) x = __dadd_rn(x, in_f[L.x_bias + row + r]);
      if (x_rows) out[L.x + row + r] = x;
      else row_max = fmax(row_max, x);
    }
    if (want_s) out[L.s + row + r] = (accel_only && !accel) ? 0.0 : ss[warp][u];
    if (want_c) {
      const double base = accel ? in_f[L.p_gpu + i] : in_f[L.p_cpu + i];
      out[L.c + row + r] = want_x ? __dadd_rn(base, x) : base;
    }
  }
  if (want_x && !x_rows) {  // max is order-free
    for (int off = 16; off > 0; off >>= 1)
      row_max = fmax(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
    if (lane == 0) out[L.x_max + i] = row_max;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`, does
// not synchronize, and returns cudaGetLastError() of the launch (0 = success).
extern "C" int repro_transfer_matrix(const void* masks, const void* per_read,
                                     const void* mem_shift,
                                     const void* host_col, void* out, int n,
                                     int r, int n_u, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n * n_u;
  if (total <= 0) return 0;
  const int block = 128;
  const int grid = (total + block - 1) / block;
  transfer_matrix_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(masks),
      static_cast<const double*>(per_read),
      static_cast<const int64_t*>(mem_shift),
      static_cast<const bool*>(host_col), static_cast<double*>(out), n, r,
      n_u);
  return static_cast<int>(cudaGetLastError());
}

// `layout` is a host array of the 19 slot offsets of struct Layout.
extern "C" int repro_score_activation(const void* in, const void* mach, void* out,
                                      const int64_t* layout, int n, int n_u, int n_res,
                                      int flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (n_u < 1 || n_u > kMaxU - 1) return static_cast<int>(cudaErrorInvalidValue);
  Layout L;
  std::memcpy(&L, layout, sizeof(L));
  const int grid = (n + kWarps - 1) / kWarps;
  score_activation_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(in), static_cast<const int64_t*>(mach),
      static_cast<double*>(out), L, n, n_u, n_res, flags);
  return static_cast<int>(cudaGetLastError());
}
