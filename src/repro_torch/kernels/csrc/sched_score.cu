// Transfer-time fold of the placement scorer, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/sched_score.py:121
// (transfer_matrix_pallas, body _xfer_kernel :95). For every (ready task i,
// unique memory u):
//
//     X[i, u] = sum over reads r, in order, of hops(mask[i, r], u) * per_read[i, r]
//
// where mask is the full int64 residency mask of the read's datum (bit 0:
// a host copy exists; bit mem+1: a valid copy in device memory mem) and
// hops is the paper-era PCIe path length: 0 if the datum is resident at u
// or exists nowhere yet (mask 0, which is also every padded read); 1 if u
// is the host or a host copy exists; 2 otherwise (device -> host -> device).
//
// Design. One thread per output element; each thread folds its reads in
// order, starting from +0.0, in f64. The in-order fold is the bit-for-bit
// contract with the reference, so there are no atomics and no split of the
// read loop. hops is 0, 1 or 2, so hops * per_read is exact and contracting
// the update into an FMA cannot change a bit; the build must not use
// --use_fast_math (per_read is computed with IEEE division by the caller).
//
// What bounds it on an H100. At the main path's shapes (n <= 128 padded
// tasks, r <= 4 padded reads, n_u = 9 memories) a call reads about
// 8 KiB of masks and read times and writes 9 KiB: under 10 ns of HBM time
// at 3.35 TB/s. The launch itself (a few microseconds) is the bound, so the
// kernel is kept to one small grid and no shared memory; amortizing the
// launch (a CUDA graph, or fusing the rest of the scoring) is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

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
  for (int k = 0; k < r; ++k) {
    const int64_t m = row_m[k];
    const bool skip = (m == 0) || ((m >> shift) & 1);
    const double hops = skip ? 0.0 : ((hc || (m & 1)) ? 1.0 : 2.0);
    acc = acc + hops * row_p[k];
  }
  out[idx] = acc;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronize, and returns cudaGetLastError() of the launch (0 = success).
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
