// The selective scan of a Mamba block, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: its counterpart is the lax.scan of the
// per-token step at repro/models/mamba.py:82 (step :82-88, run by
// chunked_scan, repro/models/recurrent.py:14). For every batch row b and
// channel c, in f32:
//
//     h <- h0[b, c, :]
//     for t in 0 .. S-1:
//         a_bar    = exp(dt[b, t, c] * A[c, :])
//         h        = a_bar * h + (dt[b, t, c] * x[b, t, c]) * B[b, t, :]
//         y[b,t,c] = sum_n h[n] * C[b, t, n]
//     hT[b, c, :] <- h
//
// dt and x are (batch, S, din), B and C (batch, S, N), A (din, N), h0 and
// hT (batch, din, N), y (batch, S, din); all f32 and contiguous. N is 16,
// the one state size of the repo's Mamba configs, and the kernel is built
// for it alone. The same kernel runs a prefill (h0 zeros) and a decode step
// (S 1, h0 the state).
// expf is the accurate one: the library is built without fast math.
//
// What bounds it on an H100: bytes. At the main path's prefill (jamba:
// batch 4, S 2048, din 8192, N 16) it reads 537 MB of dt and x and 1 MB of
// B and C and writes 268 MB of y: 0.24 ms at 3.35 TB/s. Its 1.07e9
// exponentials and about 7.5e9 other f32 operations take about 0.11 ms at
// the card's 67 TFLOP/s outside the tensor cores.
//
// Design: a simple kernel, right first. The recurrence runs along t, so the
// parallel axes are (b, c, n). One thread a (b, c) would give only 32 768
// threads at the main path's shape, about 8 warps an SM; one thread a
// (b, c, n) would spend as many shuffles on y's sum as on the state update.
// Here LANES = 4 neighbouring lanes share a channel, each holding 4 of its
// 16 states (and their A) in registers for the whole sequence, and y's sum over
// n is a two-step shuffle within the four lanes: 131 072 threads at the main
// path's shape, about 31 warps an SM. A block of 256 threads takes 64
// channels of one batch row; for each run of 32 time steps it stages dt and
// x of its 64 channels and the rows of B and C in shared memory (coalesced
// loads, the ragged ends of S and din masked), then steps through them. A
// warp writes y for 8 neighbouring channels at a time (one 32-byte sector).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LANES = 4;               // lanes that share one channel
constexpr int CH = 64;                 // channels a block
constexpr int THREADS = CH * LANES;    // 256
constexpr int T_CHUNK = 32;            // time steps staged at a time
constexpr int NS = 4;                  // states a lane: N = NS * LANES = 16

__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                      const float* __restrict__ bm, const float* __restrict__ cm,
                      const float* __restrict__ a_mat, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_out, int S, int din) {
  constexpr int N = NS * LANES;
  __shared__ float dt_s[T_CHUNK][CH];
  __shared__ float x_s[T_CHUNK][CH];
  __shared__ float b_s[T_CHUNK][N];
  __shared__ float c_s[T_CHUNK][N];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int cl = threadIdx.x / LANES;  // the block's channel
  const int lane = threadIdx.x % LANES;
  const int c = c0 + cl;
  const bool live = c < din;
  const int n0 = lane * NS;

  float a[NS], h[NS];
  const long long h_off = (static_cast<long long>(b) * din + c) * N + n0;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    a[k] = live ? a_mat[static_cast<long long>(c) * N + n0 + k] : 0.0f;
    h[k] = live ? h0[h_off + k] : 0.0f;
  }

  const long long row0 = static_cast<long long>(b) * S;  // row of (b, t = 0)
  for (int t0 = 0; t0 < S; t0 += T_CHUNK) {
    const int tn = min(T_CHUNK, S - t0);
    __syncthreads();  // the last run's reads are done
    for (int i = threadIdx.x; i < T_CHUNK * CH; i += THREADS) {
      const int tt = i / CH, cc = i % CH;
      const bool ok = tt < tn && c0 + cc < din;
      const long long off = (row0 + t0 + tt) * din + c0 + cc;
      dt_s[tt][cc] = ok ? dt[off] : 0.0f;
      x_s[tt][cc] = ok ? x[off] : 0.0f;
    }
    for (int i = threadIdx.x; i < T_CHUNK * N; i += THREADS) {
      const int tt = i / N, nn = i % N;
      const bool ok = tt < tn;
      const long long off = (row0 + t0 + tt) * N + nn;
      b_s[tt][nn] = ok ? bm[off] : 0.0f;
      c_s[tt][nn] = ok ? cm[off] : 0.0f;
    }
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      const float d = dt_s[tt][cl];
      const float dx = d * x_s[tt][cl];
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const float a_bar = expf(d * a[k]);
        const float bx = dx * b_s[tt][n0 + k];
        h[k] = a_bar * h[k] + bx;
        acc += h[k] * c_s[tt][n0 + k];
      }
      // every lane of the warp takes part: tn is the same for the block
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (live && lane == 0) y[(row0 + t0 + tt) * din + c] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < NS; ++k) h_out[h_off + k] = h[k];
  }
}

}  // namespace

// Returns 0 or the CUDA error of the launch. n_state must be 16 (every
// Mamba config of the repo: jamba, its smoke and narrow test configs);
// batch at most 65 535.
extern "C" int repro_selective_scan(const void* dt, const void* x, const void* bm, const void* cm,
                                    const void* a_mat, const void* h0, void* y, void* h_out,
                                    int batch, int S, int din, int n_state, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || batch > 65535 || S <= 0 || din <= 0 || n_state != NS * LANES)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((din + CH - 1) / CH, batch);
  selective_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dt), static_cast<const float*>(x), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(a_mat),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(h_out), S, din);
  return static_cast<int>(cudaGetLastError());
}
