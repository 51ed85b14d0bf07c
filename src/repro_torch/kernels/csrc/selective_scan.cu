// The selective scan of a Mamba block, for Hopper (sm_90a): the fused Mamba
// scan and the plain f32 scan, one templated kernel.
//
// Replaces no Pallas kernel: its counterpart is the lax.scan of the
// per-token step at repro/models/mamba.py:82-98 (step :82-88, run by
// chunked_scan, repro/models/recurrent.py:14), with what mamba_apply does
// around it (:79-80 before, :99-100 after). For every batch row b and
// channel c, h <- the state (or zeros), then for t in 0 .. S-1:
//
//     dt    = softplus(dt_pre[b, t, c] + dt_bias[c])    (each rounded to E)
//     A[n]  = -exp(a_log[c, n])                         (rounded to E)
//     h[n]  = exp(dt A[n]) h[n] + (dt x[b, t, c]) B[b, t, n]       (f32)
//     y     = sum_n h[n] C[b, t, n] + x[b, t, c] d_skip[c]        (f32)
//     g[b, t, c] = E(E(y) * E(silu(z[b, t, c])))
//
// E is the compute dtype (f32 or bf16): every value is read in E and widened
// in the kernel, where mamba_apply made f32 copies. The rounding points are
// PyTorch's: softplus with its threshold of 20, the skip as a product and a
// sum each rounded (__fmul_rn, __fadd_rn, never one FMA), silu as
// z / (1 + exp(-z)) (its division the fast one, within 2 ulp). A decode
// step writes the new state in place, into the state it read: each thread
// reads its own states before it writes them. A prefill starts from zeros
// and writes no state.
//
// The plain f32 instantiation (FUSED false) is the same kernel with the
// prologue and the epilogue off: dt, x, B, C, A and h0 in f32, y = sum_n
// h[n] C[n] and hT out (repro_selective_scan, selective_scan's contract).
//
// What bounds it on an H100: its operations. At jamba's prefill (batch 4,
// S 2048, din 8192, N 16) it takes 1.07e9 exponentials of the recurrence
// and 3 more special-function results a (b, t, c) (softplus's and silu's
// exp, silu's reciprocal; softplus's log1p is a polynomial on the FMA
// pipe): 1.28e9 at 16 a clock and SM (132 SMs, 1.98 GHz: 4.18e12 a second)
// is 0.305 ms, beside 6.8e9 other f32 flop, 0.10 ms at 67 TFLOP/s. With
// about 7 of each (b, t, c)'s 18 exponentials moved onto the FMA pipe (a
// range reduction and a degree-5 polynomial, 13 flop each) the two pipes
// balance at 0.193 ms. Its bytes (dt_pre, x, z and g in bf16, 134 MB each;
// B, C 0.5 MB) take 0.16 ms at 3.35 TB/s. This kernel runs every
// exponential on the special-function unit.
//
// Design:
//   * one thread a channel, its 16 states and A log2(e) in registers for
//     the whole sequence: no shuffles, and the per-(b, t, c) prologue and
//     epilogue run once, by the thread that owns the channel;
//   * a_bar = ex2(dt * A log2 e): one multiply and one MUFU.EX2 a state;
//   * each warp stages its own 32 channels, with no block barrier: a ring
//     of STAGES runs of RUN steps (dt_pre, x, z and the B | C row) filled by
//     16-byte cp.async copies, run k + 2 in flight while run k steps; the
//     rows of B and C are widened to f32 once a run (bf16), then read as
//     16-byte broadcast loads;
//   * the inner loop unrolled over a compile-time run length;
//   * g goes into the z tile it replaces (f32 y into dt's) and leaves as
//     whole 16-byte rows once a run;
//   * views with 16-byte rows (jamba's, every dtype) take the copies;
//     others (ragged din, unaligned offsets) are staged element by element.
// Four warps a block; at jamba's prefill 1 024 warps, 8 an SM (every
// block resident at once); see repro_scan_plan for the occupancy.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N = 16;                  // states a channel
constexpr int WARPS = 4;               // warps a block, 32 channels each
constexpr int THREADS = 32 * WARPS;    // 128
constexpr int CH = THREADS;            // channels a block
constexpr int STAGES = 3;              // runs in the ring
constexpr int TILES = 4;               // dt, x, z, B | C
constexpr float LOG2E = 1.4426950408889634f;

// steps a run: a tile of 32 channels is 1 KB, in either dtype
template <typename E>
__host__ __device__ constexpr int run_len() { return 32 / static_cast<int>(sizeof(E)); }

template <typename E>
__host__ __device__ constexpr int slot_elems() { return TILES * run_len<E>() * 32; }

// a warp's shared memory: the ring, then (bf16) the run's B | C rows in f32
template <typename E>
__host__ __device__ constexpr int warp_bytes() {
  return STAGES * slot_elems<E>() * static_cast<int>(sizeof(E)) +
         (sizeof(E) == 4 ? 0 : run_len<E>() * 32 * 4);
}

struct View {             // a (batch, S, channels) view with unit channel stride
  const void* p;
  long long sb, st;       // batch and time strides, in elements
};

struct Params {
  View dt, x, z, b, c;
  const void* a;          // (din, N): a_log (fused) or A (f32)
  const void* dt_bias;    // (din,), fused only
  const void* d_skip;     // (din,), fused only
  const float* h_in;      // (batch, din, N) or null: zeros
  float* h_out;           // (batch, din, N) or null: not written
  void* out;              // (batch, S, din), contiguous: g or y
  int S, din;
  int vec;                // every staged view and out in 16-byte rows
  int hvec;               // the states 16-byte aligned
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename E>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<E>(v)); }

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// Stage run [t0, t0 + RUN) of the warp's channels [c0, c0 + 32) into slot:
// tiles [RUN][32] of dt, x, z and of B | C (a row B's 16 then C's 16). Rows
// past S and channels past din are zeros.
template <typename E, bool FUSED>
__device__ __forceinline__ void stage(const Params& p, E* slot, int b, int t0, int c0, int lane) {
  constexpr int RUN = run_len<E>();
  constexpr int CPE = 16 / static_cast<int>(sizeof(E));  // elements a 16-byte chunk
  constexpr int CPR = 32 / CPE;                          // chunks a tile row
  constexpr int NQ = FUSED ? 3 : 2;
  if (p.vec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // RUN * CPR = 64 chunks a tile, two a lane
      const int k = lane + 32 * i;
      const int r = k / CPR, j = k % CPR;
      const int t = t0 + r;
      const bool row_ok = t < p.S;
      const bool ok = row_ok && c0 + j * CPE < p.din;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const View& v = q == 0 ? p.dt : q == 1 ? p.x : p.z;
        const E* src = static_cast<const E*>(v.p) +
                       (ok ? b * v.sb + t * v.st + c0 + j * CPE : 0);
        cp16(slot + (q * RUN + r) * 32 + j * CPE, src, ok);
      }
      const bool is_b = j < CPR / 2;
      const View& v = is_b ? p.b : p.c;
      const int jj = is_b ? j : j - CPR / 2;
      const E* src = static_cast<const E*>(v.p) + (row_ok ? b * v.sb + t * v.st + jj * CPE : 0);
      cp16(slot + (3 * RUN + r) * 32 + j * CPE, src, row_ok);
    }
  } else {
    const E zero = from_f<E>(0.0f);
    for (int i = lane; i < RUN * 32; i += 32) {
      const int r = i / 32, cc = i % 32;
      const int t = t0 + r;
      const bool row_ok = t < p.S;
      const bool ok = row_ok && c0 + cc < p.din;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const View& v = q == 0 ? p.dt : q == 1 ? p.x : p.z;
        slot[(q * RUN + r) * 32 + cc] =
            ok ? static_cast<const E*>(v.p)[b * v.sb + t * v.st + c0 + cc] : zero;
      }
      const View& v = cc < N ? p.b : p.c;
      slot[(3 * RUN + r) * 32 + cc] =
          row_ok ? static_cast<const E*>(v.p)[b * v.sb + t * v.st + cc % N] : zero;
    }
  }
}

// The steps of one run for this lane's channel; FULL: all RUN of them. In
// three passes over the run, each free of branches, so that the compiler
// can interleave its steps: the steps' dt (softplus) and x; the
// recurrence, whose steps depend on each other only through h; the skip
// and the gate.
template <typename E, bool FUSED, bool FULL>
__device__ __forceinline__ void steps(E* slot, const float* bcf, int tn, int lane,
                                      float (&h)[N], const float (&a2)[N], float bias,
                                      float dskip) {
  constexpr int RUN = run_len<E>();
  const E* dt_t = slot;
  const E* x_t = slot + RUN * 32;
  E* z_t = slot + 2 * RUN * 32;
  E* out_t = FUSED ? z_t : slot;  // g replaces z, y replaces dt
  float dv[RUN], xv[RUN], yv[RUN];
#pragma unroll
  for (int tt = 0; tt < RUN; ++tt) {
    if (!FULL && tt >= tn) break;
    float d = to_f(dt_t[tt * 32 + lane]);
    if constexpr (FUSED) {
      const float v = round_to<E>(d + bias);
      const float sp = log1pf(expf(v));  // computed either way: a select, no branch
      d = round_to<E>(v > 20.0f ? v : sp);
    }
    dv[tt] = d;
    xv[tt] = to_f(x_t[tt * 32 + lane]);
  }
#pragma unroll
  for (int tt = 0; tt < RUN; ++tt) {
    if (!FULL && tt >= tn) break;
    const float4* bc = reinterpret_cast<const float4*>(bcf + tt * 32);
    const float d = dv[tt], dx = d * xv[tt];
    float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 bq = bc[q], cq = bc[N / 4 + q];
      const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
      const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 4 * q + k;
        h[n] = fmaf(ex2(d * a2[n]), h[n], dx * bv[k]);
        if (k & 1) acc1 = fmaf(h[n], cv[k], acc1);
        else acc0 = fmaf(h[n], cv[k], acc0);
      }
    }
    yv[tt] = acc0 + acc1;
  }
#pragma unroll
  for (int tt = 0; tt < RUN; ++tt) {
    if (!FULL && tt >= tn) break;
    if constexpr (FUSED) {
      const float y = __fadd_rn(yv[tt], __fmul_rn(xv[tt], dskip));
      const float zf = to_f(z_t[tt * 32 + lane]);
      // z / (1 + exp(-z)) with the fast division (2 ulp): IEEE division's
      // slow path is a call and a branch on every step
      const float gate = round_to<E>(__fdividef(zf, 1.0f + expf(-zf)));
      out_t[tt * 32 + lane] = from_f<E>(round_to<E>(y) * gate);
    } else {
      out_t[tt * 32 + lane] = from_f<E>(yv[tt]);
    }
  }
}

template <typename E, bool FUSED>
__global__ void __launch_bounds__(THREADS) mamba_scan_kernel(const Params p) {
  constexpr int RUN = run_len<E>();
  constexpr int CPE = 16 / static_cast<int>(sizeof(E));
  constexpr int CPR = 32 / CPE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int c0 = (blockIdx.x * WARPS + warp) * 32;
  if (c0 >= p.din) return;  // no block barrier: a warp past din leaves
  const int c = c0 + lane;
  const bool live = c < p.din;
  unsigned char* mine = smem + warp * warp_bytes<E>();
  E* ring = reinterpret_cast<E*>(mine);
  float* bc_f32 = reinterpret_cast<float*>(mine + STAGES * slot_elems<E>() * sizeof(E));

  const int runs = (p.S + RUN - 1) / RUN;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < runs) stage<E, FUSED>(p, ring + s * slot_elems<E>(), b, s * RUN, c0, lane);
    cp_commit();
  }

  float a2[N], h[N];
  float bias = 0.0f, dskip = 0.0f;
  const long long h_off = (static_cast<long long>(b) * p.din + c) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float a = 0.0f;
    if (live) {
      if constexpr (FUSED)
        a = -round_to<E>(expf(to_f(static_cast<const E*>(p.a)[c * N + n])));
      else
        a = static_cast<const float*>(p.a)[c * N + n];
    }
    a2[n] = a * LOG2E;
  }
  if (live && p.h_in != nullptr && p.hvec) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p.h_in + h_off)[q];
      h[4 * q] = v.x, h[4 * q + 1] = v.y, h[4 * q + 2] = v.z, h[4 * q + 3] = v.w;
    }
  } else if (live && p.h_in != nullptr) {
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = p.h_in[h_off + n];
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = 0.0f;
  }
  if constexpr (FUSED) {
    if (live) {
      bias = to_f(static_cast<const E*>(p.dt_bias)[c]);
      dskip = to_f(static_cast<const E*>(p.d_skip)[c]);
    }
  }

  E* out = static_cast<E*>(p.out);
  for (int k = 0; k < runs; ++k) {
    cp_wait<STAGES - 2>();  // this lane's copies of run k have landed
    __syncwarp();           // and every lane's; run k - 1 is written out
    {
      const int nxt = k + STAGES - 1;
      if (nxt < runs)
        stage<E, FUSED>(p, ring + (nxt % STAGES) * slot_elems<E>(), b, nxt * RUN, c0, lane);
      cp_commit();
    }
    E* slot = ring + (k % STAGES) * slot_elems<E>();
    const float* bcf;
    if constexpr (sizeof(E) == 4) {
      bcf = reinterpret_cast<const float*>(slot + 3 * RUN * 32);
    } else {  // widen the run's B | C rows once: 8 values a 16-byte chunk
      const uint4* raw = reinterpret_cast<const uint4*>(slot + 3 * RUN * 32);
      float4* dst = reinterpret_cast<float4*>(bc_f32);
#pragma unroll
      for (int i = 0; i < RUN * 32 / 8 / 32; ++i) {
        const int k8 = lane + 32 * i;
        const uint4 u = raw[k8];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        float f[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[2 * e] = __uint_as_float(w[e] << 16);
          f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
        }
        dst[2 * k8] = make_float4(f[0], f[1], f[2], f[3]);
        dst[2 * k8 + 1] = make_float4(f[4], f[5], f[6], f[7]);
      }
      __syncwarp();
      bcf = bc_f32;
    }
    const int t0 = k * RUN;
    const int tn = min(RUN, p.S - t0);
    if (tn == RUN)
      steps<E, FUSED, true>(slot, bcf, tn, lane, h, a2, bias, dskip);
    else
      steps<E, FUSED, false>(slot, bcf, tn, lane, h, a2, bias, dskip);
    __syncwarp();
    const E* out_t = FUSED ? slot + 2 * RUN * 32 : slot;
    if (p.vec) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k16 = lane + 32 * i;
        const int r = k16 / CPR, j = k16 % CPR;
        if (r < tn && c0 + j * CPE < p.din)
          *reinterpret_cast<uint4*>(out + (static_cast<long long>(b) * p.S + t0 + r) * p.din +
                                    c0 + j * CPE) =
              *reinterpret_cast<const uint4*>(out_t + r * 32 + j * CPE);
      }
    } else {
      for (int i = lane; i < tn * 32; i += 32) {
        const int r = i / 32, cc = i % 32;
        if (c0 + cc < p.din)
          out[(static_cast<long long>(b) * p.S + t0 + r) * p.din + c0 + cc] = out_t[r * 32 + cc];
      }
    }
  }
  cp_wait<0>();
  if (live && p.h_out != nullptr && p.hvec) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p.h_out + h_off)[q] =
          make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  } else if (live && p.h_out != nullptr) {
#pragma unroll
    for (int n = 0; n < N; ++n) p.h_out[h_off + n] = h[n];
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

bool view_rows16(const View& v, int esize) {
  return aligned16(v.p) && (v.sb * esize) % 16 == 0 && (v.st * esize) % 16 == 0;
}

template <typename E, bool FUSED>
int set_smem(int device) {
  static bool ready[64] = {};
  if (device >= 0 && device < 64 && ready[device]) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(mamba_scan_kernel<E, FUSED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, WARPS * warp_bytes<E>());
  if (err == cudaSuccess && device >= 0 && device < 64) ready[device] = true;
  return static_cast<int>(err);
}

template <typename E, bool FUSED>
int launch(Params p, int batch, int device, void* stream) {
  const int esize = static_cast<int>(sizeof(E));
  p.vec = view_rows16(p.dt, esize) && view_rows16(p.x, esize) && view_rows16(p.b, esize) &&
          view_rows16(p.c, esize) && (!FUSED || view_rows16(p.z, esize)) && aligned16(p.out) &&
          (p.din * esize) % 16 == 0;
  p.hvec = (p.h_in == nullptr || aligned16(p.h_in)) && (p.h_out == nullptr || aligned16(p.h_out));
  int err = set_smem<E, FUSED>(device);
  if (err != 0) return err;
  dim3 grid((p.din + CH - 1) / CH, batch);
  mamba_scan_kernel<E, FUSED><<<grid, THREADS, WARPS * warp_bytes<E>(),
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, bool FUSED>
int plan(int device, int* smem_bytes, int* blocks_per_sm, int* run) {
  *smem_bytes = WARPS * warp_bytes<E>();
  *run = run_len<E>();
  const int err = set_smem<E, FUSED>(device);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, mamba_scan_kernel<E, FUSED>, THREADS, *smem_bytes));
}

}  // namespace

// selective_scan's contract: dt, x (batch, S, din), B, C (batch, S, N), A
// (din, N), h0 and hT (batch, din, N), y (batch, S, din); all f32 and
// contiguous. Returns 0 or the CUDA error of the launch. n_state must be
// 16 (every Mamba config of the repo); batch at most 65 535.
extern "C" int repro_selective_scan(const void* dt, const void* x, const void* bm, const void* cm,
                                    const void* a_mat, const void* h0, void* y, void* h_out,
                                    int batch, int S, int din, int n_state, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || batch > 65535 || S <= 0 || din <= 0 || n_state != N)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long sd = static_cast<long long>(S) * din, sn = static_cast<long long>(S) * N;
  Params p{View{dt, sd, din}, View{x, sd, din}, View{nullptr, 0, 0}, View{bm, sn, N},
           View{cm, sn, N}, a_mat, nullptr, nullptr, static_cast<const float*>(h0),
           static_cast<float*>(h_out), y, S, din, 0, 0};
  return launch<float, false>(p, batch, device, stream);
}

// The fused Mamba scan: dt_pre, x, z (batch, S, din) and B, C (batch, S,
// N) in the compute dtype (bf16 when bf16 != 0, else f32), unit stride
// along their last axis, batch and time strides in `strides` (elements:
// dt, x, z, B, C, two each); a_log (din, N), dt_bias and d_skip (din,)
// contiguous in the compute dtype; state (batch, din, N) f32 contiguous,
// read and written in place, or null (a prefill from zeros); g (batch, S,
// din) contiguous in the compute dtype.
extern "C" int repro_mamba_scan(const void* dt_pre, const void* x, const void* z, const void* bm,
                                const void* cm, const void* a_log, const void* dt_bias,
                                const void* d_skip, void* state, void* g,
                                const long long* strides, int batch, int S, int din,
                                int n_state, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || batch > 65535 || S <= 0 || din <= 0 || n_state != N)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{View{dt_pre, strides[0], strides[1]}, View{x, strides[2], strides[3]},
           View{z, strides[4], strides[5]}, View{bm, strides[6], strides[7]},
           View{cm, strides[8], strides[9]}, a_log, dt_bias, d_skip,
           static_cast<const float*>(state), static_cast<float*>(state), g, S, din, 0, 0};
  return bf16 ? launch<__nv_bfloat16, true>(p, batch, device, stream)
              : launch<float, true>(p, batch, device, stream);
}

// The launch plan of an instantiation (0: the f32 scan, 1: the fused scan
// in f32, 2: in bf16): threads a block, dynamic shared memory a block,
// blocks an SM can hold, steps a run. Returns 0 or a CUDA error.
extern "C" int repro_scan_plan(int kind, int device, int* threads, int* smem_bytes,
                               int* blocks_per_sm, int* run) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = THREADS;
  switch (kind) {
    case 0: return plan<float, false>(device, smem_bytes, blocks_per_sm, run);
    case 1: return plan<float, true>(device, smem_bytes, blocks_per_sm, run);
    case 2: return plan<__nv_bfloat16, true>(device, smem_bytes, blocks_per_sm, run);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
