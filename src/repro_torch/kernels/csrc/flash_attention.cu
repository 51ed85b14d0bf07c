// GQA prefill attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:71
// (flash_attention, body _flash_kernel :28):
//
//     o[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h / group, j, :]) @ v[b, h / group, :, :]
//
// with the bottom-right causal mask j <= i + (sk - sq) (masked logits
// -1e30, as the reference), logits, softmax and the P.V sum in f32, and the
// result cast to q's type with round-to-nearest. Inputs are f32 or bf16
// (all three alike). q and k have the head dim dk <= 256, v and o a value
// head dim dv <= dk of their own (MLA's values are narrower than its queries
// and keys): tiles are sized for dk, and V's columns past dv are zeros that
// are never stored. Every operand has unit stride along its head dim and
// its own batch, head and sequence strides (in elements), so the model's
// (B, S, H, d) projections go in as (B, H, S, d) views with no copy; the
// output is written through its own strides. GQA is index arithmetic: query
// head h reads KV head h / group, and no K/V is repeated. Ragged sq and sk
// are masked here: query rows past sq are computed and not stored, keys past
// sk get a logit of -inf (they add exactly 0) and are loaded as zeros.
//
// What bounds it on an H100. For the chatglm3-6b prefill (B 4, 32 query
// heads, 2 KV heads, S 2048, d 128, causal) one layer does 1.4e11 flop on
// 8.4e7 bytes of q, k, v and o: 1600 flop per byte, far above the card's
// ~20 (f32 SIMT) or ~295 (bf16 tensor cores) flop per byte, so operations
// bound it: 0.14 ms at the 989 TFLOP/s bf16 tensor-core peak. This kernel
// runs on the CUDA cores in f32 (67 TFLOP/s peak), so at best 2.1 ms a
// layer; shared-memory reads, not device memory, set its pace.
//
// Design: a simple kernel, right first. One block of 256 threads per
// (query tile of 64 rows, query head, batch). Q's tile is staged in shared
// memory once (f32, d-major); K and V tiles of 64 keys stream through shared
// memory; a causal block stops at the last key tile its rows can see. Each
// thread holds a 4 x 4 micro-tile of the 64 x 64 logit tile (rows ty*4..,
// keys tx*4..), so a row's 64 logits live in the 16 lanes of one half-warp,
// which reduce its max and sum with shuffles. P goes through shared memory
// (key-major) into the P.V product, where each thread owns 4 rows and d/16
// output columns in float4 chunks. The running max, normalizer and
// accumulator follow the reference's update order: m_new = max(m, rowmax),
// p = exp(s - m_new), alpha = exp(m - m_new), l = l * alpha + sum p,
// acc = acc * alpha + p @ v, and o = acc / l at the end. expf and IEEE
// division throughout (no --use_fast_math). Tensor cores (wgmma on bf16
// tiles, TMA loads, a producer warp) are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16: tx over keys / output columns, ty over rows
constexpr int PAD = 4;       // row padding of the d-major tiles (keeps float4 alignment)
constexpr float MASKED = -1e30f;  // the reference's masked logit

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Strides {
  long long b, h, s;  // batch, head, sequence (elements); d has stride 1
};

template <int DMAX>
constexpr size_t smem_bytes() {
  // Qt[DMAX][BQ+PAD], Kt[DMAX][BK+PAD], Vs[BK][DMAX], Pt[BK][BQ+PAD]
  return sizeof(float) *
         (DMAX * (BQ + PAD) + DMAX * (BK + PAD) + BK * DMAX + BK * (BQ + PAD));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq, int group,
                       int sq, int sk, int d, int dv, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                         // [DMAX][BQ+PAD], d-major
  float* Kt = Qt + DMAX * (BQ + PAD);       // [DMAX][BK+PAD], d-major
  float* Vs = Kt + DMAX * (BK + PAD);       // [BK][DMAX], key-major
  float* Pt = Vs + BK * DMAX;               // [BK][BQ+PAD], key-major

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int offset = sk - sq;  // bottom-right causal alignment
  constexpr int NC = DMAX / 64;  // float4 chunks of output columns per thread

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int idx = tid; idx < BQ * DMAX; idx += THREADS) {
    const int r = idx / DMAX, c = idx % DMAX;
    Qt[c * (BQ + PAD) + r] = (q0 + r < sq && c < d) ? to_f32(qb[(q0 + r) * qs.s + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.0f;
  }

  // keys a causal block can see: j <= (q0 + BQ - 1) + offset
  int k_end = sk;
  if (causal) k_end = min(sk, q0 + BQ + offset);
  const unsigned lane_base = (threadIdx.x & 31) & 16u;  // first lane of this half-warp

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Kt / Vs / Pt are consumed (and Qt is staged)
    for (int idx = tid; idx < BK * DMAX; idx += THREADS) {
      const int r = idx / DMAX, c = idx % DMAX;
      const bool in = k0 + r < sk;
      Kt[c * (BK + PAD) + r] = in && c < d ? to_f32(kb[(k0 + r) * ks.s + c]) : 0.0f;
      Vs[r * DMAX + c] = in && c < dv ? to_f32(vb[(k0 + r) * vs.s + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int kk = 0; kk < d; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[kk * (BQ + PAD) + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[kk * (BK + PAD) + tx * 4]);
      const float a4[4] = {a.x, a.y, a.z, a.w};
      const float c4[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a4[i], c4[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (kpos >= sk) {
          x = -INFINITY;  // past the keys: contributes exactly 0
        } else if (causal && kpos > qpos + offset) {
          x = MASKED;
        }
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, w));
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        Pt[(tx * 4 + j) * (BQ + PAD) + ty * 4 + i] = p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, w);
      // one lane's sum for the whole row, so all 16 lanes hold the same l
      rsum = __shfl_sync(0xffffffffu, rsum, lane_base);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[kk * (BQ + PAD) + ty * 4]);
      const float p4[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        const float4 w = *reinterpret_cast<const float4*>(&Vs[kk * DMAX + nc * 64 + tx * 4]);
        const float w4[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][nc * 4 + j] = fmaf(p4[i], w4[j], acc[i][nc * 4 + j]);
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nc * 64 + tx * 4 + j;
        if (c < dv) ob[r * os.s + c] = from_f32<T>(acc[i][nc * 4 + j] / l[i]);
      }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int hq,
                   int hk, int sq, int sk, int d, int dv, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  auto kernel = flash_attention_kernel<T, DMAX>;
  // opt in to more than 48 KB of dynamic shared memory, once per
  // instantiation (so that no such call lands inside a CUDA graph capture)
  static cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid((sq + BQ - 1) / BQ, hq, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), hq, hq / hk, sq, sk, d, dv, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int batch, int hq,
                     int hk, int sq, int sk, int d, int dv, Strides qs, Strides ks, Strides vs,
                     Strides os, float scale, int causal, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, batch, hq, hk, sq, sk, d, dv, qs, ks, vs, os, scale, causal,
                         stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, batch, hq, hk, sq, sk, d, dv, qs, ks, vs, os, scale, causal,
                          stream);
  return launch<T, 256>(q, k, v, o, batch, hq, hk, sq, sk, d, dv, qs, ks, vs, os, scale, causal,
                        stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = f32, 1 = bf16. d is
// the query/key head dim, dv (<= d) the value head dim.
// strides: 12 values, (batch, head, seq) of q, k, v and o in that order.
// Launches on `stream`, does not synchronize, and returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int batch, int hq, int hk, int sq, int sk, int d, int dv,
                                     const long long* strides, float scale, int causal,
                                     int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || hq <= 0 || hk <= 0 || hq % hk != 0 || sq <= 0 || sk <= 0 || d <= 0 ||
      d > 256 || dv <= 0 || dv > d)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_d<float>(q, k, v, o, batch, hq, hk, sq, sk, d, dv, qs, ks, vs, os, scale,
                            causal, s);
      break;
    case 1:
      err = launch_d<__nv_bfloat16>(q, k, v, o, batch, hq, hk, sq, sk, d, dv, qs, ks, vs, os,
                                    scale, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
