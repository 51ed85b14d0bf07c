// One-token GQA decode attention over a seq-major KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_decode.py:65
// (flash_decode, body _decode_kernel :28):
//
//     o[b, h, :] = softmax_s(scale * q[b, h, :] . k[b, s, h / group, :]) @ v[b, :, h / group, :]
//
// over the live positions s < length; the rest of the cache is never read
// (the reference masks them to -1e30, which adds exactly 0 once one live
// position exists, and the wrapper requires 1 <= length <= S). Logits,
// softmax and the P.V sum are f32 (p stays f32, as in the reference kernel);
// the result is cast to q's type with round-to-nearest. q is (B, Hq, hd),
// the cache k (B, S, Hkv, hd) and v (B, S, Hkv, dv) with a value head dim
// dv <= hd of its own (MLA's values are narrower than its keys), o is
// (B, Hq, dv); each has unit stride along its head dim and its own other
// strides (in elements); f32 or bf16, all alike.
//
// What bounds it on an H100: the cache read. A step reads 2 * length * Hkv
// * hd elements per sequence and does 4 * group flop per element read
// (group = Hq / Hkv query heads share each K/V row): 16 for chatglm3-6b's
// group of 16 in bf16, under the card's ~295 flop per byte, so bytes bound
// it at 3.35 TB/s.
//
// Design: a simple kernel, right first. One block of 256 threads per
// (KV head, sequence): the block holds its group's query heads (f32, in
// shared memory) and streams the cache once, 32 positions at a time, through
// shared memory. For each tile, thread (g, p) pairs take the logits (q_g .
// k_p over hd); one warp per query head then takes the tile's max, the
// running-max update, p = exp(s - m_new) and the normalizer (the reference's
// order: m_new = max(m, rowmax), alpha = exp(m - m_new), l = l * alpha +
// sum p); then each thread updates its (g, e) entries of the f32
// accumulator, kept in shared memory: acc = acc * alpha + sum_p p * v[p, e].
// o = acc / l at the end. With chatglm3-6b's 2 KV heads a batch of 4 is only
// 8 blocks on 132 SMs: a split-KV kernel (several blocks per sequence and a
// combine pass) is later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TK = 32;        // cache positions per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

// Shared memory, in floats: Qs[G][hd], Acc[G][dv], Ks[TK][hd+1], Vs[TK][dv],
// Ss[G][TK], M[G], L[G], Alpha[G] (the wrapper's smem_bytes mirrors it).
size_t smem_bytes(int group, int hd, int dv) {
  return sizeof(float) * (1ULL * group * (hd + dv) + TK * (hd + 1ULL) + 1ULL * TK * dv +
                          1ULL * group * TK + 3ULL * group);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int group, int hd, int dv,
                    int length, long long q_sb, long long q_sh, long long k_sb,
                    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                    long long v_sh, long long o_sb, long long o_sh, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [G][hd]
  float* Acc = Qs + group * hd;       // [G][dv]
  float* Ks = Acc + group * dv;       // [TK][hd+1] (padded: conflict-free dots)
  float* Vs = Ks + TK * (hd + 1);     // [TK][dv]
  float* Ss = Vs + TK * dv;           // [G][TK]
  float* M = Ss + group * TK;         // [G]
  float* L = M + group;               // [G]
  float* Alpha = L + group;           // [G]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int h0 = kvh * group;  // first query head of this group
  const int gh = group * dv;   // accumulator entries

  for (int idx = tid; idx < group * hd; idx += THREADS) {
    const int g = idx / hd, e = idx % hd;
    Qs[idx] = to_f32(q[b * q_sb + (h0 + g) * q_sh + e]);
  }
  for (int idx = tid; idx < gh; idx += THREADS) Acc[idx] = 0.0f;
  for (int g = tid; g < group; g += THREADS) {
    M[g] = -1e30f;  // the reference's initial running max
    L[g] = 0.0f;
  }
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int t0 = 0; t0 < length; t0 += TK) {
    const int n = min(TK, length - t0);  // live positions of this tile
    __syncthreads();  // the previous tile is consumed (and Qs / M / L staged)
    for (int idx = tid; idx < n * hd; idx += THREADS) {
      const int p = idx / hd, e = idx % hd;
      Ks[p * (hd + 1) + e] = to_f32(kb[(t0 + p) * k_ss + e]);
    }
    for (int idx = tid; idx < n * dv; idx += THREADS) {
      const int p = idx / dv, e = idx % dv;
      Vs[p * dv + e] = to_f32(vb[(t0 + p) * v_ss + e]);
    }
    __syncthreads();
    for (int idx = tid; idx < group * TK; idx += THREADS) {
      const int g = idx / TK, p = idx % TK;
      float x = -INFINITY;  // past the live positions: adds exactly 0
      if (p < n) {
        const float* qg = Qs + g * hd;
        const float* kp = Ks + p * (hd + 1);
        float dot = 0.0f;
        for (int e = 0; e < hd; ++e) dot = fmaf(qg[e], kp[e], dot);
        x = dot * scale;
      }
      Ss[idx] = x;
    }
    __syncthreads();
    for (int g = warp; g < group; g += WARPS) {
      const float x = Ss[g * TK + lane];  // TK == 32: one position per lane
      float rmax = x;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, w));
      const float m_prev = M[g];
      const float m_new = fmaxf(m_prev, rmax);
      const float p = expf(x - m_new);
      Ss[g * TK + lane] = p;
      float rsum = p;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, w);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        Alpha[g] = alpha;
        L[g] = L[g] * alpha + rsum;
        M[g] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < gh; idx += THREADS) {
      const int g = idx / dv, e = idx % dv;
      const float* pg = Ss + g * TK;
      float a = Acc[idx] * Alpha[g];
      for (int p = 0; p < n; ++p) a = fmaf(pg[p], Vs[p * dv + e], a);
      Acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < gh; idx += THREADS) {
    const int g = idx / dv, e = idx % dv;
    o[b * o_sb + (h0 + g) * o_sh + e] = from_f32<T>(Acc[idx] / L[g]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int hkv,
                   int group, int hd, int dv, int length, const long long* st, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(group, hd, dv);
  if (smem > 48 * 1024) {
    // opt in to the most a block may take, once per instantiation (so that
    // no such call lands inside a CUDA graph capture)
    static cudaError_t configured = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (configured != cudaSuccess) return configured;
  }
  const dim3 grid(hkv, batch);
  flash_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), group, hd, dv, length, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = f32, 1 = bf16. hd is
// the query/key head dim, dv (<= hd) the value head dim. strides: 10 values: q (batch, head), k (batch, seq, head), v (batch, seq,
// head), o (batch, head). Launches on `stream`, does not synchronize, and
// returns cudaGetLastError() of the launch (0 = success).
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v, void* o,
                                  int batch, int hkv, int group, int hd, int dv, int length,
                                  const long long* strides, float scale, int dtype,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || hkv <= 0 || group <= 0 || hd <= 0 || dv <= 0 || dv > hd || length <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch<float>(q, k, v, o, batch, hkv, group, hd, dv, length, strides, scale, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(q, k, v, o, batch, hkv, group, hd, dv, length, strides, scale,
                                  s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
