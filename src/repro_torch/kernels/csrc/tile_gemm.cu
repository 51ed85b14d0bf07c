// Tile GEMM update of the PLASMA tile bodies, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/tile_gemm.py:53 (gemm_update,
// body _gemm_kernel :29; matmul :109 goes through it with C = 0, alpha = 1):
//
//     out = C + alpha * (A @ op(B)),   op(B) = B or B^T
//
// A is (m, k), B is (k, n) or (n, k) when trans_b, C and out are (m, n).
// Inputs are f32 or bf16 (all three alike); products and sums are taken in
// f32 and the result is cast to C's type with round-to-nearest. out is a
// new buffer: C is never updated in place (the caller's C may be a view of
// a larger matrix). Every operand is row-major with unit column stride and
// its own row stride (ld*, in elements), so tiles that are views of the
// whole matrix are read where they lie, with no copy.
//
// f32 is computed in true f32 FMA on the CUDA cores, never TF32: the
// reference's tolerance (2e-4 for f32 at k = 512) and its interpret-mode
// oracle are full f32. The accumulator holds the product alone and C enters
// once at the end, as out = C + alpha * acc with separate roundings: the
// plain version (c + alpha * (a @ b)) in the same form.
//
// What bounds it on an H100. At the main path's shapes, (512, 512, 512)
// for syrk / gemm / ssssm / ormqr and (1024, 512, 1024) for tsmqr, an f32
// call does 2.7e8 or 1.1e9 flop against 4 or 10 MB of operands: 4.0 or
// 16 us at the 67 TFLOP/s f32 peak against 1.3 or 3.1 us of HBM time, so
// operations bound it (bf16: bytes, since its 989 TFLOP/s tensor-core peak
// leaves 0.3 us of arithmetic against 0.6 us of HBM time). A (512, 512)
// output has only 64 blocks of 64 x 64 for 132 SMs, so at most about half
// of the card's FMA units work on one call.
//
// Design: a simple kernel, right first. A block of 256 threads computes a
// 64 x 64 output tile; each thread holds a 4 x 4 register micro-tile of f32
// accumulators. The K loop stages 64 x 16 sub-tiles of A and op(B) in shared
// memory (8 KiB, converted to f32 on the way in); each thread reads four
// consecutive A values and four consecutive op(B) values per k step as
// float4 from shared memory for 16 FMAs. The next sub-tile's global loads
// are issued into registers before the current one's FMAs, so they overlap.
// trans_b is an indexing choice; ragged edges (a dimension that is not a
// multiple of 64 or 16) load zeros and skip their stores. Tensor cores
// (wgmma, and mma for bf16), TMA, a deeper pipeline and split-K for the
// narrow shapes are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output columns per block
constexpr int BK = 16;  // k per shared-memory stage
constexpr int TM = 4;   // output rows per thread
constexpr int TN = 4;   // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
static_assert(THREADS * 4 == BM * BK && THREADS * 4 == BK * BN,
              "each thread stages four values of A and four of op(B)");

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

// Element (r, c) of a row-major operand with row stride ld, or 0 outside
// its rows x cols.
template <typename T>
__device__ __forceinline__ float load_or_zero(const T* __restrict__ p, int64_t ld,
                                              int r, int c, int rows, int cols) {
  return (r < rows && c < cols) ? to_f32(p[r * ld + c]) : 0.0f;
}

// This thread's share of the K step at k0: four A values (one row, four
// consecutive k) and four op(B) values (B^T: one n row, four k; B: one k
// row, four consecutive n).
template <typename T, bool TRANS_B>
__device__ __forceinline__ void fetch(const T* __restrict__ a, const T* __restrict__ b,
                                      int64_t lda, int64_t ldb, int m, int n, int k,
                                      int row0, int col0, int k0, int tid,
                                      float (&ra)[4], float (&rb)[4]) {
  const int r4 = tid / 4, k4 = (tid % 4) * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ra[i] = load_or_zero(a, lda, row0 + r4, k0 + k4 + i, m, k);
    if constexpr (TRANS_B) {
      rb[i] = load_or_zero(b, ldb, col0 + r4, k0 + k4 + i, n, k);
    } else {
      rb[i] = load_or_zero(b, ldb, k0 + tid / 16, col0 + (tid % 16) * 4 + i, k, n);
    }
  }
}

template <typename T, bool TRANS_B>
__global__ void __launch_bounds__(THREADS)
gemm_update_kernel(const T* __restrict__ c, const T* __restrict__ a,
                   const T* __restrict__ b, T* __restrict__ out, int m, int n,
                   int k, int64_t ldc, int64_t lda, int64_t ldb, float alpha) {
  __shared__ __align__(16) float As[BK][BM];  // A sub-tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];  // op(B) sub-tile, k-major

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int r4 = tid / 4, k4 = (tid % 4) * 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  float ra[4], rb[4];
  fetch<T, TRANS_B>(a, b, lda, ldb, m, n, k, row0, col0, 0, tid, ra, rb);
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[k4 + i][r4] = ra[i];
    if constexpr (TRANS_B) {
#pragma unroll
      for (int i = 0; i < 4; ++i) Bs[k4 + i][r4] = rb[i];
    } else {
      *reinterpret_cast<float4*>(&Bs[tid / 16][(tid % 16) * 4]) =
          make_float4(rb[0], rb[1], rb[2], rb[3]);
    }
    __syncthreads();
    if (k0 + BK < k) {
      fetch<T, TRANS_B>(a, b, lda, ldb, m, n, k, row0, col0, k0 + BK, tid, ra, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a4[TM] = {av.x, av.y, av.z, av.w};
      const float b4[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col >= n) continue;
      const float cv = to_f32(c[r * ldc + col]);
      out[static_cast<int64_t>(r) * n + col] =
          from_f32<T>(__fadd_rn(__fmul_rn(alpha, acc[i][j]), cv));
    }
  }
}

template <typename T>
cudaError_t launch(const void* c, const void* a, const void* b, void* out, int m,
                   int n, int k, int64_t ldc, int64_t lda, int64_t ldb, float alpha,
                   bool trans_b, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const T* cp = static_cast<const T*>(c);
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* op = static_cast<T*>(out);
  if (trans_b) {
    gemm_update_kernel<T, true><<<grid, THREADS, 0, stream>>>(cp, ap, bp, op, m, n, k,
                                                              ldc, lda, ldb, alpha);
  } else {
    gemm_update_kernel<T, false><<<grid, THREADS, 0, stream>>>(cp, ap, bp, op, m, n, k,
                                                               ldc, lda, ldb, alpha);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = f32, 1 = bf16.
// Launches on `stream`, does not synchronize, and returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int repro_gemm_update(const void* c, const void* a, const void* b,
                                 void* out, int m, int n, int k, long long ldc,
                                 long long lda, long long ldb, float alpha,
                                 int trans_b, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch<float>(c, a, b, out, m, n, k, ldc, lda, ldb, alpha, trans_b != 0, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(c, a, b, out, m, n, k, ldc, lda, ldb, alpha,
                                  trans_b != 0, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
