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
// a larger matrix), and a null C reads as zero (matmul). Every operand is
// row-major with unit column stride and its own row stride (ld*, in
// elements), so tiles that are views of the whole matrix are read where
// they lie, with no copy.
//
// f32 is computed in true f32 FMA on the CUDA cores, never TF32: the
// reference's tolerance (2e-4 for f32 at k = 512) and its interpret-mode
// oracle are full f32. The accumulator holds the product alone and C enters
// once at the end, as out = C + alpha * acc with separate roundings: the
// plain version (c + alpha * (a @ b)) in the same form.
//
// What bounds it on an H100: operations. At the main path's shapes,
// (512, 512, 512) for syrk / gemm / ssssm / ormqr and (1024, 512, 1024)
// for tsmqr, an f32 call does 2.7e8 or 1.1e9 flop against 4 or 10 MB of
// operands: 4.0 or 16 us at the 67 TFLOP/s f32 peak against 1.3 or 3.1 us
// of HBM time (bf16: bytes, since its 989 TFLOP/s tensor-core peak leaves
// 0.3 us of arithmetic against 0.6 us of HBM time).
//
// Design.
//  * Wave-filling plan. A (512, 512) output has only 64 tiles of 64 x 64
//    for 132 SMs. The wrapper's planner (gemm_plan in tile_gemm.py, a pure
//    function of the shape) cuts k into n_split chunks of k_chunk (a
//    multiple of BK, none empty, at least 128 long) so that the grid
//    (n/64, m/64, n_split) holds up to two blocks per SM: 256 blocks at
//    (512, 512, 512) with 4 splits, 256 at (1024, 512, 1024) with 2. A
//    128-thread block leaves room for a second one on its SM, and two
//    blocks an SM measured faster than one block of twice the k, and no
//    slower than 128 x 64 or 128 x 128 tiles with 8 x 8 micro-tiles.
//  * Ring. k advances in stages of BK = 16 through a 3-stage ring in shared
//    memory filled by cp.async: 16-byte copies where an operand's base and
//    row stride are 16-byte aligned, 4-byte copies where they are 4-byte
//    aligned, and (bf16 at an odd element offset only) 2-byte loads through
//    registers. Every route writes the same shared-memory image, zero
//    outside the operand and past the split's k, so a misaligned view gives
//    the bits of its contiguous copy. When both A and B are 16-byte aligned
//    a kernel specialised for that case runs, with no branch on the copy
//    unit: it measured faster than the general kernel on the same aligned
//    operands at every main-path shape (tools/gemm_variants.py).
//    bf16 is staged raw and widened to f32 (exactly) when read. One barrier
//    per stage. (Four stages, or BK 32 in two, measured no faster.)
//  * Layout. cp.async cannot transpose, so A and (with trans_b) B land
//    k-minor: one row of the operand per shared-memory row, padded to 20
//    floats (24 bf16). Instead of scalar reads of one k, a thread reads
//    four consecutive k of a row at once (float4; 8 bytes for bf16), which
//    costs as few reads per FMA as k-major float4 reads would. A thread's
//    rows (and B^T rows) are interleaved, ty + 8i (tx + 16j), so a warp
//    reads consecutive rows, whose 80-byte pitch puts them in distinct
//    banks. B without trans_b lands k-major (its natural layout) and is
//    read as one float4 of four consecutive columns.
//  * Micro-tile. 128 threads; each holds an 8 x 4 register tile of f32
//    accumulators and does 128 FMA per 12 shared-memory reads (of four k
//    each).
//  * Deterministic split-K. Each split accumulates its k-chunk in sequential
//    FMA order. With n_split = 1 the block writes C + alpha * acc itself;
//    otherwise it writes acc to an f32 workspace (n_split x m x n) that the
//    wrapper allocates, and a second kernel sums the partials in split
//    order 0, 1, .., n_split - 1 and writes C + alpha * sum. No atomics,
//    nothing to reset: a call can be captured in a CUDA graph, and two
//    calls with one plan give the same bits.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // output rows per block (tile_gemm.py TILE)
constexpr int BN = 64;       // output columns per block
constexpr int BK = 16;       // k per shared-memory stage (tile_gemm.py STAGE_K)
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int TM = 8;        // output rows per thread
constexpr int TN = 4;        // output columns per thread
constexpr int RT = BM / TM;  // threads along the rows
constexpr int CT = BN / TN;  // threads along the columns
constexpr int THREADS = RT * CT;  // 128
static_assert(TN == 4 && CT == 16, "a thread reads four columns; a warp spans two rows of threads");

// Row pitch, in elements, of a k-minor shared-memory tile: BK plus padding
// that keeps rows 16-byte aligned for cp.async (80 bytes f32, 48 bf16).
template <typename T>
constexpr int KMINOR_PITCH = sizeof(T) == 4 ? BK + 4 : BK + 8;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes of which the first `bytes` are read and the
// rest zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's share of staging a ROWS x COLS box of a row-major operand
// into shared memory (row pitch PITCH) with copies of UNIT bytes: 16 or 4
// by cp.async, 2 (bf16 only) by a load and a store through registers. Its
// copies sit at fixed (row, column) offsets of the box, so only the box
// origin moves from one stage to the next.
template <typename T, int ROWS, int COLS, int PITCH, int UNIT>
struct BoxCopy {
  static constexpr int E = UNIT / static_cast<int>(sizeof(T));  // elements per copy
  static constexpr int PER_ROW = COLS / E;
  static constexpr int RSTEP = THREADS / PER_ROW;  // rows between a thread's copies
  static constexpr int N = ROWS / RSTEP;      // copies per thread
  static_assert(E >= 1 && THREADS % PER_ROW == 0 && ROWS % RSTEP == 0, "whole copies per thread");

  // Box origin `src` (inside the operand, row stride ld elements); zero
  // outside rows_valid x cols_valid.
  __device__ __forceinline__ static void copy(T* dst, const T* __restrict__ src, int64_t ld,
                                              int rows_valid, int cols_valid, int tid) {
    const int r0 = tid / PER_ROW, col = (tid % PER_ROW) * E;
    const int cv = max(0, min(E, cols_valid - col));
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int r = r0 + it * RSTEP;
      const int valid = r < rows_valid ? cv : 0;
      const T* from = valid ? src + r * ld + col : src;
      if constexpr (UNIT == 16) {
        cp_async_16(dst + r * PITCH + col, from, valid * static_cast<int>(sizeof(T)));
      } else if constexpr (UNIT == 4) {
        cp_async_4(dst + r * PITCH + col, from, valid * static_cast<int>(sizeof(T)));
      } else {
        static_assert(UNIT == 2 && sizeof(T) == 2, "2-byte copies are for bf16");
        reinterpret_cast<uint16_t*>(dst)[r * PITCH + col] =
            valid ? *reinterpret_cast<const uint16_t*>(from) : uint16_t{0};
      }
    }
  }
};

// Stage a box with the operand's copy unit: 16 bytes on the aligned
// kernel, else the unit the host found for it (copy_unit).
template <typename T, int ROWS, int COLS, int PITCH, bool ALIGNED>
__device__ __forceinline__ void stage_box(T* dst, const T* __restrict__ src, int64_t ld,
                                          int rows_valid, int cols_valid, int unit, int tid) {
  if (ALIGNED || unit == 16) {
    BoxCopy<T, ROWS, COLS, PITCH, 16>::copy(dst, src, ld, rows_valid, cols_valid, tid);
  } else if (sizeof(T) == 4 || unit == 4) {
    BoxCopy<T, ROWS, COLS, PITCH, 4>::copy(dst, src, ld, rows_valid, cols_valid, tid);
  } else if constexpr (sizeof(T) == 2) {
    BoxCopy<T, ROWS, COLS, PITCH, 2>::copy(dst, src, ld, rows_valid, cols_valid, tid);
  }
}

// Four consecutive elements of shared memory as f32: one float4, or for
// bf16 one 8-byte read widened exactly (bf16 is the top half of an f32).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}

template <typename T, bool TRANS_B, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
gemm_update_kernel(const T* __restrict__ c, const T* __restrict__ a,
                   const T* __restrict__ b, T* __restrict__ out, float* __restrict__ ws,
                   int m, int n, int k, int64_t ldc, int64_t lda, int64_t ldb, float alpha,
                   int k_chunk, int unit_a, int unit_b) {
  constexpr int PK = KMINOR_PITCH<T>;
  constexpr int A_STAGE = BM * PK;
  constexpr int B_STAGE = TRANS_B ? BN * PK : BK * BN;
  __shared__ __align__(16) T smem[STAGES * (A_STAGE + B_STAGE)];
  T* const As = smem;
  T* const Bs = smem + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int tx = tid % CT, ty = tid / CT;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(k, k_begin + k_chunk);
  const int ktiles = (k_end - k_begin + BK - 1) / BK;

  auto load = [&](int kt) {
    const int st = kt % STAGES, k0 = k_begin + kt * BK;
    stage_box<T, BM, BK, PK, ALIGNED>(As + st * A_STAGE, a + row0 * lda + k0, lda,
                                          m - row0, k_end - k0, unit_a, tid);
    if constexpr (TRANS_B) {
      stage_box<T, BN, BK, PK, ALIGNED>(Bs + st * B_STAGE, b + col0 * ldb + k0, ldb,
                                            n - col0, k_end - k0, unit_b, tid);
    } else {
      stage_box<T, BK, BN, BN, ALIGNED>(Bs + st * B_STAGE, b + k0 * ldb + col0, ldb,
                                            k_end - k0, n - col0, unit_b, tid);
    }
  };
  // Column j of this thread's micro-tile: interleaved rows of B^T, or four
  // consecutive columns of B.
  auto col_of = [&](int j) { return TRANS_B ? tx + CT * j : 4 * tx + j; };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    // Stage kt has landed for every thread, and every thread is done with
    // stage kt - 1, whose slot the next load refills.
    __syncthreads();
    if (kt + STAGES - 1 < ktiles) load(kt + STAGES - 1);
    cp_async_commit();
    const T* as = As + (kt % STAGES) * A_STAGE;
    const T* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float av[TM][4], bv[4][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) load4(as + (ty + RT * i) * PK + k4, av[i]);
      if constexpr (TRANS_B) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float t[4];
          load4(bs + (tx + CT * j) * PK + k4, t);
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q][j] = t[q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) load4(bs + (k4 + q) * BN + 4 * tx, bv[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i][q], bv[q][j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  const bool split = gridDim.z > 1;
  float* part = ws + static_cast<int64_t>(blockIdx.z) * m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + RT * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + col_of(j);
      if (col >= n) continue;
      const int64_t at = static_cast<int64_t>(r) * n + col;
      if (split) {
        part[at] = acc[i][j];
      } else {
        const float cv = c != nullptr ? to_f32(c[r * ldc + col]) : 0.0f;
        out[at] = from_f32<T>(__fadd_rn(__fmul_rn(alpha, acc[i][j]), cv));
      }
    }
  }
}

// out = C + alpha * (ws[0] + ws[1] + ... + ws[n_split - 1]), summed in
// split order.
template <typename T>
__global__ void __launch_bounds__(256)
gemm_update_combine_kernel(const float* __restrict__ ws, const T* __restrict__ c, T* __restrict__ out,
               int m, int n, int n_split, int64_t ldc, float alpha) {
  const int64_t total = static_cast<int64_t>(m) * n;
  for (int64_t at = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; at < total;
       at += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float sum = ws[at];
    for (int s = 1; s < n_split; ++s) sum = __fadd_rn(sum, ws[s * total + at]);
    const int64_t r = at / n, col = at % n;
    const float cv = c != nullptr ? to_f32(c[r * ldc + col]) : 0.0f;
    out[at] = from_f32<T>(__fadd_rn(__fmul_rn(alpha, sum), cv));
  }
}

// Copy size in bytes for an operand: 16 where its base and row stride are
// 16-byte aligned, 4 where they are 4-byte aligned, else 2.
int copy_unit(const void* p, long long ld, int elem_bytes) {
  const auto addr = reinterpret_cast<uintptr_t>(p);
  const long long pitch = ld * elem_bytes;
  if (addr % 16 == 0 && pitch % 16 == 0) return 16;
  if (addr % 4 == 0 && pitch % 4 == 0) return 4;
  return 2;
}

template <typename T>
cudaError_t launch(const void* cv, const void* av, const void* bv, void* outv, float* ws,
                   int m, int n, int k, long long ldc, long long lda, long long ldb,
                   float alpha, bool trans_b, int n_split, int k_chunk, cudaStream_t s) {
  const T* c = static_cast<const T*>(cv);
  const T* a = static_cast<const T*>(av);
  const T* b = static_cast<const T*>(bv);
  T* out = static_cast<T*>(outv);
  const int es = static_cast<int>(sizeof(T));
  const int ua = copy_unit(a, lda, es), ub = copy_unit(b, ldb, es);
  const bool aligned = ua == 16 && ub == 16;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, n_split);
#define REPRO_GEMM_LAUNCH(TB, AL)                                                             \
  gemm_update_kernel<T, TB, AL><<<grid, THREADS, 0, s>>>(c, a, b, out, ws, m, n, k, ldc, lda, \
                                                         ldb, alpha, k_chunk, ua, ub)
  if (trans_b && aligned) {
    REPRO_GEMM_LAUNCH(true, true);
  } else if (trans_b) {
    REPRO_GEMM_LAUNCH(true, false);
  } else if (aligned) {
    REPRO_GEMM_LAUNCH(false, true);
  } else {
    REPRO_GEMM_LAUNCH(false, false);
  }
#undef REPRO_GEMM_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const long long total = static_cast<long long>(m) * n;
  const int blocks = static_cast<int>(total / 256 + 1 < 65536 ? total / 256 + 1 : 65536);
  gemm_update_combine_kernel<T><<<blocks, 256, 0, s>>>(ws, c, out, m, n, n_split, ldc, alpha);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = f32, 1 = bf16.
// c may be null (read as zero). k_chunk is a positive multiple of 16 and
// n_split = ceil(k / k_chunk) <= 65535; with n_split > 1, ws holds
// n_split * m * n floats. Launches on `stream`
// (one kernel, or two with n_split > 1), does not synchronize, and returns
// cudaGetLastError() of the launches (0 = success).
extern "C" int repro_gemm_update(const void* c, const void* a, const void* b, void* out,
                                 void* ws, int m, int n, int k, long long ldc, long long lda,
                                 long long ldb, float alpha, int trans_b, int dtype,
                                 int n_split, int k_chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || n <= 0 || k <= 0 || k_chunk <= 0 || k_chunk % BK != 0 ||
      n_split != (k + k_chunk - 1) / k_chunk || n_split > 65535 ||
      (n_split > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  switch (dtype) {
    case 0:
      err = launch<float>(c, a, b, out, w, m, n, k, ldc, lda, ldb, alpha, trans_b != 0,
                          n_split, k_chunk, s);
      break;
    case 1:
      err = launch<__nv_bfloat16>(c, a, b, out, w, m, n, k, ldc, lda, ldb, alpha,
                                  trans_b != 0, n_split, k_chunk, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
