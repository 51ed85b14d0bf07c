// One-token GQA decode attention over a seq-major KV cache, split over the
// cache, on the tensor cores: bf16 for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_decode.py:65
// (flash_decode, body _decode_kernel :28) on the bf16 route:
//
//     o[b, h, :] = softmax_s(scale * q[b, h, :] . k[b, s, h / group, :]) @ v[b, :, h / group, :]
//
// over the live positions s < length. csrc/flash_decode.cu stays the f32
// route and the route for shapes this kernel does not take (the wrapper's
// rule, flash_decode.py). q and k have the head dim hd, v and o a value
// head dim dv <= hd of their own (MLA: 96 and 64), both multiples of 16.
//
// What bounds it on an H100: the cache read. A decode_32k-like call (B 16,
// S 32 768, 2 KV heads, hd 128) reads 537 MB of K and V: 0.160 ms at
// 3.35 TB/s. It also does 4 * B * Hq * S * hd = 8.6e9 flop (32 query heads
// share each KV head in groups of 16): 0.128 ms at the 67 TFLOP/s f32 SIMT
// peak, so the CUDA cores alone could not hold the byte bound even at their
// peak. The group's query heads are exactly the 16 rows of
// mma.sync.m16n8k16, so the logits and the P.V product run on the tensor
// cores, where that arithmetic costs under 0.01 ms.
//
// Design. Grid (n_split, Hkv * slices, B): the wrapper's planner
// (decode_splits) cuts the live cache into n_split chunks of a multiple of
// 64 positions, none empty, so that a small batch still fills the card.
// A group over 16 query heads is taken in 16-row slices, one block each (a
// group under 16 is padded with zero rows). A block of 4 warps streams its
// chunk in 64-position tiles through a 3-stage ring in shared memory:
// 16-byte cp.async copies, neighbouring threads on neighbouring 16-byte
// pieces of a row, positions past the chunk zero-filled. Warp w takes
// positions 16w..16w+15 of every tile and keeps its own online softmax:
//   S (16 heads x 16 positions) = Q . K^T: mma.sync m16n8k16 bf16 -> f32,
//     A (Q) and B (K) fragments through ldmatrix;
//   m_new = max(m, rowmax S), alpha = 2^(m - m_new), p = 2^(S - m_new),
//     l = l * alpha + sum p, acc = acc * alpha + p . V (the reference's
//     order), in f32 registers; the logits are kept in log2 units (scale
//     premultiplied by log2(e), exp2f), the same function as exp;
//   P . V: the same mma with P rounded to bf16 in registers (the
//     accumulator's layout is the A fragment's) and V fragments through
//     ldmatrix.trans, so V is never transposed in memory.
// At the end the four warps' (m, l, acc) merge in shared memory and the
// block writes its split's f32 (m, l, acc) to scratch that the wrapper
// allocates. A second kernel merges the splits by log-sum-exp, divides by l
// and rounds to bf16. Two launches, no atomics, nothing to reset: the call
// can be captured in a CUDA graph.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;     // cache positions per tile (16 per warp)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int ROWS = 16;     // query heads per block (the mma's M)
constexpr float LOG2E = 1.4426950408889634f;

// bf16 elements of padding per shared-memory row: a row pitch of
// hd + 8 shifts each row by 4 banks, so ldmatrix reads are conflict-free
constexpr int PAD = 8;

// Qs[ROWS][hd + PAD], Ks[STAGES][TILE][hd + PAD], Vs[STAGES][TILE][dv + PAD]
size_t split_smem_bytes(int hd, int dv) {
  return sizeof(__nv_bfloat16) *
         ((size_t)(hd + PAD) * (ROWS + STAGES * TILE) + (size_t)(dv + PAD) * STAGES * TILE);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  float* part_m;    // [B * Hq][n_split], log2 units
  float* part_l;    // [B * Hq][n_split]
  float* part_acc;  // [B * Hq][n_split][dv]
  __nv_bfloat16* o;
  int hq, group, hd, dv, length, chunk, n_split, slices;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale_log2;  // scale * log2(e)
};

// HD and DV: the largest head dims of the instantiation (hd <= HD, dv <= DV)
template <int HD, int DV>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_kernel(const Args a) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const int hd = a.hd, dv = a.dv;
  const int pitch = hd + PAD, pitch_v = dv + PAD;
  __nv_bfloat16* Qs = smem;                         // [ROWS][pitch]
  __nv_bfloat16* Ks = Qs + ROWS * pitch;            // [STAGES][TILE][pitch]
  __nv_bfloat16* Vs = Ks + STAGES * TILE * pitch;   // [STAGES][TILE][pitch_v]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment row / column pair
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / a.slices;
  const int slice = blockIdx.y % a.slices;
  const int b = blockIdx.z;
  const int h0 = kvh * a.group + slice * ROWS;   // first query head of the block
  const int n_rows = min(ROWS, a.group - slice * ROWS);
  const int s0 = split * a.chunk;
  const int s1 = min(s0 + a.chunk, a.length);    // s0 < s1: no split is empty
  const int n_tiles = (s1 - s0 + TILE - 1) / TILE;
  const int cpr = hd / 8;                        // 16-byte pieces per K row
  const int cpr_v = dv / 8;                      // and per V row

  // Q rows of the block (zero rows past the group)
  for (int idx = tid; idx < ROWS * cpr; idx += THREADS) {
    const int r = idx / cpr, c = idx % cpr;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n_rows)
      val = *reinterpret_cast<const uint4*>(a.q + b * a.q_sb + (h0 + r) * a.q_sh + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * pitch + c * 8) = val;
  }

  const __nv_bfloat16* kb = a.k + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + kvh * a.v_sh;
  auto load_tile = [&](int t) {
    const int st = t % STAGES;
    __nv_bfloat16* kd = Ks + st * TILE * pitch;
    __nv_bfloat16* vd = Vs + st * TILE * pitch_v;
    for (int idx = tid; idx < TILE * cpr; idx += THREADS) {
      const int r = idx / cpr, c = idx % cpr;
      const int pos = s0 + t * TILE + r;
      const bool valid = pos < s1;
      const long long p = valid ? pos : 0;
      cp_async_16(smem_u32(kd + r * pitch + c * 8), kb + p * a.k_ss + c * 8, valid);
    }
    for (int idx = tid; idx < TILE * cpr_v; idx += THREADS) {
      const int r = idx / cpr_v, c = idx % cpr_v;
      const int pos = s0 + t * TILE + r;
      const bool valid = pos < s1;
      const long long p = valid ? pos : 0;
      cp_async_16(smem_u32(vd + r * pitch_v + c * 8), vb + p * a.v_ss + c * 8, valid);
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  constexpr int NT = DV / 8;  // n8 tiles of the output columns
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
  float m[2] = {-1e30f, -1e30f};  // the reference's initial running max (rows g, g + 8)
  float l[2] = {0.0f, 0.0f};      // this thread's part of the row sums

  const uint32_t q_addr = smem_u32(Qs + (lane % 16) * pitch + (lane / 16) * 8);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed for every thread; tile t - 1's slot is free
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
    cp_async_commit();

    const int st = t % STAGES;
    const __nv_bfloat16* kt = Ks + st * TILE * pitch + warp * 16 * pitch;
    const __nv_bfloat16* vt = Vs + st * TILE * pitch_v + warp * 16 * pitch_v;

    // S = Q . K^T over this warp's 16 positions
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int j = lane / 8;
    const uint32_t k_addr = smem_u32(kt + ((lane % 8) + (j >> 1) * 8) * pitch + (j & 1) * 8);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      if (kk * 16 < hd) {
        uint32_t qa[4], kf[4];
        ldmatrix_x4(q_addr + kk * 32, qa);
        ldmatrix_x4(k_addr + kk * 32, kf);
        mma_bf16(s[0], qa, kf[0], kf[1]);
        mma_bf16(s[1], qa, kf[2], kf[3]);
      }
    }

    // online softmax, rows g (c = 0, 1) and g + 8 (c = 2, 3)
    const int pos0 = s0 + t * TILE + warp * 16 + 2 * tig;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int pos = pos0 + nt * 8 + (c & 1);
        // past the chunk: contributes exactly 0
        const float x = pos < s1 ? s[nt][c] * a.scale_log2 : -INFINITY;
        s[nt][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[nt][c] - m[c >> 1]);
        s[nt][c] = p;
        rsum[c >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      acc[jn][0] *= alpha[0];
      acc[jn][1] *= alpha[0];
      acc[jn][2] *= alpha[1];
      acc[jn][3] *= alpha[1];
    }

    // acc += P . V: P (16 x 16 positions) as the A fragment
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
    const uint32_t v_addr = smem_u32(vt + ((lane % 8) + (j & 1) * 8) * pitch_v + (j >> 1) * 8);
#pragma unroll
    for (int dn = 0; dn < DV / 16; ++dn) {
      if (dn * 16 < dv) {
        uint32_t vf[4];
        ldmatrix_x4_trans(v_addr + dn * 32, vf);
        mma_bf16(acc[2 * dn], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dn + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // merge the four warps' (m, l, acc) through shared memory (the ring is free)
  cp_async_wait<0>();
  __syncthreads();
  float* Wm = reinterpret_cast<float*>(Ks);  // [WARPS][ROWS]
  float* Wl = Wm + WARPS * ROWS;             // [WARPS][ROWS]
  float* Wacc = Wl + WARPS * ROWS;           // [WARPS][ROWS][dv]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (tig == 0) {
      Wm[warp * ROWS + g + 8 * r] = m[r];
      Wl[warp * ROWS + g + 8 * r] = l[r];
    }
  }
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    if (jn * 8 < dv) {
      const int col = jn * 8 + 2 * tig;
      float* w0 = Wacc + (warp * ROWS + g) * dv + col;
      float* w1 = Wacc + (warp * ROWS + g + 8) * dv + col;
      w0[0] = acc[jn][0];
      w0[1] = acc[jn][1];
      w1[0] = acc[jn][2];
      w1[1] = acc[jn][3];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n_rows * dv; idx += THREADS) {
    const int r = idx / dv, col = idx % dv;
    float mb = Wm[r];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mb = fmaxf(mb, Wm[w * ROWS + r]);
    float lb = 0.0f, ab = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(Wm[w * ROWS + r] - mb);  // 0 for a warp that saw no position
      lb += wt * Wl[w * ROWS + r];
      ab += wt * Wacc[(w * ROWS + r) * dv + col];
    }
    const long long row = (long long)b * a.hq + h0 + r;
    a.part_acc[(row * a.n_split + split) * dv + col] = ab;
    if (col == 0) {
      a.part_m[row * a.n_split + split] = mb;
      a.part_l[row * a.n_split + split] = lb;
    }
  }
}

// o[b, h, :] = sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s, M = max_s m_s
__global__ void __launch_bounds__(THREADS)
flash_decode_combine_kernel(const Args a) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long row = (long long)b * a.hq + h;
  const float* pm = a.part_m + row * a.n_split;
  const float* pl = a.part_l + row * a.n_split;
  float mb = pm[0];
  for (int s = 1; s < a.n_split; ++s) mb = fmaxf(mb, pm[s]);
  float lb = 0.0f;
  for (int s = 0; s < a.n_split; ++s) lb += exp2f(pm[s] - mb) * pl[s];
  for (int col = threadIdx.x; col < a.dv; col += THREADS) {
    float ab = 0.0f;
    for (int s = 0; s < a.n_split; ++s)
      ab += exp2f(pm[s] - mb) * a.part_acc[(row * a.n_split + s) * a.dv + col];
    a.o[b * a.o_sb + h * a.o_sh + col] = __float2bfloat16_rn(ab / lb);
  }
}

template <int HD, int DV>
cudaError_t launch(const Args& a, int batch, int hkv, cudaStream_t stream) {
  const size_t smem = split_smem_bytes(HD, DV);
  // opt in to more than 48 KB of dynamic shared memory, once per
  // instantiation (so that no such call lands inside a CUDA graph capture);
  // sized for the largest head dims of the instantiation
  static cudaError_t configured = cudaFuncSetAttribute(
      flash_decode_split_kernel<HD, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid(a.n_split, hkv * a.slices, batch);
  flash_decode_split_kernel<HD, DV><<<grid, THREADS, split_smem_bytes(a.hd, a.dv), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<<<dim3(a.hq, batch), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes); bf16 only. strides: 10 values:
// q (batch, head), k (batch, seq, head), v (batch, seq, head), o (batch,
// head), in elements. hd is the query/key head dim, dv (<= hd) the value
// head dim, both multiples of 16. part_m and part_l hold batch * hkv * group
// * n_split floats, part_acc that times dv. Launches the split kernel and the combine
// kernel on `stream`, does not synchronize, and returns cudaGetLastError()
// (0 = success).
extern "C" int repro_flash_decode_split(const void* q, const void* k, const void* v, void* o,
                                        void* part_m, void* part_l, void* part_acc, int batch,
                                        int hkv, int group, int hd, int dv, int length, int chunk,
                                        int n_split, const long long* strides, float scale,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || hkv <= 0 || group <= 0 || group > 2 * ROWS || hd <= 0 || hd > 256 ||
      hd % 16 != 0 || dv <= 0 || dv > hd || dv % 16 != 0 || length <= 0 || chunk <= 0 ||
      chunk % TILE != 0 || n_split <= 0 ||
      (long long)(n_split - 1) * chunk >= length || (long long)n_split * chunk < length)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.hq = hkv * group;
  a.group = group;
  a.hd = hd;
  a.dv = dv;
  a.length = length;
  a.chunk = chunk;
  a.n_split = n_split;
  a.slices = (group + ROWS - 1) / ROWS;
  a.q_sb = strides[0];
  a.q_sh = strides[1];
  a.k_sb = strides[2];
  a.k_ss = strides[3];
  a.k_sh = strides[4];
  a.v_sb = strides[5];
  a.v_ss = strides[6];
  a.v_sh = strides[7];
  a.o_sb = strides[8];
  a.o_sh = strides[9];
  a.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instantiation: hd and dv each rounded up to 64, 128 or 256
  if (hd <= 64) return static_cast<int>(launch<64, 64>(a, batch, hkv, s));
  if (hd <= 128)
    return static_cast<int>(dv <= 64 ? launch<128, 64>(a, batch, hkv, s)
                                     : launch<128, 128>(a, batch, hkv, s));
  if (dv <= 64) return static_cast<int>(launch<256, 64>(a, batch, hkv, s));
  if (dv <= 128) return static_cast<int>(launch<256, 128>(a, batch, hkv, s));
  return static_cast<int>(launch<256, 256>(a, batch, hkv, s));
}
