// GQA prefill attention with an online softmax on the tensor cores: bf16,
// wgmma fed by TMA, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:71
// (flash_attention, body _flash_kernel :28) on the bf16 route:
//
//     o[b, h, i, :] = softmax_j(scale * q[b, h, i, :] . k[b, h / group, j, :]) @ v[b, h / group, :, :]
//
// with the bottom-right causal mask j <= i + (sk - sq). csrc/flash_attention.cu
// stays the f32 route and the route for what this kernel does not take (the
// wrapper's rule, flash_attention.py): this one takes bf16 with a query/key
// head dim dk up to 128 and a value head dim dv <= dk (MLA: dk 96, dv 64),
// and 16-byte-aligned operands whose batch, head and sequence strides are
// multiples of 8 elements, as TMA needs. The tiles are padded to whole
// 64-wide boxes: TMA zero-fills the columns past dk and dv, which add
// exactly nothing to Q . K^T, and O's columns past dv are never stored. The
// S loop runs DK / 16 steps, DK = dk rounded up to 64, 96 or 128, a
// compile-time count: a run-time bound around the wgmma would make the
// compiler fence every one of them (ptxas C7519).
//
// What bounds it on an H100. The chatglm3-6b prefill (B 4, 32 query heads,
// 2 KV heads, S 2048, d 128, causal) does 1.4e11 flop a layer on 8.4e7
// bytes: operations bound it, 0.139 ms at the 989 TFLOP/s bf16 tensor-core
// peak. The f32 SIMT kernel can do no better than 2.1 ms; only wgmma reaches
// the tensor cores' rate.
//
// Design: the FlashAttention-3 block, kept as simple as it allows. One block
// of three warpgroups per (128-row query tile, query head, batch); the query
// tiles run longest first (the tile index is the grid's slowest dimension,
// reversed), so the causal tail of short tiles fills the card at the end.
//   * Warpgroup 2 is the producer (setmaxnreg down to 24 registers): one
//     thread issues TMA loads: Q's tile once, then K and V tiles of 128
//     keys into a 2-stage ring, each stage with full barriers for K and for
//     V (mbarrier, transaction bytes) and an empty barrier that both
//     consumers release. TMA reads 4-D (d, heads, seq, batch) tensor maps
//     built from each operand's own strides, so the model's (B, S, H, d)
//     projections go in as transpose(1, 2) views with no copy, and it
//     zero-fills rows past sq and sk. Tiles land with the 128-byte swizzle:
//     a box is 64 bf16 wide (128 bytes), so a d-128 row is two boxes, and
//     every tile is [d / 64][rows][64].
//   * Warpgroups 0 and 1 are the consumers (setmaxnreg up to 240), 64 query
//     rows each. S = Q . K^T is wgmma m64n128k16 with A (Q) and B (K) in
//     shared memory, both K-major, through B128 descriptors. The online
//     softmax runs on the accumulator in registers: a row's values sit in
//     the four threads of a quad, which reduce its max and sum with
//     shuffles; m_new = max(m, rowmax), alpha = 2^(m - m_new),
//     p = 2^(s - m_new), l = l * alpha + sum p, o = o * alpha + p . v (the
//     reference's order). Logits are kept in log2 units: the scale is
//     premultiplied by log2(e) and exp2f replaces expf, the same function.
//     P is rounded to bf16 in place (the accumulator's layout is wgmma's A
//     register fragment) and O += P . V is wgmma with A from registers and
//     B = the V tile read MN-major through the descriptor's transpose bit,
//     so V is never transposed. Logits, max, sum and O stay f32; only P is
//     rounded, which is what tensor cores take (the reference keeps P f32).
//   * Masks: keys past sk get -inf (they add exactly 0), keys above the
//     causal diagonal -1e30 (the reference's value), only in tiles that
//     reach the diagonal or sk; tiles wholly above the diagonal are not
//     loaded, and a consumer skips a tile that lies wholly above its own
//     rows. Rows past sq are computed on TMA's zero rows and not stored.
// The shared-memory opt-in is set once per instantiation, so no attribute
// call lands inside a CUDA graph capture; the tensor maps are encoded on
// the host at every call (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint, so no library beyond the runtime is linked) and
// passed as __grid_constant__ parameters.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 128;          // query rows per block (two consumer warpgroups of 64)
constexpr int BK = 128;          // keys per tile
constexpr int THREADS = 384;     // consumers: warpgroups 0 and 1; producer: warpgroup 2
constexpr int BOX_BYTES = 128;   // one swizzled row: 64 bf16
constexpr int BLOCK_BYTES = 128 * BOX_BYTES;  // a [128 rows][64] bf16 block of a tile
constexpr float MASKED = -1e30f;  // the reference's masked logit
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;  // output strides (elements); d has stride 1
  int hq, group, sq, sk, causal, n_qt;
  int dv;  // v's head dim (<= DV): O's columns to store
  float scale_log2;  // scale * log2(e)
};

template <int DK, int DV>
constexpr int smem_bytes() {
  // Q and two K stages of ceil(DK / 64) blocks, two V stages of DV / 64;
  // barriers; 1024 for alignment
  return (3 * ((DK + 63) / 64) + 2 * (DV / 64)) * BLOCK_BYTES + 64 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pin a register across the asynchronous wgmma: the compiler may neither
// read an accumulator early nor reuse an A register before the wait
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) (+)= A (64 x 16, bf16 registers) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs_t(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 16, bf16 registers) . B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// FULL: dv == DV, every column of O is stored (no test in the epilogue: an
// instantiation for dv == DV compiles as the kernel did before dv existed).
// Paired on an H100 by tools/attention_time.py, the test in every
// instantiation made chatglm3-6b's prefill 4.7 % slower (0.500 against
// 0.478 ms), d 64 3.2 % and MLA's (96, 64) 1.9 %.
template <int DK, int DV, bool FULL>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int NB = (DK + 63) / 64;  // 64-wide blocks of q's and k's head dim
  constexpr int NBV = DV / 64;  // 64-wide blocks of v's
  constexpr int NO = DV / 2;    // O accumulator registers a thread holds
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + NB * BLOCK_BYTES;        // [2 stages][NB][BK][64]
  const uint32_t sV = sK + 2 * NB * BLOCK_BYTES;    // [2 stages][NBV][BK][64]
  const uint32_t bar = sV + 2 * NBV * BLOCK_BYTES;  // q_full, k_full[2], v_full[2], empty[2]
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8u * (1 + s); };
  auto v_full = [&](int s) { return bar + 8u * (3 + s); };
  auto empty = [&](int s) { return bar + 8u * (5 + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (p.n_qt - 1 - blockIdx.z) * BQ;  // longest causal tiles first
  const int hk = h / p.group;
  const int offset = p.sk - p.sq;  // bottom-right causal alignment
  // keys the block's last row can see: j <= (q0 + BQ - 1) + offset
  const int k_end = p.causal ? min(p.sk, q0 + BQ + offset) : p.sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 256);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, NB * BLOCK_BYTES);
      for (int c = 0; c < NB; ++c) tma_load_4d(sQ + c * BLOCK_BYTES, &tm_q, c * 64, h, q0, b, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t & 1;
        if (t >= 2) mbar_wait(empty(s), ((t >> 1) - 1) & 1);  // tile t - 2 released
        const uint32_t dk = sK + s * NB * BLOCK_BYTES, dv = sV + s * NBV * BLOCK_BYTES;
        mbar_expect_tx(k_full(s), NB * BLOCK_BYTES);
        for (int c = 0; c < NB; ++c)
          tma_load_4d(dk + c * BLOCK_BYTES, &tm_k, c * 64, hk, t * BK, b, k_full(s));
        mbar_expect_tx(v_full(s), NBV * BLOCK_BYTES);
        for (int c = 0; c < NBV; ++c)
          tma_load_4d(dv + c * BLOCK_BYTES, &tm_v, c * 64, hk, t * BK, b, v_full(s));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int g = lane / 4, tig = lane % 4;
    const int row0 = q0 + 64 * wg + 16 * warp + g;  // rows row0 and row0 + 8
    const int wg_last = q0 + 64 * wg + 63;          // the warpgroup's last row

    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.0f;
    float sacc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sacc[i] = 0.0f;
    float m[2] = {MASKED, MASKED};  // the reference's initial running max
    float l[2] = {0.0f, 0.0f};      // this thread's part of the row sums

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t & 1;
      const uint32_t ph = (t >> 1) & 1;
      const int k0 = t * BK;
      mbar_wait(k_full(s), ph);
      if (!p.causal || k0 <= wg_last + offset) {
        // S = Q . K^T
        const uint32_t dk = sK + s * NB * BLOCK_BYTES;
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(sacc[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          const uint32_t off = (kk / 4) * BLOCK_BYTES + (kk % 4) * 32;
          const uint64_t da = desc_sw128(sQ + off + wg * 64 * BOX_BYTES, 16, 1024);
          const uint64_t db = desc_sw128(dk + off, 16, 1024);
          wgmma_m64n128k16_ss(sacc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(sacc[i]);

        // masks and the online softmax; sacc[4 j + 2 i + c] is row row0 + 8 i,
        // key k0 + 8 j + 2 tig + c
        const bool edge = k0 + BK > p.sk || (p.causal && k0 + BK - 1 > row0 - g - 16 * warp + offset);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float x = sacc[4 * j + 2 * i + c] * p.scale_log2;
              if (edge) {
                const int key = k0 + 8 * j + 2 * tig + c;
                if (key >= p.sk) {
                  x = -INFINITY;  // past the keys: contributes exactly 0
                } else if (p.causal && key > row0 + 8 * i + offset) {
                  x = MASKED;
                }
              }
              sacc[4 * j + 2 * i + c] = x;
              mx[i] = fmaxf(mx[i], x);
            }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m[i], mx[i]);
          alpha[i] = exp2f(m[i] - m_new);
          m[i] = m_new;
        }
        float rsum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float e = exp2f(sacc[4 * j + 2 * i + c] - m[i]);
              sacc[4 * j + 2 * i + c] = e;
              rsum[i] += e;
            }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o[4 * j + 0] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        // P in bf16 as wgmma's A fragments: keys 16 kk .. 16 kk + 15
        uint32_t pa[8][4];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
        }

        // O += P . V, V read MN-major: 64-wide d blocks BK rows apart (LBO),
        // 8-key groups 1024 bytes apart (SBO)
        mbar_wait(v_full(s), ph);
        const uint32_t dv = sV + s * NBV * BLOCK_BYTES;
#pragma unroll
        for (int i = 0; i < NO; ++i) reg_fence(o[i]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint64_t db = desc_sw128(dv + kk * 16 * BOX_BYTES, BLOCK_BYTES, 1024);
          if constexpr (DV == 128) {
            wgmma_m64n128k16_rs_t(o, pa[kk], db, 1);
          } else {
            wgmma_m64n64k16_rs_t(o, pa[kk], db, 1);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < NO; ++i) reg_fence(o[i]);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) reg_fence(pa[kk][r]);
      } else {
        mbar_wait(v_full(s), ph);  // wholly above this warpgroup's rows: nothing to add
      }
      mbar_arrive(empty(s));
    }

    // o / l, rows < sq and columns < dv only
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < p.sq) {
        __nv_bfloat16* orow = ob + row * p.o_ss + 2 * tig;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          if (FULL || 8 * j < p.dv)  // dv % 8 == 0: a pair lies wholly inside or out
            *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                pack_bf16(o[4 * j + 2 * i] / l[i], o[4 * j + 2 * i + 1] / l[i]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// 4-D (d, heads, seq, batch) map of a bf16 operand with unit stride along d;
// strides in elements; boxes of 64 x 1 x rows x 1 with the 128-byte swizzle
CUresult encode(CUtensorMap* map, const void* ptr, int d, int heads, int seq, int batch,
                long long s_h, long long s_s, long long s_b, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_s * 2, (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                     strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DK, int DV, bool FULL>
cudaError_t launch_one(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                       const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DK, DV>();
  auto kernel = flash_attention_sm90_kernel<DK, DV, FULL>;
  // opt in to more than 48 KB of dynamic shared memory, once per
  // instantiation (so that no such call lands inside a CUDA graph capture)
  static cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (configured != cudaSuccess) return configured;
  const dim3 grid(p.hq, batch, p.n_qt);
  kernel<<<grid, THREADS, smem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                   const Params& p, int batch, cudaStream_t stream) {
  return p.dv == DV ? launch_one<DK, DV, true>(mq, mk, mv, p, batch, stream)
                    : launch_one<DK, DV, false>(mq, mk, mv, p, batch, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes); bf16 only; d (q and k) up to
// 128, dv (v and o) a multiple of 8 up to d.
// strides: 12 values, (batch, head, seq) of q, k, v and o in that order, in
// elements (the batch stride of a batch of one is not read). Launches on `stream`, does not synchronize, and returns 0
// on success, a CUDA runtime error, or 10000 + the driver's error from
// encoding a tensor map (10000 alone: cuTensorMapEncodeTiled not found).
extern "C" int repro_flash_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                          int batch, int hq, int hk, int sq, int sk, int d,
                                          int dv, const long long* strides, float scale,
                                          int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch <= 0 || hq <= 0 || hk <= 0 || hq % hk != 0 || sq <= 0 || sk <= 0 || d <= 0 ||
      d > 128 || d % 8 != 0 || dv <= 0 || dv > d || dv % 8 != 0 || (causal && sq > sk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_fn() == nullptr) return 10000;
  // a batch of one is never stepped over: give its map any valid stride
  auto batch_stride = [&](int i, int heads, int seq) {
    const long long a = strides[i + 1] * heads, b = strides[i + 2] * seq;
    return batch > 1 ? strides[i] : (a > b ? a : b);
  };
  CUtensorMap mq, mk, mv;
  CUresult res = encode(&mq, q, d, hq, sq, batch, strides[1], strides[2], batch_stride(0, hq, sq), BQ);
  if (res == CUDA_SUCCESS)
    res = encode(&mk, k, d, hk, sk, batch, strides[4], strides[5], batch_stride(3, hk, sk), BK);
  if (res == CUDA_SUCCESS)
    res = encode(&mv, v, dv, hk, sk, batch, strides[7], strides[8], batch_stride(6, hk, sk), BK);
  if (res != CUDA_SUCCESS) return 10000 + static_cast<int>(res);
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.hq = hq;
  p.group = hq / hk;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.n_qt = (sq + BQ - 1) / BQ;
  p.dv = dv;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instantiation: dk rounded up to 64, 96 or 128, dv to 64 or 128
  if (d <= 64)
    err = launch<64, 64>(mq, mk, mv, p, batch, s);
  else if (d <= 96)  // dv <= 96: a DV of 128 is never full
    err = dv <= 64 ? launch<96, 64>(mq, mk, mv, p, batch, s)
                   : launch_one<96, 128, false>(mq, mk, mv, p, batch, s);
  else
    err = dv <= 64 ? launch<128, 64>(mq, mk, mv, p, batch, s)
                   : launch<128, 128>(mq, mk, mv, p, batch, s);
  return static_cast<int>(err);
}
