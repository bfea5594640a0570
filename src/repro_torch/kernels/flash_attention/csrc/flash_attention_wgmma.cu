// Forward flash attention on Hopper tensor cores, for bfloat16 inputs.
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (_attn_kernel) for bf16 q, k, v; float32 inputs keep the CUDA-core kernel
// of flash_attention.cu (the wrapper chooses by dtype alone).  The function
// is that kernel's: q (B, Sq, H, d), k/v (B, Sk, KV, d); query i at
// position i + seq_offset sees key j when j <= i + seq_offset (causal) and
// i + seq_offset - j < window (windowed); q-head h reads kv-head h*KV/H in
// place; scores are scaled in f32; (m, l) are f32; masked scores are -2^30
// and their probabilities 0; the output is acc / (l + 1e-30) in bf16, so a
// row that sees no key is 0.
//
// Layout: one block of two consumer warpgroups (256 threads) per (q-block
// of BQ = 128 rows, head h, batch b); warpgroup g owns query rows
// [64 g, 64 g + 64).  Thread 0 issues every copy; there is no producer warp.
//   * Q comes in once by TMA; K and V tiles of BK = 64 keys come in by TMA
//     into a ring of 2 stages, each with an mbarrier that counts the bytes
//     in, so tile t + 1 is in flight while tile t is multiplied.  A stage is
//     refilled (tile t + 2) once both warpgroups have passed the block
//     barrier after tile t.
//   * Every tile is stored as 64-column panels of 128-byte rows with the
//     128-byte swizzle (the widest box a swizzled TMA copy takes), so a
//     256-wide row loads as four boxes.  Head dims that are not a multiple
//     of 64 are padded by the copy's out-of-bounds zero fill: d = 16 runs
//     as 64 columns, d = 80 as 128.  The zero columns add 0 to QK^T and
//     their PV columns are never stored.
//   * K/V are 4-D tensor maps over (d, KV, Sk, B) with boxes of
//     (64, 1, BK, 1), so GQA's kv-head stride needs no copy; q is the same
//     over (d, H, Sq, B).  Rows past Sq or Sk are zero-filled by the copy and
//     excluded by the mask.
//   * S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory,
//     f32 accumulators.  bf16 x bf16 products are exact in f32, so S differs
//     from the reference's f32 product only in summation order.  The scale
//     is applied to the f32 scores (1/sqrt(d) is not a power of two at
//     d = 80 or 128; rounding q * scale to bf16 would add an error).
//   * Online softmax on the accumulator fragment: a thread holds two rows
//     (r and r + 8) of the 64 x 64 tile; row max is a shuffle over the quad
//     that owns a row; l is summed per thread and over the quad at the end.
//     Tiles wholly above the diagonal or older than the window are never
//     visited (the k loop's bounds, per block and per warpgroup); the mask
//     is evaluated only on tiles that straddle the diagonal, the window
//     edge or the end of the keys.
//   * O += P V: wgmma m64n{64,128,256}k16 with P as the register A operand,
//     repacked from S's accumulator fragment (whose layout is the A
//     fragment's), and V as the B operand from shared memory in MN-major
//     form (the transpose bit).  The reference takes P V in f32; a bf16 P
//     (as FA2/FA3 and cuDNN round it) would be the one rounding point it
//     does not have, and on the card it left outputs one bf16 step from
//     the bf16 tolerance.  So P goes in as two bf16 parts, hi = bf16(p) and
//     lo = bf16(p - hi), each multiplied by V into the same f32
//     accumulators: P is then carried to about 16 bits (relative error
//     ~2^-17), for 4 more PV products a tile (one and a half times the
//     tensor work at d = 256).
//
// Shared memory: 1024 (alignment) + BQ dp 2 + 2 stages x 2 x BK dp 2 bytes
// + 3 mbarriers, dp = d padded to 64: 197,656 B at d = 256, one block per
// SM.
//
// What bounds it on this card: operations (about 1,400 flops a byte at
// the serving shape; the bound counts 4 d flops a visible pair, the split
// P makes it 6 d on the tensor cores).  Within a warpgroup the products
// are issued and waited for in turn (S, softmax, PV), so the tensor cores
// idle during a warpgroup's softmax unless the other warpgroup's products
// fill the gap; the two are not scheduled against each other (no
// ping-pong), and the block barrier per tile keeps them in step.  Letting
// them drift (per-stage "empty" mbarriers in place of the barrier) was
// tried and did not change the time on the card.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, which
// lives in libcuda, not in the runtime; the library links no -lcuda and
// takes the function's address from the runtime's entry-point query.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;         // query rows per block (two warpgroups)
constexpr int BK = 64;          // keys per tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int THREADS = 256;
constexpr int PANEL = 64;       // bf16 columns in one 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr float NEG_INF = -1073741824.0f;  // -2^30, the reference's

template <int DP>
constexpr int smem_bytes() {
  return 1024 + BQ * DP * 2 + STAGES * 2 * BK * DP * 2 + 8 * (1 + STAGES);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ----------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// waits for the phase of `bar` with the given parity to complete; a copy
// that never lands (a fault) traps after 4 s instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == 1024) t0 = global_ns();
    if (polls > 1024 && (polls & 1023) == 0 && global_ns() - t0 > 4000000000ull)
      __trap();
  }
}

// one box of a 4-D tensor map into shared memory; completion counts bytes
// on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// ---- wgmma ------------------------------------------------------------------
// Shared-memory matrix descriptor for a tile of 128-byte swizzled rows:
// start address, leading and stride byte offsets (16-byte units), layout 1
// (128-byte swizzle).  K-major operands: SBO = 1024 (8 rows), LBO unused.
// MN-major operands: LBO = bytes between 64-column panels, SBO = 1024 (8
// rows along K).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
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
// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 64, f32) += A (64 x 16, smem) * B (64 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) * B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64(o, a, db, 1);
  else if constexpr (DP == 128) wgmma_rs_n128(o, a, db, 1);
  else wgmma_rs_n256(o, a, db, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk,
                                        int causal, int window) {
  return kpos < Sk && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

// key-tile range [lo, hi) that query rows [r_first, r_last] can see
__device__ __forceinline__ void tile_range(int r_first, int r_last, int Sk,
                                           int causal, int window, int& kb_lo,
                                           int& kb_hi) {
  const int hi = causal ? min(r_last + 1, Sk) : Sk;
  const int lo = window > 0 ? max(r_first - window + 1, 0) : 0;
  kb_lo = lo / BK;
  kb_hi = hi > lo ? (hi + BK - 1) / BK : kb_lo;
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int KV,
                int D, float scale, int causal, int window, int seq_offset) {
  constexpr int NP = DP / PANEL;             // panels of a row
  constexpr int Q_BYTES = BQ * DP * 2;
  constexpr int T_BYTES = BK * DP * 2;       // one K or V tile
  constexpr int NO = DP / 2;                 // O accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + Q_BYTES;            // + stage * T_BYTES
  const uint32_t sV = sK + STAGES * T_BYTES;   // + stage * T_BYTES
  const uint32_t qbar = sV + STAGES * T_BYTES;
  const uint32_t full = qbar + 8;              // + stage * 8

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                     // consumer warpgroup
  const int warp = (tid >> 5) & 3;             // warp within it
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * KV / H;

  int kb_lo, kb_hi;   // tiles any row of the block sees
  tile_range(q0 + seq_offset, min(q0 + BQ, Sq) - 1 + seq_offset, Sk, causal,
             window, kb_lo, kb_hi);
  const int n_tiles = kb_hi - kb_lo;
  const int wq0 = q0 + 64 * wg;                // this warpgroup's first row
  const int wq_first = wq0 + seq_offset;
  const int wq_last = min(wq0 + 64, Sq) - 1 + seq_offset;
  int wkb_lo = 0, wkb_hi = 0;                  // tiles its rows see
  if (wq0 < Sq)
    tile_range(wq_first, wq_last, Sk, causal, window, wkb_lo, wkb_hi);

  if (tid == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_tile = [&](int stage, int kb) {
    const uint32_t bar = full + 8 * stage;
    mbar_expect_tx(bar, 2 * T_BYTES);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load(sK + stage * T_BYTES + p * BK * ROW_BYTES, &tk, bar,
               p * PANEL, kvh, kb * BK, b);
      tma_load(sV + stage * T_BYTES + p * BK * ROW_BYTES, &tv, bar,
               p * PANEL, kvh, kb * BK, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(qbar, Q_BYTES);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(sQ + p * BQ * ROW_BYTES, &tq, qbar, p * PANEL, h, q0, b);
    for (int s = 0; s < STAGES && s < n_tiles; ++s) load_tile(s, kb_lo + s);
  }

  // this thread's rows of the warpgroup's 64: r0 and r0 + 8
  const int r0 = 16 * warp + (lane >> 2);
  const int qpos0 = wq0 + r0 + seq_offset;
  const int qpos1 = qpos0 + 8;
  const int col = 2 * (lane & 3);   // first of this thread's two columns
  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % STAGES;
    const int kb = kb_lo + it;
    mbar_wait(full + 8 * stage, (it / STAGES) & 1);
    __syncwarp();
    if (kb >= wkb_lo && kb < wkb_hi) {   // uniform over the warpgroup
      // ---- S = Q K^T ------------------------------------------------------
      float sacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
      const uint32_t qa = sQ + wg * 64 * ROW_BYTES;
      const uint32_t ka = sK + stage * T_BYTES;
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int p = kk / 4, c = (kk % 4) * 32;
        wgmma_ss_n64(sacc,
                     desc_sw128(qa + p * BQ * ROW_BYTES + c, 16, 1024),
                     desc_sw128(ka + p * BK * ROW_BYTES + c, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // ---- online softmax on the fragment ---------------------------------
      // sacc[4j + e]: row r0 (e < 2) or r0 + 8 (e >= 2), key 8j + col + e%2
      const int k0 = kb * BK;
      const bool whole = k0 + BK <= Sk &&
                         (!causal || k0 + BK - 1 <= wq_first) &&
                         (window <= 0 || wq_last - k0 < window);
      uint32_t vis = 0xffffffffu;
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sacc[i] * scale;
        if (!whole) {
          const int kpos = k0 + 8 * (i >> 2) + col + (i & 1);
          if (!visible((i & 2) ? qpos1 : qpos0, kpos, Sk, causal, window)) {
            x = NEG_INF;
            vis &= ~(1u << i);
          }
        }
        sacc[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = (vis >> i) & 1u
                            ? __expf(sacc[i] - ((i & 2) ? mn1 : mn0)) : 0.f;
        sacc[i] = p;
        if (i & 2) ps1 += p;
        else ps0 += p;
      }
      const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < NO; ++i) oacc[i] *= (i & 2) ? al1 : al0;

      // ---- O += P V ---------------------------------------------------------
      // P's A fragments for the 4 k-steps of 16 keys: registers 8kk..8kk+7
      // of S's fragment, in order, as bf16 pairs (low half = lower key);
      // ph = bf16(p), pl = bf16(p - ph)
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sacc[8 * kk + 2 * r], x1 = sacc[8 * kk + 2 * r + 1];
          ph[kk][r] = pack_bf16(x0, x1);
          const __nv_bfloat162 hi =
              *reinterpret_cast<const __nv_bfloat162*>(&ph[kk][r]);
          pl[kk][r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
        }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
      fence_regs(oacc);
      const uint32_t va = sV + stage * T_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = desc_sw128(va + kk * 16 * ROW_BYTES,
                                       BK * ROW_BYTES, 1024);
        wgmma_pv<DP>(oacc, ph[kk], dv);
        wgmma_pv<DP>(oacc, pl[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oacc);
    }
    __syncthreads();   // both warpgroups are done with this stage
    if (tid == 0 && it + STAGES < n_tiles) load_tile(stage, kb + STAGES);
  }

  // ---- out = acc / (l + 1e-30), rows below Sq, columns below D -----------
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float den0 = l0 + 1e-30f, den1 = l1 + 1e-30f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = wq0 + r0 + 8 * half;
    if (s >= Sq) continue;
    __nv_bfloat16* out = o + (((size_t)b * Sq + s) * H + h) * D;
    const float den = half ? den1 : den0;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + col;
      if (c < D) {
        const uint32_t v = pack_bf16(oacc[4 * j + 2 * half] / den,
                                     oacc[4 * j + 2 * half + 1] / den);
        *reinterpret_cast<uint32_t*>(out + c) = v;
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, S, N, D) bf16 tensor as a 4-D map over (D, N, S, B), boxes of
// (64, 1, rows, 1) with the 128-byte swizzle; out-of-bounds reads are 0
CUresult make_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
                  int S, int N, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2,
                                 (cuuint64_t)S * N * D * 2};
  const cuuint32_t box[4] = {PANEL, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int KV, int D, float scale, int causal,
              int window, int seq_offset, cudaStream_t stream) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return -2;
  CUtensorMap tq, tk, tv;
  if (make_map(fn, &tq, q, B, Sq, H, D, BQ) != CUDA_SUCCESS ||
      make_map(fn, &tk, k, B, Sk, KV, D, BK) != CUDA_SUCCESS ||
      make_map(fn, &tv, v, B, Sk, KV, D, BK) != CUDA_SUCCESS)
    return -3;
  const int smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_wgmma<DP><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, Sq, Sk, H, KV, D, scale, causal, window,
      seq_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs at head dim D (-1: D not compiled).
extern "C" int flash_attention_wgmma_smem_bytes(int D) {
  switch (D) {
    case 16: case 64: return smem_bytes<64>();
    case 80: case 128: return smem_bytes<128>();
    case 256: return smem_bytes<256>();
    default: return -1;
  }
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok),
// -1 for a head dim not compiled, -2 when libcuda's tensor-map encoder
// cannot be found, -3 when a tensor map is refused.  window <= 0 means no
// window.  q, k, v, o are bf16, contiguous and 16-byte aligned.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int Sq, int Sk, int H, int KV,
                                            int D, float scale, int causal,
                                            int window, int seq_offset,
                                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: case 64:
      return launch_dp<64>(q, k, v, o, B, Sq, Sk, H, KV, D, scale, causal,
                           window, seq_offset, st);
    case 80: case 128:
      return launch_dp<128>(q, k, v, o, B, Sq, Sk, H, KV, D, scale, causal,
                            window, seq_offset, st);
    case 256:
      return launch_dp<256>(q, k, v, o, B, Sq, Sk, H, KV, D, scale, causal,
                            window, seq_offset, st);
    default: return -1;
  }
}
