// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over (B, S, W), f32,
// from h0 (B, W); writes h (B, S, W) and h_last (B, W).
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/rglru/kernel.py::rglru_scan_kernel (bodies
// _rglru_kernel and _chunk_prefix), which walks 256-step chunks of a
// VMEM-resident (S, block_w) strip with a log-depth prefix inside each
// chunk and drops a remainder of S mod 256.  This kernel is right for
// every S.
//
// What bounds it on this card: bytes.  Each element of a and b is read
// once and each h written once, 12 B an element (503 MB at B=4, S=4096,
// W=2560), against 2 flops an element, far below the card's ~295 flop/B
// balance.  So the design is about keeping enough reads in flight.
//
// In-flight arithmetic.  To keep 3.35 TB/s busy at ~0.7 us of loaded DRAM
// latency the card needs ~2.3 MB of reads in flight, ~18 KB an SM.  At the
// serving shape there are only B * W = 10,240 channels.  One thread a
// channel with 8 steps of a and b loaded ahead gives 320 warps (2.4 an SM)
// x 16 x 128 B = ~5 KB an SM, a quarter of that (such a kernel ran at
// 0.85 TB/s on the card).  Threads across channels are scarce at this
// shape, so the bytes in flight come from depth in time:
//   * A block owns kCols = 64 consecutive channels of one batch row
//     (160 blocks at the serving shape, all resident at once on 132 SMs):
//     kConsumers = 2 consumer warps, lane = channel, and one producer warp.
//   * The producer keeps a ring of kStages = 2 stages full, each stage
//     kRows = 32 time steps x 64 channels of a and of b (16 KB).  Each
//     stage has a "full" mbarrier the copies complete and an "empty"
//     mbarrier both consumers arrive on once they hold the stage in
//     registers, as in sdca_block.cu.  So a block keeps up to 32 KB of
//     reads in flight: at least 32 KB on every SM (1.2 blocks an SM) and
//     ~5 MB over the card, twice what the card needs.  Deeper rings (3 to
//     8 stages) and other stage shapes were measured at the serving shape
//     and were slower or no faster: with more rows in flight at once the
//     reads spread over more DRAM pages.
//   * With W % 4 == 0 and 16-byte aligned a and b, a stage is two TMA
//     copies (3-D tensor maps over (W, S, B), boxes of (64, 32, 1)); the
//     copies' zero fill covers the W and S tails, and each row of a box is
//     one 256-byte run.  Other shapes (the global stride must be a multiple
//     of 16 bytes, the base 16-byte aligned) take the cp.async route: the
//     producer's lanes copy 4 bytes each, zero-filling past the tails, and
//     the full mbarrier counts their 32 arrivals
//     (cp.async.mbarrier.arrive.noinc).  The wrapper picks the route
//     before the launch.
//   * A consumer lane reads a[t][lane] and b[t][lane] of a stage from
//     shared memory (32 consecutive words: no bank conflict), all 32 rows
//     before the first dependent step, releases the stage, then runs the
//     32 steps from registers and stores each h_t as one 128-byte line a
//     warp.  Staging h in shared memory for a TMA store was measured
//     against these stores and not kept (PERF.md).
// Why not a time-chunked parallel scan: it would change where the result
// is rounded.  Each channel's chain stays sequential, with the plain
// version's two roundings a step (the product, then the sum; no FMA
// contraction), so the kernel equals the plain version bit for bit.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, which
// lives in libcuda, not in the runtime; the library links no -lcuda and
// takes the function's address from the runtime's entry-point query.
// Plain C interface, loaded with ctypes (kernels/_build.py); the launch
// goes on the caller's stream.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 2;               // consumer warps a block
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kCols = 32 * kConsumers;      // channels a block
constexpr int kRows = 32;                   // time steps a stage
constexpr int kStages = 2;                  // ring depth
constexpr int kStageFloats = 2 * kRows * kCols;   // a then b

// 128 bytes of alignment slack, the ring, then full[kStages] and
// empty[kStages]
constexpr int kSmemBytes = 128 + kStages * kStageFloats * 4 + 16 * kStages;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
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

// one box of a 3-D tensor map into shared memory; completion counts bytes
// on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// 4 bytes from src, or zeros when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4u : 0u) : "memory");
}

// The producer warp: stage k (time steps k kRows ..) into ring slot
// k mod kStages, once both consumers have released the slot's previous
// stage.  bars: full[kStages], then empty[kStages].
template <bool kTma>
__device__ __forceinline__ void produce(const CUtensorMap* amap,
                                        const CUtensorMap* bmap,
                                        const float* __restrict__ a,
                                        const float* __restrict__ b,
                                        float* ring, uint32_t bars, int bi,
                                        int w0, int S, int W, int lane) {
  const int n_stages = (S + kRows - 1) / kRows;
  if (kTma && lane != 0) return;
  for (int k = 0; k < n_stages; ++k) {
    const int slot = k % kStages;
    const uint32_t full = bars + 8 * slot;
    if (k >= kStages)
      mbar_wait(bars + 8 * (kStages + slot), (k / kStages - 1) & 1);
    float* dst = ring + slot * kStageFloats;
    const int t0 = k * kRows;
    if constexpr (kTma) {
      mbar_expect_tx(full, kStageFloats * 4);
      tma_load(smem_u32(dst), amap, full, w0, t0, bi);
      tma_load(smem_u32(dst + kRows * kCols), bmap, full, w0, t0, bi);
    } else {
      for (int r = 0; r < kRows; ++r) {
        const int t = t0 + r;
#pragma unroll
        for (int j = lane; j < kCols; j += 32) {
          const bool ok = t < S && w0 + j < W;
          const size_t off = ok ? (static_cast<size_t>(bi) * S + t) * W + w0 + j
                                : 0;
          cp_async4(smem_u32(dst + r * kCols + j), a + off, ok);
          cp_async4(smem_u32(dst + (kRows + r) * kCols + j), b + off, ok);
        }
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                       "r"(full) : "memory");
    }
  }
}

// A consumer warp: channel w = w0 + 32 c + lane walks t in order.
__device__ __forceinline__ void consume(const float* ring, uint32_t bars,
                                        const float* __restrict__ h0,
                                        float* __restrict__ h,
                                        float* __restrict__ h_last, int bi,
                                        int w0, int S, int W, int c,
                                        int lane) {
  const int n_stages = (S + kRows - 1) / kRows;
  const int w = w0 + 32 * c + lane;
  const bool live = w < W;
  float state = live ? h0[static_cast<size_t>(bi) * W + w] : 0.0f;
  float* hp = h + static_cast<size_t>(bi) * S * W + w;
  for (int k = 0; k < n_stages; ++k) {
    const int slot = k % kStages;
    const uint32_t empty = bars + 8 * (kStages + slot);
    mbar_wait(bars + 8 * slot, (k / kStages) & 1);
    const float* as = ring + slot * kStageFloats + 32 * c + lane;
    const float* bs = as + kRows * kCols;
    const int t0 = k * kRows;
    float* hk = hp + static_cast<size_t>(t0) * W;
    if (t0 + kRows <= S) {
      float av[kRows], bv[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        av[u] = as[u * kCols];
        bv[u] = bs[u * kCols];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
        if (live) hk[static_cast<size_t>(u) * W] = state;
      }
    } else {
      const int rows = S - t0;
      for (int u = 0; u < rows; ++u) {
        state = __fadd_rn(__fmul_rn(as[u * kCols], state), bs[u * kCols]);
        if (live) hk[static_cast<size_t>(u) * W] = state;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty);
    }
  }
  if (live) h_last[static_cast<size_t>(bi) * W + w] = state;
}

// grid (ceil(W / kCols), B); kThreads threads; kSmemBytes of dynamic
// shared memory.  amap / bmap are read only on the TMA route.
template <bool kTma>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int S, int W) {
  extern __shared__ uint8_t smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const uint32_t bars = smem_u32(ring + kStages * kStageFloats);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * kCols;
  const int bi = blockIdx.y;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, kTma ? 1 : 32);
      mbar_init(bars + 8 * (kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kConsumers)
    produce<kTma>(&amap, &bmap, a, b, ring, bars, bi, w0, S, W, lane);
  else
    consume(ring, bars, h0, h, h_last, bi, w0, S, W, warp, lane);
}

// ---- host side --------------------------------------------------------------
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

// a (B, S, W) f32 tensor as a 3-D map over (W, S, B), boxes of
// (kCols, kRows, 1); out-of-bounds reads are 0
CUresult make_map(EncodeTiled fn, CUtensorMap* map, const float* ptr, int B,
                  int S, int W) {
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)S * W * 4};
  const cuuint32_t box[3] = {kCols, kRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <bool kTma>
int launch(const CUtensorMap& amap, const CUtensorMap& bmap, const float* a,
           const float* b, const float* h0, float* h, float* h_last, int B,
           int S, int W, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_kernel<kTma>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kCols - 1) / kCols, B);
  rglru_scan_kernel<kTma><<<grid, kThreads, kSmemBytes, stream>>>(
      amap, bmap, a, b, h0, h, h_last, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block takes: 128 bytes of alignment slack, a
// ring of kStages stages of kRows x kCols floats of a and of b, and a full
// and an empty 8-byte mbarrier a stage.
int rglru_scan_smem_bytes() { return kSmemBytes; }

// Largest dynamic shared memory (bytes) one block may use on `device`.
int rglru_scan_smem_limit(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok), -2
// when libcuda's tensor-map encoder cannot be found, -3 when a tensor map
// is refused.  tma != 0 takes the TMA route (W % 4 == 0, a and b 16-byte
// aligned), else the cp.async route.  S >= 1, B >= 1, W >= 1.
int rglru_scan_launch(const float* a, const float* b, const float* h0,
                      float* h, float* h_last, int B, int S, int W, int tma,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap amap = {}, bmap = {};
  if (!tma)
    return launch<false>(amap, bmap, a, b, h0, h, h_last, B, S, W, st);
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return -2;
  if (make_map(fn, &amap, a, B, S, W) != CUDA_SUCCESS ||
      make_map(fn, &bmap, b, B, S, W) != CUDA_SUCCESS)
    return -3;
  return launch<true>(amap, bmap, a, b, h0, h, h_last, B, S, W, st);
}

}  // extern "C"
