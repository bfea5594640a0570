// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over (B, S, W), f32.
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/rglru/kernel.py::rglru_scan_kernel (_rglru_kernel,
// _chunk_prefix), which walks 256-step chunks of a VMEM-resident
// (S, block_w) strip with a log-depth prefix inside each chunk.
//
// What bounds it here: bytes.  Each element of a and b is read once and
// each h written once (12 B per element, 503 MB at B=4, S=4096, W=2560)
// against 2 flops per element, far below the card's ~295 flop/B balance.
// Design: one thread per (b, w) channel walks t in order, so the result is
// the sequential recurrence exactly (the same two roundings per step as
// the plain version: the product, then the sum; no FMA contraction).  The
// loads of a_t and b_t do not depend on h: each thread issues UNROLL
// steps' loads before it runs their dependent chain, and neighbouring
// threads take neighbouring w, so every load and store of a warp is one
// 128-byte line.  Any S is handled (the Pallas kernel drops a remainder
// of S mod 256).  Blocks of 64 threads spread the B*W channels over more
// SMs (160 blocks at the serving shape).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (w >= W) return;
  const size_t base = (size_t)bi * S * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float state = h0[(size_t)bi * W + w];
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = __ldg(ap + (size_t)(t + u) * W);
      bv[u] = __ldg(bp + (size_t)(t + u) * W);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
      hp[(size_t)(t + u) * W] = state;
    }
  }
  for (; t < S; ++t) {
    state = __fadd_rn(__fmul_rn(__ldg(ap + (size_t)t * W), state),
                      __ldg(bp + (size_t)t * W));
    hp[(size_t)t * W] = state;
  }
  h_last[(size_t)bi * W + w] = state;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int rglru_scan_launch(const float* a, const float* b,
                                 const float* h0, float* h, float* h_last,
                                 int B, int S, int W, void* stream) {
  dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, h0, h, h_last, S, W);
  return (int)cudaGetLastError();
}
