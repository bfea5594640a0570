// Blocked LocalSDCA (Procedure P) for every leaf of a tick in one launch.
//
// Replaces the TPU kernel src/repro/kernels/sdca/kernel.py::sdca_block_kernel
// (bodies _sdca_steps, _sdca_kernel, _sdca_kernel_masked).  For each of K
// leaf blocks it runs H strictly sequential coordinate steps
//     wx = <w, x_i>;  dlt = coord_delta(wx, a_i, y_i, xsq_i) * mask_h;
//     a_i += dlt;     w += (dlt / lm) * x_i
// and writes (a_end - a0, w_end - w0).  xsq = sum(X^2) / lm is computed by
// the caller, as on the TPU.
//
// Design: one CTA per leaf (the grid is the paper's "for all workers in
// parallel"; K = 128 leaves fill the 132 SMs of an H100 in one wave).  The
// leaf's private w copy and its alpha, y and xsq vectors live in shared
// memory for the whole launch; the block X[k] (m_b * d floats, 16 MiB at
// m_b = 8192, d = 512) cannot, so row x_i is read from device memory each
// step, coalesced, and read a second time (from L1) for the rank-1 update.
// <w, x_i> is a warp-shuffle reduction, then one cross-warp pass; thread 0
// evaluates coord_delta and broadcasts dlt / lm through shared memory.
// Each thread owns the same columns in the dot and in the update, so the
// only barriers are the two around the cross-warp reduction.
//
// What bounds it on this card: not bytes and not operations but the chain
// of H dependent steps per leaf.  Each step waits for its row to arrive
// from device memory, for two block barriers, and for thread 0's scalar
// update (eight Newton iterations with two logf each for the logistic
// loss) before the next step can start.  What a later version can do:
// idx is known before the launch, so row x_{idx[h+1]} can be prefetched
// into shared memory with cp.async or TMA while step h reduces, taking
// the row's latency off the chain; only the barrier and scalar latency
// would then remain per step.
//
// Plain C interface, loaded with ctypes (kernels/_build.py); the launch
// goes on the caller's stream and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum LossKind { kSquared = 0, kHinge = 1, kSmoothHinge = 2, kLogistic = 3 };

__device__ __forceinline__ float clip01(float q) {
  return fminf(fmaxf(q, 0.0f), 1.0f);
}

template <int L>
__device__ __forceinline__ float coord_delta(float wx, float a, float y,
                                             float xsq, float g);

// squared: d = (y - wx - a) / (1 + xsq)
template <>
__device__ __forceinline__ float coord_delta<kSquared>(float wx, float a,
                                                       float y, float xsq,
                                                       float) {
  return (y - wx - a) / (1.0f + xsq);
}

// hinge: q = (1 - y wx) / max(xsq, 1e-12) + a y;  d = y clip(q, 0, 1) - a
template <>
__device__ __forceinline__ float coord_delta<kHinge>(float wx, float a,
                                                     float y, float xsq,
                                                     float) {
  const float q = (1.0f - y * wx) / fmaxf(xsq, 1e-12f) + a * y;
  return y * clip01(q) - a;
}

// smoothed hinge: q = (1 - y wx - g a y) / (xsq + g) + a y
template <>
__device__ __forceinline__ float coord_delta<kSmoothHinge>(float wx, float a,
                                                           float y, float xsq,
                                                           float g) {
  const float q = (1.0f - y * wx - g * a * y) / (xsq + g) + a * y;
  return y * clip01(q) - a;
}

// logistic: 8 damped Newton steps on u = (a + d) y in (eps, 1 - eps)
template <>
__device__ __forceinline__ float coord_delta<kLogistic>(float wx, float a,
                                                        float y, float xsq,
                                                        float) {
  const float lo = 1e-6f;
  const float hi = 0.999999f;
  float d = fminf(fmaxf(a * y, 0.25f), 0.75f) * y - a;
#pragma unroll 1
  for (int s = 0; s < 8; ++s) {
    const float u = fminf(fmaxf((a + d) * y, lo), hi);
    const float grad = -xsq * d - wx - y * (logf(u) - logf(1.0f - u));
    const float hess = -xsq - 1.0f / (u * (1.0f - u));
    float dn = d - grad / hess;
    const float un = (a + dn) * y;
    if (un <= 0.0f || un >= 1.0f) dn = fminf(fmaxf(un, lo), hi) * y - a;
    d = dn;
  }
  return d;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int clamp_row(int i, int m_b) {
  // out-of-range coordinates clamp, as the TPU kernel's dynamic slices do
  return i < 0 ? 0 : (i >= m_b ? m_b - 1 : i);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
sdca_block_kernel(const float* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ alpha,
                  const float* __restrict__ w, const float* __restrict__ xsq,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ mask, float* __restrict__ da,
                  float* __restrict__ dw, int m_b, int d, int H,
                  int w_stride, float lm, float g) {
  extern __shared__ float smem[];
  float* w_s = smem;          // d
  float* a_s = w_s + d;       // m_b
  float* y_s = a_s + m_b;     // m_b
  float* q_s = y_s + m_b;     // m_b
  __shared__ float red[kWarps];
  __shared__ float coef;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k = blockIdx.x;
  const size_t kb = static_cast<size_t>(k) * m_b;
  const float* Xk = X + kb * d;
  const float* wk = w + static_cast<size_t>(k) * w_stride;
  const int32_t* idxk = idx + static_cast<size_t>(k) * H;
  const float* mk = mask ? mask + static_cast<size_t>(k) * H : nullptr;

  for (int j = tid; j < d; j += kThreads) w_s[j] = wk[j];
  for (int i = tid; i < m_b; i += kThreads) {
    a_s[i] = alpha[kb + i];
    y_s[i] = y[kb + i];
    q_s[i] = xsq[kb + i];
  }
  __syncthreads();

  // the next step's coordinate (and mask) is loaded one step ahead
  int i_next = H > 0 ? clamp_row(idxk[0], m_b) : 0;
  float m_next = (mk && H > 0) ? mk[0] : 1.0f;
  for (int h = 0; h < H; ++h) {
    const int i = i_next;
    const float mh = m_next;
    if (h + 1 < H) {
      i_next = clamp_row(idxk[h + 1], m_b);
      if (mk) m_next = mk[h + 1];
    }
    const float* xi = Xk + static_cast<size_t>(i) * d;

    float part = 0.0f;
    for (int j = tid; j < d; j += kThreads) part += w_s[j] * xi[j];
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (warp == 0) {
      float v = lane < kWarps ? red[lane] : 0.0f;
      v = warp_sum(v);
      if (lane == 0) {
        float dl = coord_delta<L>(v, a_s[i], y_s[i], q_s[i], g);
        if (mk) dl = dl * mh;
        a_s[i] = a_s[i] + dl;
        coef = dl / lm;
      }
    }
    __syncthreads();
    const float c = coef;
    for (int j = tid; j < d; j += kThreads) w_s[j] = w_s[j] + c * xi[j];
  }
  __syncthreads();

  for (int j = tid; j < d; j += kThreads)
    dw[static_cast<size_t>(k) * d + j] = w_s[j] - wk[j];
  for (int i = tid; i < m_b; i += kThreads) da[kb + i] = a_s[i] - alpha[kb + i];
}

template <int L>
cudaError_t launch(const float* X, const float* y, const float* alpha,
                   const float* w, const float* xsq, const int32_t* idx,
                   const float* mask, float* da, float* dw, int K, int m_b,
                   int d, int H, int w_stride, float lm, float g,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d + 3 * m_b) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sdca_block_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sdca_block_kernel<L><<<K, kThreads, smem, stream>>>(
      X, y, alpha, w, xsq, idx, mask, da, dw, m_b, d, H, w_stride, lm, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest dynamic shared memory (bytes) one block of this kernel may use
// on `device`: the opt-in limit less the kernel's static shared memory.
int sdca_block_smem_limit(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, sdca_block_kernel<kSquared>) !=
      cudaSuccess)
    return -1;
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

// loss: 0 squared, 1 hinge, 2 smoothed hinge (smoothing g), 3 logistic.
// w_stride: 0 for one w shared by all leaves, d for per-leaf rows.
// mask may be null (no step gating).  Returns a cudaError_t.
int sdca_block_launch(const float* X, const float* y, const float* alpha,
                      const float* w, const float* xsq, const int32_t* idx,
                      const float* mask, float* da, float* dw, int K, int m_b,
                      int d, int H, int w_stride, float lm, int loss, float g,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (loss) {
    case kSquared:
      return launch<kSquared>(X, y, alpha, w, xsq, idx, mask, da, dw, K, m_b,
                              d, H, w_stride, lm, g, s);
    case kHinge:
      return launch<kHinge>(X, y, alpha, w, xsq, idx, mask, da, dw, K, m_b,
                            d, H, w_stride, lm, g, s);
    case kSmoothHinge:
      return launch<kSmoothHinge>(X, y, alpha, w, xsq, idx, mask, da, dw, K,
                                  m_b, d, H, w_stride, lm, g, s);
    case kLogistic:
      return launch<kLogistic>(X, y, alpha, w, xsq, idx, mask, da, dw, K,
                               m_b, d, H, w_stride, lm, g, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
