// Forward flash attention (blocked online softmax) on the CUDA cores, for
// float32 inputs.
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (_attn_kernel) for f32 q, k, v; bf16 inputs go to the tensor-core kernel
// of flash_attention_wgmma.cu (the wrapper chooses by dtype alone: TF32 or
// bf16 tensor cores cannot hold f32 attention to 1e-4).  It computes that
// kernel's function: q (B, Sq, H, d) and k/v (B, Sk, KV, d), f32; query i
// at position i + seq_offset sees
// key j when j <= i + seq_offset (causal) and i + seq_offset - j < window
// (windowed); q-head h reads kv-head h*KV/H in place (no repeat); scale is
// applied to q in f32; (m, l, acc) are f32; masked scores are -2^30 and
// their probabilities 0; the output is acc / (l + 1e-30), so a row that
// sees no key is 0.
//
// Layout: one block of 256 threads per (q-block of BQ = 64 rows, head h,
// batch b).  The block keeps its scaled q rows in shared memory and walks
// key tiles of BK = 32 between bounds taken from causality and the window
// (tiles wholly above the diagonal or wholly older than the window are
// never visited, as the TPU kernel prunes its k loop).  Each tile of K
// (stored transposed) and V is staged through shared memory in f32.  A
// thread owns 4 query rows: the 16 lanes of a half-warp share those rows,
// each lane taking every 16th key of the tile for the scores and every
// 16th column of d for the f32 accumulator, which lives in registers
// (4 x d/16 floats).  Row max and row sum reduce across the half-warp by
// shuffles.
//
// Shared memory per block: 4 * (BQ (d+1) + d (BK+1) + BK d + BQ (BK+1)) B,
// 140,800 B at d = 256, inside the 227 KB a block may use (the wrapper
// checks it against cudaDevAttrMaxSharedMemoryPerBlockOptin).
//
// What bounds it on this card: operations, at the f32 rate of the CUDA
// cores (the products need f32 to meet the f32 tolerance); its inner loops
// also wait on shared-memory loads, and K/V are staged through registers
// with no copy in flight during the products.  Only f32 models take it:
// the serving path runs bf16.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // keys per tile
constexpr int THREADS = 256;    // 16 row groups x 16 lanes
constexpr int ROWS = BQ / 16;   // query rows per thread
constexpr int KPT = BK / 16;    // keys per thread per tile
constexpr float NEG_INF = -1073741824.0f;  // -2^30, the reference's

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk,
                                        int causal, int window) {
  return kpos < Sk && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
          int H,
          int KV, float scale, int causal, int window, int seq_offset) {
  constexpr int CPT = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x (D+1): q * scale
  float* Kt = Qs + BQ * (D + 1);     // D x (BK+1): key tile, transposed
  float* Vs = Kt + D * (BK + 1);     // BK x D: value tile
  float* Ps = Vs + BK * D;           // BQ x (BK+1): probabilities

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * KV / H;
  const int tid = threadIdx.x;
  const int lane = tid & 15;
  const int r0 = (tid >> 4) * ROWS;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int s = q0 + r;
    float x = 0.f;
    if (s < Sq) x = q[(((size_t)b * Sq + s) * H + h) * D + c] * scale;
    Qs[r * (D + 1) + c] = x;
  }

  // key range [lo, hi) that any row of this block can see
  const int q_first = q0 + seq_offset;
  const int q_last = min(q0 + BQ, Sq) - 1 + seq_offset;
  const int hi = causal ? min(q_last + 1, Sk) : Sk;
  const int lo = window > 0 ? max(q_first - window + 1, 0) : 0;
  const int kb_lo = lo / BK;
  const int kb_hi = hi > lo ? (hi + BK - 1) / BK : kb_lo;

  float m[ROWS], l[ROWS], acc[ROWS][CPT];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[rr][cc] = 0.f;
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile is no longer read (and Qs is in)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      const int key = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (key < Sk) {
        const size_t off = (((size_t)b * Sk + key) * KV + kvh) * D + c;
        kx = k[off];
        vx = v[off];
      }
      Kt[c * (BK + 1) + r] = kx;
      Vs[r * D + c] = vx;
    }
    __syncthreads();

    float s[ROWS][KPT];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) s[rr][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[ROWS], kv[KPT];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) qv[rr] = Qs[(r0 + rr) * (D + 1) + c];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj)
        kv[jj] = Kt[c * (BK + 1) + lane + 16 * jj];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj)
          s[rr][jj] = fmaf(qv[rr], kv[jj], s[rr][jj]);
    }

#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int qpos = q0 + r0 + rr + seq_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        if (!visible(qpos, k0 + lane + 16 * jj, Sk, causal, window))
          s[rr][jj] = NEG_INF;
        mx = fmaxf(mx, s[rr][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[rr], mx);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const int kpos = k0 + lane + 16 * jj;
        const float p = visible(qpos, kpos, Sk, causal, window)
                            ? expf(s[rr][jj] - m_new) : 0.f;
        Ps[(r0 + rr) * (BK + 1) + lane + 16 * jj] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + psum;
      m[rr] = m_new;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[rr][cc] *= alpha;
    }
    __syncwarp();  // this row group's Ps rows come from its own half-warp

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[ROWS];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) pv[rr] = Ps[(r0 + rr) * (BK + 1) + kk];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vx = Vs[kk * D + lane + 16 * cc];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr)
          acc[rr][cc] = fmaf(pv[rr], vx, acc[rr][cc]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int s = q0 + r0 + rr;
    if (s >= Sq) continue;
    float* out = o + (((size_t)b * Sq + s) * H + h) * D;
    const float denom = l[rr] + 1e-30f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      out[lane + 16 * cc] = acc[rr][cc] / denom;
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, int KV, float scale, int causal,
             int window, int seq_offset, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<D><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Sk,
      H, KV, scale, causal, window, seq_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block needs at head dim D (-1: D not compiled).
extern "C" int flash_attention_smem_bytes(int D) {
  switch (D) {
    case 16: return smem_floats<16>() * 4;
    case 64: return smem_floats<64>() * 4;
    case 80: return smem_floats<80>() * 4;
    case 128: return smem_floats<128>() * 4;
    case 256: return smem_floats<256>() * 4;
    default: return -1;
  }
}

// The most dynamic shared memory a block may opt in to on `device`.
extern "C" int flash_attention_smem_limit(int device) {
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return bytes;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok, -1 =
// head dim not compiled).  q, k, v, o are float32; window <= 0 means no
// window.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int KV, int D,
                                      float scale, int causal, int window,
                                      int seq_offset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_d<16>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal,
                                 window, seq_offset, st);
    case 64: return launch_d<64>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal,
                                 window, seq_offset, st);
    case 80: return launch_d<80>(q, k, v, o, B, Sq, Sk, H, KV, scale, causal,
                                 window, seq_offset, st);
    case 128: return launch_d<128>(q, k, v, o, B, Sq, Sk, H, KV, scale,
                                   causal, window, seq_offset, st);
    case 256: return launch_d<256>(q, k, v, o, B, Sq, Sk, H, KV, scale,
                                   causal, window, seq_offset, st);
    default: return -1;
  }
}
