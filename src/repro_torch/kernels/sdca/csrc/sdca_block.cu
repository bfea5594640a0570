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
// A leading config axis B (the reference vmaps the Pallas call over a
// sweep's configs, which adds a grid axis): the grid has B * K blocks, and
// block (b, k) solves leaf k of config b.  X and y are shared by the
// configs (config stride 0, read at leaf k); alpha, xsq, idx, the step
// mask, delta alpha and delta w are config b's, at row b * K + k; w is at
// b * w_cfg_stride + k * w_stride (w_stride 0 for one w per config); lm is
// a device array of B floats, lm[b] read once into a register, so
// c = dl / lm is the same float operation for every B.  B = 1 is the
// single-config launch: a config's blocks compute exactly what they
// compute alone.
//
// What bounds it on this card: the chain of H dependent steps per leaf,
// not bytes and not operations (a leaf's block X[k], 16 MiB at m_b = 8192,
// d = 512, cannot stay on chip, but a step reads one 2 KiB row).  So the
// design takes everything it can off that chain:
//   * Rows arrive before their step.  idx[k, :] is known at launch, so a
//     ring of P row buffers in shared memory (P = 16 at d = 512; 4 to 16,
//     a multiple of G = 4) holds the rows of the next P steps.  A producer
//     warp fills it in groups of G rows, each group with a "full" mbarrier
//     the copies complete and an "empty" mbarrier the stepping warp
//     arrives on when it is done with the group, so the producer refills a
//     group P steps ahead of its use.  With d % 4 == 0 and 16-byte aligned
//     X a row is one cp.async.bulk (a 1-D TMA copy) counted in bytes on
//     the group's mbarrier; otherwise the producer's lanes copy 4 bytes each
//     with cp.async and the mbarrier counts their 32 arrivals
//     (cp.async.mbarrier.arrive.noinc).  The stepping warp waits once per
//     group of G steps and never issues a copy.
//   * One warp steps a leaf, so no block barrier sits in the step loop.
//     With d % 4 == 0, d <= 2048 and 16-byte aligned w and dw, each lane
//     holds its d/32 elements of w in registers (NC float4 chunks lane,
//     lane + 32, ..., NC = 1, 2, 4, 8 or 16 fixed at compile time; at d =
//     2,000 lanes 0-19 hold a 16th); <w, x_i> is an xor-shuffle
//     all-reduce, so every lane has the sum; every lane then evaluates
//     coord_delta on identical inputs and writes the identical a_i, so
//     nothing is broadcast through shared memory and no lane waits for
//     another.  Other d keep w in shared memory, each lane owning the same
//     elements in the dot and the update (still no barrier), a 4-byte
//     load-FMA-store chain the compiler cannot reorder, several times
//     slower a step than the register chunks (PERF.md, section 6, has the
//     measured steps).  w's space in shared memory stays reserved either
//     way, so the routes' sizes do not depend on the pointers.
//   * What bounds the d = 2,000 step in registers: the ring.  At d = 2,000
//     it holds one group of 4 rows (32 KiB), so the producer refills it
//     only once the group's four steps are done, and each group waits a
//     copy round trip.  At 128 or more resident leaves the row stream
//     itself (8,000 B a leaf a step) is the next bound.
//   * idx and the step mask are read 32 steps at a time, a block ahead, one
//     value per lane, and taken with a shuffle, so no global load sits on
//     the chain either.
// What remains per step: the row's shared-memory loads, the shuffle
// all-reduce, the loss's scalar update (for the logistic loss up to 16
// damped Newton iterations, two logf each, about 5 on typical data) and
// the w update.  Loading the next step's row and alpha, y, xsq before this
// step's dot was tried and made the squared loss's step slower on the
// card.  Four warps load alpha, y and xsq into shared memory before the
// chain and write delta alpha after it; a, y and xsq stay in shared
// memory, a_i read every step because idx may repeat.
//   * A leaf whose alpha, y and xsq do not fit beside the ring and w (m_b
//     above 16,036 at d = 2,000, above 19,059 at d = 54 on an H100) takes
//     the global-leaf route, sdca_block_kernel_gmem_leaf: only the ring
//     and w stay on chip.  The leaf's running alpha lives in the da
//     buffer (copied from alpha before the chain, turned into a_end -
//     alpha after it; the caller's alpha is only read), y and xsq where
//     they lie.  Like idx, the scalars come a block of 32 steps ahead:
//     early in each block, lane l loads alpha, y and xsq of its step in
//     the next block (28 to 59 steps before their use, from an idx read a
//     block earlier still), so no global load sits on the chain.  The
//     chain stores no alpha on its steps either: each lane keeps the
//     coordinate and the new alpha of its step in this block and in the
//     last one, and at a block's start the lane of the latest step that
//     drew each coordinate of the block before writes it back
//     (__match_any_sync).  The loads come 4 steps after those stores,
//     behind the __syncwarp that ends a group of rows, so they see every
//     block but the last two; a warp min over the two blocks' distances
//     finds the latest step that drew i, whose alpha is taken instead of
//     the loaded one.  (A store of a_i on every step makes each group's
//     mbarrier arrive, a release, wait for it: 2.91 against 2.42 us a step
//     at K = 8, m_b = 16,037, d = 2,000 on an H100, where the shared-memory
//     route takes 2.38.)  The route computes what the shared-memory route
//     computes, float for float, and is taken only where the leaf does not
//     fit in shared memory, by shape alone (kernels/sdca/kernel.py::route).
//
// Plain C interface, loaded with ctypes (kernels/_build.py); the launch
// goes on the caller's stream and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // warp 0 steps, warp 1 copies rows;
                                  // all four load and store the leaf
constexpr int kGroup = 4;         // rows per mbarrier of the ring
constexpr int kRingFloats = 8192;   // the ring's budget: 32 KiB

enum LossKind {
  kSquared = 0,
  kHinge = 1,
  kSmoothHinge = 2,
  kLogistic = 3,
  kCustom = 4     // a loss's own step, built with SDCA_CUSTOM_LOSS
};

// the logistic step's damped Newton iterations: at most
// core/dual.py::LOGISTIC_NEWTON_STEPS, ending once a step moves the
// iterate by at most LOGISTIC_STEP_TOL (every lane holds the same
// scalars, so the exit is warp-uniform)
constexpr int kLogisticNewtonSteps = 16;
constexpr float kLogisticStepTol = 1e-6f;

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

// logistic: damped Newton steps on u = (a + d) y in (eps, 1 - eps)
template <>
__device__ __forceinline__ float coord_delta<kLogistic>(float wx, float a,
                                                        float y, float xsq,
                                                        float) {
  const float lo = 1e-6f;
  const float hi = 0.999999f;
  float d = fminf(fmaxf(a * y, 0.25f), 0.75f) * y - a;
#pragma unroll 1
  for (int s = 0; s < kLogisticNewtonSteps; ++s) {
    const float u = fminf(fmaxf((a + d) * y, lo), hi);
    const float grad = -xsq * d - wx - y * (logf(u) - logf(1.0f - u));
    const float hess = -xsq - 1.0f / (u * (1.0f - u));
    float dn = d - grad / hess;
    const float un = (a + dn) * y;
    if (un <= 0.0f || un >= 1.0f) dn = fminf(fmaxf(un, lo), hi) * y - a;
    const bool small = fabsf(dn - d) <= kLogisticStepTol;
    d = dn;
    if (small) break;
  }
  return d;
}

#ifdef SDCA_CUSTOM_LOSS
// a registered loss's step: the prelude this library was built with
// (kernels/sdca/kernel.py::prelude, from the loss's `cuda` source)
// defines sdca_custom_coord_delta
template <>
__device__ __forceinline__ float coord_delta<kCustom>(float wx, float a,
                                                      float y, float xsq,
                                                      float g) {
  return sdca_custom_coord_delta(wx, a, y, xsq, g);
}
#endif

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int clamp_row(int i, int m_b) {
  // out-of-range coordinates clamp, as the TPU kernel's dynamic slices do
  return i < 0 ? 0 : (i >= m_b ? m_b - 1 : i);
}

__host__ __device__ __forceinline__ int ring_depth(int d) {
  const int p = kRingFloats / d / kGroup * kGroup;
  return p < 4 ? 4 : (p > 16 ? 16 : p);
}

// floats before the barriers: ring, w, alpha, y, xsq (even, so the
// barriers that follow are 8-byte aligned)
__host__ __device__ __forceinline__ size_t smem_floats(int m_b, int d) {
  const size_t n = static_cast<size_t>(ring_depth(d) + 1) * d +
                   3 * static_cast<size_t>(m_b);
  return n + (n & 1);
}

// the global-leaf route's floats before the barriers: ring and w
__host__ __device__ __forceinline__ size_t gmem_leaf_smem_floats(int d) {
  const size_t n = static_cast<size_t>(ring_depth(d) + 1) * d;
  return n + (n & 1);
}

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

// Values v[t] of a length-H row, for t = h + off as the step h advances:
// lane l holds v[32 c + off + l] for the current block c of 32 steps and
// the next block's value, loaded a block ahead.
template <typename T>
struct Lookahead {
  const T* v;
  int H, off;
  T cur, nxt;
  __device__ __forceinline__ T load(int t) const { return t < H ? v[t] : T(0); }
  __device__ __forceinline__ void start(const T* v_, int H_, int off_,
                                        int lane) {
    v = v_;
    H = H_;
    off = off_;
    cur = load(off + lane);
    nxt = load(off + 32 + lane);
  }
  // the value for step h (every lane calls it with the same h, in order)
  __device__ __forceinline__ T at(int h, int lane) {
    if ((h & 31) == 0 && h > 0) {
      cur = nxt;
      nxt = load(h + off + 32 + lane);
    }
    return __shfl_sync(0xffffffffu, cur, h & 31);
  }
};

// Warp 1: copies the rows of steps g0 .. g0 + G - 1 into ring group
// (g0 / G) mod (P / G), once the stepping warp has released the group's
// previous rows (steps g0 - P ..).  bars: full[P / G], then empty[P / G].
__device__ __forceinline__ void fill_ring(const float* __restrict__ Xk,
                                          const int32_t* __restrict__ idxk,
                                          float* ring, uint32_t bars,
                                          int m_b, int d, int H, bool bulk,
                                          int lane) {
  const int P = ring_depth(d);
  const int groups = P / kGroup;
  Lookahead<int32_t> rows;
  rows.start(idxk, H, 0, lane);
  for (int g0 = 0; g0 < H; g0 += kGroup) {
    const int grp = (g0 / kGroup) % groups;
    const uint32_t full = bars + 8 * grp;
    if (g0 >= P) mbar_wait(bars + 8 * (groups + grp), ((g0 - P) / P) & 1);
    const int n = min(kGroup, H - g0);
    float* dst = ring + static_cast<size_t>(grp) * kGroup * d;
    if (bulk && lane == 0) {
      const uint32_t bytes = static_cast<uint32_t>(d) * 4;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              full), "r"(bytes * n) : "memory");
    }
    for (int r = 0; r < kGroup; ++r) {
      if (r >= n) break;
      const int i = clamp_row(rows.at(g0 + r, lane), m_b);
      const float* src = Xk + static_cast<size_t>(i) * d;
      float* row = dst + r * d;
      if (bulk) {
        if (lane == 0)
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
              "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(row)),
              "l"(src), "r"(static_cast<uint32_t>(d) * 4), "r"(full)
              : "memory");
      } else {
        for (int j = lane; j < d; j += 32)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           smem_u32(row + j)), "l"(src + j) : "memory");
      }
    }
    if (!bulk)
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                       "r"(full) : "memory");
  }
}

// GL, warp 0: writes back the new alpha of each coordinate that the steps
// of a finished block drew (hi, ha: a lane's step), from the lane of its
// latest step (in a block, lane order is step order)
__device__ __forceinline__ void store_block(float* a_s, int hi, float ha,
                                            int lane) {
  const unsigned same = __match_any_sync(0xffffffffu, hi);
  if (hi >= 0 && (same >> lane) == 1u) a_s[hi] = ha;
}

// Warp 0: the leaf's H steps.  NC > 0: w in registers, NC float4 chunks a
// lane (d % 4 == 0, d <= 128 NC, 16-byte aligned w); NC == 0: w in w_s.
// GL: a_s (the running alpha), y_s and q_s are the leaf's rows in global
// memory, read 28 to 59 steps ahead (the global-leaf route).
template <int L, int NC, bool GL = false>
__device__ __forceinline__ void leaf_chain(
    const float* __restrict__ wk, const int32_t* __restrict__ idxk,
    const float* __restrict__ mk, float* __restrict__ dwk, const float* ring,
    float* w_s, float* a_s, const float* y_s, const float* q_s,
    uint32_t bars, int m_b, int d, int H, float lm, float g, int lane) {
  const int P = ring_depth(d);
  const int groups = P / kGroup;
  const int n4 = d >> 2;            // float4 chunks of a row
  float4 w4[NC > 0 ? NC : 1];
  if constexpr (NC > 0) {
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const int c = lane + 32 * t;
      w4[t] = c < n4 ? reinterpret_cast<const float4*>(wk)[c]
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  Lookahead<int32_t> step_idx;
  Lookahead<float> step_mask;
  step_idx.start(idxk, H, 0, lane);
  if (mk) step_mask.start(mk, H, 0, lane);
  // GL: lane l holds the scalars of step 32 c + l of the current block c
  // of 32 steps (ca, cy, cq) and of the next (na, ny, nq, loaded at block
  // c's step 4 from idx[32 (c + 1) + l], read a block before: ia), and the
  // coordinate and new alpha of step 32 (c - 1) + l (hi0, ha0) and, once
  // run, of step 32 c + l (hi1, ha1)
  float ca = 0.0f, cy = 0.0f, cq = 0.0f, na = 0.0f, ny = 0.0f, nq = 0.0f;
  float ha0 = 0.0f, ha1 = 0.0f;
  int hi0 = -1, hi1 = -1, ia = 0, ia_n = 0;
  if constexpr (GL) {
    if (lane < H) {
      const int t = clamp_row(idxk[lane], m_b);
      ca = a_s[t];
      cy = y_s[t];
      cq = q_s[t];
    }
    if (32 + lane < H) ia = idxk[32 + lane];
    if (64 + lane < H) ia_n = idxk[64 + lane];
  }

  int slot = 0;   // ring slot of step h: h mod P
  for (int h = 0; h < H; ++h) {
    const int i = clamp_row(step_idx.at(h, lane), m_b);
    const float mh = mk ? step_mask.at(h, lane) : 1.0f;
    if constexpr (GL) {
      const int r = h & 31;
      if (r == 0 && h > 0) {   // block c = h / 32 starts
        store_block(a_s, hi1, ha1, lane);   // block c - 1's new alphas
        hi0 = hi1;
        ha0 = ha1;
        hi1 = -1;
        ca = na;
        cy = ny;
        cq = nq;
        ia = ia_n;                          // idx[h + 32 + lane]
        ia_n = h + 64 + lane < H ? idxk[h + 64 + lane] : 0;
      }
      // block c + 1's scalars: after the __syncwarp that ended step h - 1,
      // so every store of the blocks before c is seen
      if (r == 4 && h + 28 + lane < H) {
        const int t = clamp_row(ia, m_b);
        na = a_s[t];
        ny = y_s[t];
        nq = q_s[t];
      }
    }
    const int grp = slot / kGroup;
    if (slot % kGroup == 0) mbar_wait(bars + 8 * grp, (h / P) & 1);
    const float* x = ring + static_cast<size_t>(slot) * d;

    float part = 0.0f;
    float4 x4[NC > 0 ? NC : 1];
    if constexpr (NC > 0) {
      float p4[NC];   // one partial a chunk, summed as a tree
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        const int c = lane + 32 * t;
        x4[t] = c < n4 ? reinterpret_cast<const float4*>(x)[c]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        p4[t] = w4[t].x * x4[t].x + w4[t].y * x4[t].y + w4[t].z * x4[t].z +
                w4[t].w * x4[t].w;
      }
      // 16 partials are folded to 8 first: the tree's loop over 16 left p4
      // in local memory (a 64-byte stack frame, 16 stores a step); the
      // additions and their order are the loop's
      if constexpr (NC == 16) {
#pragma unroll
        for (int t = 0; t < 8; ++t) p4[t] += p4[t + 8];
      }
#pragma unroll
      for (int n = NC < 16 ? NC : 8; n > 1; n >>= 1)
#pragma unroll
        for (int t = 0; t < n / 2; ++t) p4[t] += p4[t + n / 2];
      part = p4[0];
    } else {
      for (int j = lane; j < d; j += 32) part += w_s[j] * x[j];
    }
    const float wx = warp_sum(part);   // every lane holds the sum

    float a, yi, qi;
    if constexpr (GL) {
      const int r = h & 31;
      a = __shfl_sync(0xffffffffu, ca, r);
      yi = __shfl_sync(0xffffffffu, cy, r);
      qi = __shfl_sync(0xffffffffu, cq, r);
      // ca was loaded after the stores of every block before the last, so
      // the latest of steps h - 32 - r .. h - 1 that drew i, if one did,
      // holds a newer a_i.  Key: distance, block (1 the current), lane;
      // the smallest key over the warp wins
      const unsigned k0 = hi0 == i ? (32u + r - lane) << 6 | lane : ~0u;
      const unsigned k1 = hi1 == i ? (0u + r - lane) << 6 | 32u | lane : ~0u;
      const unsigned last = __reduce_min_sync(0xffffffffu, min(k0, k1));
      const float a0 = __shfl_sync(0xffffffffu, ha0, last & 31);
      const float a1 = __shfl_sync(0xffffffffu, ha1, last & 31);
      if (last != ~0u) a = last & 32u ? a1 : a0;
    } else {
      a = a_s[i];
      yi = y_s[i];
      qi = q_s[i];
    }
    float dl = coord_delta<L>(wx, a, yi, qi, g);
    if (mk) dl = dl * mh;
    if constexpr (GL) {
      if (lane == (h & 31)) {   // this lane's step of the block
        hi1 = i;
        ha1 = a + dl;
      }
    } else {
      a_s[i] = a + dl;   // every lane writes the same value
    }
    const float c = dl / lm;
    if constexpr (NC > 0) {
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        w4[t].x = w4[t].x + c * x4[t].x;
        w4[t].y = w4[t].y + c * x4[t].y;
        w4[t].z = w4[t].z + c * x4[t].z;
        w4[t].w = w4[t].w + c * x4[t].w;
      }
    } else {
      for (int j = lane; j < d; j += 32) w_s[j] = w_s[j] + c * x[j];
    }
    if (slot % kGroup == kGroup - 1) {   // done with this group's rows
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (groups + grp));
    }
    if (++slot == P) slot = 0;
  }
  if constexpr (GL) store_block(a_s, hi1, ha1, lane);   // the last block

  if constexpr (NC > 0) {
#pragma unroll
    for (int t = 0; t < NC; ++t) {
      const int c = lane + 32 * t;
      if (c < n4) {
        const float4 w0 = reinterpret_cast<const float4*>(wk)[c];
        reinterpret_cast<float4*>(dwk)[c] =
            make_float4(w4[t].x - w0.x, w4[t].y - w0.y, w4[t].z - w0.z,
                        w4[t].w - w0.w);
      }
    }
  }
}

template <int L, int NC>
__global__ void __launch_bounds__(kThreads)
sdca_block_kernel(const float* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ alpha,
                  const float* __restrict__ w, const float* __restrict__ xsq,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ mask, float* __restrict__ da,
                  float* __restrict__ dw, int K, int m_b, int d, int H,
                  int w_stride, long long w_cfg_stride,
                  const float* __restrict__ lm, float g, int bulk) {
  extern __shared__ __align__(16) float smem[];
  const int P = ring_depth(d);
  const int groups = P / kGroup;
  float* ring = smem;              // P x d
  float* w_s = ring + P * d;       // d (NC > 0: unused)
  float* a_s = w_s + d;            // m_b
  float* y_s = a_s + m_b;          // m_b
  float* q_s = y_s + m_b;          // m_b
  // full[groups], then empty[groups]
  const uint32_t bars = smem_u32(smem + smem_floats(m_b, d));

  const int tid = threadIdx.x;
  const int b = blockIdx.x / K;    // config
  const int k = blockIdx.x % K;    // leaf
  const size_t row = static_cast<size_t>(blockIdx.x);   // b * K + k
  const size_t xb = static_cast<size_t>(k) * m_b;       // shared X, y
  const size_t kb = row * m_b;                          // config b's leaf k
  const float* wk = w + static_cast<size_t>(b) * w_cfg_stride +
                    static_cast<size_t>(k) * w_stride;
  const int32_t* idxk = idx + row * H;

  if (NC == 0)
    for (int j = tid; j < d; j += kThreads) w_s[j] = wk[j];
  for (int i = tid; i < m_b; i += kThreads) {
    a_s[i] = alpha[kb + i];
    y_s[i] = y[xb + i];
    q_s[i] = xsq[kb + i];
  }
  if (tid == 0) {
    for (int s = 0; s < groups; ++s) {
      mbar_init(bars + 8 * s, bulk ? 1 : 32);
      mbar_init(bars + 8 * (groups + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 32)
    leaf_chain<L, NC>(wk, idxk, mask ? mask + row * H : nullptr,
                      dw + row * d, ring, w_s, a_s, y_s, q_s, bars, m_b, d,
                      H, lm[b], g, tid);
  else if (tid < 64)
    fill_ring(X + xb * d, idxk, ring, bars, m_b, d, H, bulk != 0, tid - 32);
  __syncthreads();

  if (NC == 0)
    for (int j = tid; j < d; j += kThreads) dw[row * d + j] = w_s[j] - wk[j];
  for (int i = tid; i < m_b; i += kThreads) da[kb + i] = a_s[i] - alpha[kb + i];
}

// The global-leaf route: as sdca_block_kernel, but the leaf's running
// alpha lives in da (alpha copied in before the chain, a_end - alpha
// written after it) and its y and xsq stay where they lie; the ring and w
// alone take shared memory.
template <int L, int NC>
__global__ void __launch_bounds__(kThreads)
sdca_block_kernel_gmem_leaf(
    const float* __restrict__ X, const float* __restrict__ y,
    const float* __restrict__ alpha, const float* __restrict__ w,
    const float* __restrict__ xsq, const int32_t* __restrict__ idx,
    const float* __restrict__ mask, float* __restrict__ da,
    float* __restrict__ dw, int K,
    int m_b, int d, int H, int w_stride, long long w_cfg_stride,
    const float* __restrict__ lm, float g, int bulk) {
  extern __shared__ __align__(16) float smem[];
  const int P = ring_depth(d);
  const int groups = P / kGroup;
  float* ring = smem;              // P x d
  float* w_s = ring + P * d;       // d (NC > 0: unused)
  const uint32_t bars = smem_u32(smem + gmem_leaf_smem_floats(d));

  const int tid = threadIdx.x;
  const int b = blockIdx.x / K;
  const int k = blockIdx.x % K;
  const size_t row = static_cast<size_t>(blockIdx.x);
  const size_t xb = static_cast<size_t>(k) * m_b;
  const size_t kb = row * m_b;
  const float* wk = w + static_cast<size_t>(b) * w_cfg_stride +
                    static_cast<size_t>(k) * w_stride;
  const int32_t* idxk = idx + row * H;
  float* a_run = da + kb;          // the leaf's running alpha

  if (NC == 0)
    for (int j = tid; j < d; j += kThreads) w_s[j] = wk[j];
  for (int i = tid; i < m_b; i += kThreads) a_run[i] = alpha[kb + i];
  if (tid == 0) {
    for (int s = 0; s < groups; ++s) {
      mbar_init(bars + 8 * s, bulk ? 1 : 32);
      mbar_init(bars + 8 * (groups + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 32)
    leaf_chain<L, NC, true>(wk, idxk, mask ? mask + row * H : nullptr,
                            dw + row * d, ring, w_s, a_run, y + xb, xsq + kb,
                            bars, m_b, d, H, lm[b], g, tid);
  else if (tid < 64)
    fill_ring(X + xb * d, idxk, ring, bars, m_b, d, H, bulk != 0, tid - 32);
  __syncthreads();

  if (NC == 0)
    for (int j = tid; j < d; j += kThreads) dw[row * d + j] = w_s[j] - wk[j];
  for (int i = tid; i < m_b; i += kThreads) a_run[i] = a_run[i] - alpha[kb + i];
}

template <int L, int NC, bool GL>
cudaError_t launch_path(const float* X, const float* y, const float* alpha,
                        const float* w, const float* xsq, const int32_t* idx,
                        const float* mask, float* da, float* dw, int B,
                        int K, int m_b, int d, int H, int w_stride,
                        long long w_cfg_stride, const float* lm, float g,
                        int bulk, cudaStream_t stream) {
  const size_t floats = GL ? gmem_leaf_smem_floats(d) : smem_floats(m_b, d);
  const size_t smem = floats * sizeof(float) + 16 * (ring_depth(d) / kGroup);
  auto kernel = GL ? sdca_block_kernel_gmem_leaf<L, NC>
                   : sdca_block_kernel<L, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B * K, kThreads, smem, stream>>>(
      X, y, alpha, w, xsq, idx, mask, da, dw, K, m_b, d, H, w_stride,
      w_cfg_stride, lm, g, bulk);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch(const float* X, const float* y, const float* alpha,
                   const float* w, const float* xsq, const int32_t* idx,
                   const float* mask, float* da, float* dw, int B, int K,
                   int m_b, int d, int H, int w_stride,
                   long long w_cfg_stride, const float* lm, float g,
                   bool gmem_leaf, cudaStream_t stream) {
  // bulk copies need 16-byte aligned rows of a multiple of 16 bytes; w in
  // registers needs float4 access to w and dw and d <= 2048
  const bool bulk = d % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const bool reg_w = d % 4 == 0 && d <= 2048 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  const int bulk_i = bulk ? 1 : 0;
#define SDCA_PATH(NC, GL)                                                   \
  launch_path<L, NC, GL>(X, y, alpha, w, xsq, idx, mask, da, dw, B, K, m_b, \
                         d, H, w_stride, w_cfg_stride, lm, g, bulk_i, stream)
#define SDCA_ROUTE(NC) \
  (gmem_leaf ? SDCA_PATH(NC, true) : SDCA_PATH(NC, false))
  if (!reg_w) return SDCA_ROUTE(0);
  if (d <= 128) return SDCA_ROUTE(1);
  if (d <= 256) return SDCA_ROUTE(2);
  if (d <= 512) return SDCA_ROUTE(4);
  if (d <= 1024) return SDCA_ROUTE(8);
  return SDCA_ROUTE(16);
#undef SDCA_ROUTE
#undef SDCA_PATH
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a leaf of m_b examples in d
// dimensions: a ring of ring_depth(d) rows, w, alpha, y and xsq, and two
// 8-byte mbarriers (full, empty) per group of kGroup ring rows.
long long sdca_block_smem_bytes(int m_b, int d) {
  return static_cast<long long>(smem_floats(m_b, d)) * 4 +
         16 * (ring_depth(d) / kGroup);
}

// The same for the global-leaf route, whatever m_b: the ring, w and the
// mbarriers.
long long sdca_block_gmem_leaf_smem_bytes(int d) {
  return static_cast<long long>(gmem_leaf_smem_floats(d)) * 4 +
         16 * (ring_depth(d) / kGroup);
}

// Largest dynamic shared memory (bytes) one block may use on `device`.
int sdca_block_smem_limit(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return optin;
}

// B configs x K leaves in one launch: X (K, m_b, d) and y (K, m_b) shared;
// alpha, xsq (B, K, m_b); idx, mask (B, K, H); da (B, K, m_b); dw (B, K, d);
// lm (B,) on the device.  w_stride: 0 for one w per config, d for
// per-leaf rows; w_cfg_stride: the floats between two configs' w.
// loss: 0 squared, 1 hinge, 2 smoothed hinge (smoothing g), 3 logistic,
// 4 the custom loss a library built with SDCA_CUSTOM_LOSS holds.
// mask may be null (no step gating).  gmem_leaf: 1 for the global-leaf
// route, 0 for the shared-memory one (the wrapper's choice by shape).
// Returns a cudaError_t.
int sdca_block_launch(const float* X, const float* y, const float* alpha,
                      const float* w, const float* xsq, const int32_t* idx,
                      const float* mask, float* da, float* dw, int B, int K,
                      int m_b, int d, int H, int w_stride,
                      long long w_cfg_stride, const float* lm, int loss,
                      float g, int gmem_leaf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
#define SDCA_LOSS(L)                                                      \
  launch<L>(X, y, alpha, w, xsq, idx, mask, da, dw, B, K, m_b, d, H,      \
            w_stride, w_cfg_stride, lm, g, gmem_leaf != 0, s)
  switch (loss) {
    case kSquared:
      return SDCA_LOSS(kSquared);
    case kHinge:
      return SDCA_LOSS(kHinge);
    case kSmoothHinge:
      return SDCA_LOSS(kSmoothHinge);
    case kLogistic:
      return SDCA_LOSS(kLogistic);
#ifdef SDCA_CUSTOM_LOSS
    case kCustom:
      return SDCA_LOSS(kCustom);
#endif
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SDCA_LOSS
}

}  // extern "C"
