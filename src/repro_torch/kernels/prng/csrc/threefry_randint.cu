// A solve tick's coordinate draws: jax.random.randint(key_r, (H_r,), 0,
// m_b_r) for every row r of a (..., n, 2) key plan, in one launch.
//
// Replaces no TPU kernel.  The reference draws with jax.random, whose
// threefry XLA fuses into the tick's program; the port computed the same
// bits with plain int64 PyTorch ops (core/prng.py::randint, which stays
// the plain version), one elementwise launch per add, shift, or, xor and
// mask over the whole draw: ~640 launches a tick, each reading and
// writing int64 tensors of the draw's size, and about six such tensors
// alive at once.  Here each draw is computed in registers and only its
// int32 result is written.
//
// Bit for bit what core/prng.py::randint computes (jax's partitionable
// threefry, jax >= 0.5):
//   k1, k2 = split(key, 2): threefry2x32(key, (0, 0)), threefry2x32(key,
//            (0, 1)), once per row;
//   hi, lo = the two words of threefry2x32(k1, (0, j)) XOR-ed, and of
//            threefry2x32(k2, (0, j)), for column j;
//   span   = m_b (1 where m_b <= 0);  mult = ((2^16 % span)^2 mod 2^32) %
//            span;
//   draw   = ((hi % span) * mult + lo % span) % span, in uint32
//            arithmetic that wraps.
// Columns from H_r up to the output's width are 0.
//
// What bounds it on this card: integer operations.  A draw is two
// threefry blocks (2 key adds, 20 rounds of add / rotate / xor, 5 key
// injections of two adds: 72 operations each, the rotate one funnel
// shift), the XOR of each block's words and three 32-bit remainders by
// the row's span (about six operations each once the reciprocal is
// hoisted out of a thread's columns), ~170 in all; its only memory
// traffic is the 4-byte store.  So one thread computes each draw
// in registers, the row's split keys, span and mult are computed once a
// block into shared memory, and consecutive threads store consecutive
// columns (coalesced).  A block covers kTile columns of one row, so a
// tick of 128 x 50,000 draws is 6,272 blocks, enough to fill 132 SMs.
//
// Plain C interface, loaded with ctypes (kernels/_build.py); the launch
// goes on the caller's stream and the return value is cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                    // columns a thread draws
constexpr int kTile = kThreads * kPerThread;     // columns a block draws
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
}

// Threefry-2x32, 20 rounds, on the counter (x0, x1) under key (k0, k1):
// the rotations (13, 15, 26, 6) and (17, 29, 16, 24) in turn, a key
// injection after every four rounds.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define TF_EVEN TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ODD TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  TF_EVEN x0 += k1; x1 += k2 + 1u;
  TF_ODD  x0 += k2; x1 += k0 + 2u;
  TF_EVEN x0 += k0; x1 += k1 + 3u;
  TF_ODD  x0 += k1; x1 += k2 + 4u;
  TF_EVEN x0 += k2; x1 += k0 + 5u;
#undef TF_ODD
#undef TF_EVEN
#undef TF_ROUND
}

// 32 random bits of column j under key (k0, k1): the block's two words
// XOR-ed (the counter's high word is 0 below 2^32 columns).
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         uint32_t j) {
  uint32_t x0 = 0u, x1 = j;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// Block b draws columns [tile * kTile, (tile + 1) * kTile) of row b /
// tiles, tile = b % tiles; row r is leaf r % n of config r / n.
__global__ void __launch_bounds__(kThreads)
threefry_randint_kernel(const int64_t* __restrict__ keys,
                        const int32_t* __restrict__ hcap,
                        const int32_t* __restrict__ maxval,
                        int32_t* __restrict__ out, int n, int width,
                        int tiles) {
  __shared__ uint32_t row_const[6];   // k1 (2 words), k2 (2), span, mult
  const long long row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int leaf = static_cast<int>(row % n);
  if (threadIdx.x < 2) {
    // split(key, 2): counter (0, i) for the i-th key
    uint32_t x0 = 0u, x1 = threadIdx.x;
    threefry2x32(static_cast<uint32_t>(keys[2 * row]),
                 static_cast<uint32_t>(keys[2 * row + 1]), x0, x1);
    row_const[2 * threadIdx.x] = x0;
    row_const[2 * threadIdx.x + 1] = x1;
  } else if (threadIdx.x == 2) {
    const int32_t mb = maxval[leaf];
    const uint32_t span = mb > 0 ? static_cast<uint32_t>(mb) : 1u;
    uint32_t mult = 65536u % span;
    mult = (mult * mult) % span;
    row_const[4] = span;
    row_const[5] = mult;
  }
  __syncthreads();
  const uint32_t a0 = row_const[0], a1 = row_const[1];
  const uint32_t b0 = row_const[2], b1 = row_const[3];
  const uint32_t span = row_const[4], mult = row_const[5];
  const int h = min(hcap[leaf], width);
  int32_t* dst = out + row * width;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int j = tile * kTile + k * kThreads + threadIdx.x;
    if (j >= width) break;
    int32_t v = 0;
    if (j < h) {
      const uint32_t hi = bits(a0, a1, static_cast<uint32_t>(j));
      const uint32_t lo = bits(b0, b1, static_cast<uint32_t>(j));
      const uint32_t off = (hi % span) * mult + lo % span;
      v = static_cast<int32_t>(off % span);
    }
    dst[j] = v;
  }
}

}  // namespace

extern "C" {

// rows (config, leaf) rows of int64 key words (rows, 2); hcap and maxval
// (n,) int32, one H and one m_b per leaf, row r reading leaf r % n; out
// (rows, width) int32.  Returns a cudaError_t.
int threefry_randint_launch(const int64_t* keys, const int32_t* hcap,
                            const int32_t* maxval, int32_t* out,
                            long long rows, int n, int width,
                            void* stream) {
  if (rows <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  const int tiles = (width + kTile - 1) / kTile;
  const long long blocks = rows * tiles;
  if (n <= 0 || blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  threefry_randint_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      keys, hcap, maxval, out, n, width, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
