// Forward and backward of a whole squeezed-TCN group (a chain of p TCMs),
// for Hopper. The backward is described where it starts, below.
//
// Replaces the TPU kernel eabnet_tpu/kernels/tcm_chain.py::_fwd_kernel
// (math in _tcm_fwd_math). On the trunk x (B, T, D), TCM j computes
//   h  = x @ wi[j]                                   (D -> C = 64)
// (a narrower chain comes zero-padded to C = 64 by its wrapper,
// kernels/tcm_chain.py::pad_weights: a zero channel stays 0 throughout)
//   n  = IN_T(PReLU(h)) per branch                   (stats over all of T)
//   c  = sum_i shift(n, (K-1-i) dil_j) @ w[j, i]     (causal dilated conv)
//   g  = cL * sigmoid(cR)  (twin, EaBNet)  or  cL    (single, GaGNet)
//   x += IN_T(PReLU(g)) @ wo[j]                      (C -> D, residual)
//
// What bounds it: per group about 0.6 GFLOP (EaBNet) or 0.25 GFLOP
// (GaGNet) on ~3 MB of activations and weights at T = 701, so the card's
// f32 rate is the roofline; but each instance norm needs a reduction over
// all of T before anything downstream of it, and the conv needs a left
// halo of up to (K-1) * 32 = 128 frames.
//
// Design: the Pallas kernel keeps one sample's (T, 256) trunk resident in
// VMEM; at T = 701 that is 718 KB, beyond one SM's 227 KB. Here the trunk
// stays in global memory (it lives in L2) and the work is cut into tiles
// of TT = 16 frames of one sample, one mma row block, spread over a
// cooperative grid. A tile never changes owner, so the trunk update of TCM
// j and the in-projection of TCM j+1 need no grid barrier. Per TCM there
// are three phases and two grid barriers:
//   A: h = x @ wi, PReLU per branch -> global; per-tile (mean, M2) stats
//   -- grid.sync --
//   B: merge the tiles' stats, normalise the K shifted input windows of the
//      tile (zeros before t = 0), conv, gate, PReLU -> global; per-tile
//      stats of the gate output
//   -- grid.sync --
//   C: merge stats, normalise, x += . @ wo, write the trunk
// The levers of the forward, in the order a clock split of the first
// design ranked them (eabnet_tpu_torch/tools/tcm_chain_split.py, whose
// numbers PERF.md keeps; the backward's first lever, its weight
// gradients, is below):
// - Staging: each phase loads its tile once into shared memory, and phase
//   B (and the backward's R3) normalises all K shifted windows of both
//   branches in one pass (2 x 5 x 16 rows at K = 5), so the taps' products
//   run with no barrier between them.
// - Merges: the T-wide statistics of a sample are merged once per phase by
//   the whole block in parallel (mean = sum n_i mean_i / T, then M2 = sum
//   M2_i + n_i (mean_i - mean)^2: Chan's merge, exact, in two reductions),
//   4 threads per channel and two shuffles, into shared memory.
// - Fill: no weight is staged in shared memory (each is read once per tile
//   as an mma fragment, from L2), so a block needs at most ~49 KB (twin
//   K = 5) and 80 registers: three blocks per SM, and at the main paths'
//   shapes (B = 7, 8 at T = 601; B = 7 at T = 701) every block takes one
//   tile. The grid is every tile or as many blocks as are co-resident.
// - Products: every product runs on the tensor cores as three TF32
//   products (tf32x3.cuh), mma.sync m16n8k8: the 16-frame tile is the
//   16-row A operand, read from shared memory (rows padded to 8 mod 32
//   floats), each warp owns 8 (C-wide outputs) or 32 (D-wide) columns and
//   reads its weight fragments straight from global memory. Each k-step's
//   three products go into zeroed registers and are then added in float32:
//   the tensor cores' own float32 sum truncates, and a chain of 96 mma into
//   one accumulator drifted past the forward's 2e-5.
// What holds it back now (the same split, counters compiled in): the
// products, about half of every phase's clocks, wait on their weight
// fragments; every 16-frame tile reads all of a phase's weights from L2
// (576 KB per TCM of an EaBNet group in the backward), and 80 registers
// leave room for only two k-steps of them in flight.
// Statistics and sums are float32.
//
// bfloat16 serving (eabnet_tcm_chain_fwd_bf16) runs the same phases with
// the Pallas kernel's bf16 operands: x, the weights and the (P, 3, C)
// tables arrive in bf16, the tables read as float32 from their values.
// Each product is one mma.sync m16n8k8 with bf16 operands and a float32
// sum in place of the three TF32 products: the A fragment is the staged
// float32 tile rounded to bf16 where the fragment is built, the B
// fragment the bf16 weights as stored. Each k-step still goes into zeroed
// registers and is added in float32. The trunk stays float32 between the
// TCMs, in the workspace (a bf16 y would round it after every TCM, which
// the Pallas kernel does not): phase A of TCM 0 reads x once and writes
// its float32 copy, phase C of the last TCM writes y in bf16 once. The
// statistics, PReLU and gate are float32, as in the float32 kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int C = 64;      // squeezed channels
constexpr int TT = 16;     // frames per tile: one mma row block
constexpr int NT = 256;    // threads per block
constexpr int MAXD = 256;  // trunk width
constexpr int MAXK = 8;
constexpr int MAXP = 16;
constexpr float EPS = 1e-5f;
constexpr int SC = C + 8;     // row stride of a C-wide tile in shared memory
constexpr int SD = MAXD + 8;  // row stride of a D-wide tile
// merged statistics in shared memory: mean, inverse deviation and the
// backward's two sums, per slot (branch L, branch R, gate output)
constexpr int NSTAT = 4 * 3 * C;
constexpr int MIN_BLOCKS = 3;  // co-resident blocks per SM the kernels ask for

// Clock counters, for eabnet_tpu_torch/tools/tcm_chain_split.py, which
// builds this file with TCM_CHAIN_CLOCKS defined: lane 0 of each warp adds
// the clocks since its last mark to (phase, category) in shared memory,
// and the block writes them to tcm_clk[block][warp] at the end. Without
// TCM_CHAIN_CLOCKS the marks are empty and CK_SYNC is __syncthreads().
enum { PH_A, PH_B, PH_C, PH_R1, PH_R2, PH_R3, PH_R4, CK_PH };
#ifdef TCM_CHAIN_CLOCKS
enum { CK_MERGE, CK_STAGE, CK_PRODUCT, CK_BARRIER, CK_GRID, CK_OTHER, CK_N };
constexpr int CK_SLOT = CK_PH * CK_N + 1;  // counters, then the last mark
constexpr int CK_FLOATS = (NT / 32) * CK_SLOT * 2;
__device__ long long* tcm_clk;

__device__ __forceinline__ long long* ck_slot() {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<long long*>(smem4) + (threadIdx.x >> 5) * CK_SLOT;
}

__device__ __forceinline__ void ck_mark(int ph, int cat) {
  if ((threadIdx.x & 31) == 0) {
    long long* s = ck_slot();
    const long long now = clock64();
    s[ph * CK_N + cat] += now - s[CK_SLOT - 1];
    s[CK_SLOT - 1] = now;
  }
}

__device__ void ck_init() {
  if ((threadIdx.x & 31) == 0) {
    long long* s = ck_slot();
    for (int i = 0; i < CK_SLOT - 1; ++i) s[i] = 0;
    s[CK_SLOT - 1] = clock64();
  }
}

__device__ void ck_flush() {
  if ((threadIdx.x & 31) == 0 && tcm_clk) {
    const size_t warp = (size_t)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
    long long* o = tcm_clk + warp * (CK_SLOT - 1);
    for (int i = 0; i < CK_SLOT - 1; ++i) o[i] = ck_slot()[i];
  }
}
#define CK(ph, cat) ck_mark(ph, cat)
#define CK_SYNC(ph, cat) \
  do {                   \
    ck_mark(ph, cat);    \
    __syncthreads();     \
    ck_mark(ph, CK_BARRIER); \
  } while (0)
#else
constexpr int CK_FLOATS = 0;
__device__ __forceinline__ void ck_init() {}
__device__ __forceinline__ void ck_flush() {}
#define CK(ph, cat) \
  do {              \
  } while (0)
#define CK_SYNC(ph, cat) __syncthreads()
#endif

using bf16 = __nv_bfloat16;

// W: the type of x, the weights and the tables (float, or bf16 serving)
template <typename W>
struct ArgsT {
  const W* x;   // (B, T, D)
  const W* wi;  // (P, D, C)
  const W* wl;  // (P, K, C, C)  (tap, in, out)
  const W* wr;  // (P, K, C, C)  (ignored when single)
  const W* wo;  // (P, C, D)
  const W* al;  // (P, 3, C)  PReLU slopes [L, R, out]
  const W* ga;  // (P, 3, C)  IN scale
  const W* be;  // (P, 3, C)  IN bias
  float* y;     // (B, T, D)  trunk (float32), then the output (float32)
  W* out;       // (B, T, D)  the output of a bf16 chain (y is its trunk)
  float* pbuf;  // (2, B, T, C)  branch PReLU outputs
  float* pobuf; // (B, T, C)     gate PReLU output
  float* stats; // (3, B ntile, C, 2)  per-tile (mean, M2) per slot
  int B, T, D, K, P, ntile;
  int dil[MAXP];
};
using Args = ArgsT<float>;

__device__ __forceinline__ float sigm(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float prelu(float v, float a) {
  return fmaxf(v, 0.0f) + a * fminf(v, 0.0f);
}

template <typename W>
__device__ __forceinline__ int tile_rows(const ArgsT<W>& a, int tile) {
  return min(TT, a.T - tile * TT);
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// two and four bf16 values read as float32
__device__ __forceinline__ float2 ldg2(const bf16* p) {
  const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xFFFF0000u));
}

__device__ __forceinline__ float4 ldg4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xFFFF0000u));
}

__device__ __forceinline__ void st2(float* p, float u, float v) {
  *reinterpret_cast<float2*>(p) = make_float2(u, v);
}

__device__ __forceinline__ void st2(bf16* p, float u, float v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
}

__device__ __forceinline__ void st1(float* p, float v) { *p = v; }

__device__ __forceinline__ void st1(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The lane's place in the mma fragments: warp w, group g (rows g, g + 8),
// quad tq (k = 2 tq, 2 tq + 1 of each k-step; C columns 2 tq, 2 tq + 1).
struct Lane {
  int w, g, tq;
  __device__ Lane()
      : w(threadIdx.x >> 5), g((threadIdx.x & 31) >> 2), tq(threadIdx.x & 3) {}
};

// A fragment of a 16-row tile in shared memory (row stride S), k-step at
// k0: the mma's k slots tq and tq + 4 hold k0 + 2 tq and k0 + 2 tq + 1, so
// each row pair is one float2; B fragments are permuted alike.
__device__ __forceinline__ void frag_a(const float* t, int S, int k0,
                                       const Lane& l, uint32_t* ah,
                                       uint32_t* al) {
  const float* p = t + l.g * S + k0 + 2 * l.tq;
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 v = *reinterpret_cast<const float2*>(p + 8 * S);
  split_tf32(u.x, ah[0], al[0]);
  split_tf32(v.x, ah[1], al[1]);
  split_tf32(u.y, ah[2], al[2]);
  split_tf32(v.y, ah[3], al[3]);
}

// B fragment of B[k][n] = W[k][n] (W row-major, rows of N): k, k + 1 at n
__device__ __forceinline__ void frag_b(const float* W, int N, int k, int n,
                                       bool ok, uint32_t* bh, uint32_t* bl) {
  const float u = ok ? __ldg(W + (size_t)k * N + n) : 0.0f;
  const float v = ok ? __ldg(W + (size_t)(k + 1) * N + n) : 0.0f;
  split_tf32(u, bh[0], bl[0]);
  split_tf32(v, bh[1], bl[1]);
}

// B fragment of B[k][n] = W[n][k] (W row-major, rows of Kd): one float2
__device__ __forceinline__ void frag_bt(const float* W, int Kd, int k, int n,
                                        bool ok, uint32_t* bh, uint32_t* bl) {
  const float2 u = ok ? ldg2(W + (size_t)n * Kd + k) : make_float2(0.f, 0.f);
  split_tf32(u.x, bh[0], bl[0]);
  split_tf32(u.y, bh[1], bl[1]);
}

// c += a b as mma3 into zeroed registers, then a float32 add: the tensor
// cores' float32 sum truncates, so a long chain of mma into one
// accumulator drifts (one k-step's terms are summed inside the mma)
__device__ __forceinline__ void mma3_add(float* c, const uint32_t* ah,
                                         const uint32_t* al,
                                         const uint32_t* bh,
                                         const uint32_t* bl) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, ah, al, bh, bl);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// The products, by operand type: an A fragment of a staged float32 tile
// (a()), then c += A B for a B fragment of the weights W (row-major
// [k][n], rows of N) at k, k + 1 and column n (mac()), or of W^T (W
// row-major [n][k], rows of Kd; mac_t(), the backward's). float: three
// TF32 products; bf16: the tile rounded to bf16, one bf16 product. The
// bf16 m16n8k8 takes the same (k0 + 2 tq, k0 + 2 tq + 1) pairs of rows g,
// g + 8 as frag_a's permuted TF32 k slots, in their natural order.
template <typename W>
struct Product;

template <>
struct Product<float> {
  uint32_t ah[4], al[4];
  __device__ __forceinline__ void a(const float* t, int S, int k0,
                                    const Lane& l) {
    frag_a(t, S, k0, l, ah, al);
  }
  __device__ __forceinline__ void mac(float* c, const float* W, int N, int k,
                                      int n, bool ok) const {
    uint32_t bh[2], bl[2];
    frag_b(W, N, k, n, ok, bh, bl);
    mma3_add(c, ah, al, bh, bl);
  }
  __device__ __forceinline__ void mac_t(float* c, const float* W, int Kd,
                                        int k, int n, bool ok) const {
    uint32_t bh[2], bl[2];
    frag_bt(W, Kd, k, n, ok, bh, bl);
    mma3_add(c, ah, al, bh, bl);
  }
};

template <>
struct Product<bf16> {
  uint32_t a2[2];
  __device__ __forceinline__ void a(const float* t, int S, int k0,
                                    const Lane& l) {
    const float* p = t + l.g * S + k0 + 2 * l.tq;
    const float2 u = *reinterpret_cast<const float2*>(p);
    const float2 v = *reinterpret_cast<const float2*>(p + 8 * S);
    a2[0] = pack_bf16(u.x, u.y);
    a2[1] = pack_bf16(v.x, v.y);
  }
  __device__ __forceinline__ void mac(float* c, const bf16* W, int N, int k,
                                      int n, bool ok) const {
    const unsigned short* w = reinterpret_cast<const unsigned short*>(W);
    const uint32_t lo = ok ? __ldg(w + (size_t)k * N + n) : 0u;
    const uint32_t hi = ok ? __ldg(w + (size_t)(k + 1) * N + n) : 0u;
    mma_bf16_add(c, a2, lo | hi << 16);
  }
  __device__ __forceinline__ void mac_t(float* c, const bf16* W, int Kd,
                                        int k, int n, bool ok) const {
    // W[n][k], W[n][k + 1]: one word, the lower k in the low half
    const uint32_t b =
        ok ? __ldg(reinterpret_cast<const unsigned*>(W + (size_t)n * Kd + k))
           : 0u;
    mma_bf16_add(c, a2, b);
  }
};

// Sum over the 8 lanes of a quad position (the rows g of a C fragment)
__device__ __forceinline__ float sum_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Per-tile (mean, M2) of the two columns of a C fragment v (rows g, g + 8;
// rows past `rows` left out), written by the lanes of g = 0; st points at
// the (mean, M2) pairs of the warp's 8 columns.
__device__ __forceinline__ void frag_stats(const float* v, int rows,
                                           const Lane& l, float* st) {
  const bool ok0 = l.g < rows, ok1 = l.g + 8 < rows;
  const float inv_n = 1.0f / static_cast<float>(rows);
  const float m0 = sum_rows((ok0 ? v[0] : 0.f) + (ok1 ? v[2] : 0.f)) * inv_n;
  const float m1 = sum_rows((ok0 ? v[1] : 0.f) + (ok1 ? v[3] : 0.f)) * inv_n;
  const float d0 = v[0] - m0, d1 = v[1] - m1, d2 = v[2] - m0, d3 = v[3] - m1;
  const float q0 = sum_rows((ok0 ? d0 * d0 : 0.f) + (ok1 ? d2 * d2 : 0.f));
  const float q1 = sum_rows((ok0 ? d1 * d1 : 0.f) + (ok1 ? d3 * d3 : 0.f));
  if (l.g == 0)
    *reinterpret_cast<float4*>(st + 4 * l.tq) = make_float4(m0, q0, m1, q1);
}

// The two columns' sums of v and of v * x over a C fragment's rows, written
// by the lanes of g = 0; s1 and s2 point at the warp's 8 columns.
__device__ __forceinline__ void frag_sums(const float* v, const float* x,
                                          int rows, const Lane& l, float* s1,
                                          float* s2) {
  const bool ok0 = l.g < rows, ok1 = l.g + 8 < rows;
  const float a0 = sum_rows((ok0 ? v[0] : 0.f) + (ok1 ? v[2] : 0.f));
  const float a1 = sum_rows((ok0 ? v[1] : 0.f) + (ok1 ? v[3] : 0.f));
  const float b0 =
      sum_rows((ok0 ? v[0] * x[0] : 0.f) + (ok1 ? v[2] * x[2] : 0.f));
  const float b1 =
      sum_rows((ok0 ? v[1] * x[1] : 0.f) + (ok1 ? v[3] * x[3] : 0.f));
  if (l.g == 0) {
    st2(s1 + 2 * l.tq, a0, a1);
    st2(s2 + 2 * l.tq, b0, b1);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The T-wide merges of sample b into shared memory sm (mean, inverse
// deviation, sum 1, sum 2; each [3 slots][C]) for the slots in `slots`
// (bit s: slot s). From st's per-tile (mean, M2): mean = sum n_i mean_i /
// T, then M2 = sum M2_i + n_i (mean_i - mean)^2 (Chan's merge, exact, as
// two reductions). With tp (the walk's per-tile dgamma parts of slot 0;
// slot s at s G C, the dbeta parts tb further) also their sums: sum 1 of
// the dbeta parts, sum 2 of the dgamma parts. Thread (c, q) = (tid / 4,
// tid % 4) takes the tiles i = q mod 4, every slot's loads in one loop, and
// two shuffles add the four: a fixed order, so the bits repeat.
template <typename W>
__device__ __forceinline__ void merge(const ArgsT<W>& a, const float* st,
                                      const float* tp, size_t tb, int b,
                                      int slots, float* sm) {
  const int c = threadIdx.x >> 2, q = threadIdx.x & 3;
  const size_t G = (size_t)a.B * a.ntile;
  const float inv_t = 1.0f / static_cast<float>(a.T);
  const float* p = st + (size_t)b * a.ntile * C * 2 + c * 2;
  const float* t = tp ? tp + (size_t)b * a.ntile * C + c : nullptr;
  float sum[3] = {0.f, 0.f, 0.f}, s1[3] = {0.f, 0.f, 0.f},
        s2[3] = {0.f, 0.f, 0.f}, mean[3], m2[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
  for (int i = q; i < a.ntile; i += 4) {
    const float n = static_cast<float>(tile_rows(a, i));
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (!(slots >> s & 1)) continue;
      sum[s] += n * p[(s * G + i) * C * 2];
      if (t) {
        s2[s] += t[(s * G + i) * C];
        s1[s] += t[(s * G + i) * C + tb];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) mean[s] = quad_sum(sum[s]) * inv_t;
#pragma unroll 4
  for (int i = q; i < a.ntile; i += 4) {
    const float n = static_cast<float>(tile_rows(a, i));
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (!(slots >> s & 1)) continue;
      const float2 v =
          *reinterpret_cast<const float2*>(p + (s * G + i) * C * 2);
      const float d = v.x - mean[s];
      m2[s] += v.y + n * d * d;
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    m2[s] = quad_sum(m2[s]);
    s1[s] = quad_sum(s1[s]);
    s2[s] = quad_sum(s2[s]);
    if (q == 0 && (slots >> s & 1)) {
      sm[s * C + c] = mean[s];
      sm[3 * C + s * C + c] = 1.0f / sqrtf(m2[s] * inv_t + EPS);
      sm[6 * C + s * C + c] = s1[s];
      sm[9 * C + s * C + c] = s2[s];
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const bf16* p) { return ldg4(p); }

// The x tile (rows t0 .. t0 + 15 of sample b, D wide) into s_x[TT][SD]:
// zeros past `rows` and in the columns D .. D8 that the last k-step reads;
// with `copy`, its rows also written there as float32 (the bf16 chain's
// trunk).
template <typename S>
__device__ __forceinline__ void stage_x(float* s_x, const S* src, int D,
                                        int D8, int rows,
                                        float* copy = nullptr) {
  const int n4 = D8 / 4;
  for (int e = threadIdx.x; e < TT * n4; e += NT) {
    const int r = e / n4, c4 = (e % n4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && c4 < D) {
      v = ld4(src + (size_t)r * D + c4);
      if (copy) *reinterpret_cast<float4*>(copy + (size_t)r * D + c4) = v;
    }
    *reinterpret_cast<float4*>(s_x + r * SD + c4) = v;
  }
}

// Shared memory of the forward and of the backward (floats): the merged
// statistics, then the largest phase buffer: an x or dy tile, or the K
// windows of both branches.
size_t smem_floats(bool twin, int K) {
  const size_t win = (size_t)(twin ? 2 : 1) * K * TT * SC;
  const size_t tile = (size_t)TT * SD;
  return CK_FLOATS + NSTAT + (win > tile ? win : tile);
}

// Phase A of TCM j: h = xin @ wi[j], PReLU per branch into a.pbuf, per-tile
// stats into st; also h itself into save_h when given (the backward), and
// xin's rows as float32 into xcopy when given (the bf16 chain's trunk).
// Warp w owns the columns 8 w .. 8 w + 7.
template <bool TWIN, typename W, typename XIn>
__device__ void phase_a(const ArgsT<W>& a, int j, const XIn* xin, float* sm,
                        float* save_h, float* st, float* xcopy = nullptr) {
  const Lane l;
  const int D = a.D, T = a.T, D8 = (D + 7) & ~7;
  constexpr int NB = TWIN ? 2 : 1;
  float* s_x = sm + NSTAT;  // [TT][SD]
  const W* wi = a.wi + (size_t)j * D * C;
  const int n = 8 * l.w + l.g, col = 8 * l.w + 2 * l.tq;
  const size_t G = (size_t)a.B * a.ntile, BTC = (size_t)a.B * T * C;
  for (int tile = blockIdx.x; tile < a.B * a.ntile; tile += gridDim.x) {
    const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
    const int rows = tile_rows(a, it);
    const size_t row0 = ((size_t)b * T + t0) * D;
    CK_SYNC(PH_A, CK_OTHER);
    stage_x(s_x, xin + row0, D, D8, rows, xcopy ? xcopy + row0 : nullptr);
    CK_SYNC(PH_A, CK_STAGE);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k0 = 0; k0 < D8; k0 += 8) {
      Product<W> pr;
      pr.a(s_x, SD, k0, l);
      pr.mac(acc, wi, C, k0 + 2 * l.tq, n, k0 + 2 * l.tq < D);
    }
    CK(PH_A, CK_PRODUCT);
    const bool ok0 = l.g < rows, ok1 = l.g + 8 < rows;
    const size_t o0 = ((size_t)b * T + t0 + l.g) * C + col, o1 = o0 + 8 * C;
    if (save_h) {
      if (ok0) st2(save_h + o0, acc[0], acc[1]);
      if (ok1) st2(save_h + o1, acc[2], acc[3]);
    }
#pragma unroll
    for (int br = 0; br < NB; ++br) {
      const float2 alpha = ldg2(a.al + ((size_t)j * 3 + br) * C + col);
      const float v[4] = {prelu(acc[0], alpha.x), prelu(acc[1], alpha.y),
                          prelu(acc[2], alpha.x), prelu(acc[3], alpha.y)};
      float* pb = a.pbuf + br * BTC;
      if (ok0) st2(pb + o0, v[0], v[1]);
      if (ok1) st2(pb + o1, v[2], v[3]);
      frag_stats(v, rows, l, st + ((size_t)br * G + tile) * C * 2 + 16 * l.w);
    }
    CK(PH_A, CK_OTHER);
  }
}

// Phase B of TCM j: normalise the branches' K shifted windows, causal
// dilated conv, gate, PReLU into a.pobuf, per-tile stats of it; the conv
// outputs into save_cl/save_cr and the normalised branch inputs n into
// save_n (2, B, T, C) when given (the backward).
template <bool TWIN, typename W>
__device__ void phase_b(const ArgsT<W>& a, int j, float* sm, float* save_cl,
                        float* save_cr, float* save_n, float* st) {
  const Lane l;
  const int T = a.T, K = a.K, dil = a.dil[j];
  constexpr int NB = TWIN ? 2 : 1;
  float* s_mean = sm;
  float* s_inv = sm + 3 * C;
  float* s_win = sm + NSTAT;  // [NB][K][TT][SC]
  const W* wl = a.wl + (size_t)j * K * C * C;
  const W* wr = a.wr + (size_t)j * K * C * C;
  const int n = 8 * l.w + l.g, col = 8 * l.w + 2 * l.tq;
  const size_t G = (size_t)a.B * a.ntile, BTC = (size_t)a.B * T * C;
  int merged = -1;
  for (int tile = blockIdx.x; tile < a.B * a.ntile; tile += gridDim.x) {
    const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
    const int rows = tile_rows(a, it);
    CK_SYNC(PH_B, CK_OTHER);
    if (b != merged) {
      merge(a, st, nullptr, 0, b, TWIN ? 3 : 1, sm);
      CK_SYNC(PH_B, CK_MERGE);
      merged = b;
    }
    for (int e = threadIdx.x; e < NB * K * TT * (C / 4); e += NT) {
      const int c4 = (e % (C / 4)) * 4, r = (e / (C / 4)) % TT;
      const int bi = e / (TT * C / 4), br = bi / K, i = bi % K;
      const int t = t0 + r - (K - 1 - i) * dil;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < T) {
        const float4 p = *reinterpret_cast<const float4*>(
            a.pbuf + br * BTC + ((size_t)b * T + t) * C + c4);
        const size_t q = ((size_t)j * 3 + br) * C + c4;
        const float4 gm = ldg4(a.ga + q), bt = ldg4(a.be + q);
        const float* m = s_mean + br * C + c4;
        const float* iv = s_inv + br * C + c4;
        v = make_float4((p.x - m[0]) * iv[0] * gm.x + bt.x,
                        (p.y - m[1]) * iv[1] * gm.y + bt.y,
                        (p.z - m[2]) * iv[2] * gm.z + bt.z,
                        (p.w - m[3]) * iv[3] * gm.w + bt.w);
      }
      *reinterpret_cast<float4*>(s_win + (bi * TT + r) * SC + c4) = v;
      if (save_n && i == K - 1 && r < rows)
        *reinterpret_cast<float4*>(save_n + br * BTC +
                                   ((size_t)b * T + t0 + r) * C + c4) = v;
    }
    CK_SYNC(PH_B, CK_STAGE);
    float accl[4] = {0.f, 0.f, 0.f, 0.f}, accr[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < K; ++i) {
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 8) {
        Product<W> pr;
        pr.a(s_win + i * TT * SC, SC, k0, l);
        pr.mac(accl, wl + i * C * C, C, k0 + 2 * l.tq, n, true);
        if (TWIN) {
          pr.a(s_win + (K + i) * TT * SC, SC, k0, l);
          pr.mac(accr, wr + i * C * C, C, k0 + 2 * l.tq, n, true);
        }
      }
    }
    CK(PH_B, CK_PRODUCT);
    const float2 alpha = ldg2(a.al + ((size_t)j * 3 + 2) * C + col);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = prelu(TWIN ? accl[e] * sigm(accr[e]) : accl[e],
                   e & 1 ? alpha.y : alpha.x);
    const bool ok0 = l.g < rows, ok1 = l.g + 8 < rows;
    const size_t o0 = ((size_t)b * T + t0 + l.g) * C + col, o1 = o0 + 8 * C;
    if (ok0) st2(a.pobuf + o0, v[0], v[1]);
    if (ok1) st2(a.pobuf + o1, v[2], v[3]);
    if (save_cl) {
      if (ok0) st2(save_cl + o0, accl[0], accl[1]);
      if (ok1) st2(save_cl + o1, accl[2], accl[3]);
      if (TWIN) {
        if (ok0) st2(save_cr + o0, accr[0], accr[1]);
        if (ok1) st2(save_cr + o1, accr[2], accr[3]);
      }
    }
    frag_stats(v, rows, l, st + ((size_t)2 * G + tile) * C * 2 + 16 * l.w);
    CK(PH_B, CK_OTHER);
  }
}

// Phase C of TCM j: normalise the gate output, yout = xin + . @ wo[j]
// (yout float32, or bf16 at the end of a bf16 chain). Warp w owns the
// output columns 8 (w + 8 u) .. + 7, u < 4.
template <typename W, typename YOut>
__device__ void phase_c(const ArgsT<W>& a, int j, const float* xin,
                        YOut* yout, float* sm, const float* st) {
  const Lane l;
  const int D = a.D, T = a.T;
  float* s_mean = sm;
  float* s_inv = sm + 3 * C;
  float* s_no = sm + NSTAT;  // [TT][SC]
  const W* wo = a.wo + (size_t)j * C * D;
  const size_t q = ((size_t)j * 3 + 2) * C;
  int merged = -1;
  for (int tile = blockIdx.x; tile < a.B * a.ntile; tile += gridDim.x) {
    const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
    const int rows = tile_rows(a, it);
    CK_SYNC(PH_C, CK_OTHER);
    if (b != merged) {
      merge(a, st, nullptr, 0, b, 4, sm);
      CK_SYNC(PH_C, CK_MERGE);
      merged = b;
    }
    {
      const int r = threadIdx.x >> 4, c4 = (threadIdx.x & 15) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) {
        const float4 p = *reinterpret_cast<const float4*>(
            a.pobuf + ((size_t)b * T + t0 + r) * C + c4);
        const float4 gm = ldg4(a.ga + q + c4), bt = ldg4(a.be + q + c4);
        const float* m = s_mean + 2 * C + c4;
        const float* iv = s_inv + 2 * C + c4;
        v = make_float4((p.x - m[0]) * iv[0] * gm.x + bt.x,
                        (p.y - m[1]) * iv[1] * gm.y + bt.y,
                        (p.z - m[2]) * iv[2] * gm.z + bt.z,
                        (p.w - m[3]) * iv[3] * gm.w + bt.w);
      }
      *reinterpret_cast<float4*>(s_no + r * SC + c4) = v;
    }
    CK_SYNC(PH_C, CK_STAGE);
    float acc[4][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < C; k0 += 8) {
      Product<W> pr;
      pr.a(s_no, SC, k0, l);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n0 = 8 * (l.w + 8 * u);
        if (n0 < D)
          pr.mac(acc[u], wo, D, k0 + 2 * l.tq, n0 + l.g, n0 + l.g < D);
      }
    }
    CK(PH_C, CK_PRODUCT);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = 8 * (l.w + 8 * u) + 2 * l.tq;
      if (d >= D) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (l.g + 8 * h >= rows) continue;
        const size_t o = ((size_t)b * T + t0 + l.g + 8 * h) * D + d;
        const float2 xv = *reinterpret_cast<const float2*>(xin + o);
        st2(yout + o, xv.x + acc[u][2 * h], xv.y + acc[u][2 * h + 1]);
      }
    }
    CK(PH_C, CK_OTHER);
  }
}

template <bool TWIN, typename W>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    tcm_chain_fwd_kernel(ArgsT<W> a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4) + CK_FLOATS;
  cg::grid_group grid = cg::this_grid();
  ck_init();
  for (int j = 0; j < a.P; ++j) {
    if constexpr (sizeof(W) == 2) {  // bf16: x read once into the trunk y
      if (j == 0)
        phase_a<TWIN>(a, j, a.x, sm, nullptr, a.stats, a.y);
      else
        phase_a<TWIN>(a, j, static_cast<const float*>(a.y), sm, nullptr,
                      a.stats);
    } else {
      phase_a<TWIN>(a, j, j == 0 ? a.x : a.y, sm, nullptr, a.stats);
    }
    grid.sync();
    CK(PH_A, CK_GRID);
    phase_b<TWIN>(a, j, sm, nullptr, nullptr, nullptr, a.stats);
    grid.sync();
    CK(PH_B, CK_GRID);
    if constexpr (sizeof(W) == 2) {  // the trunk, then y once in bf16
      if (j + 1 < a.P)
        phase_c(a, j, a.y, a.y, sm, a.stats);
      else
        phase_c(a, j, a.y, a.out, sm, a.stats);
    } else {
      phase_c(a, j, j == 0 ? a.x : a.y, a.y, sm, a.stats);
    }
  }
  ck_flush();
}

// ---------------------------------------------------------------- backward
//
// Replaces eabnet_tpu/kernels/tcm_chain.py::_bwd_kernel. Only the group
// input x is a residual. Three launches on one stream:
//
// 1. The walk (tcm_chain_bwd_kernel, cooperative). It first runs the chain
//    forward again (phases A-C above), keeping in a global workspace each
//    TCM's trunk input, h = x @ wi, the conv outputs cL (cR), the
//    normalised branch inputs n and the per-tile IN statistics. Then, for
//    j = P-1 .. 0, four phases over the same tiles:
//      R1: dno = dy_j @ wo^T; no -> workspace; per-tile sums of dno and
//          dno * xhat (the IN backward's, and the gate IN's dgamma, dbeta)
//      -- grid.sync --
//      R2: IN backward of the gate output (needs those sums over all of T),
//          PReLU backward, sigmoid gate -> dcL (dcR) -> workspace; per-tile
//          dalpha of the gate PReLU
//      -- grid.sync --
//      R3: dn = sum_i shift_up(dc @ w_i^T, (K-1-i) dil) (reads later frames
//          of other tiles: the K windows of dc staged once, as in phase B);
//          per-tile sums of dn and dn * xhat per branch
//      -- grid.sync --
//      R4: IN and PReLU backward per branch -> dh -> workspace; per-tile
//          dalpha; dy_{j-1} = dy_j + dh @ wi^T (rows this tile owns)
//    where dy_j is the cotangent at TCM j's output (dy_{P-1} = dy, and
//    dy_{-1} is dx); each is kept for the weight gradients. The next TCM's
//    R1 reads only rows its own tile wrote in R4, so R4 needs no barrier
//    after it. Grid barriers per launch: 5 P (30 for an EaBNet group).
// 2. The weight gradients (tcm_chain_wgrad_kernel): one hand-written 3xTF32
//    GEMM launch over all B T rows, each block a 64 x 64 tile of one
//    gradient over a chunk of rows:
//      dwi[j]    = x_j^T dh_j,   dwo[j] = no_j^T dy_j,
//      dw_b[j, i] = shift_down(n_b, (K-1-i) dil_j)^T dc_b   (a row-offset
//                   read, zero before t = 0),
//    its tiles staged by a 4-deep cp.async ring of 32-row stages; the
//    stage's mma sums are added into float32 registers (the tensor cores'
//    float32 sum truncates). Each chunk writes its partial tile.
// 3. The sum (tcm_chain_grad_sum_kernel): the chunks' partials in chunk
//    order, and the (P, 3, C) table gradients (dalpha, dgamma, dbeta) from
//    the walk's per-tile parts in tile order. No atomics anywhere: a second
//    launch gives the same bits. For a single-branch group only branch L
//    and the out rows are computed, so wr and row 1 of the tables get a
//    zero gradient, as in the Pallas backward.
// bfloat16 training (eabnet_tcm_chain_bwd_bf16) runs the same three
// kernels with the Pallas backward's bf16 operands: x, dy, the weights and
// the tables arrive in bf16. The chain is recomputed on a float32 trunk
// (phase A of TCM 0 reads x once and keeps its float32 copy as trunk slot
// 0) and R1 of the last TCM reads dy once into a float32 copy, so the
// cotangent is carried in float32 across the TCMs; every product operand,
// in the walk and in the GEMM, is rounded to bf16 where its fragment is
// built (one bf16 mma.sync per k-step, added in float32), the IN and PReLU
// derivatives stay float32, dx is written in bf16, and every gradient is
// summed in float32 and rounded to bf16 once, in the sum kernel.
// What bounds it: three times the forward's products (the recompute, then
// the data and the weight cotangents), 11.2 GFLOP for an EaBNet group at
// B = 7, T = 601, so the f32 rate (0.17 ms) or three TF32 products on the
// tensor cores (0.07 ms); but 5 P grid barriers, the T-wide IN reductions
// and 7 phases of short per-tile work, each a chain of loads, products and
// stores, serialise the walk. In the first design the weight gradients'
// products and read-modify-writes of per-block partial slots (~0.9 GB of
// traffic per EaBNet launch) were 42% of the time; here they are one GEMM
// of ~0.13 ms at that shape. The walk is what remains (~90%), held back as
// the forward is, by its products' weight fragments.

template <typename W>
struct BArgsT {
  ArgsT<W> f;          // the forward's arguments and scratch
  const W* dy;         // (B, T, D) cotangent of the group output
  W* dx;               // (B, T, D) cotangent of the group input
  float* xs;           // (P-1, B, T, D) trunk input of TCMs 1 .. P-1; bf16:
                       // (P, B, T, D), slot 0 the float32 x
  float* hs;           // (P, B, T, C) h = x @ wi
  float* cls;          // (P, B, T, C) branch-L conv output
  float* crs;          // (P, B, T, C) branch-R conv output (twin)
  float* st;           // (P, 3, B ntile, C, 2) per-tile IN statistics
  float* ns;           // (P, 2, B, T, C) normalised branch inputs n
  float* nos;          // (P, B, T, C) normalised gate output no
  float* dys;          // (P-1, B, T, D) cotangent at TCM j's output, j < P-1;
                       // bf16: (P, B, T, D), slot P-1 the float32 dy
  float* dcs;          // (P, 2, B, T, C) d conv output per branch
  float* dhs;          // (P, B, T, C) d h
  float* dno;          // (B, T, C) d no
  float* dnb;          // (2, B, T, C) d n per branch
  float* tp;           // (3, P, 3, B ntile, C) per-tile dalpha, dgamma, dbeta
};

// Column sums of a (row = tid / 16, 4 columns) float4 over the tile's 16
// rows, in a fixed order, into out[c] (c < 64) by threads c < 64. s_red
// holds 8 x 64 floats; one barrier inside.
__device__ __forceinline__ void tile_colsum(float4 v, float* s_red,
                                            float* out) {
  const int tid = threadIdx.x;
  v.x += __shfl_xor_sync(0xffffffffu, v.x, 16);
  v.y += __shfl_xor_sync(0xffffffffu, v.y, 16);
  v.z += __shfl_xor_sync(0xffffffffu, v.z, 16);
  v.w += __shfl_xor_sync(0xffffffffu, v.w, 16);
  if ((tid & 31) < 16)
    *reinterpret_cast<float4*>(s_red + (tid >> 5) * C + (tid & 15) * 4) = v;
  __syncthreads();
  if (tid < C) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += s_red[w * C + tid];
    out[tid] = s;
  }
}

template <bool TWIN, typename W>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    tcm_chain_bwd_kernel(BArgsT<W> g) {
  constexpr bool LOWP = sizeof(W) == 2;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4) + CK_FLOATS;
  cg::grid_group grid = cg::this_grid();
  ck_init();
  const ArgsT<W>& a = g.f;
  const Lane l;
  const int tid = threadIdx.x;
  const int D = a.D, T = a.T, K = a.K, P = a.P, D8 = (D + 7) & ~7;
  constexpr int NB = TWIN ? 2 : 1;
  const int n_tiles = a.B * a.ntile;
  const size_t BTD = (size_t)a.B * T * D, BTC = (size_t)a.B * T * C;
  const size_t G = (size_t)n_tiles;
  const size_t STS = 3 * G * C * 2;
  const float inv_t = 1.0f / static_cast<float>(T);
  float* s_mean = sm;
  float* s_inv = sm + 3 * C;
  float* s_s1 = sm + 6 * C;
  float* s_s2 = sm + 9 * C;
  float* s_buf = sm + NSTAT;
  // per-tile parts of the table gradients: kind (0 dalpha, 1 dgamma,
  // 2 dbeta), TCM j, slot s
  auto tpart = [&](int kind, int j, int s) {
    return g.tp + (((size_t)kind * P + j) * 3 + s) * G * C;
  };
  const size_t tb = (size_t)P * 3 * G * C;  // dbeta parts after dgamma's
  const int n = 8 * l.w + l.g, col = 8 * l.w + 2 * l.tq;

  // the float32 trunk input of TCM j (bf16: TCM 0's is x's copy)
  auto trunk = [&](int j) -> float* {
    return g.xs + (LOWP ? j : j - 1) * BTD;
  };
  // the float32 cotangent at TCM j's output (bf16: the last is dy's copy)
  auto dcot = [&](int j) -> const float* {
    if constexpr (LOWP)
      return g.dys + j * BTD;
    else
      return j == P - 1 ? g.dy : g.dys + j * BTD;
  };

  // ---------------------------------------------- the forward, saved
  for (int j = 0; j < P; ++j) {
    float* stj = g.st + j * STS;
    const float* xin;
    if constexpr (LOWP) {
      if (j == 0)
        phase_a<TWIN>(a, j, a.x, sm, g.hs + j * BTC, stj, trunk(0));
      else
        phase_a<TWIN>(a, j, static_cast<const float*>(trunk(j)), sm,
                      g.hs + j * BTC, stj);
      xin = trunk(j);
    } else {
      xin = j == 0 ? a.x : trunk(j);
      phase_a<TWIN>(a, j, xin, sm, g.hs + j * BTC, stj);
    }
    grid.sync();
    CK(PH_A, CK_GRID);
    phase_b<TWIN>(a, j, sm, g.cls + j * BTC, g.crs + j * BTC,
                  g.ns + 2 * j * BTC, stj);
    grid.sync();
    CK(PH_B, CK_GRID);
    if (j + 1 < P) phase_c(a, j, xin, trunk(j + 1), sm, stj);
  }

  // ---------------------------------------------- the reverse walk
  for (int j = P - 1; j >= 0; --j) {
    const float* stj = g.st + j * STS;
    const float* hj = g.hs + j * BTC;
    const float* clj = g.cls + j * BTC;
    const float* crj = g.crs + j * BTC;
    float* dcj = g.dcs + 2 * j * BTC;
    const float* dsrc = dcot(j);
    const size_t q2 = ((size_t)j * 3 + 2) * C;  // out row of the tables
    // ------------------------------------------ R1
    {
      float* s_dy = s_buf;  // [TT][SD]
      const W* wo = a.wo + (size_t)j * C * D;
      int merged = -1;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        CK_SYNC(PH_R1, CK_OTHER);
        if (b != merged) {
          merge(a, stj, nullptr, 0, b, 4, sm);
          CK(PH_R1, CK_MERGE);
          merged = b;
        }
        const size_t rd = ((size_t)b * T + t0) * D;
        if (LOWP && j == P - 1)  // dy read once, kept as its float32 copy
          stage_x(s_dy, g.dy + rd, D, D8, rows, g.dys + j * BTD + rd);
        else
          stage_x(s_dy, dsrc + rd, D, D8, rows);
        CK_SYNC(PH_R1, CK_STAGE);
        // dno = dy @ wo^T: B[k = d][n = c] = wo[c][d]
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int k0 = 0; k0 < D8; k0 += 8) {
          Product<W> pr;
          pr.a(s_dy, SD, k0, l);
          pr.mac_t(acc, wo, D, k0 + 2 * l.tq, n, k0 + 2 * l.tq < D);
        }
        CK(PH_R1, CK_PRODUCT);
        // xhat of the gate IN at the fragment's places; no for the GEMM
        const float2 alv = ldg2(a.al + q2 + col), gav = ldg2(a.ga + q2 + col);
        const float2 bev = ldg2(a.be + q2 + col);
        float xo[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = l.g + 8 * h;
          xo[2 * h] = xo[2 * h + 1] = 0.f;
          if (r >= rows) continue;
          const size_t o = ((size_t)b * T + t0 + r) * C + col;
          const float2 cl = *reinterpret_cast<const float2*>(clj + o);
          float gv0 = cl.x, gv1 = cl.y;
          if (TWIN) {
            const float2 cr = *reinterpret_cast<const float2*>(crj + o);
            gv0 *= sigm(cr.x);
            gv1 *= sigm(cr.y);
          }
          const float* m = s_mean + 2 * C + col;
          const float* iv = s_inv + 2 * C + col;
          xo[2 * h] = (prelu(gv0, alv.x) - m[0]) * iv[0];
          xo[2 * h + 1] = (prelu(gv1, alv.y) - m[1]) * iv[1];
          st2(g.nos + j * BTC + o, xo[2 * h] * gav.x + bev.x,
              xo[2 * h + 1] * gav.y + bev.y);
          st2(g.dno + o, acc[2 * h], acc[2 * h + 1]);
        }
        // dbeta, dgamma parts of the gate IN (also the IN backward's sums)
        frag_sums(acc, xo, rows, l,
                  tpart(2, j, 2) + (size_t)tile * C + 8 * l.w,
                  tpart(1, j, 2) + (size_t)tile * C + 8 * l.w);
        CK(PH_R1, CK_OTHER);
      }
    }
    grid.sync();
    CK(PH_R1, CK_GRID);
    // ------------------------------------------ R2
    {
      float* s_red = s_buf;  // [8][C]
      const int r = tid >> 4, c4 = (tid & 15) * 4;
      int merged = -1;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        CK_SYNC(PH_R2, CK_OTHER);
        if (b != merged) {
          merge(a, stj, tpart(1, j, 0), tb, b, 4, sm);
          CK_SYNC(PH_R2, CK_MERGE);
          merged = b;
        }
        float da[4] = {0.f, 0.f, 0.f, 0.f};
        if (r < rows) {
          const size_t o = ((size_t)b * T + t0 + r) * C + c4;
          const float4 cl4 = *reinterpret_cast<const float4*>(clj + o);
          const float4 cr4 = TWIN ? *reinterpret_cast<const float4*>(crj + o)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 dn4 = *reinterpret_cast<const float4*>(g.dno + o);
          const float4 al4 = ldg4(a.al + q2 + c4), ga4 = ldg4(a.ga + q2 + c4);
          const float clv[4] = {cl4.x, cl4.y, cl4.z, cl4.w};
          const float crv[4] = {cr4.x, cr4.y, cr4.z, cr4.w};
          const float dnv[4] = {dn4.x, dn4.y, dn4.z, dn4.w};
          const float alp[4] = {al4.x, al4.y, al4.z, al4.w};
          const float gam[4] = {ga4.x, ga4.y, ga4.z, ga4.w};
          float dcl[4], dcr[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ch = c4 + e;
            const float sg = TWIN ? sigm(crv[e]) : 1.0f;
            const float gv = clv[e] * sg;
            const float inv = s_inv[2 * C + ch];
            const float xo = (prelu(gv, alp[e]) - s_mean[2 * C + ch]) * inv;
            const float dpo = inv * (gam[e] * dnv[e] -
                                     gam[e] * s_s1[2 * C + ch] * inv_t -
                                     xo * (gam[e] * s_s2[2 * C + ch] * inv_t));
            const float dg = gv > 0.0f ? dpo : alp[e] * dpo;
            da[e] = dpo * fminf(gv, 0.0f);
            dcl[e] = TWIN ? dg * sg : dg;
            dcr[e] = dg * clv[e] * sg * (1.0f - sg);
          }
          *reinterpret_cast<float4*>(dcj + o) =
              make_float4(dcl[0], dcl[1], dcl[2], dcl[3]);
          if (TWIN)
            *reinterpret_cast<float4*>(dcj + BTC + o) =
                make_float4(dcr[0], dcr[1], dcr[2], dcr[3]);
        }
        tile_colsum(make_float4(da[0], da[1], da[2], da[3]), s_red,
                    tpart(0, j, 2) + (size_t)tile * C);
        CK(PH_R2, CK_OTHER);
      }
    }
    grid.sync();
    CK(PH_R2, CK_GRID);
    // ------------------------------------------ R3
    {
      float* s_win = s_buf;  // [NB][K][TT][SC]
      const int dil = a.dil[j];
      int merged = -1;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        CK_SYNC(PH_R3, CK_OTHER);
        if (b != merged) {
          merge(a, stj, nullptr, 0, b, TWIN ? 3 : 1, sm);
          CK(PH_R3, CK_MERGE);
          merged = b;
        }
        for (int e = tid; e < NB * K * TT * (C / 4); e += NT) {
          const int c4 = (e % (C / 4)) * 4, r = (e / (C / 4)) % TT;
          const int bi = e / (TT * C / 4), br = bi / K, i = bi % K;
          const int t = t0 + r + (K - 1 - i) * dil;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (t < T)
            v = *reinterpret_cast<const float4*>(dcj + br * BTC +
                                                 ((size_t)b * T + t) * C + c4);
          *reinterpret_cast<float4*>(s_win + (bi * TT + r) * SC + c4) = v;
        }
        CK_SYNC(PH_R3, CK_STAGE);
        // dn_b = sum_i window_i @ w_b[i]^T:
        // B[k = c_out][n = c_in] = w[c_in][c_out]
        float acc[2][4] = {};
        for (int i = 0; i < K; ++i) {
#pragma unroll
          for (int br = 0; br < NB; ++br) {
            const W* w = (br ? a.wr : a.wl) + ((size_t)j * K + i) * C * C;
#pragma unroll 2
            for (int k0 = 0; k0 < C; k0 += 8) {
              Product<W> pr;
              pr.a(s_win + (br * K + i) * TT * SC, SC, k0, l);
              pr.mac_t(acc[br], w, C, k0 + 2 * l.tq, n, true);
            }
          }
        }
        CK(PH_R3, CK_PRODUCT);
#pragma unroll
        for (int br = 0; br < NB; ++br) {
          const size_t qb = ((size_t)j * 3 + br) * C + col;
          const float2 alv = ldg2(a.al + qb);
          float xh[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = l.g + 8 * h;
            xh[2 * h] = xh[2 * h + 1] = 0.f;
            if (r >= rows) continue;
            const size_t o = ((size_t)b * T + t0 + r) * C + col;
            const float2 hv = *reinterpret_cast<const float2*>(hj + o);
            const float* m = s_mean + br * C + col;
            const float* iv = s_inv + br * C + col;
            xh[2 * h] = (prelu(hv.x, alv.x) - m[0]) * iv[0];
            xh[2 * h + 1] = (prelu(hv.y, alv.y) - m[1]) * iv[1];
            st2(g.dnb + br * BTC + o, acc[br][2 * h], acc[br][2 * h + 1]);
          }
          frag_sums(acc[br], xh, rows, l,
                    tpart(2, j, br) + (size_t)tile * C + 8 * l.w,
                    tpart(1, j, br) + (size_t)tile * C + 8 * l.w);
        }
        CK(PH_R3, CK_OTHER);
      }
    }
    grid.sync();
    CK(PH_R3, CK_GRID);
    // ------------------------------------------ R4
    {
      float* s_dh = s_buf;              // [TT][SC]
      float* s_red = s_buf + TT * SC;   // [NB][8][C]
      const W* wi = a.wi + (size_t)j * D * C;
      const int r = tid >> 4, c4 = (tid & 15) * 4;
      int merged = -1;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        CK_SYNC(PH_R4, CK_OTHER);
        if (b != merged) {
          merge(a, stj, tpart(1, j, 0), tb, b, TWIN ? 3 : 1, sm);
          CK_SYNC(PH_R4, CK_MERGE);
          merged = b;
        }
        float dh[4] = {0.f, 0.f, 0.f, 0.f};
        float da[2][4] = {};
        const size_t o = ((size_t)b * T + t0 + r) * C + c4;
        if (r < rows) {
          const float4 h4 = *reinterpret_cast<const float4*>(hj + o);
          const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int br = 0; br < NB; ++br) {
            const size_t qb = ((size_t)j * 3 + br) * C + c4;
            const float4 al4 = ldg4(a.al + qb), ga4 = ldg4(a.ga + qb);
            const float4 dn4 =
                *reinterpret_cast<const float4*>(g.dnb + br * BTC + o);
            const float alp[4] = {al4.x, al4.y, al4.z, al4.w};
            const float gam[4] = {ga4.x, ga4.y, ga4.z, ga4.w};
            const float dnv[4] = {dn4.x, dn4.y, dn4.z, dn4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ch = br * C + c4 + e;
              const float inv = s_inv[ch];
              const float xh = (prelu(hv[e], alp[e]) - s_mean[ch]) * inv;
              const float dp =
                  inv * (gam[e] * dnv[e] - gam[e] * s_s1[ch] * inv_t -
                         xh * (gam[e] * s_s2[ch] * inv_t));
              dh[e] += hv[e] > 0.0f ? dp : alp[e] * dp;
              da[br][e] = dp * fminf(hv[e], 0.0f);
            }
          }
          *reinterpret_cast<float4*>(g.dhs + j * BTC + o) =
              make_float4(dh[0], dh[1], dh[2], dh[3]);
        }
        *reinterpret_cast<float4*>(s_dh + r * SC + c4) =
            make_float4(dh[0], dh[1], dh[2], dh[3]);
#pragma unroll
        for (int br = 0; br < NB; ++br)
          tile_colsum(make_float4(da[br][0], da[br][1], da[br][2], da[br][3]),
                      s_red + br * 8 * C, tpart(0, j, br) + (size_t)tile * C);
        // s_dh is in: tile_colsum has a barrier
        CK(PH_R4, CK_OTHER);
        // the cotangent at TCM j's input = dsrc + dh @ wi^T:
        // B[k = c][n = d] = wi[d][c]
        float acc[4][4] = {};
#pragma unroll 2
        for (int k0 = 0; k0 < C; k0 += 8) {
          Product<W> pr;
          pr.a(s_dh, SC, k0, l);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int n0 = 8 * (l.w + 8 * u);
            if (n0 < D)
              pr.mac_t(acc[u], wi, C, k0 + 2 * l.tq, n0 + l.g, n0 + l.g < D);
          }
        }
        CK(PH_R4, CK_PRODUCT);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int d = 8 * (l.w + 8 * u) + 2 * l.tq;
          if (d >= D) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (l.g + 8 * h >= rows) continue;
            const size_t od = ((size_t)b * T + t0 + l.g + 8 * h) * D + d;
            const float2 sv = *reinterpret_cast<const float2*>(dsrc + od);
            const float v0 = sv.x + acc[u][2 * h], v1 = sv.y + acc[u][2 * h + 1];
            if (j == 0)
              st2(g.dx + od, v0, v1);  // bf16: rounded once, here
            else
              st2(g.dys + (j - 1) * BTD + od, v0, v1);
          }
        }
        CK(PH_R4, CK_OTHER);
      }
    }
  }
  ck_flush();
}

// ------------------------------------------------- weight-gradient GEMM
constexpr int WG_BK = 32;      // rows per stage
constexpr int WG_STAGES = 4;   // cp.async ring depth
constexpr int WG_S = 64 + 8;   // row stride of a staged 64-wide operand
constexpr int WG_STAGE_FLOATS = 2 * WG_BK * WG_S;

struct WArgs {
  const float* x;    // group input (B, T, D)
  const float* dy;   // group output's cotangent (B, T, D)
  const float* xs;   // (P-1, B, T, D)
  const float* ns;   // (P, 2, B, T, C)
  const float* nos;  // (P, B, T, C)
  const float* dys;  // (P-1, B, T, D)
  const float* dcs;  // (P, 2, B, T, C)
  const float* dhs;  // (P, B, T, C)
  float* part;       // (chunks, np) partial gradients in the packed layout
  long long np, o_wl, o_wr, o_wo;
  int B, T, D, K, P, NB, nd;  // nd = ceil(D / 64) tiles along D
  int dil[MAXP];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// A chunk's partial of a gradient tile, as the sum kernel reads it
__device__ __forceinline__ void part_store(float* p, float u, float v) {
  st2(p, u, v);
}

// Block (chunk, job): job = j * (2 nd + NB K) + r with r < nd a tile of
// dwi[j] (rows 64 r of D), r < nd + NB K a tap (branch, i) of dw[j], else a
// tile of dwo[j] (columns 64 (r - nd - NB K) of D). out[m][n] = sum over
// the chunk's rows of A[row - shift][a0 + m] B[row][b0 + n]. LOWP (bf16
// training): each k-step is one bf16 product of the operands rounded to
// bf16, into zeroed registers and added in float32; else three TF32
// products, a stage's k-steps into zeroed registers.
template <bool LOWP>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    tcm_chain_wgrad_kernel(WArgs w) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const Lane l;
  const int tid = threadIdx.x;
  const int jpt = 2 * w.nd + w.NB * w.K;
  const int j = blockIdx.y / jpt, r = blockIdx.y % jpt;
  const size_t BTD = (size_t)w.B * w.T * w.D, BTC = (size_t)w.B * w.T * C;
  const float *A, *Bm;
  int lda, ldb, a0 = 0, b0 = 0, ma = C, nb = C, shift = 0;
  float* out;
  int ldo;
  float* part = w.part + (size_t)blockIdx.x * w.np;
  if (r < w.nd) {  // dwi[j] = x_j^T dh_j
    A = j == 0 ? w.x : w.xs + (j - 1) * BTD;
    lda = w.D;
    a0 = 64 * r;
    ma = min(64, w.D - a0);
    Bm = w.dhs + j * BTC;
    ldb = C;
    out = part + ((size_t)j * w.D + a0) * C;
    ldo = C;
  } else if (r < w.nd + w.NB * w.K) {  // dw_b[j, i] = shift(n_b)^T dc_b
    const int br = (r - w.nd) / w.K, i = (r - w.nd) % w.K;
    A = w.ns + (2 * j + br) * BTC;
    lda = C;
    shift = (w.K - 1 - i) * w.dil[j];
    Bm = w.dcs + (2 * j + br) * BTC;
    ldb = C;
    out = part + (br ? w.o_wr : w.o_wl) + (((size_t)j * w.K + i) * C) * C;
    ldo = C;
  } else {  // dwo[j] = no_j^T dy_j
    const int u = r - w.nd - w.NB * w.K;
    A = w.nos + j * BTC;
    lda = C;
    Bm = j == w.P - 1 ? w.dy : w.dys + j * BTD;
    ldb = w.D;
    b0 = 64 * u;
    nb = min(64, w.D - b0);
    out = part + w.o_wo + (size_t)j * C * w.D + b0;
    ldo = w.D;
  }
  const long long n_rows = (long long)w.B * w.T;
  const long long per = (n_rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = per * blockIdx.x;
  const long long r1 = r0 + per < n_rows ? r0 + per : n_rows;
  const int nk = r1 > r0 ? static_cast<int>((r1 - r0 + WG_BK - 1) / WG_BK) : 0;

  auto load = [&](int kt) {
    float* as = ring + (kt % WG_STAGES) * WG_STAGE_FLOATS;
    float* bs = as + WG_BK * WG_S;
    const long long base = r0 + (long long)kt * WG_BK;
    for (int i = tid; i < 2 * WG_BK * 16; i += NT) {
      const bool isb = i >= WG_BK * 16;
      const int e = isb ? i - WG_BK * 16 : i;
      const int rr = e >> 4, c4 = (e & 15) * 4;
      const long long row = base + rr;
      bool ok = row < r1 && c4 < (isb ? nb : ma);
      const float* src;
      if (isb) {
        src = Bm + (ok ? row * ldb + b0 + c4 : 0);
      } else {
        ok = ok && row % w.T >= shift;
        src = A + (ok ? (row - shift) * lda + a0 + c4 : 0);
      }
      cp_async16((isb ? bs : as) + rr * WG_S + c4, src, ok);
    }
  };

  // warp (wm, wn): rows 32 wm .. + 31 of out, columns 16 wn .. + 15
  const int m0 = 32 * (l.w & 1), n0 = 16 * (l.w >> 1);
  float acc[2][2][4], sum[2][2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[a][b][i] = 0.f;

#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<WG_STAGES - 2>();
    __syncthreads();  // stage kt is in; stage kt - 1 is free
    if (kt + WG_STAGES - 1 < nk) load(kt + WG_STAGES - 1);
    cp_async_commit();
    const float* as = ring + (kt % WG_STAGES) * WG_STAGE_FLOATS;
    const float* bs = as + WG_BK * WG_S;
    if constexpr (LOWP) {
#pragma unroll
      for (int ks = 0; ks < WG_BK / 8; ++ks) {
        // the TF32 fragments' (k = tq, tq + 4) slots as one bf16 pair
        const float* ak = as + (ks * 8 + l.tq) * WG_S + m0 + l.g;
        const float* bk = bs + (ks * 8 + l.tq) * WG_S + n0 + l.g;
        uint32_t a2[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* am = ak + mt * 16;
          a2[mt][0] = pack_bf16(am[0], am[4 * WG_S]);
          a2[mt][1] = pack_bf16(am[8], am[4 * WG_S + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint32_t b = pack_bf16(bk[nt * 8], bk[4 * WG_S + nt * 8]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_bf16_add(sum[mt][nt], a2[mt], b);
        }
      }
      continue;
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[a][b][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < WG_BK / 8; ++ks) {
      const float* ak = as + (ks * 8 + l.tq) * WG_S + m0 + l.g;
      const float* bk = bs + (ks * 8 + l.tq) * WG_S + n0 + l.g;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* am = ak + mt * 16;
        const float av[4] = {am[0], am[8], am[4 * WG_S], am[4 * WG_S + 8]};
        split4(av, ah[mt], al[mt]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bh[2], bl[2];
        split_tf32(bk[nt * 8], bh[0], bl[0]);
        split_tf32(bk[4 * WG_S + nt * 8], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma3(acc[mt][nt], ah[mt], al[mt], bh, bl);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[a][b][i] += acc[a][b][i];
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int m = m0 + mt * 16 + l.g, nn = n0 + nt * 8 + 2 * l.tq;
      if (nn >= nb) continue;
      if (m < ma)
        part_store(out + (size_t)m * ldo + nn, sum[mt][nt][0],
                   sum[mt][nt][1]);
      if (m + 8 < ma)
        part_store(out + (size_t)(m + 8) * ldo + nn, sum[mt][nt][2],
                   sum[mt][nt][3]);
    }
}

// grads[i] = the chunks' partials summed in chunk order (the products), or
// the walk's per-tile parts summed in tile order (the (P, 3, C) tables);
// zero for a single-branch group's wr and table row 1. Summed in float32,
// then written in TO (bf16 training: rounded once, here).
template <typename TO>
__global__ void tcm_chain_grad_sum_kernel(const float* __restrict__ part,
                                          const float* __restrict__ tp,
                                          TO* __restrict__ grads,
                                          long long np, long long o_wr,
                                          long long o_wo, long long o_al,
                                          int nchunk, int P, int ntiles,
                                          int twin) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np) return;
  float s = 0.0f;
  if (i < o_al) {
    if (twin || i < o_wr || i >= o_wo)
      for (int c = 0; c < nchunk; ++c) s += part[(size_t)c * np + i];
  } else {
    const long long e = i - o_al;                   // (kind, j, slot, c)
    const int slot = static_cast<int>((e / C) % 3);
    if (twin || slot != 1) {
      const long long kj = e / (3 * C);             // kind * P + j
      const float* p = tp + (kj * 3 + slot) * (long long)ntiles * C + e % C;
      float u[4] = {0.f, 0.f, 0.f, 0.f};
      int t = 0;
      for (; t + 4 <= ntiles; t += 4)
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] += p[(size_t)(t + q) * C];
      for (; t < ntiles; ++t) u[0] += p[(size_t)t * C];
      s = (u[0] + u[1]) + (u[2] + u[3]);
    }
  }
  st1(grads + i, s);
}

cudaError_t sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
}

// Grid of a cooperative launch: every tile, or as many blocks as can be
// co-resident, whichever is fewer; also the blocks per SM.
cudaError_t coop_grid(const void* kern, size_t smem, int n_tiles, int* grid,
                      int* per_sm) {
  int dev = 0, n_sm = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = sm_count(&n_sm);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, NT, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = n_tiles < *per_sm * n_sm ? n_tiles : *per_sm * n_sm;
  return cudaSuccess;
}

template <typename W = float>
const void* fwd_kernel(bool twin) {
  return twin ? (const void*)tcm_chain_fwd_kernel<true, W>
              : (const void*)tcm_chain_fwd_kernel<false, W>;
}

template <typename W = float>
const void* bwd_kernel(bool twin) {
  return twin ? (const void*)tcm_chain_bwd_kernel<true, W>
              : (const void*)tcm_chain_bwd_kernel<false, W>;
}

// The grid of the backward's walk (bwd) or the forward, float32 or bf16
// (lowp)
cudaError_t grid_of(bool bwd, bool twin, int K, int B, int T, int* grid,
                    int* per_sm, bool lowp = false) {
  return coop_grid(bwd ? (lowp ? bwd_kernel<bf16>(twin) : bwd_kernel(twin))
                       : lowp ? fwd_kernel<bf16>(twin) : fwd_kernel(twin),
                   smem_floats(twin, K) * sizeof(float),
                   B * ((T + TT - 1) / TT), grid, per_sm);
}

template <bool TWIN, typename W>
cudaError_t launch(ArgsT<W>& a, cudaStream_t stream) {
  constexpr bool LOWP = sizeof(W) == 2;
  int grid = 0, per_sm = 0;
  cudaError_t err =
      grid_of(false, TWIN, a.K, a.B, a.T, &grid, &per_sm, LOWP);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  const size_t smem = smem_floats(TWIN, a.K) * sizeof(float);
  err = cudaLaunchCooperativeKernel(fwd_kernel<W>(TWIN), dim3(grid), dim3(NT),
                                    params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Floats of the packed weight gradients (wi, wl, wr, wo, al, ga, be).
long long grad_floats(int D, int K, int P) {
  return (long long)P * (2LL * D * C + 2LL * K * C * C + 9LL * C);
}

// Row chunks of the weight-gradient GEMM: enough blocks for about three
// per SM over all jobs, at least 128 rows a chunk.
int wgrad_chunks(int B, int T, int D, int K, int P, bool twin) {
  int n_sm = 0;
  if (sm_count(&n_sm) != cudaSuccess) return -1;
  const int jobs = P * (2 * ((D + 63) / 64) + (twin ? 2 : 1) * K);
  const long long by_rows = ((long long)B * T + 127) / 128;
  int chunks = (3 * n_sm + jobs - 1) / jobs;
  if (chunks > by_rows) chunks = static_cast<int>(by_rows);
  return chunks < 1 ? 1 : chunks;
}

bool bad_shape(int B, int T, int D, int K, int P) {
  return B < 1 || T < 1 || D < 4 || D > MAXD || D % 4 || K < 1 || K > MAXK ||
         P < 1 || P > MAXP;
}

template <typename W>
void fill_args(ArgsT<W>& a, const W* x, const W* wi, const W* wl, const W* wr,
               const W* wo, const W* al, const W* ga, const W* be, float* y,
               float* work, int B, int T, int D, int K, int P,
               const int* dils) {
  a.x = x; a.wi = wi; a.wl = wl; a.wr = wr; a.wo = wo;
  a.al = al; a.ga = ga; a.be = be; a.y = y; a.out = nullptr;
  a.pbuf = work;
  a.pobuf = work + 2LL * B * T * C;
  a.stats = work + 3LL * B * T * C;
  a.B = B; a.T = T; a.D = D; a.K = K; a.P = P;
  a.ntile = (T + TT - 1) / TT;
  for (int j = 0; j < MAXP; ++j) a.dil[j] = j < P ? dils[j] : 0;
}

// The backward's workspace after the forward's scratch, in floats, in the
// order of BArgsT (xs, hs, cls, crs first: the wrapper reads them back; a
// bf16 chain keeps P trunk and P cotangent slots).
struct BwdLayout {
  long long xs, hs, cls, crs, st, ns, nos, dys, dcs, dhs, dno, dnb, tp, part,
      total;
};

BwdLayout bwd_layout(int B, int T, int D, int K, int P, int chunks,
                     bool lowp) {
  const long long ntile = (T + TT - 1) / TT;
  const long long btc = (long long)B * T * C, btd = (long long)B * T * D;
  const long long g = (long long)B * ntile;
  const long long slots = lowp ? P : P - 1;  // trunk and cotangent slots
  BwdLayout o;
  long long p = 3LL * btc + 3LL * g * C * 2;  // the forward's scratch
  o.xs = p; p += slots * btd;
  o.hs = p; p += P * btc;
  o.cls = p; p += P * btc;
  o.crs = p; p += P * btc;
  o.st = p; p += P * 3LL * g * C * 2;
  o.ns = p; p += 2LL * P * btc;
  o.nos = p; p += P * btc;
  o.dys = p; p += slots * btd;
  o.dcs = p; p += 2LL * P * btc;
  o.dhs = p; p += P * btc;
  o.dno = p; p += btc;
  o.dnb = p; p += 2 * btc;
  o.tp = p; p += 9LL * P * g * C;
  o.part = p;
  o.total = p;
  o.total += (long long)chunks * grad_floats(D, K, P);
  return o;
}

}  // namespace

// Floats of scratch the wrapper allocates for one forward launch.
extern "C" long long eabnet_tcm_chain_workspace(int B, int T) {
  const long long ntile = (T + TT - 1) / TT;
  return 3LL * B * T * C + (long long)B * ntile * 3 * C * 2;
}

// x (B, T, D) -> y (B, T, D) through P TCMs; weights as in Args; dils holds
// P host ints. All float32, contiguous, on the current device. Returns a
// cudaError_t. Requires C = 64 (narrower chains arrive zero-padded to it),
// D % 4 == 0, D <= 256, K <= 8, P <= 16.
extern "C" int eabnet_tcm_chain_fwd(const float* x, const float* wi,
                                    const float* wl, const float* wr,
                                    const float* wo, const float* al,
                                    const float* ga, const float* be, float* y,
                                    float* work, int B, int T, int D, int K,
                                    int P, const int* dils, int twin,
                                    void* stream) {
  if (bad_shape(B, T, D, K, P)) return cudaErrorInvalidValue;
  Args a;
  fill_args(a, x, wi, wl, wr, wo, al, ga, be, y, work, B, T, D, K, P, dils);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return twin ? launch<true>(a, s) : launch<false>(a, s);
}

// The serving forward with bf16 operands: as eabnet_tcm_chain_fwd with x,
// the weights, the tables and y in bfloat16; work holds
// eabnet_tcm_chain_workspace(B, T) + B T D floats (the float32 trunk last).
extern "C" int eabnet_tcm_chain_fwd_bf16(const bf16* x, const bf16* wi,
                                         const bf16* wl, const bf16* wr,
                                         const bf16* wo, const bf16* al,
                                         const bf16* ga, const bf16* be,
                                         bf16* y, float* work, int B, int T,
                                         int D, int K, int P, const int* dils,
                                         int twin, void* stream) {
  if (bad_shape(B, T, D, K, P)) return cudaErrorInvalidValue;
  ArgsT<bf16> a;
  fill_args(a, x, wi, wl, wr, wo, al, ga, be,
            work + eabnet_tcm_chain_workspace(B, T), work, B, T, D, K, P,
            dils);
  a.out = y;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return twin ? launch<true>(a, s) : launch<false>(a, s);
}

// The cooperative launch's geometry on the current device: out = {blocks,
// co-resident blocks per SM}, for the forward (bwd = 0; its bf16 variant
// with lowp = 1) or the backward's walk (bwd = 1). Returns a cudaError_t.
extern "C" int eabnet_tcm_chain_geometry(int bwd, int lowp, int twin, int K,
                                         int B, int T, int* out) {
  if (bad_shape(B, T, 4, K, 1)) return cudaErrorInvalidValue;
  return grid_of(bwd != 0, twin != 0, K, B, T, &out[0], &out[1], lowp != 0);
}

// Floats of scratch for one backward launch (negative on a CUDA error);
// lowp: bf16 training's.
extern "C" long long eabnet_tcm_chain_bwd_workspace(int B, int T, int D, int K,
                                                    int P, int twin,
                                                    int lowp) {
  int grid = 0, per_sm = 0;
  if (bad_shape(B, T, D, K, P) ||
      grid_of(true, twin != 0, K, B, T, &grid, &per_sm, lowp != 0) !=
          cudaSuccess)
    return -1;
  const int chunks = wgrad_chunks(B, T, D, K, P, twin != 0);
  if (chunks < 1) return -1;
  return bwd_layout(B, T, D, K, P, chunks, lowp != 0).total;
}

namespace {

// The backward's three launches on one stream (see eabnet_tcm_chain_bwd).
template <typename W>
cudaError_t launch_bwd(const W* x, const W* dy, const W* wi, const W* wl,
                       const W* wr, const W* wo, const W* al, const W* ga,
                       const W* be, W* dx, W* grads, float* work, int B, int T,
                       int D, int K, int P, const int* dils, int twin,
                       cudaStream_t s) {
  constexpr bool LOWP = sizeof(W) == 2;
  if (bad_shape(B, T, D, K, P)) return cudaErrorInvalidValue;
  int grid = 0, per_sm = 0;
  cudaError_t err = grid_of(true, twin != 0, K, B, T, &grid, &per_sm, LOWP);
  if (err != cudaSuccess) return err;
  const int chunks = wgrad_chunks(B, T, D, K, P, twin != 0);
  if (chunks < 1) return cudaErrorInvalidDevice;
  const BwdLayout o = bwd_layout(B, T, D, K, P, chunks, LOWP);
  BArgsT<W> g;
  fill_args(g.f, x, wi, wl, wr, wo, al, ga, be, nullptr, work, B, T, D, K, P,
            dils);
  g.dy = dy;
  g.dx = dx;
  g.xs = work + o.xs;
  g.hs = work + o.hs;
  g.cls = work + o.cls;
  g.crs = work + o.crs;
  g.st = work + o.st;
  g.ns = work + o.ns;
  g.nos = work + o.nos;
  g.dys = work + o.dys;
  g.dcs = work + o.dcs;
  g.dhs = work + o.dhs;
  g.dno = work + o.dno;
  g.dnb = work + o.dnb;
  g.tp = work + o.tp;
  void* params[] = {&g};
  const size_t smem = smem_floats(twin != 0, K) * sizeof(float);
  err = cudaLaunchCooperativeKernel(bwd_kernel<W>(twin != 0), dim3(grid),
                                    dim3(NT), params, smem, s);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the GEMM reads only float32: a bf16 chain's x and dy are their copies
  // in trunk slot 0 and cotangent slot P-1
  const size_t btd = (size_t)B * T * D;
  WArgs w;
  if constexpr (LOWP) {
    w.x = g.xs;
    w.xs = g.xs + btd;
    w.dy = g.dys + (P - 1) * btd;
  } else {
    w.x = x;
    w.xs = g.xs;
    w.dy = dy;
  }
  w.ns = g.ns; w.nos = g.nos; w.dys = g.dys;
  w.dcs = g.dcs; w.dhs = g.dhs; w.part = work + o.part;
  w.np = grad_floats(D, K, P);
  w.o_wl = (long long)P * D * C;
  w.o_wr = w.o_wl + (long long)P * K * C * C;
  w.o_wo = w.o_wr + (long long)P * K * C * C;
  w.B = B; w.T = T; w.D = D; w.K = K; w.P = P; w.NB = twin ? 2 : 1;
  w.nd = (D + 63) / 64;
  for (int j = 0; j < MAXP; ++j) w.dil[j] = g.f.dil[j];
  const size_t wsmem = sizeof(float) * WG_STAGES * WG_STAGE_FLOATS;
  err = cudaFuncSetAttribute(tcm_chain_wgrad_kernel<LOWP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(wsmem));
  if (err != cudaSuccess) return err;
  const int jobs = P * (2 * w.nd + w.NB * K);
  tcm_chain_wgrad_kernel<LOWP><<<dim3(chunks, jobs), NT, wsmem, s>>>(w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long o_al = w.o_wo + (long long)P * C * D;
  tcm_chain_grad_sum_kernel<<<(unsigned)((w.np + 255) / 256), 256, 0, s>>>(
      w.part, g.tp, grads, w.np, w.o_wr, w.o_wo, o_al, chunks, P,
      B * g.f.ntile, twin);
  return cudaGetLastError();
}

}  // namespace

// Backward of eabnet_tcm_chain_fwd: x and dy (B, T, D) and the weights ->
// dx (B, T, D) and grads = [wi, wl, wr, wo, alphas, gammas, betas] packed
// in that order, each in its forward layout, summed over the batch. work
// holds eabnet_tcm_chain_bwd_workspace(...) floats. Three launches on one
// stream: the cooperative walk, the weight-gradient GEMM, the sum. Returns
// a cudaError_t. The workspace starts with the forward's scratch
// (eabnet_tcm_chain_workspace floats), then the recomputed forward the
// reverse walk read: the trunk inputs of TCMs 1 .. P-1 (P-1, B, T, D), h
// (P, B, T, C) and the branch-L and -R conv outputs (P, B, T, C) each;
// tests read them back from there (kernels/tcm_chain.py::_launch_bwd).
extern "C" int eabnet_tcm_chain_bwd(const float* x, const float* dy,
                                    const float* wi, const float* wl,
                                    const float* wr, const float* wo,
                                    const float* al, const float* ga,
                                    const float* be, float* dx, float* grads,
                                    float* work, int B, int T, int D, int K,
                                    int P, const int* dils, int twin,
                                    void* stream) {
  return launch_bwd(x, dy, wi, wl, wr, wo, al, ga, be, dx, grads, work, B, T,
                    D, K, P, dils, twin, static_cast<cudaStream_t>(stream));
}

// The backward of bf16 training: as eabnet_tcm_chain_bwd with x, dy, the
// weights, the tables, dx and grads in bfloat16 and the workspace of
// eabnet_tcm_chain_bwd_workspace(..., lowp = 1). Its trunk slots hold the
// float32 inputs of all P TCMs (slot 0 x's copy), then h and the conv
// outputs as above; after them, past the statistics and the normalised
// inputs, the float32 cotangents at the P TCMs' outputs (slot P-1 dy's
// copy), where eabnet_tcm_chain_bwd_offsets says.
extern "C" int eabnet_tcm_chain_bwd_bf16(const bf16* x, const bf16* dy,
                                         const bf16* wi, const bf16* wl,
                                         const bf16* wr, const bf16* wo,
                                         const bf16* al, const bf16* ga,
                                         const bf16* be, bf16* dx,
                                         bf16* grads, float* work, int B,
                                         int T, int D, int K, int P,
                                         const int* dils, int twin,
                                         void* stream) {
  return launch_bwd(x, dy, wi, wl, wr, wo, al, ga, be, dx, grads, work, B, T,
                    D, K, P, dils, twin, static_cast<cudaStream_t>(stream));
}

// Offsets (floats) of the backward's trunk slots, cotangent slots and
// normalised gate outputs no (P, B, T, C) in its workspace: out = {xs,
// dys, nos}. Returns a cudaError_t.
extern "C" int eabnet_tcm_chain_bwd_offsets(int B, int T, int D, int K, int P,
                                            int twin, int lowp,
                                            long long* out) {
  if (bad_shape(B, T, D, K, P)) return cudaErrorInvalidValue;
  const int chunks = wgrad_chunks(B, T, D, K, P, twin != 0);
  if (chunks < 1) return cudaErrorInvalidDevice;
  const BwdLayout o = bwd_layout(B, T, D, K, P, chunks, lowp != 0);
  out[0] = o.xs;
  out[1] = o.dys;
  out[2] = o.nos;
  return cudaSuccess;
}

#ifdef TCM_CHAIN_CLOCKS
// Where the kernels write their counters (grid x 8 warps x 7 phases x 6
// categories long longs; null: nowhere). Returns a cudaError_t.
extern "C" int eabnet_tcm_chain_clock_buffer(long long* clk) {
  return cudaMemcpyToSymbol(tcm_clk, &clk, sizeof(clk));
}
#endif
