// Forward and backward of a whole squeezed-TCN group (a chain of p TCMs),
// for Hopper. The backward is described where it starts, below.
//
// Replaces the TPU kernel eabnet_tpu/kernels/tcm_chain.py::_fwd_kernel
// (math in _tcm_fwd_math). On the trunk x (B, T, D), TCM j computes
//   h  = x @ wi[j]                                   (D -> C = 64)
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
// of TT frames of one sample, spread over a cooperative grid that is sized
// to be co-resident (so B = 1 still fills many SMs). A tile never changes
// owner, so the trunk update of TCM j and the in-projection of TCM j+1 need
// no grid barrier. Per TCM there are three phases and two grid barriers:
//   A: h = x @ wi, PReLU per branch -> global; per-tile (mean, M2) stats
//   -- grid.sync --
//   B: merge the tiles' stats (Chan's formula, exact and stable), normalise
//      the K shifted input tiles on the fly (zeros before t = 0), conv,
//      gate, PReLU -> global; per-tile stats of the gate output
//   -- grid.sync --
//   C: merge stats, normalise, x += . @ wo, write the trunk
// Each phase stages its weights in shared memory once per block; products
// are plain f32 FMAs by hand. Statistics and sums are f32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int C = 64;      // squeezed channels
constexpr int TT = 16;     // frames per tile
constexpr int NT = 256;    // threads per block
constexpr int MAXD = 256;  // trunk width
constexpr int MAXK = 8;
constexpr int MAXP = 16;
constexpr float EPS = 1e-5f;

struct Args {
  const float* x;   // (B, T, D)
  const float* wi;  // (P, D, C)
  const float* wl;  // (P, K, C, C)  (tap, in, out)
  const float* wr;  // (P, K, C, C)  (ignored when single)
  const float* wo;  // (P, C, D)
  const float* al;  // (P, 3, C)  PReLU slopes [L, R, out]
  const float* ga;  // (P, 3, C)  IN scale
  const float* be;  // (P, 3, C)  IN bias
  float* y;         // (B, T, D)  trunk, then the output
  float* pbuf;      // (2, B, T, C)  branch PReLU outputs
  float* pobuf;     // (B, T, C)     gate PReLU output
  float* stats;     // (B, ntile, 3, C, 2)  per-tile (mean, M2)
  int B, T, D, K, P, ntile;
  int dil[MAXP];
};

__device__ __forceinline__ float sigm(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float prelu(float v, float a) {
  return fmaxf(v, 0.0f) + a * fminf(v, 0.0f);
}

__device__ __forceinline__ int tile_rows(const Args& a, int tile) {
  return min(TT, a.T - tile * TT);
}

// (mean, inv_std) over all T frames of sample b, slot s, channel c, merged
// from the per-tile partials.
__device__ void merge_stats(const Args& a, const float* stats, int b, int s,
                            int c, float* mean_out, float* inv_out) {
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int i = 0; i < a.ntile; ++i) {
    const float ni = static_cast<float>(tile_rows(a, i));
    const float* st = stats + ((((size_t)b * a.ntile + i) * 3 + s) * C + c) * 2;
    const float nn = n + ni;
    const float delta = st[0] - mean;
    mean += delta * (ni / nn);
    m2 += st[1] + delta * delta * (n * ni / nn);
    n = nn;
  }
  *mean_out = mean;
  *inv_out = 1.0f / sqrtf(m2 / static_cast<float>(a.T) + EPS);
}

// Per-tile (mean, M2) of s_v[rows][C] for channel c, written to slot s.
__device__ void tile_stats(const Args& a, float* stats, const float* s_v, int b,
                           int tile, int s, int c) {
  const int rows = tile_rows(a, tile);
  float sum = 0.0f;
  for (int r = 0; r < rows; ++r) sum += s_v[r * C + c];
  const float mean = sum / static_cast<float>(rows);
  float m2 = 0.0f;
  for (int r = 0; r < rows; ++r) {
    const float d = s_v[r * C + c] - mean;
    m2 += d * d;
  }
  float* st = stats + ((((size_t)b * a.ntile + tile) * 3 + s) * C + c) * 2;
  st[0] = mean;
  st[1] = m2;
}

__device__ void stage(float* dst, const float* src, int n, int tid) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = tid; i < n / 4; i += NT) d4[i] = s4[i];
}

// Phase A of TCM j: h = xin @ wi[j], PReLU per branch into a.pbuf, per-tile
// stats into stats; also h itself into save_h when given (the backward).
template <bool TWIN>
__device__ void phase_a(const Args& a, int j, const float* xin, float* sm,
                        float* save_h, float* stats) {
  const int tid = threadIdx.x;
  const int c = tid & (C - 1);   // output channel of the C-wide products
  const int rg = tid / C;        // row group: rows 4 rg .. 4 rg + 3
  const int D = a.D, T = a.T;
  const int n_tiles = a.B * a.ntile;
  constexpr int NB = TWIN ? 2 : 1;
  float* s_w = sm;                // [D][C]
  float* s_x = s_w + MAXD * C;    // [TT][D]
  float* s_p = s_x + TT * MAXD;   // [NB][TT][C]
  stage(s_w, a.wi + (size_t)j * D * C, D * C, tid);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
    const int rows = tile_rows(a, it);
    __syncthreads();
    for (int i = tid; i < TT * D; i += NT) {
      const int r = i / D;
      s_x[i] = r < rows ? xin[((size_t)b * T + t0 + r) * D + i % D] : 0.0f;
    }
    __syncthreads();
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < D; k += 4) {
      const float w0 = s_w[(k + 0) * C + c], w1 = s_w[(k + 1) * C + c];
      const float w2 = s_w[(k + 2) * C + c], w3 = s_w[(k + 3) * C + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(&s_x[(4 * rg + r) * D + k]);
        acc[r] += v.x * w0;
        acc[r] += v.y * w1;
        acc[r] += v.z * w2;
        acc[r] += v.w * w3;
      }
    }
    if (save_h) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * rg + r;
        if (row < rows) save_h[((size_t)b * T + t0 + row) * C + c] = acc[r];
      }
    }
#pragma unroll
    for (int br = 0; br < NB; ++br) {
      const float alpha = a.al[((size_t)j * 3 + br) * C + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * rg + r;
        const float v = prelu(acc[r], alpha);
        s_p[(br * TT + row) * C + c] = v;
        if (row < rows)
          a.pbuf[(((size_t)br * a.B + b) * T + t0 + row) * C + c] = v;
      }
    }
    __syncthreads();
    if (tid < NB * C)
      tile_stats(a, stats, s_p + (tid / C) * TT * C, b, it, tid / C, c);
  }
}

// Phase B of TCM j: normalise the branches, causal dilated conv, gate, PReLU
// into a.pobuf, per-tile stats of it; the conv outputs into save_cl/save_cr
// when given (the backward).
template <bool TWIN>
__device__ void phase_b(const Args& a, int j, float* sm, float* save_cl,
                        float* save_cr, float* stats) {
  const int tid = threadIdx.x;
  const int c = tid & (C - 1);
  const int rg = tid / C;
  const int T = a.T, K = a.K;
  const int n_tiles = a.B * a.ntile;
  constexpr int NB = TWIN ? 2 : 1;
  float* s_wl = sm;                     // [K][C][C]
  float* s_wr = s_wl + K * C * C;       // [K][C][C] (twin)
  float* s_n = TWIN ? s_wr + K * C * C : s_wr;  // [NB][TT][C]
  float* s_po = s_n + NB * TT * C;      // [TT][C]
  float* s_mean = s_po + TT * C;        // [NB][C]
  float* s_inv = s_mean + 2 * C;        // [NB][C]
  stage(s_wl, a.wl + (size_t)j * K * C * C, K * C * C, tid);
  if (TWIN) stage(s_wr, a.wr + (size_t)j * K * C * C, K * C * C, tid);
  const int dil = a.dil[j];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
    const int rows = tile_rows(a, it);
    __syncthreads();
    if (tid < NB * C)
      merge_stats(a, stats, b, tid / C, c, &s_mean[tid], &s_inv[tid]);
    float accl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float accr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < K; ++i) {
      const int shift = (K - 1 - i) * dil;
      __syncthreads();
      for (int e = tid; e < NB * TT * C; e += NT) {
        const int br = e / (TT * C), r = (e / C) % TT, ch = e % C;
        const int row = t0 + r - shift;
        float v = 0.0f;
        if (row >= 0 && row < T) {
          const float p = a.pbuf[(((size_t)br * a.B + b) * T + row) * C + ch];
          const size_t q = ((size_t)j * 3 + br) * C + ch;
          v = (p - s_mean[br * C + ch]) * s_inv[br * C + ch] * a.ga[q] + a.be[q];
        }
        s_n[e] = v;
      }
      __syncthreads();
      const float* wl = s_wl + i * C * C;
      const float* wr = s_wr + i * C * C;
      for (int k = 0; k < C; k += 4) {
        const float l0 = wl[(k + 0) * C + c], l1 = wl[(k + 1) * C + c];
        const float l2 = wl[(k + 2) * C + c], l3 = wl[(k + 3) * C + c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(&s_n[(4 * rg + r) * C + k]);
          accl[r] += v.x * l0;
          accl[r] += v.y * l1;
          accl[r] += v.z * l2;
          accl[r] += v.w * l3;
        }
        if (TWIN) {
          const float r0 = wr[(k + 0) * C + c], r1 = wr[(k + 1) * C + c];
          const float r2 = wr[(k + 2) * C + c], r3 = wr[(k + 3) * C + c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(&s_n[(TT + 4 * rg + r) * C + k]);
            accr[r] += v.x * r0;
            accr[r] += v.y * r1;
            accr[r] += v.z * r2;
            accr[r] += v.w * r3;
          }
        }
      }
    }
    const float alpha = a.al[((size_t)j * 3 + 2) * C + c];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * rg + r;
      const float g = TWIN ? accl[r] * sigm(accr[r]) : accl[r];
      const float v = prelu(g, alpha);
      s_po[row * C + c] = v;
      if (row < rows) {
        const size_t o = ((size_t)b * T + t0 + row) * C + c;
        a.pobuf[o] = v;
        if (save_cl) save_cl[o] = accl[r];
        if (TWIN && save_cr) save_cr[o] = accr[r];
      }
    }
    __syncthreads();
    if (tid < C) tile_stats(a, stats, s_po, b, it, 2, c);
  }
}

// Phase C of TCM j: normalise the gate output, yout = xin + . @ wo[j].
__device__ void phase_c(const Args& a, int j, const float* xin, float* yout,
                        float* sm, const float* stats) {
  const int tid = threadIdx.x;
  const int c = tid & (C - 1);
  const int D = a.D, T = a.T;
  const int n_tiles = a.B * a.ntile;
  float* s_w = sm;                // [C][D]
  float* s_no = s_w + C * MAXD;   // [TT][C]
  float* s_mean = s_no + TT * C;  // [C]
  float* s_inv = s_mean + C;      // [C]
  stage(s_w, a.wo + (size_t)j * C * D, C * D, tid);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
    const int rows = tile_rows(a, it);
    __syncthreads();
    if (tid < C) merge_stats(a, stats, b, 2, c, &s_mean[c], &s_inv[c]);
    __syncthreads();
    const size_t q = ((size_t)j * 3 + 2) * C;
    for (int e = tid; e < TT * C; e += NT) {
      const int r = e / C, ch = e % C;
      s_no[e] = r < rows
          ? (a.pobuf[((size_t)b * T + t0 + r) * C + ch] - s_mean[ch]) * s_inv[ch] * a.ga[q + ch] + a.be[q + ch]
          : 0.0f;
    }
    __syncthreads();
    if (tid < D) {
      const int d = tid;
      float acc[TT];
#pragma unroll
      for (int r = 0; r < TT; ++r) acc[r] = 0.0f;
      for (int k = 0; k < C; k += 4) {
        const float w0 = s_w[(k + 0) * D + d], w1 = s_w[(k + 1) * D + d];
        const float w2 = s_w[(k + 2) * D + d], w3 = s_w[(k + 3) * D + d];
#pragma unroll
        for (int r = 0; r < TT; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(&s_no[r * C + k]);
          acc[r] += v.x * w0;
          acc[r] += v.y * w1;
          acc[r] += v.z * w2;
          acc[r] += v.w * w3;
        }
      }
      for (int r = 0; r < rows; ++r) {
        const size_t o = ((size_t)b * T + t0 + r) * D + d;
        yout[o] = xin[o] + acc[r];
      }
    }
  }
}

template <bool TWIN>
__global__ void __launch_bounds__(NT) tcm_chain_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  for (int j = 0; j < a.P; ++j) {
    const float* xin = j == 0 ? a.x : a.y;
    phase_a<TWIN>(a, j, xin, sm, nullptr, a.stats);
    grid.sync();
    phase_b<TWIN>(a, j, sm, nullptr, nullptr, a.stats);
    grid.sync();
    phase_c(a, j, xin, a.y, sm, a.stats);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- backward
//
// Replaces eabnet_tpu/kernels/tcm_chain.py::_bwd_kernel. Only the group
// input x is a residual. The kernel first runs the chain forward again
// (phases A-C above), keeping what the reverse walk reads in a global
// workspace: each TCM's trunk input, h = x @ wi, the conv outputs cL (cR)
// and the per-tile IN statistics (~1.2 MB per sample and TCM at T = 601).
// Then, for j = P-1 .. 0, four phases over the same tiles, with the trunk
// cotangent dx updated in place, row by row, by the tile that owns the rows:
//   R1: dno = dx @ wo^T, dwo += no^T dx; per-tile sums of dno and dno*xhat
//   -- grid.sync --
//   R2: IN backward of the gate output (needs those sums over all of T),
//       PReLU backward, sigmoid gate -> dcL (dcR); dw += shift(n)^T dc
//   -- grid.sync --
//   R3: dn = sum_i shift_up(dc @ w_i^T, (K-1-i) dil) (reads later frames of
//       other tiles); per-tile sums of dn and dn*xhat per branch
//   -- grid.sync --
//   R4: IN and PReLU backward per branch -> dh; dwi += x^T dh; dx += dh @ wi^T
// What bounds it: three times the forward's products (the recompute, then
// the two products per forward product: the data and the weight
// cotangents), ~1.9 GFLOP per EaBNet group at B = 1, T = 601, on a few MB,
// so again the f32 rate; but 5 P grid barriers and the T-wide IN
// reductions serialise it.
// Grid barriers per launch: 2 per TCM for the forward, 3 per TCM for the
// reverse walk, 5 P in all (30 for an EaBNet group, 20 for a GaGNet one).
// The next TCM's R1 reads only rows its own tile wrote in R4, so R4 needs
// no barrier after it.
//
// Weight gradients: each block adds its tiles' contributions to its own
// slot of a partials buffer (no atomics); a second kernel sums the slots
// in block order. For a single-branch group only branch L and the out
// rows are written, so wr and row 1 of the (P, 3, C) tables get a zero
// gradient, as in the Pallas backward.
//
// Products with a transposed weight (wo^T, w^T, wi^T) stage the weight
// with a row stride of one more than its width, so a warp reading one
// column across 32 rows hits 32 banks.

struct BArgs {
  Args f;              // the forward's arguments and scratch
  const float* dy;     // (B, T, D) cotangent of the group output
  float* dx;           // (B, T, D) trunk cotangent, then d x
  float* xs;           // (P-1, B, T, D) trunk input of TCMs 1 .. P-1
  float* hs;           // (P, B, T, C) h = x @ wi
  float* cls;          // (P, B, T, C) branch-L conv output
  float* crs;          // (P, B, T, C) branch-R conv output (twin)
  float* st;           // (P, B, ntile, 3, C, 2) per-tile IN statistics
  float* dno;          // (B, T, C)
  float* dcb;          // (2, B, T, C) d conv output per branch
  float* dnb;          // (2, B, T, C) d conv input per branch
  float* sums1;        // (B, ntile, C, 2) per-tile (sum dno, sum dno*xhat)
  float* sums2;        // (B, ntile, 2, C, 2) the same per branch for dn
  float* part;         // (grid, NP) weight-gradient partials
  long long np;        // floats per partial slot (and of the gradients)
  long long o_wl, o_wr, o_wo, o_al, o_ga, o_be;  // offsets in a slot
};

__device__ __forceinline__ size_t btc(const Args& a, int b, int t, int c) {
  return ((size_t)b * a.T + t) * C + c;
}

// Merged (sum, sum*xhat) over all tiles of sample b, in tile order.
__device__ void merge_sums(const Args& a, const float* sums, int stride,
                           int b, int off, float* s1, float* s2) {
  float u = 0.0f, v = 0.0f;
  for (int i = 0; i < a.ntile; ++i) {
    const float* p = sums + ((size_t)b * a.ntile + i) * stride + off * 2;
    u += p[0];
    v += p[1];
  }
  *s1 = u;
  *s2 = v;
}

template <bool TWIN>
__global__ void __launch_bounds__(NT) tcm_chain_bwd_kernel(BArgs g) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const Args& a = g.f;
  const int tid = threadIdx.x;
  const int c = tid & (C - 1);
  const int rg = tid / C;
  const int D = a.D, T = a.T, K = a.K, P = a.P;
  const int n_tiles = a.B * a.ntile;
  constexpr int NB = TWIN ? 2 : 1;
  const size_t BTD = (size_t)a.B * T * D, BTC = (size_t)a.B * T * C;
  const size_t STS = (size_t)a.B * a.ntile * 3 * C * 2;
  const float inv_t = 1.0f / static_cast<float>(T);
  float* part = g.part + (size_t)blockIdx.x * g.np;
  float* p_wi = part;
  float* p_wl = part + g.o_wl;
  float* p_wr = part + g.o_wr;
  float* p_wo = part + g.o_wo;
  float* p_al = part + g.o_al;
  float* p_ga = part + g.o_ga;
  float* p_be = part + g.o_be;

  // ---------------------------------------------- the forward, saved
  for (int j = 0; j < P; ++j) {
    const float* xin = j == 0 ? a.x : g.xs + (j - 1) * BTD;
    float* stj = g.st + j * STS;
    phase_a<TWIN>(a, j, xin, sm, g.hs + j * BTC, stj);
    grid.sync();
    phase_b<TWIN>(a, j, sm, g.cls + j * BTC, g.crs + j * BTC, stj);
    grid.sync();
    if (j + 1 < P) phase_c(a, j, xin, g.xs + j * BTD, sm, stj);
    __syncthreads();
  }

  // ---------------------------------------------- the reverse walk
  for (int j = P - 1; j >= 0; --j) {
    const float* xin = j == 0 ? a.x : g.xs + (j - 1) * BTD;
    const float* stj = g.st + j * STS;
    const float* hj = g.hs + j * BTC;
    const float* clj = g.cls + j * BTC;
    const float* crj = g.crs + j * BTC;
    const float* dsrc = j == P - 1 ? g.dy : g.dx;
    const size_t q2 = ((size_t)j * 3 + 2) * C;  // out row of the tables
    // ------------------------------------------ R1
    {
      float* s_wo = sm;                       // [C][D+1]
      float* s_dy = s_wo + C * (MAXD + 1);    // [TT][D]
      float* s_no = s_dy + TT * MAXD;         // [TT][C]
      float* s_xo = s_no + TT * C;            // [TT][C]
      float* s_dno = s_xo + TT * C;           // [TT][C]
      float* s_mean = s_dno + TT * C;         // [C]
      float* s_inv = s_mean + C;              // [C]
      for (int i = tid; i < C * D; i += NT)
        s_wo[(i / D) * (D + 1) + i % D] = a.wo[(size_t)j * C * D + i];
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        __syncthreads();
        for (int i = tid; i < TT * D; i += NT) {
          const int r = i / D;
          s_dy[i] = r < rows ? dsrc[((size_t)b * T + t0 + r) * D + i % D] : 0.0f;
        }
        if (tid < C) merge_stats(a, stj, b, 2, c, &s_mean[c], &s_inv[c]);
        __syncthreads();
        for (int e = tid; e < TT * C; e += NT) {
          const int r = e / C, ch = e % C;
          float xo = 0.0f, no = 0.0f;
          if (r < rows) {
            const size_t o = btc(a, b, t0 + r, ch);
            const float gv = TWIN ? clj[o] * sigm(crj[o]) : clj[o];
            xo = (prelu(gv, a.al[q2 + ch]) - s_mean[ch]) * s_inv[ch];
            no = xo * a.ga[q2 + ch] + a.be[q2 + ch];
          }
          s_xo[e] = xo;
          s_no[e] = no;
        }
        // dno = dx @ wo^T
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int d = 0; d < D; ++d) {
          const float w = s_wo[c * (D + 1) + d];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r] += s_dy[(4 * rg + r) * D + d] * w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * rg + r;
          s_dno[row * C + c] = acc[r];
          if (row < rows) g.dno[btc(a, b, t0 + row, c)] = acc[r];
        }
        __syncthreads();
        // dwo += no^T dx
        if (tid < D) {
          for (int ch = 0; ch < C; ++ch) {
            float v = 0.0f;
#pragma unroll
            for (int r = 0; r < TT; ++r) v += s_no[r * C + ch] * s_dy[r * D + tid];
            p_wo[((size_t)j * C + ch) * D + tid] += v;
          }
        }
        if (tid < C) {
          float s1 = 0.0f, s2 = 0.0f;
          for (int r = 0; r < rows; ++r) {
            s1 += s_dno[r * C + c];
            s2 += s_dno[r * C + c] * s_xo[r * C + c];
          }
          float* sp = g.sums1 + (((size_t)b * a.ntile + it) * C + c) * 2;
          sp[0] = s1;
          sp[1] = s2;
          p_ga[q2 + c] += s2;
          p_be[q2 + c] += s1;
        }
      }
    }
    grid.sync();
    // ------------------------------------------ R2
    {
      float* s_dc = sm;                  // [NB][TT][C]
      float* s_n = s_dc + 2 * TT * C;    // [TT][C]
      float* s_tmp = s_n + TT * C;       // [TT][C]
      float* s_mean = s_tmp + TT * C;    // [3][C]
      float* s_inv = s_mean + 3 * C;     // [3][C]
      float* s_s = s_inv + 3 * C;        // [2][C] merged sums
      const int dil = a.dil[j];
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        __syncthreads();
        if (tid < C) {
          merge_stats(a, stj, b, 2, c, &s_mean[2 * C + c], &s_inv[2 * C + c]);
          merge_sums(a, g.sums1, C * 2, b, c, &s_s[c], &s_s[C + c]);
        } else if (tid < C + NB * C) {
          const int br = tid / C - 1;
          merge_stats(a, stj, b, br, c, &s_mean[br * C + c], &s_inv[br * C + c]);
        }
        __syncthreads();
        for (int e = tid; e < TT * C; e += NT) {
          const int r = e / C, ch = e % C;
          float dcl = 0.0f, dcr = 0.0f, da = 0.0f;
          if (r < rows) {
            const size_t o = btc(a, b, t0 + r, ch);
            const float cl = clj[o];
            const float sg = TWIN ? sigm(crj[o]) : 1.0f;
            const float gv = cl * sg;
            const float al = a.al[q2 + ch], ga = a.ga[q2 + ch];
            const float inv = s_inv[2 * C + ch];
            const float xo = (prelu(gv, al) - s_mean[2 * C + ch]) * inv;
            const float dpo = inv * (ga * g.dno[o] - ga * s_s[ch] * inv_t -
                                     xo * (ga * s_s[C + ch] * inv_t));
            const float dg = gv > 0.0f ? dpo : al * dpo;
            da = dpo * fminf(gv, 0.0f);
            if (TWIN) {
              dcl = dg * sg;
              dcr = dg * cl * sg * (1.0f - sg);
            } else {
              dcl = dg;
            }
            g.dcb[o] = dcl;
            if (TWIN) g.dcb[BTC + o] = dcr;
          }
          s_dc[e] = dcl;
          s_dc[TT * C + e] = dcr;
          s_tmp[e] = da;
        }
        __syncthreads();
        if (tid < C) {
          float v = 0.0f;
          for (int r = 0; r < rows; ++r) v += s_tmp[r * C + c];
          p_al[q2 + c] += v;
        }
        // dw[br][i] += shift_down(n_br, (K-1-i) dil)^T dc_br
        for (int br = 0; br < NB; ++br) {
          float* pw = br ? p_wr : p_wl;
          const size_t qb = ((size_t)j * 3 + br) * C;
          for (int i = 0; i < K; ++i) {
            const int shift = (K - 1 - i) * dil;
            __syncthreads();
            for (int e = tid; e < TT * C; e += NT) {
              const int r = e / C, ch = e % C, t = t0 + r - shift;
              float v = 0.0f;
              if (r < rows && t >= 0) {
                const float p = prelu(hj[btc(a, b, t, ch)], a.al[qb + ch]);
                v = (p - s_mean[br * C + ch]) * s_inv[br * C + ch] * a.ga[qb + ch] + a.be[qb + ch];
              }
              s_n[e] = v;
            }
            __syncthreads();
            const int k0 = rg * (C / 4);
            for (int kk = 0; kk < C / 4; ++kk) {
              const int k = k0 + kk;
              float v = 0.0f;
#pragma unroll
              for (int r = 0; r < TT; ++r) v += s_n[r * C + k] * s_dc[br * TT * C + r * C + c];
              pw[(((size_t)j * K + i) * C + k) * C + c] += v;
            }
          }
        }
      }
    }
    grid.sync();
    // ------------------------------------------ R3
    {
      float* s_w = sm;                             // [NB][K][C][C+1]
      float* s_dcs = s_w + NB * K * C * (C + 1);   // [TT][C]
      float* s_dn = s_dcs + TT * C;                // [NB][TT][C]
      float* s_mean = s_dn + NB * TT * C;          // [NB][C]
      float* s_inv = s_mean + NB * C;              // [NB][C]
      for (int br = 0; br < NB; ++br) {
        const float* w = (br ? a.wr : a.wl) + (size_t)j * K * C * C;
        for (int i = tid; i < K * C * C; i += NT) {
          const int tap = i / (C * C), k = (i / C) % C, ch = i % C;
          s_w[((br * K + tap) * C + k) * (C + 1) + ch] = w[i];
        }
      }
      const int dil = a.dil[j];
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        __syncthreads();
        if (tid < NB * C)
          merge_stats(a, stj, b, tid / C, c, &s_mean[tid], &s_inv[tid]);
        for (int br = 0; br < NB; ++br) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          const float* dcsrc = g.dcb + br * BTC;
          for (int i = 0; i < K; ++i) {
            const int shift = (K - 1 - i) * dil;
            __syncthreads();
            for (int e = tid; e < TT * C; e += NT) {
              const int r = e / C, ch = e % C, t = t0 + r + shift;
              s_dcs[e] = t < T ? dcsrc[btc(a, b, t, ch)] : 0.0f;
            }
            __syncthreads();
            const float* w = s_w + ((br * K + i) * C + c) * (C + 1);
            for (int k = 0; k < C; ++k) {
              const float wv = w[k];
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[r] += s_dcs[(4 * rg + r) * C + k] * wv;
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 4 * rg + r;
            s_dn[(br * TT + row) * C + c] = acc[r];
            if (row < rows) g.dnb[br * BTC + btc(a, b, t0 + row, c)] = acc[r];
          }
        }
        __syncthreads();
        if (tid < NB * C) {
          const int br = tid / C;
          const size_t qb = ((size_t)j * 3 + br) * C + c;
          float s1 = 0.0f, s2 = 0.0f;
          for (int r = 0; r < rows; ++r) {
            const float xh = (prelu(hj[btc(a, b, t0 + r, c)], a.al[qb]) -
                              s_mean[tid]) * s_inv[tid];
            const float dn = s_dn[(br * TT + r) * C + c];
            s1 += dn;
            s2 += dn * xh;
          }
          float* sp = g.sums2 + ((((size_t)b * a.ntile + it) * 2 + br) * C + c) * 2;
          sp[0] = s1;
          sp[1] = s2;
          p_ga[qb] += s2;
          p_be[qb] += s1;
        }
      }
    }
    grid.sync();
    // ------------------------------------------ R4
    {
      float* s_wi = sm;                       // [D][C+1]
      float* s_x = s_wi + MAXD * (C + 1);     // [TT][D]
      float* s_dh = s_x + TT * MAXD;          // [TT][C]
      float* s_tmp = s_dh + TT * C;           // [NB][TT][C]
      float* s_mean = s_tmp + 2 * TT * C;     // [NB][C]
      float* s_inv = s_mean + 2 * C;          // [NB][C]
      float* s_s = s_inv + 2 * C;             // [NB][2][C]
      for (int i = tid; i < D * C; i += NT)
        s_wi[(i / C) * (C + 1) + i % C] = a.wi[(size_t)j * D * C + i];
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        __syncthreads();
        if (tid < NB * C) {
          const int br = tid / C;
          merge_stats(a, stj, b, br, c, &s_mean[tid], &s_inv[tid]);
          merge_sums(a, g.sums2, 2 * C * 2, b, br * C + c,
                     &s_s[(br * 2) * C + c], &s_s[(br * 2 + 1) * C + c]);
        }
        for (int i = tid; i < TT * D; i += NT) {
          const int r = i / D;
          s_x[i] = r < rows ? xin[((size_t)b * T + t0 + r) * D + i % D] : 0.0f;
        }
        __syncthreads();
        for (int e = tid; e < TT * C; e += NT) {
          const int r = e / C, ch = e % C;
          float dh = 0.0f;
          float da[2] = {0.0f, 0.0f};
          if (r < rows) {
            const size_t o = btc(a, b, t0 + r, ch);
            const float hv = hj[o];
#pragma unroll
            for (int br = 0; br < NB; ++br) {
              const size_t qb = ((size_t)j * 3 + br) * C + ch;
              const float al = a.al[qb], ga = a.ga[qb];
              const float inv = s_inv[br * C + ch];
              const float xh = (prelu(hv, al) - s_mean[br * C + ch]) * inv;
              const float dp = inv * (ga * g.dnb[br * BTC + o] -
                                      ga * s_s[(br * 2) * C + ch] * inv_t -
                                      xh * (ga * s_s[(br * 2 + 1) * C + ch] * inv_t));
              dh += hv > 0.0f ? dp : al * dp;
              da[br] = dp * fminf(hv, 0.0f);
            }
          }
          s_dh[e] = dh;
          s_tmp[e] = da[0];
          s_tmp[TT * C + e] = da[1];
        }
        __syncthreads();
        if (tid < NB * C) {
          const int br = tid / C;
          float v = 0.0f;
          for (int r = 0; r < rows; ++r) v += s_tmp[(br * TT + r) * C + c];
          p_al[((size_t)j * 3 + br) * C + c] += v;
        }
        // dwi += x^T dh
        for (int d = rg; d < D; d += NT / C) {
          float v = 0.0f;
#pragma unroll
          for (int r = 0; r < TT; ++r) v += s_x[r * D + d] * s_dh[r * C + c];
          p_wi[((size_t)j * D + d) * C + c] += v;
        }
        // dx += dh @ wi^T (rows this tile owns)
        if (tid < D) {
          const int d = tid;
          float acc[TT];
#pragma unroll
          for (int r = 0; r < TT; ++r) acc[r] = 0.0f;
          for (int k = 0; k < C; ++k) {
            const float w = s_wi[d * (C + 1) + k];
#pragma unroll
            for (int r = 0; r < TT; ++r) acc[r] += s_dh[r * C + k] * w;
          }
          for (int r = 0; r < rows; ++r) {
            const size_t o = ((size_t)b * T + t0 + r) * D + d;
            g.dx[o] = dsrc[o] + acc[r];
          }
        }
      }
    }
    __syncthreads();
  }
}

// grads[i] = sum over blocks of the partials, in block order.
__global__ void tcm_chain_grad_sum_kernel(const float* __restrict__ part,
                                          float* __restrict__ grads,
                                          long long np, int nblk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np) return;
  float s = 0.0f;
  for (int b = 0; b < nblk; ++b) s += part[(size_t)b * np + i];
  grads[i] = s;
}

size_t smem_bytes(bool twin, int K) {
  const size_t a = MAXD * C + TT * MAXD + 2 * TT * C;
  const size_t b = (twin ? 2 : 1) * (size_t)K * C * C + (twin ? 2 : 1) * TT * C +
                   TT * C + 4 * C;
  const size_t c = C * MAXD + TT * C + 2 * C;
  size_t m = a > b ? a : b;
  m = m > c ? m : c;
  return m * sizeof(float);
}

size_t bwd_smem_bytes(bool twin, int K) {
  const size_t nb = twin ? 2 : 1;
  const size_t r1 = C * (MAXD + 1) + TT * MAXD + 3 * TT * C + 2 * C;
  const size_t r2 = 2 * TT * C + 2 * TT * C + 8 * C;
  const size_t r3 = nb * K * C * (C + 1) + TT * C + nb * TT * C + 2 * nb * C;
  const size_t r4 = MAXD * (C + 1) + TT * MAXD + TT * C + 2 * TT * C + 8 * C;
  size_t m = smem_bytes(twin, K) / sizeof(float);
  m = r1 > m ? r1 : m;
  m = r2 > m ? r2 : m;
  m = r3 > m ? r3 : m;
  m = r4 > m ? r4 : m;
  return m * sizeof(float);
}

// Grid of a cooperative launch: every tile, or as many blocks as can be
// co-resident with this shared-memory need, whichever is fewer.
cudaError_t coop_grid(const void* kern, size_t smem, int n_tiles, int* grid) {
  int dev = 0, n_sm = 0, per_sm = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = n_tiles < per_sm * n_sm ? n_tiles : per_sm * n_sm;
  return cudaSuccess;
}

template <bool TWIN>
cudaError_t launch(Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(TWIN, a.K);
  const void* kern = (const void*)tcm_chain_fwd_kernel<TWIN>;
  int grid = 0;
  cudaError_t err = coop_grid(kern, smem, a.B * a.ntile, &grid);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(NT), params, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t bwd_grid(bool twin, int K, int B, int T, int* grid) {
  const void* kern = twin ? (const void*)tcm_chain_bwd_kernel<true>
                          : (const void*)tcm_chain_bwd_kernel<false>;
  return coop_grid(kern, bwd_smem_bytes(twin, K), B * ((T + TT - 1) / TT),
                   grid);
}

// Floats of the packed weight gradients (wi, wl, wr, wo, al, ga, be).
long long grad_floats(int D, int K, int P) {
  return (long long)P * (2LL * D * C + 2LL * K * C * C + 9LL * C);
}

bool bad_shape(int B, int T, int D, int K, int P) {
  return B < 1 || T < 1 || D < 4 || D > MAXD || D % 4 || K < 1 || K > MAXK ||
         P < 1 || P > MAXP;
}

void fill_args(Args& a, const float* x, const float* wi, const float* wl,
               const float* wr, const float* wo, const float* al,
               const float* ga, const float* be, float* y, float* work, int B,
               int T, int D, int K, int P, const int* dils) {
  a.x = x; a.wi = wi; a.wl = wl; a.wr = wr; a.wo = wo;
  a.al = al; a.ga = ga; a.be = be; a.y = y;
  a.pbuf = work;
  a.pobuf = work + 2LL * B * T * C;
  a.stats = work + 3LL * B * T * C;
  a.B = B; a.T = T; a.D = D; a.K = K; a.P = P;
  a.ntile = (T + TT - 1) / TT;
  for (int j = 0; j < MAXP; ++j) a.dil[j] = j < P ? dils[j] : 0;
}

}  // namespace

// Floats of scratch the wrapper allocates for one forward launch.
extern "C" long long eabnet_tcm_chain_workspace(int B, int T) {
  const long long ntile = (T + TT - 1) / TT;
  return 3LL * B * T * C + (long long)B * ntile * 3 * C * 2;
}

// x (B, T, D) -> y (B, T, D) through P TCMs; weights as in Args; dils holds
// P host ints. All float32, contiguous, on the current device. Returns a
// cudaError_t. Requires C = 64, D % 4 == 0, D <= 256, K <= 8, P <= 16, and
// the branch weights of one TCM in shared memory (twin: K <= 6).
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

// Floats of scratch for one backward launch (negative on a CUDA error).
extern "C" long long eabnet_tcm_chain_bwd_workspace(int B, int T, int D, int K,
                                                    int P, int twin) {
  int grid = 0;
  if (bwd_grid(twin != 0, K, B, T, &grid) != cudaSuccess) return -1;
  const long long ntile = (T + TT - 1) / TT;
  const long long btc = (long long)B * T * C, btd = (long long)B * T * D;
  const long long st = (long long)B * ntile * 3 * C * 2;
  return eabnet_tcm_chain_workspace(B, T)   // the forward's scratch
         + (P - 1) * btd + 3LL * P * btc    // xs, hs, cls, crs
         + P * st                           // per-TCM statistics
         + 5 * btc                          // dno, dcb, dnb
         + (long long)B * ntile * C * 2 * 3 // sums1, sums2
         + grid * grad_floats(D, K, P);     // partials
}

// Backward of eabnet_tcm_chain_fwd: x and dy (B, T, D) and the weights ->
// dx (B, T, D) and grads = [wi, wl, wr, wo, alphas, gammas, betas] packed
// in that order, each in its forward layout, summed over the batch. work
// holds eabnet_tcm_chain_bwd_workspace(...) floats. Two launches on one
// stream: the cooperative backward and the sum of its partials. Returns a
// cudaError_t. The workspace starts with the forward's scratch
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
  if (bad_shape(B, T, D, K, P)) return cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = bwd_grid(twin != 0, K, B, T, &grid);
  if (err != cudaSuccess) return err;
  BArgs g;
  fill_args(g.f, x, wi, wl, wr, wo, al, ga, be, nullptr, work, B, T, D, K, P,
            dils);
  const long long ntile = g.f.ntile;
  const long long btc = (long long)B * T * C, btd = (long long)B * T * D;
  const long long st = (long long)B * ntile * 3 * C * 2;
  float* p = work + eabnet_tcm_chain_workspace(B, T);
  g.dy = dy;
  g.dx = dx;
  g.xs = p; p += (P - 1) * btd;
  g.hs = p; p += P * btc;
  g.cls = p; p += P * btc;
  g.crs = p; p += P * btc;
  g.st = p; p += P * st;
  g.dno = p; p += btc;
  g.dcb = p; p += 2 * btc;
  g.dnb = p; p += 2 * btc;
  g.sums1 = p; p += (long long)B * ntile * C * 2;
  g.sums2 = p; p += (long long)B * ntile * C * 2 * 2;
  g.part = p;
  g.np = grad_floats(D, K, P);
  g.o_wl = (long long)P * D * C;
  g.o_wr = g.o_wl + (long long)P * K * C * C;
  g.o_wo = g.o_wr + (long long)P * K * C * C;
  g.o_al = g.o_wo + (long long)P * C * D;
  g.o_ga = g.o_al + 3LL * P * C;
  g.o_be = g.o_ga + 3LL * P * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(g.part, 0, sizeof(float) * grid * g.np, s);
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_smem_bytes(twin != 0, K);
  const void* kern = twin ? (const void*)tcm_chain_bwd_kernel<true>
                          : (const void*)tcm_chain_bwd_kernel<false>;
  void* params[] = {&g};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(NT), params, smem, s);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tcm_chain_grad_sum_kernel<<<(unsigned)((g.np + 255) / 256), 256, 0, s>>>(
      g.part, grads, g.np, grid);
  return cudaGetLastError();
}
