// The TCM-chain kernels of the first design (eabnet_tpu_torch/csrc/
// tcm_chain.cu as it stood before the tensor-core design: scalar FFMA
// products, 16-frame tiles on a cooperative grid sized by one block's
// shared memory, per-tile serial statistics merges, weight gradients as
// per-block partial slots), with clock64() counters: the measurement that
// the redesign started from, and the "before" column it is timed against.
// Built on its own by tcm_chain_split.py (nvcc -shared) and called through
// ctypes; not part of the kernel library.
//
// Lane 0 of every warp adds the clocks of each region of a phase to
// clk[block][warp][phase][category] (phases A, B, C of the recompute or
// the forward, R1-R4 of the reverse walk; categories below); the sum over
// categories is the phase's time on that warp. MODE knocks parts out, to
// separate their costs (the outputs are then wrong):
//   bit 0: no statistics merges (mean 0, inverse deviation 1 stand in);
//   bit 1: no weight-gradient work in the walk (the dwo, dw and dwi
//          products and their read-modify-writes of the partial slots).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int C = 64;
constexpr int TT = 16;
constexpr int NT = 256;
constexpr int MAXD = 256;
constexpr int MAXP = 16;
constexpr float EPS = 1e-5f;
constexpr int NPH = 7;   // A, B, C, R1, R2, R3, R4
constexpr int NCAT = 7;  // categories below
enum { MERGE, STAGE, PRODUCT, WGRAD, BARRIER, GRID, OTHER };
constexpr int CLK_FLOATS = (NT / 32) * NPH * NCAT * 2;  // long longs as floats

struct Args {
  const float* x;
  const float* wi;
  const float* wl;
  const float* wr;
  const float* wo;
  const float* al;
  const float* ga;
  const float* be;
  float* y;
  float* pbuf;
  float* pobuf;
  float* stats;
  int B, T, D, K, P, ntile, mode;
  int dil[MAXP];
};

// Clock counters of one warp in shared memory; mark(ph, cat) adds the
// clocks since the last mark to (ph, cat).
template <bool CLK>
struct Clk {
  long long last;
  long long* s;
  bool lead;
  __device__ void init(long long* base) {
    if (CLK) {
      s = base + (threadIdx.x >> 5) * NPH * NCAT;
      lead = (threadIdx.x & 31) == 0;
      if (lead)
        for (int i = 0; i < NPH * NCAT; ++i) s[i] = 0;
      last = clock64();
    }
  }
  __device__ __forceinline__ void mark(int ph, int cat) {
    if (CLK) {
      const long long now = clock64();
      if (lead) s[ph * NCAT + cat] += now - last;
      last = now;
    }
  }
  __device__ __forceinline__ void bar(int ph, int cat) {
    mark(ph, cat);
    __syncthreads();
    mark(ph, BARRIER);
  }
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

__device__ void merge_stats(const Args& a, const float* stats, int b, int s,
                            int c, float* mean_out, float* inv_out) {
  if (a.mode & 1) {
    *mean_out = 0.0f;
    *inv_out = 1.0f;
    return;
  }
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

template <bool TWIN, bool CLK>
__device__ void phase_a(const Args& a, int j, const float* xin, float* sm,
                        float* save_h, float* stats, Clk<CLK>& k_) {
  constexpr int PH = 0;
  const int tid = threadIdx.x;
  const int c = tid & (C - 1);
  const int rg = tid / C;
  const int D = a.D, T = a.T;
  const int n_tiles = a.B * a.ntile;
  constexpr int NB = TWIN ? 2 : 1;
  float* s_w = sm;
  float* s_x = s_w + MAXD * C;
  float* s_p = s_x + TT * MAXD;
  stage(s_w, a.wi + (size_t)j * D * C, D * C, tid);
  k_.mark(PH, STAGE);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
    const int rows = tile_rows(a, it);
    k_.bar(PH, OTHER);
    for (int i = tid; i < TT * D; i += NT) {
      const int r = i / D;
      s_x[i] = r < rows ? xin[((size_t)b * T + t0 + r) * D + i % D] : 0.0f;
    }
    k_.bar(PH, STAGE);
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
    k_.mark(PH, PRODUCT);
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
    k_.bar(PH, OTHER);
    if (tid < NB * C)
      tile_stats(a, stats, s_p + (tid / C) * TT * C, b, it, tid / C, c);
    k_.mark(PH, OTHER);
  }
}

template <bool TWIN, bool CLK>
__device__ void phase_b(const Args& a, int j, float* sm, float* save_cl,
                        float* save_cr, float* stats, Clk<CLK>& k_) {
  constexpr int PH = 1;
  const int tid = threadIdx.x;
  const int c = tid & (C - 1);
  const int rg = tid / C;
  const int T = a.T, K = a.K;
  const int n_tiles = a.B * a.ntile;
  constexpr int NB = TWIN ? 2 : 1;
  float* s_wl = sm;
  float* s_wr = s_wl + K * C * C;
  float* s_n = TWIN ? s_wr + K * C * C : s_wr;
  float* s_po = s_n + NB * TT * C;
  float* s_mean = s_po + TT * C;
  float* s_inv = s_mean + 2 * C;
  stage(s_wl, a.wl + (size_t)j * K * C * C, K * C * C, tid);
  if (TWIN) stage(s_wr, a.wr + (size_t)j * K * C * C, K * C * C, tid);
  k_.mark(PH, STAGE);
  const int dil = a.dil[j];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
    const int rows = tile_rows(a, it);
    k_.bar(PH, OTHER);
    if (tid < NB * C)
      merge_stats(a, stats, b, tid / C, c, &s_mean[tid], &s_inv[tid]);
    k_.mark(PH, MERGE);
    float accl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float accr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < K; ++i) {
      const int shift = (K - 1 - i) * dil;
      k_.bar(PH, OTHER);
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
      k_.bar(PH, STAGE);
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
      k_.mark(PH, PRODUCT);
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
    k_.bar(PH, OTHER);
    if (tid < C) tile_stats(a, stats, s_po, b, it, 2, c);
    k_.mark(PH, OTHER);
  }
}

template <bool CLK>
__device__ void phase_c(const Args& a, int j, const float* xin, float* yout,
                        float* sm, const float* stats, Clk<CLK>& k_) {
  constexpr int PH = 2;
  const int tid = threadIdx.x;
  const int c = tid & (C - 1);
  const int D = a.D, T = a.T;
  const int n_tiles = a.B * a.ntile;
  float* s_w = sm;
  float* s_no = s_w + C * MAXD;
  float* s_mean = s_no + TT * C;
  float* s_inv = s_mean + C;
  stage(s_w, a.wo + (size_t)j * C * D, C * D, tid);
  k_.mark(PH, STAGE);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
    const int rows = tile_rows(a, it);
    k_.bar(PH, OTHER);
    if (tid < C) merge_stats(a, stats, b, 2, c, &s_mean[c], &s_inv[c]);
    k_.bar(PH, MERGE);
    const size_t q = ((size_t)j * 3 + 2) * C;
    for (int e = tid; e < TT * C; e += NT) {
      const int r = e / C, ch = e % C;
      s_no[e] = r < rows
          ? (a.pobuf[((size_t)b * T + t0 + r) * C + ch] - s_mean[ch]) * s_inv[ch] * a.ga[q + ch] + a.be[q + ch]
          : 0.0f;
    }
    k_.bar(PH, STAGE);
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
      k_.mark(PH, PRODUCT);
      for (int r = 0; r < rows; ++r) {
        const size_t o = ((size_t)b * T + t0 + r) * D + d;
        yout[o] = xin[o] + acc[r];
      }
    }
    k_.mark(PH, OTHER);
  }
}

template <bool TWIN, bool CLK>
__global__ void __launch_bounds__(NT) split_fwd_kernel(Args a, long long* clk) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4) + (CLK ? CLK_FLOATS : 0);
  cg::grid_group grid = cg::this_grid();
  Clk<CLK> k_;
  k_.init(reinterpret_cast<long long*>(smem4));
  for (int j = 0; j < a.P; ++j) {
    const float* xin = j == 0 ? a.x : a.y;
    phase_a<TWIN, CLK>(a, j, xin, sm, nullptr, a.stats, k_);
    k_.mark(0, OTHER);
    grid.sync();
    k_.mark(0, GRID);
    phase_b<TWIN, CLK>(a, j, sm, nullptr, nullptr, a.stats, k_);
    k_.mark(1, OTHER);
    grid.sync();
    k_.mark(1, GRID);
    phase_c<CLK>(a, j, xin, a.y, sm, a.stats, k_);
    k_.bar(2, OTHER);
  }
  if (CLK && k_.lead) {
    long long* o = clk + ((size_t)blockIdx.x * (NT / 32) + threadIdx.x / 32) * NPH * NCAT;
    for (int i = 0; i < NPH * NCAT; ++i) o[i] = k_.s[i];
  }
}

struct BArgs {
  Args f;
  const float* dy;
  float* dx;
  float* xs;
  float* hs;
  float* cls;
  float* crs;
  float* st;
  float* dno;
  float* dcb;
  float* dnb;
  float* sums1;
  float* sums2;
  float* part;
  long long np;
  long long o_wl, o_wr, o_wo, o_al, o_ga, o_be;
};

__device__ __forceinline__ size_t btc(const Args& a, int b, int t, int c) {
  return ((size_t)b * a.T + t) * C + c;
}

__device__ void merge_sums(const Args& a, const float* sums, int stride,
                           int b, int off, float* s1, float* s2) {
  if (a.mode & 1) {
    *s1 = 0.0f;
    *s2 = 0.0f;
    return;
  }
  float u = 0.0f, v = 0.0f;
  for (int i = 0; i < a.ntile; ++i) {
    const float* p = sums + ((size_t)b * a.ntile + i) * stride + off * 2;
    u += p[0];
    v += p[1];
  }
  *s1 = u;
  *s2 = v;
}

template <bool TWIN, bool CLK>
__global__ void __launch_bounds__(NT) split_bwd_kernel(BArgs g, long long* clk) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4) + (CLK ? CLK_FLOATS : 0);
  cg::grid_group grid = cg::this_grid();
  Clk<CLK> k_;
  k_.init(reinterpret_cast<long long*>(smem4));
  const Args& a = g.f;
  const int tid = threadIdx.x;
  const int c = tid & (C - 1);
  const int rg = tid / C;
  const int D = a.D, T = a.T, K = a.K, P = a.P;
  const int n_tiles = a.B * a.ntile;
  const bool wgrad = !(a.mode & 2);
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

  for (int j = 0; j < P; ++j) {
    const float* xin = j == 0 ? a.x : g.xs + (j - 1) * BTD;
    float* stj = g.st + j * STS;
    phase_a<TWIN, CLK>(a, j, xin, sm, g.hs + j * BTC, stj, k_);
    k_.mark(0, OTHER);
    grid.sync();
    k_.mark(0, GRID);
    phase_b<TWIN, CLK>(a, j, sm, g.cls + j * BTC, g.crs + j * BTC, stj, k_);
    k_.mark(1, OTHER);
    grid.sync();
    k_.mark(1, GRID);
    if (j + 1 < P) phase_c<CLK>(a, j, xin, g.xs + j * BTD, sm, stj, k_);
    k_.bar(2, OTHER);
  }

  for (int j = P - 1; j >= 0; --j) {
    const float* xin = j == 0 ? a.x : g.xs + (j - 1) * BTD;
    const float* stj = g.st + j * STS;
    const float* hj = g.hs + j * BTC;
    const float* clj = g.cls + j * BTC;
    const float* crj = g.crs + j * BTC;
    const float* dsrc = j == P - 1 ? g.dy : g.dx;
    const size_t q2 = ((size_t)j * 3 + 2) * C;
    {  // R1
      constexpr int PH = 3;
      float* s_wo = sm;
      float* s_dy = s_wo + C * (MAXD + 1);
      float* s_no = s_dy + TT * MAXD;
      float* s_xo = s_no + TT * C;
      float* s_dno = s_xo + TT * C;
      float* s_mean = s_dno + TT * C;
      float* s_inv = s_mean + C;
      for (int i = tid; i < C * D; i += NT)
        s_wo[(i / D) * (D + 1) + i % D] = a.wo[(size_t)j * C * D + i];
      k_.mark(PH, STAGE);
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        k_.bar(PH, OTHER);
        for (int i = tid; i < TT * D; i += NT) {
          const int r = i / D;
          s_dy[i] = r < rows ? dsrc[((size_t)b * T + t0 + r) * D + i % D] : 0.0f;
        }
        k_.mark(PH, STAGE);
        if (tid < C) merge_stats(a, stj, b, 2, c, &s_mean[c], &s_inv[c]);
        k_.bar(PH, MERGE);
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
        k_.mark(PH, STAGE);
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int d = 0; d < D; ++d) {
          const float w = s_wo[c * (D + 1) + d];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r] += s_dy[(4 * rg + r) * D + d] * w;
        }
        k_.mark(PH, PRODUCT);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * rg + r;
          s_dno[row * C + c] = acc[r];
          if (row < rows) g.dno[btc(a, b, t0 + row, c)] = acc[r];
        }
        k_.bar(PH, OTHER);
        if (wgrad && tid < D) {
          for (int ch = 0; ch < C; ++ch) {
            float v = 0.0f;
#pragma unroll
            for (int r = 0; r < TT; ++r) v += s_no[r * C + ch] * s_dy[r * D + tid];
            p_wo[((size_t)j * C + ch) * D + tid] += v;
          }
        }
        k_.mark(PH, WGRAD);
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
        k_.mark(PH, OTHER);
      }
    }
    k_.mark(3, OTHER);
    grid.sync();
    k_.mark(3, GRID);
    {  // R2
      constexpr int PH = 4;
      float* s_dc = sm;
      float* s_n = s_dc + 2 * TT * C;
      float* s_tmp = s_n + TT * C;
      float* s_mean = s_tmp + TT * C;
      float* s_inv = s_mean + 3 * C;
      float* s_s = s_inv + 3 * C;
      const int dil = a.dil[j];
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        k_.bar(PH, OTHER);
        if (tid < C) {
          merge_stats(a, stj, b, 2, c, &s_mean[2 * C + c], &s_inv[2 * C + c]);
          merge_sums(a, g.sums1, C * 2, b, c, &s_s[c], &s_s[C + c]);
        } else if (tid < C + NB * C) {
          const int br = tid / C - 1;
          merge_stats(a, stj, b, br, c, &s_mean[br * C + c], &s_inv[br * C + c]);
        }
        k_.bar(PH, MERGE);
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
        k_.bar(PH, OTHER);
        if (tid < C) {
          float v = 0.0f;
          for (int r = 0; r < rows; ++r) v += s_tmp[r * C + c];
          p_al[q2 + c] += v;
        }
        k_.mark(PH, OTHER);
        if (wgrad) {
          for (int br = 0; br < NB; ++br) {
            float* pw = br ? p_wr : p_wl;
            const size_t qb = ((size_t)j * 3 + br) * C;
            for (int i = 0; i < K; ++i) {
              const int shift = (K - 1 - i) * dil;
              k_.bar(PH, WGRAD);
              for (int e = tid; e < TT * C; e += NT) {
                const int r = e / C, ch = e % C, t = t0 + r - shift;
                float v = 0.0f;
                if (r < rows && t >= 0) {
                  const float p = prelu(hj[btc(a, b, t, ch)], a.al[qb + ch]);
                  v = (p - s_mean[br * C + ch]) * s_inv[br * C + ch] * a.ga[qb + ch] + a.be[qb + ch];
                }
                s_n[e] = v;
              }
              k_.bar(PH, STAGE);
              const int k0 = rg * (C / 4);
              for (int kk = 0; kk < C / 4; ++kk) {
                const int k = k0 + kk;
                float v = 0.0f;
#pragma unroll
                for (int r = 0; r < TT; ++r) v += s_n[r * C + k] * s_dc[br * TT * C + r * C + c];
                pw[(((size_t)j * K + i) * C + k) * C + c] += v;
              }
              k_.mark(PH, WGRAD);
            }
          }
        }
      }
    }
    k_.mark(4, OTHER);
    grid.sync();
    k_.mark(4, GRID);
    {  // R3
      constexpr int PH = 5;
      float* s_w = sm;
      float* s_dcs = s_w + NB * K * C * (C + 1);
      float* s_dn = s_dcs + TT * C;
      float* s_mean = s_dn + NB * TT * C;
      float* s_inv = s_mean + NB * C;
      for (int br = 0; br < NB; ++br) {
        const float* w = (br ? a.wr : a.wl) + (size_t)j * K * C * C;
        for (int i = tid; i < K * C * C; i += NT) {
          const int tap = i / (C * C), k = (i / C) % C, ch = i % C;
          s_w[((br * K + tap) * C + k) * (C + 1) + ch] = w[i];
        }
      }
      k_.mark(PH, STAGE);
      const int dil = a.dil[j];
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        k_.bar(PH, OTHER);
        if (tid < NB * C)
          merge_stats(a, stj, b, tid / C, c, &s_mean[tid], &s_inv[tid]);
        k_.mark(PH, MERGE);
        for (int br = 0; br < NB; ++br) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          const float* dcsrc = g.dcb + br * BTC;
          for (int i = 0; i < K; ++i) {
            const int shift = (K - 1 - i) * dil;
            k_.bar(PH, OTHER);
            for (int e = tid; e < TT * C; e += NT) {
              const int r = e / C, ch = e % C, t = t0 + r + shift;
              s_dcs[e] = t < T ? dcsrc[btc(a, b, t, ch)] : 0.0f;
            }
            k_.bar(PH, STAGE);
            const float* w = s_w + ((br * K + i) * C + c) * (C + 1);
            for (int k = 0; k < C; ++k) {
              const float wv = w[k];
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[r] += s_dcs[(4 * rg + r) * C + k] * wv;
            }
            k_.mark(PH, PRODUCT);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 4 * rg + r;
            s_dn[(br * TT + row) * C + c] = acc[r];
            if (row < rows) g.dnb[br * BTC + btc(a, b, t0 + row, c)] = acc[r];
          }
        }
        k_.bar(PH, OTHER);
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
        k_.mark(PH, OTHER);
      }
    }
    k_.mark(5, OTHER);
    grid.sync();
    k_.mark(5, GRID);
    {  // R4
      constexpr int PH = 6;
      float* s_wi = sm;
      float* s_x = s_wi + MAXD * (C + 1);
      float* s_dh = s_x + TT * MAXD;
      float* s_tmp = s_dh + TT * C;
      float* s_mean = s_tmp + 2 * TT * C;
      float* s_inv = s_mean + 2 * C;
      float* s_s = s_inv + 2 * C;
      for (int i = tid; i < D * C; i += NT)
        s_wi[(i / C) * (C + 1) + i % C] = a.wi[(size_t)j * D * C + i];
      k_.mark(PH, STAGE);
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        k_.bar(PH, OTHER);
        if (tid < NB * C) {
          const int br = tid / C;
          merge_stats(a, stj, b, br, c, &s_mean[tid], &s_inv[tid]);
          merge_sums(a, g.sums2, 2 * C * 2, b, br * C + c,
                     &s_s[(br * 2) * C + c], &s_s[(br * 2 + 1) * C + c]);
        }
        k_.mark(PH, MERGE);
        for (int i = tid; i < TT * D; i += NT) {
          const int r = i / D;
          s_x[i] = r < rows ? xin[((size_t)b * T + t0 + r) * D + i % D] : 0.0f;
        }
        k_.bar(PH, STAGE);
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
        k_.bar(PH, OTHER);
        if (tid < NB * C) {
          const int br = tid / C;
          float v = 0.0f;
          for (int r = 0; r < rows; ++r) v += s_tmp[(br * TT + r) * C + c];
          p_al[((size_t)j * 3 + br) * C + c] += v;
        }
        k_.mark(PH, OTHER);
        if (wgrad) {
          for (int d = rg; d < D; d += NT / C) {
            float v = 0.0f;
#pragma unroll
            for (int r = 0; r < TT; ++r) v += s_x[r * D + d] * s_dh[r * C + c];
            p_wi[((size_t)j * D + d) * C + c] += v;
          }
        }
        k_.mark(PH, WGRAD);
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
          k_.mark(PH, PRODUCT);
          for (int r = 0; r < rows; ++r) {
            const size_t o = ((size_t)b * T + t0 + r) * D + d;
            g.dx[o] = dsrc[o] + acc[r];
          }
        }
        k_.mark(PH, OTHER);
      }
    }
    k_.bar(6, OTHER);
  }
  if (CLK && k_.lead) {
    long long* o = clk + ((size_t)blockIdx.x * (NT / 32) + threadIdx.x / 32) * NPH * NCAT;
    for (int i = 0; i < NPH * NCAT; ++i) o[i] = k_.s[i];
  }
}

__global__ void split_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ grads, long long np,
                                 int nblk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= np) return;
  float s = 0.0f;
  for (int b = 0; b < nblk; ++b) s += part[(size_t)b * np + i];
  grads[i] = s;
}

// Shared memory of the first design (floats), and with the counters.
size_t fwd_floats(bool twin, int K) {
  const size_t a = MAXD * C + TT * MAXD + 2 * TT * C;
  const size_t b = (twin ? 2 : 1) * (size_t)K * C * C + (twin ? 2 : 1) * TT * C +
                   TT * C + 4 * C;
  const size_t c = C * MAXD + TT * C + 2 * C;
  size_t m = a > b ? a : b;
  return m > c ? m : c;
}

size_t bwd_floats(bool twin, int K) {
  const size_t nb = twin ? 2 : 1;
  const size_t r1 = C * (MAXD + 1) + TT * MAXD + 3 * TT * C + 2 * C;
  const size_t r2 = 2 * TT * C + 2 * TT * C + 8 * C;
  const size_t r3 = nb * K * C * (C + 1) + TT * C + nb * TT * C + 2 * nb * C;
  const size_t r4 = MAXD * (C + 1) + TT * MAXD + TT * C + 2 * TT * C + 8 * C;
  size_t m = fwd_floats(twin, K);
  m = r1 > m ? r1 : m;
  m = r2 > m ? r2 : m;
  m = r3 > m ? r3 : m;
  return r4 > m ? r4 : m;
}

size_t smem_of(bool bwd, bool twin, int K, bool clk) {
  return ((bwd ? bwd_floats(twin, K) : fwd_floats(twin, K)) +
          (clk ? CLK_FLOATS : 0)) * sizeof(float);
}

cudaError_t coop_grid(const void* kern, size_t smem, int n_tiles, int* grid) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
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

const void* fwd_kern(bool twin, bool clk) {
  if (twin) return clk ? (const void*)split_fwd_kernel<true, true>
                       : (const void*)split_fwd_kernel<true, false>;
  return clk ? (const void*)split_fwd_kernel<false, true>
             : (const void*)split_fwd_kernel<false, false>;
}

const void* bwd_kern(bool twin, bool clk) {
  if (twin) return clk ? (const void*)split_bwd_kernel<true, true>
                       : (const void*)split_bwd_kernel<true, false>;
  return clk ? (const void*)split_bwd_kernel<false, true>
             : (const void*)split_bwd_kernel<false, false>;
}

long long grad_floats(int D, int K, int P) {
  return (long long)P * (2LL * D * C + 2LL * K * C * C + 9LL * C);
}

void fill_args(Args& a, const float* x, const float* const* w, float* y,
               float* work, int B, int T, int D, int K, int P,
               const int* dils, int mode) {
  a.x = x; a.wi = w[0]; a.wl = w[1]; a.wr = w[2]; a.wo = w[3];
  a.al = w[4]; a.ga = w[5]; a.be = w[6]; a.y = y;
  a.pbuf = work;
  a.pobuf = work + 2LL * B * T * C;
  a.stats = work + 3LL * B * T * C;
  a.B = B; a.T = T; a.D = D; a.K = K; a.P = P;
  a.ntile = (T + TT - 1) / TT;
  a.mode = mode;
  for (int j = 0; j < MAXP; ++j) a.dil[j] = j < P ? dils[j] : 0;
}

long long fwd_work(int B, int T) {
  const long long ntile = (T + TT - 1) / TT;
  return 3LL * B * T * C + (long long)B * ntile * 3 * C * 2;
}

}  // namespace

// The launch geometry: grid[0] blocks of 256 threads, grid[1] blocks per SM
// by occupancy, for the forward (bwd = 0) or the backward (bwd = 1).
extern "C" int split_grid(int bwd, int twin, int K, int B, int T, int* out) {
  const size_t smem = smem_of(bwd, twin, K, false);
  const void* kern = bwd ? bwd_kern(twin, false) : fwd_kern(twin, false);
  int grid = 0, per_sm = 0;
  cudaError_t err = coop_grid(kern, smem, B * ((T + TT - 1) / TT), &grid);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  out[0] = grid;
  out[1] = per_sm;
  return err;
}

// Floats of scratch for split_bwd (the forward needs fwd_work(B, T)).
extern "C" long long split_bwd_workspace(int B, int T, int D, int K, int P,
                                         int twin) {
  int g[2];
  if (split_grid(1, twin, K, B, T, g) != cudaSuccess) return -1;
  const long long ntile = (T + TT - 1) / TT;
  const long long btc = (long long)B * T * C, btd = (long long)B * T * D;
  const long long st = (long long)B * ntile * 3 * C * 2;
  return fwd_work(B, T) + (P - 1) * btd + 3LL * P * btc + P * st + 5 * btc +
         (long long)B * ntile * C * 2 * 3 + g[0] * grad_floats(D, K, P);
}

extern "C" long long split_fwd_workspace(int B, int T) { return fwd_work(B, T); }

// The first design's forward: w = {wi, wl, wr, wo, al, ga, be}; clk, when
// clk_on, holds grid x 8 x 7 x 7 long longs.
extern "C" int split_fwd(const float* x, const float* const* w, float* y,
                         float* work, long long* clk, int B, int T, int D,
                         int K, int P, const int* dils, int twin, int mode,
                         int clk_on, void* stream) {
  Args a;
  fill_args(a, x, w, y, work, B, T, D, K, P, dils, mode);
  int g[2];
  cudaError_t err = (cudaError_t)split_grid(0, twin, K, B, T, g);
  if (err != cudaSuccess) return err;
  const void* kern = fwd_kern(twin != 0, clk_on != 0);
  const size_t smem = smem_of(false, twin != 0, K, clk_on != 0);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* params[] = {&a, &clk};
  err = cudaLaunchCooperativeKernel(kern, dim3(g[0]), dim3(NT), params, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The first design's backward: the memset of the partial slots, the
// cooperative walk and the sum of the slots (stages: bit 0 the memset and
// the walk, bit 1 the memset and the sum, so that the memset and sum can be
// timed alone).
extern "C" int split_bwd(const float* x, const float* dy,
                         const float* const* w, float* dx, float* grads,
                         float* work, long long* clk, int B, int T, int D,
                         int K, int P, const int* dils, int twin, int mode,
                         int clk_on, int stages, void* stream) {
  int g[2];
  cudaError_t err = (cudaError_t)split_grid(1, twin, K, B, T, g);
  if (err != cudaSuccess) return err;
  const int grid = g[0];
  BArgs b;
  fill_args(b.f, x, w, nullptr, work, B, T, D, K, P, dils, mode);
  const long long ntile = b.f.ntile;
  const long long btc = (long long)B * T * C, btd = (long long)B * T * D;
  const long long st = (long long)B * ntile * 3 * C * 2;
  float* p = work + fwd_work(B, T);
  b.dy = dy;
  b.dx = dx;
  b.xs = p; p += (P - 1) * btd;
  b.hs = p; p += P * btc;
  b.cls = p; p += P * btc;
  b.crs = p; p += P * btc;
  b.st = p; p += P * st;
  b.dno = p; p += btc;
  b.dcb = p; p += 2 * btc;
  b.dnb = p; p += 2 * btc;
  b.sums1 = p; p += (long long)B * ntile * C * 2;
  b.sums2 = p; p += (long long)B * ntile * C * 2 * 2;
  b.part = p;
  b.np = grad_floats(D, K, P);
  b.o_wl = (long long)P * D * C;
  b.o_wr = b.o_wl + (long long)P * K * C * C;
  b.o_wo = b.o_wr + (long long)P * K * C * C;
  b.o_al = b.o_wo + (long long)P * C * D;
  b.o_ga = b.o_al + 3LL * P * C;
  b.o_be = b.o_ga + 3LL * P * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(b.part, 0, sizeof(float) * grid * b.np, s);
  if (err != cudaSuccess) return err;
  if (stages & 1) {
    const size_t smem = smem_of(true, twin != 0, K, clk_on != 0);
    const void* kern = bwd_kern(twin != 0, clk_on != 0);
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    void* params[] = {&b, &clk};
    err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(NT), params, smem, s);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    split_sum_kernel<<<(unsigned)((b.np + 255) / 256), 256, 0, s>>>(
        b.part, grads, b.np, grid);
  }
  return cudaGetLastError();
}
