// Forward of a whole squeezed-TCN group (a chain of p TCMs), for Hopper.
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
__device__ void merge_stats(const Args& a, int b, int s, int c, float* mean_out,
                            float* inv_out) {
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int i = 0; i < a.ntile; ++i) {
    const float ni = static_cast<float>(tile_rows(a, i));
    const float* st = a.stats + ((((size_t)b * a.ntile + i) * 3 + s) * C + c) * 2;
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
__device__ void tile_stats(const Args& a, const float* s_v, int b, int tile,
                           int s, int c) {
  const int rows = tile_rows(a, tile);
  float sum = 0.0f;
  for (int r = 0; r < rows; ++r) sum += s_v[r * C + c];
  const float mean = sum / static_cast<float>(rows);
  float m2 = 0.0f;
  for (int r = 0; r < rows; ++r) {
    const float d = s_v[r * C + c] - mean;
    m2 += d * d;
  }
  float* st = a.stats + ((((size_t)b * a.ntile + tile) * 3 + s) * C + c) * 2;
  st[0] = mean;
  st[1] = m2;
}

__device__ void stage(float* dst, const float* src, int n, int tid) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = tid; i < n / 4; i += NT) d4[i] = s4[i];
}

template <bool TWIN>
__global__ void __launch_bounds__(NT) tcm_chain_fwd_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int c = tid & (C - 1);   // output channel of the C-wide products
  const int rg = tid / C;        // row group: rows 4 rg .. 4 rg + 3
  const int D = a.D, T = a.T, K = a.K;
  const int n_tiles = a.B * a.ntile;
  constexpr int NB = TWIN ? 2 : 1;

  for (int j = 0; j < a.P; ++j) {
    const float* xin = j == 0 ? a.x : a.y;
    // ------------------------------------------------ phase A
    {
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
        if (tid < NB * C) tile_stats(a, s_p + (tid / C) * TT * C, b, it, tid / C, c);
      }
    }
    grid.sync();
    // ------------------------------------------------ phase B
    {
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
        if (tid < NB * C) merge_stats(a, b, tid / C, c, &s_mean[tid], &s_inv[tid]);
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
          if (row < rows) a.pobuf[((size_t)b * T + t0 + row) * C + c] = v;
        }
        __syncthreads();
        if (tid < C) tile_stats(a, s_po, b, it, 2, c);
      }
    }
    grid.sync();
    // ------------------------------------------------ phase C
    {
      float* s_w = sm;                // [C][D]
      float* s_no = s_w + C * MAXD;   // [TT][C]
      float* s_mean = s_no + TT * C;  // [C]
      float* s_inv = s_mean + C;      // [C]
      stage(s_w, a.wo + (size_t)j * C * D, C * D, tid);
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int b = tile / a.ntile, it = tile % a.ntile, t0 = it * TT;
        const int rows = tile_rows(a, it);
        __syncthreads();
        if (tid < C) merge_stats(a, b, 2, c, &s_mean[c], &s_inv[c]);
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
            a.y[o] = xin[o] + acc[r];
          }
        }
      }
    }
    __syncthreads();
  }
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

template <bool TWIN>
cudaError_t launch(Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(TWIN, a.K);
  auto kern = tcm_chain_fwd_kernel<TWIN>;
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
  const int n_tiles = a.B * a.ntile;
  const int grid = n_tiles < per_sm * n_sm ? n_tiles : per_sm * n_sm;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(grid),
                                    dim3(NT), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the wrapper allocates for one launch.
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
  if (B < 1 || T < 1 || D < 4 || D > MAXD || D % 4 || K < 1 || K > MAXK ||
      P < 1 || P > MAXP)
    return cudaErrorInvalidValue;
  Args a;
  a.x = x; a.wi = wi; a.wl = wl; a.wr = wr; a.wo = wo;
  a.al = al; a.ga = ga; a.be = be; a.y = y;
  a.pbuf = work;
  a.pobuf = work + 2LL * B * T * C;
  a.stats = work + 3LL * B * T * C;
  a.B = B; a.T = T; a.D = D; a.K = K; a.P = P;
  a.ntile = (T + TT - 1) / TT;
  for (int j = 0; j < MAXP; ++j) a.dil[j] = j < P ? dils[j] : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return twin ? launch<true>(a, s) : launch<false>(a, s);
}
