// The LSTM-BF forward of the first design (eabnet_tpu_torch/csrc/lstm_bf.cu
// as it stood before the wavefront design), with clock64() counters: the
// measurement that the redesign started from. Built on its own by
// lstm_fwd_split.py (nvcc -shared) and called through ctypes; not part of
// the kernel library.
//
// One block of 256 threads (one per gate column) owns LB lanes; a step is
// four phases (layer-1 product, layer-1 cell, layer-2 product, layer-2
// cell and store), each followed by __syncthreads. Lane 0 of every warp
// adds the clocks of each phase's work and of each barrier wait to
// clk[block][warp][8]. MODE knocks parts of the products out, to separate
// their costs (the outputs are then wrong):
//   0: in full;  1: no weight loads (a register stands in for them);
//   2: no h loads (one float4 per lane and step stands in);  3: neither.

#include <cuda_runtime.h>

namespace {

constexpr int H = 64;
constexpr int G = 4 * H;

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int LB, int MODE, bool CLK>
__global__ void __launch_bounds__(G)
split_fwd_kernel(const float* __restrict__ xw1, const float* __restrict__ w_hh1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 float* __restrict__ h2_out, long long* __restrict__ clk,
                 long long* __restrict__ cal, int T, int L) {
  extern __shared__ float4 smem4[];
  float* s_w1 = reinterpret_cast<float*>(smem4);
  float* s_w2 = s_w1 + H * G;
  float* s_h1 = s_w2 + 2 * H * G;
  float* s_h2 = s_h1 + LB * H;
  float* s_g = s_h2 + LB * H;

  const int j = threadIdx.x;
  const int lane0 = blockIdx.x * LB;
  for (int i = j; i < H * G; i += G) s_w1[i] = w_hh1[i];
  for (int i = j; i < 2 * H * G; i += G) s_w2[i] = w2[i];
  for (int i = j; i < LB * H; i += G) {
    s_h1[i] = 0.0f;
    s_h2[i] = 0.0f;
  }
  const float bj = b2[j];
  constexpr int PAIRS = (LB * H + G - 1) / G;
  float c1[PAIRS], c2[PAIRS];
#pragma unroll
  for (int r = 0; r < PAIRS; ++r) c1[r] = c2[r] = 0.0f;
  float xcur[LB];
#pragma unroll
  for (int l = 0; l < LB; ++l) {
    const int lane = lane0 + l;
    xcur[l] = lane < L ? xw1[static_cast<size_t>(lane) * G + j] : 0.0f;
  }
  __syncthreads();
  const float wreg = s_w1[j];  // MODE 1, 3: stands in for every weight

  long long acc_clk[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  long long t_prev = clock64();
  auto mark = [&](int seg) {
    if (CLK) {
      const long long now = clock64();
      acc_clk[seg] += now - t_prev;
      t_prev = now;
    }
  };
  long long c0 = 0, g0 = 0;
  if (CLK && blockIdx.x == 0 && j == 0) {
    c0 = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  }

  auto product = [&](const float* s_h, const float* w, float* acc) {
    float4 hreg[LB];
    if (MODE >= 2) {
#pragma unroll
      for (int l = 0; l < LB; ++l)
        hreg[l] = *reinterpret_cast<const float4*>(&s_h[l * H]);
    }
    for (int k = 0; k < H; k += 4) {
      float wa, wb, wc, wd;
      if (MODE == 1 || MODE == 3) {
        wa = wb = wc = wd = wreg;
      } else {
        wa = w[(k + 0) * G + j];
        wb = w[(k + 1) * G + j];
        wc = w[(k + 2) * G + j];
        wd = w[(k + 3) * G + j];
      }
#pragma unroll
      for (int l = 0; l < LB; ++l) {
        const float4 h = MODE >= 2
            ? hreg[l] : *reinterpret_cast<const float4*>(&s_h[l * H + k]);
        acc[l] += h.x * wa;
        acc[l] += h.y * wb;
        acc[l] += h.z * wc;
        acc[l] += h.w * wd;
      }
    }
  };
  auto cell = [&](float* c, float* s_h, bool out, int t) {
#pragma unroll
    for (int r = 0; r < PAIRS; ++r) {
      const int q = j + r * G;
      if (q < LB * H) {
        const int l = q / H, u = q % H;
        const float* g = s_g + l * G;
        const float cn = sigm(g[H + u]) * c[r] + sigm(g[u]) * tanhf(g[2 * H + u]);
        c[r] = cn;
        const float h = sigm(g[3 * H + u]) * tanhf(cn);
        s_h[l * H + u] = h;
        const int lane = lane0 + l;
        if (out && lane < L)
          h2_out[(static_cast<size_t>(t) * L + lane) * H + u] = h;
      }
    }
  };

  for (int t = 0; t < T; ++t) {
    float acc[LB];
#pragma unroll
    for (int l = 0; l < LB; ++l) acc[l] = xcur[l];
    product(s_h1, s_w1, acc);
#pragma unroll
    for (int l = 0; l < LB; ++l) s_g[l * G + j] = acc[l];
    if (t + 1 < T) {
#pragma unroll
      for (int l = 0; l < LB; ++l) {
        const int lane = lane0 + l;
        xcur[l] = lane < L
            ? xw1[(static_cast<size_t>(t + 1) * L + lane) * G + j] : 0.0f;
      }
    }
    mark(0);
    __syncthreads();
    mark(1);
    cell(c1, s_h1, false, t);
    mark(2);
    __syncthreads();
    mark(3);
#pragma unroll
    for (int l = 0; l < LB; ++l) acc[l] = bj;
    product(s_h1, s_w2, acc);
    product(s_h2, s_w2 + H * G, acc);
#pragma unroll
    for (int l = 0; l < LB; ++l) s_g[l * G + j] = acc[l];
    mark(4);
    __syncthreads();
    mark(5);
    cell(c2, s_h2, true, t);
    mark(6);
    __syncthreads();
    mark(7);
  }
  if (CLK) {
    if ((j & 31) == 0) {
      long long* o = clk + (static_cast<size_t>(blockIdx.x) * (G / 32) + j / 32) * 8;
#pragma unroll
      for (int s = 0; s < 8; ++s) o[s] = acc_clk[s];
    }
    if (blockIdx.x == 0 && j == 0) {
      long long g1;
      const long long c1v = clock64();
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
      cal[0] = c1v - c0;
      cal[1] = g1 - g0;
    }
  }
}

template <int LB, int MODE, bool CLK>
int launch(const float* xw1, const float* w1, const float* w2, const float* b2,
           float* h2, long long* clk, long long* cal, int T, int L,
           cudaStream_t s) {
  const size_t smem = sizeof(float) * (3 * H * G + LB * (2 * H + G));
  cudaError_t err = cudaFuncSetAttribute(
      split_fwd_kernel<LB, MODE, CLK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  split_fwd_kernel<LB, MODE, CLK><<<(L + LB - 1) / LB, G, smem, s>>>(
      xw1, w1, w2, b2, h2, clk, cal, T, L);
  return cudaGetLastError();
}

template <int LB>
int dispatch_mode(int mode, bool clk_on, const float* xw1, const float* w1,
                  const float* w2, const float* b2, float* h2, long long* clk,
                  long long* cal, int T, int L, cudaStream_t s) {
  if (!clk_on) return launch<LB, 0, false>(xw1, w1, w2, b2, h2, clk, cal, T, L, s);
  switch (mode) {
    case 0: return launch<LB, 0, true>(xw1, w1, w2, b2, h2, clk, cal, T, L, s);
    case 1: return launch<LB, 1, true>(xw1, w1, w2, b2, h2, clk, cal, T, L, s);
    case 2: return launch<LB, 2, true>(xw1, w1, w2, b2, h2, clk, cal, T, L, s);
    default: return launch<LB, 3, true>(xw1, w1, w2, b2, h2, clk, cal, T, L, s);
  }
}

}  // namespace

// lb in {2, 9, 10, 16, 20}; clk has (L / lb blocks) x 8 warps x 8 entries,
// cal 2 (block 0's clocks and nanoseconds over the loop). Returns a
// cudaError_t.
extern "C" int split_fwd(const float* xw1, const float* w1, const float* w2,
                         const float* b2, float* h2, long long* clk,
                         long long* cal, int T, int L, int lb, int mode,
                         int clk_on, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lb) {
    case 2: return dispatch_mode<2>(mode, clk_on, xw1, w1, w2, b2, h2, clk, cal, T, L, s);
    case 9: return dispatch_mode<9>(mode, clk_on, xw1, w1, w2, b2, h2, clk, cal, T, L, s);
    case 10: return dispatch_mode<10>(mode, clk_on, xw1, w1, w2, b2, h2, clk, cal, T, L, s);
    case 16: return dispatch_mode<16>(mode, clk_on, xw1, w1, w2, b2, h2, clk, cal, T, L, s);
    case 20: return dispatch_mode<20>(mode, clk_on, xw1, w1, w2, b2, h2, clk, cal, T, L, s);
    default: return cudaErrorInvalidValue;
  }
}
