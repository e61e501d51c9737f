// Forward and backward of the LSTM beamforming head's double recurrence,
// for Hopper. The backward is described where it starts, below.
//
// Replaces the TPU kernel eabnet_tpu/kernels/lstm_bf.py::_fwd_kernel: two
// stacked LSTMs (H = 64, gate order i, f, g, o) over T steps for L
// independent lanes (one per batch item and frequency bin). The layer-1
// input projection arrives hoisted as xw1 (T, L, 4H) = x @ W_ih1 + b_ih1 +
// b_hh1; each step computes
//   gates1 = xw1[t] + h1 @ W_hh1
//   gates2 = [h1, h2] @ [W_ih2; W_hh2] + b2
// and the kernel writes the layer-2 hidden sequence h2 (T, L, H).
//
// What bounds it: 701 dependent steps of two dependent small products.
// Per lane-step the work is 48K multiply-adds on 96 floats of stream, so
// the card's arithmetic rate, not its memory, is the roofline; but at
// B = 1 there are only 161 lanes, and the chain of T x 2 dependent
// matrix-vector products sets a latency floor that no roofline shows.
//
// Design: one block of 256 threads (one per gate column) owns LB lanes
// for the whole sequence. Both weight matrices (64 KB + 128 KB f32) live in
// shared memory for the block's lifetime; h1/h2 of its lanes live in
// shared memory, c1/c2 in the registers of the threads that update them.
// A step is four phases separated by __syncthreads: layer-1 gate products
// (each thread reads its weight column once and reuses it over the LB
// lanes), layer-1 cell update, layer-2 gate products, layer-2 cell update
// and output store. The next step's xw1 is loaded during layer 2. LB is
// the smallest power of two that keeps the grid within one wave of SMs,
// so small batches still spread over many SMs. Lanes past L are masked.
// State, sums and activations are f32, with precise expf/tanhf.

#include <cuda_runtime.h>

namespace {

constexpr int H = 64;
constexpr int G = 4 * H;  // gate columns: one thread each

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int LB, bool RES>
__global__ void __launch_bounds__(G)
lstm_bf_fwd_kernel(const float* __restrict__ xw1,
                   const float* __restrict__ w_hh1,
                   const float* __restrict__ w2,
                   const float* __restrict__ b2,
                   float* __restrict__ h1_out, float* __restrict__ c1_out,
                   float* __restrict__ h2_out, float* __restrict__ c2_out,
                   int T, int L) {
  extern __shared__ float4 smem4[];
  float* s_w1 = reinterpret_cast<float*>(smem4);  // [H][G]
  float* s_w2 = s_w1 + H * G;                     // [2H][G]
  float* s_h1 = s_w2 + 2 * H * G;                 // [LB][H]
  float* s_h2 = s_h1 + LB * H;                    // [LB][H]
  float* s_g = s_h2 + LB * H;                     // [LB][G]

  const int j = threadIdx.x;
  const int lane0 = blockIdx.x * LB;
  for (int i = j; i < H * G; i += G) s_w1[i] = w_hh1[i];
  for (int i = j; i < 2 * H * G; i += G) s_w2[i] = w2[i];
  for (int i = j; i < LB * H; i += G) {
    s_h1[i] = 0.0f;
    s_h2[i] = 0.0f;
  }
  const float bj = b2[j];

  // cell-update ownership: pair index q = j + r * G -> (lane q / H, unit q % H)
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

  for (int t = 0; t < T; ++t) {
    float acc[LB];
    // ---- layer-1 gates: xw1[t] + h1 @ W_hh1
#pragma unroll
    for (int l = 0; l < LB; ++l) acc[l] = xcur[l];
    for (int k = 0; k < H; k += 4) {
      const float wa = s_w1[(k + 0) * G + j], wb = s_w1[(k + 1) * G + j];
      const float wc = s_w1[(k + 2) * G + j], wd = s_w1[(k + 3) * G + j];
#pragma unroll
      for (int l = 0; l < LB; ++l) {
        const float4 h = *reinterpret_cast<const float4*>(&s_h1[l * H + k]);
        acc[l] += h.x * wa;
        acc[l] += h.y * wb;
        acc[l] += h.z * wc;
        acc[l] += h.w * wd;
      }
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) s_g[l * G + j] = acc[l];
    if (t + 1 < T) {  // prefetch the next step's projected input
#pragma unroll
      for (int l = 0; l < LB; ++l) {
        const int lane = lane0 + l;
        xcur[l] = lane < L
            ? xw1[(static_cast<size_t>(t + 1) * L + lane) * G + j] : 0.0f;
      }
    }
    __syncthreads();
    // ---- layer-1 cell
#pragma unroll
    for (int r = 0; r < PAIRS; ++r) {
      const int q = j + r * G;
      if (q < LB * H) {
        const int l = q / H, u = q % H;
        const float* g = s_g + l * G;
        const float c = sigm(g[H + u]) * c1[r] + sigm(g[u]) * tanhf(g[2 * H + u]);
        c1[r] = c;
        const float h = sigm(g[3 * H + u]) * tanhf(c);
        s_h1[l * H + u] = h;
        const int lane = lane0 + l;
        if (RES && lane < L) {
          const size_t o = (static_cast<size_t>(t) * L + lane) * H + u;
          h1_out[o] = h;
          c1_out[o] = c;
        }
      }
    }
    __syncthreads();
    // ---- layer-2 gates: [h1, h2] @ [W_ih2; W_hh2] + b2
#pragma unroll
    for (int l = 0; l < LB; ++l) acc[l] = bj;
    for (int half = 0; half < 2; ++half) {
      const float* s_h = half ? s_h2 : s_h1;
      const float* w = s_w2 + half * H * G;
      for (int k = 0; k < H; k += 4) {
        const float wa = w[(k + 0) * G + j], wb = w[(k + 1) * G + j];
        const float wc = w[(k + 2) * G + j], wd = w[(k + 3) * G + j];
#pragma unroll
        for (int l = 0; l < LB; ++l) {
          const float4 h = *reinterpret_cast<const float4*>(&s_h[l * H + k]);
          acc[l] += h.x * wa;
          acc[l] += h.y * wb;
          acc[l] += h.z * wc;
          acc[l] += h.w * wd;
        }
      }
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) s_g[l * G + j] = acc[l];
    __syncthreads();
    // ---- layer-2 cell and output
#pragma unroll
    for (int r = 0; r < PAIRS; ++r) {
      const int q = j + r * G;
      if (q < LB * H) {
        const int l = q / H, u = q % H;
        const float* g = s_g + l * G;
        const float c = sigm(g[H + u]) * c2[r] + sigm(g[u]) * tanhf(g[2 * H + u]);
        c2[r] = c;
        const float h = sigm(g[3 * H + u]) * tanhf(c);
        s_h2[l * H + u] = h;
        const int lane = lane0 + l;
        if (lane < L) {
          const size_t o = (static_cast<size_t>(t) * L + lane) * H + u;
          h2_out[o] = h;
          if (RES) c2_out[o] = c;
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- backward
//
// Replaces eabnet_tpu/kernels/lstm_bf.py::_bwd_kernel. One block of 256
// threads owns LB lanes and walks t = T-1 .. 0, carrying (dh1, dc1, dh2,
// dc2) per lane. Per step, from the saved states at t and t-1 (zero before
// t = 0) it recomputes gates2 = h1[t] @ W_ih2 + h2[t-1] @ W_hh2 + b2, takes
// the layer-2 cell backward, forms dh2' = dgates2 @ W_hh2^T and the layer-1
// cotangent dh1 + dgates2 @ W_ih2^T, recomputes gates1 = xw1[t] + h1[t-1] @
// W_hh1, takes the layer-1 cell backward and forms dh1' = dgates1 @ W_hh1^T.
// It writes dgates1 (= d xw1) and dgates2 to global memory.
//
// The three weight matrices take 192 KB of shared memory, so the weight-
// gradient sums (3 x 64 x 256 f32) fit neither there nor in registers: a
// second kernel reduces sum_{t,l} h^T dgates over all T*L rows into per-
// block partials, and a third sums the partials in a fixed order, so the
// result does not change from run to run (no atomics).
//
// Products with W^T read W[u][j] for 32 different u in one warp; the index
// j is rotated by u, (j0 + u) mod 256, so those reads fall in 32 different
// banks while the forward-direction products keep the forward's layout.
//
// What bounds it: per lane-step 3 x 16K multiply-adds to recompute the
// gates, 3 x 16K for the cotangent products and 3 x 16K for the weight
// gradients, ~295 KFLOP, on 3.3 KB of stream (xw1, dy, four states in,
// d xw1 out): the f32 rate, ~3 ms at T = 601, L = 1,127. As in the
// forward, T dependent steps set a latency floor besides.

template <int LB>
__global__ void __launch_bounds__(G)
lstm_bf_bwd_kernel(const float* __restrict__ xw1, const float* __restrict__ dy,
                   const float* __restrict__ h1s, const float* __restrict__ c1s,
                   const float* __restrict__ h2s, const float* __restrict__ c2s,
                   const float* __restrict__ w_hh1,
                   const float* __restrict__ w_ih2,
                   const float* __restrict__ w_hh2,
                   const float* __restrict__ b2,
                   float* __restrict__ dxw1, float* __restrict__ dg2_out,
                   int T, int L) {
  extern __shared__ float4 smem4[];
  float* s_w1 = reinterpret_cast<float*>(smem4);  // W_hh1 [H][G]
  float* s_wi2 = s_w1 + H * G;                    // W_ih2 [H][G]
  float* s_wh2 = s_wi2 + H * G;                   // W_hh2 [H][G]
  float* s_ha = s_wh2 + H * G;                    // [LB][2H] h1[t] | h2[t-1], then h1[t-1]
  float* s_dh1 = s_ha + LB * 2 * H;               // [LB][H] carried dh1
  float* s_dh2 = s_dh1 + LB * H;                  // [LB][H] carried dh2
  float* s_g = s_dh2 + LB * H;                    // [LB][G] gates, then dgates

  const int j = threadIdx.x;
  const int lane0 = blockIdx.x * LB;
  for (int i = j; i < H * G; i += G) {
    s_w1[i] = w_hh1[i];
    s_wi2[i] = w_ih2[i];
    s_wh2[i] = w_hh2[i];
  }
  for (int i = j; i < LB * H; i += G) s_dh1[i] = s_dh2[i] = 0.0f;
  const float bj = b2[j];

  constexpr int PAIRS = (LB * H + G - 1) / G;
  float dc1[PAIRS], dc2[PAIRS];
#pragma unroll
  for (int r = 0; r < PAIRS; ++r) dc1[r] = dc2[r] = 0.0f;
  // transposed products: thread -> (unit tu, lanes tl0, tl0 + 4, ...)
  const int tu = j % H, tl0 = j / H;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const size_t row_t = static_cast<size_t>(t) * L;
    const size_t row_p = static_cast<size_t>(t - 1) * L;  // unused at t = 0
    // ---- h1[t], h2[t-1] of the block's lanes
    for (int i = j; i < LB * 2 * H; i += G) {
      const int l = i / (2 * H), k = i % (2 * H), lane = lane0 + l;
      float v = 0.0f;
      if (lane < L) {
        if (k < H) v = h1s[(row_t + lane) * H + k];
        else if (t > 0) v = h2s[(row_p + lane) * H + k - H];
      }
      s_ha[i] = v;
    }
    __syncthreads();
    // ---- gates2 = [h1[t], h2[t-1]] @ [W_ih2; W_hh2] + b2
    {
      float acc[LB];
#pragma unroll
      for (int l = 0; l < LB; ++l) acc[l] = bj;
      for (int half = 0; half < 2; ++half) {
        const float* w = half ? s_wh2 : s_wi2;
        for (int k = 0; k < H; k += 4) {
          const float wa = w[(k + 0) * G + j], wb = w[(k + 1) * G + j];
          const float wc = w[(k + 2) * G + j], wd = w[(k + 3) * G + j];
#pragma unroll
          for (int l = 0; l < LB; ++l) {
            const float4 h = *reinterpret_cast<const float4*>(
                &s_ha[l * 2 * H + half * H + k]);
            acc[l] += h.x * wa;
            acc[l] += h.y * wb;
            acc[l] += h.z * wc;
            acc[l] += h.w * wd;
          }
        }
      }
#pragma unroll
      for (int l = 0; l < LB; ++l) s_g[l * G + j] = acc[l];
    }
    __syncthreads();
    // ---- layer-2 cell backward (dgates2 in place of gates2)
#pragma unroll
    for (int r = 0; r < PAIRS; ++r) {
      const int q = j + r * G;
      if (q < LB * H) {
        const int l = q / H, u = q % H, lane = lane0 + l;
        float* g = s_g + l * G;
        float dh = s_dh2[q], c_t = 0.0f, c_p = 0.0f;
        if (lane < L) {
          dh += dy[(row_t + lane) * H + u];
          c_t = c2s[(row_t + lane) * H + u];
          if (t > 0) c_p = c2s[(row_p + lane) * H + u];
        }
        const float si = sigm(g[u]), sf = sigm(g[H + u]);
        const float sg = tanhf(g[2 * H + u]), so = sigm(g[3 * H + u]);
        const float tc = tanhf(c_t);
        const float dct = dc2[r] + dh * so * (1.0f - tc * tc);
        g[3 * H + u] = dh * tc * so * (1.0f - so);
        g[H + u] = dct * c_p * sf * (1.0f - sf);
        g[u] = dct * sg * si * (1.0f - si);
        g[2 * H + u] = dct * si * (1.0f - sg * sg);
        dc2[r] = dct * sf;
      }
    }
    __syncthreads();
    // ---- dh2' = dgates2 @ W_hh2^T; dh1 += dgates2 @ W_ih2^T; store dgates2
    for (int l = tl0; l < LB; l += G / H) {
      const float* dg = s_g + l * G;
      float a2 = 0.0f, a1 = 0.0f;
      for (int j0 = 0; j0 < G; ++j0) {
        const int jj = (j0 + tu) & (G - 1);
        const float d = dg[jj];
        a2 += d * s_wh2[tu * G + jj];
        a1 += d * s_wi2[tu * G + jj];
      }
      s_dh2[l * H + tu] = a2;
      s_dh1[l * H + tu] += a1;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int lane = lane0 + l;
      if (lane < L) dg2_out[(row_t + lane) * G + j] = s_g[l * G + j];
    }
    // ---- h1[t-1] for gates1 (the buffer's h1[t] half is free now)
    for (int i = j; i < LB * H; i += G) {
      const int l = i / H, k = i % H, lane = lane0 + l;
      s_ha[l * 2 * H + H + k] =
          (lane < L && t > 0) ? h1s[(row_p + lane) * H + k] : 0.0f;
    }
    __syncthreads();
    // ---- gates1 = xw1[t] + h1[t-1] @ W_hh1
    {
      float acc[LB];
#pragma unroll
      for (int l = 0; l < LB; ++l) {
        const int lane = lane0 + l;
        acc[l] = lane < L ? xw1[(row_t + lane) * G + j] : 0.0f;
      }
      for (int k = 0; k < H; k += 4) {
        const float wa = s_w1[(k + 0) * G + j], wb = s_w1[(k + 1) * G + j];
        const float wc = s_w1[(k + 2) * G + j], wd = s_w1[(k + 3) * G + j];
#pragma unroll
        for (int l = 0; l < LB; ++l) {
          const float4 h = *reinterpret_cast<const float4*>(
              &s_ha[l * 2 * H + H + k]);
          acc[l] += h.x * wa;
          acc[l] += h.y * wb;
          acc[l] += h.z * wc;
          acc[l] += h.w * wd;
        }
      }
#pragma unroll
      for (int l = 0; l < LB; ++l) s_g[l * G + j] = acc[l];
    }
    __syncthreads();
    // ---- layer-1 cell backward (dgates1 in place of gates1)
#pragma unroll
    for (int r = 0; r < PAIRS; ++r) {
      const int q = j + r * G;
      if (q < LB * H) {
        const int l = q / H, u = q % H, lane = lane0 + l;
        float* g = s_g + l * G;
        const float dh = s_dh1[q];
        float c_t = 0.0f, c_p = 0.0f;
        if (lane < L) {
          c_t = c1s[(row_t + lane) * H + u];
          if (t > 0) c_p = c1s[(row_p + lane) * H + u];
        }
        const float si = sigm(g[u]), sf = sigm(g[H + u]);
        const float sg = tanhf(g[2 * H + u]), so = sigm(g[3 * H + u]);
        const float tc = tanhf(c_t);
        const float dct = dc1[r] + dh * so * (1.0f - tc * tc);
        g[3 * H + u] = dh * tc * so * (1.0f - so);
        g[H + u] = dct * c_p * sf * (1.0f - sf);
        g[u] = dct * sg * si * (1.0f - si);
        g[2 * H + u] = dct * si * (1.0f - sg * sg);
        dc1[r] = dct * sf;
      }
    }
    __syncthreads();
    // ---- dh1' = dgates1 @ W_hh1^T; store dgates1 = d xw1[t]
    for (int l = tl0; l < LB; l += G / H) {
      const float* dg = s_g + l * G;
      float a1 = 0.0f;
      for (int j0 = 0; j0 < G; ++j0) {
        const int jj = (j0 + tu) & (G - 1);
        a1 += dg[jj] * s_w1[tu * G + jj];
      }
      s_dh1[l * H + tu] = a1;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int lane = lane0 + l;
      if (lane < L) dxw1[(row_t + lane) * G + j] = s_g[l * G + j];
    }
    __syncthreads();
  }
}

// Weight-gradient partials. blockIdx.y picks the product:
//   0: dW_hh1 = sum h1[t-1]^T dgates1    1: dW_ih2 = sum h1[t]^T dgates2
//   2: dW_hh2 = sum h2[t-1]^T dgates2    (1 also sums db2 = sum dgates2)
// over the rows n = t * L + lane of a contiguous chunk per block; h[t-1] is
// row n - L, zero for t = 0. Thread j owns column j of the (64, 256)
// partial, 64 sums in registers; RW rows of h are staged in shared memory.
constexpr int RW = 8;

__global__ void __launch_bounds__(G)
lstm_bf_wgrad_kernel(const float* __restrict__ h1s,
                     const float* __restrict__ h2s,
                     const float* __restrict__ dg1,
                     const float* __restrict__ dg2,
                     float* __restrict__ part, int T, int L) {
  __shared__ float4 s_a4[RW * H / 4];
  const float* s_a = reinterpret_cast<const float*>(s_a4);
  const int j = threadIdx.x, which = blockIdx.y, nblk = gridDim.x;
  const long long n_rows = static_cast<long long>(T) * L;
  const long long per = (n_rows + nblk - 1) / nblk;
  const long long n0 = per * blockIdx.x;
  const long long n1 = n0 + per < n_rows ? n0 + per : n_rows;
  const float* a = which == 2 ? h2s : h1s;
  const float* b = which == 0 ? dg1 : dg2;
  const long long shift = which == 1 ? 0 : L;
  float acc[H];
#pragma unroll
  for (int u = 0; u < H; ++u) acc[u] = 0.0f;
  float accb = 0.0f;
  for (long long n = n0; n < n1; n += RW) {
    __syncthreads();
    for (int i = j; i < RW * H; i += G) {
      const long long row = n + i / H, src = row - shift;
      reinterpret_cast<float*>(s_a4)[i] =
          (row < n1 && src >= 0) ? a[src * H + i % H] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float bv = n + r < n1 ? b[(n + r) * G + j] : 0.0f;
      accb += bv;
#pragma unroll
      for (int u = 0; u < H; u += 4) {
        const float4 av = *reinterpret_cast<const float4*>(&s_a[r * H + u]);
        acc[u + 0] += av.x * bv;
        acc[u + 1] += av.y * bv;
        acc[u + 2] += av.z * bv;
        acc[u + 3] += av.w * bv;
      }
    }
  }
  // part layout: [3][nblk][H * G], then db2 partials [nblk][G]
  float* out = part + (static_cast<size_t>(which) * nblk + blockIdx.x) * H * G;
#pragma unroll
  for (int u = 0; u < H; ++u) out[u * G + j] = acc[u];
  if (which == 1)
    part[static_cast<size_t>(3) * nblk * H * G + blockIdx.x * G + j] = accb;
}

// dw (3 * H * G + G) = the partials summed over blocks in block order.
__global__ void lstm_bf_wgrad_sum_kernel(const float* __restrict__ part,
                                         float* __restrict__ dw, int nblk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * H * G + G) return;
  float s = 0.0f;
  if (i < 3 * H * G) {
    const int which = i / (H * G), k = i % (H * G);
    for (int b = 0; b < nblk; ++b)
      s += part[(static_cast<size_t>(which) * nblk + b) * H * G + k];
  } else {
    for (int b = 0; b < nblk; ++b)
      s += part[static_cast<size_t>(3) * nblk * H * G + b * G + (i - 3 * H * G)];
  }
  dw[i] = s;
}

template <int LB, bool RES>
cudaError_t launch_fwd(const float* xw1, const float* w_hh1, const float* w2,
                       const float* b2, float* h1, float* c1, float* h2,
                       float* c2, int T, int L, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * H * G + LB * (2 * H + G));
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bf_fwd_kernel<LB, RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (L + LB - 1) / LB;
  lstm_bf_fwd_kernel<LB, RES><<<grid, G, smem, stream>>>(
      xw1, w_hh1, w2, b2, h1, c1, h2, c2, T, L);
  return cudaGetLastError();
}

template <int LB>
cudaError_t launch_bwd(const float* xw1, const float* dy, const float* h1,
                       const float* c1, const float* h2, const float* c2,
                       const float* w_hh1, const float* w_ih2,
                       const float* w_hh2, const float* b2, float* dxw1,
                       float* dg2, int T, int L, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * H * G + LB * (4 * H + G));
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bf_bwd_kernel<LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (L + LB - 1) / LB;
  lstm_bf_bwd_kernel<LB><<<grid, G, smem, stream>>>(
      xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2, dxw1, dg2, T, L);
  return cudaGetLastError();
}

// Lanes per block: the smallest power of two (at most 16) that keeps the
// grid within one wave of SMs.
cudaError_t lanes_per_block(int L, int* lb) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int need = (L + n_sm - 1) / n_sm;
  *lb = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : need <= 8 ? 8 : 16;
  return cudaSuccess;
}

int wgrad_blocks() {
  int dev = 0, n_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return n_sm;
}

}  // namespace

// xw1 (T, L, 256), w_hh1 (64, 256), w2 (128, 256), b2 (256,) -> h2 (T, L, 64),
// all float32, contiguous, on the current device. Returns a cudaError_t.
extern "C" int eabnet_lstm_bf_fwd(const float* xw1, const float* w_hh1,
                                  const float* w2, const float* b2, float* h2,
                                  int T, int L, void* stream) {
  if (T < 1 || L < 1) return cudaErrorInvalidValue;
  int lb = 0;
  cudaError_t err = lanes_per_block(L, &lb);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* no = nullptr;
  switch (lb) {
    case 1: return launch_fwd<1, false>(xw1, w_hh1, w2, b2, no, no, h2, no, T, L, s);
    case 2: return launch_fwd<2, false>(xw1, w_hh1, w2, b2, no, no, h2, no, T, L, s);
    case 4: return launch_fwd<4, false>(xw1, w_hh1, w2, b2, no, no, h2, no, T, L, s);
    case 8: return launch_fwd<8, false>(xw1, w_hh1, w2, b2, no, no, h2, no, T, L, s);
    default: return launch_fwd<16, false>(xw1, w_hh1, w2, b2, no, no, h2, no, T, L, s);
  }
}

// The training forward: as eabnet_lstm_bf_fwd, and also writes the
// residuals h1, c1, c2 (T, L, 64) that the backward reads.
extern "C" int eabnet_lstm_bf_fwd_train(const float* xw1, const float* w_hh1,
                                        const float* w2, const float* b2,
                                        float* h1, float* c1, float* h2,
                                        float* c2, int T, int L, void* stream) {
  if (T < 1 || L < 1) return cudaErrorInvalidValue;
  int lb = 0;
  cudaError_t err = lanes_per_block(L, &lb);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lb) {
    case 1: return launch_fwd<1, true>(xw1, w_hh1, w2, b2, h1, c1, h2, c2, T, L, s);
    case 2: return launch_fwd<2, true>(xw1, w_hh1, w2, b2, h1, c1, h2, c2, T, L, s);
    case 4: return launch_fwd<4, true>(xw1, w_hh1, w2, b2, h1, c1, h2, c2, T, L, s);
    case 8: return launch_fwd<8, true>(xw1, w_hh1, w2, b2, h1, c1, h2, c2, T, L, s);
    default: return launch_fwd<16, true>(xw1, w_hh1, w2, b2, h1, c1, h2, c2, T, L, s);
  }
}

// Floats of scratch the wrapper allocates for one backward launch:
// dgates2 (T, L, 256) and the weight-gradient partials.
extern "C" long long eabnet_lstm_bf_bwd_workspace(int T, int L) {
  const int nblk = wgrad_blocks();
  if (nblk < 1) return -1;
  return static_cast<long long>(T) * L * G +
         static_cast<long long>(nblk) * (3 * H * G + G);
}

// Backward: xw1 (T, L, 256), dy (T, L, 64) and the residuals h1, c1, h2, c2
// (T, L, 64); w_hh1, w_ih2, w_hh2 (64, 256), b2 (256,) -> dxw1 (T, L, 256)
// and dw = [dW_hh1, dW_ih2, dW_hh2 (64, 256) each, db2 (256)] contiguous.
// work holds eabnet_lstm_bf_bwd_workspace(T, L) floats. Three launches on
// one stream: the reverse-time walk, the weight-gradient partials, their
// sum. Returns a cudaError_t.
extern "C" int eabnet_lstm_bf_bwd(const float* xw1, const float* dy,
                                  const float* h1, const float* c1,
                                  const float* h2, const float* c2,
                                  const float* w_hh1, const float* w_ih2,
                                  const float* w_hh2, const float* b2,
                                  float* dxw1, float* dw, float* work, int T,
                                  int L, void* stream) {
  if (T < 1 || L < 1) return cudaErrorInvalidValue;
  int lb = 0;
  cudaError_t err = lanes_per_block(L, &lb);
  if (err != cudaSuccess) return err;
  const int nblk = wgrad_blocks();
  if (nblk < 1) return cudaErrorInvalidDevice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dg2 = work;
  float* part = work + static_cast<size_t>(T) * L * G;
  switch (lb) {
    case 1: err = launch_bwd<1>(xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2, dxw1, dg2, T, L, s); break;
    case 2: err = launch_bwd<2>(xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2, dxw1, dg2, T, L, s); break;
    case 4: err = launch_bwd<4>(xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2, dxw1, dg2, T, L, s); break;
    case 8: err = launch_bwd<8>(xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2, dxw1, dg2, T, L, s); break;
    default: err = launch_bwd<16>(xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2, dxw1, dg2, T, L, s); break;
  }
  if (err != cudaSuccess) return err;
  lstm_bf_wgrad_kernel<<<dim3(nblk, 3), G, 0, s>>>(h1, h2, dxw1, dg2, part, T, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = 3 * H * G + G;
  lstm_bf_wgrad_sum_kernel<<<(n_out + 255) / 256, 256, 0, s>>>(part, dw, nblk);
  return cudaGetLastError();
}

extern "C" const char* eabnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
