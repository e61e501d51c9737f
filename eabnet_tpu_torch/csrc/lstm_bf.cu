// Forward of the LSTM beamforming head's double recurrence, for Hopper.
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

template <int LB>
__global__ void __launch_bounds__(G)
lstm_bf_fwd_kernel(const float* __restrict__ xw1,
                   const float* __restrict__ w_hh1,
                   const float* __restrict__ w2,
                   const float* __restrict__ b2,
                   float* __restrict__ h2_out, int T, int L) {
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
        s_h1[l * H + u] = sigm(g[3 * H + u]) * tanhf(c);
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
        if (lane < L) h2_out[(static_cast<size_t>(t) * L + lane) * H + u] = h;
      }
    }
    __syncthreads();
  }
}

template <int LB>
cudaError_t launch(const float* xw1, const float* w_hh1, const float* w2,
                   const float* b2, float* h2, int T, int L,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * H * G + LB * (2 * H + G));
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bf_fwd_kernel<LB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (L + LB - 1) / LB;
  lstm_bf_fwd_kernel<LB><<<grid, G, smem, stream>>>(xw1, w_hh1, w2, b2, h2,
                                                      T, L);
  return cudaGetLastError();
}

}  // namespace

// xw1 (T, L, 256), w_hh1 (64, 256), w2 (128, 256), b2 (256,) -> h2 (T, L, 64),
// all float32, contiguous, on the current device. Returns a cudaError_t.
extern "C" int eabnet_lstm_bf_fwd(const float* xw1, const float* w_hh1,
                                  const float* w2, const float* b2, float* h2,
                                  int T, int L, void* stream) {
  if (T < 1 || L < 1) return cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int need = (L + n_sm - 1) / n_sm;  // lanes per block for one wave
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need <= 1) return launch<1>(xw1, w_hh1, w2, b2, h2, T, L, s);
  if (need <= 2) return launch<2>(xw1, w_hh1, w2, b2, h2, T, L, s);
  if (need <= 4) return launch<4>(xw1, w_hh1, w2, b2, h2, T, L, s);
  if (need <= 8) return launch<8>(xw1, w_hh1, w2, b2, h2, T, L, s);
  return launch<16>(xw1, w_hh1, w2, b2, h2, T, L, s);
}

extern "C" const char* eabnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
