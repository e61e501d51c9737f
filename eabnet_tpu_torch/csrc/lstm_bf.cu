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
// and the kernel writes the layer-2 hidden sequence h2 (T, L, H) (the
// training variant also h1, c1 and c2).
//
// What bounds it: T dependent steps of small products. Per lane-step the
// work is 48K multiply-adds on 96 floats of stream, so no roofline binds:
// the time per step on the SM that owns the most lanes does. A block owns
// LB lanes on one SM; per lane and step each of its 256 threads runs
// 192 FFMA, 8 shared loads of 16 bytes, 6 shuffles and half an LSTM cell
// (five precise tanhf). The FFMA throughput, 384 clocks per lane-step on the
// SM's four schedulers, is the floor; the kernel runs at 35-44% of it
// (eabnet_tpu_torch/tools/lstm_fwd_split.py): with two warps per
// scheduler the products stall, and the cells (latency chains of tanhf)
// and the sums take the rest. At one or two lanes per block (one item:
// 161 lanes) nothing hides the chain of a step: products, then sums, then
// cell, then the barrier.
//
// Design. The layers run as a wavefront: pass s computes gates1[s] = xw1[s]
// + h1[s-1] W_hh1 and gates2[s-1] = h1[s-1] W_ih2 + h2[s-2] W_hh2 + b2 from
// one h1[s-1] | h2[s-2] tile, then the cells of h1[s] and h2[s-1]: T + 1
// passes, one block barrier each. Thread t = 4 u + kq holds, for unit u, the
// four gate columns (i, f, g, o) of W_hh1, W_ih2 and W_hh2 over a quarter kq
// of the 64 rows (192 floats) in registers for the whole sequence: no weight
// is read after the first pass, and each h value loaded feeds 8 FFMA (h1) or
// 4 (h2). Lanes go in pairs: the four threads of a unit sum their quarters
// over two lanes with shuffles, the partner across bit 1 of kq taking the
// other layer and the one across bit 0 the other lane, so each thread ends
// with the four gates of one (layer, lane) and takes that cell in registers:
// every thread has a cell per pair. A pair's cell comes after the next
// pair's products, with no branch between them, so its tanhf chains
// interleave with that pair's FFMA. xw1 arrives by cp.async into a double
// buffer a pass ahead; h1 and h2 live in a double buffer in shared memory
// (rows padded by 8 floats), the cell states in shared memory slots that one
// thread owns. LB = ceil(L / SMs) lanes per block (not rounded to a power of
// two; at most FWD_LB_MAX, by shared memory), so the grid fills the card in
// one wave up to 60 x 132 lanes; an odd LB leaves one lane of the last pair
// idle. Lanes past L are masked. State, sums and activations are float32
// with the precise tanhf; the sigmoid is 1/2 + tanh(x/2)/2, without a
// division. No tensor cores: float32's precision would take three TF32
// products each, with the weights re-read from shared memory and split every
// step (the backward's walk), and the FFMA rate, at under half its floor,
// is not what holds the step. No atomics: a second launch gives the same
// bits.
//
// bfloat16 serving (eabnet_lstm_bf_fwd_bf16) is the same kernel with the
// Pallas kernel's bf16 operands: xw1, the weights and b2 arrive in bf16,
// h2 leaves in bf16. The weights go to registers as float32 (a bf16 value
// is a float32 value, so the products are those of the bf16 operands, and
// their sums stay float32); h is rounded to bf16 where it is written to
// the h buffer, the only place it is read from as a product operand (in the
// Pallas kernel h enters the products and the output only through a cast
// to bf16); c and the gates stay float32. xw1 arrives by 16-byte cp.async,
// a lane's 256 gates in their own order, and the cell reads its four. Its
// work and time per step are the float32 kernel's: only the stream halves.
// bfloat16 training (eabnet_lstm_bf_fwd_train_bf16) also writes h1, c1 and
// c2 in bf16, as the Pallas kernel writes its four sequences in the
// primal dtype: the carried state stays float32, and the backward reads
// the rounded h and c.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int H = 64;
constexpr int G = 4 * H;  // gate columns

// The sigmoid as 1/2 + tanh(x/2)/2 with the precise tanhf: the same
// function as 1 / (1 + exp(-x)) to float32 rounding, without a division,
// whose slow path (a call) would cut the cell math into pieces that the
// scheduler cannot interleave with the products around it.
__device__ __forceinline__ float sigm_t(float x) {
  return fmaf(0.5f, tanhf(0.5f * x), 0.5f);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

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

constexpr int FWD_THREADS = 256;
constexpr int FWD_LB_MAX = 60;  // lanes per block that fit in shared memory
constexpr int HS = H + 8;       // h and cell-state row stride (floats)

// Shared memory of a forward block: per lane (LB rounded up to even
// lanes), the h1 | h2 double buffer (2 x 2 rows of HS), the xw1 double
// buffer (2 x G) and the cell states (2 rows of HS); and b2 (G).
constexpr int FWD_LANE_FLOATS = 4 * HS + 2 * G + 2 * HS;

size_t fwd_smem_bytes(int lb) {
  return sizeof(float) * (FWD_LANE_FLOATS * ((lb + 1) & ~1) + G);
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// h as the next products will read it: itself, or rounded to bf16
__device__ __forceinline__ float operand(float h, const float*) { return h; }
__device__ __forceinline__ float operand(float h, const bf16*) {
  return __bfloat162float(__float2bfloat16_rn(h));
}

// TIn is float (the float32 kernel) or bf16 (bf16 operands); TC the type
// of the saved cell states (the training variant's c1, c2), TIn's in the
// package
template <bool RES, typename TIn, typename TC>
__global__ void __launch_bounds__(FWD_THREADS, 1)
lstm_bf_fwd_kernel(const TIn* __restrict__ xw1,
                   const TIn* __restrict__ w_hh1,
                   const TIn* __restrict__ w2,
                   const TIn* __restrict__ b2,
                   TIn* __restrict__ h1_out, TC* __restrict__ c1_out,
                   TIn* __restrict__ h2_out, TC* __restrict__ c2_out,
                   int T, int L, int LB) {
  constexpr bool LOWP = sizeof(TIn) == 2;
  const int LP = (LB + 1) & ~1;  // lanes in pairs; a lane past LB is idle
  extern __shared__ float4 smem4[];
  float* s_h = reinterpret_cast<float*>(smem4);  // [2 buf][2 layer][LP][HS]
  float* s_x = s_h + 4 * LP * HS;  // [2 buf][LP][unit][gate]; bf16: [gate]
  float* s_c = s_x + 2 * LP * G;                 // [2 layer][LP][HS]
  float* s_b = s_c + 2 * LP * HS;                // [unit][gate]

  const int t = threadIdx.x, u = t >> 2, kq = t & 3;
  const int own_layer = kq >> 1, own_lane = kq & 1;
  const int lane0 = blockIdx.x * LB;

  // xw1[s] for the block's lanes -> s_x[s & 1], gates of a unit together
  // (float32: one float per thread and lane); bf16: each lane's 256 gates
  // in their own order, 16 bytes per copy
  auto load_x = [&](int s) {
    if constexpr (LOWP) {
      bf16* dst = reinterpret_cast<bf16*>(s_x + (s & 1) * LP * G);
      for (int e = t; e < LB * (G / 8); e += FWD_THREADS) {
        const int l = e / (G / 8), c8 = (e % (G / 8)) * 8;
        const bool ok = lane0 + l < L;
        cp_async16(dst + l * G + c8,
                   xw1 + (ok ? (static_cast<size_t>(s) * L + lane0 + l) * G
                               + c8 : 0), ok);
      }
    } else {
      float* dst = s_x + (s & 1) * LP * G + 4 * (t & (H - 1)) + (t >> 6);
      for (int l = 0; l < LB; ++l) {
        const bool ok = lane0 + l < L;
        cp_async4(dst + l * G,
                  xw1 + (ok ? (static_cast<size_t>(s) * L + lane0 + l) * G + t
                            : 0), ok);
      }
    }
    cp_async_commit();
  };
  load_x(0);
  for (int i = t; i < 4 * LP * HS; i += FWD_THREADS) s_h[i] = 0.0f;
  for (int i = t; i < 2 * LP * HS; i += FWD_THREADS) s_c[i] = 0.0f;
  s_b[4 * (t & (H - 1)) + (t >> 6)] = to_f32(b2[t]);
  // this thread's weights, in registers for the whole sequence: rows k =
  // 4 (kq + 4 i) + e of W_hh1, W_ih2 and W_hh2, the four gate columns of
  // unit u
  float wa[4][4][4], wb[4][4][4], wc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * (kq + 4 * i) + e, col = q * H + u;
        wa[i][e][q] = to_f32(w_hh1[k * G + col]);
        wb[i][e][q] = to_f32(w2[k * G + col]);
        wc[i][e][q] = to_f32(w2[(H + k) * G + col]);
      }
  cp_async_wait<0>();
  __syncthreads();

  // pass s: gates1[s] and gates2[s-1] from h1[s-1] | h2[s-2], then the
  // cells of h1[s] (s < T) and h2[s-1] (s > 0)
  for (int s = 0; s <= T; ++s) {
    if (s + 1 < T) load_x(s + 1);
    const float* hb = s_h + (s & 1) * 2 * LP * HS;
    float* hn = s_h + ((s + 1) & 1) * 2 * LP * HS;
    const float* xb = s_x + (s & 1) * LP * G;

    // the gate sums of lanes m, m + 1: this thread's quarter of K (a layer
    // 1, b layer 2), then the quarters summed: the partner across bit 1 of
    // kq takes the other layer, the one across bit 0 the other lane, so
    // each thread ends with the four gates of (own_layer, m + own_lane)
    auto gates = [&](int m, float* gt) {
      float a[2][4], b[2][4];
#pragma unroll
      for (int ln = 0; ln < 2; ++ln) {
        const float4* p1 =
            reinterpret_cast<const float4*>(hb + (m + ln) * HS) + kq;
        const float4* p2 =
            reinterpret_cast<const float4*>(hb + (LP + m + ln) * HS) + kq;
#pragma unroll
        for (int q = 0; q < 4; ++q) a[ln][q] = b[ln][q] = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x4 = p1[4 * i], y4 = p2[4 * i];
          const float x[4] = {x4.x, x4.y, x4.z, x4.w};
          const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              a[ln][q] = fmaf(x[e], wa[i][e][q], a[ln][q]);
              b[ln][q] = fmaf(x[e], wb[i][e][q], b[ln][q]);
              b[ln][q] = fmaf(y[e], wc[i][e][q], b[ln][q]);
            }
        }
      }
      float r[2][4];
#pragma unroll
      for (int ln = 0; ln < 2; ++ln)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float send = own_layer ? a[ln][q] : b[ln][q];
          const float keep = own_layer ? b[ln][q] : a[ln][q];
          r[ln][q] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
        }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float send = own_lane ? r[0][q] : r[1][q];
        const float keep = own_lane ? r[1][q] : r[0][q];
        gt[q] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
    };
    // the cell of (own_layer, lane m + own_lane) from its gate sums; no
    // branch but the stores, so that it interleaves with the next pair's
    // products
    auto cell = [&](int m, const float* gt) {
      const int l = m + own_lane, lane = lane0 + l;
      const int row = own_layer * LP + l;
      float4 add;
      if constexpr (LOWP) {
        const bf16* x16 = reinterpret_cast<const bf16*>(xb) + l * G + u;
        add = own_layer ? *reinterpret_cast<const float4*>(s_b + 4 * u)
                        : make_float4(to_f32(x16[0]), to_f32(x16[H]),
                                      to_f32(x16[2 * H]), to_f32(x16[3 * H]));
      } else {
        add = *reinterpret_cast<const float4*>(
            own_layer ? s_b + 4 * u : xb + l * G + 4 * u);
      }
      float* cp = s_c + row * HS + u;
      const float c = sigm_t(gt[1] + add.y) * *cp +
                      sigm_t(gt[0] + add.x) * tanhf(gt[2] + add.z);
      const float h = sigm_t(gt[3] + add.w) * tanhf(c);
      if (l < LB && (own_layer ? s > 0 : s < T)) {
        *cp = c;
        hn[row * HS + u] = operand(h, xw1);
        if (lane < L) {
          if (own_layer) {
            const size_t o = (static_cast<size_t>(s - 1) * L + lane) * H + u;
            store(h2_out + o, h);
            if (RES) store(c2_out + o, c);
          } else if (RES) {
            const size_t o = (static_cast<size_t>(s) * L + lane) * H + u;
            store(h1_out + o, h);
            store(c1_out + o, c);
          }
        }
      }
    };
    float gt[4];
    gates(0, gt);
#pragma unroll 1
    for (int m = 2; m < LP; m += 2) {
      float nx[4];
      gates(m, nx);
      cell(m - 2, gt);
#pragma unroll
      for (int q = 0; q < 4; ++q) gt[q] = nx[q];
    }
    cell(LP - 2, gt);
    cp_async_wait<0>();
    __syncthreads();  // h1[s], h2[s-1] and xw1[s+1] are in; s_x[s & 1] free
  }
}

// ---------------------------------------------------------------- backward
//
// Replaces eabnet_tpu/kernels/lstm_bf.py::_bwd_kernel (pallas_call at
// :289). Three launches: a reverse-time walk that writes d xw1 (= dgates1)
// and dgates2, a tensor-core GEMM that sums the weight gradients over the
// T*L rows into per-chunk partials, and a sum of those partials in chunk
// order (no atomics, so a launch repeats its bits).
//
// bfloat16 training (eabnet_lstm_bf_bwd_bf16) is the same design on the
// Pallas backward's bf16 operands: xw1, dy, the saved h and c, the
// weights and b2 arrive in bf16 (the weights staged as float32 values),
// every product is one bf16 mma.sync m16n8k8 per k-step (the h tiles
// staged in bf16 and read as bf16 pairs; dgates rounded to bf16 where the
// fragment is built, so the walk keeps its float32 dgates tiles and
// dgates2 workspace, which db2 sums unrounded), d xw1 leaves rounded to
// bf16, and the weight gradients are summed in float32 and rounded once,
// in the sum kernel. The carried (dh, dc), the gates and the cell math
// stay float32.
//
// What bounds it on this card. Per lane-step there are nine 64 x 256
// products: three recompute the gates (gates2 = [h1[t] | h2[t-1]] @
// [W_ih2; W_hh2] + b2, gates1 = xw1[t] + h1[t-1] @ W_hh1), three carry the
// cotangent back (dgates2 @ W_hh2^T, dgates2 @ W_ih2^T, dgates1 @
// W_hh1^T) and three are the weight gradients: 199.75 GFLOP at T = 601,
// L = 1,127, 2.98 ms at the float32 rate, 1.21 ms as three TF32 tensor-core
// products. The stream is 2.25 GB (0.67 ms). The walk is also a chain of
// T dependent steps, each of four dependent phases, so its latency per
// step, not a roofline, sets its time when few lanes share an SM.
//
// The walk. A block owns LB <= 9 lanes (taken from the SM count, so 1,127
// lanes fill 126 SMs; more than 9 lanes per SM take more waves: 1,288
// take two) as the rows of one 16-row tile, and runs all six per-step
// products on the tensor cores as mma.sync m16n8k8 TF32 with
// the 3xTF32 split (a = a_hi + a_lo; a_lo b_hi + a_hi b_lo + a_hi b_hi,
// which keeps float32's precision; one TF32 product keeps ~3 digits). The
// three weight matrices stay in shared memory (192 KB), each row's columns
// XOR-swizzled in groups of 8 by (u ^ u >> 2) & 3, so that the gates
// products (scalar loads down a column) and the transposed products
// (float2 loads along a row) read their fragments without bank conflicts.
// Warp w owns hidden units 8w .. 8w+7: its gates tiles are the columns
// {64q + 8w}, q = i, f, g, o, so each thread holds all four gates of its
// (lane, unit) pairs in registers and takes both cell backwards there, with
// the carried (dh, dc) in registers too; its transposed-product tiles are
// the same units, which land in the same registers. Only dgates passes
// through shared memory (it is the next product's A operand). The long
// transposed products (K = 256) keep 4-8 independent accumulators per tile
// so no single chain runs 256 deep. The gates of step t-1 do not depend on
// the carried cotangent, so they are computed at the end of step t beside
// its last product, and their layer-2 cell right after: two barriers per
// step. h1[t-1], h2[t-2] and h1[t-2] arrive by cp.async into a double
// buffer a step ahead; xw1, dy and the cell states of the next step are
// loaded into registers a step ahead. The cell math stays float32 with the
// precise tanhf (the sigmoid as 1/2 + tanh(x/2)/2, with no division).
//
// What holds the walk back now: per step and SM it issues 4,608 mma.sync
// (mma.sync does not reach the card's TF32 peak, which needs wgmma and
// 64-row tiles) and reads ~390 KB of weight fragments and ~200 KB of A
// fragments from shared memory (at 128 B per clock, ~4,600 clocks), with
// only 8 warps to overlap the two; and 7 of the 16 tile rows are idle at
// LB = 9, 14 at LB = 2 (one item: 161 lanes), where a walk with the
// operands swapped (weights as the 16-row A, lanes as the 8-column B)
// would issue fewer products; the released configs train 8 items a step
// (LB = 9, two waves). Splitting the A tiles once into hi and lo words in
// shared memory (fewer ALU instructions, twice the A loads) was measured
// slower, so each warp splits its own fragments.
//
// The weight gradients: dW_hh1 = h1[t-1]^T dgates1 and [dW_ih2; dW_hh2] =
// [h1[t] | h2[t-1]]^T dgates2, one K = 128 product, so dgates2 is read
// once; db2 = the column sums of dgates2, taken from the same tiles. Both
// are 3xTF32 mma.sync GEMMs over a chunk of rows per block, their tiles
// staged by a 4-deep cp.async ring of 32-row stages, rows padded to 8 mod
// 32 floats.

constexpr int BWD_THREADS = 256;
constexpr int BWD_LB_MAX = 9;  // lanes per block that fit beside the weights
constexpr int SH = 3 * H + 8;  // h tile row: h1[t] | h2[t-1] | h1[t-1]
constexpr int SD = G + 8;      // dgates tile row

// index of W[u][j] in a swizzled [H][G] copy
__device__ __forceinline__ int wsw(int u, int j) {
  return u * G + (j ^ (((u ^ (u >> 2)) & 3) << 3));
}

// the weights (float32), the h tiles (TIn) and the dgates tiles (float32)
template <typename TIn>
size_t bwd_smem_bytes(int lb) {
  return sizeof(float) * (3 * H * G + 2 * lb * SD) +
         sizeof(TIn) * 2 * lb * SH;
}

__device__ __forceinline__ float2 ld2(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
}

__device__ __forceinline__ float2 ld2(const bf16* p, bool ok) {
  return ok ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p))
            : make_float2(0.f, 0.f);
}

// four consecutive values as float32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xFFFF0000u));
}

__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void st2(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// an A row pair (k, k + 1) of a bf16 product: a bf16 tile's own word, or
// two float32 values rounded to bf16; zero for a row past the block
__device__ __forceinline__ uint32_t a_word(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

__device__ __forceinline__ uint32_t a_word(const float* p, bool ok) {
  const float2 v = ld2(p, ok);
  return pack_bf16(v.x, v.y);
}

// The walk's A fragment of a dgates tile (float32 in shared memory) for
// the bf16 transposed products: dgates rounded to bf16 where the fragment
// is built (the Pallas kernel's dg = dgates.astype(wdt)), then one bf16
// product per B fragment.
struct DgFrag {
  uint32_t a[2];
  __device__ __forceinline__ void load(const float* p, bool r0, bool r1) {
    a[0] = a_word(p, r0);
    a[1] = a_word(p + 8 * SD, r1);
  }
  __device__ __forceinline__ void mma(float* acc, uint32_t b) const {
    mma_bf16(acc, a, b);
  }
};

// One LSTM cell backward: gates (i, f, g, o pre-activations) in, the
// gates' cotangents out (in place); returns dc_prev.
__device__ __forceinline__ float cell_bwd(float* gt, float dh, float dc,
                                          float c_t, float c_p) {
  const float si = sigm_t(gt[0]), sf = sigm_t(gt[1]);
  const float sg = tanhf(gt[2]), so = sigm_t(gt[3]);
  const float tc = tanhf(c_t);
  const float dct = dc + dh * so * (1.0f - tc * tc);
  gt[0] = dct * sg * si * (1.0f - si);
  gt[1] = dct * c_p * sf * (1.0f - sf);
  gt[2] = dct * si * (1.0f - sg * sg);
  gt[3] = dh * tc * so * (1.0f - so);
  return dct * sf;
}

// The per-step values a thread reads from global memory, for its rows
// (g, g + 8) and units (u0, u0 + 1): xw1 per gate, dy, and c1, c2 at t-1.
struct StepIn {
  float2 x[4][2], dy[2], c1p[2], c2p[2];
};

// TIn: float (the float32 walk, 3xTF32 products) or bf16 (bf16 training,
// one bf16 product per k-step); TC: the saved cell states' type
template <typename TIn, typename TC>
__global__ void __launch_bounds__(BWD_THREADS, 1)
lstm_bf_bwd_kernel(const TIn* __restrict__ xw1, const TIn* __restrict__ dy,
                   const TIn* __restrict__ h1s, const TC* __restrict__ c1s,
                   const TIn* __restrict__ h2s, const TC* __restrict__ c2s,
                   const TIn* __restrict__ w_hh1,
                   const TIn* __restrict__ w_ih2,
                   const TIn* __restrict__ w_hh2,
                   const TIn* __restrict__ b2,
                   TIn* __restrict__ dxw1, float* __restrict__ dg2_out,
                   int T, int L, int LB) {
  constexpr bool LOWP = sizeof(TIn) == 2;
  extern __shared__ float4 smem4[];
  float* s_w1 = reinterpret_cast<float*>(smem4);  // W_hh1, swizzled
  float* s_wi2 = s_w1 + H * G;                    // W_ih2, swizzled
  float* s_wh2 = s_wi2 + H * G;                   // W_hh2, swizzled
  TIn* s_h = reinterpret_cast<TIn*>(s_wh2 + H * G);  // [2][LB][SH]
  float* s_dg2 = reinterpret_cast<float*>(s_h + 2 * LB * SH);  // [LB][SD]
  float* s_dg1 = s_dg2 + LB * SD;                 // [LB][SD]

  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2,
            tq = tid & 3;
  const int lane0 = blockIdx.x * LB;
  const int u0 = 8 * w + 2 * tq;  // this thread's units u0, u0 + 1
  // this thread's rows g and g + 8: inside the block and inside L
  bool rin[2], rok[2];
  size_t rl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    rin[rr] = g + 8 * rr < LB;
    rok[rr] = rin[rr] && lane0 + g + 8 * rr < L;
    rl[rr] = static_cast<size_t>(lane0 + g + 8 * rr);
  }

  // Fragment offsets, so that every shared load in the loops below is a
  // register plus a constant. A: row g, column 2 tq of a tile. B of the
  // gates products: W[8 a + 2 tq + e][64 q + 8 w + g] = wm[gb[e][a & 1] +
  // 8 a G + 64 q] (the swizzle of row u = 8 a + 2 tq + e depends on a only
  // through a & 1). B of the transposed products: W[8 w + g][8 kk + 2 tq,
  // + 1] = wm[tb[kk & 3] + 32 (kk >> 2)], a float2.
  const int a_off = g * SH + 2 * tq, d_off = g * SD + 2 * tq;
  int gb[2][2], tb[4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int a = 0; a < 2; ++a)
      gb[e][a] = wsw(8 * a + 2 * tq + e, 8 * w + g) - 8 * a * G;
#pragma unroll
  for (int m = 0; m < 4; ++m) tb[m] = wsw(8 * w + g, 8 * m + 2 * tq);

  // A fragment of a 16-row tile in shared memory (rows past LB are zero):
  // p points at row g, k = 8 kk + 2 tq, the mma's k slots tq and tq + 4
  // permuted alike in A and B so that both are one float2
  auto load_a = [&](const TIn* p, int stride, uint32_t* ah, uint32_t* al) {
    const float2 lo = ld2(p, rin[0]), hi = ld2(p + 8 * stride, rin[1]);
    split_tf32(lo.x, ah[0], al[0]);
    split_tf32(lo.y, ah[2], al[2]);
    split_tf32(hi.x, ah[1], al[1]);
    split_tf32(hi.y, ah[3], al[3]);
  };

  // the weights as float32 (a bf16 weight is its float32 value)
  for (int i = tid; i < H * G / 4; i += BWD_THREADS) {
    const int u = i / (G / 4), j = (i % (G / 4)) * 4;
    const int p = wsw(u, j);  // the swizzle moves groups of 8: float4 stays
    *reinterpret_cast<float4*>(s_w1 + p) = ld4(w_hh1 + 4 * i);
    *reinterpret_cast<float4*>(s_wi2 + p) = ld4(w_ih2 + 4 * i);
    *reinterpret_cast<float4*>(s_wh2 + p) = ld4(w_hh2 + 4 * i);
  }

  // h tile of step s: h1[s] | h2[s-1] | h1[s-1], zero outside [0, T) x L;
  // E values per 16-byte copy
  constexpr int E = 16 / sizeof(TIn);
  auto load_h = [&](int s, TIn* dst) {
    for (int i = tid; i < LB * (3 * H / E); i += BWD_THREADS) {
      const int r = i / (3 * H / E), c = (i % (3 * H / E)) * E;
      const int part = c / H, ts = part == 0 ? s : s - 1;
      const bool ok = lane0 + r < L && ts >= 0;
      const TIn* src = (part == 1 ? h2s : h1s) +
          (ok ? (static_cast<size_t>(ts) * L + lane0 + r) * H + c % H : 0);
      cp_async16(dst + r * SH + c, src, ok);
    }
    cp_async_commit();
  };
  auto load_in = [&](int s, StepIn& in) {
    const bool has_p = s > 0;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const size_t o = (static_cast<size_t>(s) * L + rl[rr]);
      const size_t op = (static_cast<size_t>(has_p ? s - 1 : 0) * L + rl[rr]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        in.x[q][rr] = ld2(xw1 + o * G + q * H + u0, rok[rr]);
      in.dy[rr] = ld2(dy + o * H + u0, rok[rr]);
      in.c1p[rr] = ld2(c1s + op * H + u0, rok[rr] && has_p);
      in.c2p[rr] = ld2(c2s + op * H + u0, rok[rr] && has_p);
    }
  };

  float bq[4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bq[q][0] = to_f32(b2[q * H + u0]);
    bq[q][1] = to_f32(b2[q * H + u0 + 1]);
  }
  // gates2 = [h1[s] | h2[s-1]] @ [W_ih2; W_hh2] + b2 (K = 128) and gates1 =
  // xw1[s] + h1[s-1] @ W_hh1 (K = 64) of step s from its h tile sh; tile q
  // = gate q, columns 64 q + 8 w .. + 7
  auto gates = [&](const TIn* sh, const StepIn& in, float (*a2)[4],
                   float (*a1)[4]) {
    auto kstep = [&](int kk, const float* wm, float (*acc)[4]) {
      const float* wk = wm + (kk & 7) * 8 * G;
      if constexpr (LOWP) {  // bf16 h and weights: one bf16 product
        const uint32_t a[2] = {a_word(sh + a_off + 8 * kk, rin[0]),
                               a_word(sh + a_off + 8 * kk + 8 * SH, rin[1])};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_bf16(acc[q], a, pack_bf16(wk[gb[0][kk & 1] + q * H],
                                        wk[gb[1][kk & 1] + q * H]));
      } else {
        uint32_t ah[4], al[4];
        load_a(sh + a_off + 8 * kk, SH, ah, al);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t bh[2], bl[2];
          split_tf32(wk[gb[0][kk & 1] + q * H], bh[0], bl[0]);
          split_tf32(wk[gb[1][kk & 1] + q * H], bh[1], bl[1]);
          mma3(acc[q], ah, al, bh, bl);
        }
      }
    };
    float a2h[4][4];  // the h2[s-1] half on its own: shorter chains
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a2[q][0] = a2[q][2] = bq[q][0];
      a2[q][1] = a2[q][3] = bq[q][1];
      a1[q][0] = in.x[q][0].x;
      a1[q][1] = in.x[q][0].y;
      a1[q][2] = in.x[q][1].x;
      a1[q][3] = in.x[q][1].y;
#pragma unroll
      for (int i = 0; i < 4; ++i) a2h[q][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      kstep(kk, s_wi2, a2);
      kstep(kk + 8, s_wh2, a2h);
    }
#pragma unroll
    for (int kk = 16; kk < 24; ++kk) kstep(kk, s_w1, a1);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) a2[q][i] += a2h[q][i];
  };

  // carried per (row rr, unit e) at index 2 rr + e, the mma C layout
  float dh1c[4] = {0.f, 0.f, 0.f, 0.f}, dh2c[4] = {0.f, 0.f, 0.f, 0.f};
  float dc1[4] = {0.f, 0.f, 0.f, 0.f}, dc2[4] = {0.f, 0.f, 0.f, 0.f};
  float c1t[4], c2t[4], a2[4][4], a1[4][4];
  StepIn cur, nxt;
  load_h(T - 1, s_h + ((T - 1) & 1) * LB * SH);
  load_in(T - 1, cur);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const size_t o = (static_cast<size_t>(T - 1) * L + rl[rr]) * H + u0;
    const float2 a = ld2(c1s + o, rok[rr]), b = ld2(c2s + o, rok[rr]);
    c1t[2 * rr] = a.x;
    c1t[2 * rr + 1] = a.y;
    c2t[2 * rr] = b.x;
    c2t[2 * rr + 1] = b.y;
  }
  // layer-2 cell backward of step s on its gates a2: dgates2 to shared and
  // (when store) global memory
  auto cell2 = [&](int s, const StepIn& in, bool store) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float dyv[2] = {in.dy[rr].x, in.dy[rr].y};
      const float cp[2] = {in.c2p[rr].x, in.c2p[rr].y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * rr + e;
        float gt[4] = {a2[0][i], a2[1][i], a2[2][i], a2[3][i]};
        dc2[i] = cell_bwd(gt, dyv[e] + dh2c[i], dc2[i], c2t[i], cp[e]);
#pragma unroll
        for (int q = 0; q < 4; ++q) a2[q][i] = gt[q];
      }
      if (rin[rr] && store) {
        const size_t o = (static_cast<size_t>(s) * L + rl[rr]) * G + u0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = make_float2(a2[q][2 * rr], a2[q][2 * rr + 1]);
          *reinterpret_cast<float2*>(s_dg2 + (g + 8 * rr) * SD + q * H +
                                     u0) = v;
          if (rok[rr]) st2(dg2_out + o + q * H, v);
        }
      }
    }
  };
  cp_async_wait<0>();
  __syncthreads();  // the weights and the h tile of T-1 are in
  gates(s_h + ((T - 1) & 1) * LB * SH, cur, a2, a1);
  cell2(T - 1, cur, true);

  // Step t starts from dgates2 of t, which step t+1 left in shared memory:
  // its last phase computes the serial chain's last product (dh1'), the
  // gates of t and their layer-2 cell backward, independent work that the
  // scheduler can interleave; two barriers per step.
  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) {
      load_h(t - 1, s_h + ((t - 1) & 1) * LB * SH);
      load_in(t - 1, nxt);
    }
    __syncthreads();  // dgates2 of t is in

    // ---- dh2' = dgates2 @ W_hh2^T, dh1 += dgates2 @ W_ih2^T (K = 256),
    //      units 8 w .. + 7; B[k = j][n = u] = W[u][j], a float2 along j
    {
      float acc[2][4][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[p][s][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) {
        uint32_t ah[4], al[4];
        DgFrag dg;
        if constexpr (LOWP)
          dg.load(s_dg2 + d_off + 8 * kk, rin[0], rin[1]);
        else
          load_a(s_dg2 + d_off + 8 * kk, SD, ah, al);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float* wm = p ? s_wi2 : s_wh2;
          const float2 b = *reinterpret_cast<const float2*>(
              wm + tb[kk & 3] + 32 * (kk >> 2));
          if constexpr (LOWP) {
            dg.mma(acc[p][kk & 3], pack_bf16(b.x, b.y));
          } else {
            uint32_t bh[2], bl[2];
            split_tf32(b.x, bh[0], bl[0]);
            split_tf32(b.y, bh[1], bl[1]);
            mma3(acc[p][kk & 3], ah, al, bh, bl);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dh2c[i] = (acc[0][0][i] + acc[0][1][i]) +
                  (acc[0][2][i] + acc[0][3][i]);
        dh1c[i] += (acc[1][0][i] + acc[1][1][i]) +
                   (acc[1][2][i] + acc[1][3][i]);
      }
    }

    // ---- layer-1 cell backward: dgates1 = d xw1[t]
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float cp[2] = {cur.c1p[rr].x, cur.c1p[rr].y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * rr + e;
        float gt[4] = {a1[0][i], a1[1][i], a1[2][i], a1[3][i]};
        dc1[i] = cell_bwd(gt, dh1c[i], dc1[i], c1t[i], cp[e]);
#pragma unroll
        for (int q = 0; q < 4; ++q) a1[q][i] = gt[q];
      }
      if (rin[rr]) {
        const size_t o = (static_cast<size_t>(t) * L + rl[rr]) * G + u0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = make_float2(a1[q][2 * rr], a1[q][2 * rr + 1]);
          *reinterpret_cast<float2*>(s_dg1 + (g + 8 * rr) * SD + q * H +
                                     u0) = v;
          if (rok[rr]) st2(dxw1 + o + q * H, v);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // dgates1 and the h tile of t-1 are in

    // ---- dh1' = dgates1 @ W_hh1^T (K = 256), eight accumulators
    {
      float acc[8][4];
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[s][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) {
        const float2 b = *reinterpret_cast<const float2*>(
            s_w1 + tb[kk & 3] + 32 * (kk >> 2));
        if constexpr (LOWP) {
          DgFrag dg;
          dg.load(s_dg1 + d_off + 8 * kk, rin[0], rin[1]);
          dg.mma(acc[kk & 7], pack_bf16(b.x, b.y));
        } else {
          uint32_t ah[4], al[4];
          load_a(s_dg1 + d_off + 8 * kk, SD, ah, al);
          uint32_t bh[2], bl[2];
          split_tf32(b.x, bh[0], bl[0]);
          split_tf32(b.y, bh[1], bl[1]);
          mma3(acc[kk & 7], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dh1c[i] = ((acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i])) +
                  ((acc[4][i] + acc[5][i]) + (acc[6][i] + acc[7][i]));
    }
    // ---- step t-1 reads c[t-1] as its c_t; its gates and layer-2 cell
    //      (at t = 0 of no step: nothing is stored)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      c1t[2 * rr] = cur.c1p[rr].x;
      c1t[2 * rr + 1] = cur.c1p[rr].y;
      c2t[2 * rr] = cur.c2p[rr].x;
      c2t[2 * rr + 1] = cur.c2p[rr].y;
    }
    gates(s_h + ((t - 1) & 1) * LB * SH, nxt, a2, a1);
    cell2(t - 1, nxt, t > 0);
    if (t > 0) cur = nxt;
  }
}

// Weight-gradient partials on the tensor cores, one launch: blockIdx.y is
// the job:
//   0: dW_hh1 = sum_n h1[n-L]^T dgates1[n]          (M = 64, N = 256)
//   1, 2: [dW_ih2; dW_hh2] = sum_n [h1[n] | h2[n-L]]^T dgates2[n], columns
//         128 (y-1) .. + 127, and db2 over those columns  (M = 128, N = 128)
// over the rows n = t L + lane of chunk blockIdx.x (h[n-L] is zero for
// t = 0). Each job's block is a 16,384-entry tile: 8 warps of 32 x 64.
// Partials go to part[chunk] in dw's layout [dW_hh1, dW_ih2, dW_hh2, db2].
// TA: the states' type, TB: that of the job's B operand (bsrc: dgates1,
// which is d xw1, or dgates2, float32). With bf16 states (bf16 training) each k-step is one bf16
// product of the operands rounded to bf16 (dgates2 arrives in float32 and
// is rounded here; db2 sums it unrounded, as the Pallas kernel does), into
// zeroed registers and then added in float32; with float32 states, three
// TF32 products per k-step, a stage's k-steps into zeroed registers.
constexpr int WG_BK = 32;     // rows per stage
constexpr int WG_STAGES = 4;  // cp.async ring depth
// a stage holds the larger job's A and B rows: (64 + 8) + (256 + 8) floats
constexpr int WG_STAGE_FLOATS = WG_BK * (H + 8 + G + 8);
constexpr int DW_FLOATS = 3 * H * G + G;

// an mma operand pair (k, k + 1) from two bf16 values, or from two float32
// values rounded to bf16
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return pack_bf16(lo, hi);
}

template <typename TA, typename TB>
__device__ __forceinline__ void wgrad_tile(const TA* __restrict__ h1s,
                                           const TA* __restrict__ h2s,
                                           const TB* __restrict__ bsrc,
                                           float* __restrict__ part, int T,
                                           int L, int job) {
  constexpr bool LOWP = sizeof(TA) == 2;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  const int tid = threadIdx.x, w = tid >> 5, g = (tid & 31) >> 2,
            tq = tid & 3;
  const int MT = job ? 2 * H : H, NT = job ? G / 2 : G;
  const int AS = MT + 8, BS = NT + 8;  // row strides (values)
  const int col0 = job ? (job - 1) * (G / 2) : 0;
  const int wm = MT / 32;  // warps along M
  const int m0 = (w % wm) * 32, n0 = (w / wm) * 64;

  const long long n_rows = static_cast<long long>(T) * L;
  const long long per = (n_rows + gridDim.x - 1) / gridDim.x;
  const long long r0 = per * blockIdx.x;
  const long long r1 = r0 + per < n_rows ? r0 + per : n_rows;
  const int nk = r1 > r0 ? static_cast<int>((r1 - r0 + WG_BK - 1) / WG_BK) : 0;

  // stage kt's A rows (TA) and B rows (TB); EA, EB values per 16 bytes
  constexpr int EA = 16 / sizeof(TA), EB = 16 / sizeof(TB);
  auto stage_a = [&](int kt) {
    return reinterpret_cast<TA*>(ring + (kt % WG_STAGES) * WG_STAGE_FLOATS *
                                            sizeof(float));
  };
  auto stage_b = [&](int kt) {
    return reinterpret_cast<TB*>(stage_a(kt) + WG_BK * AS);
  };
  auto load = [&](int kt) {
    TA* as = stage_a(kt);
    TB* bs = stage_b(kt);
    const long long base = r0 + static_cast<long long>(kt) * WG_BK;
    for (int i = tid; i < WG_BK * MT / EA; i += BWD_THREADS) {
      const int r = i / (MT / EA), c = (i % (MT / EA)) * EA;
      const long long n = base + r;
      const TA* src = h1s;
      bool ok = n < r1;
      long long row = n;
      if (job == 0 || c >= H) {
        row = n - L;
        ok = ok && row >= 0;
        if (job) src = h2s;
      }
      cp_async16(as + r * AS + c,
                 src + (ok ? row * H + (c & (H - 1)) : 0), ok);
    }
    for (int i = tid; i < WG_BK * NT / EB; i += BWD_THREADS) {
      const int r = i / (NT / EB), c = (i % (NT / EB)) * EB;
      const long long n = base + r;
      const bool ok = n < r1;
      cp_async16(bs + r * BS + c, bsrc + (ok ? n * G + col0 + c : 0), ok);
    }
  };

  // the tensor cores' float32 sum truncates where an FADD rounds, so the
  // mma accumulators take one stage (WG_BK rows) and are then added into
  // float32 sums: the error does not grow with the chunk's length
  float acc[2][8][4], sum[2][8][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[a][b][i] = 0.f;
  float accb = 0.f;

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
    const TA* as = stage_a(kt);
    const TB* bs = stage_b(kt);
    if (job && tid < NT) {  // db2: each stage's rows, then the sum
      float st = 0.f;
#pragma unroll
      for (int r = 0; r < WG_BK; ++r) st += to_f32(bs[r * BS + tid]);
      accb += st;
    }
    if constexpr (LOWP) {
#pragma unroll
      for (int ks = 0; ks < WG_BK / 8; ++ks) {
        // the TF32 fragments' (k = tq, tq + 4) slots as one bf16 pair
        const TA* ak = as + (ks * 8 + tq) * AS + m0 + g;
        const TB* bk = bs + (ks * 8 + tq) * BS + n0 + g;
        uint32_t a2[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          a2[mt][0] = pack2(ak[mt * 16], ak[4 * AS + mt * 16]);
          a2[mt][1] = pack2(ak[mt * 16 + 8], ak[4 * AS + mt * 16 + 8]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint32_t b = pack2(bk[nt * 8], bk[4 * BS + nt * 8]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16_add(sum[mt][nt], a2[mt], b);
        }
      }
      continue;
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[a][b][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < WG_BK / 8; ++ks) {
      const TA* ak = as + (ks * 8 + tq) * AS + m0 + g;
      const TB* bk = bs + (ks * 8 + tq) * BS + n0 + g;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float av[4] = {to_f32(ak[mt * 16]), to_f32(ak[mt * 16 + 8]),
                             to_f32(ak[4 * AS + mt * 16]),
                             to_f32(ak[4 * AS + mt * 16 + 8])};
        split4(av, ah[mt], al[mt]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bh[2], bl[2];
        split_tf32(to_f32(bk[nt * 8]), bh[0], bl[0]);
        split_tf32(to_f32(bk[4 * BS + nt * 8]), bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma3(acc[mt][nt], ah[mt], al[mt], bh, bl);
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[a][b][i] += acc[a][b][i];
  }
  cp_async_wait<0>();

  float* out = part + static_cast<size_t>(blockIdx.x) * DW_FLOATS;
  const int row0 = job ? H : 0;  // [dW_ih2; dW_hh2] follow dW_hh1
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int m = row0 + m0 + mt * 16 + g, n = col0 + n0 + nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(out + m * G + n) =
          make_float2(sum[mt][nt][0], sum[mt][nt][1]);
      *reinterpret_cast<float2*>(out + (m + 8) * G + n) =
          make_float2(sum[mt][nt][2], sum[mt][nt][3]);
    }
  if (job && tid < NT) out[3 * H * G + col0 + tid] = accb;
}

// TD1: the type of d xw1 (job 0's B operand); dgates2 is float32
template <typename TA, typename TD1>
__global__ void __launch_bounds__(BWD_THREADS, 1)
lstm_bf_wgrad_kernel(const TA* __restrict__ h1s, const TA* __restrict__ h2s,
                     const TD1* __restrict__ dg1,
                     const float* __restrict__ dg2, float* __restrict__ part,
                     int T, int L) {
  if (blockIdx.y == 0)
    wgrad_tile(h1s, h2s, dg1, part, T, L, 0);
  else
    wgrad_tile(h1s, h2s, dg2, part, T, L, blockIdx.y);
}

// dw = the partials summed over chunks in chunk order, in float32, then
// written in dw's type (bf16 training: rounded once, at the end).
template <typename TO>
__global__ void lstm_bf_wgrad_sum_kernel(const float* __restrict__ part,
                                         TO* __restrict__ dw, int nchunk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= DW_FLOATS) return;
  float s = 0.0f;
  for (int c = 0; c < nchunk; ++c)
    s += part[static_cast<size_t>(c) * DW_FLOATS + i];
  store(dw + i, s);
}

cudaError_t sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
}

// Lanes per block, forward and backward: as few as fill the SMs once (not
// rounded to a power of two), at most lb_max; more lanes take more waves.
cudaError_t lanes_per_block(int L, int lb_max, int* lb) {
  int n_sm = 0;
  cudaError_t err = sm_count(&n_sm);
  if (err != cudaSuccess) return err;
  const int need = (L + n_sm - 1) / n_sm;
  *lb = need < 1 ? 1 : need > lb_max ? lb_max : need;
  return cudaSuccess;
}

template <bool RES, typename TIn, typename TC>
cudaError_t launch_fwd(const TIn* xw1, const TIn* w_hh1, const TIn* w2,
                       const TIn* b2, TIn* h1, TC* c1, TIn* h2, TC* c2, int T,
                       int L, cudaStream_t stream) {
  if (T < 1 || L < 1) return cudaErrorInvalidValue;
  int lb = 0;
  cudaError_t err = lanes_per_block(L, FWD_LB_MAX, &lb);
  if (err != cudaSuccess) return err;
  const size_t smem = fwd_smem_bytes(lb);
  err = cudaFuncSetAttribute(lstm_bf_fwd_kernel<RES, TIn, TC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_bf_fwd_kernel<RES, TIn, TC>
      <<<(L + lb - 1) / lb, FWD_THREADS, smem, stream>>>(
      xw1, w_hh1, w2, b2, h1, c1, h2, c2, T, L, lb);
  return cudaGetLastError();
}

// Row chunks of the weight-gradient GEMM: its 3 jobs x chunks blocks, one
// per SM, fill the card once.
int wgrad_chunks() {
  int n_sm = 0;
  if (sm_count(&n_sm) != cudaSuccess) return -1;
  return n_sm / 3 > 0 ? n_sm / 3 : 1;
}

}  // namespace

// xw1 (T, L, 256), w_hh1 (64, 256), w2 (128, 256), b2 (256,) -> h2 (T, L, 64),
// all float32, contiguous, on the current device. Returns a cudaError_t.
extern "C" int eabnet_lstm_bf_fwd(const float* xw1, const float* w_hh1,
                                  const float* w2, const float* b2, float* h2,
                                  int T, int L, void* stream) {
  float* no = nullptr;
  return launch_fwd<false>(xw1, w_hh1, w2, b2, no, no, h2, no, T, L,
                           static_cast<cudaStream_t>(stream));
}

// The serving forward with bf16 operands: as eabnet_lstm_bf_fwd with xw1,
// w_hh1, w2, b2 and h2 in bfloat16 (xw1 16-byte aligned).
extern "C" int eabnet_lstm_bf_fwd_bf16(const bf16* xw1, const bf16* w_hh1,
                                       const bf16* w2, const bf16* b2,
                                       bf16* h2, int T, int L, void* stream) {
  bf16* no = nullptr;
  return launch_fwd<false>(xw1, w_hh1, w2, b2, no, no, h2, no, T, L,
                           static_cast<cudaStream_t>(stream));
}

// The training forward: as eabnet_lstm_bf_fwd, and also writes the
// residuals h1, c1, c2 (T, L, 64) that the backward reads.
extern "C" int eabnet_lstm_bf_fwd_train(const float* xw1, const float* w_hh1,
                                        const float* w2, const float* b2,
                                        float* h1, float* c1, float* h2,
                                        float* c2, int T, int L, void* stream) {
  return launch_fwd<true>(xw1, w_hh1, w2, b2, h1, c1, h2, c2, T, L,
                          static_cast<cudaStream_t>(stream));
}

// The type of the cell states that bf16 training saves (the Pallas
// kernel writes its sequences in the primal dtype).
using CSave = bf16;

// The training forward of bf16 training: as eabnet_lstm_bf_fwd_bf16, and
// also writes h1 and (in CSave) c1, c2, rounded from the float32 state.
extern "C" int eabnet_lstm_bf_fwd_train_bf16(const bf16* xw1,
                                             const bf16* w_hh1,
                                             const bf16* w2, const bf16* b2,
                                             bf16* h1, CSave* c1, bf16* h2,
                                             CSave* c2, int T, int L,
                                             void* stream) {
  return launch_fwd<true>(xw1, w_hh1, w2, b2, h1, c1, h2, c2, T, L,
                          static_cast<cudaStream_t>(stream));
}

// The forward's lanes per block for L lanes on the current device (its
// grid is ceil(L / that) blocks), or minus a cudaError_t.
extern "C" int eabnet_lstm_bf_fwd_lanes_per_block(int L) {
  int lb = 0;
  const cudaError_t err = lanes_per_block(L < 1 ? 1 : L, FWD_LB_MAX, &lb);
  return err == cudaSuccess ? lb : -static_cast<int>(err);
}

// Floats of scratch the wrapper allocates for one backward launch:
// dgates2 (T, L, 256) and the weight-gradient partials.
extern "C" long long eabnet_lstm_bf_bwd_workspace(int T, int L) {
  const int nchunk = wgrad_chunks();
  if (nchunk < 1) return -1;
  return static_cast<long long>(T) * L * G +
         static_cast<long long>(nchunk) * DW_FLOATS;
}

namespace {

// The backward's three launches on one stream.
template <typename TIn, typename TC>
cudaError_t launch_bwd(const TIn* xw1, const TIn* dy, const TIn* h1,
                       const TC* c1, const TIn* h2, const TC* c2,
                       const TIn* w_hh1, const TIn* w_ih2, const TIn* w_hh2,
                       const TIn* b2, TIn* dxw1, TIn* dw, float* work, int T,
                       int L, cudaStream_t s) {
  if (T < 1 || L < 1) return cudaErrorInvalidValue;
  int lb = 0;
  cudaError_t err = lanes_per_block(L, BWD_LB_MAX, &lb);
  if (err != cudaSuccess) return err;
  const int nchunk = wgrad_chunks();
  if (nchunk < 1) return cudaErrorInvalidDevice;
  float* dg2 = work;
  float* part = work + static_cast<size_t>(T) * L * G;
  size_t smem = bwd_smem_bytes<TIn>(lb);
  err = cudaFuncSetAttribute(lstm_bf_bwd_kernel<TIn, TC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_bf_bwd_kernel<TIn, TC><<<(L + lb - 1) / lb, BWD_THREADS, smem, s>>>(
      xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2, dxw1, dg2, T, L, lb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = sizeof(float) * WG_STAGES * WG_STAGE_FLOATS;
  err = cudaFuncSetAttribute(lstm_bf_wgrad_kernel<TIn, TIn>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lstm_bf_wgrad_kernel<TIn, TIn><<<dim3(nchunk, 3), BWD_THREADS, smem, s>>>(
      h1, h2, dxw1, dg2, part, T, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lstm_bf_wgrad_sum_kernel<<<(DW_FLOATS + 255) / 256, 256, 0, s>>>(
      part, dw, nchunk);
  return cudaGetLastError();
}

}  // namespace

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
  return launch_bwd(xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2, dxw1,
                    dw, work, T, L, static_cast<cudaStream_t>(stream));
}

// The backward of bf16 training: as eabnet_lstm_bf_bwd with every tensor
// in bfloat16 (the cell states in CSave) and the same float32 workspace;
// dxw1 and dw come out rounded to bf16 (dw once, after its float32 sum).
extern "C" int eabnet_lstm_bf_bwd_bf16(const bf16* xw1, const bf16* dy,
                                       const bf16* h1, const CSave* c1,
                                       const bf16* h2, const CSave* c2,
                                       const bf16* w_hh1, const bf16* w_ih2,
                                       const bf16* w_hh2, const bf16* b2,
                                       bf16* dxw1, bf16* dw, float* work,
                                       int T, int L, void* stream) {
  return launch_bwd(xw1, dy, h1, c1, h2, c2, w_hh1, w_ih2, w_hh2, b2, dxw1,
                    dw, work, T, L, static_cast<cudaStream_t>(stream));
}

extern "C" const char* eabnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
