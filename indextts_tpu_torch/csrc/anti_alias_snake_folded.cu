// K4: the fused anti-aliased Snake / SnakeBeta of the vocoder's narrow stages
// (C <= 96), for NVIDIA Hopper (sm_90a).
//
// Replaces indextts_tpu/ops/pallas/antialias_folded.py:fused_folded_aa. That
// kernel folds s time phases onto the TPU's 128 lanes and runs the two
// resampling filters as stacked-tap matrix products with diagonal-dense
// weights; the fold, its zero blocks and its halo blocks are a lane layout and
// are not carried over. What is carried over is the function and where it
// rounds:
//   y[m] = sum_k up[k] * x[clamp((m + 15 - k) / 2 - 5, 0, T-1)]   (m + 15 - k even)
//   a[m] = round(y[m] + 1/(beta + 1e-9) * sin(alpha * y[m])^2)
//   z[t] = sum_j dn[j] * a[clamp(2t + j - 5, 0, 2T-1)]
// up = 2 f and dn = f are the 12-tap Kaiser-sinc filters, ROUNDED TO x's DTYPE
// by the caller (the TPU kernel casts its tap matrices to x's dtype); the sums
// and the snake are float32; round() rounds the activated 2x-rate samples to
// x's dtype, as the TPU kernel does before its second product; the sin is the
// polynomial of approx_sin.cuh or sinf, as the caller says. Both clamps are
// the composed path's replicate pads, so the edges need no patch pass. x and
// out are [B, C, T], time contiguous (the vocoder trunk's layout), alpha and
// beta [C] float32, already exponentiated for log-scale parameters.
//
// Shape of the work: few rows (24-96 per batch element), each tens of
// thousands of frames long. Bound: within 5 % of each other for bf16, 4 bytes
// against ~84 float32 operations per element (operations ahead); bytes for
// float32. The design is a warp that walks along a row. A lane holds 8
// consecutive frames, so a warp holds a chunk of 256 frames, loaded and stored
// as one contiguous run of 16-byte vectors. The 3 input frames and the 5
// activated samples a lane needs from each neighbour come by warp shuffle;
// across a chunk's ends they come from the chunk before (kept in registers)
// and the chunk after (loaded and activated one step ahead, the outputs one
// step behind). Every activated sample of a warp's segment is computed once:
// there is no shared memory, no block barrier and no halo recomputed per
// thread. The 10 samples outside the segment's ends, and the row's last
// sample for the right-hand clamp, are computed one per lane in a prologue.
// The host cuts each row into equal segments so that the grid is at most one
// resident wave (16 warps on each SM), which keeps the tail short.
//
// TMA loads and packed bf16 shuffles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "approx_sin.cuh"

namespace {

constexpr int LANE_F = 8;            // frames a lane holds of a chunk
constexpr int CHUNK = 32 * LANE_F;   // frames a warp holds
constexpr int WARPS = 8;             // warps per block; they share nothing
constexpr int THREADS = 32 * WARPS;
constexpr int WARPS_PER_SM = 16;     // resident at <= 128 registers a thread
constexpr unsigned FULL = 0xffffffffu;

struct Taps {
  float up[12];  // 2 f, rounded to the I/O dtype
  float dn[12];  // f, rounded to the I/O dtype
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// frames f0 .. f0+7 of a row, replicate-clamped to the row
__device__ __forceinline__ void load8(const float* row, int f0, int T_len, bool vec_ok, float (&v)[LANE_F]) {
  if (vec_ok && f0 >= 0 && f0 + LANE_F <= T_len) {
    const float4 a = *reinterpret_cast<const float4*>(row + f0);
    const float4 b = *reinterpret_cast<const float4*>(row + f0 + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < LANE_F; ++q) v[q] = row[min(max(f0 + q, 0), T_len - 1)];
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* row, int f0, int T_len, bool vec_ok, float (&v)[LANE_F]) {
  if (vec_ok && f0 >= 0 && f0 + LANE_F <= T_len) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + f0);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      v[2 * q] = f.x;
      v[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < LANE_F; ++q) v[q] = __bfloat162float(row[min(max(f0 + q, 0), T_len - 1)]);
  }
}

__device__ __forceinline__ void store8(float* row, int f0, int T_len, bool vec_ok, const float (&z)[LANE_F]) {
  if (f0 >= T_len) return;
  if (vec_ok && f0 + LANE_F <= T_len) {
    *reinterpret_cast<float4*>(row + f0) = make_float4(z[0], z[1], z[2], z[3]);
    *reinterpret_cast<float4*>(row + f0 + 4) = make_float4(z[4], z[5], z[6], z[7]);
  } else {
#pragma unroll
    for (int q = 0; q < LANE_F; ++q) {
      if (f0 + q < T_len) row[f0 + q] = z[q];
    }
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* row, int f0, int T_len, bool vec_ok, const float (&z)[LANE_F]) {
  if (f0 >= T_len) return;
  if (vec_ok && f0 + LANE_F <= T_len) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(z[2 * q], z[2 * q + 1]);
    *reinterpret_cast<uint4*>(row + f0) = raw;
  } else {
#pragma unroll
    for (int q = 0; q < LANE_F; ++q) {
      if (f0 + q < T_len) row[f0 + q] = __float2bfloat16(z[q]);
    }
  }
}

template <typename T, bool POLY_SIN>
__device__ __forceinline__ float snake(float y, float a, float inv_b) {
  const float s = POLY_SIN ? poly_sin(y * a) : sinf(y * a);
  return round_to<T>(y + inv_b * (s * s));
}

// the value of `mine` in the lane before / after this one, around the warp
__device__ __forceinline__ float from_prev_lane(float mine, int lane) {
  return __shfl_sync(FULL, mine, (lane + 31) & 31);
}
__device__ __forceinline__ float from_next_lane(float mine, int lane) {
  return __shfl_sync(FULL, mine, (lane + 1) & 31);
}

// The 16 activated samples a[2 f0 .. 2 f0 + 15] of a lane's 8 frames f0 ..
// f0+7 of a chunk: xc are the lane's frames, xpt the last 3 frames the lane
// held of the chunk before, xn its frames of the chunk after (lane 0 reads
// the chunk before through lane 31, lane 31 the chunk after through lane 0).
// Samples past the row's last, 2T - 1, take `last`.
template <typename T, bool POLY_SIN>
__device__ __forceinline__ void activate_chunk(const float (&xpt)[3], const float (&xc)[LANE_F], const float (&xn)[LANE_F],
                                               int lane, int f0, int T_len, float a, float inv_b, float last,
                                               const Taps& tp, float (&act)[2 * LANE_F]) {
  float xw[LANE_F + 6];  // frames f0-3 .. f0+10
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    xw[k] = from_prev_lane(lane == 31 ? xpt[k] : xc[LANE_F - 3 + k], lane);
    xw[LANE_F + 3 + k] = from_next_lane(lane == 0 ? xn[k] : xc[k], lane);
  }
#pragma unroll
  for (int q = 0; q < LANE_F; ++q) xw[3 + q] = xc[q];
#pragma unroll
  for (int q = 0; q < LANE_F; ++q) {
    // xw[q + 3 + o] is frame f0 + q + o
    const float ye = tp.up[1] * xw[q + 5] + tp.up[3] * xw[q + 4] + tp.up[5] * xw[q + 3] + tp.up[7] * xw[q + 2] +
                     tp.up[9] * xw[q + 1] + tp.up[11] * xw[q];
    const float yo = tp.up[0] * xw[q + 6] + tp.up[2] * xw[q + 5] + tp.up[4] * xw[q + 4] + tp.up[6] * xw[q + 3] +
                     tp.up[8] * xw[q + 2] + tp.up[10] * xw[q + 1];
    act[2 * q] = snake<T, POLY_SIN>(ye, a, inv_b);
    act[2 * q + 1] = snake<T, POLY_SIN>(yo, a, inv_b);
  }
  if (f0 + LANE_F > T_len) {
#pragma unroll
    for (int e = 0; e < 2 * LANE_F; ++e) {
      if (2 * f0 + e > 2 * T_len - 1) act[e] = last;
    }
  }
}

// z[t] = sum_j dn[j] a[2t + j - 5] for the lane's 8 frames, from its own 16
// samples, the last 5 of the lane before and the first 5 of the lane after
// (around the chunk's ends: `before`, the last 5 samples the lane held of the
// chunk before; `after`, the first 5 of the chunk after).
__device__ __forceinline__ void filter_down(const float (&before)[5], const float (&act)[2 * LANE_F], const float (&after)[5],
                                            int lane, const Taps& tp, float (&z)[LANE_F]) {
  float w[2 * LANE_F + 10];  // samples 2 f0 - 5 .. 2 f0 + 20
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    w[k] = from_prev_lane(lane == 31 ? before[k] : act[2 * LANE_F - 5 + k], lane);
    w[2 * LANE_F + 5 + k] = from_next_lane(lane == 0 ? after[k] : act[k], lane);
  }
#pragma unroll
  for (int e = 0; e < 2 * LANE_F; ++e) w[5 + e] = act[e];
#pragma unroll
  for (int q = 0; q < LANE_F; ++q) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 12; ++j) s += tp.dn[j] * w[2 * q + j];
    z[q] = s;
  }
}

template <typename T, bool POLY_SIN>
__global__ void __launch_bounds__(THREADS, 2)
folded_aa_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ alpha,
                 const float* __restrict__ beta, int C, int T_len, int nrows, int chunks_per_seg, int segs_per_row,
                 int vec_ok, Taps tp) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int row = w / segs_per_row;
  if (row >= nrows) return;  // the whole warp: no barrier follows
  const int chunks_per_row = (T_len + CHUNK - 1) / CHUNK;
  const int k0 = (w - row * segs_per_row) * chunks_per_seg;
  const int k1 = min(k0 + chunks_per_seg, chunks_per_row);
  if (k0 >= k1) return;
  const T* xr = x + static_cast<size_t>(row) * T_len;
  T* zr = out + static_cast<size_t>(row) * T_len;
  const float a = alpha[row % C];
  const float inv_b = 1.0f / (beta[row % C] + 1e-9f);
  const bool vec = vec_ok != 0;
  const int last_m = 2 * T_len - 1;

  // Prologue, one sample a lane: lanes 0-4 the 5 samples before the segment,
  // a[2 k0 CHUNK - 5 ..], lanes 5-9 the 5 after it, a[2 k1 CHUNK ..], lane 10
  // the row's last sample; each clamped into the row, as the filter reads it.
  float edge;
  {
    int m = last_m;
    if (lane < 5) m = 2 * k0 * CHUNK - 5 + lane;
    else if (lane < 10) m = 2 * k1 * CHUNK + lane - 5;
    m = min(max(m, 0), last_m);
    const int i = m >> 1;
    float xs[7];  // frames i-3 .. i+3
#pragma unroll
    for (int q = 0; q < 7; ++q) xs[q] = to_f(xr[min(max(i - 3 + q, 0), T_len - 1)]);
    const float ye = tp.up[1] * xs[5] + tp.up[3] * xs[4] + tp.up[5] * xs[3] + tp.up[7] * xs[2] + tp.up[9] * xs[1] +
                     tp.up[11] * xs[0];
    const float yo = tp.up[0] * xs[6] + tp.up[2] * xs[5] + tp.up[4] * xs[4] + tp.up[6] * xs[3] + tp.up[8] * xs[2] +
                     tp.up[10] * xs[1];
    edge = snake<T, POLY_SIN>((m & 1) ? yo : ye, a, inv_b);
  }
  const float last = __shfl_sync(FULL, edge, 10);
  float before[5], after[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    before[k] = __shfl_sync(FULL, edge, k);
    after[k] = __shfl_sync(FULL, edge, 5 + k);
  }

  float xpt[3], xc[LANE_F], xn[LANE_F], act[2 * LANE_F], act_next[2 * LANE_F], z[LANE_F];
  {
    float xp[LANE_F];
    load8(xr, (k0 - 1) * CHUNK + lane * LANE_F, T_len, vec, xp);
#pragma unroll
    for (int k = 0; k < 3; ++k) xpt[k] = xp[LANE_F - 3 + k];
  }
  load8(xr, k0 * CHUNK + lane * LANE_F, T_len, vec, xc);
  load8(xr, (k0 + 1) * CHUNK + lane * LANE_F, T_len, vec, xn);
  activate_chunk<T, POLY_SIN>(xpt, xc, xn, lane, k0 * CHUNK + lane * LANE_F, T_len, a, inv_b, last, tp, act);

  // chunk j is activated while chunk j + 1 loads; chunk j - 1 is written
  for (int j = k0 + 1; j < k1; ++j) {
#pragma unroll
    for (int k = 0; k < 3; ++k) xpt[k] = xc[LANE_F - 3 + k];
#pragma unroll
    for (int q = 0; q < LANE_F; ++q) xc[q] = xn[q];
    load8(xr, (j + 1) * CHUNK + lane * LANE_F, T_len, vec, xn);
    const int f0 = j * CHUNK + lane * LANE_F;
    activate_chunk<T, POLY_SIN>(xpt, xc, xn, lane, f0, T_len, a, inv_b, last, tp, act_next);
    float head[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) head[k] = act_next[k];
    filter_down(before, act, head, lane, tp, z);
    store8(zr, f0 - CHUNK, T_len, vec, z);
#pragma unroll
    for (int k = 0; k < 5; ++k) before[k] = act[2 * LANE_F - 5 + k];
#pragma unroll
    for (int e = 0; e < 2 * LANE_F; ++e) act[e] = act_next[e];
  }
  filter_down(before, act, after, lane, tp, z);
  store8(zr, (k1 - 1) * CHUNK + lane * LANE_F, T_len, vec, z);
}

template <typename T>
int launch(const void* x, void* out, const float* a, const float* b, int C, int T_len, int nrows, bool poly,
           const Taps& tp, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // equal segments of each row, as many as keep the grid within one resident wave
  const int chunks_per_row = (T_len + CHUNK - 1) / CHUNK;
  const int wave = sms * WARPS_PER_SM;
  int segs = max(1, min(chunks_per_row, wave / nrows));
  const int chunks_per_seg = (chunks_per_row + segs - 1) / segs;
  segs = (chunks_per_row + chunks_per_seg - 1) / chunks_per_seg;
  const long long warps = static_cast<long long>(nrows) * segs;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int VEC = 16 / sizeof(T);
  const int vec_ok = T_len % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const T* xi = static_cast<const T*>(x);
  T* xo = static_cast<T*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (poly) {
    folded_aa_kernel<T, true><<<grid, THREADS, 0, s>>>(xi, xo, a, b, C, T_len, nrows, chunks_per_seg, segs, vec_ok, tp);
  } else {
    folded_aa_kernel<T, false><<<grid, THREADS, 0, s>>>(xi, xo, a, b, C, T_len, nrows, chunks_per_seg, segs, vec_ok, tp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: device pointers to [B, C, T]; alpha, beta: device float32 [C];
// dtype: 0 = float32, 1 = bfloat16; poly_sin: the polynomial sin instead of
// sinf; up, dn: host pointers to the 12 up taps (2 f) and the 12 down taps (f),
// already rounded to the I/O dtype; stream: the cudaStream_t to launch on.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel cannot take.
extern "C" int indextts_anti_alias_snake_folded(const void* x, void* out, const void* alpha, const void* beta, int B,
                                                int C, int T, int dtype, int poly_sin, const float* up,
                                                const float* dn, void* stream) {
  const long long nrows = static_cast<long long>(B) * C;
  if (B <= 0 || C <= 0 || T <= 0 || nrows > 0x7fffffffLL || T > 0x1fffffff || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps tp;
  for (int k = 0; k < 12; ++k) {
    tp.up[k] = up[k];
    tp.dn[k] = dn[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  const int n = static_cast<int>(nrows);
  if (dtype == 0) return launch<float>(x, out, a, b, C, T, n, poly_sin != 0, tp, s);
  return launch<__nv_bfloat16>(x, out, a, b, C, T, n, poly_sin != 0, tp, s);
}
