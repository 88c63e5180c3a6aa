// The lane scheme that K1 (anti_alias_snake.cu) and K4
// (anti_alias_snake_folded.cu) share: the anti-aliased Snake / SnakeBeta of
// one [B, C, T] row computed in registers, a warp at a time.
//
//   y[m] = sum_k up[k] * x[clamp((m + 15 - k) / 2 - 5, 0, T-1)]   (m + 15 - k even)
//   a[m] = R(y[m] + 1/(beta + 1e-9) * sin(alpha * y[m])^2)
//   z[t] = sum_j dn[j] * a[clamp(2t + j - 5, 0, 2T-1)]
//
// up = 2 f and dn = f are the 12-tap Kaiser-sinc filters as the caller gives
// them (K4 rounds them to x's dtype, K1 does not); R rounds the activated
// 2x-rate samples to x's dtype when ROUND is set (K4 in bf16) and is the
// identity otherwise; the sums and the snake are float32.
//
// Geometry. A lane holds LANE_F = 8 consecutive frames, loaded as one
// 16-byte vector in bf16 (two in float32); a warp holds a window of 256
// frames. It computes the 16 activated samples of each lane's frames
// without a branch (both phases every lane), taking the 3 frames it needs
// from each neighbour lane by __shfl_sync; then it filters down from
// registers, taking 5 samples from each neighbour lane, and stores 16 bytes
// a lane. Lanes 0 and 31 hold the window's halo: their outputs would need
// the lanes beyond the warp, so only lanes 1-30 store, and a warp's chunk is
// CHUNK = 240 output frames. Consecutive chunks' windows overlap by 16
// frames; each chunk is independent of the others (no carried state, no
// serial chain, no shared memory, no block barrier). What lanes 0 and 31
// read around the warp (lane 0 from lane 31 and back) reaches none of the
// samples the storing lanes use.
//
// The row's ends. Frames outside the row are loaded clamped, which is the
// upsampler's replicate pad. The 2x-rate clamp is applied to the activated
// samples: in a row's first chunk lane 0's samples (m < 0) all take a[0],
// lane 1's first; in a chunk whose window passes the row's end, samples m >
// 2T - 1 take a[2T - 1] from the lane that holds frame T - 1. Both branches
// are uniform across the warp.
//
// Work split. A warp takes `cpw` consecutive chunks of one row, loading the
// next chunk's frames while it computes the current one; the host picks cpw
// from the card's SM count so that the grid is about one resident wave
// (RESIDENT_WARPS warps on each SM).
//
// copy() is the same geometry, loads and stores with no arithmetic (out =
// x): the floor the activation bodies are read against (K3's ident body).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "approx_sin.cuh"

namespace aa_lanes {

constexpr int LANE_F = 8;                   // frames a lane holds
constexpr int WINDOW = 32 * LANE_F;         // frames a warp holds
constexpr int CHUNK = WINDOW - 2 * LANE_F;  // output frames a warp stores: lanes 1-30
constexpr int WARPS = 4;                    // warps per block; they share nothing
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 8;               // resident blocks an SM must hold: <= 64 registers a thread
constexpr int RESIDENT_WARPS = WARPS * MIN_BLOCKS;
constexpr unsigned FULL = 0xffffffffu;

struct Taps {
  float up[12];  // 2 f
  float dn[12];  // f
};

template <typename T, bool ROUND>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (ROUND && sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16(v));
  } else {
    return v;
  }
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

// z to frames f0 .. f0+7 of a row, those inside it
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

template <typename T, bool ROUND, bool POLY_SIN>
__device__ __forceinline__ float snake(float y, float a, float inv_b) {
  const float s = POLY_SIN ? poly_sin(y * a) : sinf(y * a);
  return round_to<T, ROUND>(y + inv_b * (s * s));
}

// One chunk: the warp's window holds frames c0 - 8 .. c0 + 247 of the row,
// lane l frames f0 = c0 - 8 + 8 l .. f0 + 7 in xc; lanes 1-30 store outputs
// c0 .. c0 + 239 to zr.
template <typename T, bool ROUND, bool POLY_SIN>
__device__ __forceinline__ void chunk(const float (&xc)[LANE_F], int lane, int c0, int T_len, float a, float inv_b,
                                      const Taps& tp, T* __restrict__ zr, bool vec_ok) {
  const int f0 = c0 - LANE_F + lane * LANE_F;
  const int prev = (lane + 31) & 31, next = (lane + 1) & 31;

  // frames f0 - 3 .. f0 + 10: 3 from the lane before, 8 own, 3 from the lane after
  float xw[LANE_F + 6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    xw[k] = __shfl_sync(FULL, xc[LANE_F - 3 + k], prev);
    xw[LANE_F + 3 + k] = __shfl_sync(FULL, xc[k], next);
  }
#pragma unroll
  for (int q = 0; q < LANE_F; ++q) xw[3 + q] = xc[q];

  // the activated samples a[2 f0 .. 2 f0 + 15]; xw[q + 3 + o] is frame f0 + q + o
  float act[2 * LANE_F];
#pragma unroll
  for (int q = 0; q < LANE_F; ++q) {
    const float ye = tp.up[1] * xw[q + 5] + tp.up[3] * xw[q + 4] + tp.up[5] * xw[q + 3] + tp.up[7] * xw[q + 2] +
                     tp.up[9] * xw[q + 1] + tp.up[11] * xw[q];
    const float yo = tp.up[0] * xw[q + 6] + tp.up[2] * xw[q + 5] + tp.up[4] * xw[q + 4] + tp.up[6] * xw[q + 3] +
                     tp.up[8] * xw[q + 2] + tp.up[10] * xw[q + 1];
    act[2 * q] = snake<T, ROUND, POLY_SIN>(ye, a, inv_b);
    act[2 * q + 1] = snake<T, ROUND, POLY_SIN>(yo, a, inv_b);
  }

  // the 2x-rate clamp at the row's ends
  if (c0 == 0) {  // lane 0 holds frames -8 .. -1: its samples are a[0], lane 1's first
    const float a0 = __shfl_sync(FULL, act[0], 1);
    if (lane == 0) {
#pragma unroll
      for (int e = 0; e < 2 * LANE_F; ++e) act[e] = a0;
    }
  }
  if (c0 + WINDOW - LANE_F > T_len) {  // the window passes frame T - 1: later samples are a[2T - 1]
    const int rel = T_len - 1 - (c0 - LANE_F);  // frame T - 1 in the window, 8 .. 255
    const int e_last = 2 * (rel & (LANE_F - 1)) + 1;
    float mine = act[0];
#pragma unroll
    for (int e = 1; e < 2 * LANE_F; e += 2) {
      if (e == e_last) mine = act[e];
    }
    const float last = __shfl_sync(FULL, mine, rel >> 3);
#pragma unroll
    for (int e = 0; e < 2 * LANE_F; ++e) {
      if (2 * f0 + e > 2 * T_len - 1) act[e] = last;
    }
  }

  // z[t] = sum_j dn[j] a[2t + j - 5]: w holds samples 2 f0 - 5 .. 2 f0 + 20, 5
  // from the lane before, 16 own, 5 from the lane after
  float w[2 * LANE_F + 10];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    w[k] = __shfl_sync(FULL, act[2 * LANE_F - 5 + k], prev);
    w[2 * LANE_F + 5 + k] = __shfl_sync(FULL, act[k], next);
  }
#pragma unroll
  for (int e = 0; e < 2 * LANE_F; ++e) w[5 + e] = act[e];
  float z[LANE_F];
#pragma unroll
  for (int q = 0; q < LANE_F; ++q) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 12; ++j) s += tp.dn[j] * w[2 * q + j];
    z[q] = s;
  }
  if (lane != 0 && lane != 31) store8(zr, f0, T_len, vec_ok, z);
}

// The kernel body: warp w takes chunks k0 .. k0 + cpw - 1 of row w / segs.
template <typename T, bool ROUND, bool POLY_SIN>
__device__ __forceinline__ void run(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ alpha,
                                    const float* __restrict__ beta, int C, int T_len, int nrows, int cpw, int segs,
                                    bool vec_ok, const Taps& tp) {
  const int lane = threadIdx.x & 31;
  const long long w = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const long long row = w / segs;
  if (row >= nrows) return;  // the whole warp: no shuffle follows
  const int chunks = (T_len + CHUNK - 1) / CHUNK;
  const int k0 = static_cast<int>(w - row * segs) * cpw;
  const int k1 = min(k0 + cpw, chunks);
  if (k0 >= k1) return;
  const T* xr = x + row * T_len;
  T* zr = out + row * T_len;
  const int c = static_cast<int>(row % C);
  const float a = alpha[c];
  const float inv_b = 1.0f / (beta[c] + 1e-9f);

  float xc[LANE_F], xn[LANE_F];
  load8(xr, k0 * CHUNK - LANE_F + lane * LANE_F, T_len, vec_ok, xc);
  for (int j = k0; j < k1; ++j) {
    if (j + 1 < k1) load8(xr, (j + 1) * CHUNK - LANE_F + lane * LANE_F, T_len, vec_ok, xn);
    chunk<T, ROUND, POLY_SIN>(xc, lane, j * CHUNK, T_len, a, inv_b, tp, zr, vec_ok);
#pragma unroll
    for (int q = 0; q < LANE_F; ++q) xc[q] = xn[q];
  }
}

// The pass-through: run's geometry (warp w takes chunks k0 .. k0 + cpw - 1 of
// row w / segs; every lane loads its 8 frames, lanes 1-30 store them), with
// no arithmetic: out = x.
template <typename T>
__device__ __forceinline__ void copy(const T* __restrict__ x, T* __restrict__ out, int T_len, int nrows, int cpw,
                                     int segs, bool vec_ok) {
  const int lane = threadIdx.x & 31;
  const long long w = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const long long row = w / segs;
  if (row >= nrows) return;
  const int chunks = (T_len + CHUNK - 1) / CHUNK;
  const int k0 = static_cast<int>(w - row * segs) * cpw;
  const int k1 = min(k0 + cpw, chunks);
  const T* xr = x + row * T_len;
  T* zr = out + row * T_len;
  float xc[LANE_F], xn[LANE_F];
  load8(xr, k0 * CHUNK - LANE_F + lane * LANE_F, T_len, vec_ok, xc);
  for (int j = k0; j < k1; ++j) {
    if (j + 1 < k1) load8(xr, (j + 1) * CHUNK - LANE_F + lane * LANE_F, T_len, vec_ok, xn);
    if (lane != 0 && lane != 31) store8(zr, j * CHUNK - LANE_F + lane * LANE_F, T_len, vec_ok, xc);
#pragma unroll
    for (int q = 0; q < LANE_F; ++q) xc[q] = xn[q];
  }
}

// The work split of `nrows` rows of `units` work units each (chunks, here)
// over a wave of `wave` resident warps, `warps` to a block: units per warp
// (cpw) and warps per row (segs), so that nrows * segs warps are about one
// resident wave. The least cpw that spreads the units over one wave can
// overshoot it by a few warps per row (B = 4 at 384 x 6400: 4608 warps for a
// wave of 4224), and the blocks past the wave then run a whole run of units
// on an almost empty card; so the split takes, of that cpw and the least one
// that fits every row into one wave, the one with fewer rounds (waves x
// cpw). Returns the number of blocks, or -1 if it is too many.
inline long long split_units(long long nrows, long long units, long long wave, int warps, int& cpw, int& segs) {
  const long long total = nrows * units;
  long long c = std::min(units, std::max(1LL, (total + wave - 1) / wave));
  const long long waves = (nrows * ((units + c - 1) / c) + wave - 1) / wave;
  const long long fit = wave / std::max(nrows, 1LL);  // warps a row may have in one wave
  if (waves > 1 && fit >= 1 && (units + fit - 1) / fit < waves * c) c = (units + fit - 1) / fit;
  cpw = static_cast<int>(c);
  segs = static_cast<int>((units + cpw - 1) / cpw);
  const long long blocks = (nrows * segs + warps - 1) / warps;
  return blocks > 0x7fffffffLL ? -1 : blocks;
}

// The lane scheme's split: rows of T_len frames in chunks, on `sms` SMs.
inline long long split(int nrows, int T_len, int sms, int& cpw, int& segs) {
  return split_units(nrows, (T_len + CHUNK - 1) / CHUNK, static_cast<long long>(std::max(sms, 1)) * RESIDENT_WARPS,
                     WARPS, cpw, segs);
}

// 16-byte vectors are safe when every row starts on a 16-byte boundary
template <typename T>
inline bool vectors_ok(const void* x, const void* out, int T_len) {
  constexpr int VEC = 16 / sizeof(T);
  return T_len % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace aa_lanes
