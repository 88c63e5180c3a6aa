// K5: int8-weight matmul (W8A16) for NVIDIA Hopper (sm_90a).
//
// Replaces indextts_tpu/ops/pallas/qmatmul.py:int8_matmul, the Pallas TPU
// kernel. It computes exactly that kernel's function:
//   y[m, n] = (sum_k bf16(x[m, k]) * wq[n, k]) * scale[n]     (f32 sum)
//   out[m, n] = T(T(y[m, n]) + T(bias[n]))                     (T = x's dtype)
// x is rounded to bf16 even when it is float32 (qmatmul.py:34); every
// product of a bf16 and an int8 is exact in f32, so only the order of the sum
// differs from the plain version (ops/cuda/qmatmul.py:int8_matmul_plain).
//
// Layout: x [M, K] row-major, float32 or bf16; wq [N, K] int8 row-major (one
// output channel per row, torch Linear's layout); scale [N] float32; bias [N]
// in x's dtype or absent; out [M, N] in x's dtype.
//
// Bound: bytes. M is the decode batch (1-16), so each weight byte meets at
// most M multiply-adds: far under the card's operations-per-byte ridge, and
// the int8 weights (N * K bytes) are nearly all the traffic. Design: one warp
// per output channel n, eight warps per block. A warp walks its weight row
// along K with 16-byte loads (lane l reads bytes 16l.. of each 512-byte
// step, so a warp's loads are consecutive), converts the 16 int8 to float in
// registers, and multiplies them against the block's M rows of bf16(x),
// staged once per block in shared memory in chunks of KC columns. A warp
// shuffle reduces the 32 partial sums; lane 0 scales, casts, adds the bias
// and stores. N / 8 blocks (160 for N = 1280, 1025 for N = 8194) fill the
// card without split-K. Rows of 8 x rows share a block; larger M takes more
// blocks along y. Rows whose K is not a multiple of 16 (or a weight not
// 16-byte aligned) take a scalar path with one byte per lane.
// wgmma / TMA, a persistent grid and split-K for short N are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;               // output channels per block
constexpr int THREADS = WARPS * 32;
constexpr int MT = 8;                  // x rows per block
constexpr int KC = 2048;               // x columns staged per pass (32 KB of bf16)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// the two bf16 of a 32-bit word, low half first (little-endian: element k)
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
// byte j of a 32-bit word as a signed int8, in float
__device__ __forceinline__ float i8(uint32_t u, int j) {
  return static_cast<float>(static_cast<int32_t>(u << (24 - 8 * j)) >> 24);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ scale,
                   const T* __restrict__ bias, T* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 xs[MT][KC];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + warp;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int8_t* wrow = wq + static_cast<size_t>(n < N ? n : 0) * K;

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < rows * kc; i += THREADS) {
      const int m = i / kc;
      const int k = i - m * kc;
      xs[m][k] = __float2bfloat16(to_f(x[static_cast<size_t>(m0 + m) * K + k0 + k]));
    }
    __syncthreads();
    if (n < N) {
      if (VEC) {
#pragma unroll 4
        for (int k = lane * 16; k < kc; k += 32 * 16) {
          const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wrow + k0 + k));
          const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
          float w[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) w[j] = i8(ww[j >> 2], j & 3);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < rows) {
              const uint4* xp = reinterpret_cast<const uint4*>(&xs[m][k]);
              const uint4 a = xp[0];
              const uint4 b = xp[1];
              const uint32_t xx[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
              float s = acc[m];
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                s = fmaf(bf_lo(xx[j]), w[2 * j], s);
                s = fmaf(bf_hi(xx[j]), w[2 * j + 1], s);
              }
              acc[m] = s;
            }
          }
        }
      } else {
        for (int k = lane; k < kc; k += 32) {
          const float w = static_cast<float>(wrow[k0 + k]);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < rows) acc[m] = fmaf(__bfloat162float(xs[m][k]), w, acc[m]);
          }
        }
      }
    }
  }
  if (n >= N) return;  // after the last barrier

#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  }
  if (lane == 0) {
    const float s = scale[n];
    const float b = bias != nullptr ? to_f(bias[n]) : 0.0f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < rows) {
        float o = round_as(acc[m] * s, x);
        if (bias != nullptr) o = o + b;
        store_f(out + static_cast<size_t>(m0 + m) * N + n, o);
      }
    }
  }
}

template <typename T>
void launch(const void* x, const void* wq, const void* scale, const void* bias, void* out, int M, int N, int K,
            bool vec, cudaStream_t s) {
  const dim3 grid((N + WARPS - 1) / WARPS, (M + MT - 1) / MT);
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wq);
  const float* sp = static_cast<const float*>(scale);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  if (vec) {
    int8_matmul_kernel<T, true><<<grid, THREADS, 0, s>>>(xp, wp, sp, bp, op, M, N, K);
  } else {
    int8_matmul_kernel<T, false><<<grid, THREADS, 0, s>>>(xp, wp, sp, bp, op, M, N, K);
  }
}

}  // namespace

// x: device [M, K]; wq: device int8 [N, K]; scale: device float32 [N]; bias:
// device [N] in x's dtype, or null; out: device [M, N]. dtype: 0 = float32,
// 1 = bfloat16 (x, bias and out). stream: the cudaStream_t to launch on.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int indextts_int8_matmul(const void* x, const void* wq, const void* scale, const void* bias, void* out,
                                    int M, int N, int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + MT - 1) / MT > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, wq, scale, bias, out, M, N, K, vec, s);
  } else {
    launch<__nv_bfloat16>(x, wq, scale, bias, out, M, N, K, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
