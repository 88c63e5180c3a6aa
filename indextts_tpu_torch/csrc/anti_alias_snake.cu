// K1: fused anti-aliased Snake / SnakeBeta for NVIDIA Hopper (sm_90a).
//
// Replaces indextts_tpu/ops/pallas/antialias.py:fused_anti_alias_snake, the
// Pallas TPU kernel. It computes the composed path of
// indextts_tpu_torch/ops/antialias.py:activation1d, edges included:
//   y[m] = 2 * sum_k f[k] * x[clamp((m + 15 - k) / 2 - 5, 0, T-1)]   (m + 15 - k even)
//   a[m] = y[m] + 1/(beta + 1e-9) * sin(alpha * y[m])^2
//   z[t] = sum_j f[j] * a[clamp(2t + j - 5, 0, 2T-1)]
// f is the 12-tap Kaiser-sinc low-pass (cutoff 0.25, half-width 0.3). The
// x-clamp is the upsampler's replicate pad; the 2x-rate clamp is the
// downsampler's replicate pad on the activated signal (the JAX kernel's
// exact_edges=True semantics, without its patch of the outer frames).
//
// Layout: x and out are [B, C, T], time contiguous (the vocoder trunk's
// layout). alpha and beta are [C] float32, already exponentiated for
// log-scale parameters. Math is float32; I/O is float32 or bf16. The sin is
// sinf for float32 I/O and, for bf16 I/O, the range-reduced degree-9
// polynomial of indextts_tpu/ops/activations.py:approx_sin (max abs error
// 3.6e-5, below bf16 resolution) -- the same choice as the plain path.
//
// Bound: bytes. Per element the best case reads x once and writes z once
// (2 passes of [B, C, T] with the same-shape output counted; the TPU kernel
// reads its input twice for the halo), against ~60 flops and two sins per
// output -- far under the card's operations-per-byte ridge. The 2x-rate
// signal never leaves the chip: one block stages TILE_T + 12 input frames of
// one (batch, channel) row in shared memory, computes the TILE_T*2 + 11
// activated 2x-rate samples it needs into shared memory, and writes TILE_T
// outputs once. The halo costs 12 / TILE_T extra reads. Loads and stores run
// along the contiguous time axis, so a warp touches consecutive addresses.
// Wider vector loads, TMA staging and several rows per block are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "approx_sin.cuh"

namespace {

constexpr int TILE_T = 512;                 // outputs per block
constexpr int THREADS = 256;
constexpr int HALO = 6;                     // input frames each side of a tile
constexpr int XS_LEN = TILE_T + 2 * HALO;   // staged input frames
constexpr int AS_LEN = 2 * TILE_T + 11;     // activated 2x-rate samples

struct Taps {
  float f[12];
};

__device__ __forceinline__ float load_f(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T, bool POLY_SIN>
__global__ void __launch_bounds__(THREADS)
anti_alias_snake_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const float* __restrict__ alpha, const float* __restrict__ beta,
                        int C, int T_len, Taps taps) {
  __shared__ float xs[XS_LEN];
  __shared__ float acts[AS_LEN];

  const int row = blockIdx.x;  // b * C + c
  const int c = row % C;
  const int t0 = blockIdx.y * TILE_T;
  const T* xr = x + static_cast<size_t>(row) * T_len;
  T* zr = out + static_cast<size_t>(row) * T_len;

  // input frames t0-6 .. t0+TILE_T+5, replicate-clamped
  for (int i = threadIdx.x; i < XS_LEN; i += THREADS) {
    const int g = min(max(t0 - HALO + i, 0), T_len - 1);
    xs[i] = load_f(xr, g);
  }
  __syncthreads();

  const float a = alpha[c];
  const float inv_b = 1.0f / (beta[c] + 1e-9f);
  const int last2 = 2 * T_len - 1;
  // activated 2x-rate samples m = 2*t0-5 .. 2*t0+2*TILE_T+5, clamped to the
  // signal; m's input neighbourhood starts HALO frames before the tile
  for (int j = threadIdx.x; j < AS_LEN; j += THREADS) {
    const int m = min(max(2 * t0 - 5 + j, 0), last2);
    const float* xb = xs + ((m >> 1) - (t0 - HALO));
    float y;
    if ((m & 1) == 0) {
      y = taps.f[1] * xb[2] + taps.f[3] * xb[1] + taps.f[5] * xb[0] + taps.f[7] * xb[-1] +
          taps.f[9] * xb[-2] + taps.f[11] * xb[-3];
    } else {
      y = taps.f[0] * xb[3] + taps.f[2] * xb[2] + taps.f[4] * xb[1] + taps.f[6] * xb[0] +
          taps.f[8] * xb[-1] + taps.f[10] * xb[-2];
    }
    y *= 2.0f;
    const float s = POLY_SIN ? poly_sin(y * a) : sinf(y * a);
    acts[j] = y + inv_b * (s * s);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TILE_T; i += THREADS) {
    const int t = t0 + i;
    if (t >= T_len) break;
    const float* ap = acts + 2 * i;
    float z = 0.0f;
#pragma unroll
    for (int k = 0; k < 12; ++k) z += taps.f[k] * ap[k];
    store_f(zr, t, z);
  }
}

}  // namespace

// x, out: device pointers to [B, C, T]; alpha, beta: device float32 [C];
// dtype: 0 = float32, 1 = bfloat16; taps: host pointer to the 12 filter taps;
// stream: the cudaStream_t to launch on. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int indextts_anti_alias_snake(const void* x, void* out, const void* alpha, const void* beta,
                                         int B, int C, int T, int dtype, const float* taps,
                                         void* stream) {
  const int tiles = (T + TILE_T - 1) / TILE_T;
  if (B <= 0 || C <= 0 || T <= 0 || tiles > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps tp;
  for (int k = 0; k < 12; ++k) tp.f[k] = taps[k];
  const dim3 grid(static_cast<unsigned>(B) * C, tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  if (dtype == 0) {
    anti_alias_snake_kernel<float, false><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), a, b, C, T, tp);
  } else {
    anti_alias_snake_kernel<__nv_bfloat16, true><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), a, b, C, T, tp);
  }
  return static_cast<int>(cudaGetLastError());
}
