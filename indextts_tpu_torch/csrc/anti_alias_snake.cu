// K1: fused anti-aliased Snake / SnakeBeta for NVIDIA Hopper (sm_90a).
//
// Replaces indextts_tpu/ops/pallas/antialias.py:fused_anti_alias_snake, the
// Pallas TPU kernel. It computes the composed path of
// indextts_tpu_torch/ops/antialias.py:activation1d, edges included:
//   y[m] = 2 * sum_k f[k] * x[clamp((m + 15 - k) / 2 - 5, 0, T-1)]   (m + 15 - k even)
//   a[m] = y[m] + 1/(beta + 1e-9) * sin(alpha * y[m])^2
//   z[t] = sum_j f[j] * a[clamp(2t + j - 5, 0, 2T-1)]
// f is the 12-tap Kaiser-sinc low-pass (cutoff 0.25, half-width 0.3), in
// float32; the 2x-rate samples are not rounded. The x-clamp is the
// upsampler's replicate pad; the 2x-rate clamp is the downsampler's replicate
// pad on the activated signal (the JAX kernel's exact_edges=True semantics,
// without its patch of the outer frames).
//
// Layout: x and out are [B, C, T], time contiguous (the vocoder trunk's
// layout). alpha and beta are [C] float32, already exponentiated for
// log-scale parameters. Math is float32; I/O is float32 or bf16. The sin is
// sinf for float32 I/O and, for bf16 I/O, the range-reduced degree-9
// polynomial of indextts_tpu/ops/activations.py:approx_sin (max abs error
// 3.6e-5, below bf16 resolution) -- the same choice as the plain path.
//
// Bound: per output element 4 bytes move in bf16 (x read once, z written
// once) against 84 float32 operations (two 2x-rate samples x (12 for the up
// taps + 18 for the snake) + 24 for the down taps): at the card's 67 TFLOP/s
// and 3.35 TB/s that is operations for bf16, within 5 % of the bytes; float32
// moves 8 bytes an element and is bound by bytes. So the design spends no
// instruction it can avoid: the lane scheme of aa_lanes.cuh keeps the 2x-rate
// signal in registers (a lane's 8 frames arrive as one 16-byte load, its 16
// samples are computed without a branch, neighbours' frames and samples come
// by warp shuffle, the outputs leave as one 16-byte store), with no shared
// memory, no block barrier and every filter tap a constant-bank operand. The
// halo a chunk recomputes is 16 of 256 frames. The grid is about one
// resident wave, sized from the SM count the caller passes.

#include "aa_lanes.cuh"

namespace {

using aa_lanes::Taps;

template <typename T, bool POLY_SIN>
__global__ void __launch_bounds__(aa_lanes::THREADS, aa_lanes::MIN_BLOCKS)
anti_alias_snake_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ alpha,
                        const float* __restrict__ beta, int C, int T_len, int nrows, int cpw, int segs, int vec_ok,
                        Taps taps) {
  aa_lanes::run<T, false, POLY_SIN>(x, out, alpha, beta, C, T_len, nrows, cpw, segs, vec_ok != 0, taps);
}

template <typename T, bool POLY_SIN>
int launch(const void* x, void* out, const float* a, const float* b, int C, int T_len, int nrows, int sms,
           const Taps& tp, cudaStream_t s) {
  int cpw = 1, segs = 1;
  const long long blocks = aa_lanes::split(nrows, T_len, sms, cpw, segs);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_ok = aa_lanes::vectors_ok<T>(x, out, T_len);
  anti_alias_snake_kernel<T, POLY_SIN><<<static_cast<unsigned>(blocks), aa_lanes::THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), a, b, C, T_len, nrows, cpw, segs, vec_ok, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: device pointers to [B, C, T]; alpha, beta: device float32 [C];
// dtype: 0 = float32, 1 = bfloat16; sms: the card's SM count (sizes the
// grid); taps: host pointer to the 12 filter taps f; stream: the
// cudaStream_t to launch on. Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for arguments the kernel cannot take.
extern "C" int indextts_anti_alias_snake(const void* x, void* out, const void* alpha, const void* beta, int B, int C,
                                         int T, int dtype, int sms, const float* taps, void* stream) {
  const long long nrows = static_cast<long long>(B) * C;
  if (B <= 0 || C <= 0 || T <= 0 || nrows > 0x7fffffffLL || T > 0x1fffffff || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps tp;
  for (int k = 0; k < 12; ++k) {
    tp.up[k] = 2.0f * taps[k];
    tp.dn[k] = taps[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  const int n = static_cast<int>(nrows);
  if (dtype == 0) return launch<float, false>(x, out, a, b, C, T, n, sms, tp, s);
  return launch<__nv_bfloat16, true>(x, out, a, b, C, T, n, sms, tp, s);
}
