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
// thousands of frames long. Bound: for bf16, 4 bytes against ~84 float32
// operations per element, within 5 % of each other (operations ahead); bytes
// for float32. The design is K1's (aa_lanes.cuh) with the rounding points
// above: a lane's 8 frames in registers, neighbours by warp shuffle, 16-byte
// loads and stores, no shared memory and no barrier. A long row is cut into
// independent chunks of 240 frames (each recomputes a 16-frame halo), and a
// warp takes a run of consecutive chunks, loading the next while it computes
// the current; the caller passes the SM count, from which the runs are sized
// so that the grid is about one resident wave of 32 warps per SM (K4's first
// design walked each row in one warp per segment, 16 warps per SM, behind a
// gathered prologue).

#include "aa_lanes.cuh"

namespace {

using aa_lanes::Taps;

template <typename T, bool POLY_SIN>
__global__ void __launch_bounds__(aa_lanes::THREADS, aa_lanes::MIN_BLOCKS)
folded_aa_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ alpha,
                 const float* __restrict__ beta, int C, int T_len, int nrows, int cpw, int segs, int vec_ok,
                 Taps taps) {
  aa_lanes::run<T, true, POLY_SIN>(x, out, alpha, beta, C, T_len, nrows, cpw, segs, vec_ok != 0, taps);
}

template <typename T>
int launch(const void* x, void* out, const float* a, const float* b, int C, int T_len, int nrows, bool poly, int sms,
           const Taps& tp, cudaStream_t s) {
  int cpw = 1, segs = 1;
  const long long blocks = aa_lanes::split(nrows, T_len, sms, cpw, segs);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_ok = aa_lanes::vectors_ok<T>(x, out, T_len);
  const T* xi = static_cast<const T*>(x);
  T* xo = static_cast<T*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (poly) {
    folded_aa_kernel<T, true><<<grid, aa_lanes::THREADS, 0, s>>>(xi, xo, a, b, C, T_len, nrows, cpw, segs, vec_ok, tp);
  } else {
    folded_aa_kernel<T, false><<<grid, aa_lanes::THREADS, 0, s>>>(xi, xo, a, b, C, T_len, nrows, cpw, segs, vec_ok, tp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: device pointers to [B, C, T]; alpha, beta: device float32 [C];
// dtype: 0 = float32, 1 = bfloat16; poly_sin: the polynomial sin instead of
// sinf; sms: the card's SM count (sizes the grid); up, dn: host pointers to
// the 12 up taps (2 f) and the 12 down taps (f), already rounded to the I/O
// dtype; stream: the cudaStream_t to launch on. Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for arguments
// the kernel cannot take.
extern "C" int indextts_anti_alias_snake_folded(const void* x, void* out, const void* alpha, const void* beta, int B,
                                                int C, int T, int dtype, int poly_sin, int sms, const float* up,
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
  if (dtype == 0) return launch<float>(x, out, a, b, C, T, n, poly_sin != 0, sms, tp, s);
  return launch<__nv_bfloat16>(x, out, a, b, C, T, n, poly_sin != 0, sms, tp, s);
}
