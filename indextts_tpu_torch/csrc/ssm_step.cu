// K7: one Mamba-2 decode step of one layer, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs no state-space layer. The
// hybrid decoder (models/granite.py) launches it once a Mamba layer a decode
// step. From the in_proj output of one token per row,
//   zx[b] = [z (DI) | x (DI), B (N), C (N) | dt (H)],   DI = H * P,
// it computes, for each row b and head h,
//   u_c   = silu(bias_c + sum_k w_ck win_ck)   win_c = [conv state of c, x_c]
//   dt    = softplus(dt_h + dt_bias_h),  da = exp(dt * A_h),  A_h = -exp(A_log_h)
//   S_pn  = da * S_pn + dt * x_p * B_n        the head's state S [P, N], float32
//   y_p   = sum_n S_pn C_n + D_h x_p
//   out   = y_p * silu(z_p)                   float32, [B, DI]
// and shifts each channel's conv state (the last K - 1 inputs, in the model's
// dtype) to hold x_c. Both states are read and written in place; the gated
// RMSNorm over all heads and out_proj follow in the caller.
//
// Bound: bytes. Each state element meets two multiply-adds: the least time
// is the float32 state read and written once (2 MiB each way a row at
// granite-4.0-h's 64 heads of 64 x 128), plus the conv state, the token's
// inputs and the output, over 3.35 TB/s (ops/cuda/ssm_step.ssm_step_bytes).
//
// Design:
//  * A block owns one (row, head): its 64 x 128 state is 32 KB, read once
//    with 16-byte streaming loads and written back the same way. Thread t of
//    256 takes the state row t / 32 + 8 i (i < 8) at float4 column t % 32, so
//    a warp load reads one state row whole (512 bytes); the eight loads of a
//    thread are issued before any is used. y_p is a shuffle sum over the
//    warp. At 32 slots that is 2,048 blocks.
//  * The convolution: the block convolves its head's 64 x channels, and
//    every block convolves B and C (256 channels, a few hundred multiply-adds,
//    from L2), into shared memory. A block owns its x channels' conv state and
//    shifts it; B's and C's is shared by the row's blocks, so it is shifted
//    by the row's last block to finish reading it: each block counts itself
//    in (a fence, then an atomic add on the row's counter) after its reads,
//    and the block that finds H - 1 before it writes the shifted window and
//    sets the counter back to zero for the next launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }
// torch.nn.functional.softplus with its threshold of 20
__device__ __forceinline__ float softplus(float x) { return x > 20.0f ? x : log1pf(expf(x)); }

// T: zx, the conv state and weights (float or bf16); P: head size; N: state size; K: conv width
template <typename T, int P, int N, int K>
__global__ void __launch_bounds__(THREADS)
    ssm_step_kernel(const T* __restrict__ zx, long long row_stride, T* conv_state, const T* __restrict__ conv_w,
                    const T* __restrict__ conv_b, const float* __restrict__ dt_bias, const float* __restrict__ a_neg,
                    const float* __restrict__ d_skip, float* __restrict__ state, float* __restrict__ out,
                    unsigned int* counter, int H) {
  constexpr int Q = N / 4;                          // float4 columns of a state row
  constexpr int ROWS = THREADS / Q;                 // state rows a pass covers
  constexpr int PASSES = (P + ROWS - 1) / ROWS;
  static_assert(N % 4 == 0 && Q <= 32 && 32 % Q == 0 && P % (32 / Q) == 0, "state shape");
  static_assert(2 * N <= THREADS && P <= THREADS, "one channel a thread");
  __shared__ float xs[P], zs[P], bs[N], cs[N];
  __shared__ float s_dt, s_da;
  __shared__ int s_last;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int DI = H * P, CD = DI + 2 * N;
  const T* row = zx + static_cast<size_t>(b) * row_stride;
  T* cst = conv_state + static_cast<size_t>(b) * CD * (K - 1);

  float nb[K - 1];  // B / C channel DI + tid: its shifted window, for the row's last block
  if (tid < 2 * N) {
    const int c = DI + tid;
    float win[K];
#pragma unroll
    for (int k = 0; k < K - 1; ++k) win[k] = to_f(cst[static_cast<size_t>(c) * (K - 1) + k]);
    win[K - 1] = to_f(row[DI + c]);
    float acc = to_f(conv_b[c]);
#pragma unroll
    for (int k = 0; k < K; ++k) acc = fmaf(to_f(conv_w[static_cast<size_t>(c) * K + k]), win[k], acc);
    if (tid < N) {
      bs[tid] = silu(acc);
    } else {
      cs[tid - N] = silu(acc);
    }
#pragma unroll
    for (int k = 0; k < K - 1; ++k) nb[k] = win[k + 1];
  }
  if (tid < P) {  // the head's own x channels: convolved, and their window shifted in place
    const int c = h * P + tid;
    float win[K];
#pragma unroll
    for (int k = 0; k < K - 1; ++k) win[k] = to_f(cst[static_cast<size_t>(c) * (K - 1) + k]);
    win[K - 1] = to_f(row[DI + c]);
    float acc = to_f(conv_b[c]);
#pragma unroll
    for (int k = 0; k < K; ++k) acc = fmaf(to_f(conv_w[static_cast<size_t>(c) * K + k]), win[k], acc);
    xs[tid] = silu(acc);
    zs[tid] = to_f(row[c]);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) store(&cst[static_cast<size_t>(c) * (K - 1) + k], win[k + 1]);
  }
  if (tid == 0) {
    const float dt = softplus(to_f(row[DI + CD + h]) + dt_bias[h]);
    s_dt = dt;
    s_da = expf(dt * a_neg[h]);
  }
  __syncthreads();
  if (tid == 0) {  // this block has read B's and C's conv state: count it in
    __threadfence();
    s_last = atomicAdd(&counter[b], 1u) == static_cast<unsigned>(H - 1);
  }

  const float dt = s_dt, da = s_da;
  const int q = tid % Q, r0 = tid / Q;
  const float4 B4 = make_float4(bs[4 * q], bs[4 * q + 1], bs[4 * q + 2], bs[4 * q + 3]);
  const float4 C4 = make_float4(cs[4 * q], cs[4 * q + 1], cs[4 * q + 2], cs[4 * q + 3]);
  float* sp = state + (static_cast<size_t>(b) * H + h) * P * N;
  const float dh = d_skip[h];
  float4 hv[PASSES];
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int p = r0 + i * ROWS;
    if (p < P) hv[i] = __ldcs(reinterpret_cast<const float4*>(sp + static_cast<size_t>(p) * N) + q);
  }
#pragma unroll
  for (int i = 0; i < PASSES; ++i) {
    const int p = r0 + i * ROWS;
    if (p < P) {  // uniform over a warp: a warp's lanes cover whole rows
      const float u = dt * xs[p];
      float4 v = hv[i];
      v.x = fmaf(da, v.x, u * B4.x);
      v.y = fmaf(da, v.y, u * B4.y);
      v.z = fmaf(da, v.z, u * B4.z);
      v.w = fmaf(da, v.w, u * B4.w);
      __stcs(reinterpret_cast<float4*>(sp + static_cast<size_t>(p) * N) + q, v);
      float y = fmaf(v.x, C4.x, fmaf(v.y, C4.y, fmaf(v.z, C4.z, v.w * C4.w)));
#pragma unroll
      for (int off = Q / 2; off > 0; off >>= 1) y += __shfl_xor_sync(FULL, y, off);
      if (q == 0) {
        y = fmaf(dh, xs[p], y);
        out[static_cast<size_t>(b) * DI + h * P + p] = y * silu(zs[p]);
      }
    }
  }

  __syncthreads();
  if (s_last) {  // every block of the row has read B's and C's conv state
    if (tid < 2 * N) {
#pragma unroll
      for (int k = 0; k < K - 1; ++k) store(&cst[static_cast<size_t>(DI + tid) * (K - 1) + k], nb[k]);
    }
    if (tid == 0) counter[b] = 0;
  }
}

template <typename T, int P, int N>
int launch(const void* zx, long long row_stride, void* conv_state, const void* conv_w, const void* conv_b,
           const void* dt_bias, const void* a_neg, const void* d_skip, void* state, void* out, void* counter, int B,
           int H, cudaStream_t s) {
  ssm_step_kernel<T, P, N, 4><<<dim3(H, B), THREADS, 0, s>>>(
      static_cast<const T*>(zx), row_stride, static_cast<T*>(conv_state), static_cast<const T*>(conv_w),
      static_cast<const T*>(conv_b), static_cast<const float*>(dt_bias), static_cast<const float*>(a_neg),
      static_cast<const float*>(d_skip), static_cast<float*>(state), static_cast<float*>(out),
      static_cast<unsigned int*>(counter), H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_shape(int P, int N, const void* zx, long long row_stride, void* conv_state, const void* conv_w,
             const void* conv_b, const void* dt_bias, const void* a_neg, const void* d_skip, void* state, void* out,
             void* counter, int B, int H, cudaStream_t s) {
  if (P == 64 && N == 128) {
    return launch<T, 64, 128>(zx, row_stride, conv_state, conv_w, conv_b, dt_bias, a_neg, d_skip, state, out,
                              counter, B, H, s);
  }
  if (P == 16 && N == 16) {
    return launch<T, 16, 16>(zx, row_stride, conv_state, conv_w, conv_b, dt_bias, a_neg, d_skip, state, out,
                             counter, B, H, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// zx: device [B, 2 H P + 2 N + H] rows row_stride elements apart (float32 or
// bf16: dtype 0 / 1); conv_state: device [B, H P + 2 N, K - 1] and conv_w
// [H P + 2 N, K], conv_b [H P + 2 N] in zx's dtype; dt_bias, a_neg (= -exp(A_log)),
// d_skip: device float32 [H]; state: device float32 [B, H, P, N], 16-byte
// aligned; out: device float32 [B, H P]; counter: device uint32 [>= B], zero.
// (P, N): (64, 128) (granite-4.0-h) or (16, 16) (the tiny test models); K: 4.
// stream: the cudaStream_t to launch on. Returns the launch's error (0 on success).
extern "C" int indextts_ssm_step(const void* zx, long long row_stride, void* conv_state, const void* conv_w,
                                 const void* conv_b, const void* dt_bias, const void* a_neg, const void* d_skip,
                                 void* state, void* out, void* counter, int B, int H, int P, int N, int K,
                                 int dtype, void* stream) {
  if (B <= 0 || H <= 0 || B > 65535 || K != 4 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return by_shape<float>(P, N, zx, row_stride, conv_state, conv_w, conv_b, dt_bias, a_neg, d_skip, state, out,
                           counter, B, H, s);
  }
  return by_shape<__nv_bfloat16>(P, N, zx, row_stride, conv_state, conv_w, conv_b, dt_bias, a_neg, d_skip, state,
                                 out, counter, B, H, s);
}
