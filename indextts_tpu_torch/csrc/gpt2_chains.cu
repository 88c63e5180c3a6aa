// K8: the GPT-2 block's residual adds and LayerNorms, for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these chains to XLA, which
// fuses them (indextts_tpu/models/gpt.py, the block's LayerNorms and residual
// adds). The port ran each as plain PyTorch, one small kernel an operation: a
// LayerNorm in 5 (ops/norms.layer_norm: three casts to float32, the norm, the
// cast back) after a bf16 residual add, so 12 launches a layer and ~290 of a
// decode step's ~690. One kernel takes their place (gelu_new, the block's
// third chain, is PyTorch's own tanh GELU on the card: one launch, the same
// float32 arithmetic, one rounding; ops/cuda/gpt2_chains.py):
//
//  * add_layer_norm: x [rows, D], an optional delta d [rows, D] (the output
//    of attn_proj or mlp_proj, its bias included), gamma and beta [D]:
//      x_new = round(x + d)                 (x when there is no d)
//      y     = round((x_new - mean) / sqrt(var + eps) * gamma + beta)
//    with the mean and the (biased) variance of the row of x_new. The sum is
//    rounded to the working dtype before its statistics are taken, as the
//    port's bf16 add then LayerNorm did, so x_new is that add's result bit for
//    bit. The statistics and y are computed in float64 and y is rounded once
//    (bf16: through a round-to-odd float, so the rounding is correct): y is
//    the LayerNorm of x_new correctly rounded, and no rounding of the plain
//    path (float32 statistics, then the cast) lies nearer the true value.
//    With float32 statistics the float32 instance read up to 2.0x the plain
//    path's error against float64 on the card. The float64 arithmetic costs
//    ~1.6 us a launch on an H100 (4.0 us own at 8 rows of 1,280 bf16). Each GPT-2 layer runs it twice (x + attn_proj(a)
//    into ln_2; x + mlp_proj(.) into the next layer's ln_1, or into ln_f
//    after the last layer), layer 0's ln_1 without d.
//
// Layout: row-major, contiguous, D a multiple of 8, every pointer on a 16-byte
// boundary; float32 or bf16 throughout (gamma and beta in the rows' dtype).
//
// Bound: bytes. A LayerNorm does ~8 float64 operations an element (~1 a byte
// of a bf16 row in and out; the card's float64 ridge is ~10), far under the
// ridge: the least time is x (and d) read, x_new and y written over 3.35
// TB/s. A decode step's rows are 1-32 of 1,280 bf16 values, 2.5-160 KB a
// launch: a few hundred nanoseconds of bytes, so the design is about one
// launch where there were 6, with every load of a row issued before the
// first is used.
//
// Design: a warp per row, four rows a block. Each lane loads its 16-byte
// vectors of x, d, gamma and beta (8 bf16 or 4 float32 values, vectors lane,
// lane + 32, ...; 5 a lane for 1,280 bf16) before it uses any, and keeps the
// row in registers: the mean from a warp shuffle sum, the variance as a
// second pass over the registers (no E[x^2] - mean^2 cancellation), then y,
// all three in float64. No shared memory, no __syncthreads. Rows wider than
// 16 vectors a lane take a loop over device memory instead (the row's sum
// written, read back for the variance and for y), the same arithmetic. It
// launches on the caller's stream, allocates nothing, and returns the
// launch's error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROW_WARPS = 4;  // rows a block of add_layer_norm
constexpr int ROW_THREADS = 32 * ROW_WARPS;
constexpr int MAX_NV = 16;  // 16-byte vectors a lane keeps in registers
constexpr int EARLY_NV = 8;  // up to this many, gamma and beta are loaded with x and d
constexpr unsigned FULL = 0xffffffffu;

// values of T in one 16-byte vector
template <typename T>
__host__ __device__ constexpr int per_vec() {
  return 16 / static_cast<int>(sizeof(T));
}

// the values of one 16-byte vector as float32 (exact)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// float32 values rounded to T (to nearest, ties to even) in one 16-byte vector
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  if constexpr (std::is_same<T, float>::value) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// v rounded to T and back to float32 (PyTorch's bf16 add: a float32 sum, rounded)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;  // the same value in every lane: each butterfly stage adds the same pair
}

// a float64 value rounded once to T (to nearest, ties to even): float32
// directly; bf16 through a float32 rounded to odd (toward zero, its last bit
// set when that was inexact), which a round to nearest then takes to the
// correctly rounded bf16
template <typename T>
__device__ __forceinline__ float round_once(double y) {
  if constexpr (std::is_same<T, float>::value) {
    return __double2float_rn(y);
  } else {
    const float f = __double2float_rz(y);
    return static_cast<double>(f) == y ? f : __uint_as_float(__float_as_uint(f) | 1u);
  }
}

// x_new = round(x + a) element by element over one vector, in place in v (float32)
template <typename T>
__device__ __forceinline__ void add_rounded(float* v, const uint4& a) {
  constexpr int E = per_vec<T>();
  float t[E];
  unpack<T>(a, t);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = round_to<T>(v[e] + t[e]);
}

// y of one vector: (v - mean) * rstd * gamma + beta in float64, rounded once to T
template <typename T>
__device__ __forceinline__ uint4 norm_vec(const float* v, const uint4& g, const uint4& b, double mean, double rstd) {
  constexpr int E = per_vec<T>();
  float gf[E], bf[E], o[E];
  unpack<T>(g, gf);
  unpack<T>(b, bf);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    o[e] = round_once<T>(fma((v[e] - mean) * rstd, static_cast<double>(gf[e]), static_cast<double>(bf[e])));
  }
  return pack<T>(o);
}

// NV: the 16-byte vectors a lane holds, at least ceil(D / (32 * E))
template <typename T, int NV>
__global__ void __launch_bounds__(ROW_THREADS)
    add_layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ d, T* __restrict__ x_out,
                          T* __restrict__ y, const T* __restrict__ gamma, const T* __restrict__ beta, long long rows,
                          int D, double eps) {
  constexpr int E = per_vec<T>();
  constexpr bool EARLY = NV <= EARLY_NV;
  const long long row = static_cast<long long>(blockIdx.x) * ROW_WARPS + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp
  const int lane = threadIdx.x & 31;
  const int nvec = D / E;
  const long long base = row * D;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const uint4* dr = d != nullptr ? reinterpret_cast<const uint4*>(d + base) : nullptr;
  const uint4* gr = reinterpret_cast<const uint4*>(gamma);
  const uint4* br = reinterpret_cast<const uint4*>(beta);

  // every load of the row before any is used
  uint4 rx[NV], rd[NV], rg[EARLY ? NV : 1], rb[EARLY ? NV : 1];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      rx[i] = xr[c];
      if (dr != nullptr) rd[i] = dr[c];
      if constexpr (EARLY) {
        rg[i] = gr[c];
        rb[i] = br[c];
      }
    }
  }

  float v[NV][E];
  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      unpack<T>(rx[i], v[i]);
      if (dr != nullptr) {
        add_rounded<T>(v[i], rd[i]);
        reinterpret_cast<uint4*>(x_out + base)[c] = pack<T>(v[i]);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sum += v[i][e];
    }
  }
  const double mean = warp_sum(sum) / D;
  double sq = 0.0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + 32 * i < nvec) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const double t = v[i][e] - mean;
        sq = fma(t, t, sq);
      }
    }
  }
  const double rstd = 1.0 / sqrt(warp_sum(sq) / D + eps);
  uint4* yr = reinterpret_cast<uint4*>(y + base);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + 32 * i;
    if (c < nvec) {
      if constexpr (EARLY) {
        yr[c] = norm_vec<T>(v[i], rg[i], rb[i], mean, rstd);
      } else {
        yr[c] = norm_vec<T>(v[i], gr[c], br[c], mean, rstd);
      }
    }
  }
}

// rows wider than MAX_NV vectors a lane: the same arithmetic, the row re-read
// from device memory (the sum as written, so the statistics see the rounded
// values); each lane re-reads only the vectors it wrote
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
    add_layer_norm_wide_kernel(const T* x, const T* d, T* x_out, T* y, const T* __restrict__ gamma,
                               const T* __restrict__ beta, long long rows, int D, double eps) {
  constexpr int E = per_vec<T>();
  const long long row = static_cast<long long>(blockIdx.x) * ROW_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int nvec = D / E;
  const long long base = row * D;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const uint4* dr = d != nullptr ? reinterpret_cast<const uint4*>(d + base) : nullptr;
  const uint4* src = reinterpret_cast<const uint4*>((dr != nullptr ? x_out : x) + base);
  double sum = 0.0;
  for (int c = lane; c < nvec; c += 32) {
    float v[E];
    unpack<T>(xr[c], v);
    if (dr != nullptr) {
      add_rounded<T>(v, dr[c]);
      reinterpret_cast<uint4*>(x_out + base)[c] = pack<T>(v);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sum += v[e];
  }
  const double mean = warp_sum(sum) / D;
  double sq = 0.0;
  for (int c = lane; c < nvec; c += 32) {
    float v[E];
    unpack<T>(src[c], v);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const double t = v[e] - mean;
      sq = fma(t, t, sq);
    }
  }
  const double rstd = 1.0 / sqrt(warp_sum(sq) / D + eps);
  for (int c = lane; c < nvec; c += 32) {
    float v[E];
    unpack<T>(src[c], v);
    reinterpret_cast<uint4*>(y + base)[c] = norm_vec<T>(v, reinterpret_cast<const uint4*>(gamma)[c],
                                                        reinterpret_cast<const uint4*>(beta)[c], mean, rstd);
  }
}

template <typename T, int NV>
cudaError_t launch_rows(const void* x, const void* d, void* x_out, void* y, const void* gamma, const void* beta,
                        long long rows, int D, double eps, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((rows + ROW_WARPS - 1) / ROW_WARPS);
  add_layer_norm_kernel<T, NV><<<blocks, ROW_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(d), static_cast<T*>(x_out), static_cast<T*>(y),
      static_cast<const T*>(gamma), static_cast<const T*>(beta), rows, D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t add_layer_norm(const void* x, const void* d, void* x_out, void* y, const void* gamma, const void* beta,
                           long long rows, int D, double eps, cudaStream_t s) {
  const int lanes_vecs = (D / per_vec<T>() + 31) / 32;  // vectors a lane holds
#define ADD_LN_CASE(N) \
  if (lanes_vecs <= N) return launch_rows<T, N>(x, d, x_out, y, gamma, beta, rows, D, eps, s);
  ADD_LN_CASE(1)
  ADD_LN_CASE(2)
  ADD_LN_CASE(3)
  ADD_LN_CASE(4)
  ADD_LN_CASE(5)
  ADD_LN_CASE(6)
  ADD_LN_CASE(8)
  ADD_LN_CASE(10)
  ADD_LN_CASE(12)
  ADD_LN_CASE(MAX_NV)
#undef ADD_LN_CASE
  const unsigned blocks = static_cast<unsigned>((rows + ROW_WARPS - 1) / ROW_WARPS);
  add_layer_norm_wide_kernel<T><<<blocks, ROW_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(d), static_cast<T*>(x_out), static_cast<T*>(y),
      static_cast<const T*>(gamma), static_cast<const T*>(beta), rows, D, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: device [rows, D]; d: device [rows, D] or null (then x_out is not
// written: x_new is x); x_out: device [rows, D] (d given); gamma, beta: device
// [D]; all of one dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte
// aligned; D a multiple of 8. eps: the LayerNorm's. stream: the cudaStream_t
// to launch on. Returns the launch's error (0 on success).
extern "C" int indextts_add_layer_norm(const void* x, const void* d, void* x_out, void* y, const void* gamma,
                                       const void* beta, long long rows, int D, double eps, int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || D % 8 != 0 || (rows + ROW_WARPS - 1) / ROW_WARPS > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1) || (d != nullptr && x_out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 0 ? add_layer_norm<float>(x, d, x_out, y, gamma, beta, rows, D, eps, s)
                                   : add_layer_norm<__nv_bfloat16>(x, d, x_out, y, gamma, beta, rows, D, eps, s);
  return static_cast<int>(e);
}
