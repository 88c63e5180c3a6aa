// K2: the anti-aliased Snake / SnakeBeta followed by a dilated Conv1d + bias,
// fused, for NVIDIA Hopper (sm_90a). One AMPBlock1 half-branch:
//   out = conv1d(activation1d(x), w, bias, padding = (k*d - d) / 2, dilation = d)
//
// Replaces indextts_tpu/ops/pallas/aa_conv_branch.py:fused_aa_snake_dconv_tmajor,
// the Pallas TPU kernel. The activation is K1's (csrc/anti_alias_snake.cu),
// computed the same way with the same two clamped index spaces, so inside
// [0, T) it equals the composed path; frames outside [0, T) are zero, the
// conv's zero padding. The output therefore equals the composed oracle at
// every frame and the JAX kernel's edge patch has no counterpart here.
//
// Layout: x and out [B, C, T] (time contiguous, the vocoder trunk's layout);
// wt [k, C, C], tap-major (torch's Conv1d weight [Cout, Cin, k] permuted by
// the wrapper, so each (tap, output channel) row of a 32-channel chunk is 64
// contiguous bytes); bias [C];
// alpha and beta [C] float32, already exponentiated for log-scale
// parameters. I/O is float32 or bf16, in one dtype for x, w, bias and out.
//
// Bound: operations. The conv is 2 k C^2 flops per frame (k = 11 at C = 768:
// 13,000 flops per output byte pair), far above the card's ridge, so it runs
// on the tensor cores: mma.sync m16n8k16, bf16 in, float32 accumulate. One
// block computes a 64-channel x 128-frame output tile of one batch row. Per
// chunk of 32 input channels it
//   1. starts the weight slice ws[j][co][ci] on its way into shared memory
//      (16-byte cp.async copies for bf16, landing while steps 1-3 run), and
//      stages the x rows, frames t0 - h - 6 .. t0 + 128 + h + 5 (replicate-
//      clamped), in shared memory as float32, one warp to a channel row;
//   2. computes the activated 2x-rate samples there (one sin each; the bf16
//      path uses the JAX package's approx_sin polynomial, float32 sinf);
//   3. downsamples into a time-major tile act[t][ci] of 128 + 2h rows,
//      rounded to x's dtype as the composed path rounds it;
//   4. runs the k taps: tap j is the same activation tile shifted by j*d
//      rows, so each B fragment is an ldmatrix of 16-byte rows at any row
//      offset and no per-tap copy exists.
// Eight warps each own a 32 x 32 output tile (2 x 4 mma tiles, 32 float
// accumulators a thread). The epilogue stages the tile through shared memory,
// adds the bias in float32 and writes rows along time.
//
// The activation is recomputed for each 64-channel output tile (C / 64
// times), since CUDA blocks have no sequential grid axis to carry it in; it
// costs ~60 flops a (channel, frame) on the CUDA cores against 2 k 64 on the
// tensor cores. float32 I/O takes the same staging and runs the conv on the
// CUDA cores in float32 (a plain FMA loop): it is for tests, not speed.
// wgmma, TMA, staging pipelined across chunks and larger output tiles are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "approx_sin.cuh"

namespace {

constexpr int TILE_T = 128;   // output frames per block
constexpr int TILE_CO = 64;   // output channels per block
constexpr int CK = 32;        // input channels per staged chunk
constexpr int THREADS = 256;  // 8 warps: 2 along channels x 4 along time
constexpr int HALO = 6;       // input frames each side of K1's stencil
constexpr int OUT_ROW = TILE_T + 4;
constexpr int MAX_SMEM = 232448;

struct Taps {
  float f[12];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// padded row (elements) of the activation and weight tiles: 80-byte bf16 rows
// keep the eight 16-byte rows of an ldmatrix on distinct banks
template <typename T>
struct Row;
template <>
struct Row<__nv_bfloat16> {
  static constexpr int n = CK + 8;
};
template <>
struct Row<float> {
  static constexpr int n = CK + 1;
};

// Shared memory: region 0 holds the staged x rows, then (aliasing them) the
// time-major activation tile; region 1 the 2x-rate samples; the epilogue's
// output tile reuses regions 0 and 1; region 2 the weight slice.
struct Smem {
  size_t act_off, ws_off, total;
};

template <typename T>
__host__ __device__ Smem smem_layout(int K, int h) {
  const int text = TILE_T + 2 * h;
  const size_t xs = static_cast<size_t>(CK) * (text + 2 * HALO) * sizeof(float);
  const size_t as = static_cast<size_t>(text) * Row<T>::n * sizeof(T);
  const size_t r0 = align16(xs > as ? xs : as);
  const size_t r1 = align16(static_cast<size_t>(CK) * (2 * text + 11) * sizeof(float));
  const size_t out = align16(static_cast<size_t>(TILE_CO) * OUT_ROW * sizeof(float));
  const size_t ws_off = r0 + r1 > out ? r0 + r1 : out;
  const size_t ws = align16(static_cast<size_t>(K) * TILE_CO * Row<T>::n * sizeof(T));
  return {r0, ws_off, ws_off + ws};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, bool TENSOR_CORES>
__global__ void __launch_bounds__(THREADS)
aa_snake_dconv_kernel(const T* __restrict__ x, const T* __restrict__ wt, const T* __restrict__ bias,
                      T* __restrict__ out, const float* __restrict__ alpha, const float* __restrict__ beta,
                      int C, int T_len, int K, int dil, Taps taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ROW = Row<T>::n;
  const int h = (K - 1) * dil / 2;
  const int text = TILE_T + 2 * h;  // activation rows: the tile and the conv's halo
  const int xl = text + 2 * HALO;   // staged x frames per channel
  const int al = 2 * text + 11;     // activated 2x-rate samples per channel
  const Smem lay = smem_layout<T>(K, h);
  float* xs = reinterpret_cast<float*>(smem);
  T* act = reinterpret_cast<T*>(smem);  // aliases xs once it is consumed
  float* acts = reinterpret_cast<float*>(smem + lay.act_off);
  T* ws = reinterpret_cast<T*>(smem + lay.ws_off);
  float* ostage = reinterpret_cast<float*>(smem);

  const int t0 = blockIdx.x * TILE_T;
  const int co0 = blockIdx.y * TILE_CO;
  const int b = blockIdx.z;
  const T* xb = x + static_cast<size_t>(b) * C * T_len;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1;   // 32-channel half of the tile
  const int wn = warp >> 1;  // 32-frame quarter of the tile
  const int tbase = t0 - h;  // frame of activation row 0
  const int last2 = 2 * T_len - 1;

  // tensor cores: acc[(mi * 4 + ni) * 4 + r], m16 tile mi, n8 tile ni;
  // CUDA cores: acc[cc * 8 + tt], 4 channels x 8 frames
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += CK) {
    // 1. the weight slice, rows (j, co) of the chunk's input channels: 16-byte
    //    async copies when the rows are whole and aligned, else element-wise
    if (sizeof(T) == 2 && C % 8 == 0 && c0 + CK <= C) {
      constexpr int SEGS = CK * 2 / 16;
      for (int i = tid; i < K * TILE_CO * SEGS; i += THREADS) {
        const int row = i / SEGS, seg = i - row * SEGS;  // row = j * TILE_CO + co
        const int j = row / TILE_CO, co = row - j * TILE_CO;
        T* dst = ws + row * ROW + seg * 8;
        if (co0 + co < C) {
          cp_async16(dst, wt + (static_cast<size_t>(j) * C + co0 + co) * C + c0 + seg * 8);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        }
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < K * TILE_CO * CK; i += THREADS) {
        const int row = i / CK, ci = i - row * CK;
        const int j = row / TILE_CO, co = row - j * TILE_CO;
        T v = from_f<T>(0.0f);
        if (co0 + co < C && c0 + ci < C) v = wt[(static_cast<size_t>(j) * C + co0 + co) * C + c0 + ci];
        ws[row * ROW + ci] = v;
      }
    }
    //    the x rows, replicate-clamped, one warp to a channel row
    for (int ci = warp; ci < CK; ci += THREADS / 32) {
      const T* xr = xb + static_cast<size_t>(min(c0 + ci, C - 1)) * T_len;
      const bool live = c0 + ci < C;
#pragma unroll 4
      for (int j = lane; j < xl; j += 32) {
        xs[ci * xl + j] = live ? to_f(xr[min(max(tbase - HALO + j, 0), T_len - 1)]) : 0.0f;
      }
    }
    __syncthreads();

    // 2. activated 2x-rate samples m = 2*tbase - 5 + j2, clamped to the
    //    signal, one warp to a channel row
    for (int ci = warp; ci < CK; ci += THREADS / 32) {
      const int c = min(c0 + ci, C - 1);
      const float a = alpha[c], inv_b = 1.0f / (beta[c] + 1e-9f);
      for (int j2 = lane; j2 < al; j2 += 32) {
        const int m = min(max(2 * tbase - 5 + j2, 0), last2);
        const float* xp = xs + ci * xl + ((m >> 1) - (tbase - HALO));
        float y;
        if ((m & 1) == 0) {
          y = taps.f[1] * xp[2] + taps.f[3] * xp[1] + taps.f[5] * xp[0] + taps.f[7] * xp[-1] +
              taps.f[9] * xp[-2] + taps.f[11] * xp[-3];
        } else {
          y = taps.f[0] * xp[3] + taps.f[2] * xp[2] + taps.f[4] * xp[1] + taps.f[6] * xp[0] +
              taps.f[8] * xp[-1] + taps.f[10] * xp[-2];
        }
        y *= 2.0f;
        const float sn = TENSOR_CORES ? poly_sin(y * a) : sinf(y * a);
        acts[ci * al + j2] = y + inv_b * (sn * sn);
      }
    }
    __syncthreads();

    // 3. downsampled activation, time-major, rounded to T; zero outside
    //    [0, T) (the conv's padding) and past C
    for (int i = tid; i < text * CK; i += THREADS) {
      const int tt = i / CK, ci = i - tt * CK;
      const int t = tbase + tt;
      float z = 0.0f;
      if (t >= 0 && t < T_len && c0 + ci < C) {
        const float* ap = acts + ci * al + 2 * tt;
#pragma unroll
        for (int k = 0; k < 12; ++k) z += taps.f[k] * ap[k];
      }
      act[tt * ROW + ci] = from_f<T>(z);
    }
    cp_async_wait_all();  // this thread's weight copies
    __syncthreads();

    // 4. the k taps over this chunk
    if constexpr (TENSOR_CORES) {
      const uint32_t act_base = smem_u32(act);
      const uint32_t ws_base = smem_u32(ws);
      const int a_row = lane & 15, a_col = (lane >> 4) * 8;
      const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
      for (int j = 0; j < K; ++j) {
#pragma unroll
        for (int kk = 0; kk < CK; kk += 16) {
          uint32_t a[2][4], bf[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int row = j * TILE_CO + wm * 32 + mi * 16 + a_row;
            ldmatrix_x4(a[mi], ws_base + (row * ROW + kk + a_col) * 2);
          }
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t r[4];
            const int row = wn * 32 + np * 16 + b_row + j * dil;
            ldmatrix_x4(r, act_base + (row * ROW + kk + b_col) * 2);
            bf[2 * np][0] = r[0];
            bf[2 * np][1] = r[1];
            bf[2 * np + 1][0] = r[2];
            bf[2 * np + 1][1] = r[3];
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_bf16(acc + (mi * 4 + ni) * 4, a[mi], bf[ni][0], bf[ni][1]);
          }
        }
      }
    } else {
      const int co_l = wm * 32 + (lane >> 2) * 4, t_l = wn * 32 + (lane & 3) * 8;
      for (int j = 0; j < K; ++j) {
        for (int ci = 0; ci < CK; ++ci) {
          float wv[4], av[8];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) wv[cc] = to_f(ws[(j * TILE_CO + co_l + cc) * ROW + ci]);
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) av[tt] = to_f(act[(t_l + tt + j * dil) * ROW + ci]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
            for (int tt = 0; tt < 8; ++tt) acc[cc * 8 + tt] = fmaf(wv[cc], av[tt], acc[cc * 8 + tt]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: the tile through shared memory, + bias in float32, rows along time
  if constexpr (TENSOR_CORES) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* c = acc + (mi * 4 + ni) * 4;
        const int co = wm * 32 + mi * 16 + g, t = wn * 32 + ni * 8 + 2 * q;
        ostage[co * OUT_ROW + t] = c[0];
        ostage[co * OUT_ROW + t + 1] = c[1];
        ostage[(co + 8) * OUT_ROW + t] = c[2];
        ostage[(co + 8) * OUT_ROW + t + 1] = c[3];
      }
    }
  } else {
    const int co_l = wm * 32 + (lane >> 2) * 4, t_l = wn * 32 + (lane & 3) * 8;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) ostage[(co_l + cc) * OUT_ROW + t_l + tt] = acc[cc * 8 + tt];
    }
  }
  __syncthreads();
  for (int i = tid; i < TILE_CO * TILE_T; i += THREADS) {
    const int co = i / TILE_T, tl = i - co * TILE_T;
    if (co0 + co < C && t0 + tl < T_len) {
      const float v = ostage[co * OUT_ROW + tl] + to_f(bias[co0 + co]);
      out[(static_cast<size_t>(b) * C + co0 + co) * T_len + t0 + tl] = from_f<T>(v);
    }
  }
}

template <typename T, bool TC>
int launch(const void* x, const void* wt, const void* bias, void* out, const float* alpha, const float* beta,
           int B, int C, int T_len, int K, int dil, const Taps& taps, cudaStream_t s) {
  const Smem lay = smem_layout<T>(K, (K - 1) * dil / 2);
  if (lay.total > static_cast<size_t>(MAX_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;  // the largest dynamic shared memory set for this instance so far
  if (lay.total > configured) {
    const cudaError_t e = cudaFuncSetAttribute(aa_snake_dconv_kernel<T, TC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(lay.total));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = lay.total;
  }
  const dim3 grid((T_len + TILE_T - 1) / TILE_T, (C + TILE_CO - 1) / TILE_CO, B);
  aa_snake_dconv_kernel<T, TC><<<grid, THREADS, lay.total, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), static_cast<const T*>(bias), static_cast<T*>(out),
      alpha, beta, C, T_len, K, dil, taps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: device [B, C, T]; wt: device [K, C, C] (tap, out, in); bias: device [C], all in one
// dtype (0 = float32, 1 = bfloat16); alpha, beta: device float32 [C]; taps:
// host pointer to the 12 filter taps; stream: the cudaStream_t to launch on.
// K odd, (K - 1) * dil even. Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for arguments the kernel cannot take.
extern "C" int indextts_aa_snake_dconv(const void* x, const void* wt, const void* bias, void* out,
                                       const void* alpha, const void* beta, int B, int C, int T, int K,
                                       int dil, int dtype, const float* taps, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || (C + TILE_CO - 1) / TILE_CO > 65535 || T <= 0 || K <= 0 ||
      K % 2 == 0 || dil <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps tp;
  for (int k = 0; k < 12; ++k) tp.f[k] = taps[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  if (dtype == 0) return launch<float, false>(x, wt, bias, out, a, b, B, C, T, K, dil, tp, s);
  return launch<__nv_bfloat16, true>(x, wt, bias, out, a, b, B, C, T, K, dil, tp, s);
}
