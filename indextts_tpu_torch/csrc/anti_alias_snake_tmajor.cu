// K3: the fused anti-aliased Snake / SnakeBeta in three bodies, for NVIDIA
// Hopper (sm_90a): filter taps on the CUDA cores, filter taps on the tensor
// cores, and a pass-through with the same loads and stores.
//
// Replaces indextts_tpu/ops/pallas/antialias_tmajor.py:
// fused_anti_alias_snake_tmajor (bodies _kernel, _kernel_mxu, _kernel_ident).
// The function is K1's (csrc/anti_alias_snake.cu), composed-path edges
// included, by clamping both index spaces:
//   y[m] = 2 * sum_k f[k] * x[clamp((m + 15 - k) / 2 - 5, 0, T-1)]   (m + 15 - k even)
//   a[m] = y[m] + 1/(beta + 1e-9) * sin(alpha * y[m])^2
//   z[t] = sum_j f[j] * a[clamp(2t + j - 5, 0, 2T-1)]
// The TPU kernel blocks its input time-major because there a shift along the
// major axis moves no data; that layout is not carried over. x and out are
// [B, C, T], time contiguous (the vocoder trunk's layout), alpha and beta [C]
// float32, already exponentiated for log-scale parameters; I/O is float32 or
// bf16. What is carried over is what each body computes and that the input
// streams once, halo included.
//
// All three bodies stage a tile of rows ((b, c) pairs) x frames, with 8
// frames of halo on each side, into shared memory with 16-byte loads (when T
// and the pointers allow; element-wise clamped loads at the signal's ends
// and for odd T), then cross one block barrier.
//
// Taps on the CUDA cores (body 0). A thread owns 16 consecutive output frames
// of one row: it reads the 32 staged frames around them from shared memory
// with 16-byte loads, computes the 42 activated 2x-rate samples it needs in
// registers (one sin each) and sums them into its 16 outputs as they appear,
// so all 12 + 12 taps are register reads, and stores its run with 16-byte
// stores. Every index is a compile-time constant after unrolling. Bound: per
// output element 4 (bf16) or 8 (float32) bytes move, against ~84 float32
// operations on the CUDA cores (2 samples x (12 for the taps + 18 for the
// snake with the polynomial sin) + 24 for the down taps); at the card's 67
// TFLOP/s and 3.35 TB/s the two times are within 5 % of each other for bf16
// (operations ahead), and bytes bound float32. The design spends 42 / 32 of
// the minimal sample count (the run's own halo) to keep every intermediate in
// registers and the instruction stream free of barriers.
//
// Taps on the tensor cores (body 1, bf16). The TPU body's banded matrix
// products, with their rounding points: ue = S @ E^T and uo = S @ O^T (taps
// 2 f rounded to bf16, float32 accumulation), the snake in float32, se and so
// ROUNDED TO bf16, then z = SE @ Ye^T + SO @ Yo^T (taps rounded to bf16,
// float32 accumulation). Rows are the M side; time is K and N. The bands are
// 6 wide, so the 8 output columns of an n-block read 14 input columns, inside
// one 16-deep K block placed 4 columns before them: one mma.sync m16n8k16 per
// phase and n-block, and no zero block is multiplied. The band fragments are
// the same for every n-block and live in 8 + 8 registers. A warp owns 16 rows
// x 64 frames: 9 n-blocks of se / so (its own halo), which it writes to its
// own shared-memory strip, patches at the signal's ends, and reads back as
// the A operand of the 8 output n-blocks; the outputs leave through the same
// strip as 16-byte row stores. Only the staging barrier spans the block.
// float32 input has no full-precision tensor-core mode (TF32 keeps 10
// mantissa bits and misses the 2e-5 contract), so the wrapper sends it to
// body 0, whose float32 FMAs sum the same products.
//
// Ident (body 2): body 0's geometry, staging and stores, no arithmetic: out =
// x. The copy floor the other bodies, K1 and (per activation) K2 are read
// against.
//
// wgmma, TMA staging and ldmatrix loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "approx_sin.cuh"

namespace {

constexpr int PAD = 8;  // staged halo frames each side of a tile: >= 6, and 16 bytes in both dtypes

struct Taps {
  float f[12];
};

// ---------------------------------------------------------------------------
// staging, shared by the three bodies
// ---------------------------------------------------------------------------

// Rows row0 .. row0+ROWS-1 (clamped to the last row), frames t0-PAD ..
// t0+TILE+PAD-1 (replicate-clamped) into xs[r * SROW + i], frame t0 - PAD + i.
template <typename T, int ROWS, int TILE, int SROW>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x, T* xs, int nrows, int T_len, int row0, int t0,
                                           bool vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = (TILE + 2 * PAD) / VEC;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += blockDim.x) {
    const int r = i / CHUNKS, ch = i - r * CHUNKS;
    const T* xr = x + static_cast<size_t>(min(row0 + r, nrows - 1)) * T_len;
    const int f0 = t0 - PAD + ch * VEC;
    T* dst = xs + r * SROW + ch * VEC;
    if (vec_ok && f0 >= 0 && f0 + VEC <= T_len) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(xr + f0);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[e] = xr[min(max(f0 + e, 0), T_len - 1)];
    }
  }
}

__device__ __forceinline__ void load32(const float* p, float (&v)[32]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 q = reinterpret_cast<const float4*>(p)[k];
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}

__device__ __forceinline__ void load32(const __nv_bfloat16* p, float (&v)[32]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[k];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[8 * k + 2 * j] = f.x;
      v[8 * k + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x, the low half, is lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 float outputs of one thread to out[0..15], 16-byte stores
__device__ __forceinline__ void store16(float* o, const float (&z)[16], int n_valid_chunks) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k < n_valid_chunks) reinterpret_cast<float4*>(o)[k] = make_float4(z[4 * k], z[4 * k + 1], z[4 * k + 2], z[4 * k + 3]);
  }
}

__device__ __forceinline__ void store16(__nv_bfloat16* o, const float (&z)[16], int n_valid_chunks) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k < n_valid_chunks) {
      reinterpret_cast<uint4*>(o)[k] = make_uint4(pack_bf16(z[8 * k], z[8 * k + 1]), pack_bf16(z[8 * k + 2], z[8 * k + 3]),
                                                  pack_bf16(z[8 * k + 4], z[8 * k + 5]), pack_bf16(z[8 * k + 6], z[8 * k + 7]));
    }
  }
}

__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ---------------------------------------------------------------------------
// bodies 0 and 2: taps on the CUDA cores, and the pass-through
// ---------------------------------------------------------------------------

constexpr int CC_ROWS = 8;      // rows per block, one warp each
constexpr int CC_RUN = 16;      // output frames per thread
constexpr int CC_TILE = 32 * CC_RUN;
constexpr int CC_SROW = CC_TILE + 2 * PAD;
constexpr int CC_THREADS = 32 * CC_ROWS;

template <typename T, bool POLY_SIN, bool IDENT>
__global__ void __launch_bounds__(CC_THREADS)
tmajor_taps_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ alpha,
                   const float* __restrict__ beta, int C, int T_len, int nrows, Taps taps, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ __align__(16) T xs[CC_ROWS * CC_SROW];
  const int row0 = blockIdx.x * CC_ROWS;
  const int t0 = blockIdx.y * CC_TILE;
  stage_rows<T, CC_ROWS, CC_TILE, CC_SROW>(x, xs, nrows, T_len, row0, t0, vec_ok != 0);
  __syncthreads();

  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = row0 + r;
  const int t = t0 + lane * CC_RUN;  // the run's first output frame
  if (row >= nrows || t >= T_len) return;
  const T* xrow = xs + r * CC_SROW + lane * CC_RUN;  // element i is frame t - PAD + i
  T* orow = out + static_cast<size_t>(row) * T_len + t;

  if constexpr (IDENT) {
    if (vec_ok) {
#pragma unroll
      for (int k = 0; k < CC_RUN / VEC; ++k) {
        if (t + k * VEC < T_len) {
          reinterpret_cast<uint4*>(orow)[k] = reinterpret_cast<const uint4*>(xrow + PAD)[k];
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < CC_RUN; ++q) {
        if (t + q < T_len) orow[q] = xrow[PAD + q];
      }
    }
    return;
  } else {
    float xr[32];
    load32(xrow, xr);
    const int c = row % C;
    const float a = alpha[c];
    const float inv_b = 1.0f / (beta[c] + 1e-9f);
    // sample u is 2x-rate index m = 2t - 5 + u. Below the signal (m < 0, only
    // in the run at t = 0: u < 5) it is sample m = 0, i.e. u = 5; above it
    // (m > 2T - 1: u > u_hi) it is sample u_hi.
    const bool at_start = t == 0;
    const int u_hi = 2 * (T_len - t) + 4;
    float z[CC_RUN];
#pragma unroll
    for (int q = 0; q < CC_RUN; ++q) z[q] = 0.0f;
    float last = 0.0f;
#pragma unroll
    for (int u = 0; u < 2 * CC_RUN + 10; ++u) {
      float y;
      if (u & 1) {  // m even, frame m / 2 at xr[n]
        const int n = (u + 11) / 2;
        y = taps.f[1] * xr[n + 2] + taps.f[3] * xr[n + 1] + taps.f[5] * xr[n] + taps.f[7] * xr[n - 1] +
            taps.f[9] * xr[n - 2] + taps.f[11] * xr[n - 3];
      } else {  // m odd, frame (m - 1) / 2 at xr[n]
        const int n = (u + 10) / 2;
        y = taps.f[0] * xr[n + 3] + taps.f[2] * xr[n + 2] + taps.f[4] * xr[n + 1] + taps.f[6] * xr[n] +
            taps.f[8] * xr[n - 1] + taps.f[10] * xr[n - 2];
      }
      y *= 2.0f;
      const float s = POLY_SIN ? poly_sin(y * a) : sinf(y * a);
      float v = y + inv_b * (s * s);
      if (u <= u_hi) {
        last = v;
      } else {
        v = last;
      }
      // z[q] += f[j] * a[2(t + q) + j - 5]: sample u meets output q at j = u - 2q
      const bool dead = at_start && u < 5;
#pragma unroll
      for (int q = 0; q < CC_RUN; ++q) {
        const int j = u - 2 * q;
        if (j >= 0 && j < 12) z[q] += dead ? 0.0f : taps.f[j] * v;
      }
      if (u == 5) {
        if (at_start) {
#pragma unroll
          for (int up = 0; up < 5; ++up) {
#pragma unroll
            for (int q = 0; q < CC_RUN; ++q) {
              const int j = up - 2 * q;
              if (j >= 0 && j < 12) z[q] += taps.f[j] * v;
            }
          }
        }
      }
    }
    if (vec_ok) {
      store16(orow, z, (T_len - t + VEC - 1) / VEC);
    } else {
#pragma unroll
      for (int q = 0; q < CC_RUN; ++q) {
        if (t + q < T_len) from_f(orow + q, z[q]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// body 1: taps on the tensor cores (bf16)
// ---------------------------------------------------------------------------

constexpr int MX_ROWS = 16;                     // rows per block: the M of one mma tile
constexpr int MX_WARPS = 4;
constexpr int MX_WT = 64;                       // output frames per warp
constexpr int MX_TILE = MX_WARPS * MX_WT;
constexpr int MX_SROW = MX_TILE + 2 * PAD + 8;  // 140 words a row: rows g = 0..7 land on distinct banks
constexpr int MX_PW = MX_WT + 8;                // phase samples per warp and row; 36 words a row, the same
constexpr int MX_THREADS = 32 * MX_WARPS;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of a 16 x 16 bf16 tile at column `col` of rows of `stride`
// elements: a0 (row g, cols 2q, 2q+1), a1 (row g+8), a2 (row g, cols +8), a3
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int stride, int col, int g, int q) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(tile);
  a[0] = w[(g * stride + col + 2 * q) >> 1];
  a[1] = w[((g + 8) * stride + col + 2 * q) >> 1];
  a[2] = w[(g * stride + col + 2 * q + 8) >> 1];
  a[3] = w[((g + 8) * stride + col + 2 * q + 8) >> 1];
}

template <bool POLY_SIN>
__device__ __forceinline__ float snake(float y, float a, float inv_b) {
  const float s = POLY_SIN ? poly_sin(y * a) : sinf(y * a);
  return y + inv_b * (s * s);
}

template <bool POLY_SIN>
__global__ void __launch_bounds__(MX_THREADS)
tmajor_mma_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                  const float* __restrict__ alpha, const float* __restrict__ beta, int C, int T_len, int nrows,
                  Taps taps, int vec_ok) {
  using bf16 = __nv_bfloat16;
  __shared__ __align__(16) bf16 xs[MX_ROWS * MX_SROW];
  __shared__ __align__(16) bf16 ph[MX_WARPS][2][MX_ROWS * MX_PW];
  __shared__ float tp[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    if (threadIdx.x == k) tp[k] = taps.f[k];
  }
  const int row0 = blockIdx.x * MX_ROWS;
  const int t0 = blockIdx.y * MX_TILE;
  stage_rows<bf16, MX_ROWS, MX_TILE, MX_SROW>(x, xs, nrows, T_len, row0, t0, vec_ok != 0);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int tw = t0 + warp * MX_WT;  // the warp's first output frame
  if (tw >= T_len) return;

  // Band fragments, B[k][n] in the mma's layout: b0 = (k = 2q, 2q+1; n = g),
  // b1 = (k = 2q+8, 2q+9; n = g). Up, K block 4 frames before the n-block:
  //   E[k][n] = 2 f[13 - 2k + 2n], O[k][n] = 2 f[14 - 2k + 2n];
  // down, K block at the n-block's own phase column:
  //   Ye[k][n] = f[2k - 2n - 3], Yo[k][n] = f[2k - 2n - 2]; f = 0 outside 0..11.
  auto f_at = [&](int j) -> float { return (j >= 0 && j < 12) ? tp[j] : 0.0f; };
  uint32_t be[2], bo[2], bye[2], byo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = 2 * q + 8 * h;
    be[h] = pack_bf16(2.0f * f_at(13 - 2 * k + 2 * g), 2.0f * f_at(11 - 2 * k + 2 * g));
    bo[h] = pack_bf16(2.0f * f_at(14 - 2 * k + 2 * g), 2.0f * f_at(12 - 2 * k + 2 * g));
    bye[h] = pack_bf16(f_at(2 * k - 2 * g - 3), f_at(2 * k - 2 * g - 1));
    byo[h] = pack_bf16(f_at(2 * k - 2 * g - 2), f_at(2 * k - 2 * g));
  }
  float al[2], ib[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = min(row0 + g + 8 * h, nrows - 1) % C;
    al[h] = alpha[c];
    ib[h] = 1.0f / (beta[c] + 1e-9f);
  }

  // phase samples se[i] = a[2i], so[i] = a[2i+1] for i = tw - 4 + li, li = 0..71
  bf16* se = ph[warp][0];
  bf16* so = ph[warp][1];
  uint32_t* se32 = reinterpret_cast<uint32_t*>(se);
  uint32_t* so32 = reinterpret_cast<uint32_t*>(so);
#pragma unroll
  for (int nb = 0; nb < MX_PW / 8; ++nb) {
    // the n-block's samples i0 .. i0+7 (i0 = tw - 4 + 8 nb) read frames i0-3 ..
    // i0+10: K block from frame i0 - 4, staged at column warp * WT + 8 nb
    uint32_t a[4];
    load_a(a, xs, MX_SROW, warp * MX_WT + 8 * nb, g, q);
    float ce[4] = {0.0f, 0.0f, 0.0f, 0.0f}, co[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(ce, a, be[0], be[1]);
    mma_bf16(co, a, bo[0], bo[1]);
    const int w0 = (g * MX_PW + 8 * nb + 2 * q) >> 1, w1 = ((g + 8) * MX_PW + 8 * nb + 2 * q) >> 1;
    se32[w0] = pack_bf16(snake<POLY_SIN>(ce[0], al[0], ib[0]), snake<POLY_SIN>(ce[1], al[0], ib[0]));
    se32[w1] = pack_bf16(snake<POLY_SIN>(ce[2], al[1], ib[1]), snake<POLY_SIN>(ce[3], al[1], ib[1]));
    so32[w0] = pack_bf16(snake<POLY_SIN>(co[0], al[0], ib[0]), snake<POLY_SIN>(co[1], al[0], ib[0]));
    so32[w1] = pack_bf16(snake<POLY_SIN>(co[2], al[1], ib[1]), snake<POLY_SIN>(co[3], al[1], ib[1]));
  }
  __syncwarp();
  // the 2x-rate signal's ends: below it every sample is a[0] = se[0], above
  // it a[2T - 1] = so[T - 1]
  const int li_hi = T_len - tw + 4;  // the first li past the signal
  if (tw == 0 || li_hi < MX_PW) {
    for (int idx = lane; idx < MX_ROWS * MX_PW; idx += 32) {
      const int r = idx / MX_PW, li = idx - r * MX_PW;
      if (tw == 0 && li < 4) {
        se[idx] = so[idx] = se[r * MX_PW + 4];
      } else if (li >= li_hi) {
        se[idx] = so[idx] = so[r * MX_PW + li_hi - 1];
      }
    }
    __syncwarp();
  }

  // z[t] = sum_r f[2r+1] se[t-2+r] + f[2r] so[t-3+r]: output n-block ob reads
  // phase columns 8 ob + 1 .. 8 ob + 14, inside the K block at column 8 ob
  float acc[MX_WT / 8][4];
#pragma unroll
  for (int ob = 0; ob < MX_WT / 8; ++ob) {
    acc[ob][0] = acc[ob][1] = acc[ob][2] = acc[ob][3] = 0.0f;
    uint32_t a[4];
    load_a(a, se, MX_PW, 8 * ob, g, q);
    mma_bf16(acc[ob], a, bye[0], bye[1]);
    load_a(a, so, MX_PW, 8 * ob, g, q);
    mma_bf16(acc[ob], a, byo[0], byo[1]);
  }
  __syncwarp();
  // out through the warp's own strip (se's), then 16-byte row stores
#pragma unroll
  for (int ob = 0; ob < MX_WT / 8; ++ob) {
    se32[(g * MX_PW + 8 * ob + 2 * q) >> 1] = pack_bf16(acc[ob][0], acc[ob][1]);
    se32[((g + 8) * MX_PW + 8 * ob + 2 * q) >> 1] = pack_bf16(acc[ob][2], acc[ob][3]);
  }
  __syncwarp();
  for (int idx = lane; idx < MX_ROWS * (MX_WT / 8); idx += 32) {
    const int r = idx / (MX_WT / 8), ch = idx - r * (MX_WT / 8);
    const int row = row0 + r, t = tw + 8 * ch;
    if (row >= nrows || t >= T_len) continue;
    bf16* o = out + static_cast<size_t>(row) * T_len + t;
    const bf16* src = se + r * MX_PW + 8 * ch;
    if (vec_ok) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && t + e < T_len; ++e) o[e] = src[e];
    }
  }
}

template <typename T>
int launch_taps(const void* x, void* out, const float* a, const float* b, int C, int T_len, int nrows, int body,
                bool poly, const Taps& tp, int vec_ok, cudaStream_t s) {
  const dim3 grid((nrows + CC_ROWS - 1) / CC_ROWS, (T_len + CC_TILE - 1) / CC_TILE);
  const T* xi = static_cast<const T*>(x);
  T* xo = static_cast<T*>(out);
  if (body == 2) {
    tmajor_taps_kernel<T, false, true><<<grid, CC_THREADS, 0, s>>>(xi, xo, a, b, C, T_len, nrows, tp, vec_ok);
  } else if (poly) {
    tmajor_taps_kernel<T, true, false><<<grid, CC_THREADS, 0, s>>>(xi, xo, a, b, C, T_len, nrows, tp, vec_ok);
  } else {
    tmajor_taps_kernel<T, false, false><<<grid, CC_THREADS, 0, s>>>(xi, xo, a, b, C, T_len, nrows, tp, vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: device pointers to [B, C, T]; alpha, beta: device float32 [C];
// dtype: 0 = float32, 1 = bfloat16; body: 0 = taps on the CUDA cores, 1 = taps
// on the tensor cores (bfloat16 only), 2 = pass-through; poly_sin: the
// polynomial sin instead of sinf; taps: host pointer to the 12 filter taps;
// stream: the cudaStream_t to launch on. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for arguments the
// kernel cannot take.
extern "C" int indextts_anti_alias_snake_tmajor(const void* x, void* out, const void* alpha, const void* beta,
                                                int B, int C, int T, int dtype, int body, int poly_sin,
                                                const float* taps, void* stream) {
  const long long nrows = static_cast<long long>(B) * C;
  if (B <= 0 || C <= 0 || T <= 0 || nrows > 0x7fffffffLL || (T + MX_TILE - 1) / MX_TILE > 65535 ||
      T > 0x3fffffff || (dtype != 0 && dtype != 1) || body < 0 || body > 2 || (body == 1 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps tp;
  for (int k = 0; k < 12; ++k) tp.f[k] = taps[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  const int vec = dtype == 0 ? 4 : 8;
  const int vec_ok = T % vec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int n = static_cast<int>(nrows);
  if (body == 1) {
    const dim3 grid((n + MX_ROWS - 1) / MX_ROWS, (T + MX_TILE - 1) / MX_TILE);
    const __nv_bfloat16* xi = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* xo = static_cast<__nv_bfloat16*>(out);
    if (poly_sin) {
      tmajor_mma_kernel<true><<<grid, MX_THREADS, 0, s>>>(xi, xo, a, b, C, T, n, tp, vec_ok);
    } else {
      tmajor_mma_kernel<false><<<grid, MX_THREADS, 0, s>>>(xi, xo, a, b, C, T, n, tp, vec_ok);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 0) return launch_taps<float>(x, out, a, b, C, T, n, body, poly_sin != 0, tp, vec_ok, s);
  return launch_taps<__nv_bfloat16>(x, out, a, b, C, T, n, body, poly_sin != 0, tp, vec_ok, s);
}
