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
// x and out are [B, C, T], time contiguous (the vocoder trunk's layout),
// alpha and beta [C] float32, already exponentiated for log-scale
// parameters; I/O is float32 or bf16.
//
// The TPU kernel exists beside K1 because of two TPU layouts: time in
// sublanes, where a shift along time moves data through the register file,
// against time major, where it moves none. This card has neither: K1 and K3
// read the same [B, C, T] rows. So the CUDA-core body (0) IS K1's design,
// the lane scheme of aa_lanes.cuh, instantiated with K1's rounding points
// (unrounded float32 taps 2 f and f, samples not rounded) under K3's own
// __global__ name, entry and launch count; and the ident body (2) is that
// scheme's copy(): the same geometry, loads and stores, out = x, the floor
// the other bodies are read against. Neither uses shared memory or a block
// barrier; the grid of both is about one resident wave, split by
// aa_lanes::split from the card's SM count (which this entry reads itself:
// its signature stays, where K1's and K4's take the count from
// ops/cuda/common.py:sm_count). Bound of body 0: per element 4
// bytes move in bf16 against 84 float32 operations; at 3.35 TB/s and 67
// TFLOP/s operations decide, by 5 % (see anti_alias_snake.cu).
//
// Taps on the tensor cores (body 1, bf16). The TPU body's banded matrix
// products, with their rounding points: ue = X @ E^T and uo = X @ O^T (taps
// 2 f rounded to bf16, float32 sums), the snake in float32, se and so (the
// even and odd 2x-rate samples) ROUNDED TO bf16, then z = SE @ Ye^T + SO @
// Yo^T (taps f rounded to bf16, float32 sums). The bound is bytes: 4 an
// element in bf16 (0.132 ms for a vocoder call's 110.6 M elements), against
// 36 float32 operations of the two snakes (0.059 ms) and 128 tensor-core
// FLOP of the banded mma (0.014 ms). So every intermediate stays in
// registers and the CUDA cores do only the snakes, the packing and the I/O:
//   * A warp owns a tile of 16 rows ((b, c) pairs: the M of mma.sync
//     m16n8k16) and walks a run of 8-frame n-blocks along T. The bands are 6
//     wide, so up n-block u (phase samples i0 = tr - 4 + 8u .. i0 + 7) reads
//     frames i0 - 4 .. i0 + 11: one 16-deep K block, one mma per phase, no
//     zero block multiplied; wgmma's 64-row tiles would be mostly zeros.
//     The band fragments (E, O, Ye, Yo in the B layout) are made at the
//     warp's start from the 12 taps by shuffles and live in 8 registers.
//   * The snake runs on the up accumulators in place (a thread holds rows g
//     and g + 8: two (alpha, 1/beta) pairs), and the results are packed to
//     bf16x2: the contract's rounding point.
//   * The C fragments of up n-blocks ob and ob + 1 ARE the A fragment of
//     output n-block ob's 16-deep down K block (phase samples to - 4 .. to +
//     11; a0, a1 from ob's C, a2, a3 from ob + 1's), as FlashAttention-2
//     reuses S as P: two mma (even, odd phase) and no trip through memory.
//     The walk carries the previous up n-block's 4 packed words; the halo is
//     one up n-block at the start of a run. A step (STEP n-blocks) has no
//     branch unless it reaches the row's end, so its products and snakes
//     interleave; a step's loads are issued one step ahead.
//   * The A fragment of x for up n-block u + 1 reuses half of u's: each
//     n-block loads one new 8-frame group, a 4-byte word per row of a
//     thread. (16-byte loads transposed in the quad by shuffles were no
//     faster on the card.)
//   * The 2x-rate clamp at the row's ends: samples i < 0 take se[0] and
//     samples i > T - 1 take so[T - 1]; the value sits in one thread of the
//     quad and comes by __shfl_sync, in branches uniform across the warp.
//   * Outputs leave as 16-byte row stores: the C fragments of two n-blocks
//     are transposed within the quad by shuffles.
// float32 input has no full-precision tensor-core mode (TF32 keeps 10
// mantissa bits and misses the 2e-5 contract), so the wrapper sends it to
// body 0, whose float32 FMAs sum the same products.

#include "aa_lanes.cuh"

namespace {

using aa_lanes::Taps;
using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// bodies 0 and 2: the lane scheme
// ---------------------------------------------------------------------------

template <typename T, bool POLY_SIN>
__global__ void __launch_bounds__(aa_lanes::THREADS, aa_lanes::MIN_BLOCKS)
tmajor_taps_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ alpha,
                   const float* __restrict__ beta, int C, int T_len, int nrows, int cpw, int segs, int vec_ok,
                   Taps taps) {
  aa_lanes::run<T, false, POLY_SIN>(x, out, alpha, beta, C, T_len, nrows, cpw, segs, vec_ok != 0, taps);
}

template <typename T>
__global__ void __launch_bounds__(aa_lanes::THREADS, aa_lanes::MIN_BLOCKS)
tmajor_ident_kernel(const T* __restrict__ x, T* __restrict__ out, int T_len, int nrows, int cpw, int segs,
                    int vec_ok) {
  aa_lanes::copy<T>(x, out, T_len, nrows, cpw, segs, vec_ok != 0);
}

// ---------------------------------------------------------------------------
// body 1: taps on the tensor cores (bf16)
// ---------------------------------------------------------------------------

namespace mx {
constexpr int ROWS = 16;             // rows of a warp's tile: the mma's M
constexpr int NB = 8;                // frames of an n-block: the mma's N
constexpr int STEP = 2;              // n-blocks a warp finishes per step of its walk (even)
constexpr int STEP_F = STEP * NB;    // output frames of a step
constexpr int WARPS = 4;             // warps per block; they share nothing
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 5;        // resident blocks an SM must hold: <= 102 registers a thread
constexpr int RESIDENT_WARPS = WARPS * MIN_BLOCKS;
// bits of the kernel's `vec` argument
constexpr int X4 = 1;    // x's rows start on 4-byte boundaries (T even, x aligned)
constexpr int O16 = 2;   // out's rows start on 16-byte boundaries (T % 8 == 0, out aligned)
}  // namespace mx

// The band fragments in mma.sync's B layout (lane: g = lane / 4, q = lane %
// 4): register 2 p + h of a lane holds B[k][g], B[k + 1][g] (k = 2 q + 8 h)
// of p = E, O, Ye, Yo, packed bf16x2, where (f = 0 outside 0 .. 11)
//   up, K block 4 frames before the n-block: E[k][n] = 2 f[13 - 2k + 2n], O[k][n] = 2 f[14 - 2k + 2n];
//   down, K block 4 phase samples before it: Ye[k][n] = f[2k - 2n - 3],  Yo[k][n] = f[2k - 2n - 2].
// Lane j < 12 holds f[j] and the lanes take their taps by shuffle (the 16
// addresses a lane needs differ across the warp: read from the parameter
// bank they would be serialised).
struct Bands {
  uint32_t be[2], bo[2], bye[2], byo[2];
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi);

__device__ __forceinline__ Bands band_fragments(const Taps& taps, int lane) {
  float mine = 0.0f;  // f[lane] for lanes 0 .. 11; lane 31 answers every index outside the filter
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    if (lane == k) mine = taps.dn[k];
  }
  auto f = [&](int j) { return __shfl_sync(FULL, mine, (j >= 0 && j < 12) ? j : 31); };
  const int g = lane >> 2, q = lane & 3;
  Bands b;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = 2 * q + 8 * h;
    b.be[h] = pack_bf16(2.0f * f(13 - 2 * k + 2 * g), 2.0f * f(11 - 2 * k + 2 * g));
    b.bo[h] = pack_bf16(2.0f * f(14 - 2 * k + 2 * g), 2.0f * f(12 - 2 * k + 2 * g));
    b.bye[h] = pack_bf16(f(2 * k - 2 * g - 3), f(2 * k - 2 * g - 1));
    b.byo[h] = pack_bf16(f(2 * k - 2 * g - 2), f(2 * k - 2 * g));
  }
  return b;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x, the low half, is lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The 4 x 4 transpose of v over the 4 lanes of a quad: slot s of the lane at
// q goes to slot q of the lane at s. Two butterfly stages, each swapping one
// bit between the lane's and the slot's index: 4 shuffles.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    const bool upper = (q & m) != 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s & m) continue;
      const uint32_t got = __shfl_xor_sync(FULL, upper ? v[s] : v[s | m], m);
      if (upper) {
        v[s] = got;
      } else {
        v[s | m] = got;
      }
    }
  }
}

// frames f, f + 1 of a row (f even) as bf16x2; `inside`: one aligned 4-byte
// load, else two replicate-clamped loads
__device__ __forceinline__ uint32_t load_pair(const bf16* row, int f, int T_len, bool inside) {
  if (inside) return __ldg(reinterpret_cast<const unsigned int*>(row + f));
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  const uint32_t lo = __ldg(r + min(max(f, 0), T_len - 1));
  const uint32_t hi = __ldg(r + min(max(f + 1, 0), T_len - 1));
  return lo | (hi << 16);
}

// One 8-frame group (frames fg .. fg + 7) of the A fragment: the thread's word
// (frames fg + 2q, fg + 2q + 1) of rows g and g + 8.
__device__ __forceinline__ void load_group(uint32_t (&w)[2], const bf16* const (&xr)[2], int fg, int q, int T_len,
                                           int vec) {
  const bool inside = (vec & mx::X4) && fg >= 0 && fg + mx::NB <= T_len;  // uniform across the warp
  w[0] = load_pair(xr[0], fg + 2 * q, T_len, inside);
  w[1] = load_pair(xr[1], fg + 2 * q, T_len, inside);
}

// The STEP groups of frames fs .. fs + STEP_F - 1: xs[k] is group fs + 8k.
// Inside the row (a branch uniform across the warp) they are 2 STEP aligned
// 4-byte loads and nothing else.
__device__ __forceinline__ void load_step(uint32_t (&xs)[mx::STEP][2], const bf16* const (&xr)[2], int fs, int q,
                                          int T_len, int vec) {
  if ((vec & mx::X4) && fs >= 0 && fs + mx::STEP_F <= T_len) {
#pragma unroll
    for (int k = 0; k < mx::STEP; ++k) {
#pragma unroll
      for (int h = 0; h < 2; ++h) xs[k][h] = __ldg(reinterpret_cast<const unsigned int*>(xr[h] + fs + mx::NB * k + 2 * q));
    }
  } else {
#pragma unroll
    for (int k = 0; k < mx::STEP; ++k) load_group(xs[k], xr, fs + mx::NB * k, q, T_len, vec);
  }
}

// se and so of one up n-block, packed bf16x2: e[h] / o[h] hold row g + 8h's
// samples n = 2q (low half) and 2q + 1 (high half)
struct Phase {
  uint32_t e[2], o[2];
};

template <bool POLY_SIN>
__device__ __forceinline__ float snake(float y, float a, float inv_b) {
  const float s = POLY_SIN ? poly_sin(y * a) : sinf(y * a);
  return y + inv_b * (s * s);
}

// Up n-block from its two groups (lo: frames i0 - 4 .. i0 + 3, hi: i0 + 4 ..
// i0 + 11), the snake on the accumulators, rounded to bf16.
template <bool POLY_SIN>
__device__ __forceinline__ Phase up_block(const uint32_t (&lo)[2], const uint32_t (&hi)[2], const uint32_t (&be)[2],
                                          const uint32_t (&bo)[2], const float (&al)[2], const float (&ib)[2]) {
  const uint32_t a[4] = {lo[0], lo[1], hi[0], hi[1]};
  float ce[4] = {0.0f, 0.0f, 0.0f, 0.0f}, co[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(ce, a, be[0], be[1]);
  mma_bf16(co, a, bo[0], bo[1]);
  Phase p;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    p.e[h] = pack_bf16(snake<POLY_SIN>(ce[2 * h], al[h], ib[h]), snake<POLY_SIN>(ce[2 * h + 1], al[h], ib[h]));
    p.o[h] = pack_bf16(snake<POLY_SIN>(co[2 * h], al[h], ib[h]), snake<POLY_SIN>(co[2 * h + 1], al[h], ib[h]));
  }
  return p;
}

// The 2x-rate clamp on the up n-block of samples i0 .. i0 + 7: below the row
// every sample is a[0] = se[0], past it a[2T - 1] = so[T - 1]. tail carries
// so[T - 1] (both halves) from the n-block that holds it to later ones; both
// branches are uniform across the warp.
__device__ __forceinline__ void clamp_ends(Phase& p, int i0, int T_len, int lane, int q, uint32_t (&tail)[2]) {
  if (i0 < 0) {  // i0 = -4: n = 0 .. 3 (q = 0, 1) take se[0], n = 4 (q = 2, low half)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t s = __shfl_sync(FULL, p.e[h], (lane & ~3) | 2) & 0xffffu;
      if (q < 2) p.e[h] = p.o[h] = s | (s << 16);
    }
  }
  if (i0 + mx::NB >= T_len) {  // the n-block holds sample T - 1 (nl = 7 included) or lies past it
    const int nl = T_len - 1 - i0;  // sample T - 1 at n = nl here; nl < 0: an earlier n-block held it
    if (nl >= 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t v = __shfl_sync(FULL, p.o[h], (lane & ~3) | (nl >> 1));
        const uint32_t s = (nl & 1) ? v >> 16 : v & 0xffffu;
        tail[h] = s | (s << 16);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (2 * q > nl) {
        p.e[h] = p.o[h] = tail[h];
      } else if (2 * q + 1 > nl) {
        p.e[h] = (p.e[h] & 0xffffu) | (tail[h] & 0xffff0000u);
        p.o[h] = (p.o[h] & 0xffffu) | (tail[h] & 0xffff0000u);
      }
    }
  }
}

// Output n-block from the up n-blocks before (prev) and after (cur) it:
// words[0] / words[1] hold rows g / g + 8 at n = 2q, 2q + 1, bf16x2.
__device__ __forceinline__ void down_block(const Phase& prev, const Phase& cur, const uint32_t (&bye)[2],
                                           const uint32_t (&byo)[2], uint32_t& row_g, uint32_t& row_g8) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const uint32_t ae[4] = {prev.e[0], prev.e[1], cur.e[0], cur.e[1]};
  const uint32_t ao[4] = {prev.o[0], prev.o[1], cur.o[0], cur.o[1]};
  mma_bf16(acc, ae, bye[0], bye[1]);
  mma_bf16(acc, ao, byo[0], byo[1]);
  row_g = pack_bf16(acc[0], acc[1]);
  row_g8 = pack_bf16(acc[2], acc[3]);
}

// 8 outputs (bf16x2 words) to frames f .. f + 7 of a row, those inside it
__device__ __forceinline__ void store_group(bf16* row, int f, int T_len, bool o16, const uint32_t (&v)[4]) {
  if (f >= T_len) return;
  if (o16 && f + mx::NB <= T_len) {
    *reinterpret_cast<uint4*>(row + f) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    unsigned short* r = reinterpret_cast<unsigned short*>(row);
#pragma unroll
    for (int e = 0; e < mx::NB; ++e) {
      if (f + e < T_len) r[f + e] = static_cast<unsigned short>(v[e >> 1] >> (16 * (e & 1)));
    }
  }
}

// What a warp carries along its walk: its rows, their snake parameters, the
// band fragments, the last up n-block, the x group it shares with the next
// one, and so[T - 1] once the walk has passed it.
struct Walk {
  const bf16* xr[2];
  float al[2], ib[2];
  Bands bands;
  Phase prev;
  uint32_t carry[2];
  uint32_t tail[2];
};

// One step: output n-blocks b = 0 .. STEP - 1 (frames f0 + 8b ..) from up
// n-blocks b (wk.prev for b = 0) and b + 1 (samples f0 + 4 + 8b ..), read
// from the groups xc (frames f0 + 8 ..). ov gets the output words, slots (row
// g, row g + 8) x (first, second n-block of a pair). EDGE: some up n-block
// passes sample T - 1 (the clamp); the other steps run without a branch, so
// their n-blocks' products and snakes interleave.
template <bool POLY_SIN, bool EDGE>
__device__ __forceinline__ void step(Walk& wk, const uint32_t (&xc)[mx::STEP][2], int f0, int T_len, int lane,
                                     int q, uint32_t (&ov)[mx::STEP / 2][4]) {
#pragma unroll
  for (int b = 0; b < mx::STEP; ++b) {
    const uint32_t lo[2] = {b == 0 ? wk.carry[0] : xc[b > 0 ? b - 1 : 0][0],
                            b == 0 ? wk.carry[1] : xc[b > 0 ? b - 1 : 0][1]};
    Phase cur = up_block<POLY_SIN>(lo, xc[b], wk.bands.be, wk.bands.bo, wk.al, wk.ib);
    if (EDGE) clamp_ends(cur, f0 + 4 + mx::NB * b, T_len, lane, q, wk.tail);
    down_block(wk.prev, cur, wk.bands.bye, wk.bands.byo, ov[b >> 1][2 * (b & 1)], ov[b >> 1][2 * (b & 1) + 1]);
    wk.prev = cur;
  }
  wk.carry[0] = xc[mx::STEP - 1][0];
  wk.carry[1] = xc[mx::STEP - 1][1];
}

// Warp w takes steps k0 .. k0 + cpw - 1 (output frames STEP_F k0 ..) of row
// tile w / segs.
template <bool POLY_SIN>
__global__ void __launch_bounds__(mx::THREADS, mx::MIN_BLOCKS)
tmajor_mma_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, const float* __restrict__ alpha,
                  const float* __restrict__ beta, int C, int T_len, int nrows, int cpw, int segs, int vec,
                  Taps taps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const long long w = (static_cast<long long>(blockIdx.x) * mx::THREADS + threadIdx.x) >> 5;
  const long long tile = w / segs;
  if (tile >= (nrows + mx::ROWS - 1) / mx::ROWS) return;  // the whole warp: no shuffle follows
  const int steps = (T_len + mx::STEP_F - 1) / mx::STEP_F;
  const int k0 = static_cast<int>(w - tile * segs) * cpw;
  const int n_steps = min(k0 + cpw, steps) - k0;
  if (n_steps <= 0) return;

  // rows g and g + 8 of the tile; loads past the last row read it, stores skip
  Walk wk;
  int row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = static_cast<int>(tile) * mx::ROWS + g + 8 * h;
    wk.xr[h] = x + static_cast<long long>(min(row[h], nrows - 1)) * T_len;
  }
  // group j of the run holds frames tr - 8 + 8j; up n-block u (samples tr - 4
  // + 8u ..) reads groups u and u + 1; output n-block ob (frames tr + 8 ob ..)
  // reads up n-blocks ob and ob + 1. Every load of the first step is issued
  // before any arithmetic.
  const int tr = k0 * mx::STEP_F;
  uint32_t g0[2], xn[mx::STEP][2];
  load_group(g0, wk.xr, tr - 8, q, T_len, vec);
  load_group(wk.carry, wk.xr, tr, q, T_len, vec);
  load_step(xn, wk.xr, tr + 8, q, T_len, vec);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = min(row[h], nrows - 1) % C;
    wk.al[h] = alpha[c];
    wk.ib[h] = 1.0f / (beta[c] + 1e-9f);
  }
  wk.bands = band_fragments(taps, lane);
  wk.tail[0] = wk.tail[1] = 0u;
  wk.prev = up_block<POLY_SIN>(g0, wk.carry, wk.bands.be, wk.bands.bo, wk.al, wk.ib);
  clamp_ends(wk.prev, tr - 4, T_len, lane, q, wk.tail);

  // the lane's row of the transposed output words: row g + 8 (q & 1)
  const int r_out = (q & 1) ? row[1] : row[0];
  bf16* const orow = out + static_cast<long long>(min(r_out, nrows - 1)) * T_len;
  for (int s = 0; s < n_steps; ++s) {
    const int f0 = tr + mx::STEP_F * s;
    uint32_t xc[mx::STEP][2];
#pragma unroll
    for (int k = 0; k < mx::STEP; ++k) {
      xc[k][0] = xn[k][0];
      xc[k][1] = xn[k][1];
    }
    if (s + 1 < n_steps) load_step(xn, wk.xr, f0 + mx::STEP_F + 8, q, T_len, vec);
    uint32_t ov[mx::STEP / 2][4];
    if (f0 + mx::STEP_F + 4 >= T_len) {  // the step's last up n-block (samples f0 + STEP_F - 4 ..) reaches T - 1
      step<POLY_SIN, true>(wk, xc, f0, T_len, lane, q, ov);
    } else {
      step<POLY_SIN, false>(wk, xc, f0, T_len, lane, q, ov);
    }
    // after the transpose the lane at q holds all 8 outputs of slot q: row g +
    // 8 (q & 1) of the pair's n-block q >> 1
    const bool full = (vec & mx::O16) && f0 + mx::STEP_F <= T_len;  // uniform: 16-byte stores only
#pragma unroll
    for (int p = 0; p < mx::STEP / 2; ++p) {
      quad_transpose(ov[p], q);
      const int f = f0 + mx::NB * (2 * p + (q >> 1));
      if (r_out < nrows) {
        if (full) {
          *reinterpret_cast<uint4*>(orow + f) = make_uint4(ov[p][0], ov[p][1], ov[p][2], ov[p][3]);
        } else {
          store_group(orow, f, T_len, vec & mx::O16, ov[p]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The SM count of the current device (the one the wrapper made current for
// the launch), read once per device. K1's and K4's entries take it as an
// argument from ops/cuda/common.py:sm_count; K3's entry keeps the signature
// it had before the grid was sized to the card, so it reads the same count
// here. A failed read is returned as its CUDA error, never guessed.
cudaError_t sm_count(int& n) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cached[dev] > 0) {
    n = cached[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (n < 1) return cudaErrorInvalidValue;
  if (dev < 64) cached[dev] = n;
  return cudaSuccess;
}

template <typename T>
int launch_lanes(const void* x, void* out, const float* a, const float* b, int C, int T_len, int nrows, int body,
                 bool poly, const Taps& tp, int sms, cudaStream_t s) {
  int cpw = 1, segs = 1;
  const long long blocks = aa_lanes::split(nrows, T_len, sms, cpw, segs);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_ok = aa_lanes::vectors_ok<T>(x, out, T_len);
  const T* xi = static_cast<const T*>(x);
  T* xo = static_cast<T*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (body == 2) {
    tmajor_ident_kernel<T><<<grid, aa_lanes::THREADS, 0, s>>>(xi, xo, T_len, nrows, cpw, segs, vec_ok);
    return static_cast<int>(cudaGetLastError());
  }
  if (poly) {
    tmajor_taps_kernel<T, true><<<grid, aa_lanes::THREADS, 0, s>>>(xi, xo, a, b, C, T_len, nrows, cpw, segs, vec_ok, tp);
  } else {
    tmajor_taps_kernel<T, false><<<grid, aa_lanes::THREADS, 0, s>>>(xi, xo, a, b, C, T_len, nrows, cpw, segs, vec_ok, tp);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* x, void* out, const float* a, const float* b, int C, int T_len, int nrows, bool poly,
               const Taps& tp, int sms, cudaStream_t s) {
  const long long tiles = (nrows + mx::ROWS - 1) / mx::ROWS;
  const long long steps = (T_len + mx::STEP_F - 1) / mx::STEP_F;
  int cpw = 1, segs = 1;
  const long long blocks = aa_lanes::split_units(tiles, steps, static_cast<long long>(sms) * mx::RESIDENT_WARPS,
                                                 mx::WARPS, cpw, segs);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x), op = reinterpret_cast<uintptr_t>(out);
  const int vec = (T_len % 2 == 0 && xp % 4 == 0 ? mx::X4 : 0) | (T_len % 8 == 0 && op % 16 == 0 ? mx::O16 : 0);
  const bf16* xi = static_cast<const bf16*>(x);
  bf16* xo = static_cast<bf16*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (poly) {
    tmajor_mma_kernel<true><<<grid, mx::THREADS, 0, s>>>(xi, xo, a, b, C, T_len, nrows, cpw, segs, vec, tp);
  } else {
    tmajor_mma_kernel<false><<<grid, mx::THREADS, 0, s>>>(xi, xo, a, b, C, T_len, nrows, cpw, segs, vec, tp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: device pointers to [B, C, T]; alpha, beta: device float32 [C];
// dtype: 0 = float32, 1 = bfloat16; body: 0 = taps on the CUDA cores, 1 = taps
// on the tensor cores (bfloat16 only), 2 = pass-through; poly_sin: the
// polynomial sin instead of sinf; taps: host pointer to the 12 filter taps;
// stream: the cudaStream_t to launch on. The grid is sized from the current
// device's SM count. Returns cudaGetLastError() after the launch (0 on
// success), the error of a failed SM-count read, or cudaErrorInvalidValue for
// arguments the kernel cannot take.
extern "C" int indextts_anti_alias_snake_tmajor(const void* x, void* out, const void* alpha, const void* beta,
                                                int B, int C, int T, int dtype, int body, int poly_sin,
                                                const float* taps, void* stream) {
  const long long nrows = static_cast<long long>(B) * C;
  if (B <= 0 || C <= 0 || T <= 0 || nrows > 0x7fffffffLL || T > 0x1fffffff || (dtype != 0 && dtype != 1) ||
      body < 0 || body > 2 || (body == 1 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  const int n = static_cast<int>(nrows);
  int sms = 0;
  const cudaError_t e = sm_count(sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  Taps tp;  // up = 2 f, dn = f; the tensor-core body makes its bands from dn
  for (int k = 0; k < 12; ++k) {
    tp.up[k] = 2.0f * taps[k];
    tp.dn[k] = taps[k];
  }
  if (body == 1) return launch_mma(x, out, a, b, C, T, n, poly_sin != 0, tp, sms, s);
  if (dtype == 0) return launch_lanes<float>(x, out, a, b, C, T, n, body, poly_sin != 0, tp, sms, s);
  return launch_lanes<bf16>(x, out, a, b, C, T, n, body, poly_sin != 0, tp, sms, s);
}
