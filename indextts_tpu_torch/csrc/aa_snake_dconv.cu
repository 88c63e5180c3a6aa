// K2: the anti-aliased Snake / SnakeBeta followed by a dilated Conv1d + bias,
// fused, for NVIDIA Hopper (sm_90a). One AMPBlock1 half-branch:
//   out = conv1d(activation1d(x), w, bias, padding = (k*d - d) / 2, dilation = d)
//
// Replaces indextts_tpu/ops/pallas/aa_conv_branch.py:fused_aa_snake_dconv_tmajor,
// the Pallas TPU kernel. The activation is K1's (csrc/anti_alias_snake.cu),
// with the same two clamped index spaces, so inside [0, T) it equals the
// composed path; frames outside [0, T) are zero, the conv's zero padding. It
// is rounded to x's dtype before the conv; the conv sums in float32, adds the
// bias in float32 and rounds once.
//
// Layout: x and out [B, C, T] (time contiguous, the vocoder trunk's layout);
// wp the packed weight (ops/cuda/aa_conv_branch.py:pack_weight): torch's
// Conv1d weight [Cout, Cin, k], zero-padded to a multiple of 64 channels, as
// [k][Cout / 64][Cin / 64] tiles of 64 x 64, each tile 8 planes (one per 8
// input channels, 16 bytes in bf16) of 64 output-channel rows: a tile is one
// contiguous 8 KB block in exactly the order the tensor cores read it from
// shared memory. bias [C]; alpha and beta [C] float32, already exponentiated
// for log-scale parameters. x, w, bias and out share one dtype.
//
// Bound: operations. The conv is 2 k C^2 flops per frame (13,000 per output
// byte pair at k = 11, C = 768), far above the card's ridge, and the
// activation is ~84 float32 operations per element on the CUDA cores, as long
// as a k = 3 product of 64 channels on the tensor cores. So the product runs
// on wgmma, and the activation is computed as few times as the register file
// allows and never in the product's way.
//
// bf16 design (aa_snake_dconv_wgmma_kernel), five warpgroups a block:
//  * The output tile is 192 channels x TN frames (TN = 128, or 64 when 128
//    would leave more than half of the SMs without a block): three consumer
//    warpgroups, each one wgmma M = 64 slice with its float32 accumulators in
//    registers. 192 divides every wide stage of the vocoder (768, 384, 192).
//  * The activation is computed once per frame tile, not once per output
//    block: the channel blocks of a frame tile form a thread block cluster
//    (4 blocks at C = 768, 2 at C = 384), each block's producers compute
//    1 / 4 or 1 / 2 of every 64-channel chunk and write it, through
//    distributed shared memory, into the activation buffer of every block of
//    the cluster. The first kernel computed it C / 64 times. What it costs:
//    one block per SM (640 threads, ~150 KB of shared memory), 2-byte remote
//    stores, and one cluster-scope fence per producer warp and chunk (a
//    release at cluster scope on every arrival is a device-wide memory
//    barrier each: with those the sharing gained nothing).
//  * Two producer warpgroups compute the activation of the next chunk while
//    the consumers multiply this one: a thread takes one channel and 16
//    consecutive frames, reads the 32 frames around them straight from global
//    memory (16-byte loads), keeps the 42 activated 2x-rate samples in
//    registers (K3's CUDA-core body, in phases over all samples so that
//    neighbouring instructions are independent) and writes 16 rounded values
//    into one of two activation buffers. mbarriers hand the buffers back and
//    forth: "full" counts the producer warps of the whole cluster, "empty"
//    its consumer warpgroups.
//  * The tap shift. The activation buffer is the B operand in the no-swizzle
//    K-major layout with the frames of one 16-byte channel group contiguous:
//    plane p (8 channels) holds row r at byte (p * KGS + r) * 16. A wgmma
//    descriptor then steps 128 bytes per 8 rows (SBO) and KGS * 16 bytes per
//    plane (LBO), and tap j is the same buffer with the start address moved
//    by j * d rows = j * d 16-byte units: no per-tap copy, any dilation. KGS
//    is odd, so the producers' 2-byte stores of 32 channels hit 32 banks.
//  * Weights: each consumer warpgroup streams its own 64 x 64 tiles (one per
//    chunk and tap) through a ring of four 8 KB slots with cp.async.bulk, one
//    copy a tile, completion on an mbarrier; a slot is refilled as soon as
//    the wgmma that read it has retired, so the next taps' weights arrive
//    while this tap multiplies. At most two wgmma groups are in flight.
//    Every frame tile streams all of its weights from the L2 cache: at k = 11
//    that traffic (~3 TB/s), not the tensor cores, bounds the kernel; sharing
//    it between the frame tiles of a cluster by multicast is left undone.
//  * Epilogue: accumulator + bias, rounded, through the warpgroup's (now
//    idle) ring as a 64 x TN tile, then 16-byte stores along time.
//  * Odd shapes: channels past C are zero rows of the packed weight and zero
//    rows of the activation; T of no 16-byte vector or unaligned pointers
//    take element-wise loads and stores; runs of frames that lie outside
//    [0, T) are written as zeros without being computed.
//
// float32 (aa_snake_dconv_f32_kernel) keeps the first kernel's staging and
// runs the conv on the CUDA cores in float32 (a plain FMA loop) from the same
// packed weight: it is for tests, not speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "approx_sin.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HALO = 6;       // input frames each side of K1's stencil
constexpr int MAX_SMEM = 232448;
constexpr int WT = 64;        // the packed weight's tile: 64 output x 64 input channels
constexpr int WT_ELEMS = WT * WT;

struct Taps {
  float f[12];
};

__host__ __device__ constexpr size_t align_up(size_t n, size_t a) { return (n + a - 1) / a * a; }

// element (tap j, output channel co, input channel ci) of the packed weight
__device__ __forceinline__ size_t packed_index(int j, int co, int ci, int ntiles) {
  const size_t tile = (static_cast<size_t>(j) * ntiles + (co >> 6)) * ntiles + (ci >> 6);
  return tile * WT_ELEMS + ((ci & 63) >> 3) * (WT * 8) + (co & 63) * 8 + (ci & 7);
}

// ---------------------------------------------------------------------------
// float32: the conv on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_TILE_T = 128;   // output frames per block
constexpr int F_TILE_CO = 64;   // output channels per block
constexpr int F_CK = 32;        // input channels per staged chunk
constexpr int F_THREADS = 256;  // 8 warps: 2 along channels x 4 along time
constexpr int F_ROW = F_CK + 1;
constexpr int F_OUT_ROW = F_TILE_T + 4;

// Shared memory: region 0 holds the staged x rows, then (aliasing them) the
// time-major activation tile; region 1 the 2x-rate samples; the epilogue's
// output tile reuses regions 0 and 1; region 2 the weight slice.
struct FSmem {
  size_t act_off, ws_off, total;
};

__host__ __device__ inline FSmem f_smem_layout(int K, int h) {
  const int text = F_TILE_T + 2 * h;
  const size_t xs = static_cast<size_t>(F_CK) * (text + 2 * HALO) * sizeof(float);
  const size_t as = static_cast<size_t>(text) * F_ROW * sizeof(float);
  const size_t r0 = align_up(xs > as ? xs : as, 16);
  const size_t r1 = align_up(static_cast<size_t>(F_CK) * (2 * text + 11) * sizeof(float), 16);
  const size_t out = align_up(static_cast<size_t>(F_TILE_CO) * F_OUT_ROW * sizeof(float), 16);
  const size_t ws_off = r0 + r1 > out ? r0 + r1 : out;
  const size_t ws = align_up(static_cast<size_t>(K) * F_TILE_CO * F_ROW * sizeof(float), 16);
  return {r0, ws_off, ws_off + ws};
}

__global__ void __launch_bounds__(F_THREADS)
aa_snake_dconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wp, const float* __restrict__ bias,
                          float* __restrict__ out, const float* __restrict__ alpha, const float* __restrict__ beta,
                          int C, int T_len, int K, int dil, int ntiles, Taps taps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = (K - 1) * dil / 2;
  const int text = F_TILE_T + 2 * h;  // activation rows: the tile and the conv's halo
  const int xl = text + 2 * HALO;     // staged x frames per channel
  const int al = 2 * text + 11;       // activated 2x-rate samples per channel
  const FSmem lay = f_smem_layout(K, h);
  float* xs = reinterpret_cast<float*>(smem);
  float* act = reinterpret_cast<float*>(smem);  // aliases xs once it is consumed
  float* acts = reinterpret_cast<float*>(smem + lay.act_off);
  float* ws = reinterpret_cast<float*>(smem + lay.ws_off);
  float* ostage = reinterpret_cast<float*>(smem);

  const int t0 = blockIdx.x * F_TILE_T;
  const int co0 = blockIdx.y * F_TILE_CO;
  const int b = blockIdx.z;
  const float* xb = x + static_cast<size_t>(b) * C * T_len;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1;   // 32-channel half of the tile
  const int wn = warp >> 1;  // 32-frame quarter of the tile
  const int tbase = t0 - h;  // frame of activation row 0
  const int last2 = 2 * T_len - 1;

  float acc[32];  // acc[cc * 8 + tt], 4 channels x 8 frames
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += F_CK) {
    // 1. the weight slice ws[j][co][ci] of the chunk's input channels (zero past C: the packed weight's padding)
#pragma unroll 4
    for (int i = tid; i < K * F_TILE_CO * F_CK; i += F_THREADS) {
      const int row = i / F_CK, ci = i - row * F_CK;
      const int j = row / F_TILE_CO, co = row - j * F_TILE_CO;
      ws[row * F_ROW + ci] = wp[packed_index(j, co0 + co, c0 + ci, ntiles)];
    }
    //    the x rows, replicate-clamped, one warp to a channel row
    for (int ci = warp; ci < F_CK; ci += F_THREADS / 32) {
      const float* xr = xb + static_cast<size_t>(min(c0 + ci, C - 1)) * T_len;
      const bool live = c0 + ci < C;
#pragma unroll 4
      for (int j = lane; j < xl; j += 32) {
        xs[ci * xl + j] = live ? xr[min(max(tbase - HALO + j, 0), T_len - 1)] : 0.0f;
      }
    }
    __syncthreads();

    // 2. activated 2x-rate samples m = 2*tbase - 5 + j2, clamped to the
    //    signal, one warp to a channel row
    for (int ci = warp; ci < F_CK; ci += F_THREADS / 32) {
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
        const float sn = sinf(y * a);
        acts[ci * al + j2] = y + inv_b * (sn * sn);
      }
    }
    __syncthreads();

    // 3. downsampled activation, time-major; zero outside [0, T) (the conv's
    //    padding) and past C
    for (int i = tid; i < text * F_CK; i += F_THREADS) {
      const int tt = i / F_CK, ci = i - tt * F_CK;
      const int t = tbase + tt;
      float z = 0.0f;
      if (t >= 0 && t < T_len && c0 + ci < C) {
        const float* ap = acts + ci * al + 2 * tt;
#pragma unroll
        for (int k = 0; k < 12; ++k) z += taps.f[k] * ap[k];
      }
      act[tt * F_ROW + ci] = z;
    }
    __syncthreads();

    // 4. the k taps over this chunk: tap j is the same tile shifted by j * dil rows
    const int co_l = wm * 32 + (lane >> 2) * 4, t_l = wn * 32 + (lane & 3) * 8;
    for (int j = 0; j < K; ++j) {
      for (int ci = 0; ci < F_CK; ++ci) {
        float wv[4], av[8];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) wv[cc] = ws[(j * F_TILE_CO + co_l + cc) * F_ROW + ci];
#pragma unroll
        for (int tt = 0; tt < 8; ++tt) av[tt] = act[(t_l + tt + j * dil) * F_ROW + ci];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int tt = 0; tt < 8; ++tt) acc[cc * 8 + tt] = fmaf(wv[cc], av[tt], acc[cc * 8 + tt]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: the tile through shared memory, + bias, rows along time
  {
    const int co_l = wm * 32 + (lane >> 2) * 4, t_l = wn * 32 + (lane & 3) * 8;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int tt = 0; tt < 8; ++tt) ostage[(co_l + cc) * F_OUT_ROW + t_l + tt] = acc[cc * 8 + tt];
    }
  }
  __syncthreads();
  for (int i = tid; i < F_TILE_CO * F_TILE_T; i += F_THREADS) {
    const int co = i / F_TILE_T, tl = i - co * F_TILE_T;
    if (co0 + co < C && t0 + tl < T_len) {
      out[(static_cast<size_t>(b) * C + co0 + co) * T_len + t0 + tl] = ostage[co * F_OUT_ROW + tl] + bias[co0 + co];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the conv on wgmma
// ---------------------------------------------------------------------------

constexpr int CK = 64;              // input channels per chunk: one packed tile, four k16 steps
constexpr int CONSUMERS = 3;        // warpgroups, 64 output channels each
constexpr int PRODUCERS = 2;        // warpgroups computing the activation
constexpr int THREADS = (CONSUMERS + PRODUCERS) * 128;
constexpr int PROD_THREADS = PRODUCERS * 128;
constexpr int NW = 4;               // weight ring slots per consumer warpgroup
constexpr int WT_BYTES = WT_ELEMS * 2;
constexpr int RUN = 16;             // output frames per producer item
constexpr int MAX_H16 = 64;         // the conv's halo, rounded up to a run, at most
constexpr int NBARS = 4 + CONSUMERS * NW;

// Shared memory: two activation buffers of 8 planes x KGS rows x 16 bytes,
// the consumers' weight rings, the mbarriers.
struct WSmem {
  int text, kgs;
  size_t act_bytes, ring_off, bar_off, total;
};

__host__ __device__ inline WSmem w_smem_layout(int tn, int h16) {
  WSmem s;
  s.text = tn + 2 * h16;  // activation rows: the tile and the halo, whole runs
  s.kgs = s.text + 1;     // rows per plane, odd
  s.act_bytes = align_up(static_cast<size_t>(8) * s.kgs * 16, 128);
  s.ring_off = 2 * s.act_bytes;
  s.bar_off = s.ring_off + static_cast<size_t>(CONSUMERS) * NW * WT_BYTES;
  s.total = s.bar_off + NBARS * sizeof(uint64_t);
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase differs from `parity`. A wait that lasts
// seconds is a broken pipeline: trap, so the launch fails instead of hanging.
// `cluster`: the arrivals come from other blocks of the cluster (acquire at cluster scope).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity, bool cluster = false) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    if (cluster) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    } else {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    }
    if (done) return;
    if ((spins & 0x3ff) == 0x3ff) {
      if (start == 0) {
        start = clock64();
      } else if (clock64() - start > (1LL << 33)) {
        __trap();
      }
    }
  }
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the 128 threads of consumer warpgroup `wg` (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory"); }

// No-swizzle K-major operand: 8-row x 16-byte core matrices; lbo = bytes
// between the two planes of a k16 step, sbo = bytes between 8-row groups.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int TN>
__device__ __forceinline__ void wgmma_k16(float (&d)[TN / 2], uint64_t a, uint64_t b) {
  if constexpr (TN == 128) {
    wgmma_m64n128k16(d, a, b);
  } else {
    wgmma_m64n64k16(d, a, b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x, the low half, is lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The activation of one channel at 16 consecutive frames t .. t+15 (t a
// multiple of 16, 0 <= t < T) from the 32 frames xr[i] = x[clamp(t - 8 + i)].
// Sample u is 2x-rate index m = 2t - 5 + u; below the signal (only at t = 0:
// u < 5) it is sample u = 5, above it (u > u_hi) sample u_hi: the composed
// path's two replicate pads. Written in phases over all 42 samples (up taps,
// snake, pads, down taps), so that neighbouring instructions are independent
// and a lone warp keeps the pipeline busy.
__device__ __forceinline__ void activation_run(const float (&xr)[32], float a, float inv_b, int t, int T_len,
                                               const Taps& taps, float (&z)[RUN]) {
  constexpr int NS = 2 * RUN + 10;
  float v[NS];
#pragma unroll
  for (int u = 0; u < NS; ++u) {
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
    v[u] = 2.0f * y;
  }
#pragma unroll
  for (int u = 0; u < NS; ++u) {
    const float s = poly_sin(v[u] * a);
    v[u] = v[u] + inv_b * (s * s);
  }
  if (t == 0) {
#pragma unroll
    for (int u = 0; u < 5; ++u) v[u] = v[5];
  }
  const int u_hi = 2 * (T_len - t) + 4;
  if (u_hi < NS - 1) {  // the run reaches the signal's end
    float last = 0.0f;
#pragma unroll
    for (int u = 0; u < NS; ++u) {
      if (u <= u_hi) {
        last = v[u];
      } else {
        v[u] = last;
      }
    }
  }
  // z[q] = sum_j f[j] * a[2(t + q) + j - 5]: sample u meets output q at j = u - 2q
#pragma unroll
  for (int q = 0; q < RUN; ++q) z[q] = 0.0f;
#pragma unroll
  for (int u = 0; u < NS; ++u) {
#pragma unroll
    for (int q = 0; q < RUN; ++q) {
      const int j = u - 2 * q;
      if (j >= 0 && j < 12) z[q] = fmaf(taps.f[j], v[u], z[q]);
    }
  }
}

// ---- thread block clusters: the blocks of one frame tile share the activation ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// the address, in the cluster's shared window, of this block's shared address `addr` in block `rank`
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster_u16(uint32_t addr, unsigned short v) {
  asm volatile("st.shared::cluster.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}
// Arrive on a barrier of another block of the cluster. The arrival itself
// orders nothing beyond this block: a thread that publishes data to the
// other block fences at cluster scope once, before its arrivals.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(addr) : "memory");
}
__device__ __forceinline__ void fence_cluster() { asm volatile("fence.acq_rel.cluster;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int TN>
__global__ void __launch_bounds__(THREADS, 1)
aa_snake_dconv_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp, const bf16* __restrict__ bias,
                            bf16* __restrict__ out, const float* __restrict__ alpha, const float* __restrict__ beta,
                            int C, int T_len, int K, int dil, int ntiles, int vec_ok, Taps taps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7, wtid = tid & 127;
  const int h = (K - 1) * dil / 2;
  const int h16 = (h + RUN - 1) / RUN * RUN;
  const WSmem lay = w_smem_layout(TN, h16);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* act_full = bars;       // [2]: every producer warp of the cluster arrives
  uint64_t* act_empty = bars + 2;  // [2]: one thread of every active consumer warpgroup of the cluster arrives

  // The cluster is CS blocks along y: the same frame tile, consecutive
  // 192-channel output blocks. Each computes 1 / CS of every activation
  // chunk and writes it into all CS blocks' buffers.
  const int CS = static_cast<int>(cluster_size());
  const int rank = static_cast<int>(cluster_rank());
  const int t0 = blockIdx.x * TN;
  const int tile0 = blockIdx.y * CONSUMERS;  // the block's first 64-channel output tile
  const int b = blockIdx.z;
  const int n_active = max(0, min(CONSUMERS, ntiles - tile0));
  const int cluster_tile0 = (blockIdx.y - rank) * CONSUMERS;
  const int n_active_cluster = min(CONSUMERS * CS, ntiles - cluster_tile0);
  const int nchunks = ntiles;
  const int tb = t0 - h16;      // frame of activation row 0, a multiple of 16
  const int rowoff = h16 - h;   // activation row that tap 0 reads for output frame t0

  if (tid == 0) {
    mbar_init(&act_full[0], (PROD_THREADS / 32) * CS);
    mbar_init(&act_full[1], (PROD_THREADS / 32) * CS);
    mbar_init(&act_empty[0], n_active_cluster);
    mbar_init(&act_empty[1], n_active_cluster);
    for (int i = 0; i < CONSUMERS * NW; ++i) mbar_init(&bars[4 + i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (CS > 1) cluster_sync_all();  // every block's barriers exist before a neighbour arrives on them

  if (wg >= CONSUMERS) {
    // ---- producers: this block's share of the activation of chunk c, into buffer c & 1 of every block ----
    const int pwarp = (tid - CONSUMERS * 128) >> 5, lane = tid & 31;
    const bf16* xb = x + static_cast<size_t>(b) * C * T_len;
    const int units = 2 * (lay.text / RUN);  // a unit: 32 channels of one run of 16 frames, one warp's work
    for (int c = 0; c < nchunks; ++c) {
      mbar_wait(&act_empty[c & 1], ((c >> 1) & 1) ^ 1, CS > 1);
      unsigned char* buf = smem + (c & 1) * lay.act_bytes;
      // unit u belongs to block u mod CS; a block's units go round its warps
      for (int u = rank + CS * pwarp; u < units; u += CS * (PROD_THREADS / 32)) {
        const int cil = (u & 1) * 32 + lane, r = u >> 1;
        const int ci = c * CK + cil;
        const int t = tb + RUN * r;
        float z[RUN];
        if (ci < C && t >= 0 && t < T_len) {
          const bf16* row = xb + static_cast<size_t>(ci) * T_len;
          const int f0 = t - 8;
          float xr[32];
          if (vec_ok && f0 >= 0 && f0 + 32 <= T_len) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + f0) + k);
              const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float2 f = __bfloat1622float2(hp[j]);
                xr[8 * k + 2 * j] = f.x;
                xr[8 * k + 2 * j + 1] = f.y;
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < 32; ++i) xr[i] = __bfloat162float(row[min(max(f0 + i, 0), T_len - 1)]);
          }
          activation_run(xr, alpha[ci], 1.0f / (beta[ci] + 1e-9f), t, T_len, taps, z);
#pragma unroll
          for (int q = 0; q < RUN; ++q) {
            if (t + q >= T_len) z[q] = 0.0f;  // the conv's zero padding
          }
        } else {
#pragma unroll
          for (int q = 0; q < RUN; ++q) z[q] = 0.0f;
        }
        bf16* dst = reinterpret_cast<bf16*>(buf + (static_cast<size_t>(cil >> 3) * lay.kgs + RUN * r) * 16) + (cil & 7);
        if (CS == 1) {
#pragma unroll
          for (int q = 0; q < RUN; ++q) dst[q * 8] = __float2bfloat16(z[q]);
        } else {
          const uint32_t local = smem_u32(dst);
          for (int peer = 0; peer < CS; ++peer) {
            const uint32_t remote = map_to_rank(local, peer);
#pragma unroll
            for (int q = 0; q < RUN; ++q) {
              const bf16 v = __float2bfloat16(z[q]);
              st_cluster_u16(remote + q * 16, *reinterpret_cast<const unsigned short*>(&v));
            }
          }
        }
      }
      // these writes, before the tensor cores' reads: every lane fences its
      // own, the warp joins, one lane tells every block of the cluster
      asm volatile("fence.proxy.async;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) {
        if (CS == 1) {
          mbar_arrive(&act_full[c & 1]);
        } else {
          fence_cluster();  // once: the warp's remote writes, before the arrivals that announce them
          const uint32_t local = smem_u32(&act_full[c & 1]);
          for (int peer = 0; peer < CS; ++peer) mbar_arrive_remote(map_to_rank(local, peer));
        }
      }
    }
  } else if (wg < n_active) {
    // ---- consumers: output channels 64 (tile0 + wg) .. + 63 ----
    const int ct = tile0 + wg;
    uint64_t* w_full = bars + 4 + wg * NW;
    unsigned char* ring = smem + lay.ring_off + static_cast<size_t>(wg) * NW * WT_BYTES;
    const int total = nchunks * K;  // (chunk, tap) iterations
    int next_fill = 0;
    // thread 0: start the copies of iterations < limit that are not yet on their way
    auto fill = [&](int limit) {
      while (next_fill < limit && next_fill < total) {
        const int c = next_fill / K, j = next_fill - c * K, slot = next_fill % NW;
        const bf16* src = wp + ((static_cast<size_t>(j) * ntiles + ct) * ntiles + c) * WT_ELEMS;
        mbar_expect_tx(&w_full[slot], WT_BYTES);
        bulk_copy_g2s(ring + slot * WT_BYTES, src, WT_BYTES, &w_full[slot]);
        ++next_fill;
      }
    };
    if (wtid == 0) fill(NW);

    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.0f;
    const uint64_t desc_a0 = make_desc(smem_u32(ring), WT * 16, 128);
    const uint64_t desc_b0 = make_desc(smem_u32(smem), static_cast<uint32_t>(lay.kgs) * 16, 128) + rowoff;
    int it = 0;
    for (int c = 0; c < nchunks; ++c) {
      mbar_wait(&act_full[c & 1], (c >> 1) & 1, CS > 1);
      if (CS > 1) fence_proxy_async();  // other blocks' writes, seen by the wait, before this thread's wgmma reads
      const uint64_t desc_b = desc_b0 + static_cast<uint64_t>(((c & 1) * lay.act_bytes) >> 4);
      for (int j = 0; j < K; ++j) {
        const int slot = it % NW;
        mbar_wait(&w_full[slot], (it / NW) & 1);
        wgmma_fence();
        const uint64_t da = desc_a0 + static_cast<uint64_t>((slot * WT_BYTES) >> 4);
        const uint64_t db = desc_b + static_cast<uint64_t>(j * dil);  // tap j: j * dil rows of 16 bytes further
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks) {
          wgmma_k16<TN>(acc, da + static_cast<uint64_t>(ks * 2 * WT), db + static_cast<uint64_t>(ks * 2 * lay.kgs));
        }
        wgmma_commit();
        wgmma_wait<1>();  // iteration it - 1 has retired: its slot is free
        wg_sync(wg);
        if (wtid == 0) fill(it + NW);
        ++it;
      }
      wgmma_wait<0>();
      wg_sync(wg);
      if (wtid == 0) {
        fill(it + NW);
        if (CS == 1) {
          mbar_arrive(&act_empty[c & 1]);
        } else {  // every block's producers write this buffer in every block
          const uint32_t local = smem_u32(&act_empty[c & 1]);
          for (int peer = 0; peer < CS; ++peer) mbar_arrive_remote(map_to_rank(local, peer));
        }
      }
    }

    // epilogue: + bias in float32, rounded, through the idle ring as [64][TN + 8], 16-byte stores along time
    constexpr int SROW = TN + 8;
    bf16* stg = reinterpret_cast<bf16*>(ring);
    const int lane = wtid & 31, g = lane >> 2, q = lane & 3;
    const int row_l = 16 * (wtid >> 5) + g;
    const int co_a = ct * WT + row_l, co_b = co_a + 8;
    const float bias_a = co_a < C ? __bfloat162float(bias[co_a]) : 0.0f;
    const float bias_b = co_b < C ? __bfloat162float(bias[co_b]) : 0.0f;
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
      *reinterpret_cast<uint32_t*>(stg + row_l * SROW + 8 * i + 2 * q) =
          pack_bf16(acc[4 * i] + bias_a, acc[4 * i + 1] + bias_a);
      *reinterpret_cast<uint32_t*>(stg + (row_l + 8) * SROW + 8 * i + 2 * q) =
          pack_bf16(acc[4 * i + 2] + bias_b, acc[4 * i + 3] + bias_b);
    }
    wg_sync(wg);
    for (int idx = wtid; idx < WT * (TN / 8); idx += 128) {
      const int row = idx / (TN / 8), v = idx - row * (TN / 8);
      const int co = ct * WT + row, t = t0 + 8 * v;
      if (co < C && t < T_len) {
        const bf16* src = stg + row * SROW + 8 * v;
        bf16* dst = out + (static_cast<size_t>(b) * C + co) * T_len + t;
        if (vec_ok) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && t + e < T_len; ++e) dst[e] = src[e];
        }
      }
    }
  }
  if (CS > 1) cluster_sync_all();  // no block leaves while a neighbour may still write or arrive here
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || count <= 0) {
      count = 132;
    }
  }
  return count;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, size_t& configured) {
  if (bytes > static_cast<size_t>(MAX_SMEM)) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > configured) {  // the largest dynamic shared memory set for this kernel so far
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = bytes;
  }
  return 0;
}

template <int TN>
int launch_wgmma(const void* x, const void* wp, const void* bias, void* out, const float* alpha, const float* beta,
                 int B, int C, int T_len, int K, int dil, int ntiles, int h16, int vec_ok, const Taps& taps,
                 cudaStream_t s) {
  const WSmem lay = w_smem_layout(TN, h16);
  static size_t configured = 0;
  const int err = set_smem(aa_snake_dconv_wgmma_kernel<TN>, lay.total, configured);
  if (err != 0) return err;
  const int blocks_y = (ntiles + CONSUMERS - 1) / CONSUMERS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T_len + TN - 1) / TN, blocks_y, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = s;
  // the channel blocks of one frame tile in clusters of 4, or 2, where they divide so
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = blocks_y % 4 == 0 ? 4 : (blocks_y % 2 == 0 ? 2 : 1);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, aa_snake_dconv_wgmma_kernel<TN>, static_cast<const bf16*>(x), static_cast<const bf16*>(wp),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), alpha, beta, C, T_len, K, dil, ntiles, vec_ok, taps);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// x, out: device [B, C, T]; wp: device packed weight (the header note; k *
// ceil(C / 64)^2 tiles of 64 x 64); bias: device [C], all in one dtype (0 =
// float32, 1 = bfloat16); alpha, beta: device float32 [C]; taps: host pointer
// to the 12 filter taps; stream: the cudaStream_t to launch on. K odd, (K -
// 1) * dil even. Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for arguments the kernel cannot take.
extern "C" int indextts_aa_snake_dconv(const void* x, const void* wp, const void* bias, void* out,
                                       const void* alpha, const void* beta, int B, int C, int T, int K,
                                       int dil, int dtype, const float* taps, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || (C + WT - 1) / WT > 65535 || T <= 0 || K <= 0 || K % 2 == 0 || dil <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps tp;
  for (int k = 0; k < 12; ++k) tp.f[k] = taps[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(alpha);
  const float* b = static_cast<const float*>(beta);
  const int ntiles = (C + WT - 1) / WT;
  const int h = (K - 1) * dil / 2;
  if (dtype == 0) {
    const FSmem lay = f_smem_layout(K, h);
    static size_t configured = 0;
    const int err = set_smem(aa_snake_dconv_f32_kernel, lay.total, configured);
    if (err != 0) return err;
    const dim3 grid((T + F_TILE_T - 1) / F_TILE_T, (C + F_TILE_CO - 1) / F_TILE_CO, B);
    aa_snake_dconv_f32_kernel<<<grid, F_THREADS, lay.total, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wp), static_cast<const float*>(bias),
        static_cast<float*>(out), a, b, C, T, K, dil, ntiles, tp);
    return static_cast<int>(cudaGetLastError());
  }
  const int h16 = (h + RUN - 1) / RUN * RUN;
  if (h16 > MAX_H16) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_ok = T % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // 128-frame tiles (half the weight traffic of 64-frame tiles, a wider wgmma) unless they would leave more
  // than half of the SMs without a block
  const long long blocks128 = static_cast<long long>((T + 127) / 128) * ((ntiles + CONSUMERS - 1) / CONSUMERS) * B;
  if (2 * blocks128 < sm_count()) {
    return launch_wgmma<64>(x, wp, bias, out, a, b, B, C, T, K, dil, ntiles, h16, vec_ok, tp, s);
  }
  return launch_wgmma<128>(x, wp, bias, out, a, b, B, C, T, K, dil, ntiles, h16, vec_ok, tp, s);
}
