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
// output channel per row, torch Linear's layout, no packing); scale [N]
// float32; bias [N] in x's dtype or absent; out [M, N] in x's dtype.
//
// Bound: bytes. M is the decode batch (1-16), so each weight byte meets at
// most 16 multiply-adds, far under the card's operations-per-byte ridge, and
// the int8 weights (N * K bytes) are nearly all the traffic. A decode matrix
// is 1.6-10.5 MB, which the card streams in 0.5-3 us, so a launch lasts about
// as long as a few trips to device memory: what counts is that every weight
// byte is requested early and read once, that every SM takes part (turning
// int8 into bf16 costs ~3 instructions a byte; 40 blocks of four warps alone
// need 7-17 us for a matrix), and that little is waited for twice.
//
// Design:
//  * The product runs on the tensor cores with the weights as the 16-row
//    operand: mma.sync m16n8k16, A = 16 output channels x 16 k (int8 turned
//    into bf16 exactly), B = x^T, 8 rows of x a tile, two tiles for M <= 16.
//    One x fragment serves 16 channels, and M <= 16 reads the weights once.
//  * A warp owns 16 channels. Per 64 k it issues two 16-byte loads a lane
//    (rows g and g + 8 of its channel group, lane q of each four taking bytes
//    16q .. 16q+15, so four lanes read 64 consecutive bytes of a row and every
//    sector is used whole). The sum over k has no order, so the mma's k index
//    is permuted to fit: word s of a lane's 16 bytes is mma step s, bytes
//    4s, 4s+1 its columns 2q, 2q+1 and bytes 4s+2, 4s+3 its columns 2q+8,
//    2q+9; the x fragment is read with the same permutation (two 16-byte
//    shared-memory loads per 8 rows of x and 64 k, conflict-free on rows
//    padded by 16 bytes). The loads of four such steps (8 per lane, 4 KB a
//    warp) are issued before the first is used, and the next four while
//    these multiply.
//  * A block is four warps = 64 channels over one slice of K; it stages its
//    slice of x in shared memory as bf16 once, after its first weight loads
//    are on their way. Short N gets split-K: 2, 4 or 8 blocks along K form a
//    thread block cluster, each leaves its partial 64 x M tile in its own
//    shared memory, and after a cluster barrier block r sums channel slice r
//    over the cluster's blocks in rank order through distributed shared
//    memory, scales, rounds, adds the bias and stores. The order is fixed, so
//    two runs give the same bits; no atomics.
//  * What was measured and left out (ops/cuda/qmatmul.py names the script):
//    an empty launch of this shape takes ~2 us and a launch of clusters
//    1.3-1.7 us more; summing through a scratch buffer and a ticket counter
//    instead (a plain launch) took the same time in all, as did pushing the
//    partial tiles into the first block by remote stores; a cp.async ring
//    with 16 steps in flight per warp was no faster than the 4 + 4 steps in
//    registers; blocks over all of K with no reduction at all left too few
//    warps to convert the bytes.
//  * int8 -> bf16: xor 0x80 makes the byte v + 128; a byte permute drops it
//    into the mantissa of 2^23, a float subtraction of 2^23 + 128 leaves v,
//    and the high halves of two such floats are the bf16 pair.
//  * Tails: channels past N and k past K load zeros; K not a multiple of 16
//    or an unaligned weight pointer takes byte loads into the same registers;
//    x that cannot be read as 16-byte vectors is staged element-wise; M > 16
//    takes more blocks along z (the weights are read once per 16 rows).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;                 // 16-channel groups per block
constexpr int THREADS = WARPS * 32;
constexpr int NB = WARPS * 16;           // output channels per block
constexpr int STEP = 64;                 // k per warp step: 16 bytes a lane, four lanes a row
constexpr int BATCH = 4;                 // steps whose loads are issued together
constexpr int KC = 1024;                 // x columns staged at a time (a multiple of BATCH * STEP)
constexpr int XPAD = 8;                  // bf16 of padding per staged x row: 16 bytes
constexpr int MAX_SPLIT = 8;             // blocks of a cluster along K

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  const __nv_bfloat16 h = __float2bfloat16(v);
  return *reinterpret_cast<const unsigned short*>(&h);
}
__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) { return *reinterpret_cast<const unsigned short*>(&v); }

// four int8 (bytes 0..3 of w) as two bf16 pairs: lo = (b0, b1), hi = (b2, b3)
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // v + 128 in each byte
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
  // |v| <= 128 is exact in bf16: the pair is the two floats' high halves
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 weight bytes of channel n at k .. k+15; zeros past N or K
template <bool VEC>
__device__ __forceinline__ uint4 load_w(const int8_t* __restrict__ wq, int n, int k, int N, int K) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (n < N && k < K) {
    const int8_t* p = wq + static_cast<size_t>(n) * K + k;
    if (VEC) {
      v = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (k + j < K) w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * (j & 3));
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  return v;
}

// NT: 8-row tiles of x a block takes (1 or 2). VEC: 16-byte weight loads.
template <typename T, int NT, bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ scale,
                   const T* __restrict__ bias, T* __restrict__ out, int M, int N, int K, int kb, int xvec) {
  constexpr int MT = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kc_cap = kb < KC ? kb : KC;
  const int xs_row = kc_cap + XPAD;                                        // elements
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);              // [MT][xs_row]
  float* part = reinterpret_cast<float*>(smem + static_cast<size_t>(MT) * xs_row * 2);  // [NB][MT]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;   // the cluster spans the grid's x axis: the block's rank
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.y * NB;
  const int m0 = blockIdx.z * 16;
  const int ng = n0 + warp * 16 + g;  // the lane's two weight rows: ng and ng + 8
  const int k0 = split * kb;
  const int kend = min(K, k0 + kb);
  const int nsteps = kend > k0 ? (kend - k0 + STEP - 1) / STEP : 0;

  uint4 wg[BATCH], wh[BATCH];
  auto load_batch = [&](uint4 (&a)[BATCH], uint4 (&b)[BATCH], int s0) {
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int k = (s0 + i < nsteps) ? k0 + (s0 + i) * STEP + 16 * q : K;
      a[i] = load_w<VEC>(wq, ng, k, N, K);
      b[i] = load_w<VEC>(wq, ng + 8, k, N, K);
    }
  };
  load_batch(wg, wh, 0);  // on their way while x is staged

  // acc[t][e]: x tile t, accumulator set e (even and odd mma steps, two
  // independent chains), the mma's four values: (channel g, rows 2q, 2q+1 of
  // x) and (channel g + 8, the same rows)
  float acc[NT][2][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) acc[t][e][0] = acc[t][e][1] = acc[t][e][2] = acc[t][e][3] = 0.0f;
  }

  for (int c0 = 0; c0 < nsteps * STEP; c0 += KC) {
    const int kc = min(kc_cap, nsteps * STEP - c0);  // a multiple of STEP
    if (c0 > 0) __syncthreads();                     // the previous columns are consumed
    // stage rows m0 .. m0+MT-1, columns k0+c0 .. +kc-1 of x as bf16; zeros past M and K
    if (xvec) {
      constexpr int V = 16 / sizeof(T);
      const int per_row = kc / V;
      for (int i = tid; i < MT * per_row; i += THREADS) {
        const int m = i / per_row, kv = (i - m * per_row) * V;
        const int k = k0 + c0 + kv;
        uint32_t h[V];
        if (m0 + m < M && k < K) {  // K is a multiple of V: the vector is whole
          const uint4 raw = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + m) * K + k);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < V; ++j) h[j] = bf16_bits(e[j]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) h[j] = 0u;
        }
        uint32_t* dst = reinterpret_cast<uint32_t*>(xs + m * xs_row + kv);
#pragma unroll
        for (int j = 0; j < V / 2; ++j) dst[j] = h[2 * j] | (h[2 * j + 1] << 16);
      }
    } else {
      for (int i = tid; i < MT * kc; i += THREADS) {
        const int m = i / kc, kk = i - m * kc;
        const int k = k0 + c0 + kk;
        const float v = (m0 + m < M && k < K) ? to_f(x[static_cast<size_t>(m0 + m) * K + k]) : 0.0f;
        xs[m * xs_row + kk] = __float2bfloat16(v);
      }
    }
    __syncthreads();

    for (int s0 = c0 / STEP; s0 < (c0 + kc) / STEP; s0 += BATCH) {
      uint4 ng_[BATCH], nh_[BATCH];
      load_batch(ng_, nh_, s0 + BATCH);  // the next steps' loads, before these are used
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        if (s0 + i < (c0 + kc) / STEP) {
          const int col = (s0 + i) * STEP - c0 + 16 * q;
          uint32_t xb[NT][8];
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const uint4* xp = reinterpret_cast<const uint4*>(xs + (8 * t + g) * xs_row + col);
            const uint4 lo = xp[0], hi = xp[1];
            xb[t][0] = lo.x, xb[t][1] = lo.y, xb[t][2] = lo.z, xb[t][3] = lo.w;
            xb[t][4] = hi.x, xb[t][5] = hi.y, xb[t][6] = hi.z, xb[t][7] = hi.w;
          }
          const uint32_t wa[4] = {wg[i].x, wg[i].y, wg[i].z, wg[i].w};
          const uint32_t wb[4] = {wh[i].x, wh[i].y, wh[i].z, wh[i].w};
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            uint32_t a[4];
            int8x4_to_bf16(wa[s], a[0], a[2]);
            int8x4_to_bf16(wb[s], a[1], a[3]);
#pragma unroll
            for (int t = 0; t < NT; ++t) mma_bf16(acc[t][s & 1], a, xb[t][2 * s], xb[t][2 * s + 1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) wg[i] = ng_[i], wh[i] = nh_[i];
    }
  }

  // the block's partial tile, part[channel][row of x]
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float* p = part + (warp * 16 + g) * MT + 8 * t + 2 * q;
    p[0] = acc[t][0][0] + acc[t][1][0];
    p[1] = acc[t][0][1] + acc[t][1][1];
    p[8 * MT] = acc[t][0][2] + acc[t][1][2];
    p[8 * MT + 1] = acc[t][0][3] + acc[t][1][3];
  }
  cluster.sync();

  // block `split` finishes channels split * per .. + per - 1: partials summed
  // in rank order, then the scale, the two roundings and the bias
  const int per = NB / nsplit;
  for (int i = tid; i < per * MT; i += THREADS) {
    const int m = i / per, c = split * per + (i - m * per);
    float sum = 0.0f;
    for (int r = 0; r < nsplit; ++r) sum += cluster.map_shared_rank(part, r)[c * MT + m];
    const int n = n0 + c;
    if (n < N && m0 + m < M) {
      float o = round_as(sum * scale[n], x);
      if (bias != nullptr) o = o + to_f(bias[n]);
      store_f(out + static_cast<size_t>(m0 + m) * N + n, o);
    }
  }
  cluster.sync();  // no block leaves while another reads its partial tile
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

// Blocks along K: the least of 1, 2, 4, 8 that gives every SM a block, while
// a block keeps at least two 64-k steps.
int choose_split(int N, int K) {
  const int blocks_n = (N + NB - 1) / NB;
  const int steps = (K + STEP - 1) / STEP;
  int split = 1;
  while (split < MAX_SPLIT && blocks_n * split < sm_count() && steps / (2 * split) >= 2) split *= 2;
  return split;
}

template <typename T, int NT, bool VEC>
int launch(const void* x, const void* wq, const void* scale, const void* bias, void* out, int M, int N, int K,
           int split, int xvec, cudaStream_t s) {
  const int steps = (K + STEP - 1) / STEP;
  const int kb = ((steps + split - 1) / split) * STEP;  // k per block
  const int kc_cap = kb < KC ? kb : KC;
  const size_t smem = static_cast<size_t>(8 * NT) * (kc_cap + XPAD) * 2 + static_cast<size_t>(NB) * 8 * NT * 4;
  const dim3 grid(split, (N + NB - 1) / NB, (M + 15) / 16);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;  // under 48 KB: 16 x 1032 bf16 and the 4 KB tile
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // the blocks along K are one cluster
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, int8_matmul_kernel<T, NT, VEC>, static_cast<const T*>(x),
                                           static_cast<const int8_t*>(wq), static_cast<const float*>(scale),
                                           static_cast<const T*>(bias), static_cast<T*>(out), M, N, K, kb, xvec);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* wq, const void* scale, const void* bias, void* out, int M, int N, int K,
             int split, cudaStream_t s) {
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  const int xvec = K % (16 / static_cast<int>(sizeof(T))) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (M <= 8) {
    return vec ? launch<T, 1, true>(x, wq, scale, bias, out, M, N, K, split, xvec, s)
               : launch<T, 1, false>(x, wq, scale, bias, out, M, N, K, split, xvec, s);
  }
  return vec ? launch<T, 2, true>(x, wq, scale, bias, out, M, N, K, split, xvec, s)
             : launch<T, 2, false>(x, wq, scale, bias, out, M, N, K, split, xvec, s);
}

}  // namespace

// x: device [M, K]; wq: device int8 [N, K]; scale: device float32 [N]; bias:
// device [N] in x's dtype, or null; out: device [M, N]. dtype: 0 = float32,
// 1 = bfloat16 (x, bias and out). stream: the cudaStream_t to launch on.
// Returns the launch's error (0 on success).
extern "C" int indextts_int8_matmul(const void* x, const void* wq, const void* scale, const void* bias, void* out,
                                    int M, int N, int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + 15) / 16 > 65535 || (N + NB - 1) / NB > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int split = choose_split(N, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, wq, scale, bias, out, M, N, K, split, s);
  return dispatch<__nv_bfloat16>(x, wq, scale, bias, out, M, N, K, split, s);
}
