// K6: the decode step's attention over one layer's KV cache, for NVIDIA
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA
// (indextts_tpu/models/gpt_decode.py _decode_block and _decode_block_q), and
// the port ran it as plain PyTorch, ~17 operations a layer on the bf16 cache
// and ~35 on the int8 one, with a bf16 copy of the whole int8 cache layer
// made every step (ops/cuda/decode_attn.py keeps that arithmetic as the plain
// version). One launch a layer computes, for each row b and head h of the
// one new token,
//   s_j = (q . k_j) * ks_j * scale + bias_j      every column j not masked
//   s_* = (q . k_new) * scale                    the token's own logit
//   a   = (sum_j e^(s_j - m) vs_j v_j + e^(s_* - m) v_new)
//         / (sum_j e^(s_j - m) + e^(s_* - m))
// with ks_j = vs_j = 1 on a bf16 / float32 cache and scale the caller's (1 /
// sqrt(Dh) for GPT-2, granite-4.0-h's attention_multiplier for its layers),
// all in float32 and rounded once, to the output's dtype; then it writes
// k_new and v_new into column pos, on the int8 cache quantized as
// models/gpt_decode._quant_cols does (one scale per head pair: the float32
// amax over heads 2g and 2g + 1, at least 1e-8, times 1 / 127 as PyTorch's
// division by a host scalar computes it on the card; each value divided by
// that scale, rounded half to even, clamped at +-127).
//
// Column j is masked when bias_j is at or below float32's lowest value (the
// port's NEG, or -inf); column pos is skipped whatever its bias (it is masked
// in every step of the port's loops, JAX's base_mask), so its write never
// races with a read. Masked columns are not read: what they hold never
// reaches the result.
//
// Grouped-query attention: with G query heads a KV head, query head h * G + i
// (i < G) reads KV head h; G = 1 is multi-head attention.
//
// Layout: q [B, H * G, Dh], k_new, v_new [B, H, Dh] in the output's dtype
// (float32 or bf16), heads Dh apart and rows `qkv_stride` elements apart (the
// parts of the qkv projection, read in place); the cache [B, H, S, Dh] in that
// dtype, or int8 with the scales ks, vs [B, H/2, S] float32; bias [B, S]
// float32; pos one int64 on the device (a captured step reads no host value)
// or a value, inside [0, S) (the kernel traps on another); out [B, H * G * Dh].
//
// Bound: bytes. Each cache byte meets one multiply-add, far under the card's
// operations-per-byte ridge: the least time is the K/V cache (and its
// scales) read once, plus q, k, v, the bias and the output, over 3.35 TB/s.
// A layer's cache is 1.3-26 MB on the port's three loops (3 beams at S ~ 350
// to 32 int8 slots at S = 320): 0.4-8 us, as short as a few trips to device
// memory, so the design is about bytes in flight and filling the card.
//
// Design:
//  * A block owns one (row, KV head pair, query i of the group): the pair's
//    int8 scale and the write of column pos stay inside the blocks of i = 0.
//    The G blocks of a pair read the same columns, the later ones mostly from
//    L2 (the counts' bound reads each KV head once). Two warps a head split the
//    block's columns; each lane loads 16 bytes of a column (8 bf16, 16 int8,
//    4 float32 values), so Dh / (16 bytes) lanes take one column (4 lanes an
//    int8 head of 64, 8 a bf16 one) and a warp load reads whole columns,
//    consecutive in memory. q sits in float32 registers.
//  * Each lane group keeps an online softmax (running max, sum and its slice
//    of the weighted V) over its columns, four columns a round: the K and V
//    loads of a round are issued together, with the next round's bias loads
//    behind them, before any is used. The groups of a warp, the warps of a
//    head and the blocks of a cluster then merge their (max, sum, slice)
//    triples, the last through distributed shared memory.
//  * Where B * H/2 blocks would leave the card's SMs short, the columns are
//    also split over the 2-8 blocks of a thread block cluster (the least
//    power of two that gives two blocks an SM, while each block keeps at
//    least 32 columns). The split follows from B, H, S and the SM count, read
//    from the device: 30 pairs (3 beams) take 8 blocks each, 80 (a batch of
//    8) 4, 320 (32 slots) none.
//  * The new token's own logit and value seed the first lane group of the
//    cluster's first block; that block writes column pos after its columns
//    are read. Nothing else is launched, nothing allocated, no scores or
//    weights go to device memory.
//  * Timed on an H100 and left out (own us a layer for 8 rows / 3 beams on
//    the bf16 cache at S = 331, 32 int8 slots at S = 320; this design 8.7 /
//    6.8 / 14.1): four warps a head with a conversion instruction for int8,
//    10.1 / 7.2 / 22.0 (two warps with it, 9.2 / 7.3 / 17.5); no
//    split and eight warps a head, 8.3 / 7.1 / 26.8; one warp a head, 12.4 /
//    9.2 / 18.3; splits that give each SM one or four blocks instead of two,
//    or none, all slower (fewer leave SMs idle; more cost the cluster more
//    than they save); K / V loads not held back by the bias, 10.8 / 7.9 / 23.3
//    (the masked columns' bytes cost more than the wait on the bias); eight
//    columns a round, 13.7 / 7.6 / 32.9; the final cluster barrier with
//    release / acquire order, ~0.5 us more.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS_PER_HEAD = 2;
constexpr int THREADS = 2 * WARPS_PER_HEAD * 32;  // one head pair
constexpr int ROUND = 4;                           // columns a lane loads before it uses the first
constexpr int MAX_SPLIT = 8;                       // blocks of a cluster along S
constexpr int MIN_CHUNK = 32;                      // columns a block keeps at least
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the values of one 16-byte load as float32 (exact for each cache type)
__device__ __forceinline__ void unpack(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
// int8 -> float32 without a conversion instruction: xor 0x80 makes each byte
// v + 128, a byte permute drops it into the mantissa of 2^23, and
// subtracting 2^23 + 128 leaves v exactly
__device__ __forceinline__ void unpack(const uint4& u, float* f, const int8_t*) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[4 * i + k] = __uint_as_float(__byte_perm(w[i], 0x4b000000u, 0x7650 + k)) - 8388736.0f;
    }
  }
}

// merge the softmax triple (m2, l2, acc2) into (m, l, acc); a max of -inf
// stands for no column at all
template <int E>
__device__ __forceinline__ void merge(float& m, float& l, float* acc, float m2, float l2, const float* acc2) {
  const float mx = fmaxf(m, m2);
  const float a = m == -INFINITY ? 0.0f : expf(m - mx);
  const float c = m2 == -INFINITY ? 0.0f : expf(m2 - mx);
  l = l * a + l2 * c;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = acc[e] * a + acc2[e] * c;
  m = mx;
}

// T: q, k_new, v_new and out (float or bf16); C: the cache (T, or int8 with scales); DH: the head size;
// G: query heads a KV head
template <typename T, typename C, int DH, int G>
__global__ void __launch_bounds__(THREADS)
    decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kn, const T* __restrict__ vn,
                       long long qkv_stride, C* kc, C* vc, float* ksc, float* vsc, const float* __restrict__ bias,
                       const long long* __restrict__ pos_ptr, long long pos_val, T* __restrict__ out, int H, int S,
                       int chunk, float scale) {
  constexpr bool Q8 = std::is_same<C, int8_t>::value;
  constexpr int E = 16 / static_cast<int>(sizeof(C));  // values a lane loads from a column
  constexpr int LP = DH / E;                           // lanes a column
  constexpr int PW = 32 / LP;                          // columns a warp load
  constexpr int STRIDE = WARPS_PER_HEAD * PW;          // columns of one load of a head's warps
  static_assert(DH % E == 0 && LP >= 1 && LP <= 32 && 32 % LP == 0, "head size");

  __shared__ float s_m[2][WARPS_PER_HEAD], s_l[2][WARPS_PER_HEAD];
  __shared__ float s_acc[2][WARPS_PER_HEAD][DH];
  __shared__ float p_m[2], p_l[2], p_acc[2][DH];  // the block's triple, read by the cluster
  __shared__ float s_amax[2][2];                  // int8: |k_new|, |v_new| max of each head of the pair

  const int split = blockIdx.x, nsplit = gridDim.x, g = blockIdx.y / G, gi = blockIdx.y % G, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hl = warp / WARPS_PER_HEAD, w = warp % WARPS_PER_HEAD;
  const int h = 2 * g + hl;
  const bool head = h < H;  // an odd H leaves the last pair one head
  const int sub = lane % LP, grp = lane / LP;
  const long long pos = pos_ptr != nullptr ? *pos_ptr : pos_val;
  if (pos < 0 || pos >= S) __trap();  // a cursor off the cache: fail, as index_copy_ does, not skip the write

  const size_t row = static_cast<size_t>(b) * qkv_stride + static_cast<size_t>(head ? h : 0) * DH + sub * E;
  const size_t qrow = static_cast<size_t>(b) * qkv_stride + static_cast<size_t>(head ? h * G + gi : 0) * DH + sub * E;
  float qf[E], acc[E];
  float self = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qf[e] = head ? to_f(q[qrow + e]) : 0.0f;
    self = fmaf(qf[e], head ? to_f(kn[row + e]) : 0.0f, self);
    acc[e] = 0.0f;
  }
#pragma unroll
  for (int off = LP / 2; off > 0; off >>= 1) self += __shfl_xor_sync(FULL, self, off);
  float m = -INFINITY, l = 0.0f;
  if (split == 0 && w == 0 && grp == 0 && head) {  // the token's own logit and value
    m = self * scale;
    l = 1.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = to_f(vn[row + e]);
  }

  const size_t plane = (static_cast<size_t>(b) * H + (head ? h : 0)) * S;  // column 0 of this head
  const C* kp = kc + plane * DH + sub * E;
  const C* vp = vc + plane * DH + sub * E;
  const size_t splane = (static_cast<size_t>(b) * (H / 2) + g) * S;  // int8 scales of the pair
  const float* bp = bias + static_cast<size_t>(b) * S;
  const int lo = split * chunk;
  const int hi = min(S, lo + chunk);

  float bnext[ROUND];
#pragma unroll
  for (int u = 0; u < ROUND; ++u) {
    const int j = lo + w * PW + u * STRIDE + grp;
    bnext[u] = j < hi ? bp[j] : -INFINITY;
  }
  for (int base = lo + w * PW; base < hi; base += ROUND * STRIDE) {  // warp-uniform
    bool ok[ROUND];
    uint4 kr[ROUND], vr[ROUND];
    float bcur[ROUND], ksj[ROUND], vsj[ROUND];
#pragma unroll
    for (int u = 0; u < ROUND; ++u) {
      const int j = base + u * STRIDE + grp;
      bcur[u] = bnext[u];
      ok[u] = head && j < hi && j != pos && bcur[u] > -FLT_MAX;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      ksj[u] = vsj[u] = 1.0f;
      if (ok[u]) {
        kr[u] = __ldcs(reinterpret_cast<const uint4*>(kp + static_cast<size_t>(j) * DH));
        vr[u] = __ldcs(reinterpret_cast<const uint4*>(vp + static_cast<size_t>(j) * DH));
        if (Q8) {
          ksj[u] = ksc[splane + j];
          vsj[u] = vsc[splane + j];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ROUND; ++u) {  // the next round's bias, in flight behind this round's K and V
      const int j = base + (ROUND + u) * STRIDE + grp;
      bnext[u] = j < hi ? bp[j] : -INFINITY;
    }
    float sc[ROUND];
    float mx = m;
#pragma unroll
    for (int u = 0; u < ROUND; ++u) {
      float kf[E];
      unpack(kr[u], kf, static_cast<const C*>(nullptr));
      float d = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) d = fmaf(qf[e], kf[e], d);
#pragma unroll
      for (int off = LP / 2; off > 0; off >>= 1) d += __shfl_xor_sync(FULL, d, off);
      sc[u] = ok[u] ? d * ksj[u] * scale + bcur[u] : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    if (mx > -INFINITY) {
      const float corr = expf(m - mx);  // 0 while m is -inf
      l *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
      for (int u = 0; u < ROUND; ++u) {
        if (ok[u]) {
          const float p = expf(sc[u] - mx);
          l += p;
          const float pv = p * vsj[u];
          float vf[E];
          unpack(vr[u], vf, static_cast<const C*>(nullptr));
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = fmaf(pv, vf[e], acc[e]);
        }
      }
      m = mx;
    }
  }

  // the lane groups of a warp
#pragma unroll
  for (int off = LP; off < 32; off <<= 1) {
    float acc2[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc2[e] = __shfl_xor_sync(FULL, acc[e], off);
    const float m2 = __shfl_xor_sync(FULL, m, off), l2 = __shfl_xor_sync(FULL, l, off);
    merge<E>(m, l, acc, m2, l2, acc2);
  }
  if (grp == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[hl][w][sub * E + e] = acc[e];
    if (sub == 0) {
      s_m[hl][w] = m;
      s_l[hl][w] = l;
    }
  }
  if (Q8 && split == 0 && w == 0 && gi == 0) {  // the pair's int8 scales of column pos
    float ak = 0.0f, av = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ak = fmaxf(ak, head ? fabsf(to_f(kn[row + e])) : 0.0f);
      av = fmaxf(av, head ? fabsf(to_f(vn[row + e])) : 0.0f);
    }
#pragma unroll
    for (int off = LP / 2; off > 0; off >>= 1) {
      ak = fmaxf(ak, __shfl_xor_sync(FULL, ak, off));
      av = fmaxf(av, __shfl_xor_sync(FULL, av, off));
    }
    if (lane == 0) {
      s_amax[hl][0] = ak;
      s_amax[hl][1] = av;
    }
  }
  __syncthreads();

  // the warps of a head: thread t takes head t / DH of the pair, dimension t % DH
  const bool single = nsplit == 1;
  for (int t = threadIdx.x; t < 2 * DH; t += THREADS) {
    const int hh = t / DH, d = t % DH;
    float M = -INFINITY, L = 0.0f, A = 0.0f;
#pragma unroll
    for (int v = 0; v < WARPS_PER_HEAD; ++v) merge<1>(M, L, &A, s_m[hh][v], s_l[hh][v], &s_acc[hh][v][d]);
    if (single) {
      if (2 * g + hh < H) store_f(out + ((static_cast<size_t>(b) * H + 2 * g + hh) * G + gi) * DH + d, A / L);
    } else {
      p_acc[hh][d] = A;
      if (d == 0) {
        p_m[hh] = M;
        p_l[hh] = L;
      }
    }
  }
  if (!single) {  // the blocks of the cluster, merged by its first in rank order
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (split == 0) {
      for (int t = threadIdx.x; t < 2 * DH; t += THREADS) {
        const int hh = t / DH, d = t % DH;
        float M = -INFINITY, L = 0.0f, A = 0.0f;
        for (int r = 0; r < nsplit; ++r) {
          const float m2 = cluster.map_shared_rank(&p_m[0], r)[hh];
          const float l2 = cluster.map_shared_rank(&p_l[0], r)[hh];
          const float a2 = cluster.map_shared_rank(&p_acc[0][0], r)[hh * DH + d];
          merge<1>(M, L, &A, m2, l2, &a2);
        }
        if (2 * g + hh < H) store_f(out + ((static_cast<size_t>(b) * H + 2 * g + hh) * G + gi) * DH + d, A / L);
      }
    }
    // no block leaves while the first reads its triple; the first's reads are
    // done (their sums are stored), so the barrier orders no memory
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
  }

  // column pos: the new K and V, after this block's reads of the cache
  if (split == 0 && w == 0 && grp == 0 && head && gi == 0) {
    const size_t at = (plane + static_cast<size_t>(pos)) * DH + sub * E;
    if constexpr (Q8) {
      const float sk = fmaxf(fmaxf(s_amax[0][0], s_amax[1][0]), 1e-8f) * (1.0f / 127.0f);
      const float sv = fmaxf(fmaxf(s_amax[0][1], s_amax[1][1]), 1e-8f) * (1.0f / 127.0f);
      uint32_t wk[4] = {0, 0, 0, 0}, wv[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float qk = fminf(fmaxf(rintf(__fdiv_rn(to_f(kn[row + e]), sk)), -127.0f), 127.0f);
        const float qv = fminf(fmaxf(rintf(__fdiv_rn(to_f(vn[row + e]), sv)), -127.0f), 127.0f);
        wk[e / 4] |= (static_cast<uint32_t>(static_cast<int>(qk)) & 0xffu) << (8 * (e % 4));
        wv[e / 4] |= (static_cast<uint32_t>(static_cast<int>(qv)) & 0xffu) << (8 * (e % 4));
      }
      *reinterpret_cast<uint4*>(kc + at) = make_uint4(wk[0], wk[1], wk[2], wk[3]);
      *reinterpret_cast<uint4*>(vc + at) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      if (hl == 0 && sub == 0) {
        ksc[splane + pos] = sk;
        vsc[splane + pos] = sv;
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kc[at + e] = kn[row + e];
        vc[at + e] = vn[row + e];
      }
    }
  }
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

// Blocks of a cluster along S: the least of 1, 2, 4, 8 that gives every SM
// two blocks, while a block keeps at least MIN_CHUNK columns.
int choose_split(int blocks, int S) {
  int split = 1;
  while (split < MAX_SPLIT && blocks * split < 2 * sm_count() && (S + 2 * split - 1) / (2 * split) >= MIN_CHUNK) {
    split *= 2;
  }
  return split;
}

template <typename T, typename C, int DH, int G>
int launch(const void* q, const void* k, const void* v, long long qkv_stride, void* kc, void* vc, void* ks, void* vs,
           const void* bias, const void* pos, long long pos_val, void* out, int B, int H, int S, float scale,
           cudaStream_t s) {
  const int pairs = (H + 1) / 2;
  const int split = choose_split(B * pairs * G, S);
  const int chunk = (S + split - 1) / split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, pairs * G, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // the blocks along S are one cluster
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_attn_kernel<T, C, DH, G>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qkv_stride, static_cast<C*>(kc), static_cast<C*>(vc), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const float*>(bias), static_cast<const long long*>(pos), pos_val,
      static_cast<T*>(out), H, S, chunk, scale);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, typename C>
int by_head_size(int Dh, int G, const void* q, const void* k, const void* v, long long qkv_stride, void* kc, void* vc,
                 void* ks, void* vs, const void* bias, const void* pos, long long pos_val, void* out, int B, int H,
                 int S, float scale, cudaStream_t s) {
#define DECODE_ATTN_CASE(D, GG)                                                                                \
  if (Dh == D && G == GG)                                                                                     \
    return launch<T, C, D, GG>(q, k, v, qkv_stride, kc, vc, ks, vs, bias, pos, pos_val, out, B, H, S, scale, s);
  DECODE_ATTN_CASE(16, 1)
  DECODE_ATTN_CASE(64, 1)
  DECODE_ATTN_CASE(16, 2)
  DECODE_ATTN_CASE(64, 4)
#undef DECODE_ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: device [B, H * G, Dh], k, v: device [B, H, Dh], rows qkv_stride elements apart, heads Dh apart;
// kc, vc: device [B, H, S, Dh] in their dtype, or int8 with ks, vs [B, H/2, S]
// float32 (int8_cache = 1; null otherwise); bias: device float32 [B, S]; pos:
// a device int64, or null to take pos_val; out: device [B, H * Dh]. dtype:
// 0 = float32, 1 = bfloat16 (q, k, v, out and a full-precision cache). Dh:
// 16 (the tiny test models) or 64 (the published ones); G: query heads a KV head, 1 at either, 2 at 16,
// 4 at 64. scale: the scores' factor. stream: the cudaStream_t to launch on. Returns the launch's error (0
// on success).
extern "C" int indextts_decode_attn(const void* q, const void* k, const void* v, long long qkv_stride, void* kc,
                                    void* vc, void* ks, void* vs, const void* bias, const void* pos,
                                    long long pos_val, void* out, int B, int H, int G, int S, int Dh, float scale,
                                    int dtype, int int8_cache, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || S <= 0 || B > 65535 || (H + 1) / 2 * G > 65535 || (dtype != 0 && dtype != 1) ||
      (int8_cache && H % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return int8_cache ? by_head_size<float, int8_t>(Dh, G, q, k, v, qkv_stride, kc, vc, ks, vs, bias, pos, pos_val, out,
                                                    B, H, S, scale, s)
                      : by_head_size<float, float>(Dh, G, q, k, v, qkv_stride, kc, vc, ks, vs, bias, pos, pos_val, out,
                                                   B, H, S, scale, s);
  }
  return int8_cache ? by_head_size<__nv_bfloat16, int8_t>(Dh, G, q, k, v, qkv_stride, kc, vc, ks, vs, bias, pos, pos_val,
                                                          out, B, H, S, scale, s)
                    : by_head_size<__nv_bfloat16, __nv_bfloat16>(Dh, G, q, k, v, qkv_stride, kc, vc, ks, vs, bias, pos,
                                                                 pos_val, out, B, H, S, scale, s);
}
