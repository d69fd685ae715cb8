// Multi-head attention over (B, T, H, D) tensors with the TPU kernel's
// precision staging:
//
//   S = (Q K^T) * 1/sqrt(D)           fp32 (bf16 products, fp32 sums)
//   keys at or beyond Tk masked
//   P = exp(S - rowmax) / rowsum      fp32, then cast to the input type
//   O = P V                           fp32 sums, one cast at the end
//
// Replaces the Pallas TPU kernel open_muse_tpu/ops/pallas/flash_attention.py
// `flash_attention` (body `_kernel`), which holds a group of (batch, head)
// pairs' whole K/V in VMEM, pads K/V to 128 lanes and masks the pad.  Neither
// the grouping nor the padding is carried over: here a block owns one
// (batch, head) pair and a tile of query rows and masks the ragged keys in
// place.  The exact staging rules out online-softmax rescaling of an
// unnormalised PV: P is rounded to bf16 only after the exact row sum is known.
//
// What bounds it on the H100: at the paths' shapes (v1's self-attention
// (1, 257, 16, 48); v2's block attention (2, 256, 12, 64) over the 77 text
// keys, 16 rows of batch when training) neither bytes (1.6 MB at v1: 0.5 us)
// nor operations (0.2 GFLOP: 0.2 us) but latency: how many dependent memory
// round trips a block waits on, how long one warp's chain of mma, exp and
// shuffles is, and how many SMs hold a block at all.
//
// What the design does about it: one pass over K, with all of a (batch,
// head) pair's K and V, rounded up to 16 keys and zero-filled, copied into
// dynamic shared memory by cp.async 16-byte copies issued at once, K as one
// commit group and V as a second, while the Q fragments load straight into
// registers.  The block waits once for K, computes S once (mma.sync
// m16n8k16, K fragments by ldmatrix) and keeps it in registers, takes the
// row max, exp and the row sum while V is still arriving, then forms P =
// exp * (1 / sum) rounded to bf16 and P V (V fragments by ldmatrix.trans on
// row-major V, so no transposed copy).  exp is ex2.approx with log2(e) folded into the
// scale and the division a product with the row sum's IEEE reciprocal: both
// within a few fp32 ulps of the TPU kernel's exp(S - max) / sum, far below
// the bf16 rounding of P that follows.  Blocks hold 4 groups of 16 query
// rows (64 rows); S's register footprint is fixed at compile time, so the
// capacity follows Tk.  Variant rule, on Tk before the launch:
//
//  * Tk <= 80 (v2's 77 text keys): one warp a group over every key, 128
//    threads; S is 40 floats a thread.
//  * 80 < Tk <= 288 (v1's 257): two warps a group, each over its
//    half of the 16-key chunks (at most 9), 256 threads; the halves' row
//    maxima and sums meet in shared memory (sums added in warp order) and
//    the second warp's partial P V is added to the first's before the store.
//  * Tk > 288 (the 1024-token v1 trunks of the MOVQ configs: 1025 keys
//    with the class token, 1024 without): two passes over 64-key tiles, four
//    warps, 64 query rows a block: the first pass takes each row's max and
//    sum of exponentials online, the second recomputes S, forms P in bf16
//    and accumulates P V, with K and V loaded synchronously and V transposed
//    into padded shared memory.
//
// All count as one launch of the wrapper; the wrapper counts the two-pass
// variant apart too.  Query rows, keys and the batch /
// token strides are free: q, k and v may be views into a fused projection
// (token stride 3 H D for a packed [q | k | v]), with no padding and no copy.
// No atomics: two calls are bit-equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_frag.cuh"

namespace {

using namespace muse::frag;

// ---------------------------------------------------------------------------
// one pass: Tk <= kMaxKeys

constexpr int kMaxKeys = 288;  // the one-pass capacity: two warps of 9 chunks of 16 keys

template <int D>
__host__ __device__ constexpr int one_pass_row() { return D + 8; }  // K / V row in shared memory

// dynamic shared memory: K and V rounded up to 16 keys, then with kSplit > 1
// the partial P V of the warps that do not store
template <int D, int kGroups, int kSplit>
size_t one_pass_smem(int Tk) {
  return 2 * size_t((Tk + 15) / 16 * 16) * one_pass_row<D>() * sizeof(T) +
         size_t(kGroups) * (kSplit - 1) * kRowsPerWarp * D * sizeof(float);
}

// A block holds kGroups groups of 16 query rows of one (batch, head) pair;
// kSplit warps share a group, each over its own run of at most kChunks
// 16-key chunks.  Strides in elements: sb between batch rows, st between
// tokens; heads are D apart and d is contiguous.
template <int D, int kGroups, int kSplit, int kChunks>
__global__ void __launch_bounds__(32 * kGroups * kSplit)
one_pass_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, int H, int Tq, int Tk, int64_t q_sb, int64_t q_st,
                int64_t k_sb, int64_t k_st, int64_t v_sb, int64_t v_st, float scale_log2) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kThreads = 32 * kGroups * kSplit;
  constexpr int kRow = one_pass_row<D>();  // 112 / 144 bytes: ldmatrix rows on distinct banks
  constexpr int kDChunks = D / 8;          // 16-byte chunks a row; 8-column C tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red_m[kGroups][kSplit][kRowsPerWarp], red_l[kGroups][kSplit][kRowsPerWarp];
  const int chunks = (Tk + 15) / 16;
  const int keys = chunks * 16;  // rows staged: Tk rounded up, zero-filled
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + keys * kRow;
  float4* part = reinterpret_cast<float4*>(Vs + keys * kRow);  // the split warps' P V

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / kSplit, half = warp % kSplit;
  const int g = lane >> 2, t4 = lane & 3;
  const T* kb = k + b * k_sb + int64_t(h) * D;
  const T* vb = v + b * v_sb + int64_t(h) * D;

  // every copy of K, then of V, in flight at once: two commit groups, so S
  // and the softmax run while V is still arriving
  for (int idx = threadIdx.x; idx < keys * kDChunks; idx += kThreads) {
    const int r = idx / kDChunks, c = (idx % kDChunks) * 8;
    cp_async16(Ks + r * kRow + c, r < Tk ? kb + r * k_st + c : kb, r < Tk ? 16 : 0);
  }
  cp_async_commit();
  for (int idx = threadIdx.x; idx < keys * kDChunks; idx += kThreads) {
    const int r = idx / kDChunks, c = (idx % kDChunks) * 8;
    cp_async16(Vs + r * kRow + c, r < Tk ? vb + r * v_st + c : vb, r < Tk ? 16 : 0);
  }
  cp_async_commit();
  // meanwhile this thread's Q fragments, straight into registers
  const int r0 = blockIdx.x * (kGroups * kRowsPerWarp) + grp * kRowsPerWarp + g;
  uint32_t qf[D / 16][4];
  load_a<D>(qf, q + b * q_sb + int64_t(h) * D, q_st, r0, Tq, t4);
  // this warp's chunks [c0, c1)
  const int per = (chunks + kSplit - 1) / kSplit;
  const int c0 = half * per, c1 = min(chunks, c0 + per);
  cp_async_wait<1>();  // K
  __syncthreads();

  // S for the group's 16 rows and this warp's keys, once, in the log2
  // domain: s[n] is the m16n8 C fragment of keys (c0 * 2 + n) * 8 .. + 7,
  // (s[n][0], s[n][1]) row g and (s[n][2], s[n][3]) row g + 8 at keys + t4*2
  // and + 1; masked keys -inf
  float s[2 * kChunks][4];
  // ldmatrix row of lane: keys (lane & 7) + 8 (lane >> 4), d 8 ((lane >> 3) & 1)
  const T* kl = Ks + ((lane & 7) + ((lane >> 4) << 3)) * kRow + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (c0 + j < c1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * j][e] = s[2 * j + 1][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t bf[4];  // (b0, b1) of the chunk's keys 0 .. 7, then of 8 .. 15
        ldmatrix_x4(bf, kl + (c0 + j) * 16 * kRow + kc * 16);
        mma16816(s[2 * j], qf[kc], bf);
        mma16816(s[2 * j + 1], qf[kc], bf + 2);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = (c0 + j) * 16 + (e >> 2) * 8 + t4 * 2 + (e & 1);
        float& x = s[2 * j + (e >> 2)][e & 3];
        x = key < Tk ? x * scale_log2 : -INFINITY;
      }
    }
  }

  // the rows' max and sum over every key; 2^(S' - max') with S' = S log2(e)
  // is exp(S - max).  Row g in the fragments' elements 0, 1; g + 8 in 2, 3
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (c0 + j < c1) {
#pragma unroll
      for (int n = 2 * j; n < 2 * j + 2; ++n) {
        m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]));
        m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]));
      }
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  if constexpr (kSplit > 1) {
    if (t4 == 0) {
      red_m[grp][half][g] = m0;
      red_m[grp][half][g + 8] = m1;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kSplit; ++w) {
      m0 = fmaxf(m0, red_m[grp][w][g]);
      m1 = fmaxf(m1, red_m[grp][w][g + 8]);
    }
  }  // finite: key 0 is never masked
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (c0 + j < c1) {
#pragma unroll
      for (int n = 2 * j; n < 2 * j + 2; ++n) {
        s[n][0] = ex2(s[n][0] - m0);
        s[n][1] = ex2(s[n][1] - m0);
        s[n][2] = ex2(s[n][2] - m1);
        s[n][3] = ex2(s[n][3] - m1);
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if constexpr (kSplit > 1) {  // the warps' sums added in warp order, the same in each
    if (t4 == 0) {
      red_l[grp][half][g] = l0;
      red_l[grp][half][g + 8] = l1;
    }
    __syncthreads();
    l0 = l1 = 0.f;
#pragma unroll
    for (int w = 0; w < kSplit; ++w) {
      l0 += red_l[grp][w][g];
      l1 += red_l[grp][w][g + 8];
    }
  }
  const float inv0 = __frcp_rn(l0), inv1 = __frcp_rn(l1);

  // O = P V over this warp's keys, with P normalised, then rounded to bf16
  float acc[kDChunks][4];
#pragma unroll
  for (int n = 0; n < kDChunks; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  cp_async_wait<0>();  // V
  __syncthreads();
  // ldmatrix.trans row of lane: keys (lane & 7) + 8 ((lane >> 3) & 1), d 8 (lane >> 4)
  const T* vl = Vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRow + ((lane >> 4) << 3);
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (c0 + j < c1) {
      uint32_t pa[4];  // the A fragment of P for the chunk's 16 keys
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int n = 2 * j + hi;
        pa[2 * hi] = pack2(s[n][0] * inv0, s[n][1] * inv0);
        pa[2 * hi + 1] = pack2(s[n][2] * inv1, s[n][3] * inv1);
      }
#pragma unroll
      for (int n = 0; n < kDChunks; n += 2) {  // (b0, b1) of d n*8 .. +7, then of n*8+8 .. +15
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vl + (c0 + j) * 16 * kRow + n * 8);
        mma16816(acc[n], pa, bf);
        mma16816(acc[n + 1], pa, bf + 2);
      }
    }
  }

  // the group's first warp adds the others' partial sums, in warp order, and stores
  if constexpr (kSplit > 1) {
    float4* mine = part + ((grp * (kSplit - 1)) * kDChunks) * 32 + lane;
    if (half > 0) {
#pragma unroll
      for (int n = 0; n < kDChunks; ++n)
        mine[((half - 1) * kDChunks + n) * 32] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    }
    __syncthreads();
    if (half > 0) return;
#pragma unroll
    for (int w = 1; w < kSplit; ++w) {
#pragma unroll
      for (int n = 0; n < kDChunks; ++n) {
        const float4 p = mine[((w - 1) * kDChunks + n) * 32];
        acc[n][0] += p.x;
        acc[n][1] += p.y;
        acc[n][2] += p.z;
        acc[n][3] += p.w;
      }
    }
  }
  const int64_t o_st = int64_t(H) * D;
  T* ob = o + (int64_t(b) * Tq * H + h) * D;
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < kDChunks; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r0 < Tq) *reinterpret_cast<uint32_t*>(ob + r0 * o_st + c) = pack2(acc[n][0], acc[n][1]);
    if (r1 < Tq) *reinterpret_cast<uint32_t*>(ob + r1 * o_st + c) = pack2(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// two passes: Tk > kMaxKeys

constexpr int kTwoWarps = 4;
constexpr int kTwoThreads = 32 * kTwoWarps;
constexpr int kBlockK = 64;                      // keys a tile
constexpr int kKPad = kBlockK + 8;               // V^T row length in shared memory

template <int D>
__global__ void __launch_bounds__(kTwoThreads)
two_pass_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, int H, int Tq, int Tk, int64_t q_sb, int64_t q_st,
                int64_t k_sb, int64_t k_st, int64_t v_sb, int64_t v_st, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kDPad = D + 8;  // K row length in shared memory
  constexpr int kChunks = D / 8;
  __shared__ __align__(16) T Ks[kBlockK][kDPad];
  __shared__ __align__(16) T Vt[D][kKPad];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const T* kb = k + b * k_sb + int64_t(h) * D;
  const T* vb = v + b * v_sb + int64_t(h) * D;
  const int64_t o_st = int64_t(H) * D;
  T* ob = o + (int64_t(b) * Tq * H + h) * D;

  const int r0 = blockIdx.x * (kTwoWarps * kRowsPerWarp) + warp * kRowsPerWarp + g, r1 = r0 + 8;
  uint32_t qf[D / 16][4];
  load_a<D>(qf, q + b * q_sb + int64_t(h) * D, q_st, r0, Tq, t4);

  auto load_k = [&](int j0) {
    for (int idx = threadIdx.x; idx < kBlockK * kChunks; idx += kTwoThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < Tk) val = *reinterpret_cast<const uint4*>(kb + (j0 + r) * k_st + c);
      *reinterpret_cast<uint4*>(&Ks[r][c]) = val;
    }
  };
  auto load_v = [&](int j0) {
    for (int idx = threadIdx.x; idx < kBlockK * kChunks; idx += kTwoThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < Tk) val = *reinterpret_cast<const uint4*>(vb + (j0 + r) * v_st + c);
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[c + i][r] = e[i];
    }
  };

  // S for this warp's 16 rows and the tile's 64 keys, laid out as in the
  // one-pass kernel; masked keys are -inf
  float s[kBlockK / 8][4];
  auto scores = [&](int j0) {
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(&Ks[n * 8 + g][kc * 16 + t4 * 2]);
        bf[1] = *reinterpret_cast<const uint32_t*>(&Ks[n * 8 + g][kc * 16 + t4 * 2 + 8]);
        mma16816(s[n], qf[kc], bf);
      }
    }
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + n * 8 + t4 * 2 + (e & 1);
        s[n][e] = key < Tk ? s[n][e] * scale : -INFINITY;
      }
    }
  };

  // pass 1: each row's max and sum of exp(S - max), online over the tiles
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < Tk; j0 += kBlockK) {
    __syncthreads();
    load_k(j0);
    __syncthreads();
    scores(j0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));  // finite: a tile holds a key < Tk
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n)
        sum += expf(s[n][2 * r] - m_new) + expf(s[n][2 * r + 1] - m_new);
      l[r] = l[r] * expf(m[r] - m_new) + quad_sum(sum);
      m[r] = m_new;
    }
  }

  // pass 2: P = exp(S - max) / sum in the input type, O += P V in fp32
  float acc[kChunks][4];
#pragma unroll
  for (int n = 0; n < kChunks; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int j0 = 0; j0 < Tk; j0 += kBlockK) {
    __syncthreads();
    load_k(j0);
    load_v(j0);
    __syncthreads();
    scores(j0);
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kk + half;
        pa[2 * half] = pack2(__fdiv_rn(expf(s[n][0] - m[0]), l[0]),
                             __fdiv_rn(expf(s[n][1] - m[0]), l[0]));
        pa[2 * half + 1] = pack2(__fdiv_rn(expf(s[n][2] - m[1]), l[1]),
                                 __fdiv_rn(expf(s[n][3] - m[1]), l[1]));
      }
#pragma unroll
      for (int n = 0; n < kChunks; ++n) {
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(&Vt[n * 8 + g][kk * 16 + t4 * 2]);
        bf[1] = *reinterpret_cast<const uint32_t*>(&Vt[n * 8 + g][kk * 16 + t4 * 2 + 8]);
        mma16816(acc[n], pa, bf);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kChunks; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r0 < Tq) *reinterpret_cast<uint32_t*>(ob + r0 * o_st + c) = pack2(acc[n][0], acc[n][1]);
    if (r1 < Tq) *reinterpret_cast<uint32_t*>(ob + r1 * o_st + c) = pack2(acc[n][2], acc[n][3]);
  }
}

template <int D, int kGroups, int kSplit, int kChunks>
int launch_one_pass(const T* q, const T* k, const T* v, T* o, int B, int H, int Tq, int Tk,
                    const int64_t* s, float scale, cudaStream_t stream) {
  auto kernel = one_pass_kernel<D, kGroups, kSplit, kChunks>;
  const size_t smem = one_pass_smem<D, kGroups, kSplit>(Tk);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  constexpr int rows = kGroups * kRowsPerWarp;
  const dim3 grid((Tq + rows - 1) / rows, B * H);
  kernel<<<grid, 32 * kGroups * kSplit, smem, stream>>>(
      q, k, v, o, H, Tq, Tk, s[0], s[1], s[2], s[3], s[4], s[5], scale * kLog2e);
  return int(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Tq, int Tk,
           const int64_t* s, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (Tk <= 80) {
    return launch_one_pass<D, 4, 1, 5>(qp, kp, vp, op, B, H, Tq, Tk, s, scale, stream);
  } else if (Tk <= kMaxKeys) {
    return launch_one_pass<D, 4, 2, kMaxKeys / 32>(qp, kp, vp, op, B, H, Tq, Tk, s, scale,
                                                   stream);
  } else {
    constexpr int rows = kTwoWarps * kRowsPerWarp;
    const dim3 grid((Tq + rows - 1) / rows, B * H);
    two_pass_kernel<D><<<grid, kTwoThreads, 0, stream>>>(
        qp, kp, vp, op, H, Tq, Tk, s[0], s[1], s[2], s[3], s[4], s[5], scale);
  }
  return int(cudaGetLastError());
}

}  // namespace

// q (B, Tq, H, D), k and v (B, Tk, H, D) bf16, D 48 (v1) or 64 (v2's
// blocks), each with d contiguous, heads D apart, and the batch and
// token strides given in elements (multiples of 8; pointers 16-byte aligned);
// o (B, Tq, H, D) contiguous.  strides: q_sb, q_st, k_sb, k_st, v_sb, v_st.
// Tk <= 288 takes the one-pass kernel, larger Tk the two-pass one.
extern "C" int muse_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int Tq, int Tk, int D, const int64_t* strides,
                                    float scale, void* stream_ptr) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B * H > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (D) {
    case 48: return launch<48>(q, k, v, o, B, H, Tq, Tk, strides, scale, stream);
    case 64: return launch<64>(q, k, v, o, B, H, Tq, Tk, strides, scale, stream);
    default: return int(cudaErrorInvalidValue);
  }
}
