// Trunk attention sublayers of MaskGiTUViT_v2, forward:
//
//   h   = x + res                                  (bf16 add)
//   n   = h * bf16(rsqrt(mean(h^2) + eps)) * ln    (fp32 variance)
//   a   = n * (1 + adaln_scale) + adaln_shift      (bf16, rounded per op)
//   qkv = a @ Wqkv^T  (self)   |   q = a @ Wq^T, [k|v] given  (cross)
//   o_h = softmax(q_h k_h^T / sqrt(64)) v_h        (fp32 logits and softmax,
//                                                   bf16 probs, fp32 PV sum)
//   out = concat_h(o_h) @ Wout^T                   -> (out, h)
//
// and backward: given g_out and g_res (the gradient of h), the data-side
// gradients dx (= dres), d(adaln) (B, 2D), d(ln) (D,), and a, dqkv (or dq
// and d[k|v]) and the attention output for the weight-gradient products,
// which stay in torch as JAX leaves them to XLA (attn_sublayer.py:628-633).
//
// Replaces the Pallas TPU kernels open_muse_tpu/ops/pallas/attn_sublayer.py
// `attn_sublayer_self` (body `_self_kernel`), `attn_sublayer_cross` (body
// `_cross_kernel`), `_self_bwd_pallas` (body `_self_bwd_kernel`) and
// `_cross_bwd_pallas` (body `_cross_bwd_kernel`), with the precision staging
// of their oracles `_xla_ref_self` / `_xla_ref_cross` and of the Pallas
// backward bodies.
//
// What bounds it on the H100: at the serving shape (2 x 256 rows, hidden
// 1024, 16 heads of 64, 77 text keys) each sublayer moves ~8 MB of weights
// and ~5 MB of activations for ~4 GFLOP; at the training shape (16 x 256
// rows) the backward does ~5x the forward's products.  The TPU kernels' grid
// of one cell per batch element would put 2 - 16 blocks on 132 SMs.
//
// What the design does about it: chains of launches on one stream, each with
// enough blocks to fill the card.
// - Forward, self (kernel 9) and cross (kernel 10) alike: a row kernel with
//   the row in registers (a warp a row at width 1024, every 16-byte load of
//   x, res, ln and the AdaLN rows issued before any arithmetic; the
//   block-a-row kernel below at other widths), the in-projection (qkv or q)
//   on the Hopper GEMM of gemm_sm90.cuh (TMA, wgmma), flash_attention.cu's
//   attention through its launcher (`muse_flash_attention`, by its rule: up
//   to 288 keys one pass with S in registers and P rounded to bf16 after the
//   exact row sum -- on wgmma with a (batch, head) pair's K and V read once
//   by TMA into a persistent block, or multicast into a cluster's blocks at
//   serving's 256 tokens; on mma.sync over the 77 text keys at serving's
//   batch --; two passes above) reading q / k / v as strided views of the
//   (B, S, 3D) projection or of q and the (B, L, 2D) [k|v] projection (4-D
//   tensor maps with free batch and token strides), and the out projection
//   on the Hopper GEMM.
// - Backward, self (kernel 11) and cross (kernel 12) alike, eight launches:
//   the register row kernel again (recompute a, keeping 1/rms), the Hopper
//   GEMM for the recomputed qkv or q and, with the weight read MN-major, for
//   dattn = g_out @ Wout and da = dproj @ W_in; the attention backward,
//   reading q / k / v and writing dq / dk / dv as strided views of the (B,
//   S, 3I) projection or of q and the (B, L, 2I) [k|v] projection and their
//   gradients: up to 288 queries and 256 keys (every path's shape) one block a
//   (batch, head) pair on wgmma (namespace bwd: Q, K, V and dO read once by
//   TMA, S and dP each computed twice, the row statistics in shared memory);
//   above, two mma.sync kernels (a ninth launch) that keep S, P, dP and dS in
//   registers (a block per 64 query rows: the row statistics, the output, D
//   and dQ in three passes over streamed key tiles; a block per 64 keys: dK
//   and dV in one pass over streamed query tiles); the register row kernel
//   of dx and a two-stage column reduction of d(adaln) and d(ln).  The
//   block-a-row kernels take the rows at widths other than 1024.
// d(adaln) and d(ln) are reduced in two stages (per 32-row chunk, then over
// chunks) without atomics; no kernel uses atomics, so two calls give
// bit-equal results.
#include <algorithm>
#include <cmath>

#include "attn_sm90.cuh"
#include "bf16x2.cuh"
#include "gemm_sm90.cuh"
#include "mma_frag.cuh"

// flash_attention.cu's launcher: the forwards' attention
extern "C" int muse_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int Tq, int Tk, int D, const int64_t* strides,
                                    float scale, void* stream_ptr);

namespace {

constexpr int kRowThreads = 256;

// h = x + res; a = adaln(rmsnorm(h)), one block per row.  rstd_out, when
// given, keeps the unrounded fp32 1/rms of each row for the backward.
__global__ void __launch_bounds__(kRowThreads)
rmsnorm_adaln_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ res,
                     const __nv_bfloat16* __restrict__ ln, const __nv_bfloat16* __restrict__ adaln,
                     __nv_bfloat16* __restrict__ h_out, __nv_bfloat16* __restrict__ a_out,
                     float* __restrict__ rstd_out, int S, int D, float eps) {
  const int64_t row = blockIdx.x;
  const int batch = int(row / S);
  const __nv_bfloat16* xr = x + row * D;
  const __nv_bfloat16* rr = res ? res + row * D : nullptr;
  __nv_bfloat16* hr = h_out + row * D;

  float sumsq = 0.f;
  for (int i = threadIdx.x; i < D; i += kRowThreads) {
    float v = __bfloat162float(xr[i]);
    if (rr) v = __bfloat162float(__float2bfloat16_rn(v + __bfloat162float(rr[i])));
    hr[i] = __float2bfloat16_rn(v);
    sumsq += v * v;
  }
  __shared__ float warp_sums[kRowThreads / 32];
  __shared__ float inv_rms;
  for (int off = 16; off > 0; off >>= 1) sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sumsq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < kRowThreads / 32; ++i) total += warp_sums[i];
    // rsqrt in fp32, cast to bf16 (_xla_ref_self: rsqrt(var + eps).astype(h.dtype))
    const float r = rsqrtf(total / float(D) + eps);
    inv_rms = __bfloat162float(__float2bfloat16_rn(r));
    if (rstd_out) rstd_out[row] = r;
  }
  __syncthreads();

  const __nv_bfloat16* scale = adaln + int64_t(batch) * 2 * D;
  const __nv_bfloat16* shift = scale + D;
  __nv_bfloat16* ar = a_out + row * D;
  for (int i = threadIdx.x; i < D; i += kRowThreads) {
    const float hv = __bfloat162float(hr[i]);
    float n = __bfloat162float(__float2bfloat16_rn(hv * inv_rms));
    n = __bfloat162float(__float2bfloat16_rn(n * __bfloat162float(ln[i])));
    const float one_plus = __bfloat162float(__float2bfloat16_rn(1.0f + __bfloat162float(scale[i])));
    const float t = __bfloat162float(__float2bfloat16_rn(n * one_plus));
    ar[i] = __float2bfloat16_rn(t + __bfloat162float(shift[i]));
  }
}

// The same h and a (and rstd) with the row in registers: a warp a row of
// width kVecs * 256, kRegRows rows a block.  Each lane holds kVecs 16-byte
// vectors of x, res, ln, scale and shift, all loaded before any arithmetic,
// so the row costs one round trip; the roundings are the kernel's above, op
// for op, each converting two values at once (bf16x2.cuh; a takes five of
// them an element).
constexpr int kRegRows = 2;

using bf2 = __nv_bfloat162;
using muse::pair;
using muse::round2;

template <int kVecs>
__global__ void __launch_bounds__(32 * kRegRows)
rmsnorm_adaln_rows_kernel(const uint4* __restrict__ x, const uint4* __restrict__ res,
                          const uint4* __restrict__ ln, const __nv_bfloat16* __restrict__ adaln,
                          uint4* __restrict__ h_out, uint4* __restrict__ a_out,
                          float* __restrict__ rstd_out, int rows, int S, float eps) {
  constexpr int D = kVecs * 256, kRowVecs = D / 8;
  const int lane = threadIdx.x % 32;
  const int64_t row = int64_t(blockIdx.x) * kRegRows + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps: no block barrier below
  const uint4* scale = reinterpret_cast<const uint4*>(adaln + (row / S) * 2 * D);
  const uint4* shift = scale + kRowVecs;
  uint4 xv[kVecs], rv[kVecs] = {}, lv[kVecs], sv[kVecs], tv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) xv[i] = x[row * kRowVecs + i * 32 + lane];
  if (res != nullptr) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) rv[i] = res[row * kRowVecs + i * 32 + lane];
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    lv[i] = ln[i * 32 + lane];
    sv[i] = scale[i * 32 + lane];
    tv[i] = shift[i * 32 + lane];
  }

  // h = bf16(x + res), its sum of squares
  float2 h[kVecs][4];
  float sumsq = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    uint4 hv = xv[i];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float2 v = pair(xv[i], p);
      if (res != nullptr) {
        const float2 r = pair(rv[i], p);
        const bf2 hb = __floats2bfloat162_rn(v.x + r.x, v.y + r.y);
        reinterpret_cast<bf2*>(&hv)[p] = hb;
        v = __bfloat1622float2(hb);
      }
      h[i][p] = v;
      sumsq += v.x * v.x;
      sumsq += v.y * v.y;
    }
    h_out[row * kRowVecs + i * 32 + lane] = hv;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
  const float r = rsqrtf(sumsq / float(D) + eps);
  if (rstd_out != nullptr && lane == 0) rstd_out[row] = r;
  const float inv_rms = __bfloat162float(__float2bfloat16_rn(r));

  // a = bf16(bf16(bf16(bf16(h * r) * ln) * bf16(1 + scale)) + shift)
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    uint4 av;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 l = pair(lv[i], p), sc = pair(sv[i], p), sh = pair(tv[i], p);
      float2 n = round2(make_float2(h[i][p].x * inv_rms, h[i][p].y * inv_rms));
      n = round2(make_float2(n.x * l.x, n.y * l.y));
      const float2 one_plus = round2(make_float2(1.0f + sc.x, 1.0f + sc.y));
      const float2 t = round2(make_float2(n.x * one_plus.x, n.y * one_plus.y));
      reinterpret_cast<bf2*>(&av)[p] = __floats2bfloat162_rn(t.x + sh.x, t.y + sh.y);
    }
    a_out[row * kRowVecs + i * 32 + lane] = av;
  }
}

constexpr int kHeadDim = 64;
constexpr int kAttnThreads = 128;  // the attention backward's blocks: 4 warps of 16 rows

// q / k / v of one sublayer as strided views of its projections: the first
// kv_len of L keys are attended
struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int64_t q_bs, q_rs;    // batch / row strides of q (elements)
  int64_t kv_bs, kv_rs;  // batch / row strides of k and v
  int L, kv_len;
  float scale;
};

// ---------------------------------------------------------------------------
// Backward of the sublayers' attention above 288 queries or 256 keys: S, P, dP
// and dS in registers
// ---------------------------------------------------------------------------
//
// Two launches over grids of (64-row tile, batch x head), 4 warps of 16 rows
// each, on mma.sync m16n8k16 fragments (mma_frag.cuh): every S, P, dP and dS
// tile lives in a warp's accumulators and feeds the next product as an A
// fragment, with no shared-memory staging; the streamed operand's 64-row
// tiles come in by cp.async into two buffers, the next tile's copies in
// flight while the current one is used.  Self attention (kernel 11) and
// cross attention (kernel 12) alike: S queries against the first kv_len of
// L keys, q / dq and k, v / dk, dv strided views of their projections.
// - attn_bwd_q_kernel, a block per 64 query rows: three passes over the
//   ceil(kv_len / 64) key tiles, keys past kv_len at a logit of -inf (P
//   exactly 0).  1: the rows' max and sum of exp (online, in the log2
//   domain).  2: P = exp(S - max) / sum rounded to bf16, O = P V summed in
//   fp32, stored as the attention output; D = rowsum(dO * O) from the fp32
//   O; the rows' statistics (max, 1 / sum, D) stored for the second kernel.
//   3: dP = dO V^T, dS = bf16(P (dP - D) / 8), dQ = dS K.
// - attn_bwd_kv_kernel, a block per 64 keys of the L: one pass over the
//   query tiles with their statistics: S^T = K Q^T, P^T from the first
//   kernel's statistics, dV += bf16(P^T) dO, dP^T = V dO^T, dS^T, dK += dS^T
//   Q; the rows of keys past kv_len are stored as zeros.
// Both sum in a fixed order: two calls are bit-equal.  Any S and L: the key
// and query tiles are streamed, not held.
constexpr int kTile = 64;               // rows of a block, and of a streamed tile
constexpr int kTileRow = kHeadDim + 8;  // bf16 a staged row: ldmatrix rows on distinct banks

struct AttnBwdArgs {
  const __nv_bfloat16* q;  // (B, S) rows of q, strides q_sb, q_st; dq alike
  const __nv_bfloat16* k;  // (B, L) rows of k and v, strides kv_sb, kv_st; dk, dv alike
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;  // (B, S, D)
  __nv_bfloat16* out;         // (B, S, D)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* stat_m;   // (B, H, Sp): each row's max of the scaled logits, log2 domain,
  float* stat_il;  // 1 / its sum of exp, and D = rowsum(dO * O); Sp = S rounded
  float* delta;    // up to kTile, rows past S (0, 0, 0)
  int64_t q_sb, q_st;    // batch / token strides of q and dq (elements)
  int64_t kv_sb, kv_st;  // of k, v, dk and dv
  int64_t o_sb, o_st;    // of out and dout
  int H, S, Sp, L, kv_len;
  float scale_log2;  // 1 / sqrt(64) * log2(e)
  float scale;       // 1 / sqrt(64)
};

// tile rows [r0, r0 + 64) of a (S, 64) operand with token stride st into a
// staged tile, rows past S zero-filled; 512 16-byte copies over 128 threads
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int64_t st,
                                           int r0, int S) {
  using namespace muse::frag;
#pragma unroll
  for (int i = 0; i < kTile * (kHeadDim / 8) / kAttnThreads; ++i) {
    const int c = threadIdx.x + i * kAttnThreads;
    const int r = c / (kHeadDim / 8), col = (c % (kHeadDim / 8)) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * kTileRow + col, ok ? src + (r0 + r) * st + col : src, ok ? 16 : 0);
  }
}

// s (16 rows x 64 columns, as 8 m16n8 C fragments) = A (16 x 64, fragments
// af) times the staged tile's rows transposed; `lk` is this lane's ldmatrix
// row of the tile (keys (lane & 7) + 8 (lane >> 4), d 8 ((lane >> 3) & 1))
__device__ __forceinline__ void rows_by_tile_t(float s[8][4], const uint32_t af[4][4],
                                               const __nv_bfloat16* lk) {
  using namespace muse::frag;
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * j][e] = s[2 * j + 1][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kHeadDim / 16; ++kc) {
      uint32_t bf[4];
      ldmatrix_x4(bf, lk + j * 16 * kTileRow + kc * 16);
      mma16816(s[2 * j], af[kc], bf);
      mma16816(s[2 * j + 1], af[kc], bf + 2);
    }
  }
}

// acc (16 x 64) += the 16 x 16 A fragment pa times rows [16 j, 16 j + 16) of
// the staged tile; `lt` is this lane's ldmatrix.trans row (rows (lane & 7) +
// 8 ((lane >> 3) & 1), d 8 (lane >> 4))
__device__ __forceinline__ void accumulate_tile(float acc[8][4], const uint32_t pa[4],
                                                const __nv_bfloat16* lt, int j) {
  using namespace muse::frag;
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; n += 2) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, lt + j * 16 * kTileRow + n * 8);
    mma16816(acc[n], pa, bf);
    mma16816(acc[n + 1], pa, bf + 2);
  }
}

// columns [16 j, 16 j + 16) of a 16 x 64 fp32 C-fragment tile as the bf16 A
// fragment of the next product
__device__ __forceinline__ void a_fragment(uint32_t pa[4], const float s[8][4], int j) {
  using namespace muse::frag;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    pa[2 * hi] = pack2(s[2 * j + hi][0], s[2 * j + hi][1]);
    pa[2 * hi + 1] = pack2(s[2 * j + hi][2], s[2 * j + hi][3]);
  }
}

// rows r0 and r0 + 8 (< rows) of a 16 x 64 fp32 accumulator as bf16, rows
// from `valid` on as zeros
__device__ __forceinline__ void store_rows16(__nv_bfloat16* base, int64_t st, const float acc[8][4],
                                             int r0, int rows, int valid, int t4) {
  using namespace muse::frag;
  const bool ok0 = r0 < valid, ok1 = r0 + 8 < valid;
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r0 < rows)
      *reinterpret_cast<uint32_t*>(base + r0 * st + c) = ok0 ? pack2(acc[n][0], acc[n][1]) : 0u;
    if (r0 + 8 < rows)
      *reinterpret_cast<uint32_t*>(base + (r0 + 8) * st + c) =
          ok1 ? pack2(acc[n][2], acc[n][3]) : 0u;
  }
}

__global__ void __launch_bounds__(kAttnThreads) attn_bwd_q_kernel(AttnBwdArgs p) {
  using namespace muse::frag;
  __shared__ __align__(16) __nv_bfloat16 Ks[2][kTile * kTileRow];
  __shared__ __align__(16) __nv_bfloat16 Vs[2][kTile * kTileRow];
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t head = int64_t(h) * kHeadDim;
  const __nv_bfloat16* kb = p.k + b * p.kv_sb + head;
  const __nv_bfloat16* vb = p.v + b * p.kv_sb + head;
  const int r0 = blockIdx.x * kTile + warp * 16 + g;  // this lane's rows r0, r0 + 8
  const int tiles = (p.kv_len + kTile - 1) / kTile;   // the key tiles with an attended key

  uint32_t qf[kHeadDim / 16][4], dof[kHeadDim / 16][4];
  load_a<kHeadDim>(qf, p.q + b * p.q_sb + head, p.q_st, r0, p.S, t4);
  load_a<kHeadDim>(dof, p.dout + b * p.o_sb + head, p.o_st, r0, p.S, t4);
  // this lane's ldmatrix row (lk) and ldmatrix.trans row (lt) in a staged tile
  const int lk = ((lane & 7) + ((lane >> 4) << 3)) * kTileRow + (((lane >> 3) & 1) << 3);
  const int lt = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kTileRow + ((lane >> 4) << 3);

  // one pass over the key tiles, K (and V) of tile t + 1 in flight while
  // tile t is used
  auto stream = [&](bool with_v, auto&& body) {
    stage_tile(Ks[0], kb, p.kv_st, 0, p.kv_len);
    if (with_v) stage_tile(Vs[0], vb, p.kv_st, 0, p.kv_len);
    cp_async_commit();
    for (int t = 0; t < tiles; ++t) {
      const int buf = t & 1;
      if (t + 1 < tiles) {
        stage_tile(Ks[buf ^ 1], kb, p.kv_st, (t + 1) * kTile, p.kv_len);
        if (with_v) stage_tile(Vs[buf ^ 1], vb, p.kv_st, (t + 1) * kTile, p.kv_len);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      body(t, Ks[buf], Vs[buf]);
      __syncthreads();  // every warp is done with buf before tile t + 2 overwrites it
    }
  };
  // S of tile t in the log2 domain, keys past kv_len at -inf
  auto logits = [&](float s[8][4], int t, const __nv_bfloat16* K) {
    rows_by_tile_t(s, qf, K + lk);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t * kTile + n * 8 + t4 * 2 + (e & 1);
        s[n][e] = key < p.kv_len ? s[n][e] * p.scale_log2 : -INFINITY;
      }
    }
  };

  // pass 1: the rows' max and sum of exp, online over the tiles
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  stream(false, [&](int t, const __nv_bfloat16* K, const __nv_bfloat16*) {
    float s[8][4];
    logits(s, t, K);
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      x0 = fmaxf(x0, fmaxf(s[n][0], s[n][1]));
      x1 = fmaxf(x1, fmaxf(s[n][2], s[n][3]));
    }
    // finite from the first tile on: key 0 < kv_len
    const float n0 = fmaxf(m0, quad_max(x0)), n1 = fmaxf(m1, quad_max(x1));
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      a0 += ex2(s[n][0] - n0) + ex2(s[n][1] - n0);
      a1 += ex2(s[n][2] - n1) + ex2(s[n][3] - n1);
    }
    l0 = l0 * ex2(m0 - n0) + quad_sum(a0);
    l1 = l1 * ex2(m1 - n1) + quad_sum(a1);
    m0 = n0;
    m1 = n1;
  });
  const float il0 = __frcp_rn(l0), il1 = __frcp_rn(l1);

  // pass 2: O = bf16(P) V in fp32, then D = rowsum(dO * O)
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  stream(true, [&](int t, const __nv_bfloat16* K, const __nv_bfloat16* V) {
    float s[8][4];
    logits(s, t, K);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = ex2(s[n][0] - m0) * il0;
      s[n][1] = ex2(s[n][1] - m0) * il0;
      s[n][2] = ex2(s[n][2] - m1) * il1;
      s[n][3] = ex2(s[n][3] - m1) * il1;
    }
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      uint32_t pa[4];
      a_fragment(pa, s, j);
      accumulate_tile(acc, pa, V + lt, j);
    }
  });
  // dof[kc] holds dO at the columns of acc[2 kc] (registers 0, 1) and
  // acc[2 kc + 1] (2, 3)
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int kc = 0; kc < kHeadDim / 16; ++kc) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float2 lo = __bfloat1622float2(reinterpret_cast<const bf2&>(dof[kc][2 * hi]));
      const float2 up = __bfloat1622float2(reinterpret_cast<const bf2&>(dof[kc][2 * hi + 1]));
      d0 += lo.x * acc[2 * kc + hi][0] + lo.y * acc[2 * kc + hi][1];
      d1 += up.x * acc[2 * kc + hi][2] + up.y * acc[2 * kc + hi][3];
    }
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  store_rows16(p.out + b * p.o_sb + head, p.o_st, acc, r0, p.S, p.S, t4);
  if (t4 == 0) {  // every row of the tile, past S too (0, 0, 0: P = 0 in the second kernel)
    const int64_t row = int64_t(blockIdx.y) * p.Sp + r0;
    const bool ok0 = r0 < p.S, ok1 = r0 + 8 < p.S;
    p.stat_m[row] = ok0 ? m0 : 0.f;
    p.stat_il[row] = ok0 ? il0 : 0.f;
    p.delta[row] = ok0 ? d0 : 0.f;
    p.stat_m[row + 8] = ok1 ? m1 : 0.f;
    p.stat_il[row + 8] = ok1 ? il1 : 0.f;
    p.delta[row + 8] = ok1 ? d1 : 0.f;
  }

  // pass 3: dP = dO V^T, dS = bf16(P (dP - D) / 8), dQ = dS K
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  stream(true, [&](int t, const __nv_bfloat16* K, const __nv_bfloat16* V) {
    float s[8][4], dp[8][4];
    logits(s, t, K);
    rows_by_tile_t(dp, dof, V + lk);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = (ex2(s[n][0] - m0) * il0) * (dp[n][0] - d0) * p.scale;
      s[n][1] = (ex2(s[n][1] - m0) * il0) * (dp[n][1] - d0) * p.scale;
      s[n][2] = (ex2(s[n][2] - m1) * il1) * (dp[n][2] - d1) * p.scale;
      s[n][3] = (ex2(s[n][3] - m1) * il1) * (dp[n][3] - d1) * p.scale;
    }
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      uint32_t pa[4];
      a_fragment(pa, s, j);
      accumulate_tile(acc, pa, K + lt, j);
    }
  });
  store_rows16(p.dq + b * p.q_sb + head, p.q_st, acc, r0, p.S, p.S, t4);
}

__global__ void __launch_bounds__(kAttnThreads) attn_bwd_kv_kernel(AttnBwdArgs p) {
  using namespace muse::frag;
  __shared__ __align__(16) __nv_bfloat16 Qs[2][kTile * kTileRow];
  __shared__ __align__(16) __nv_bfloat16 dOs[2][kTile * kTileRow];
  __shared__ __align__(16) float St[2][3][kTile];  // max | 1 / sum | D of the query tile
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int64_t head = int64_t(h) * kHeadDim;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + head;
  const __nv_bfloat16* dob = p.dout + b * p.o_sb + head;
  const int64_t stat0 = int64_t(blockIdx.y) * p.Sp;
  const int r0 = blockIdx.x * kTile + warp * 16 + g;  // this lane's keys r0, r0 + 8
  const int tiles = p.Sp / kTile;

  uint32_t kf[kHeadDim / 16][4], vf[kHeadDim / 16][4];
  load_a<kHeadDim>(kf, p.k + b * p.kv_sb + head, p.kv_st, r0, p.kv_len, t4);
  load_a<kHeadDim>(vf, p.v + b * p.kv_sb + head, p.kv_st, r0, p.kv_len, t4);
  const int lk = ((lane & 7) + ((lane >> 4) << 3)) * kTileRow + (((lane >> 3) & 1) << 3);
  const int lt = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kTileRow + ((lane >> 4) << 3);

  auto issue = [&](int t, int buf) {
    stage_tile(Qs[buf], qb, p.q_st, t * kTile, p.S);
    stage_tile(dOs[buf], dob, p.o_st, t * kTile, p.S);
    if (threadIdx.x < 3 * kTile / 4) {  // the statistics: whole 64-row tiles of Sp
      const int a = threadIdx.x / (kTile / 4), c = (threadIdx.x % (kTile / 4)) * 4;
      const float* src = (a == 0 ? p.stat_m : a == 1 ? p.stat_il : p.delta) + stat0 + t * kTile + c;
      cp_async16(&St[buf][a][c], src, 16);
    }
  };

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  issue(0, 0);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) issue(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* sm = St[buf][0];
    const float* si = St[buf][1];
    const float* sd = St[buf][2];
    // S^T (this warp's 16 keys x the tile's 64 queries) -> P^T, fp32
    float s[8][4];
    rows_by_tile_t(s, kf, Qs[buf] + lk);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = n * 8 + t4 * 2 + (e & 1);
        s[n][e] = ex2(s[n][e] * p.scale_log2 - sm[q]) * si[q];
      }
    }
    // dV += bf16(P^T) dO
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      uint32_t pa[4];
      a_fragment(pa, s, j);
      accumulate_tile(dv, pa, dOs[buf] + lt, j);
    }
    // dP^T = V dO^T; dS^T = bf16(P^T (dP^T - D) / 8); dK += dS^T Q
    float dp[8][4];
    rows_by_tile_t(dp, vf, dOs[buf] + lk);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = n * 8 + t4 * 2 + (e & 1);
        s[n][e] = s[n][e] * (dp[n][e] - sd[q]) * p.scale;
      }
    }
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      uint32_t pa[4];
      a_fragment(pa, s, j);
      accumulate_tile(dk, pa, Qs[buf] + lt, j);
    }
    __syncthreads();
  }
  // keys past kv_len: zero rows (their P^T, from zero K rows, is not 0)
  store_rows16(p.dk + b * p.kv_sb + head, p.kv_st, dk, r0, p.L, p.kv_len, t4);
  store_rows16(p.dv + b * p.kv_sb + head, p.kv_st, dv, r0, p.L, p.kv_len, t4);
}

// ---------------------------------------------------------------------------
// Backward of the sublayers' attention, S <= 288 and L <= 256: one block a
// (batch, head) pair on warpgroup products
// ---------------------------------------------------------------------------
//
// What bounds it: bytes.  At x (16, 256, 1024) the self core reads q, k, v
// and dO and writes out, dq, dk and dv, 67.1 MB (20.0 us at 3.35 TB/s),
// against 12.9 GFLOP of six products (13.0 us at 989 TFLOP/s); the cross
// core over 77 keys moves 43.7 MB (13.0 us) for 3.9 GFLOP.  The mma.sync pair
// above computes S four times, reads K and V once per 64-query block and pass
// and Q and dO once per 64-key block, on mma.sync, with the row statistics
// through device memory between its two launches.
//
// What the design does about it (namespace bwd):
// - A persistent block (one an SM) walks over the pairs and holds a pair's
//   Q, K, V and dO in shared memory, each read once from device memory by
//   TMA (the 4-D head maps of attn_sm90.cuh: free batch and token strides,
//   64-row boxes in the 128-byte swizzle, zeros past S and kv_len), each
//   on its own mbarrier, so the products start before the pair is whole.
//   Up to 128 keys the next pair's K, V and first two query tiles land
//   while a pair is worked on (Layout); above, once it is done.
// - Two warpgroups of 64 rows, no producer warpgroup (one thread issues the
//   loads): the 256-key phase A needs nearly all of a thread's 255
//   registers.  Every product is a wgmma.  Phase A, a warpgroup a 64-query
//   tile: S = Q K^T over the key capacity (a template argument, 96 or 256
//   keys: no product under a run-time condition), the exact softmax in
//   registers (P kept in fp32 as 2^(S c - max) with c = log2(e) / 8, one
//   IEEE reciprocal a row); then, over the keys in groups of 32, the next
//   group's products in flight while one is used: O = bf16(P) V (P's
//   fragments as A) and D = rowsum(dO * O) from the fp32 O and the dO
//   tile, as the mma.sync pair takes it; then dP = dO V^T with dS = bf16(P
//   (dP - D) / 8) and dQ += dS K, dO's fragments in registers.  The rows'
//   max, 1 / sum and D stay in shared memory (rows past S as (0, 0, 0):
//   their P is 0).  Phase B, after both warpgroups' statistics are in, a
//   warpgroup a 64-key block with K and V as A fragments: per 64 queries
//   S^T = K Q^T and dP^T = V dO^T, P^T from the statistics, dV += bf16(P^T)
//   dO and dK += dS^T Q.  S and dP are each computed twice, none stored;
//   nothing leaves the block but the four outputs.
// - out and dq (phase A) and dk and dv (phase B, rows past kv_len as zeros)
//   leave through a warpgroup's swizzled tiles by TMA stores, clipped at S
//   and L, while the warpgroup goes on.
// - Sums in a fixed order, no atomics: two calls are bit-equal.
namespace bwd {

using muse::attn::desc_at;
using muse::attn::fence_operands;
using muse::attn::fence_proxy_async;
using muse::attn::head_map;
using muse::attn::kBox;
using muse::attn::scores_step;
using muse::attn::tma_box;
using muse::attn::tma_store_box;
using muse::attn::tma_store_drain;
using muse::attn::tile_a_frags;
using muse::attn::warpgroup_sync;
using muse::attn::wgmma_rs;
using muse::attn::wgmma_rs_n32;
using muse::frag::ex2;
using muse::frag::pack2;
using muse::frag::quad_max;
using muse::frag::quad_sum;
using muse::sm90::fence_accumulators;
using muse::sm90::mbar_arrive;
using muse::sm90::mbar_expect_tx;
using muse::sm90::mbar_init;
using muse::sm90::mbar_wait;
using muse::sm90::smem_desc;
using muse::sm90::smem_desc_mn;
using muse::sm90::smem_u32;
using muse::sm90::wgmma_commit;
using muse::sm90::wgmma_fence;
using muse::sm90::wgmma_wait;

constexpr int kMaxRows = 288;  // the queries one block holds
constexpr int kMaxKeys = 256;  // and its keys: capacity 96 (cross's 77) or 256 (self's 256)
constexpr int kMaxTiles = (kMaxRows + 63) / 64;
constexpr int kConsumers = 2;  // warpgroups of 64 rows; no producer: one thread issues the loads
constexpr int kThreads = 128 * kConsumers;

// whether this kernel takes (S, L); the mma.sync pair takes the others
constexpr bool takes(int S, int L) { return S <= kMaxRows && L <= kMaxKeys; }

// the key capacity of L keys, in 32-key chunks (keys past L masked)
constexpr int chunks_of(int L) { return L <= 96 ? 3 : 8; }

// Shared memory of a key capacity and a pair's query tiles, 1024-byte
// aligned: K (k_slots slots of kKeyBoxes boxes), V, a ring of `slots` Q
// tiles and one of dO tiles, two output tiles a warpgroup, each row's max, 1
// / sum and D, the mbarriers (a K slot's, V's, K and V read, a ring slot's
// Q and dO).  What of the next pair loads while a pair is worked on:
// - up to 128 keys (kEarly), its K and V (phase B takes its K and V
//   fragments at its start) and, in two more ring slots where they fit,
//   its first two query tiles;
// - above, its K, into a second K slot where that fits; V and the query
//   tiles once this pair is done.  A second key block a
//   warpgroup in registers, or the ring's bookkeeping, cost the 256-key
//   kernel spills that made it slower on the card (PERF.md).
template <int kChunks>
struct Layout {
  static constexpr int kKeyBoxes = (kChunks * 32 + 63) / 64;
  static constexpr bool kEarly = kKeyBoxes <= kConsumers;
  static constexpr int kSpare = kEarly ? 2 : 0;
  int q_tiles, slots, k_slots;
  __host__ __device__ constexpr int v() const { return k_slots * kKeyBoxes * kBox; }
  __host__ __device__ constexpr int q() const { return v() + kKeyBoxes * kBox; }
  __host__ __device__ constexpr int dout() const { return q() + slots * kBox; }
  __host__ __device__ constexpr int tiles() const { return dout() + slots * kBox; }
  __host__ __device__ constexpr int stats() const { return tiles() + 2 * kConsumers * kBox; }
  __host__ __device__ constexpr int barriers() const { return stats() + 3 * kMaxTiles * 64 * 4; }
  __host__ __device__ constexpr int bytes() const {
    return 1024 + barriers() + (4 + kMaxTiles + kSpare) * 8;
  }
  __host__ __device__ constexpr bool fits() const { return bytes() <= 232448; }
  // the layout of S queries: the next pair's slots where they fit
  __host__ __device__ static constexpr Layout of(int S) {
    const int t = (S + 63) / 64;
    if (kEarly) return Layout{t, t + kSpare, 1}.fits() ? Layout{t, t + kSpare, 1} : Layout{t, t, 1};
    return Layout{t, t, 2}.fits() ? Layout{t, t, 2} : Layout{t, t, 1};
  }
};
static_assert(Layout<chunks_of(kMaxKeys)>{kMaxTiles, kMaxTiles, 1}.fits(),
              "the SM's shared memory");

// the 64 x 64 fp32 accumulators of a warpgroup as bf16 into a tile in the
// 128-byte swizzle (16-byte chunk n of row r at n ^ (r % 8)); rows r, r + 8
// written as zeros where `keep0` / `keep1` is false
__device__ __forceinline__ void to_tile(unsigned char* tile, const float* acc, int r, int t4,
                                        bool keep0 = true, bool keep1 = true) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(tile + r * 128 + ((n ^ (r & 7)) << 4) + 4 * t4) =
        keep0 ? pack2(acc[4 * n], acc[4 * n + 1]) : 0u;
    *reinterpret_cast<uint32_t*>(tile + (r + 8) * 128 + ((n ^ (r & 7)) << 4) + 4 * t4) =
        keep1 ? pack2(acc[4 * n + 2], acc[4 * n + 3]) : 0u;
  }
}

// 16-key (or 16-query) steps of a 64 x 64 fp32 accumulator block as bf16 A
// fragments: x holds keys 16 j .. + 15 of rows g (0, 1, 4, 5) and g + 8
__device__ __forceinline__ void a_frag(uint32_t a[4], const float* x) {
  a[0] = pack2(x[0], x[1]);
  a[1] = pack2(x[2], x[3]);
  a[2] = pack2(x[4], x[5]);
  a[3] = pack2(x[6], x[7]);
}

// Phase A goes over the key capacity in groups of 32 keys (two 16-key steps
// from step j0), each group's products one commit group and the next
// group's in flight while one is used: S's accumulators stay live through
// the passes, and the rest has to fit beside them.

// P's A fragments for keys 16 j0 .. + 31: the exponentials x (of those
// keys) times each row's 1 / sum, rounded to bf16
__device__ __forceinline__ void p_frags(uint32_t (&a)[2][4], const float* x, float inv0,
                                        float inv1) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = x[8 * j + e] * ((e & 2) ? inv1 : inv0);  // 2, 3, 6, 7: r + 8
    a_frag(a[j], v);
  }
}

// dP = dO V^T over keys 16 j0 .. + 31, one commit group: dO's fragments
// from registers, V K-major from shared memory (descriptor vk)
__device__ __forceinline__ void issue_dp(float* dp, const uint32_t (&dof)[4][4], uint64_t vk,
                                         int j0) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_n32<0>(dp, dof[kk], desc_at(vk, j0 * 2048 + kk * 32), kk);
  wgmma_commit();
}

template <int kChunks>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_o,
                      const __grid_constant__ CUtensorMap map_dq,
                      const __grid_constant__ CUtensorMap map_dk,
                      const __grid_constant__ CUtensorMap map_dv, int B, int H, int S, int L,
                      int kv_len, float scale_log2, float scale) {
  using Lay = Layout<kChunks>;
  constexpr int kS = 16 * kChunks;     // S's accumulators a thread
  constexpr int kSteps = 2 * kChunks;  // 16-key steps of the capacity
  constexpr int kKeyBoxes = Lay::kKeyBoxes;
  constexpr bool kEarly = Lay::kEarly;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* smem = bwd_smem + ((1024 - (smem_u32(bwd_smem) & 1023)) & 1023);
  const Lay lay = Lay::of(S);
  const int q_tiles = lay.q_tiles, slots = lay.slots, k_slots = lay.k_slots;
  const int k_blocks = (L + 63) / 64;
  const int ahead = slots - q_tiles;  // the next pair's tiles loaded during this pair
  const uint32_t k0 = smem_u32(smem), vs = k0 + lay.v(), qs = k0 + lay.q(), dos = k0 + lay.dout();
  float* stat_m = reinterpret_cast<float*>(smem + lay.stats());
  float* stat_il = stat_m + kMaxTiles * 64;
  float* stat_d = stat_il + kMaxTiles * 64;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + lay.barriers());  // a K slot's
  uint64_t* full_v = full_k + 2;
  uint64_t* kv_read = full_k + 3;  // every thread has its K and V fragments
  uint64_t* full_t = full_k + 4;   // a ring slot's Q and dO

  // the warpgroup, broadcast so that ptxas sees it uniform: loops over a
  // warpgroup's tasks would otherwise serialise its wgmma (C7520)
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
  const int w4 = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r = w4 * 16 + g;  // this thread's rows r and r + 8 of a warpgroup's 64
  const bool leader = threadIdx.x % 128 == 0;  // issues the warpgroup's stores
  unsigned char* tile0 = smem + lay.tiles() + wg * 2 * kBox;
  unsigned char* tile1 = tile0 + kBox;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4 + kMaxTiles + Lay::kSpare; ++i)
      mbar_init(&full_k[i], i == 3 ? kThreads : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Loads, all issued by thread 0.  Query tile t of the block's i-th pair
  // (global tile n = i q_tiles + t) lies in ring slot n % slots, its
  // barrier's phase n / slots: the slot's last user is pair i - 1 (its
  // tiles past `ahead`) or, for the first `ahead` tiles, pair i - 2's.
  auto load_k = [&](int i, int pb, int ph) {  // into the K slot of the block's i-th pair
    unsigned char* dst = smem + (i % k_slots) * kKeyBoxes * kBox;
    uint64_t* bar = &full_k[i % k_slots];
    mbar_expect_tx(bar, kKeyBoxes * kBox);
    for (int j = 0; j < kKeyBoxes; ++j) tma_box(dst + j * kBox, &map_k, bar, ph, j * 64, pb);
  };
  auto load_v = [&](int pb, int ph) {
    mbar_expect_tx(full_v, kKeyBoxes * kBox);
    for (int j = 0; j < kKeyBoxes; ++j)
      tma_box(smem + lay.v() + j * kBox, &map_v, full_v, ph, j * 64, pb);
  };
  auto load_tile = [&](int i, int t) {
    const int pp = blockIdx.x + i * gridDim.x, slot = (i * q_tiles + t) % slots;
    mbar_expect_tx(&full_t[slot], 2 * kBox);
    tma_box(smem + lay.q() + slot * kBox, &map_q, &full_t[slot], pp % H, t * 64, pp / H);
    tma_box(smem + lay.dout() + slot * kBox, &map_do, &full_t[slot], pp % H, t * 64, pp / H);
  };
  const int pairs = B * H;
  if (threadIdx.x == 0 && int(blockIdx.x) < pairs) {  // the first pair's operands loaded ahead
    if (kEarly || k_slots > 1) load_k(0, blockIdx.x / H, blockIdx.x % H);
    if (kEarly) load_v(blockIdx.x / H, blockIdx.x % H);
    for (int t = 0; t < ahead && t < q_tiles; ++t) load_tile(0, t);
  }

  for (int i = 0, p = blockIdx.x; p < pairs; ++i, p += gridDim.x) {
    const int b = p / H, h = p % H;
    const uint32_t parity = i & 1;
    const bool next = p + int(gridDim.x) < pairs;
    // ring slot and barrier phase of this pair's query tile t
    auto slot_of = [&](int t) { return kEarly ? (i * q_tiles + t) % slots : t; };
    auto phase_of = [&](int t) {
      return kEarly ? uint32_t((i * q_tiles + t) / slots) & 1 : parity;
    };
    if (threadIdx.x == 0) {  // every earlier read of these slots is done
      if constexpr (kEarly) {
        for (int t = ahead; t < q_tiles; ++t) load_tile(i, t);
        if (next)
          for (int t = 0; t < ahead && t < q_tiles; ++t) load_tile(i + 1, t);
      } else {  // (K), the first tiles, V (which the products need after S), the
                // rest, the next pair's K into the other K slot
        if (k_slots == 1) load_k(i, b, h);
        for (int t = 0; t < min(q_tiles, kConsumers); ++t) load_tile(i, t);
        load_v(b, h);
        for (int t = kConsumers; t < q_tiles; ++t) load_tile(i, t);
        if (k_slots > 1 && next) load_k(i + 1, (p + gridDim.x) / H, (p + gridDim.x) % H);
      }
    }

    // phase A: query tiles t = wg, wg + 2, ...
    const uint32_t ks = k0 + (i % k_slots) * kKeyBoxes * kBox;
    unsigned char* kbase = smem + (i % k_slots) * kKeyBoxes * kBox;
    mbar_wait(&full_k[i % k_slots], uint32_t(i / k_slots) & 1);
    for (int t = wg; t < q_tiles; t += kConsumers) {
      const int slot = slot_of(t);
      mbar_wait(&full_t[slot], phase_of(t));
      const uint32_t qa = qs + slot * kBox;
      float sc[kS];  // sc[4 n + e]: key 8 n + 2 t4 + (e & 1) of row r (e < 2) or r + 8
#pragma unroll
      for (int e = 0; e < kS; ++e) sc[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) scores_step<kChunks>(sc, qa, ks, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_accumulators<kS>(sc);

      // P = 2^(S c - max c) / sum, kept as the exponentials and 1 / sum
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < kS / 4; ++n) {
        float* x = sc + 4 * n;
        if (8 * n + 8 > kv_len) {  // keys at or past kv_len: -inf
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * n + t4 * 2 + (e & 1) >= kv_len) x[e] = -INFINITY;
        }
        m0 = fmaxf(m0, fmaxf(x[0], x[1]));
        m1 = fmaxf(m1, fmaxf(x[2], x[3]));
      }
      // finite: key 0 is never masked
      const float base0 = quad_max(m0) * scale_log2, base1 = quad_max(m1) * scale_log2;
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int n = 0; n < kS / 4; ++n) {
        float* x = sc + 4 * n;
        x[0] = ex2(fmaf(x[0], scale_log2, -base0));
        x[1] = ex2(fmaf(x[1], scale_log2, -base0));
        x[2] = ex2(fmaf(x[2], scale_log2, -base1));
        x[3] = ex2(fmaf(x[3], scale_log2, -base1));
        l0 += x[0] + x[1];
        l1 += x[2] + x[3];
      }
      const float inv0 = __frcp_rn(quad_sum(l0)), inv1 = __frcp_rn(quad_sum(l1));

      // pass 1: O = bf16(P) V in fp32, P's fragments of one group built
      // while the group before multiplies
      mbar_wait(full_v, parity);
      const uint64_t vmn = smem_desc_mn(vs), vk = smem_desc(vs), kmn = smem_desc_mn(ks);
      float acc[32];
      {
        uint32_t pa[2][2][4];
#pragma unroll
        for (int j0 = 0; j0 < kSteps; j0 += 2) {
          const int buf = (j0 / 2) & 1;
          if (j0 >= 4) {  // the group that read this buffer is done
            wgmma_wait<1>();
            fence_operands<8>(&pa[buf][0][0]);
          }
          p_frags(pa[buf], sc + 8 * j0, inv0, inv1);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wgmma_rs<1>(acc, pa[buf][j], desc_at(vmn, (j0 + j) * 2048), j0 + j);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_operands<16>(&pa[0][0][0]);
      }
      fence_accumulators<32>(acc);

      // D = rowsum(dO * O): dO's bf16 pairs at the places of O's
      // accumulators in the swizzled tile
      const unsigned char* dot = smem + lay.dout() + slot * kBox;
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int at = ((n ^ (r & 7)) << 4) + 4 * t4;
        const auto* g0 = reinterpret_cast<const __nv_bfloat162*>(dot + r * 128 + at);
        const auto* g1 = reinterpret_cast<const __nv_bfloat162*>(dot + (r + 8) * 128 + at);
        const float2 o0 = __bfloat1622float2(*g0), o1 = __bfloat1622float2(*g1);
        d0 += acc[4 * n] * o0.x + acc[4 * n + 1] * o0.y;
        d1 += acc[4 * n + 2] * o1.x + acc[4 * n + 3] * o1.y;
      }
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);

      // out through tile 0 (the previous task's tiles have left first)
      if (leader) tma_store_drain();
      warpgroup_sync(wg);
      to_tile(tile0, acc, r, t4);
      fence_proxy_async();
      warpgroup_sync(wg);
      if (leader) tma_store_box(&map_o, tile0, h, t * 64, b);

      uint32_t dof[4][4];  // dO's A fragments, for dP
      tile_a_frags(dof, dot, r, t4);
      if (t4 == 0) {  // the rows' statistics; rows past S (0, 0, 0): P = 0 in phase B
        const int row = t * 64 + r;
        const bool ok0 = row < S, ok1 = row + 8 < S;
        stat_m[row] = ok0 ? base0 : 0.f;
        stat_il[row] = ok0 ? inv0 : 0.f;
        stat_d[row] = ok0 ? d0 : 0.f;
        stat_m[row + 8] = ok1 ? base1 : 0.f;
        stat_il[row + 8] = ok1 ? inv1 : 0.f;
        stat_d[row + 8] = ok1 ? d1 : 0.f;
      }

      // pass 2: dP = dO V^T, dS = bf16(P (dP - D) / 8), dQ += dS K; the next
      // group's dP in flight while one group's dS is formed
      float dq[32];
      {
        float dp[2][16];
        uint32_t ds[2][4];
        issue_dp(dp[0], dof, vk, 0);
#pragma unroll
        for (int j0 = 0; j0 < kSteps; j0 += 2) {
          const int buf = (j0 / 2) & 1;
          if (j0 + 2 < kSteps) {  // then: this group's dP and the last group's dQ are done
            issue_dp(dp[buf ^ 1], dof, vk, j0 + 2);
            wgmma_wait<1>();
          } else {
            wgmma_wait<0>();
          }
          fence_accumulators<16>(dp[buf]);
          fence_operands<8>(&ds[0][0]);
          const float* x = sc + 8 * j0;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const bool up = e & 2;  // elements 2, 3, 6, 7: row r + 8
              v[e] = (x[8 * j + e] * (up ? inv1 : inv0)) * (dp[buf][8 * j + e] - (up ? d1 : d0)) *
                     scale;
            }
            a_frag(ds[j], v);
          }
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wgmma_rs<1>(dq, ds[j], desc_at(kmn, (j0 + j) * 2048), j0 + j);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_operands<8>(&ds[0][0]);
        fence_operands<16>(&dof[0][0]);
      }
      fence_accumulators<32>(dq);
      to_tile(tile1, dq, r, t4);
      fence_proxy_async();
      warpgroup_sync(wg);
      if (leader) tma_store_box(&map_dq, tile1, h, t * 64, b);
    }
    __syncthreads();  // every row's statistics are in

    // phase B: key blocks kb0, kb0 + 2, ..., the warpgroup that had fewer
    // query tiles first; K and V as A fragments (up to 128 keys, one block a
    // warpgroup, read before the next pair's K and V are let in)
    const int kb0 = (wg + q_tiles) % kConsumers;
    uint32_t kf[4][4], vf[4][4];
    if constexpr (kEarly) {  // the block's fragments now, then the next pair's K and V
      if (kb0 < k_blocks) {
        tile_a_frags(kf, kbase + kb0 * kBox, r, t4);
        tile_a_frags(vf, smem + lay.v() + kb0 * kBox, r, t4);
      }
      mbar_arrive(kv_read);
      if (threadIdx.x == 0 && next) {
        mbar_wait(kv_read, parity);
        load_k(i + 1, (p + gridDim.x) / H, (p + gridDim.x) % H);
        load_v((p + gridDim.x) / H, (p + gridDim.x) % H);
      }
    }
    for (int kb = kb0; kb < k_blocks; kb += kConsumers) {
      if constexpr (!kEarly) {
        tile_a_frags(kf, kbase + kb * kBox, r, t4);
        tile_a_frags(vf, smem + lay.v() + kb * kBox, r, t4);
      }
      float dv[32], dk[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) dv[e] = dk[e] = 0.f;
      uint32_t pt[4][4], dt[4][4];  // the last 64 queries' A fragments of P^T and dS^T
      for (int c = 0; c < q_tiles; ++c) {
        float st[32], dpt[32];  // st[4 n + e]: query 64 c + 8 n + 2 t4 + (e & 1), key row r / r + 8
        const uint32_t qc = qs + slot_of(c) * kBox, dc = dos + slot_of(c) * kBox;
        const uint64_t qk = smem_desc(qc), dok = smem_desc(dc);
        const uint64_t qmn = smem_desc_mn(qc), dmn = smem_desc_mn(dc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs<0>(st, kf[kk], desc_at(qk, kk * 32), kk);
          wgmma_rs<0>(dpt, vf[kk], desc_at(dok, kk * 32), kk);
        }
        wgmma_commit();
        wgmma_wait<0>();  // also the last 64 queries' dV and dK products
        fence_accumulators<32>(st);
        fence_accumulators<32>(dpt);
        fence_operands<16>(&pt[0][0]);
        fence_operands<16>(&dt[0][0]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int q = c * 64 + 8 * n + 2 * t4;
          const float2 m = *reinterpret_cast<const float2*>(stat_m + q);
          const float2 il = *reinterpret_cast<const float2*>(stat_il + q);
          const float2 dd = *reinterpret_cast<const float2*>(stat_d + q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            const float pv = ex2(fmaf(st[4 * n + e], scale_log2, -(odd ? m.y : m.x))) *
                             (odd ? il.y : il.x);
            dpt[4 * n + e] = pv * (dpt[4 * n + e] - (odd ? dd.y : dd.x)) * scale;
            st[4 * n + e] = pv;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a_frag(pt[j], st + 8 * j);
          a_frag(dt[j], dpt + 8 * j);
        }
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_rs<1>(dv, pt[j], desc_at(dmn, j * 2048), 1);
#pragma unroll
        for (int j = 0; j < 4; ++j) wgmma_rs<1>(dk, dt[j], desc_at(qmn, j * 2048), 1);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_operands<16>(&pt[0][0]);
      fence_operands<16>(&dt[0][0]);
      fence_operands<16>(&kf[0][0]);
      fence_operands<16>(&vf[0][0]);
      fence_accumulators<32>(dv);
      fence_accumulators<32>(dk);
      // keys past kv_len: zero rows (their P^T, from zero K rows, is not 0)
      const int key = kb * 64 + r;
      if (leader) tma_store_drain();
      warpgroup_sync(wg);
      to_tile(tile0, dk, r, t4, key < kv_len, key + 8 < kv_len);
      to_tile(tile1, dv, r, t4, key < kv_len, key + 8 < kv_len);
      fence_proxy_async();
      warpgroup_sync(wg);
      if (leader) {
        tma_store_box(&map_dk, tile0, h, kb * 64, b);
        tma_store_box(&map_dv, tile1, h, kb * 64, b);
      }
    }
    __syncthreads();  // the pair's operands are read: the next pair's may land
  }
  if (leader) tma_store_drain();  // the last tiles have left shared memory
}

template <int kChunks>
cudaError_t launch(const AttnBwdArgs& p, int B, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v, map_do, map_o, map_dq, map_dk, map_dv;
  const int H = p.H, S = p.S;
  cudaError_t err = head_map(&map_q, p.q, B, S, H, kHeadDim, p.q_sb, p.q_st);
  if (err == cudaSuccess) err = head_map(&map_k, p.k, B, p.kv_len, H, kHeadDim, p.kv_sb, p.kv_st);
  if (err == cudaSuccess) err = head_map(&map_v, p.v, B, p.kv_len, H, kHeadDim, p.kv_sb, p.kv_st);
  if (err == cudaSuccess) err = head_map(&map_do, p.dout, B, S, H, kHeadDim, p.o_sb, p.o_st);
  if (err == cudaSuccess) err = head_map(&map_o, p.out, B, S, H, kHeadDim, p.o_sb, p.o_st);
  if (err == cudaSuccess) err = head_map(&map_dq, p.dq, B, S, H, kHeadDim, p.q_sb, p.q_st);
  if (err == cudaSuccess) err = head_map(&map_dk, p.dk, B, p.L, H, kHeadDim, p.kv_sb, p.kv_st);
  if (err == cudaSuccess) err = head_map(&map_dv, p.dv, B, p.L, H, kHeadDim, p.kv_sb, p.kv_st);
  if (err != cudaSuccess) return err;
  auto kernel = attn_bwd_wgmma_kernel<kChunks>;
  static const cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (configured != cudaSuccess) return configured;
  const int grid = std::min(B * H, muse::sm90::sm_count());  // persistent: one block an SM
  kernel<<<grid, kThreads, Layout<kChunks>::of(S).bytes(), stream>>>(
      map_q, map_k, map_v, map_do, map_o, map_dq, map_dk, map_dv, B, H, S, p.L, p.kv_len,
      p.scale_log2, p.scale);
  return cudaGetLastError();
}

// by the key capacity of L
cudaError_t launch(const AttnBwdArgs& p, int B, cudaStream_t stream) {
  return chunks_of(p.L) == 3 ? launch<3>(p, B, stream) : launch<8>(p, B, stream);
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// Backward: rmsnorm / AdaLN (attn_sublayer.py `_rms_adaln_bwd`)
// ---------------------------------------------------------------------------

constexpr int kChunkRows = 32;  // rows per partial sum of d(adaln) and d(ln)

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// dx = bf16(bf16(r * (dn - hhat * mean_D(dn * hhat))) + g_res), one block per
// row, with hhat = bf16(h * bf16(r)) and dn = da * (1 + adaln_scale) * ln.
__global__ void __launch_bounds__(kRowThreads)
rms_adaln_bwd_row_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ da,
                         const __nv_bfloat16* __restrict__ ln,
                         const __nv_bfloat16* __restrict__ adaln,
                         const __nv_bfloat16* __restrict__ g_res, const float* __restrict__ rstd,
                         __nv_bfloat16* __restrict__ dx, int S, int D) {
  const int64_t row = blockIdx.x;
  const int batch = int(row / S);
  const float r = rstd[row];
  const float r_b = bf16_round(r);
  const __nv_bfloat16* scale = adaln + int64_t(batch) * 2 * D;
  const __nv_bfloat16* hr = h + row * D;
  const __nv_bfloat16* dar = da + row * D;
  auto dn_hhat = [&](int i, float& dn, float& hhat) {
    hhat = bf16_round(__bfloat162float(hr[i]) * r_b);
    dn = (__bfloat162float(dar[i]) * (1.0f + __bfloat162float(scale[i]))) * __bfloat162float(ln[i]);
  };
  float acc = 0.f;
  for (int i = threadIdx.x; i < D; i += kRowThreads) {
    float dn, hhat;
    dn_hhat(i, dn, hhat);
    acc += dn * hhat;
  }
  __shared__ float warp_sums[kRowThreads / 32];
  __shared__ float mean;
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < kRowThreads / 32; ++i) total += warp_sums[i];
    mean = total / float(D);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += kRowThreads) {
    float dn, hhat;
    dn_hhat(i, dn, hhat);
    const float dh = r * (dn - hhat * mean);
    dx[row * D + i] = __float2bfloat16_rn(bf16_round(dh) + __bfloat162float(g_res[row * D + i]));
  }
}

// The same dx with the row in registers: a warp a row of width kVecs * 256,
// kRegRows rows a block, every 16-byte load of h, da, g_res, ln and scale
// issued before any arithmetic; the row's sum of dn * hhat over the warp by
// shuffles, in a fixed order.
template <int kVecs>
__global__ void __launch_bounds__(32 * kRegRows)
rms_adaln_bwd_rows_kernel(const uint4* __restrict__ h, const uint4* __restrict__ da,
                          const uint4* __restrict__ ln, const __nv_bfloat16* __restrict__ adaln,
                          const uint4* __restrict__ g_res, const float* __restrict__ rstd,
                          uint4* __restrict__ dx, int rows, int S) {
  constexpr int D = kVecs * 256, kRowVecs = D / 8;
  const int lane = threadIdx.x % 32;
  const int64_t row = int64_t(blockIdx.x) * kRegRows + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps: no block barrier below
  const uint4* scale = reinterpret_cast<const uint4*>(adaln + (row / S) * 2 * D);
  uint4 hv[kVecs], dv[kVecs], gv[kVecs], lv[kVecs], sv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    hv[i] = h[row * kRowVecs + i * 32 + lane];
    dv[i] = da[row * kRowVecs + i * 32 + lane];
    gv[i] = g_res[row * kRowVecs + i * 32 + lane];
    lv[i] = ln[i * 32 + lane];
    sv[i] = scale[i * 32 + lane];
  }
  const float r = rstd[row];
  const float r_b = bf16_round(r);
  float2 dn[kVecs][4], hhat[kVecs][4];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 hh = pair(hv[i], p), d = pair(dv[i], p), l = pair(lv[i], p), sc = pair(sv[i], p);
      hhat[i][p] = round2(make_float2(hh.x * r_b, hh.y * r_b));
      dn[i][p] = make_float2((d.x * (1.0f + sc.x)) * l.x, (d.y * (1.0f + sc.y)) * l.y);
      acc += dn[i][p].x * hhat[i][p].x;
      acc += dn[i][p].y * hhat[i][p].y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const float mean = acc / float(D);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    uint4 out;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 g = pair(gv[i], p);
      const float2 dh = round2(make_float2(r * (dn[i][p].x - hhat[i][p].x * mean),
                                           r * (dn[i][p].y - hhat[i][p].y * mean)));
      reinterpret_cast<bf2*>(&out)[p] = __floats2bfloat162_rn(dh.x + g.x, dh.y + g.y);
    }
    dx[row * kRowVecs + i * 32 + lane] = out;
  }
}

// Per 32-row chunk of one batch element, one thread per column: partial sums
// of d(scale) = da * n2, d(shift) = da and d(ln) = da * (1 + scale) * hhat,
// written to partial[(batch * chunks + chunk) * 3 + {0, 1, 2}][D].
__global__ void __launch_bounds__(kRowThreads)
rms_adaln_bwd_col_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ da,
                         const __nv_bfloat16* __restrict__ ln,
                         const __nv_bfloat16* __restrict__ adaln, const float* __restrict__ rstd,
                         float* __restrict__ partial, int S, int D) {
  const int d = blockIdx.x * kRowThreads + threadIdx.x;
  if (d >= D) return;
  const int chunk = blockIdx.y;
  const int batch = blockIdx.z;
  const float one_plus = 1.0f + __bfloat162float(adaln[int64_t(batch) * 2 * D + d]);
  const float ln_d = __bfloat162float(ln[d]);
  float ds = 0.f, dt = 0.f, dl = 0.f;
  const int s1 = min(S, (chunk + 1) * kChunkRows);
  for (int s = chunk * kChunkRows; s < s1; ++s) {
    const int64_t row = int64_t(batch) * S + s;
    const float hhat = bf16_round(__bfloat162float(h[row * D + d]) * bf16_round(rstd[row]));
    const float n2 = bf16_round(hhat * ln_d);
    const float daf = __bfloat162float(da[row * D + d]);
    ds += daf * n2;
    dt += daf;
    dl += (daf * one_plus) * hhat;
  }
  float* out = partial + (int64_t(batch) * gridDim.y + chunk) * 3 * D;
  out[d] = ds;
  out[D + d] = dt;
  out[2 * D + d] = dl;
}

// d(adaln)[b] = [sum over b's chunks of d(scale) | of d(shift)] (blockIdx.y
// < B) and d(ln) = sum over every chunk (blockIdx.y == B), in a fixed order.
__global__ void __launch_bounds__(kRowThreads)
rms_adaln_bwd_reduce_kernel(const float* __restrict__ partial, __nv_bfloat16* __restrict__ dadaln,
                            __nv_bfloat16* __restrict__ dln, int B, int D, int chunks) {
  const int d = blockIdx.x * kRowThreads + threadIdx.x;
  if (d >= D) return;
  const int b = blockIdx.y;
  if (b < B) {
    float ds = 0.f, dt = 0.f;
    for (int c = 0; c < chunks; ++c) {
      const float* in = partial + (int64_t(b) * chunks + c) * 3 * D;
      ds += in[d];
      dt += in[D + d];
    }
    dadaln[int64_t(b) * 2 * D + d] = __float2bfloat16_rn(ds);
    dadaln[int64_t(b) * 2 * D + D + d] = __float2bfloat16_rn(dt);
  } else {
    float dl = 0.f;
    for (int i = 0; i < B * chunks; ++i) dl += partial[int64_t(i) * 3 * D + 2 * D + d];
    dln[d] = __float2bfloat16_rn(dl);
  }
}

// ---------------------------------------------------------------------------
// Launch helpers
// ---------------------------------------------------------------------------

// q/k/v pointers and strides of one sublayer of inner width I (64 x the
// heads): `kv` == nullptr selects self attention over proj = qkv (B, S, 3I);
// otherwise proj = q (B, S, I) and kv the (B, L, 2I) [k|v] projection of the
// text context.
AttnArgs attn_args(const __nv_bfloat16* proj, const __nv_bfloat16* kv, int S, int I, int L,
                   int kv_len) {
  AttnArgs args{};
  const bool self_attn = kv == nullptr;
  const int n_in = self_attn ? 3 * I : I;
  args.q = proj;
  args.q_bs = int64_t(S) * n_in;
  args.q_rs = n_in;
  if (self_attn) {
    args.k = proj + I;
    args.v = proj + 2 * I;
    args.kv_bs = args.q_bs;
    args.kv_rs = args.q_rs;
    args.L = S;
    args.kv_len = S;
  } else {
    args.k = kv;
    args.v = kv + I;
    args.kv_bs = int64_t(L) * 2 * I;
    args.kv_rs = 2 * I;
    args.L = L;
    args.kv_len = kv_len;
  }
  args.scale = 1.0f / sqrtf(float(kHeadDim));
  return args;
}

// h = x + res, a = adaln(rmsnorm(h)) and, when rstd is given, each row's
// 1/rms: the register row kernel at width 1024, the block-a-row one at others
cudaError_t launch_norm_rows(const void* x, const void* res, const void* ln, const void* adaln,
                             void* h, void* a, float* rstd, int rows, int S, int D, float eps,
                             cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (D == 1024) {
    rmsnorm_adaln_rows_kernel<4><<<(rows + kRegRows - 1) / kRegRows, 32 * kRegRows, 0, stream>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(res),
        static_cast<const uint4*>(ln), static_cast<const bf*>(adaln), static_cast<uint4*>(h),
        static_cast<uint4*>(a), rstd, rows, S, eps);
  } else {
    rmsnorm_adaln_kernel<<<rows, kRowThreads, 0, stream>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(res), static_cast<const bf*>(ln),
        static_cast<const bf*>(adaln), static_cast<bf*>(h), static_cast<bf*>(a), rstd, S, D, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// One sublayer forward as four launches on `stream`: the row kernel, the
// in-projection and the out projection on the Hopper GEMM, and
// flash_attention.cu's attention over q / k / v as strided views.  The
// attention's inner width is I = 64 H: the model width D, or a tensor-parallel
// rank's share of D (its H heads).  `kv` == nullptr selects the self
// sublayer: w_in is Wqkv (3I, D) and qkv_buf is (B, S, 3I).  Otherwise w_in
// is Wq (I, D), qkv_buf is (B, S, I) and kv is the (B, L, 2I) [k|v]
// projection of the text context, of which the first kv_len keys are
// attended.  w_out is (D, I), attn_buf (B, S, I).  res may be nullptr (zeros).
extern "C" int muse_attn_sublayer(const void* x, const void* res, const void* ln,
                                  const void* adaln, const void* w_in, const void* w_out,
                                  const void* kv, void* h_out, void* a_buf, void* qkv_buf,
                                  void* attn_buf, void* out, int B, int S, int D, int H, int L,
                                  int kv_len, float eps, void* stream_ptr) {
  using bf = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows = B * S;
  const int I = kHeadDim * H;
  const int n_in = kv == nullptr ? 3 * I : I;
  cudaError_t err =
      launch_norm_rows(x, res, ln, adaln, h_out, a_buf, nullptr, rows, S, D, eps, stream);
  if (err != cudaSuccess) return int(err);
  bf* proj = static_cast<bf*>(qkv_buf);
  err = muse::sm90::gemm_tn(static_cast<const bf*>(a_buf), static_cast<const bf*>(w_in),
                            muse::StoreBf16{proj, n_in}, rows, n_in, D, stream);
  if (err != cudaSuccess) return int(err);
  const AttnArgs args = attn_args(proj, static_cast<const bf*>(kv), S, I, L, kv_len);
  const int64_t strides[6] = {args.q_bs, args.q_rs, args.kv_bs, args.kv_rs, args.kv_bs, args.kv_rs};
  const int status = muse_flash_attention(args.q, args.k, args.v, attn_buf, B, H, S, args.kv_len,
                                          kHeadDim, strides, args.scale, stream);
  if (status != 0) return status;
  return int(muse::sm90::gemm_tn(static_cast<const bf*>(attn_buf), static_cast<const bf*>(w_out),
                                 muse::StoreBf16{static_cast<bf*>(out), D}, rows, D, I, stream));
}

// One sublayer backward on `stream`, inputs as the forward's plus g_out and
// g_res (B, S, D); I = 64 H as in the forward.  Outputs: dx (B, S, D) -- also
// the gradient of res --, dadaln (B, 2D), dln (D,), a (B, S, D), dproj = dqkv
// (B, S, 3I) or dq (B, S, I), attn (B, S, I) and, for cross, dkv (B, L, 2I),
// zero past kv_len.  Scratch: h (B, S, D), proj like dproj, dattn (B, S,
// max(D, I)), rstd (B * S) fp32, partial (B * ceil(S / 32) * 3 * D) fp32 and,
// where muse_attn_bwd_one_block(S, L) is 0, stats (3, B, H, S rounded up to
// 64) fp32 (else it may be null).  On a head shard (I < D) dx, dln and dadaln
// are this shard's part of the gradients; the caller sums them over the
// shards.  Self (kernel 11) and cross (kernel 12) run one chain of eight
// launches: the row kernel (keeping 1/rms; the register one at width 1024),
// the in-projection (qkv or q) and dattn = g_out @ Wout on the Hopper GEMM
// (Wout read MN-major), the attention backward (one block a (batch, head)
// pair on wgmma up to 288 queries and 256 keys; above, the two mma.sync
// kernels, a ninth launch), da = dproj @ W_in on the Hopper GEMM (W_in read
// MN-major), the row kernel of dx (the register one at width 1024), and the
// two-stage d(adaln) / d(ln) reduction.
extern "C" int muse_attn_sublayer_bwd(
    const void* x, const void* res, const void* ln, const void* adaln, const void* w_in,
    const void* w_out, const void* kv, const void* g_out, const void* g_res, void* dx,
    void* dadaln, void* dln, void* a_buf, void* dproj, void* attn_buf, void* dkv, void* h_buf,
    void* proj_buf, void* dattn_buf, void* stats, void* rstd, void* partial, int B, int S, int D,
    int H, int L, int kv_len, float eps, void* stream_ptr) {
  using bf = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows = B * S;
  const bool self_attn = kv == nullptr;
  const int I = kHeadDim * H;
  const int n_in = self_attn ? 3 * I : I;
  const bf* ln_ = static_cast<const bf*>(ln);
  const bf* adaln_ = static_cast<const bf*>(adaln);
  const bf* w_in_ = static_cast<const bf*>(w_in);
  bf* h = static_cast<bf*>(h_buf);
  bf* a = static_cast<bf*>(a_buf);
  bf* proj = static_cast<bf*>(proj_buf);
  bf* dattn = static_cast<bf*>(dattn_buf);
  bf* dproj_ = static_cast<bf*>(dproj);
  float* rstd_ = static_cast<float*>(rstd);
  float* stats_ = static_cast<float*>(stats);
  if (!self_attn && (kv_len < 1 || kv_len > L)) return int(cudaErrorInvalidValue);

  // recompute a (and keep 1/rms), the projection, and dattn = g_out @ Wout
  cudaError_t err = launch_norm_rows(x, res, ln, adaln, h, a, rstd_, rows, S, D, eps, stream);
  if (err != cudaSuccess) return int(err);
  err = muse::sm90::gemm_tn(a, w_in_, muse::StoreBf16{proj, n_in}, rows, n_in, D, stream);
  if (err != cudaSuccess) return int(err);
  err = muse::sm90::gemm_nn(static_cast<const bf*>(g_out), static_cast<const bf*>(w_out),
                            muse::StoreBf16{dattn, I}, rows, I, D, stream);
  if (err != cudaSuccess) return int(err);

  // the attention backward: one block a (batch, head) pair on wgmma up to
  // 288 queries and 256 keys, the pair of mma.sync kernels above
  const AttnArgs args = attn_args(proj, static_cast<const bf*>(kv), S, I, L, kv_len);
  AttnBwdArgs bargs{};
  bargs.q = args.q;
  bargs.k = args.k;
  bargs.v = args.v;
  bargs.dout = dattn;
  bargs.out = static_cast<bf*>(attn_buf);
  bargs.dq = dproj_;
  bargs.dk = self_attn ? dproj_ + I : static_cast<bf*>(dkv);
  bargs.dv = bargs.dk + I;
  bargs.q_sb = args.q_bs;
  bargs.q_st = args.q_rs;
  bargs.kv_sb = args.kv_bs;  // dq / dk / dv lie as q / k / v do
  bargs.kv_st = args.kv_rs;
  bargs.o_sb = int64_t(S) * I;
  bargs.o_st = I;
  bargs.H = H;
  bargs.S = S;
  bargs.L = args.L;
  bargs.kv_len = args.kv_len;
  // dS's factor 1 / 8; over one key the softmax is the constant 1 and its
  // gradient 0 exactly (dP - D, from two sums of the same products, would
  // leave rounding there)
  bargs.scale = args.kv_len == 1 ? 0.f : args.scale;
  bargs.scale_log2 = args.scale * muse::frag::kLog2e;
  if (bwd::takes(S, args.L)) {
    err = bwd::launch(bargs, B, stream);
  } else {
    if (stats == nullptr) return int(cudaErrorInvalidValue);
    const int Sp = (S + kTile - 1) / kTile * kTile;
    const int64_t n_stats = int64_t(B) * H * Sp;
    bargs.stat_m = stats_;
    bargs.stat_il = stats_ + n_stats;
    bargs.delta = stats_ + 2 * n_stats;
    bargs.Sp = Sp;
    attn_bwd_q_kernel<<<dim3(Sp / kTile, B * H), kAttnThreads, 0, stream>>>(bargs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    attn_bwd_kv_kernel<<<dim3((args.L + kTile - 1) / kTile, B * H), kAttnThreads, 0, stream>>>(
        bargs);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return int(err);

  // da = dproj @ W_in (into the dattn buffer, consumed above, of max(D, I)
  // columns a row), then the
  // rmsnorm / AdaLN backward
  bf* da = dattn;
  err = muse::sm90::gemm_nn(static_cast<const bf*>(dproj_), w_in_, muse::StoreBf16{da, D}, rows, D,
                            n_in, stream);
  if (err != cudaSuccess) return int(err);
  if (D == 1024) {
    rms_adaln_bwd_rows_kernel<4><<<(rows + kRegRows - 1) / kRegRows, 32 * kRegRows, 0, stream>>>(
        reinterpret_cast<const uint4*>(h), reinterpret_cast<const uint4*>(da),
        static_cast<const uint4*>(ln), adaln_, static_cast<const uint4*>(g_res), rstd_,
        static_cast<uint4*>(dx), rows, S);
  } else {
    rms_adaln_bwd_row_kernel<<<rows, kRowThreads, 0, stream>>>(
        h, da, ln_, adaln_, static_cast<const bf*>(g_res), rstd_, static_cast<bf*>(dx), S, D);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int chunks = (S + kChunkRows - 1) / kChunkRows;
  const int col_blocks = (D + kRowThreads - 1) / kRowThreads;
  rms_adaln_bwd_col_kernel<<<dim3(col_blocks, chunks, B), kRowThreads, 0, stream>>>(
      h, da, ln_, adaln_, rstd_, static_cast<float*>(partial), S, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  rms_adaln_bwd_reduce_kernel<<<dim3(col_blocks, B + 1), kRowThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<bf*>(dadaln), static_cast<bf*>(dln), B, D,
      chunks);
  return int(cudaGetLastError());
}

// 1 where muse_attn_sublayer_bwd's attention takes the one-block wgmma kernel
// (S queries at most 288, L keys at most 256), 0 where it takes the mma.sync pair
// and needs the stats scratch
extern "C" int muse_attn_bwd_one_block(int S, int L) { return bwd::takes(S, L) ? 1 : 0; }
