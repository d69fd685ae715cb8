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
//   above (the 512px trunk's 1024 tokens), two wgmma kernels (a ninth
//   launch; namespace lng: a block per 128 query rows takes the row
//   statistics, the output, D and dQ in three passes over key tiles streamed
//   by TMA, a block per 128 keys dK and dV in one pass over query tiles, the
//   statistics through an fp32 scratch between them); the register row
//   kernel of dx and a two-stage column reduction of d(adaln) and d(ln).  The
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

// The attention backward's operands: S queries against the first kv_len of
// L keys, q / dq and k, v / dk, dv strided views of their projections.
struct AttnBwdArgs {
  const __nv_bfloat16* q;  // (B, S) rows of q, strides q_sb, q_st; dq alike
  const __nv_bfloat16* k;  // (B, L) rows of k and v, strides kv_sb, kv_st; dk, dv alike
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;  // (B, S, D)
  __nv_bfloat16* out;         // (B, S, D)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* stats;          // the long route's row statistics (namespace lng)
  int64_t q_sb, q_st;    // batch / token strides of q and dq (elements)
  int64_t kv_sb, kv_st;  // of k, v, dk and dv
  int64_t o_sb, o_st;    // of out and dout
  int H, S, L, kv_len;
  float scale_log2;  // 1 / sqrt(64) * log2(e)
  float scale;       // 1 / sqrt(64); 0 over one key
};

// The TMA maps of the attention backward's eight tensors (attn_sm90.cuh's
// 4-D head maps: 64-row boxes, zeros past S and kv_len on load, stores
// clipped at S and L)
struct BwdMaps {
  CUtensorMap q, k, v, dout, out, dq, dk, dv;
};

cudaError_t bwd_maps(BwdMaps* m, const AttnBwdArgs& p, int B) {
  using muse::attn::head_map;
  const int H = p.H, S = p.S;
  cudaError_t err = head_map(&m->q, p.q, B, S, H, kHeadDim, p.q_sb, p.q_st);
  if (err == cudaSuccess) err = head_map(&m->k, p.k, B, p.kv_len, H, kHeadDim, p.kv_sb, p.kv_st);
  if (err == cudaSuccess) err = head_map(&m->v, p.v, B, p.kv_len, H, kHeadDim, p.kv_sb, p.kv_st);
  if (err == cudaSuccess) err = head_map(&m->dout, p.dout, B, S, H, kHeadDim, p.o_sb, p.o_st);
  if (err == cudaSuccess) err = head_map(&m->out, p.out, B, S, H, kHeadDim, p.o_sb, p.o_st);
  if (err == cudaSuccess) err = head_map(&m->dq, p.dq, B, S, H, kHeadDim, p.q_sb, p.q_st);
  if (err == cudaSuccess) err = head_map(&m->dk, p.dk, B, p.L, H, kHeadDim, p.kv_sb, p.kv_st);
  if (err == cudaSuccess) err = head_map(&m->dv, p.dv, B, p.L, H, kHeadDim, p.kv_sb, p.kv_st);
  return err;
}

// ---------------------------------------------------------------------------
// Backward of the sublayers' attention, S <= 288 and L <= 256: one block a
// (batch, head) pair on warpgroup products
// ---------------------------------------------------------------------------
//
// What bounds it: bytes.  At x (16, 256, 1024) the self core reads q, k, v
// and dO and writes out, dq, dk and dv, 67.1 MB (20.0 us at 3.35 TB/s),
// against 12.9 GFLOP of six products (13.0 us at 989 TFLOP/s); the cross
// core over 77 keys moves 43.7 MB (13.0 us) for 3.9 GFLOP.  Two kernels
// (namespace lng, above 288 queries or 256 keys) would read K and V once per
// 128-query block and pass and Q and dO once per 128-key block, with the row
// statistics through device memory between them.
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
//   tile, as namespace lng takes it; then dP = dO V^T with dS = bf16(P
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

// whether this kernel takes (S, L); namespace lng takes the others
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
  BwdMaps m;
  const cudaError_t err = bwd_maps(&m, p, B);
  if (err != cudaSuccess) return err;
  auto kernel = attn_bwd_wgmma_kernel<kChunks>;
  static const cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (configured != cudaSuccess) return configured;
  const int grid = std::min(B * p.H, muse::sm90::sm_count());  // persistent: one block an SM
  kernel<<<grid, kThreads, Layout<kChunks>::of(p.S).bytes(), stream>>>(
      m.q, m.k, m.v, m.dout, m.out, m.dq, m.dk, m.dv, B, p.H, p.S, p.L, p.kv_len, p.scale_log2,
      p.scale);
  return cudaGetLastError();
}

// by the key capacity of L
cudaError_t launch(const AttnBwdArgs& p, int B, cudaStream_t stream) {
  return chunks_of(p.L) == 3 ? launch<3>(p, B, stream) : launch<8>(p, B, stream);
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// Backward of the sublayers' attention above 288 queries or 256 keys: two
// kernels on warpgroup products
// ---------------------------------------------------------------------------
//
// What bounds it: operations.  At the 512px trunk's x (8, 1024, 1024), 128
// (batch, head) pairs of 1024 queries and keys, the six products (S, O, dP,
// dV, dQ, dK) are 103.1 GFLOP (104.2 us at 989 TFLOP/s) against 134 MB of
// q, k, v, dO, out, dq, dk and dv (40.1 us at 3.35 TB/s).  A row of 1024
// fp32 logits does not fit beside 64 query rows, and the exact staging
// (P rounded to bf16 after the exact row sum) rules out an online softmax
// of an unnormalised O, so S is computed four times (three passes of the
// rows kernel, one of the columns kernel): ten products, and four
// exponentials a score on the MUFU (134 M at x (2, 1024, 1024): 32 us at 16
// a clock an SM).
//
// What the design does about it (namespace lng):
// - Two launches, each a block of two consumer warpgroups of 64 rows and a
//   producer warpgroup (its registers given to the consumers by
//   setmaxnreg) whose first thread issues every load by TMA (the 4-D head
//   maps: free batch and token strides, zeros past S and kv_len) into a
//   ring of kStages slots, full and empty mbarriers a slot, so loads run
//   ahead of the products and the two warpgroups need not keep step.
//   Every product is a wgmma with A from registers.
// - attn_bwd_rows_kernel, a block per 128 queries of a pair: its Q and dO
//   tiles loaded once (A fragments of S and dP), the pair's 64-key tiles
//   of K, then of K and V twice, streamed through the ring.  Pass 1: S and
//   each row's max and sum (per thread, the quad meeting once, as kernel
//   5's two-pass variant).  Pass 2: P = 2^(S c - max c) / sum rounded to
//   bf16, O += P V; D = rowsum(dO * O) from the fp32 O and the dO tile; O
//   stored by TMA through a swizzled tile; the rows' (max c, 1 / sum, D)
//   written to an fp32 scratch, rows past S as (0, 0, 0).  Pass 3: dP = dO
//   V^T, dS = bf16(P (dP - D) / 8), dQ += dS K, all of dQ summed in one
//   warpgroup's registers; dQ stored by TMA.  Keys past kv_len are masked
//   in pass 1 only: their K and V rows load as zeros, so their P and dS
//   multiply zeros in O, dP and dQ.  Up to 96 keys (the cross sublayer's
//   77 text keys) attn_bwd_rows_short_kernel takes its place: the pair's K
//   and V loaded once, S over the 96-key capacity in registers (computed
//   once, one exponential a score), two query tiles a warpgroup (x (8,
//   1024, 1024), kv 77: 60.3 -> 36.5 us on the card).
// - attn_bwd_cols_kernel, a block per 128 keys of a pair: its K and V tiles
//   loaded once (A fragments), then per 64 queries the Q and dO tiles and
//   their 768 bytes of statistics (one bulk copy) through the ring: S^T = K
//   Q^T and dP^T = V dO^T, P^T from the statistics, dV += bf16(P^T) dO and
//   dK += dS^T Q in registers, the next tile's S^T issued after them; dK
//   and dV stored by TMA, rows past kv_len as zeros.  Its two warpgroups
//   take turns (named barriers) to issue S^T and dP^T, so that one's
//   exponentials overlap the other's products (48 -> 36 us at x (2, 1024,
//   1024) on the card).  Where even twice its blocks fit the card in one
//   wave (cross at batch 2: 32 blocks), a block takes one key block and
//   its warpgroups share out the query tiles (`halves`), warpgroup 1's
//   sums added to warpgroup 0's in shared memory (18.0 -> 11.2 us with the
//   ring of 8 slots).
// - No atomics: dQ is summed over the keys inside one warpgroup and dK, dV
//   over the queries, each in a fixed order, so two calls are bit-equal.
// - Measured on the card and not kept (rows kernel at x (8, 1024, 1024),
//   PERF.md): the next item's products in flight while one item's
//   exponentials are taken (ptxas serialised every wgmma, C7515 / C7514:
//   +19 - 43%), turns as in the columns kernel, also with a step's products
//   in one group (+5 - 8%), a third consumer warpgroup (-5%, but +24% at x
//   (2, 1024, 1024)), S and dP with A from shared memory and a ring of 8
//   slots rather than 4 (within 1%; kept for `halves`).  Its products and
//   exponentials add up rather than overlap: ~40% of the tensor rate and
//   ~35% of the MUFU rate.  A columns kernel whose queries were split over
//   a cluster, the partial sums reduced in distributed shared memory, was
//   slower (cross at batch 2: 18.0 -> 23.3 us).
namespace lng {

using bwd::a_frag;
using bwd::to_tile;
using muse::attn::desc_at;
using muse::attn::fence_operands;
using muse::attn::fence_proxy_async;
using muse::attn::kBox;
using muse::attn::tile_a_frags;
using muse::attn::tma_box;
using muse::attn::tma_store_box;
using muse::attn::tma_store_drain;
using muse::attn::warpgroup_sync;
using muse::attn::wgmma_rs;
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

constexpr int kConsumers = 2;                    // warpgroups of 64 rows (queries, or keys)
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer's warpgroup
// registers a thread after setmaxnreg: the producer's go to the consumers
// (128 x 24 + 256 x 240 = 64512 of 65536; at the 168 of a launch of 384
// threads the columns kernel spilled)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 8;                       // ring slots
constexpr int kStatRows = 64;                    // a query tile's statistics:
constexpr int kStatFloats = 3 * kStatRows;       // max c, 1 / sum, D
constexpr int kStatBytes = kStatFloats * 4;

// shared memory, 1024-byte aligned: the rows kernel's ring of K and of V
// tiles, its warpgroups' Q, dO and output tiles, its mbarriers (full and
// empty a slot, a warpgroup's Q and dO)
constexpr int kRowsV = kStages * kBox;
constexpr int kRowsQ = 2 * kStages * kBox;
constexpr int kRowsDO = kRowsQ + kConsumers * kBox;
constexpr int kRowsOut = kRowsDO + kConsumers * kBox;
constexpr int kRowsBars = kRowsOut + kConsumers * kBox;
constexpr int kRowsSmem = 1024 + kRowsBars + (2 * kStages + kConsumers) * 8;
// the columns kernel's K and V tiles (its output tiles after), its ring of
// Q, dO and statistics, its mbarriers (full and empty a slot, K and V)
constexpr int kColsV = kConsumers * kBox;
constexpr int kColsQ = 2 * kConsumers * kBox;
constexpr int kColsDO = kColsQ + kStages * kBox;
constexpr int kColsStats = kColsDO + kStages * kBox;
constexpr int kColsBars = kColsStats + kStages * kStatBytes;
constexpr int kColsPart = kColsBars + 1024;  // with halves: warpgroup 1's fp32 dK and dV
constexpr int kColsSmem = 1024 + kColsPart + 2 * 64 * 64 * 4;
// the short-keys rows kernel's (kv_len <= kShortKeys): K's two boxes, V's,
// the block's kShortTiles query tiles of Q and of dO, a warpgroup's output
// tile, its mbarriers (K and V, a query tile's Q and dO)
constexpr int kShortKeys = 96;  // S over a capacity of 3 x 32 keys, in registers
constexpr int kShortTiles = 2 * kConsumers;  // query tiles a block: two a warpgroup
constexpr int kShortQ = 4 * kBox;
constexpr int kShortDO = kShortQ + kShortTiles * kBox;
constexpr int kShortOut = kShortDO + kShortTiles * kBox;
constexpr int kShortBars = kShortOut + kConsumers * kBox;
constexpr int kShortSmem = 1024 + kShortBars + (1 + kShortTiles) * 8;
static_assert(kRowsSmem <= 232448 && kColsSmem <= 232448 && kShortSmem <= 232448 &&
                  (2 * kStages + 1) * 8 <= kColsPart - kColsBars,
              "the SM's shared memory");

// `bytes` (a multiple of 16) from global to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// named barriers 3 and 4 (1 and 2 are warpgroup_sync's): the turn of
// consumer warpgroup 0 or 1 to issue its products, passed by the other
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 + wg), "n"(128 * kConsumers) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(3 + (1 - wg)), "n"(128 * kConsumers) : "memory");
}

// this thread's warpgroup (kConsumers: the producer's), broadcast so that
// ptxas sees it uniform (C7520), its registers set by setmaxnreg
__device__ __forceinline__ int warpgroup() {
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);
  if (wg == kConsumers)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  return wg;
}

__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_rows_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_o,
                     const __grid_constant__ CUtensorMap map_dq, float* __restrict__ stats, int H,
                     int S, int kv_len, float scale_log2, float scale) {
  extern __shared__ __align__(1024) unsigned char rows_smem[];
  unsigned char* smem = rows_smem + ((1024 - (smem_u32(rows_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRowsBars);
  uint64_t* empty = full + kStages;
  uint64_t* full_q = empty + kStages;
  const int pair = blockIdx.y, b = pair / H, h = pair % H;
  const int q_tiles = (S + 63) / 64, t0 = blockIdx.x * kConsumers;
  const int active = min(kConsumers, q_tiles - t0);  // warpgroups with a query tile
  const int kt = (kv_len + 63) / 64;                 // key tiles
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * active);
    }
    for (int c = 0; c < kConsumers; ++c) mbar_init(&full_q[c], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = warpgroup();
  if (wg == kConsumers) {  // the producer: Q and dO, then K; K and V; K and V (one thread)
    if (threadIdx.x == 128 * kConsumers) {
      for (int c = 0; c < active; ++c) {
        mbar_expect_tx(&full_q[c], 2 * kBox);
        tma_box(smem + kRowsQ + c * kBox, &map_q, &full_q[c], h, (t0 + c) * 64, b);
        tma_box(smem + kRowsDO + c * kBox, &map_do, &full_q[c], h, (t0 + c) * 64, b);
      }
      for (int n = 0; n < 3 * kt; ++n) {
        const int s = n % kStages, j = n % kt;
        if (n >= kStages) mbar_wait(&empty[s], uint32_t(n / kStages - 1) & 1);
        const bool with_v = n >= kt;
        mbar_expect_tx(&full[s], with_v ? 2 * kBox : kBox);
        tma_box(smem + s * kBox, &map_k, &full[s], h, j * 64, b);
        if (with_v) tma_box(smem + kRowsV + s * kBox, &map_v, &full[s], h, j * 64, b);
      }
    }
    return;
  }
  if (wg >= active) return;

  const int w4 = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r = w4 * 16 + g;  // this thread's rows r and r + 8 of the warpgroup's 64
  const bool leader = threadIdx.x % 128 == 0;
  const int t = t0 + wg;  // the query tile
  const unsigned char* dot = smem + kRowsDO + wg * kBox;
  unsigned char* tile = smem + kRowsOut + wg * kBox;
  const uint32_t k0 = smem_u32(smem), v0 = k0 + kRowsV;
  mbar_wait(&full_q[wg], 0);
  uint32_t qf[4][4];  // Q's A fragments
  tile_a_frags(qf, smem + kRowsQ + wg * kBox, r, t4);

  // S = Q K^T of ring item n (32 accumulators: s[4 c + e] is key 8 c + 2 t4
  // + (e & 1) of the tile, row r for e < 2, else r + 8), issued
  auto issue_scores = [&](float* s, int n) {
    const uint64_t kd = smem_desc(k0 + (n % kStages) * kBox);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(s, qf[kk], desc_at(kd, kk * 32), kk);
  };
  auto wait_item = [&](int n) { mbar_wait(&full[n % kStages], uint32_t(n / kStages) & 1); };
  auto release = [&](int n) { mbar_arrive(&empty[n % kStages]); };

  // pass 1: each row's max and sum of 2^(S c), per thread, trees over a tile
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
  int n = 0;
  for (int j = 0; j < kt; ++j, ++n) {
    float s[32];
    wait_item(n);
    wgmma_fence();
    issue_scores(s, n);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators<32>(s);
    release(n);
    if ((j + 1) * 64 > kv_len) {  // keys at or past kv_len: -inf
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (j * 64 + (e / 4) * 8 + t4 * 2 + (e & 1) >= kv_len) s[e] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) x[c] = fmaxf(s[4 * c + 2 * i], s[4 * c + 2 * i + 1]);
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
#pragma unroll
        for (int c = 0; c < w; ++c) x[c] = fmaxf(x[c], x[c + w]);
      const float m = fmaxf(mx[i], x[0]);
      const float base = m == -INFINITY ? 0.f : m * scale_log2;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        x[c] = ex2(fmaf(s[4 * c + 2 * i], scale_log2, -base)) +
               ex2(fmaf(s[4 * c + 2 * i + 1], scale_log2, -base));
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
#pragma unroll
        for (int c = 0; c < w; ++c) x[c] += x[c + w];
      sm[i] = sm[i] * ex2(fmaf(mx[i], scale_log2, -base)) + x[0];
      mx[i] = m;
    }
  }
  float base[2], inv[2];  // rows r and r + 8: finite, key 0 is never masked
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    base[i] = quad_max(mx[i]) * scale_log2;
    const float part = mx[i] == -INFINITY ? 0.f : sm[i] * ex2(fmaf(mx[i], scale_log2, -base[i]));
    inv[i] = __frcp_rn(quad_sum(part));
  }

  // pass 2: O = bf16(P) V in fp32 (keys past kv_len meet V's zero rows)
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int j = 0; j < kt; ++j, ++n) {
    float s[32];
    wait_item(n);
    wgmma_fence();
    issue_scores(s, n);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators<32>(s);
    uint32_t pa[4][4];  // P's A fragments, keys 16 c .. + 15
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = (e >> 1) & 1;  // elements 2, 3, 6, 7: row r + 8
        v[e] = ex2(fmaf(s[8 * c + e], scale_log2, -base[i])) * inv[i];
      }
      a_frag(pa[c], v);
    }
    const uint64_t vmn = smem_desc_mn(v0 + (n % kStages) * kBox);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) wgmma_rs<1>(acc, pa[c], desc_at(vmn, c * 2048), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators<32>(acc);
    fence_operands<16>(&pa[0][0]);
    release(n);
  }

  // D = rowsum(dO * O): dO's bf16 pairs at the places of O's accumulators
  // in the swizzled tile
  float d[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int at = ((c ^ (r & 7)) << 4) + 4 * t4;
    const float2 o0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dot + r * 128 + at));
    const float2 o1 =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dot + (r + 8) * 128 + at));
    d[0] += acc[4 * c] * o0.x + acc[4 * c + 1] * o0.y;
    d[1] += acc[4 * c + 2] * o1.x + acc[4 * c + 3] * o1.y;
  }
  d[0] = quad_sum(d[0]);
  d[1] = quad_sum(d[1]);
  if (t4 == 0) {  // the rows' statistics; rows past S (0, 0, 0): P = 0 in the columns kernel
    float* st = stats + (int64_t(pair) * q_tiles + t) * kStatFloats;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r + 8 * i;
      const bool ok = t * 64 + row < S;
      st[row] = ok ? base[i] : 0.f;
      st[kStatRows + row] = ok ? inv[i] : 0.f;
      st[2 * kStatRows + row] = ok ? d[i] : 0.f;
    }
  }
  to_tile(tile, acc, r, t4);  // out, through the warpgroup's tile
  fence_proxy_async();
  warpgroup_sync(wg);
  if (leader) tma_store_box(&map_o, tile, h, t * 64, b);
  uint32_t dof[4][4];  // dO's A fragments, for dP
  tile_a_frags(dof, dot, r, t4);

  // pass 3: dP = dO V^T, dS = bf16(P (dP - D) / 8), dQ += dS K
  float dq[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dq[e] = 0.f;
  for (int j = 0; j < kt; ++j, ++n) {
    float s[32], dp[32];
    wait_item(n);
    const uint32_t ks = k0 + (n % kStages) * kBox;
    const uint64_t vd = smem_desc(v0 + (n % kStages) * kBox);
    wgmma_fence();
    issue_scores(s, n);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<0>(dp, dof[kk], desc_at(vd, kk * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators<32>(s);
    fence_accumulators<32>(dp);
    uint32_t ds[4][4];  // dS's A fragments, keys 16 c .. + 15
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = (e >> 1) & 1;
        v[e] = (ex2(fmaf(s[8 * c + e], scale_log2, -base[i])) * inv[i]) * (dp[8 * c + e] - d[i]) *
               scale;
      }
      a_frag(ds[c], v);
    }
    const uint64_t kmn = smem_desc_mn(ks);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) wgmma_rs<1>(dq, ds[c], desc_at(kmn, c * 2048), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators<32>(dq);
    fence_operands<16>(&ds[0][0]);
    release(n);
  }
  fence_operands<16>(&dof[0][0]);
  fence_operands<16>(&qf[0][0]);
  if (leader) tma_store_drain();  // out has left the tile
  warpgroup_sync(wg);
  to_tile(tile, dq, r, t4);
  fence_proxy_async();
  warpgroup_sync(wg);
  if (leader) {
    tma_store_box(&map_dq, tile, h, t * 64, b);
    tma_store_drain();
  }
}

// The rows kernel's work over at most kShortKeys keys (the cross
// sublayer's 77 text keys): the pair's K and V loaded once, S held in
// registers over the key capacity, so S is computed once and each score
// takes one exponential (the ring kernel above computes S three times):
// the exact softmax, O = bf16(P) V, D, the statistics, dP = dO V^T, dS and
// dQ, every product one commit group, as the one-block kernel's phase A.
// A warpgroup takes two query tiles (t and t + 2 of the block's four), the
// second's Q and dO landing while the first is worked on.
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_rows_short_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const __grid_constant__ CUtensorMap map_o,
                           const __grid_constant__ CUtensorMap map_dq, float* __restrict__ stats,
                           int H, int S, int kv_len, float scale_log2, float scale) {
  using muse::attn::scores_step;
  constexpr int kS = 48;     // S's accumulators a thread: 3 chunks of 32 keys
  constexpr int kSteps = 6;  // 16-key steps of the capacity
  extern __shared__ __align__(1024) unsigned char short_smem[];
  unsigned char* smem = short_smem + ((1024 - (smem_u32(short_smem) & 1023)) & 1023);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + kShortBars);
  uint64_t* full_q = full_kv + 1;
  const int pair = blockIdx.y, b = pair / H, h = pair % H;
  const int q_tiles = (S + 63) / 64, t0 = blockIdx.x * kShortTiles;
  const int tiles = min(kShortTiles, q_tiles - t0);   // the block's query tiles
  const int active = min(kConsumers, tiles);          // warpgroups with a query tile
  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int c = 0; c < kShortTiles; ++c) mbar_init(&full_q[c], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = warpgroup();
  if (wg == kConsumers) {  // the producer: K and V (two boxes each), Q and dO (one thread)
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(full_kv, 4 * kBox);
      for (int j = 0; j < 2; ++j) {
        tma_box(smem + j * kBox, &map_k, full_kv, h, j * 64, b);
        tma_box(smem + (2 + j) * kBox, &map_v, full_kv, h, j * 64, b);
      }
      for (int c = 0; c < tiles; ++c) {
        mbar_expect_tx(&full_q[c], 2 * kBox);
        tma_box(smem + kShortQ + c * kBox, &map_q, &full_q[c], h, (t0 + c) * 64, b);
        tma_box(smem + kShortDO + c * kBox, &map_do, &full_q[c], h, (t0 + c) * 64, b);
      }
    }
    return;
  }
  if (wg >= active) return;

  const int w4 = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r = w4 * 16 + g;  // this thread's rows r and r + 8 of the warpgroup's 64
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* tile = smem + kShortOut + wg * kBox;
  const uint32_t ks = smem_u32(smem), vs = ks + 2 * kBox;
  mbar_wait(full_kv, 0);
  for (int c = wg; c < tiles; c += kConsumers) {  // the warpgroup's query tiles
    const int t = t0 + c;
    const unsigned char* dot = smem + kShortDO + c * kBox;
    mbar_wait(&full_q[c], 0);

    // S = Q K^T over the capacity (sc[4 n + e]: key 8 n + 2 t4 + (e & 1) of
    // row r for e < 2, else r + 8), the exact softmax kept as the
    // exponentials and each row's 1 / sum
    float sc[kS];
#pragma unroll
    for (int e = 0; e < kS; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) scores_step<3>(sc, smem_u32(smem + kShortQ + c * kBox), ks, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators<kS>(sc);
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kS / 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * n + 2 * t4 + (e & 1) >= kv_len) sc[4 * n + e] = -INFINITY;  // keys past kv_len
      m[0] = fmaxf(m[0], fmaxf(sc[4 * n], sc[4 * n + 1]));
      m[1] = fmaxf(m[1], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    float base[2], inv[2], l[2] = {0.f, 0.f};  // finite: key 0 is never masked
#pragma unroll
    for (int i = 0; i < 2; ++i) base[i] = quad_max(m[i]) * scale_log2;
#pragma unroll
    for (int n = 0; n < kS / 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        sc[4 * n + e] = ex2(fmaf(sc[4 * n + e], scale_log2, -base[i]));
        l[i] += sc[4 * n + e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) inv[i] = __frcp_rn(quad_sum(l[i]));

    // O = bf16(P) V in fp32, V MN-major over its two boxes (16-key step j at
    // 2048 j bytes)
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    {
      uint32_t pa[kSteps][4];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = sc[8 * j + e] * inv[(e >> 1) & 1];
        a_frag(pa[j], v);
      }
      const uint64_t vmn = smem_desc_mn(vs);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j) wgmma_rs<1>(acc, pa[j], desc_at(vmn, j * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands<kSteps * 4>(&pa[0][0]);
    }
    fence_accumulators<32>(acc);

    // D = rowsum(dO * O) from the fp32 O and the dO tile; the statistics
    float d[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int at = ((c ^ (r & 7)) << 4) + 4 * t4;
      const float2 o0 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dot + r * 128 + at));
      const float2 o1 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dot + (r + 8) * 128 + at));
      d[0] += acc[4 * c] * o0.x + acc[4 * c + 1] * o0.y;
      d[1] += acc[4 * c + 2] * o1.x + acc[4 * c + 3] * o1.y;
    }
    d[0] = quad_sum(d[0]);
    d[1] = quad_sum(d[1]);
    if (t4 == 0) {  // rows past S (0, 0, 0): P = 0 in the columns kernel
      float* st = stats + (int64_t(pair) * q_tiles + t) * kStatFloats;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r + 8 * i;
        const bool ok = t * 64 + row < S;
        st[row] = ok ? base[i] : 0.f;
        st[kStatRows + row] = ok ? inv[i] : 0.f;
        st[2 * kStatRows + row] = ok ? d[i] : 0.f;
      }
    }
    if (leader) tma_store_drain();  // the last tile's dq has left the tile
    warpgroup_sync(wg);
    to_tile(tile, acc, r, t4);  // out, through the warpgroup's tile
    fence_proxy_async();
    warpgroup_sync(wg);
    if (leader) tma_store_box(&map_o, tile, h, t * 64, b);

    // dP = dO V^T over the capacity, dS = bf16(P (dP - D) / 8), dQ = dS K
    float dp[kS];
#pragma unroll
    for (int e = 0; e < kS; ++e) dp[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) scores_step<3>(dp, smem_u32(dot), vs, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators<kS>(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;  // dQ, O having left for the tile
    {
      uint32_t ds[kSteps][4];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = (e >> 1) & 1;
          v[e] = (sc[8 * j + e] * inv[i]) * (dp[8 * j + e] - d[i]) * scale;
        }
        a_frag(ds[j], v);
      }
      const uint64_t kmn = smem_desc_mn(ks);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j) wgmma_rs<1>(acc, ds[j], desc_at(kmn, j * 2048), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands<kSteps * 4>(&ds[0][0]);
    }
    fence_accumulators<32>(acc);
    if (leader) tma_store_drain();  // out has left the tile
    warpgroup_sync(wg);
    to_tile(tile, acc, r, t4);
    fence_proxy_async();
    warpgroup_sync(wg);
    if (leader) tma_store_box(&map_dq, tile, h, t * 64, b);
  }
  if (leader) tma_store_drain();
}

__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_cols_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_dk,
                     const __grid_constant__ CUtensorMap map_dv, const float* __restrict__ stats,
                     int H, int S, int L, int kv_len, int halves, float scale_log2, float scale) {
  extern __shared__ __align__(1024) unsigned char cols_smem[];
  unsigned char* smem = cols_smem + ((1024 - (smem_u32(cols_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kColsBars);
  uint64_t* empty = full + kStages;
  uint64_t* full_kv = empty + kStages;
  const int pair = blockIdx.y, b = pair / H, h = pair % H;
  // a key block a warpgroup, or with `halves` (below a card's worth of
  // blocks) one key block a block, its query tiles shared out between the
  // warpgroups (even and odd) and their sums added in shared memory
  const int q_tiles = (S + 63) / 64, kb0 = halves ? blockIdx.x : blockIdx.x * kConsumers;
  const int key_blocks = halves ? 1 : min(kConsumers, (L + 63) / 64 - kb0);
  const int active = halves ? min(kConsumers, q_tiles) : key_blocks;  // working warpgroups
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], halves ? 128 : 128 * active);
    }
    mbar_init(full_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = warpgroup();
  if (wg == kConsumers) {  // the producer: K and V, then Q, dO and statistics a query tile
                           // (one thread)
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(full_kv, 2 * key_blocks * kBox);
      for (int c = 0; c < key_blocks; ++c) {
        tma_box(smem + c * kBox, &map_k, full_kv, h, (kb0 + c) * 64, b);
        tma_box(smem + kColsV + c * kBox, &map_v, full_kv, h, (kb0 + c) * 64, b);
      }
      const float* src = stats + int64_t(pair) * q_tiles * kStatFloats;
      for (int n = 0; n < q_tiles; ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(&empty[s], uint32_t(n / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kBox + kStatBytes);
        tma_box(smem + kColsQ + s * kBox, &map_q, &full[s], h, n * 64, b);
        tma_box(smem + kColsDO + s * kBox, &map_do, &full[s], h, n * 64, b);
        bulk_copy(smem + kColsStats + s * kStatBytes, src + n * kStatFloats, kStatBytes, &full[s]);
      }
    }
    return;
  }
  if (wg >= active) return;

  const int w4 = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r = w4 * 16 + g;  // this thread's keys r and r + 8 of the warpgroup's 64
  const bool leader = threadIdx.x % 128 == 0;
  const int kb = halves ? kb0 : kb0 + wg;  // the key block
  unsigned char* kt = smem + (halves ? 0 : wg) * kBox;
  unsigned char* vt = smem + kColsV + (halves ? 0 : wg) * kBox;
  const int first = halves ? wg : 0, step = halves ? kConsumers : 1;  // the query tiles taken
  mbar_wait(full_kv, 0);
  uint32_t kf[4][4], vf[4][4];  // K's and V's A fragments
  tile_a_frags(kf, kt, r, t4);
  tile_a_frags(vf, vt, r, t4);
  float dv[32], dk[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dv[e] = dk[e] = 0.f;
  uint32_t pt[4][4], dt[4][4];  // the last query tile's A fragments of P^T and dS^T
  // the two warpgroups take turns to issue S^T and dP^T, warpgroup 0 first,
  // so that one's exponentials overlap the other's products (with halves
  // their counts of tiles may differ: no turns)
  const bool turns = active == kConsumers && !halves;
  if (turns && wg == 1) turn_pass(wg);
  for (int n = first; n < q_tiles; n += step) {
    const int slot = n % kStages;
    float st[32], dpt[32];  // st[4 c + e]: query 64 n + 8 c + 2 t4 + (e & 1), key row r / r + 8
    const uint32_t qc = smem_u32(smem + kColsQ + slot * kBox);
    const uint32_t dc = smem_u32(smem + kColsDO + slot * kBox);
    const uint64_t qk = smem_desc(qc), dok = smem_desc(dc);
    mbar_wait(&full[slot], uint32_t(n / kStages) & 1);
    if (turns) turn_wait(wg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<0>(st, kf[kk], desc_at(qk, kk * 32), kk);
      wgmma_rs<0>(dpt, vf[kk], desc_at(dok, kk * 32), kk);
    }
    wgmma_commit();
    if (turns && !(wg == 1 && n == q_tiles - 1)) turn_pass(wg);  // every turn taken
    wgmma_wait<0>();  // also the last query tile's dV and dK products
    fence_accumulators<32>(st);
    fence_accumulators<32>(dpt);
    fence_operands<16>(&pt[0][0]);
    fence_operands<16>(&dt[0][0]);
    const float* sm = reinterpret_cast<const float*>(smem + kColsStats + slot * kStatBytes);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int q = 8 * c + 2 * t4;
      const float2 m = *reinterpret_cast<const float2*>(sm + q);
      const float2 il = *reinterpret_cast<const float2*>(sm + kStatRows + q);
      const float2 dd = *reinterpret_cast<const float2*>(sm + 2 * kStatRows + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const float pv =
            ex2(fmaf(st[4 * c + e], scale_log2, -(odd ? m.y : m.x))) * (odd ? il.y : il.x);
        dpt[4 * c + e] = pv * (dpt[4 * c + e] - (odd ? dd.y : dd.x)) * scale;
        st[4 * c + e] = pv;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a_frag(pt[j], st + 8 * j);
      a_frag(dt[j], dpt + 8 * j);
    }
    const uint64_t dmn = smem_desc_mn(dc), qmn = smem_desc_mn(qc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs<1>(dv, pt[j], desc_at(dmn, j * 2048), 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_rs<1>(dk, dt[j], desc_at(qmn, j * 2048), 1);
    wgmma_commit();
    // the last tile's slot, read by products the wait above saw done, goes
    // back to the producer only now: released between that wait and these
    // products, the card gave wrong dK and dV past the first query tile
    // (with the ring's slots in order from 0; the cause was not found)
    if (n > first) mbar_arrive(&empty[(n - step) % kStages]);
  }
  wgmma_wait<0>();
  fence_operands<16>(&pt[0][0]);
  fence_operands<16>(&dt[0][0]);
  fence_operands<16>(&kf[0][0]);
  fence_operands<16>(&vf[0][0]);
  fence_accumulators<32>(dv);
  fence_accumulators<32>(dk);
  if (halves && active > 1) {  // warpgroup 1's sums into warpgroup 0's, in that order
    float* part = reinterpret_cast<float*>(smem + kColsPart);  // [dK, dV][64 x 64]
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int at = (r + 8 * ((e >> 1) & 1)) * 64 + 8 * (e / 4) + 2 * t4 + (e & 1);
        part[at] = dk[e];
        part[64 * 64 + at] = dv[e];
      }
    }
    asm volatile("bar.sync 5, %0;\n" ::"n"(128 * kConsumers) : "memory");
    if (wg == 1) return;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int at = (r + 8 * ((e >> 1) & 1)) * 64 + 8 * (e / 4) + 2 * t4 + (e & 1);
      dk[e] += part[at];
      dv[e] += part[64 * 64 + at];
    }
  }
  // dk and dv through the K and V tiles (read into registers at the start);
  // keys past kv_len as zero rows (their P^T, from zero K rows, is not 0)
  const int key = kb * 64 + r;
  to_tile(kt, dk, r, t4, key < kv_len, key + 8 < kv_len);
  to_tile(vt, dv, r, t4, key < kv_len, key + 8 < kv_len);
  fence_proxy_async();
  warpgroup_sync(wg);
  if (leader) {
    tma_store_box(&map_dk, kt, h, kb * 64, b);
    tma_store_box(&map_dv, vt, h, kb * 64, b);
    tma_store_drain();
  }
}

cudaError_t launch(const AttnBwdArgs& p, int B, cudaStream_t stream) {
  if (p.stats == nullptr) return cudaErrorInvalidValue;
  BwdMaps m;
  cudaError_t err = bwd_maps(&m, p, B);
  if (err != cudaSuccess) return err;
  static const cudaError_t configured = [] {
    const auto smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaError_t e = cudaFuncSetAttribute(attn_bwd_rows_kernel, smem, kRowsSmem);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(attn_bwd_rows_short_kernel, smem, kShortSmem);
    return e == cudaSuccess ? cudaFuncSetAttribute(attn_bwd_cols_kernel, smem, kColsSmem) : e;
  }();
  if (configured != cudaSuccess) return configured;
  const int q_tiles = (p.S + 63) / 64, k_blocks = (p.L + 63) / 64;
  // halves where the doubled grid still fits the card in one wave (the
  // cross sublayer's one block a pair at batch 2: 32 blocks; at 128 blocks
  // it ran 21.5 -> 35.2 us at x (8, 1024, 1024) on the card)
  const int halves =
      2 * ((k_blocks + kConsumers - 1) / kConsumers) * B * p.H <= muse::sm90::sm_count();
  const dim3 rows_grid((q_tiles + kConsumers - 1) / kConsumers, B * p.H);
  if (p.kv_len <= kShortKeys) {
    const dim3 short_grid((q_tiles + kShortTiles - 1) / kShortTiles, B * p.H);
    attn_bwd_rows_short_kernel<<<short_grid, kThreads, kShortSmem, stream>>>(
        m.q, m.k, m.v, m.dout, m.out, m.dq, p.stats, p.H, p.S, p.kv_len, p.scale_log2, p.scale);
  } else {
    attn_bwd_rows_kernel<<<rows_grid, kThreads, kRowsSmem, stream>>>(
        m.q, m.k, m.v, m.dout, m.out, m.dq, p.stats, p.H, p.S, p.kv_len, p.scale_log2, p.scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 cols_grid(halves ? k_blocks : (k_blocks + kConsumers - 1) / kConsumers, B * p.H);
  attn_bwd_cols_kernel<<<cols_grid, kThreads, kColsSmem, stream>>>(
      m.q, m.k, m.v, m.dout, m.dk, m.dv, p.stats, p.H, p.S, p.L, p.kv_len, halves, p.scale_log2,
      p.scale);
  return cudaGetLastError();
}

}  // namespace lng

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
// where muse_attn_bwd_one_block(S, L) is 0, stats (B, H, ceil(S / 64), 3,
// 64) fp32 (lng::kStatFloats a query tile; else it may be null).  On a head shard (I < D) dx, dln and dadaln
// are this shard's part of the gradients; the caller sums them over the
// shards.  Self (kernel 11) and cross (kernel 12) run one chain of eight
// launches: the row kernel (keeping 1/rms; the register one at width 1024),
// the in-projection (qkv or q) and dattn = g_out @ Wout on the Hopper GEMM
// (Wout read MN-major), the attention backward (one block a (batch, head)
// pair on wgmma up to 288 queries and 256 keys; above, the rows and columns
// kernels of namespace lng, a ninth launch), da = dproj @ W_in on the Hopper GEMM (W_in read
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
  // 288 queries and 256 keys, the rows and columns kernels above
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
  bargs.stats = static_cast<float*>(stats);
  err = bwd::takes(S, args.L) ? bwd::launch(bargs, B, stream) : lng::launch(bargs, B, stream);
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
// (S queries at most 288, L keys at most 256), 0 where it takes the rows and
// columns kernels (namespace lng) and needs the stats scratch
extern "C" int muse_attn_bwd_one_block(int S, int L) { return bwd::takes(S, L) ? 1 : 0; }
