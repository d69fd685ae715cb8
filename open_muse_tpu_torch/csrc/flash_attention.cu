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
// place (the one-pass wgmma kernel reads a pair's K and V once, as the
// grouping did).  The exact staging rules out online-softmax rescaling of an
// unnormalised PV: P is rounded to bf16 only after the exact row sum is known.
//
// What bounds it on the H100: bytes at the trainers', eval's and the
// distillation teacher's batches (16 - 128 rows of 16 heads: q, k, v read
// and o written once are 10 - 80 us at 3.35 TB/s, the two products 3 - 26
// us at 989 TFLOP/s, the exponentials 2 - 16 us on the MUFU at 16 a clock
// an SM); latency when serving at batch 1 - 2 (1.6 MB at v1's (1, 257, 16,
// 48): 0.5 us): how many dependent memory round trips a block waits on, how
// long one warp's chain of products, exponentials and shuffles is, and how
// many SMs hold a block at all.  Variant rule, on Tk, D, the (batch, head)
// pairs B H and Tq before the launch (kernels/flash_attention.py `variant`
// mirrors it):
//
//  * Tk <= 288, D 48 / 64, and the pairs fill the card (`op::cluster_for`
//    is 1: more than SMs / 2 pairs, or no row tiles to share), or D 64 over
//    more than 96 keys: one pass on warpgroup products (namespace op).
//    Bytes are the bound, so K and V are read once per (batch, head) pair:
//    a persistent block (one an SM) walks over pairs and holds two pairs' K
//    and V in shared memory, loaded by TMA (a 4-D tensor map (D, H, T, B) with the batch and
//    token strides free, 64-key boxes in the 128-byte swizzle, zeros past D
//    and Tk) while two or three consumer warpgroups of 64 query rows work
//    on the pair before; when the pairs do not fill the card (serving's 24 -
//    32), the blocks that share a pair's row tiles form a cluster and each
//    loads a share of K and V, multicast into every block of it.  A
//    producer warpgroup issues every load (K, V and each task's Q tile, on
//    mbarriers; setmaxnreg gives its registers to the consumers), so loads
//    overlap math.  A consumer warpgroup runs S = Q K^T on wgmma with Q and
//    K from shared memory (n256 + n32 at 257 - 288 keys, two n128 at 97 -
//    256, n64 + n32 at 33 - 96, n32 below: the capacity is a template
//    argument, no product is skipped at run time), keeps S in registers
//    (up to 144 floats a thread), takes the exact softmax by its warps' rows
//    (exp as ex2.approx with log2(e) folded into the scale, one IEEE
//    reciprocal a row), runs P V on wgmma with P's bf16 fragments in
//    registers as A and V as an MN-major B (the transpose flag; D 48 reads
//    the box's zero columns 48 .. 63 too), and stores O through a swizzled
//    tile by one TMA store.  Tq = 257's last row tile is one more task of a
//    warpgroup (no block of its own); its warps past Tq take no
//    exponential.  The swizzle is 128 bytes at D 48 too: the box is 64
//    columns wide, one swizzle row, and the map's zeros fill 48 .. 63.
//  * Tk <= 288 otherwise (D 16 / 32: the eval stacks' seeded towers and
//    trunks; D 48 and the 77 text keys at few pairs: v1 and v2 serving),
//    where the mma.sync kernel's small blocks were faster on the card: one
//    pass on mma.sync.  A block holds 4 groups of 16 query rows (64 rows) of
//    one pair and copies all of its K and V, rounded up to 16 keys and
//    zero-filled, into dynamic shared memory by cp.async, K as one commit
//    group and V as a second, while the Q fragments load straight into
//    registers; it waits once for K, computes S once (m16n8k16, K fragments
//    by ldmatrix) and keeps it in registers, takes the row max, exp and sum
//    while V is still arriving, then forms P = exp * (1 / sum) rounded to
//    bf16 and P V (V fragments by ldmatrix.trans on row-major V).  Up to 80
//    keys one warp a group covers every key (S 40 floats a thread); above,
//    two warps a group each take half of the 16-key chunks (at most 9), the
//    halves' row maxima and sums meeting in shared memory (sums added in
//    warp order) and the second warp's partial P V added to the first's
//    before the store.
//  * Tk > 288 (the 1024-token v1 trunks of the MOVQ configs: 1025 keys
//    with the class token, 1024 without; the 512px v2 trunk's 1024 inside
//    kernel 9): two passes over 64-key tiles.  A row of 1024 fp32 logits
//    does not fit beside 64+ query rows on the card, so the exact staging
//    is kept by computing S twice: pass 1 streams K and takes each row's
//    max and sum of exponentials (online, per thread, the row's four
//    threads meeting once at the end), pass 2 streams K and V, recomputes
//    S, forms P = 2^(S' - max') / sum rounded to bf16 and accumulates P V.
//    What bounds it: three products (12.9 GFLOP at (2, 1024, 16, 64): 13 us
//    at 989 TFLOP/s) and two exponentials a score (67 M: 16 us on the MUFU
//    at 16 a clock an SM), where the PV-and-QK^T bound the report counts is
//    8.7 us.  What the design does about it: K and V tiles go through
//    rings of three slots in shared memory by cp.async, one commit group a
//    tile, so two tiles are in flight while one is read; exp is ex2.approx
//    with the scale and log2(e) folded into one FMA and one IEEE reciprocal
//    a row; the tile's max and sum are trees.  At D 64 (every path) two
//    warpgroups of 64 query rows (128 a block) run wgmma: S with Q's
//    fragments in registers as A and the K tile as a K-major B, P V with
//    P's fragments (S's accumulators rounded, whose layout is an A
//    fragment's) as A and the V tile, row-major, as an MN-major B through
//    wgmma's transpose flag; the tiles are written in the layout of TMA's
//    128-byte swizzle.  At D 16 / 32 / 48 four warps of 16 rows run
//    mma.sync with ldmatrix / ldmatrix.trans fragments.
//
// All count as one launch of the wrapper; the wrapper counts the two-pass
// variant apart too.  Query rows, keys and the batch /
// token strides are free: q, k and v may be views into a fused projection
// (token stride 3 H D for a packed [q | k | v]), with no padding and no copy.
// No atomics: two calls are bit-equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "attn_sm90.cuh"
#include "gemm_sm90.cuh"
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
// two passes over streamed key tiles on mma.sync: Tk > kMaxKeys, D 16 / 32 / 48

constexpr int kTileKeys = 64;  // keys a tile
constexpr int kStages = 3;     // ring slots: two tiles in flight while one is read

template <int D>
__host__ __device__ constexpr int tile_elems() { return kTileKeys * one_pass_row<D>(); }

// dynamic shared memory: a ring of kStages K tiles, then one of V tiles
template <int D>
size_t two_pass_smem() { return 2 * size_t(kStages) * tile_elems<D>() * sizeof(T); }

// A block holds kWarps groups of 16 query rows of one (batch, head) pair,
// one warp a group, and streams K (pass 1) and K and V (pass 2) through the
// rings by cp.async, one commit group a tile: tile j is waited for while
// tiles j + 1 .. j + kStages - 1 are still arriving.  One __syncthreads a
// tile, after which the slot read one tile ago is refilled.  Four warps (64
// rows) a block: on the card, 8 warps were 0 - 25% slower at every shape
// but (2, 1024, 16, 64), 7% faster there (since taken by wgmma).
constexpr int kWarps = 4;

template <int D>
__global__ void __launch_bounds__(32 * kWarps, 16 / kWarps)
two_pass_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, int H, int Tq, int Tk, int64_t q_sb, int64_t q_st,
                int64_t k_sb, int64_t k_st, int64_t v_sb, int64_t v_st, float scale_log2) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int kThreads = 32 * kWarps;
  constexpr int kRow = one_pass_row<D>();
  constexpr int kDChunks = D / 8;
  constexpr int kTile = tile_elems<D>();
  constexpr int kN = kTileKeys / 8;  // m16n8 C fragments of S a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kStages * kTile;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const T* kb = k + b * k_sb + int64_t(h) * D;
  const T* vb = v + b * v_sb + int64_t(h) * D;
  const int tiles = (Tk + kTileKeys - 1) / kTileKeys;

  // tile j of K or V into ring slot j % kStages, keys past Tk zero-filled
  auto load_tile = [&](const T* src, int64_t st, T* ring, int j) {
    T* dst = ring + (j % kStages) * kTile;
    const int j0 = j * kTileKeys;
#pragma unroll
    for (int idx = threadIdx.x; idx < kTileKeys * kDChunks; idx += kThreads) {
      const int r = idx / kDChunks, c = (idx % kDChunks) * 8;
      const bool in = j0 + r < Tk;
      cp_async16(dst + r * kRow + c, in ? src + (j0 + r) * st + c : src, in ? 16 : 0);
    }
  };
  // the first kStages - 1 tiles of a pass, one commit group each (empty
  // past the last tile, so that every wait below counts alike)
  auto prologue = [&](bool with_v) {
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < tiles) {
        load_tile(kb, k_st, Ks, j);
        if (with_v) load_tile(vb, v_st, Vs, j);
      }
      cp_async_commit();
    }
  };
  // wait for tile j, then refill the slot every warp finished reading
  auto next_tile = [&](int j, bool with_v) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < tiles) {
      load_tile(kb, k_st, Ks, j + kStages - 1);
      if (with_v) load_tile(vb, v_st, Vs, j + kStages - 1);
    }
    cp_async_commit();
  };

  prologue(false);  // K in flight while Q loads into registers
  const int r0 = blockIdx.x * (kWarps * kRowsPerWarp) + warp * kRowsPerWarp + g;
  uint32_t qf[D / 16][4];
  load_a<D>(qf, q + b * q_sb + int64_t(h) * D, q_st, r0, Tq, t4);

  // S of the warp's 16 rows and tile j's keys, unscaled, laid out as in the
  // one-pass kernel (s[n]: keys j * 64 + n * 8 ..; elements 0, 1 row g, 2, 3
  // row g + 8); keys past Tk -inf
  float s[kN][4];
  const T* kl = Ks + ((lane & 7) + ((lane >> 4) << 3)) * kRow + (((lane >> 3) & 1) << 3);
  auto scores = [&](int j) {
    const T* kt = kl + (j % kStages) * kTile;
#pragma unroll
    for (int n = 0; n < kN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int c = 0; c < kTileKeys / 16; ++c) {
        uint32_t bf[4];  // (b0, b1) of keys c * 16 .. + 7, then of + 8 .. + 15
        ldmatrix_x4(bf, kt + c * 16 * kRow + kc * 16);
        mma16816(s[2 * c], qf[kc], bf);
        mma16816(s[2 * c + 1], qf[kc], bf + 2);
      }
    }
    if ((j + 1) * kTileKeys > Tk) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * kTileKeys + n * 8 + t4 * 2 + (e & 1) >= Tk) s[n][e] = -INFINITY;
    }
  };

  // pass 1: this thread's running max of its own columns (unscaled) and sum
  // of 2^(S c - max c), c = log2(e) / sqrt(D): exp(S / sqrt(D) - max), with
  // no shuffle a tile; the row's four threads meet once, after the last
  // tile.  The tile's max and sum are trees over its 16 columns of the row,
  // not chains of 16 dependent operations.
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
  for (int j = 0; j < tiles; ++j) {
    next_tile(j, false);
    scores(j);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t[kN];
#pragma unroll
      for (int n = 0; n < kN; ++n) t[n] = fmaxf(s[n][2 * r], s[n][2 * r + 1]);
#pragma unroll
      for (int w = kN / 2; w > 0; w /= 2)
#pragma unroll
        for (int n = 0; n < w; ++n) t[n] = fmaxf(t[n], t[n + w]);
      const float m = fmaxf(mx[r], t[0]);
      const float base = m == -INFINITY ? 0.f : m * scale_log2;
#pragma unroll
      for (int n = 0; n < kN; ++n)
        t[n] = ex2(fmaf(s[n][2 * r], scale_log2, -base)) +
               ex2(fmaf(s[n][2 * r + 1], scale_log2, -base));
#pragma unroll
      for (int w = kN / 2; w > 0; w /= 2)
#pragma unroll
        for (int n = 0; n < w; ++n) t[n] += t[n + w];
      sm[r] = sm[r] * ex2(fmaf(mx[r], scale_log2, -base)) + t[0];  // 2^-inf = 0 on the first
      mx[r] = m;
    }
  }
  // the row's max over its four threads (finite: key 0 is never masked) and
  // its exact sum; one IEEE reciprocal a row
  float base[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    base[r] = quad_max(mx[r]) * scale_log2;
    const float part = mx[r] == -INFINITY ? 0.f : sm[r] * ex2(fmaf(mx[r], scale_log2, -base[r]));
    inv[r] = __frcp_rn(quad_sum(part));
  }

  // pass 2: P = 2^(S c - max c) / sum rounded to bf16, O += P V in fp32
  __syncthreads();  // every warp is done with pass 1's slots
  prologue(true);
  float acc[kDChunks][4];
#pragma unroll
  for (int n = 0; n < kDChunks; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // ldmatrix.trans row of lane: keys (lane & 7) + 8 ((lane >> 3) & 1), d 8 (lane >> 4)
  const T* vl = Vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRow + ((lane >> 4) << 3);
  for (int j = 0; j < tiles; ++j) {
    next_tile(j, true);
    scores(j);
    const T* vt = vl + (j % kStages) * kTile;
#pragma unroll
    for (int c = 0; c < kTileKeys / 16; ++c) {
      uint32_t pa[4];  // the A fragment of P for keys c * 16 .. + 15
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float* sn = s[2 * c + hi];
        pa[2 * hi] = pack2(ex2(fmaf(sn[0], scale_log2, -base[0])) * inv[0],
                           ex2(fmaf(sn[1], scale_log2, -base[0])) * inv[0]);
        pa[2 * hi + 1] = pack2(ex2(fmaf(sn[2], scale_log2, -base[1])) * inv[1],
                               ex2(fmaf(sn[3], scale_log2, -base[1])) * inv[1]);
      }
#pragma unroll
      for (int n = 0; n < kDChunks; n += 2) {  // (b0, b1) of d n*8 .. +7, then of n*8+8 .. +15
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt + c * 16 * kRow + n * 8);
        mma16816(acc[n], pa, bf);
        mma16816(acc[n + 1], pa, bf + 2);
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

template <int D>
int launch_two_pass(const T* q, const T* k, const T* v, T* o, int B, int H, int Tq, int Tk,
                    const int64_t* s, float scale, cudaStream_t stream) {
  auto kernel = two_pass_kernel<D>;
  const size_t smem = two_pass_smem<D>();
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return int(attr);
  constexpr int rows = kWarps * kRowsPerWarp;
  const dim3 grid((Tq + rows - 1) / rows, B * H);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(q, k, v, o, H, Tq, Tk, s[0], s[1], s[2], s[3], s[4],
                                              s[5], scale * kLog2e);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// two passes on warpgroup products: Tk > kMaxKeys, D 64

namespace wg {

using muse::attn::fence_proxy_async;
using muse::attn::wgmma_rs;
using muse::sm90::fence_accumulators;
using muse::sm90::smem_desc;
using muse::sm90::smem_desc_mn;
using muse::sm90::smem_u32;
using muse::sm90::wgmma_commit;
using muse::sm90::wgmma_fence;
using muse::sm90::wgmma_wait;

constexpr int kRows = 128;          // query rows a block: two warpgroups of 64
constexpr int kThreads = 256;
constexpr int kTileBytes = 64 * 128;  // 64 keys x 64 d of bf16, rows of 128 bytes
constexpr int kSmem = 1024 + kStages * 2 * kTileBytes;

// A block holds two warpgroups of 64 query rows of one (batch, head) pair.
// K and V tiles of 64 keys go through rings of kStages slots by cp.async
// into the layout TMA's 128-byte swizzle would give (16-byte chunk c of row
// r at chunk c ^ (r % 8)), so wgmma reads a K tile as a K-major B (S = Q
// K^T, Q's fragments in registers as A) and a V tile as an MN-major B (P V,
// P's fragments in registers as A, rounded from S's accumulators, whose
// layout is an A fragment's).  The accumulators of S and of O are each 32
// floats a thread; element 4 n + e is the one-pass kernel's s[n][e].
__global__ void __launch_bounds__(kThreads, 1)
two_pass_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, int H, int Tq, int Tk, int64_t q_sb, int64_t q_st,
                      int64_t k_sb, int64_t k_st, int64_t v_sb, int64_t v_st,
                      float scale_log2) {
  constexpr int D = 64;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // the swizzle repeats every 1024 bytes: tiles start on that grain
  unsigned char* smem = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + kStages * kTileBytes;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const T* kb = k + b * k_sb + int64_t(h) * D;
  const T* vb = v + b * v_sb + int64_t(h) * D;
  const int tiles = (Tk + 63) / 64;

  auto load_tile = [&](const T* src, int64_t st, unsigned char* ring, int j) {
    unsigned char* dst = ring + (j % kStages) * kTileBytes;
    const int j0 = j * 64;
#pragma unroll
    for (int i = 0; i < 64 * 8 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / 8, c = idx % 8;
      const bool in = j0 + r < Tk;
      cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), in ? src + (j0 + r) * st + c * 8 : src,
                 in ? 16 : 0);
    }
  };
  auto prologue = [&](bool with_v) {
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < tiles) {
        load_tile(kb, k_st, Ks, j);
        if (with_v) load_tile(vb, v_st, Vs, j);
      }
      cp_async_commit();
    }
  };
  // wait for tile j, make it visible to wgmma (the async proxy), then
  // refill the slot every product finished reading
  auto next_tile = [&](int j, bool with_v) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    if (j + kStages - 1 < tiles) {
      load_tile(kb, k_st, Ks, j + kStages - 1);
      if (with_v) load_tile(vb, v_st, Vs, j + kStages - 1);
    }
    cp_async_commit();
  };

  prologue(false);
  const int r0 = blockIdx.x * kRows + warp * kRowsPerWarp + g;  // warp w: rows 16 w .. of the block
  uint32_t qf[D / 16][4];
  load_a<D>(qf, q + b * q_sb + int64_t(h) * D, q_st, r0, Tq, t4);

  float s[32];  // S of the warpgroup's 64 rows and the tile's 64 keys
  auto scores = [&](int j) {
    const uint32_t kt = smem_u32(Ks + (j % kStages) * kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_rs<0>(s, qf[kk], smem_desc(kt + kk * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators<32>(s);
    if ((j + 1) * 64 > Tk) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (j * 64 + (e / 4) * 8 + t4 * 2 + (e & 1) >= Tk) s[e] = -INFINITY;
    }
  };

  // pass 1, as the mma.sync kernel's: per thread, trees over a tile
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
  for (int j = 0; j < tiles; ++j) {
    next_tile(j, false);
    scores(j);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) t[n] = fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]);
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
#pragma unroll
        for (int n = 0; n < w; ++n) t[n] = fmaxf(t[n], t[n + w]);
      const float m = fmaxf(mx[r], t[0]);
      const float base = m == -INFINITY ? 0.f : m * scale_log2;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        t[n] = ex2(fmaf(s[4 * n + 2 * r], scale_log2, -base)) +
               ex2(fmaf(s[4 * n + 2 * r + 1], scale_log2, -base));
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
#pragma unroll
        for (int n = 0; n < w; ++n) t[n] += t[n + w];
      sm[r] = sm[r] * ex2(fmaf(mx[r], scale_log2, -base)) + t[0];
      mx[r] = m;
    }
  }
  float base[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    base[r] = quad_max(mx[r]) * scale_log2;
    const float part = mx[r] == -INFINITY ? 0.f : sm[r] * ex2(fmaf(mx[r], scale_log2, -base[r]));
    inv[r] = __frcp_rn(quad_sum(part));
  }

  // pass 2: P rounded to bf16 after the exact sum, O += P V in fp32
  __syncthreads();
  prologue(true);
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    next_tile(j, true);
    scores(j);
    uint32_t pa[4][4];  // A fragments of P, keys c * 16 .. + 15
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float* sn = s + 4 * (2 * c + hi);
        pa[c][2 * hi] = pack2(ex2(fmaf(sn[0], scale_log2, -base[0])) * inv[0],
                              ex2(fmaf(sn[1], scale_log2, -base[0])) * inv[0]);
        pa[c][2 * hi + 1] = pack2(ex2(fmaf(sn[2], scale_log2, -base[1])) * inv[1],
                                  ex2(fmaf(sn[3], scale_log2, -base[1])) * inv[1]);
      }
    const uint32_t vt = smem_u32(Vs + (j % kStages) * kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) wgmma_rs<1>(acc, pa[c], smem_desc_mn(vt + c * 2048), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_accumulators<32>(acc);
  }

  const int64_t o_st = int64_t(H) * D;
  T* ob = o + (int64_t(b) * Tq * H + h) * D;
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + t4 * 2;
    if (r0 < Tq)
      *reinterpret_cast<uint32_t*>(ob + r0 * o_st + c) = pack2(acc[4 * n], acc[4 * n + 1]);
    if (r1 < Tq)
      *reinterpret_cast<uint32_t*>(ob + r1 * o_st + c) = pack2(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

int launch(const T* q, const T* k, const T* v, T* o, int B, int H, int Tq, int Tk,
           const int64_t* s, float scale, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      two_pass_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid((Tq + kRows - 1) / kRows, B * H);
  two_pass_wgmma_kernel<<<grid, kThreads, kSmem, stream>>>(
      q, k, v, o, H, Tq, Tk, s[0], s[1], s[2], s[3], s[4], s[5], scale * kLog2e);
  return int(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// one pass on warpgroup products: Tk <= kMaxKeys, D 48 / 64

namespace op {

using muse::attn::chunks_for;
using muse::attn::fence_operands;
using muse::attn::head_map;
using muse::attn::kBox;
using muse::attn::scores_step;
using muse::attn::tma_box;
using muse::attn::tma_box_multicast;
using muse::attn::tma_store_box;
using muse::attn::tma_store_drain;
using muse::attn::warpgroup_sync;
using muse::sm90::fence_accumulators;
using muse::sm90::mbar_arrive;
using muse::sm90::mbar_expect_tx;
using muse::sm90::mbar_init;
using muse::sm90::mbar_wait;
using muse::sm90::smem_desc_mn;
using muse::sm90::smem_u32;
using muse::sm90::wgmma_commit;
using muse::sm90::wgmma_fence;
using muse::sm90::wgmma_wait;

constexpr int kMaxCluster = 8;  // the portable cluster size

// What a capacity fixes: consumer warpgroups of 64 query rows (3 up to 256
// keys, 2 where S takes 144 registers a thread) beside the
// producer's warpgroup; the registers a thread after setmaxnreg (each
// quadrant's 512 a warp slot shared as consumers x kRegs + kProducerRegs);
// the TMA boxes of 64 keys a pair's K (or V) takes, zeros past Tk, so that
// every product reads staged rows; the slots of pairs' K and V a persistent
// block keeps (two: the next pair's arrive while one is read; a third
// gained nothing on the card; a cluster's block one); the ring of Q tiles
// (two a consumer warpgroup: a third gained nothing either); the dynamic
// shared memory: the K / V slots, the Q ring, a tile of O a consumer
// warpgroup and the mbarriers, 1024-byte aligned.
constexpr int consumers_for(int chunks) { return chunks <= 8 ? 3 : 2; }

template <int kChunks>
struct Cfg {
  static constexpr int kConsumers = consumers_for(kChunks);
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kProducerRegs = kConsumers == 3 ? 32 : 24;
  static constexpr int kRegs = kConsumers == 3 ? 160 : 240;
  static constexpr int kBoxes = (kChunks * 32 + 63) / 64;
  static constexpr int kKvBytes = 2 * kBoxes * kBox;  // a pair's K, then its V
  static constexpr int kKvSlots = 2;
  static constexpr int kQSlots = 2 * kConsumers;
  static constexpr int kBarriers = 3 * kKvSlots + 2 * kQSlots;
  static constexpr size_t smem(int kv_slots) {
    return 1024 + size_t(kv_slots) * kKvBytes + (kQSlots + kConsumers) * kBox + kBarriers * 8;
  }
  static_assert(smem(kKvSlots) <= 232448, "the SM's shared memory");
};

// The cluster size: 1 (persistent blocks walking over the (batch, head)
// pairs) once the pairs fill the card; else a cluster of c blocks a pair, c
// as large as the card holds (pairs * c <= SMs) but no larger than gives
// each consumer warpgroup one 64-row tile, at most 8.
inline int cluster_for(int pairs, int Tq, int Tk, int sms) {
  const int tiles = (Tq + 63) / 64, consumers = consumers_for(chunks_for(Tk));
  return std::max(1, std::min({sms / pairs, (tiles + consumers - 1) / consumers, kMaxCluster}));
}

// Where this kernel runs, and the mma.sync one-pass kernel otherwise:
// wherever its blocks are persistent (the pairs fill the card), and in
// clusters at D 64 over more than 96 keys.  With fewer pairs than that, at
// 96 keys or fewer (the 77 text keys when serving) and at D 48 (v1
// serving's (1, 257, 16, 48)), the mma.sync kernel's 64-row blocks were
// 22 - 61% faster on the card (PERF.md).
inline bool takes(int pairs, int Tq, int Tk, int D, int sms) {
  return cluster_for(pairs, Tq, Tk, sms) == 1 || (D == 64 && Tk > 96);
}


// Clusters of csize blocks along x (1: persistent blocks).  Cluster c takes
// the pairs c, c + clusters, ...; block `rank` of it the pair's 64-row tiles
// rank, rank + csize, ...; the block's tasks (pair, row tile) in order go
// round its consumer warpgroups.  The producer warpgroup's first thread
// keeps the loads in flight: a pair's K and V into one of kv_slots slots (a
// persistent block's two: the next pair's arrive while this one's are read;
// in a cluster, one pair a cluster, each block loads a share of the boxes
// and multicasts it), the tasks' Q tiles into the ring.  A consumer
// warpgroup waits for the pair's K and V and the task's Q, runs S = Q K^T
// (A and B from shared memory), frees the Q slot, takes the exact softmax
// in registers (each warp its 16 rows, a row's four threads meeting by
// shuffles), runs O = P V as m64n64k16 products with P from registers and V
// an MN-major B, and stores O from registers.  Every consumer warpgroup
// releases the pair's slot once past its tasks.
template <int D, int kChunks>
__global__ void __launch_bounds__(Cfg<kChunks>::kThreads, 1)
one_pass_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_o, int B, int H, int Tq, int Tk,
                      float scale_log2) {
  namespace cg = cooperative_groups;
  using C = Cfg<kChunks>;
  static_assert(D == 48 || D == 64, "a head within one 128-byte swizzle row");
  constexpr int kN = 64;  // P V's width: at D 48 also the box's zero columns 48 .. 63
  constexpr int kS = 16 * kChunks;  // S's accumulators a thread
  constexpr int kSteps = 2 * kChunks;  // P V's k steps of 16 keys
  extern __shared__ __align__(1024) unsigned char op_smem[];
  unsigned char* smem = op_smem + ((1024 - (smem_u32(op_smem) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int kv_slots = csize == 1 ? C::kKvSlots : 1;
  unsigned char* kv = smem;
  unsigned char* qs = smem + kv_slots * C::kKvBytes;
  unsigned char* os = qs + C::kQSlots * kBox;  // each consumer warpgroup's O tile
  uint64_t* full_k = reinterpret_cast<uint64_t*>(os + C::kConsumers * kBox);
  uint64_t* full_v = full_k + C::kKvSlots;
  uint64_t* empty_kv = full_v + C::kKvSlots;
  uint64_t* full_q = empty_kv + C::kKvSlots;
  uint64_t* empty_q = full_q + C::kQSlots;

  const int pairs = B * H, tiles = (Tq + 63) / 64;
  const int clusters = gridDim.x / csize, cid = blockIdx.x / csize;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kKvSlots; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_kv[s], 128 * C::kConsumers);
    }
    for (int s = 0; s < C::kQSlots; ++s) {
      mbar_init(&full_q[s], 1);
      mbar_init(&empty_q[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block's barriers are set before a multicast lands in it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * C::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (warp == 4 * C::kConsumers && lane == 0) {  // the producer
      int task = 0;
      for (int i = 0, p = cid; p < pairs; ++i, p += clusters) {
        const int b = p / H, h = p % H, s = i % kv_slots;
        if (i >= kv_slots) mbar_wait(&empty_kv[s], (i / kv_slots - 1) & 1);
        // K, then V, each on its own barrier: S waits for K alone
        mbar_expect_tx(&full_k[s], C::kKvBytes / 2);
        mbar_expect_tx(&full_v[s], C::kKvBytes / 2);
        for (int j = rank; j < 2 * C::kBoxes; j += csize) {
          const bool is_v = j >= C::kBoxes;
          const int t = (is_v ? j - C::kBoxes : j) * 64;
          unsigned char* dst = kv + s * C::kKvBytes + j * kBox;
          uint64_t* bar = is_v ? &full_v[s] : &full_k[s];
          if (csize == 1)
            tma_box(dst, is_v ? &map_v : &map_k, bar, h, t, b);
          else
            tma_box_multicast(dst, is_v ? &map_v : &map_k, bar, h, t, b,
                              uint16_t((1u << csize) - 1));
        }
        for (int t = rank; t < tiles; t += csize, ++task) {
          const int slot = task % C::kQSlots;
          if (task >= C::kQSlots) mbar_wait(&empty_q[slot], (task / C::kQSlots - 1) & 1);
          mbar_expect_tx(&full_q[slot], kBox);
          tma_box(qs + slot * kBox, &map_q, &full_q[slot], h, t * 64, b);
        }
      }
    }
    __syncwarp();
    // no block leaves while a multicast may still be writing into another
    if (csize > 1) cluster.sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kRegs));
    const int wg = warp / 4, w4 = warp % 4;  // warp w4 of the warpgroup: rows 16 w4 .. + 15
    const int g = lane >> 2, t4 = lane & 3;
    const bool leader = threadIdx.x % 128 == 0;  // stores the warpgroup's O tiles
    unsigned char* ot = os + wg * kBox;
    int task = 0;
    for (int i = 0, p = cid; p < pairs; ++i, p += clusters) {
      const int b = p / H, h = p % H, s = i % kv_slots;
      mbar_wait(&full_k[s], (i / kv_slots) & 1);
      const uint32_t ks = smem_u32(kv + s * C::kKvBytes), vs = ks + C::kBoxes * kBox;
      for (int t = rank; t < tiles; t += csize, ++task) {
        if (task % C::kConsumers != wg) continue;
        const int slot = task % C::kQSlots;
        mbar_wait(&full_q[slot], (task / C::kQSlots) & 1);
        const uint32_t qa = smem_u32(qs + slot * kBox);

        // S of the warpgroup's 64 rows and every key: sc[4 n + e] is key 8
        // n + 2 t4 + (e & 1) of row g (e < 2) or g + 8 (e >= 2)
        float sc[kS];
#pragma unroll
        for (int e = 0; e < kS; ++e) sc[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) scores_step<kChunks>(sc, qa, ks, kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_accumulators<kS>(sc);
        mbar_arrive(&empty_q[slot]);

        // P = 2^(S c - max c) / sum with c = log2(e) / sqrt(D), rounded to
        // bf16 after the exact sum, as P V's A fragments of 16 keys.  A warp
        // whose rows all lie past Tq (the ragged last tile: Q's rows there
        // are zeros, and so is S) takes no exponential and keeps P zero.
        const bool live = t * 64 + w4 * 16 < Tq;
        float inv0 = 0.f, inv1 = 0.f;
        if (live) {
          float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
          for (int n = 0; n < kS / 4; ++n) {
            float* x = sc + 4 * n;
            if (8 * n + 8 > Tk) {  // keys at or past Tk: -inf
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (8 * n + t4 * 2 + (e & 1) >= Tk) x[e] = -INFINITY;
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
          inv0 = __frcp_rn(quad_sum(l0));
          inv1 = __frcp_rn(quad_sum(l1));
        }

        // O = P V in fp32, V's 16-key step j 2048 bytes on
        uint32_t pa[kSteps][4];  // P rounded to bf16 after the product with 1 / sum
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          const float* x = sc + 8 * j;  // keys 16 j .. + 15
          pa[j][0] = pack2(x[0] * inv0, x[1] * inv0);
          pa[j][1] = pack2(x[2] * inv1, x[3] * inv1);
          pa[j][2] = pack2(x[4] * inv0, x[5] * inv0);
          pa[j][3] = pack2(x[6] * inv1, x[7] * inv1);
        }
        mbar_wait(&full_v[s], (i / kv_slots) & 1);
        float acc[kN / 2];
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kSteps; ++j)
          wg::wgmma_rs<1>(acc, pa[j], smem_desc_mn(vs + j * 2048), j);
        wgmma_commit();
        wgmma_wait<0>();
        fence_accumulators<kN / 2>(acc);
#pragma unroll
        for (int j = 0; j < kSteps; ++j) fence_operands<4>(pa[j]);

        // O rounded to bf16 into the warpgroup's tile in the 128-byte
        // swizzle (16-byte chunk c of row r at c ^ (r % 8): a warp's stores
        // hit 32 banks), then one TMA store of the tile, clipped at Tq and D
        if (leader) tma_store_drain();  // the previous task's tile has left
        warpgroup_sync(wg);
        const int r = w4 * 16 + g;  // rows r and r + 8 of the tile
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(ot + r * 128 + ((n ^ (r & 7)) << 4) + 4 * t4) =
              pack2(acc[4 * n], acc[4 * n + 1]);
          *reinterpret_cast<uint32_t*>(ot + (r + 8) * 128 + ((n ^ (r & 7)) << 4) + 4 * t4) =
              pack2(acc[4 * n + 2], acc[4 * n + 3]);
        }
        wg::fence_proxy_async();  // the tile, written by threads, to the TMA's proxy
        warpgroup_sync(wg);
        if (leader) tma_store_box(&map_o, ot, h, t * 64, b);
      }
      mbar_arrive(&empty_kv[s]);
    }
    if (leader) tma_store_drain();  // the last tile has left shared memory
    if (csize > 1) cluster.sync();
  }
}


template <int D, int kChunks>
int launch(const T* q, const T* k, const T* v, T* o, int B, int H, int Tq, int Tk,
           const int64_t* s, float scale, cudaStream_t stream) {
  using C = Cfg<kChunks>;
  CUtensorMap map_q, map_k, map_v, map_o;
  cudaError_t err = head_map(&map_q, q, B, Tq, H, D, s[0], s[1]);
  if (err == cudaSuccess) err = head_map(&map_k, k, B, Tk, H, D, s[2], s[3]);
  if (err == cudaSuccess) err = head_map(&map_v, v, B, Tk, H, D, s[4], s[5]);
  if (err == cudaSuccess) err = head_map(&map_o, o, B, Tq, H, D, int64_t(Tq) * H * D, int64_t(H) * D);
  if (err != cudaSuccess) return int(err);
  auto kernel = one_pass_wgmma_kernel<D, kChunks>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::smem(C::kKvSlots)));
  if (configured != cudaSuccess) return int(configured);
  const int pairs = B * H, sms = muse::sm90::sm_count();
  const int csize = cluster_for(pairs, Tq, Tk, sms);
  cudaLaunchConfig_t config = {};
  // persistent blocks, one an SM at most; or a cluster a pair
  config.gridDim = dim3(csize == 1 ? std::min(pairs, sms) : pairs * csize);
  config.blockDim = dim3(C::kThreads);
  config.dynamicSmemBytes = C::smem(csize == 1 ? C::kKvSlots : 1);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, map_q, map_k, map_v, map_o, B, H, Tq, Tk,
                           scale * kLog2e);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

template <int D>
int launch(const T* q, const T* k, const T* v, T* o, int B, int H, int Tq, int Tk,
           const int64_t* s, float scale, cudaStream_t stream) {
  switch (chunks_for(Tk)) {
    case 1: return launch<D, 1>(q, k, v, o, B, H, Tq, Tk, s, scale, stream);
    case 3: return launch<D, 3>(q, k, v, o, B, H, Tq, Tk, s, scale, stream);
    case 8: return launch<D, 8>(q, k, v, o, B, H, Tq, Tk, s, scale, stream);
    default: return launch<D, 9>(q, k, v, o, B, H, Tq, Tk, s, scale, stream);
  }
}

}  // namespace op

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

// the rule: one pass up to kMaxKeys keys (on wgmma at D 48 / 64), above
// two passes (on wgmma at D 64)
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Tq, int Tk,
           const int64_t* s, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* out = static_cast<T*>(o);
  if (Tk > kMaxKeys) {
    if constexpr (D == 64) return wg::launch(qp, kp, vp, out, B, H, Tq, Tk, s, scale, stream);
    else return launch_two_pass<D>(qp, kp, vp, out, B, H, Tq, Tk, s, scale, stream);
  }
  if constexpr (D >= 48) {
    if (op::takes(B * H, Tq, Tk, D, muse::sm90::sm_count()))
      return op::launch<D>(qp, kp, vp, out, B, H, Tq, Tk, s, scale, stream);
  }
  if (Tk <= 80)
    return launch_one_pass<D, 4, 1, 5>(qp, kp, vp, out, B, H, Tq, Tk, s, scale, stream);
  return launch_one_pass<D, 4, 2, kMaxKeys / 32>(qp, kp, vp, out, B, H, Tq, Tk, s, scale, stream);
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int Tq, int Tk,
             int D, const int64_t* strides, float scale, void* stream_ptr) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || B * H > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, H, Tq, Tk, strides, scale, stream);
    case 32: return launch<32>(q, k, v, o, B, H, Tq, Tk, strides, scale, stream);
    case 48: return launch<48>(q, k, v, o, B, H, Tq, Tk, strides, scale, stream);
    case 64: return launch<64>(q, k, v, o, B, H, Tq, Tk, strides, scale, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Tq, H, D), k and v (B, Tk, H, D) bf16, D 16 (the eval stacks'
// seeded CLIP towers and tiny trunks), 32 (the mid-scale trunk's blocks), 48
// (v1) or 64 (v2's blocks, CLIP ViT-L/14), each with d contiguous, heads D apart, and the batch and
// token strides given in elements (multiples of 8; pointers 16-byte aligned);
// o (B, Tq, H, D) contiguous.  strides: q_sb, q_st, k_sb, k_st, v_sb, v_st.
// Tk <= 288 takes a one-pass kernel (wgmma or mma.sync, by the rule in the
// header), larger Tk the two-pass one (wgmma at D 64, mma.sync otherwise).
extern "C" int muse_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                    int H, int Tq, int Tk, int D, const int64_t* strides,
                                    float scale, void* stream_ptr) {
  return dispatch(q, k, v, o, B, H, Tq, Tk, D, strides, scale, stream_ptr);
}
