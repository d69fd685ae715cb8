// Nearest codebook entry for each latent row:
//
//   id[n] = argmin_k ( e_sq[k] - 2 * z[n] . cb[k] )      fp32, first k on ties
//
// z (N, C) and cb (K, C) fp32, e_sq (K,) = |cb[k]|^2 computed by the wrapper.
// Replaces the Pallas TPU kernel open_muse_tpu/ops/pallas/vq_argmin.py
// `vq_argmin` (body `_kernel`), which streams codebook tiles past a VMEM
// block of rows and keeps a running (min, argmin) per row.
//
// What bounds it on the H100: the products.  The scores need fp32's
// accuracy (a single TF32 or bf16 product moves near-tied scores and with
// them the ids), and fp32 FMA runs at 67 TFLOP/s: 2 N K C = 68.7 GFLOP for
// the pre-encode batch (N = 16384, K = 8192, C = 256) is 1.03 ms there.  On
// the bf16 tensor cores the same accuracy costs six products: each fp32
// value x is split into three bf16 parts, hi = bf16(x), mid = bf16(x - hi),
// lo = bf16(x - hi - mid) (each subtraction exact in fp32, so the parts
// carry x to about 2^-24 of itself), and z . e is summed over hi.hi, hi.mid,
// mid.hi, hi.lo, mid.mid and lo.hi in fp32 (bf16 x bf16 products are exact
// in fp32; the dropped mid.lo, lo.mid and lo.lo stay within about 2^-23 of
// each |z_c e_c|, the size of fp32's own rounding of a product).  That
// is 12 N K C = 412 GFLOP, 417 us at 989 TFLOP/s; the bytes (z, cb, ids: ~25
// MB; the split operands the kernel writes and reads: 38 MB) are 7.5 - 20 us.
//
// What the design does about it, three launches after a memset:
// - A split pass: one elementwise kernel over z and the codebook writes z'
//   (N, 3 Cp) = -2 [z_hi | z_mid | z_lo] and cb' (K', 3 Cp) = [e_hi | e_mid |
//   e_lo] in bf16.  Cp is C rounded up to a multiple of 64 (one GEMM k step
//   then reads one part) and K' is K rounded up to an even count (the GEMM's
//   even N), both padded with zeros; the -2 is exact.
// - The Hopper GEMM (gemm_sm90.cuh, TMA + wgmma) on z' x cb'^T over a K of 6
//   Cp: its epilogue remaps the k steps so that the six Cp-wide spans read
//   the part pairs (hi, hi), (hi, mid), (mid, hi), (hi, lo), (mid, mid), (lo,
//   hi), the six products in one reduction, each part stored once.  The
//   epilogue is staged: the block's 128 x kBN fp32 tile of -2 z . e
//   arrives in shared memory, one warp a row adds e_sq, masks the columns
//   past K and reduces to (lowest score, lowest column on equal scores) with
//   shuffles, and one lane merges it into best[row] with a 64-bit atomicMin
//   on (order-preserving score bits << 32 | id).  The (N, K) scores never
//   reach device memory, and the atomics keep the lowest score and, on equal
//   scores, the lowest id whatever order the blocks run in: two calls give
//   the same ids.
// - unpack_ids: the ids from the packed minima.
//
// Two routes, chosen by C alone (narrow::takes, read by the wrapper through
// muse_vq_route): the split route above for C > kMaxC (10), and for the
// narrow latents of MOVQ and Paella (C 4) a route whose product is as deep
// as the work.  Padded to 64, C 4 made the split route's K 6 x 64 where the
// six part products need 6 x 4: 15 of every 16 tensor operations multiplied
// zeros, and the staged epilogue read every score back through shared
// memory; at C 256 the K of 1536 hides both.  The narrow route, two launches:
// - vq_pack_kernel: the codebook as cb' (K, W) bf16, W = 32 (C <= 4) or 64
//   (C <= 10), the six part spans side by side along K, each C wide, [e_hi
//   | e_mid | e_hi | e_lo | e_mid | e_hi], then the three parts of e_sq
//   (|e|^2 summed in fp32 in column order, each product and sum rounded)
//   and zeros; it also sets best and the row blocks' counters (below) when
//   a row's codes are split over several blocks.  z's spans, [z_hi | z_hi |
//   z_mid | z_hi | z_mid | z_lo] of -2 z then (1, 1, 1) against e_sq's
//   parts, are built in registers as wgmma's A: the accumulators hold the
//   whole score e_sq - 2 z . e, a K of 32 at C 4 (27 columns live) against
//   384.
// - vq_narrow_kernel<kSteps>: a block keeps 384 rows resident (192 at W
//   64): three consumer warpgroups, two 64-row m-tiles each (one at W 64),
//   their A fragments in registers, built from the block's rows of z and
//   their bf16 parts staged in shared memory.  It walks a range of codes in
//   tiles of 128: a producer warpgroup, its registers given to the
//   consumers by setmaxnreg, keeps a 4-slot TMA ring of cb' tiles full from
//   its first thread (full / empty mbarriers, the 128-byte swizzle, zeros
//   past W and past K).  For each tile and m-tile a consumer warpgroup
//   issues kSteps register-A wgmma m64n128k16, waits, and takes each row's
//   minimum over its 32 columns from the accumulators in registers by a
//   tree of mins (FMNMX, one a score, at the ALU pipe's half rate), keeping
//   the row's best score and the tile that holds it (strict <: the earlier
//   tile keeps an exact tie).  A search for the column in every tile that
//   beats the running best ran in most tiles at a warp's grain (each of its
//   64 thread-rows has a record about ln(tiles) times) and tripled the ALU
//   work a score; instead, after the last tile, the quad's four threads of
//   a row take its lowest (score, tile) and score that tile's columns
//   again, those of the thread(s) holding the minimum, 8 each, in fp32 on
//   the CUDA cores from the range's codes (staged in shared memory by
//   cp.async while the products run): the lowest wins, the lowest column
//   on equal scores (an ulp or so from the tensor cores' sums, far inside
//   VQ_RTOL; identical codes score alike).  The grid is row blocks x code
//   ranges, the ranges as many as fill the card's SMs (and as let a range's
//   codes fit shared memory): one range writes ids directly; over several,
//   each block merges into best with the split route's 64-bit atomicMin on
//   (order key, id), and the last block of a row block (a counter after
//   __threadfence) unpacks its rows' ids.  The minimum is of (score, id)
//   pairs whatever order the blocks run in: two calls give the same ids,
//   the earliest on exact ties.
// What bounds it: at C 4 the ALU pipe's minima (N K FMNMX at 64 a clock an
// SM, 128 us at (262144, 8192)) and the tensor products (16 N K C bf16
// operations, 139 us) about equally; they overlap only in part across the
// three warpgroups (each waits for its products before its minima: products
// kept in flight meanwhile made ptxas serialise every wgmma, C7514, and a
// second accumulator set spilled at 160 registers).
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>

#include "gemm_sm90.cuh"

namespace {

constexpr int kParts = 3;  // hi, mid, lo
// the parts of z' and of cb' that the six Cp-wide spans of the product's K
// read, two bits a span: z' (hi, hi, mid, hi, mid, lo), cb' (hi, mid, hi, lo,
// mid, hi)
constexpr unsigned kZSpans = 0x910, kCbSpans = 0x184;

// monotone map of a float to an unsigned key: a < b  <=>  key(a) < key(b)
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Eight bf16 values packed in 16 bytes.
union Pack8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

// One thread an 8-column chunk of a row of z (rows [0, N)) or of the
// codebook (rows [N, N + Kp)): the three bf16 parts of (z: -2 x, cb: x).
// Columns past C and codebook rows past K are zeros.
__global__ void __launch_bounds__(256)
vq_split_kernel(const float* __restrict__ z, const float* __restrict__ cb, int N, int C, int K,
                int Kp, int Cp, __nv_bfloat16* __restrict__ zp, __nv_bfloat16* __restrict__ cbp) {
  const int chunks = Cp / 8;
  const int64_t total = int64_t(N + Kp) * chunks;
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < total;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int row = int(i / chunks), c0 = int(i % chunks) * 8;
    const bool is_z = row < N;
    const int r = is_z ? row : row - N;
    const float* src = is_z ? z + int64_t(r) * C : cb + int64_t(r) * C;
    const bool live = is_z || r < K;
    float x[8];
    if (live && C % 4 == 0 && c0 + 8 <= C) {
      const float4 a = *reinterpret_cast<const float4*>(src + c0);
      const float4 b = *reinterpret_cast<const float4*>(src + c0 + 4);
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = live && c0 + e < C ? src[c0 + e] : 0.f;
    }
    Pack8 part[3];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float v = is_z ? -2.f * x[e] : x[e];
      part[0].h[e] = __float2bfloat16_rn(v);
      const float r1 = __fsub_rn(v, __bfloat162float(part[0].h[e]));
      part[1].h[e] = __float2bfloat16_rn(r1);
      part[2].h[e] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(part[1].h[e])));
    }
    __nv_bfloat16* dst = (is_z ? zp : cbp) + int64_t(r) * kParts * Cp + c0;
#pragma unroll
    for (int p = 0; p < kParts; ++p) *reinterpret_cast<uint4*>(dst + p * Cp) = part[p].u;
  }
}

// The epilogue of z' x cb'^T.  It maps k step k of the 6 Cp-long product to
// the columns of z' and of cb' holding its span's parts; it is staged: the
// block's fp32 tile of -2 z . e in
// shared memory, every thread of the block.  One warp a row at a time: each
// lane takes columns lane, lane + 32, ... (increasing, strict <: the first
// column wins within a lane), the warp reduces to the lowest score and on
// equal scores the lowest column, and lane 0 merges it into best[row].
struct VqArgminEpilogue {
  static constexpr bool kStaged = true;
  static constexpr bool kRemapK = true;
  const float* e_sq;
  int codes;  // K: columns at or past it are cb's zero padding
  unsigned long long* best;
  int cp;        // the width of a part, a multiple of the k step
  int k_extent;  // the operands' width, 3 cp

  __device__ __forceinline__ int k_a(int k) const { return remap(kZSpans, k); }
  __device__ __forceinline__ int k_w(int k) const { return remap(kCbSpans, k); }
  __device__ __forceinline__ int remap(unsigned spans, int k) const {
    const int span = k / cp;
    return int((spans >> (2 * span)) & 3) * cp + k - span * cp;
  }

  template <int kBM, int kBN, int kLd, int kThreads>
  __device__ __forceinline__ void tile(const float* s, int m0, int n0, int M, int) const {
    constexpr int kWarps = kThreads / 32, kPer = kBN / 32;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    float e[kPer];  // +inf past K: such a column never wins
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = n0 + lane + 32 * j;
      e[j] = col < codes ? e_sq[col] : INFINITY;
    }
    for (int r = warp; r < kBM && m0 + r < M; r += kWarps) {
      float best_s = INFINITY;
      int best_i = INT_MAX;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float v = __fadd_rn(e[j], s[r * kLd + lane + 32 * j]);
        if (v < best_s) {
          best_s = v;
          best_i = n0 + lane + 32 * j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, best_s, off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
        if (os < best_s || (os == best_s && oi < best_i)) {
          best_s = os;
          best_i = oi;
        }
      }
      if (lane == 0 && best_i < codes)
        atomicMin(best + m0 + r, (static_cast<unsigned long long>(order_key(best_s)) << 32) |
                                     static_cast<uint32_t>(best_i));
    }
  }
};

__global__ void unpack_ids(const unsigned long long* __restrict__ best, int N,
                           int* __restrict__ ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < N) ids[i] = static_cast<int>(best[i] & 0xffffffffull);
}

int split_blocks(int N, int Kp, int Cp) {
  const int64_t chunks = int64_t(N + Kp) * (Cp / 8);
  return int(std::min<int64_t>((chunks + 255) / 256, 8 * muse::sm90::sm_count()));
}

}  // namespace

namespace narrow {

using muse::sm90::mbar_arrive;
using muse::sm90::mbar_expect_tx;
using muse::sm90::mbar_init;
using muse::sm90::mbar_wait;
using muse::sm90::smem_desc;
using muse::sm90::smem_u32;
using muse::sm90::tma_load_2d;

// the widest latents the route takes: its packed K (6 C + 3) fits one
// 128-byte row of bf16, one TMA box and four k steps
constexpr int kMaxC = 10;
constexpr int kTileCodes = 128;  // codes a tile: the products' N
// consumer warpgroups: three, so that one's products run while the others
// take minima (two left the tensor cores idle for the products' latency)
constexpr int kConsumers = 3;
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer's warpgroup
// registers a thread after setmaxnreg: the producer's go to the consumers
// (128 x 24 + 384 x 160 = 64512 of 65536; 512 threads start at 128)
constexpr int kProducerRegs = 24, kConsumerRegs = 160;
constexpr int kStages = 4;
constexpr int kTileBytes = kTileCodes * 128;  // one TMA box: 128 codes x 64 bf16
// shared memory: the ring, its barriers, the block's rows of z (fp32, and
// the three bf16 parts of -2 z a row, [hi | mid | lo] each C wide) and its
// range's codes in fp32 (read once, coalesced, for the A fragments and for
// scoring a tile's columns again)
constexpr int kZBytes = 8 * 1024;       // rows_per_block(C) x C fp32, C up to kMaxC
constexpr int kPartBytes = 12 * 1024;   // rows_per_block(C) x 3 C bf16
constexpr int kCodeBytes = 128 * 1024;  // a range's codes: per x 128 x C fp32
constexpr int kBarOffset = kStages * kTileBytes, kZOffset = kBarOffset + 2 * kStages * 8;
constexpr int kPartOffset = kZOffset + kZBytes, kCodeOffset = kPartOffset + kPartBytes;
constexpr int kSmemMax = 1024 + kCodeOffset + kCodeBytes;

// the route's rule: C alone
__host__ __device__ constexpr bool takes(int C) { return C >= 1 && C <= kMaxC; }
// the packed K: six C-wide spans and e_sq's three parts, rounded up to 32
__host__ __device__ constexpr int width(int C) { return (6 * C + 3 + 31) / 32 * 32; }
// 64-row m-tiles a consumer warpgroup keeps, their A fragments in registers:
// 2 at two k steps (W 32), 1 at four
__host__ __device__ constexpr int m_tiles(int steps) { return 4 / steps; }
// rows a block: 384 at W 32, 192 at W 64
__host__ __device__ constexpr int rows_per_block(int C) {
  return kConsumers * m_tiles(width(C) / 16) * 64;
}
__host__ __device__ constexpr int row_blocks(int N, int C) {
  return (N + rows_per_block(C) - 1) / rows_per_block(C);
}
// the most code tiles a range may hold: its fp32 codes fit kCodeBytes
__host__ __device__ constexpr int max_range_tiles(int C) {
  return kCodeBytes / (kTileCodes * 4 * C);
}

// floats [0, n) of src (16-byte aligned) into shared memory by cp.async,
// `threads` threads, 16 bytes a copy and 4 for a ragged end; committed as
// one group, not waited for
__device__ __forceinline__ void stage_async(float* dst, const float* __restrict__ src, int n,
                                            int tid, int threads) {
  const int n4 = n / 4;
  for (int i = tid; i < n4; i += threads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + 4 * i)),
                 "l"(src + 4 * i)
                 : "memory");
  for (int i = 4 * n4 + tid; i < n; i += threads)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst + i)),
                 "l"(src + i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// part p (0 hi, 1 mid, 2 lo) of x's three bf16 parts, as vq_split_kernel
// takes them
__device__ __forceinline__ __nv_bfloat16 split_part(float x, int p) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(hi));
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  if (p == 0) return hi;
  if (p == 1) return mid;
  return __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
}

// xr[c] for a run-time c below kMaxC, without indexing registers (which
// would put xr in local memory)
__device__ __forceinline__ float pick(const float (&xr)[kMaxC], int c) {
  float v = xr[0];
#pragma unroll
  for (int cc = 1; cc < kMaxC; ++cc) v = c == cc ? xr[cc] : v;
  return v;
}

// One thread an 8-column chunk of cb' (K, W), one 16-byte store, from the
// code's C values loaded first (|e|^2 summed in fp32 in column order, each
// product and sum rounded, as the plain twin sums it); then, when `init` >
// 0, best[0, N) = all ones and the row blocks' counters best[N, init) = 0.
// K W and init below 2^31 (the wrapper's int32 shapes).
__global__ void __launch_bounds__(256)
vq_pack_kernel(const float* __restrict__ cb, int K, int C, int W, __nv_bfloat16* __restrict__ cbp,
               unsigned long long* __restrict__ best, int N, int init) {
  const int chunks = K * (W / 8), shift = W == 32 ? 2 : 3;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < chunks + init;
       i += gridDim.x * blockDim.x) {
    if (i < chunks) {
      const int code = i >> shift, col0 = (i & (W / 8 - 1)) * 8;
      const float* e = cb + int64_t(code) * C;
      float ev[kMaxC];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) ev[c] = c < C ? __ldg(e + c) : 0.f;
      float e_sq = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C) e_sq = __fadd_rn(e_sq, __fmul_rn(ev[c], ev[c]));
      // column col: span col / C holds that part of channel col % C, then
      // e_sq's three parts, then zeros
      Pack8 out;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + j, span = col / C;
        out.h[j] = col < 6 * C ? split_part(pick(ev, col - span * C), (kCbSpans >> (2 * span)) & 3)
                   : col < 6 * C + 3 ? split_part(e_sq, col - 6 * C)
                                     : __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(cbp + int64_t(i) * 8) = out.u;
    } else {
      const int j = i - chunks;
      best[j] = j < N ? ~0ull : 0ull;
    }
  }
}

// D (64 x 128, fp32) (+)= A (64 x 16) B: A from registers (each warp its 16
// rows as an mma.sync A fragment), B 128 x 16 K-major in 128-byte-swizzled
// shared memory; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t a[4], uint64_t desc_b,
                                              int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// One row of a tile's scores: this thread's 32 columns of row h of the
// accumulators (q = 0 .. 31: accumulator 4 (q / 2) + 2 h + q % 2, column 8
// (q / 2) + 2 t4 + q % 2), their minimum by a tree of mins, one instruction
// a score.  kMask: the tile reaches past K, and columns at or past `live`
// are left out.
template <bool kMask>
__device__ __forceinline__ float tile_min(const float* acc, int h, int t4, int live) {
  float v[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    v[q] = acc[4 * (q / 2) + 2 * h + q % 2];
    if (kMask && 8 * (q / 2) + 2 * t4 + q % 2 >= live) v[q] = INFINITY;
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) v[q] = fminf(v[2 * q], v[2 * q + 1]);
#pragma unroll
  for (int q = 0; q < 8; ++q) v[q] = fminf(v[2 * q], v[2 * q + 1]);
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = fminf(v[2 * q], v[2 * q + 1]);
  return fminf(fminf(v[0], v[1]), fminf(v[2], v[3]));
}

// For each of the thread's kSlots rows (slot j: row row0 + 64 (j / 2) + 8
// (j % 2)), the column of code tile tile[j] that holds the row's minimum.
// The tensor-core minimum lies among the 32 columns of each lane w of the
// quad set in lanes[j] (columns tile[j] + 8 i + 2 w + e, i < 16, e < 2);
// the quad's four threads score them again as |e|^2 - 2 z . e in fp32,
// this thread the 8 with i / 4 = t4, and the lowest score wins, the lowest
// column on equal scores (the tensor cores' sums and these differ by an ulp
// or so, far inside VQ_RTOL; identical codes get identical scores).  All
// threads of the warp call it; lanes[j] is the quad's own (rarely more
// than one lane: exact ties).  z_rows: the block's rows of z from
// first_row, codes: the range's codes from code `first`, both in shared
// memory; at C 4 read as float4.
template <int kSlots>
__device__ __forceinline__ void tile_columns(const float* z_rows, int first_row, int row0, int N,
                                             const float* codes, int C, int K, int first,
                                             const int (&tile)[kSlots], int t4,
                                             unsigned (&lanes)[kSlots], int (&id)[kSlots]) {
  float best[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    best[j] = INFINITY;
    id[j] = K;
  }
  bool left = false;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) left |= lanes[j] != 0;
  while (__any_sync(0xffffffffu, left)) {
    left = false;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int w = lanes[j] != 0 ? __ffs(lanes[j]) - 1 : 0;
      const bool live = lanes[j] != 0;
      lanes[j] &= lanes[j] - 1;
      left |= lanes[j] != 0;
      const float* x = z_rows + (min(row0 + 64 * (j / 2) + 8 * (j % 2), N - 1) - first_row) * C;
      if (C == 4) {  // the 8 codes read together, clamped to the range's last
        const float4 xv = *reinterpret_cast<const float4*>(x);
        float4 e[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          e[q] = reinterpret_cast<const float4*>(
              codes)[min(tile[j] + 8 * (4 * t4 + q / 2) + 2 * w + q % 2, K - 1) - first];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = tile[j] + 8 * (4 * t4 + q / 2) + 2 * w + q % 2;
          const float dot =
              fmaf(xv.w, e[q].w, fmaf(xv.z, e[q].z, fmaf(xv.y, e[q].y, xv.x * e[q].x)));
          const float e_sq =
              fmaf(e[q].w, e[q].w, fmaf(e[q].z, e[q].z, fmaf(e[q].y, e[q].y, e[q].x * e[q].x)));
          const float score = fmaf(-2.f, dot, e_sq);
          if (live && col < K && (score < best[j] || (score == best[j] && col < id[j]))) {
            best[j] = score;
            id[j] = col;
          }
        }
        continue;
      }
      for (int q = 0; q < 8; ++q) {
        const int col = tile[j] + 8 * (4 * t4 + q / 2) + 2 * w + q % 2;
        if (!live || col >= K) break;
        const float* e = codes + (col - first) * C;
        float dot = 0.f, e_sq = 0.f;
        for (int c = 0; c < C; ++c) {
          dot = fmaf(x[c], e[c], dot);
          e_sq = fmaf(e[c], e[c], e_sq);
        }
        const float score = fmaf(-2.f, dot, e_sq);
        if (score < best[j] || (score == best[j] && col < id[j])) {
          best[j] = score;
          id[j] = col;
        }
      }
    }
  }
  // the quad's lowest score, then lowest column
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[j], off);
      const int oi = __shfl_xor_sync(0xffffffffu, id[j], off);
      if (ob < best[j] || (ob == best[j] && oi < id[j])) {
        best[j] = ob;
        id[j] = oi;
      }
    }
  }
}

// the products of one m-tile's 64 rows against a tile of 128 codes: kSteps
// register-A k steps into acc (overwritten), committed as one group
template <int kSteps>
__device__ __forceinline__ void tile_products(float* acc, const uint32_t (&a)[kSteps][4],
                                              uint32_t tile) {
  muse::sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) wgmma_rs_n128(acc, a[kk], smem_desc(tile + kk * 32), kk);
  muse::sm90::wgmma_commit();
}

// Grid (ranges, row blocks): block (r, b) takes rows [kRows b, kRows (b +
// 1)) against the code tiles [r per, (r + 1) per) of 128.  kSteps: the
// packed K's k steps of 16 (W / 16).  best: (N,) packed minima, then a
// counter a row block (used only over several ranges).
template <int kSteps>
__global__ void __launch_bounds__(kThreads, 1)
vq_narrow_kernel(const __grid_constant__ CUtensorMap map_cb, const float* __restrict__ z,
                 const float* __restrict__ cb, int N, int C, int K, int per,
                 unsigned long long* __restrict__ best, int* __restrict__ ids) {
  constexpr int kMTiles = m_tiles(kSteps), kRows = kConsumers * kMTiles * 64;
  extern __shared__ __align__(1024) unsigned char vq_smem[];
  unsigned char* smem = vq_smem + ((1024 - (smem_u32(vq_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  float* z_rows = reinterpret_cast<float*>(smem + kZOffset);
  __nv_bfloat16* z_parts = reinterpret_cast<__nv_bfloat16*>(smem + kPartOffset);
  float* codes = reinterpret_cast<float*>(smem + kCodeOffset);
  __shared__ int last_block;

  const int tiles = (K + kTileCodes - 1) / kTileCodes;
  const int tile0 = blockIdx.x * per, steps = min(tiles, tile0 + per) - tile0;
  // the warpgroup, broadcast so that ptxas sees it uniform (C7520)
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0), t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread keeps the ring of code tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (t == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
        mbar_expect_tx(&full[s], kTileBytes);
        tma_load_2d(smem + s * kTileBytes, &map_cb, &full[s], 0, (tile0 + i) * kTileCodes);
      }
    }
    return;  // the consumers wait for every load it issued
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  {
    // the range's codes into shared memory, waited for only before the
    // columns are scored; the block's rows of z, fp32 and as the three
    // bf16 parts of -2 z, each thread a few floats
    const int first_row = blockIdx.y * kRows, code_first = tile0 * kTileCodes;
    stage_async(codes, cb + int64_t(code_first) * C,
                (min(K, code_first + steps * kTileCodes) - code_first) * C, threadIdx.x,
                128 * kConsumers);
    {
      // at most kRows kMaxC / (128 kConsumers) = 5 floats a thread, loaded together
      constexpr int kPer = (kRows * kMaxC + 128 * kConsumers - 1) / (128 * kConsumers);
      const int n = (min(N, first_row + kRows) - first_row) * C;
      float x[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = threadIdx.x + u * 128 * kConsumers;
        x[u] = i < n ? __ldg(z + int64_t(first_row) * C + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = threadIdx.x + u * 128 * kConsumers, r = i / C, c = i - r * C;
        if (i >= n) break;
        z_rows[i] = x[u];
#pragma unroll
        for (int p = 0; p < 3; ++p) z_parts[(3 * r + p) * C + c] = split_part(-2.f * x[u], p);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
    const int lane = t % 32, g = lane / 4, t4 = lane % 4;
    // row of m-tile mt, half h (+ 8 h)
    const int row0 = first_row + wg * kMTiles * 64 + (t / 32) * 16 + g;
    // z's packed rows as wgmma's A: register j of k step kk holds columns 16
    // kk + 8 (j / 2) + 2 t4, + 1 of row (j even) or row + 8; rows past N zero.
    // The thread's 4 kSteps columns are the same in every row: where each
    // reads its value in a row's parts (or that it holds a 1 against e_sq,
    // or a 0) is worked out once.
    constexpr int kCols = 4 * kSteps;  // column q: 16 (q / 4) + 8 (q / 2 % 2) + 2 t4 + q % 2
    int at[kCols];                     // the part's offset in the row's 3 C; -1: a 1, -2: a 0
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int col = 16 * (q / 4) + 8 * (q / 2 % 2) + 2 * t4 + q % 2, span = col / C;
      at[q] = col < 6 * C ? int((kZSpans >> (2 * span)) & 3) * C + col - span * C
                          : col < 6 * C + 3 ? -1 : -2;
    }
    uint32_t a[kMTiles][kSteps][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 64 + 8 * h;
        const __nv_bfloat16* parts = z_parts + (min(row, N - 1) - first_row) * 3 * C;
        uint32_t v[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const uint32_t b = at[q] >= 0 ? __bfloat16_as_ushort(parts[max(at[q], 0)])
                             : at[q] == -1 ? 0x3f80u  // bf16 1.0
                                           : 0u;
          v[q] = row < N ? b : 0u;
        }
        // register j of k step kk: columns q = 4 kk + 2 (j / 2), + 1 of row h = j % 2
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          a[mt][kk][h] = v[4 * kk] | (v[4 * kk + 1] << 16);
          a[mt][kk][h + 2] = v[4 * kk + 2] | (v[4 * kk + 3] << 16);
        }
      }
    }
    float best_v[kMTiles][2];
    int best_i[kMTiles][2];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      best_v[mt][0] = best_v[mt][1] = INFINITY;
      best_i[mt][0] = best_i[mt][1] = INT_MAX;
    }

    // per tile and m-tile: the products, then each row's minimum over this
    // thread's 32 columns and, where it beats the running best, the tile
    float acc[64];
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q] = 0.f;
    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t tile = smem_u32(smem + s * kTileBytes);
      const int code0 = (tile0 + i) * kTileCodes, live = K - code0;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        tile_products<kSteps>(acc, a[mt], tile);
        muse::sm90::wgmma_wait<0>();
        muse::sm90::fence_accumulators<64>(acc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m = live >= kTileCodes ? tile_min<false>(acc, h, t4, live)
                                             : tile_min<true>(acc, h, t4, live);
          if (m < best_v[mt][h]) {  // strict: the earlier tile keeps an exact tie
            best_v[mt][h] = m;
            best_i[mt][h] = code0;
          }
        }
      }
      mbar_arrive(&empty[s]);
    }
    // each row: the quad's lowest (score, tile), then its column among the
    // tied lanes' 32 columns of that tile, scored again (tile_columns); all
    // of the thread's rows at once, so that their shuffles and loads overlap
    constexpr int kSlots = 2 * kMTiles;  // slot mt * 2 + h: row row0 + mt * 64 + 8 h
    float v[kSlots];
    int tile[kSlots];
    unsigned lanes[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      v[j] = best_v[j / 2][j % 2];
      tile[j] = best_i[j / 2][j % 2];  // the first code of this thread's best tile
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const float ov = __shfl_xor_sync(0xffffffffu, v[j], off);
        const int ot = __shfl_xor_sync(0xffffffffu, tile[j], off);
        if (ov < v[j] || (ov == v[j] && ot < tile[j])) {
          v[j] = ov;
          tile[j] = ot;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      // the lanes of the quad whose best is the row's (their scores equal)
      const bool tied = best_v[j / 2][j % 2] == v[j] && best_i[j / 2][j % 2] == tile[j] &&
                        tile[j] < K;
      lanes[j] = (__ballot_sync(0xffffffffu, tied) >> (lane & ~3)) & 0xfu;
      if (tile[j] >= K) tile[j] = code_first;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // the range's codes
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
    int id[kSlots];
    tile_columns<kSlots>(z_rows, first_row, row0, N, codes, C, K, code_first, tile, t4, lanes, id);
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int row = row0 + (j / 2) * 64 + 8 * (j % 2);
      if (t4 != 0 || row >= N) continue;
      if (gridDim.x == 1)
        ids[row] = id[j] < K ? id[j] : -1;
      else if (id[j] < K)
        atomicMin(best + row, (static_cast<unsigned long long>(order_key(v[j])) << 32) |
                                  static_cast<uint32_t>(id[j]));
    }
  }
  if (gridDim.x == 1) return;

  // over several ranges: the row block's last block unpacks its ids (the
  // consumers' threads, named barrier 1)
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  if (threadIdx.x == 0) {
    unsigned int* count = reinterpret_cast<unsigned int*>(best + N + blockIdx.y);
    last_block = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
  if (!last_block) return;
  __threadfence();
  for (int r = threadIdx.x; r < kRows; r += 128 * kConsumers) {
    const int row = blockIdx.y * kRows + r;
    if (row < N) ids[row] = static_cast<int>(__ldcg(best + row) & 0xffffffffull);
  }
}

int pack_blocks(int64_t items) {
  return int(std::max<int64_t>(1, std::min<int64_t>((items + 255) / 256,
                                                    8 * muse::sm90::sm_count())));
}

template <int kSteps>
cudaError_t launch_kernel(const CUtensorMap& map, const float* z, const float* cb, int N, int C,
                          int K, int ranges, int per, unsigned long long* best, int* ids,
                          cudaStream_t stream) {
  auto kernel = vq_narrow_kernel<kSteps>;
  static const cudaError_t configured =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (configured != cudaSuccess) return configured;
  const int bytes = 1024 + kCodeOffset + per * kTileCodes * 4 * C;
  kernel<<<dim3(ranges, row_blocks(N, C)), kThreads, bytes, stream>>>(map, z, cb, N, C, K, per,
                                                                       best, ids);
  return cudaGetLastError();
}

// z (N, C), cb (K, C) fp32; cbp (K, width(C)) bf16 and best (N + row
// blocks) 64-bit scratch; ids (N,) int32 out.  Two launches.
cudaError_t launch(const float* z, const float* cb, int N, int C, int K, __nv_bfloat16* cbp,
                   unsigned long long* best, int* ids, cudaStream_t stream) {
  const int W = width(C), blocks = row_blocks(N, C), tiles = (K + kTileCodes - 1) / kTileCodes;
  // as many code ranges as fill the card's SMs with the row blocks (and as
  // their codes fit shared memory), none empty
  int ranges = std::max(1, std::min(tiles, muse::sm90::sm_count() / blocks));
  ranges = std::max(ranges, (tiles + max_range_tiles(C) - 1) / max_range_tiles(C));
  const int per = (tiles + ranges - 1) / ranges;
  ranges = (tiles + per - 1) / per;
  const int init = ranges > 1 ? N + blocks : 0;
  vq_pack_kernel<<<pack_blocks(int64_t(K) * W / 8 + init), 256, 0, stream>>>(cb, K, C, W, cbp,
                                                                             best, N, init);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap map;
  err = muse::sm90::tensor_map(&map, cbp, K, W, kTileCodes);
  if (err != cudaSuccess) return err;
  return W == 32 ? launch_kernel<2>(map, z, cb, N, C, K, ranges, per, best, ids, stream)
                 : launch_kernel<4>(map, z, cb, N, C, K, ranges, per, best, ids, stream);
}

}  // namespace narrow

// The route of (N, C, K) and its scratch, in elements: scratch[0] bf16 of
// z' and scratch[1] of cb' (the split route: N x 3 Cp and Kp x 3 Cp; the
// narrow route: none and K x width(C)), scratch[2] 64-bit of best (N; the
// narrow route adds a counter a row block of rows_per_block(C)).  Returns 1 for the
// narrow route, 0 for the split route, -1 for an empty shape.
extern "C" int muse_vq_route(int N, int C, int K, long long* scratch) {
  if (N <= 0 || K <= 0 || C <= 0) return -1;
  if (narrow::takes(C)) {
    scratch[0] = 0;
    scratch[1] = static_cast<long long>(K) * narrow::width(C);
    scratch[2] = static_cast<long long>(N) + narrow::row_blocks(N, C);
    return 1;
  }
  const long long Cp = (C + 63) / 64 * 64, Kp = (K + 1) / 2 * 2;
  scratch[0] = N * 3 * Cp;
  scratch[1] = Kp * 3 * Cp;
  scratch[2] = N;
  return 0;
}

// The narrow route's codebook pass alone: cb (K, C) fp32 -> cbp (K,
// width(C)) bf16; C up to narrow::kMaxC.
extern "C" int muse_vq_pack(const float* cb, int K, int C, void* cbp, void* stream_ptr) {
  if (K <= 0 || !narrow::takes(C)) return int(cudaErrorInvalidValue);
  const int W = narrow::width(C);
  narrow::vq_pack_kernel<<<narrow::pack_blocks(int64_t(K) * W / 8), 256, 0,
                           static_cast<cudaStream_t>(stream_ptr)>>>(
      cb, K, C, W, static_cast<__nv_bfloat16*>(cbp), nullptr, 0, 0);
  return int(cudaGetLastError());
}

// The split pass alone: z (N, C), cb (K, C) fp32 -> zp (N, 3 Cp), cbp (Kp, 3
// Cp) bf16, Cp = C rounded up to a multiple of 64, Kp = K rounded up to even.
extern "C" int muse_vq_split(const float* z, const float* cb, int N, int C, int K, void* zp,
                             void* cbp, void* stream_ptr) {
  if (N <= 0 || K <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  const int Cp = (C + 63) / 64 * 64, Kp = (K + 1) / 2 * 2;
  vq_split_kernel<<<split_blocks(N, Kp, Cp), 256, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      z, cb, N, C, K, Kp, Cp, static_cast<__nv_bfloat16*>(zp), static_cast<__nv_bfloat16*>(cbp));
  return int(cudaGetLastError());
}

// z (N, C), cb (K, C) fp32 contiguous; the scratch muse_vq_route gives for
// (N, C, K): zp and cbp bf16, best 64-bit; ids: (N,) int32 out.  The split
// route also takes e_sq (K,) = |cb[k]|^2 in fp32 (the narrow route computes
// it in its pack pass and ignores the argument).
extern "C" int muse_vq_argmin(const float* z, const float* cb, const float* e_sq, int N, int C,
                              int K, void* zp, void* cbp, unsigned long long* best, int* ids,
                              void* stream_ptr) {
  using bf = __nv_bfloat16;
  if (N <= 0 || K <= 0 || C <= 0) return int(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (narrow::takes(C))
    return int(narrow::launch(z, cb, N, C, K, static_cast<bf*>(cbp), best, ids, stream));
  const int Cp = (C + 63) / 64 * 64, Kp = (K + 1) / 2 * 2;
  cudaError_t err = cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * size_t(N), stream);
  if (err != cudaSuccess) return int(err);
  int status = muse_vq_split(z, cb, N, C, K, zp, cbp, stream_ptr);
  if (status != 0) return status;
  const VqArgminEpilogue epi{e_sq, K, best, Cp, kParts * Cp};
  err = muse::sm90::gemm_tn(static_cast<const bf*>(zp), static_cast<const bf*>(cbp), epi, N, Kp,
                            6 * Cp, stream);
  if (err != cudaSuccess) return int(err);
  unpack_ids<<<(N + 255) / 256, 256, 0, stream>>>(best, N, ids);
  return int(cudaGetLastError());
}
