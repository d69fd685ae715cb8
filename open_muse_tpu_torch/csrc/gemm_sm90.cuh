// Hopper GEMM mainloop for the port's kernels: TMA, wgmma, mbarriers and
// warp specialisation, for sm_90a.
//
//   C[m, n] = epilogue(sum_k A[m, k] * W[n, k])     (gemm_tn:  A kMK, W kNK)
//   C[m, n] = epilogue(sum_k A[m, k] * W[k, n])     (gemm_nn:  A kMK, W kKN)
//   C[m, n] = epilogue(sum_k A[k, m] * W[k, n])     (gemm_tnn: A kKM, W kKN)
//                                                   bf16 x bf16 -> fp32
//
// A is (M, K) rows, K-major, or (K, M) rows, MN-major (the g of a weight
// gradient g^T h, summed over its rows).  W is a torch nn.Linear weight (N,
// K) read as it lies: K-major for a @ W^T (the forward projections),
// MN-major for g @ W (the backward's data gradients, where K runs along the
// weight's rows) and for the h of g^T h.  An MN-major operand is no copy:
// its TMA boxes are taken along M or N (64 columns, one 128-byte swizzle
// row, by 64 k rows; 8 KB a box), and wgmma reads them with its transpose
// flag for that operand, the descriptor's leading byte offset the 8 KB
// between boxes along M or N and its stride byte offset the 1024 between
// 8-row groups along K.  One design, fixed at compile time per layout pair.
//
// Design, for the port's products (512 - 4096 rows, N 1024 - 3072, K 1024 -
// 4096; 0.5 - 26 GFLOP):
// - A block owns a 128 x kBN output tile (kBN 64, 128 or 256) and walks K in
//   steps of 64 (128 bytes of bf16, one 128-byte swizzle row).  Three
//   warpgroups: the last is the producer, whose first thread keeps a ring of
//   kStages shared-memory stages filled by TMA (A's 128 x 64 tile as one box
//   of 64 k x 128 rows, K-major, or two boxes of 64 m x 64 k rows, one a
//   consumer, MN-major; W's kBN x 64 tile as one box or kBN / 64 boxes; the
//   hardware's 128-byte swizzle, completion counted in bytes on the stage's
//   `full` mbarrier); the first two are consumers, each issuing
//   wgmma.mma_async m64nNk16 (N = kBN) for its 64 rows of the tile with kBN /
//   2 fp32 accumulators a thread in registers, one k step's group kept in
//   flight while the next is issued, and releasing a stage on its `empty`
//   mbarrier once the products that read it are done.  No setmaxnreg: at
//   most 128 accumulators a thread fit the register file at one block an SM.
// - Ragged shapes: TMA fills the boxes past M, N and K with zeros, and the
//   epilogue masks the rows past M and the columns past N.  Each operand's
//   row pitch a multiple of 16 bytes (K a multiple of 8 for a K-major
//   operand, M or N for an MN-major one), N even, 16-byte aligned pointers.
// - Filling the card (variant_for): wide tiles when there are rows enough
//   (the training shapes: 256, fewer L2 re-reads of A), narrow ones at 512
//   rows, where a 1024-wide product is 32 tiles of 128 x 128 for 132 SMs;
//   there K may be split over a cluster of 2 blocks along grid z.  Each
//   block then writes its fp32 partial tile over its own drained stages;
//   after a cluster barrier block r sums rows [r BM / split, (r + 1) BM /
//   split) of the tile over the blocks' partials, read through distributed
//   shared memory in rank order, and stores them.  No atomics: two calls are
//   bit-equal.
// - The epilogue is a functor: `store2(row, col, v0, v1)` for two
//   neighbouring fp32 outputs of a row (col even), `store1` for a last odd
//   one (StoreBf16 below rounds to bf16).  One that declares kStaged true
//   gets instead the whole fp32 tile in shared memory, over the drained
//   stages, and every thread of the block: `tile<BM, kBN, ld,
//   threads>(tile, m0, n0, M, N)`, for an epilogue that reads operands of
//   its own (glu_matmul.cu's, which turns dh into da, db and h with 16-byte
//   row loads, several in flight a thread).  Such an epilogue takes no K
//   split.  One that declares kRemapK true also chooses, for each k step of
//   the product, which columns of A and of W it reads (`k_a(k)`, `k_w(k)`,
//   the operands `k_extent` columns wide): vq_argmin.cu's six part products
//   read three bf16 parts of each K-major operand.
// - The host builds both tensor maps (cuTensorMapEncodeTiled, reached
//   through cudaGetDriverEntryPoint, so nothing links against libcuda) on
//   every call from the pointers it is given, and passes them by value as
//   __grid_constant__ parameters: a captured CUDA graph replays with the
//   buffers of the captured call.
//
// Bound on the H100: at the serving shapes (512 rows) a product is 0.5 - 3
// GFLOP against 2 - 9 MB of operands, 0.6 - 3 us at the card's peak rates;
// the tile walk re-reads A and W panels from L2 (N / kBN and M / 128 times),
// and each launch costs ~2.5 us of its own in a graph replay.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace muse {

// Epilogue: C rounded to bf16, row-major with leading dimension `ldc`.
struct StoreBf16 {
  static constexpr bool kStaged = false;
  __nv_bfloat16* c;
  int64_t ldc;
  __device__ __forceinline__ void store2(int r, int col, float v0, float v1) const {
    *reinterpret_cast<__nv_bfloat162*>(c + r * ldc + col) = __floats2bfloat162_rn(v0, v1);
  }
  __device__ __forceinline__ void store1(int r, int col, float v) const {
    c[r * ldc + col] = __float2bfloat16_rn(v);
  }
};

namespace sm90 {

constexpr int BM = 128, BK = 64;  // tile rows, k step (128 bytes of bf16)
constexpr int kConsumers = 2;      // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 4;
constexpr int kMaxSplit = 4;

// whether an epilogue remaps the k coordinate of the operands' tiles
template <class E, class = void>
struct RemapsK : std::false_type {};
template <class E>
struct RemapsK<E, std::void_t<decltype(E::kRemapK)>> : std::bool_constant<E::kRemapK> {};

// the layout of A: (M, K), read K-major, or (K, M), read MN-major (C = A^T W)
enum ALayout { kMK = 0, kKM = 1 };
// the layout of W: nn.Linear's (N, K), read K-major (C = A W^T), or (K, N),
// read MN-major (C = A W)
enum WLayout { kNK = 0, kKN = 1 };

// the shared memory of a tile width: kStages stages of A (BM x BK) and W
// (kBN x BK), 1024-byte aligned; after the k loop the fp32 partial tile of a
// split product reuses them
template <int kBN>
struct Smem {
  static constexpr int kTileA = BM * BK * 2, kTileW = kBN * BK * 2;
  static constexpr int kStageBytes = kTileA + kTileW;
  static constexpr int kRedLd = kBN + 8;  // floats a row of the partial tile
  static_assert(BM * kRedLd * 4 <= kStages * kStageBytes, "the partial tile fits the stages");
  static constexpr int kBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// -- TMA and wgmma --------------------------------------------------------------

// one box of a 2-D tensor map into shared memory; c0 the contiguous
// coordinate, completion counted on `bar` in bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride byte
// offset); the leading byte offset is unused in this layout.  A k step of 16
// elements inside the 128-byte row is a start address 32 bytes further on.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// the same for an MN-major operand staged as boxes of 64 k rows x 128 bytes
// (64 m or n) in the 128-byte swizzle: 64-column groups along M or N
// kBoxBytes apart (the leading byte offset), 8-row groups along K 1024 bytes
// apart (the stride byte offset).  A k step of 16 rows is a start address
// 2048 bytes further on.
constexpr int kBoxBytes = BK * 128;  // one 64 x 64 bf16 box

__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(kBoxBytes >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>  // until at most kPending committed groups are in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// keeps the compiler from touching the accumulators across an asynchronous
// product
template <int kCount>
__device__ __forceinline__ void fence_accumulators(float* d) {
#pragma unroll
  for (int i = 0; i < kCount; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x kN, fp32, accumulated) += A (64 x 16) B (kN x 16)^T, both bf16 in
// 128-byte-swizzled shared memory, each K-major (kTrans 0) or MN-major (1);
// d is this thread's kN / 2 accumulators (see the epilogue for their rows
// and columns)

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kN, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  if constexpr (kN == 64) wgmma_m64n64k16<kTransA, kTransB>(d, desc_a, desc_b);
  else if constexpr (kN == 128) wgmma_m64n128k16<kTransA, kTransB>(d, desc_a, desc_b);
  else wgmma_m64n256k16<kTransA, kTransB>(d, desc_a, desc_b);
}

// -- the kernel ---------------------------------------------------------------

// Grid (ceil(N / kBN), ceil(M / BM), split), launched as clusters of (1, 1,
// split).  map_a: A (M, K) in 64 x BM boxes (kMK) or A (K, M) in 64 x 64
// boxes, two a stage (kKM); map_w: W (N, K) in 64 x kBN boxes (kNK) or W (K,
// N) in 64 x 64 boxes, kBN / 64 of them a stage (kKN).
template <int kBN, ALayout kA, WLayout kW, class Epilogue>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_w, Epilogue epi, int M, int N, int K) {
  namespace cg = cooperative_groups;
  using L = Smem<kBN>;
  constexpr int kAcc = kBN / 2;  // accumulators a consumer thread
  extern __shared__ __align__(1024) unsigned char gemm_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: stages start on that grain
  unsigned char* smem = gemm_smem + ((1024 - (smem_u32(gemm_smem) & 1023)) & 1023);
  unsigned char* stage_a = smem;
  unsigned char* stage_w = smem + kStages * L::kTileA;
  float* red = reinterpret_cast<float*>(smem);  // after the k loop
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * L::kStageBytes);
  uint64_t* empty = full + kStages;

  const int split = gridDim.z;
  const int rank = blockIdx.z;  // the block's rank in its cluster of split blocks along z
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int k_steps = (K + BK - 1) / BK;
  const int per = (k_steps + split - 1) / split;
  const int kb0 = min(k_steps, rank * per), kb1 = min(k_steps, kb0 + per);
  const int steps = kb1 - kb0;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[kAcc];
  if (wg == kConsumers) {
    // producer: one thread keeps the stages filled
    if (t == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
        mbar_expect_tx(&full[s], L::kStageBytes);
        const int k = (kb0 + i) * BK;
        int ka = k, kw = k;
        if constexpr (RemapsK<Epilogue>::value) {
          ka = epi.k_a(k);
          kw = epi.k_w(k);
        }
        if constexpr (kA == kMK) {
          tma_load_2d(stage_a + s * L::kTileA, &map_a, &full[s], ka, m0);
        } else {
#pragma unroll
          for (int j = 0; j < BM / 64; ++j)
            tma_load_2d(stage_a + s * L::kTileA + j * kBoxBytes, &map_a, &full[s], m0 + 64 * j, ka);
        }
        if constexpr (kW == kNK) {
          tma_load_2d(stage_w + s * L::kTileW, &map_w, &full[s], kw, n0);
        } else {
#pragma unroll
          for (int j = 0; j < kBN / 64; ++j)
            tma_load_2d(stage_w + s * L::kTileW + j * kBoxBytes, &map_w, &full[s], n0 + 64 * j, kw);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows wg * 64 .. + 63 of the tile (the
    // same 8 KB into the stage in either layout of A)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t a = smem_u32(stage_a + s * L::kTileA + wg * 64 * BK * 2);
      const uint32_t w = smem_u32(stage_w + s * L::kTileW);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 along K: 32 bytes on K-major, 2048 MN-major
        wgmma_m64k16<kBN, kA, kW>(acc,
                                  kA == kMK ? smem_desc(a + kk * 32) : smem_desc_mn(a + kk * 2048),
                                  kW == kNK ? smem_desc(w + kk * 32) : smem_desc_mn(w + kk * 2048));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: release its stage
      if (i > 0) mbar_arrive(&empty[(i - 1) % kStages]);
    }
    wgmma_wait<0>();
    fence_accumulators<kAcc>(acc);
  }

  // accumulator i of a consumer thread: row wg * 64 + 16 (t / 32) + (t % 32) / 4
  // (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (t % 4) + i % 2
  const int row0 = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col0 = 2 * (t % 4);
  if constexpr (!Epilogue::kStaged) {
    if (split == 1) {
      if (wg == kConsumers) return;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + row0 + 8 * h, c = n0 + 8 * j + col0;
          if (r >= M) continue;
          if (c + 1 < N) epi.store2(r, c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          else if (c < N) epi.store1(r, c, acc[4 * j + 2 * h]);
        }
      }
      return;
    }
  }

  // the fp32 tile through shared memory: every stage has been read by now,
  // and the tile takes their place
  __syncthreads();
  if (wg < kConsumers) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(&red[(row0 + 8 * h) * L::kRedLd + 8 * j + col0]) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  if constexpr (Epilogue::kStaged) {  // the whole tile to the epilogue (split 1)
    __syncthreads();
    epi.template tile<BM, kBN, L::kRedLd, kThreads>(red, m0, n0, M, N);
  } else {
    // split K: partial tiles through distributed shared memory, summed in
    // rank order
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rows = BM / split;
    for (int idx = threadIdx.x; idx < rows * (kBN / 2); idx += kThreads) {
      const int r = rank * rows + idx / (kBN / 2), c = 2 * (idx % (kBN / 2));
      float2 sum = make_float2(0.f, 0.f);
      for (int q = 0; q < split; ++q) {
        const float* part = cluster.map_shared_rank(red, q);
        const float2 v = *reinterpret_cast<const float2*>(part + r * L::kRedLd + c);
        sum.x += v.x;
        sum.y += v.y;
      }
      const int gr = m0 + r, gc = n0 + c;
      if (gr >= M) continue;
      if (gc + 1 < N) epi.store2(gr, gc, sum.x, sum.y);
      else if (gc < N) epi.store1(gr, gc, sum.x);
    }
    cluster.sync();  // no block leaves while another still reads its partial tile
  }
}

// -- host ----------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (rows, cols) bf16 rows, cols contiguous, in boxes of 64 columns x box_rows
// rows with the 128-byte swizzle; zeros past the edges
inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {cuuint32_t(BK), cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
  static const int n = [] {
    int device = 0, count = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    return count > 0 ? count : 132;
  }();
  return n;
}

inline int tiles(int M, int N, int bn) { return ((M + BM - 1) / BM) * ((N + bn - 1) / bn); }

// The variant rule, chosen on the shape before the launch from a sweep of
// every tile width and split at the paths' shapes (PERF.md): the widest tile
// that still gives the card enough blocks, and a K split of 2 only for the
// narrow tile when that still fits one wave with four k steps a block or
// more (a cluster's split costs a few microseconds of its own, so 4 never
// paid).  One rule for every layout: at the GLU's dwo (1024, 2816, 4096),
// A and W MN-major, its 88 blocks of 128 x 256 beat both 128-wide tiles and
// a K split of 2 (PERF.md).  Writes (bn, split).
inline void variant_for(int M, int N, int K, int* bn, int* split) {
  const int sms = sm_count(), k_steps = (K + BK - 1) / BK;
  *split = 1;
  if (2 * tiles(M, N, 256) >= sms) {
    *bn = 256;
  } else if (10 * tiles(M, N, 128) >= 7 * sms) {
    *bn = 128;
  } else {
    *bn = 64;
    if (2 * tiles(M, N, 64) <= sms && k_steps >= 8) *split = 2;
  }
}

// the operands' extent along K: K, or the remapping epilogue's
template <class Epilogue>
int k_extent(const Epilogue& epi, int K) {
  if constexpr (RemapsK<Epilogue>::value) return epi.k_extent;
  return K;
}

template <int kBN, ALayout kA, WLayout kW, class Epilogue>
cudaError_t launch(const __nv_bfloat16* a, const __nv_bfloat16* w, const Epilogue& epi, int M,
                   int N, int K, int split, cudaStream_t stream) {
  CUtensorMap map_a, map_w;
  const int kx = k_extent(epi, K);
  cudaError_t err = kA == kMK ? tensor_map(&map_a, a, M, kx, BM) : tensor_map(&map_a, a, kx, M, BK);
  if (err != cudaSuccess) return err;
  err = kW == kNK ? tensor_map(&map_w, w, N, kx, kBN) : tensor_map(&map_w, w, kx, N, BK);
  if (err != cudaSuccess) return err;
  auto kernel = wgmma_gemm_kernel<kBN, kA, kW, Epilogue>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<kBN>::kBytes);
  if (configured != cudaSuccess) return configured;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((N + kBN - 1) / kBN, (M + BM - 1) / BM, split);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = Smem<kBN>::kBytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, map_a, map_w, epi, M, N, K);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <ALayout kA, WLayout kW, class Epilogue>
cudaError_t dispatch(const __nv_bfloat16* a, const __nv_bfloat16* w, const Epilogue& epi, int M,
                     int N, int K, cudaStream_t stream, int bn, int split) {
  // each operand's row pitch a multiple of 16 bytes (the tensor maps), N even
  const int kx = k_extent(epi, K);
  const bool pitch_a = kA == kMK ? kx % 8 == 0 : M % 8 == 0;
  const bool pitch_w = kW == kNK ? kx % 8 == 0 && N % 2 == 0 : N % 8 == 0;
  if (M <= 0 || N <= 0 || K <= 0 || !pitch_a || !pitch_w || split < 0 || split > kMaxSplit ||
      (bn == 0) != (split == 0))
    return cudaErrorInvalidValue;
  const bool by_rule = bn == 0;
  if (by_rule) variant_for(M, N, K, &bn, &split);
  if (Epilogue::kStaged && split > 1) {  // the tile goes to the epilogue whole: no K split
    if (!by_rule) return cudaErrorInvalidValue;
    split = 1;
  }
  switch (bn) {
    case 64: return launch<64, kA, kW>(a, w, epi, M, N, K, split, stream);
    case 128: return launch<128, kA, kW>(a, w, epi, M, N, K, split, stream);
    case 256: return launch<256, kA, kW>(a, w, epi, M, N, K, split, stream);
    default: return cudaErrorInvalidValue;
  }
}

// C = epilogue(A (M, K) x W^T) with W an nn.Linear weight (N, K); K a
// multiple of 8, N even, pointers 16-byte aligned.  bn, the tile width, is
// 64, 128 or 256 and split 1, 2 or 4; 0 for both takes variant_for.
// Returns the launch's error.
template <class Epilogue>
cudaError_t gemm_tn(const __nv_bfloat16* a, const __nv_bfloat16* w, const Epilogue& epi, int M,
                    int N, int K, cudaStream_t stream, int bn = 0, int split = 0) {
  return dispatch<kMK, kNK>(a, w, epi, M, N, K, stream, bn, split);
}

// C = epilogue(A (M, K) x W) with W (K, N) rows, N contiguous (an nn.Linear
// weight (out, in) with K = out: g @ W); K and N multiples of 8, pointers
// 16-byte aligned; bn and split as gemm_tn's.
template <class Epilogue>
cudaError_t gemm_nn(const __nv_bfloat16* a, const __nv_bfloat16* w, const Epilogue& epi, int M,
                    int N, int K, cudaStream_t stream, int bn = 0, int split = 0) {
  return dispatch<kMK, kKN>(a, w, epi, M, N, K, stream, bn, split);
}

// C = epilogue(A^T W) with A given as a_t (K, M) rows and W (K, N) rows,
// both MN-major: a weight gradient g^T h summed over the K rows of g (K, M)
// and h (K, N); M and N multiples of 8, K any, pointers 16-byte aligned; bn
// and split as gemm_tn's.
template <class Epilogue>
cudaError_t gemm_tnn(const __nv_bfloat16* a_t, const __nv_bfloat16* w, const Epilogue& epi, int M,
                     int N, int K, cudaStream_t stream, int bn = 0, int split = 0) {
  return dispatch<kKM, kKN>(a_t, w, epi, M, N, K, stream, bn, split);
}

}  // namespace sm90
}  // namespace muse
