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
// Replaces the Pallas TPU kernels open_muse_tpu/ops/pallas/attn_sublayer.py
// `attn_sublayer_self` (body `_self_kernel`) and `attn_sublayer_cross` (body
// `_cross_kernel`), with the precision staging of their oracles
// `_xla_ref_self` / `_xla_ref_cross`.
//
// What bounds it on the H100: at the serving shape (2 x 256 rows, hidden
// 1024, 16 heads of 64, 77 text keys) each sublayer moves ~8 MB of weights
// and ~5 MB of activations for ~4 GFLOP; the TPU kernel's grid of one cell
// per batch element would put 2 blocks on 132 SMs.
//
// What the design does about it: a chain of four launches on one stream, each
// with enough blocks to fill the card -- a row kernel (one block per row), the
// shared tiled GEMM (64 x 64 tiles), an attention kernel with one block per
// (batch, head, 64-query tile), and the GEMM again.  The attention kernel
// streams keys in tiles of 64: a first pass takes each row's max and sum, a
// second writes normalised bf16 probabilities and accumulates PV, so any key
// length fits in shared memory; key columns >= kv_len are masked in the
// kernel instead of padding kv.  Fusing the chain into fewer launches is left
// for later work.
#include <cfloat>
#include <cmath>

#include "gemm_tile.cuh"

namespace {

constexpr int kRowThreads = 256;
using kProjTile = muse::GemmTile<64, 64>;  // BN 64, BK 64

// h = x + res; a = adaln(rmsnorm(h)), one block per row.
__global__ void __launch_bounds__(kRowThreads)
rmsnorm_adaln_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ res,
                     const __nv_bfloat16* __restrict__ ln, const __nv_bfloat16* __restrict__ adaln,
                     __nv_bfloat16* __restrict__ h_out, __nv_bfloat16* __restrict__ a_out, int S,
                     int D, float eps) {
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
    inv_rms = __bfloat162float(__float2bfloat16_rn(rsqrtf(total / float(D) + eps)));
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

constexpr int kHeadDim = 64;
constexpr int kQTile = 64;   // query rows per block, 16 per warp
constexpr int kKTile = 64;   // keys per streamed tile
constexpr int kAttnThreads = 128;
constexpr int kLdh = kHeadDim + 8;  // bf16 per shared row
constexpr int kLdf = kKTile + 4;    // fp32 per shared logits row
constexpr size_t kAttnSmem = sizeof(__nv_bfloat16) * (kQTile + 2 * kKTile) * kLdh +
                             sizeof(float) * kQTile * kLdf +
                             sizeof(__nv_bfloat16) * kQTile * kLdh;

struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  int64_t q_bs, q_rs;    // batch / row strides of q (elements)
  int64_t kv_bs, kv_rs;  // batch / row strides of k and v
  int64_t o_bs, o_rs;
  int S, L, kv_len;
  float scale;
};

__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t row_stride, int rows_valid) {
  // 64 rows x 64 bf16 = 512 chunks of 16 B over 128 threads
  for (int c = threadIdx.x; c < 64 * (kHeadDim / 8); c += kAttnThreads) {
    const int r = c / (kHeadDim / 8);
    const int col = (c % (kHeadDim / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * kLdh + col) = val;
  }
}

// One block per (query tile, head, batch); warp w owns query rows 16w..16w+15.
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(AttnArgs p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kQTile * kLdh;
  __nv_bfloat16* Vs = Ks + kKTile * kLdh;
  float* Sf = reinterpret_cast<float*>(Vs + kKTile * kLdh);
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(Sf + kQTile * kLdf);

  const int q0 = blockIdx.x * kQTile;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* qb = p.q + batch * p.q_bs + q0 * p.q_rs + head * kHeadDim;
  const __nv_bfloat16* kb = p.k + batch * p.kv_bs + head * kHeadDim;
  const __nv_bfloat16* vb = p.v + batch * p.kv_bs + head * kHeadDim;

  load_tile(Qs, qb, p.q_rs, min(kQTile, p.S - q0));
  __syncthreads();

  float* Sw = Sf + warp * 16 * kLdf;            // this warp's 16 x 64 logits
  __nv_bfloat16* Pw = Pb + warp * 16 * kLdh;    // and its bf16 probabilities
  const int my_row = lane / 2;                  // two lanes per logits row
  const int my_col0 = (lane % 2) * (kKTile / 2);

  // logits of this warp's 16 rows against the current key tile -> Sw (unscaled)
  auto tile_logits = [&]() {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fq[kHeadDim / 16];
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wmma::load_matrix_sync(fq[kk], Qs + warp * 16 * kLdh + kk * 16, kLdh);
#pragma unroll
    for (int j = 0; j < kKTile / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fk;
        wmma::load_matrix_sync(fk, Ks + j * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(acc, fq[kk], fk, acc);
      }
      wmma::store_matrix_sync(Sw + j * 16, acc, kLdf, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // pass 1: row max and sum of exp over all unmasked keys
  float m = -INFINITY, s = 0.f;
  for (int k0 = 0; k0 < p.L; k0 += kKTile) {
    load_tile(Ks, kb + k0 * p.kv_rs, p.kv_rs, min(kKTile, p.L - k0));
    __syncthreads();
    tile_logits();
    float tmax = -INFINITY;
    for (int c = 0; c < kKTile / 2; ++c) {
      const int key = k0 + my_col0 + c;
      if (key < p.kv_len) tmax = fmaxf(tmax, Sw[my_row * kLdf + my_col0 + c] * p.scale);
    }
    if (tmax > -INFINITY) {
      const float new_m = fmaxf(m, tmax);
      float add = 0.f;
      for (int c = 0; c < kKTile / 2; ++c) {
        const int key = k0 + my_col0 + c;
        if (key < p.kv_len) add += expf(Sw[my_row * kLdf + my_col0 + c] * p.scale - new_m);
      }
      s = (m > -INFINITY ? s * expf(m - new_m) : 0.f) + add;
      m = new_m;
    }
    __syncthreads();
  }
  {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, 1);
    const float s_o = __shfl_xor_sync(0xffffffffu, s, 1);
    const float mm = fmaxf(m, m_o);
    s = (m > -INFINITY ? s * expf(m - mm) : 0.f) + (m_o > -INFINITY ? s_o * expf(m_o - mm) : 0.f);
    m = mm;
  }

  // pass 2: probabilities in bf16, PV accumulated in fp32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[kHeadDim / 16];
#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j) wmma::fill_fragment(acc_o[j], 0.f);
  for (int k0 = 0; k0 < p.L; k0 += kKTile) {
    const int valid = min(kKTile, p.L - k0);
    load_tile(Ks, kb + k0 * p.kv_rs, p.kv_rs, valid);
    load_tile(Vs, vb + k0 * p.kv_rs, p.kv_rs, valid);
    __syncthreads();
    tile_logits();
    for (int c = 0; c < kKTile / 2; ++c) {
      const int col = my_col0 + c;
      const int key = k0 + col;
      float prob = 0.f;
      if (key < p.kv_len) prob = expf(Sw[my_row * kLdf + col] * p.scale - m) / s;
      Pw[my_row * kLdh + col] = __float2bfloat16_rn(prob);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fp;
      wmma::load_matrix_sync(fp, Pw + kk * 16, kLdh);
#pragma unroll
      for (int j = 0; j < kHeadDim / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, Vs + kk * 16 * kLdh + j * 16, kLdh);
        wmma::mma_sync(acc_o[j], fp, fv, acc_o[j]);
      }
    }
    __syncthreads();
  }

  // fp32 -> bf16 through this warp's logits buffer
#pragma unroll
  for (int j = 0; j < kHeadDim / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, acc_o[j], kLdf, wmma::mem_row_major);
  __syncwarp();
  __nv_bfloat16* ob = p.out + batch * p.o_bs + head * kHeadDim;
  for (int idx = lane; idx < 16 * kHeadDim / 2; idx += 32) {
    const int r = idx / (kHeadDim / 2);
    const int col = (idx % (kHeadDim / 2)) * 2;
    const int q = q0 + warp * 16 + r;
    if (q < p.S)
      *reinterpret_cast<__nv_bfloat162*>(ob + q * p.o_rs + col) =
          __floats2bfloat162_rn(Sw[r * kLdf + col], Sw[r * kLdf + col + 1]);
  }
}

cudaError_t launch_attention(const AttnArgs& args, int B, int H, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kAttnSmem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((args.S + kQTile - 1) / kQTile, H, B);
  attention_kernel<<<grid, kAttnThreads, kAttnSmem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// One sublayer as four launches on `stream`.  `kv` == nullptr selects the
// self sublayer: w_in is Wqkv (3D, D) and qkv_buf is (B, S, 3D).  Otherwise
// w_in is Wq (D, D), qkv_buf is (B, S, D) and kv is the (B, L, 2D) [k|v]
// projection of the text context.  res may be nullptr (zeros).
extern "C" int muse_attn_sublayer(const void* x, const void* res, const void* ln,
                                  const void* adaln, const void* w_in, const void* w_out,
                                  const void* kv, void* h_out, void* a_buf, void* qkv_buf,
                                  void* attn_buf, void* out, int B, int S, int D, int H, int L,
                                  int kv_len, float eps, void* stream_ptr) {
  using bf = __nv_bfloat16;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int rows = B * S;
  rmsnorm_adaln_kernel<<<rows, kRowThreads, 0, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(res), static_cast<const bf*>(ln),
      static_cast<const bf*>(adaln), static_cast<bf*>(h_out), static_cast<bf*>(a_buf), S, D, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const bool self_attn = kv == nullptr;
  const int n_in = self_attn ? 3 * D : D;
  err = muse::launch_gemm_tn<kProjTile>(muse::RowLoader{static_cast<const bf*>(a_buf), D},
                             static_cast<const bf*>(w_in), static_cast<bf*>(qkv_buf), rows, n_in, D,
                             stream);
  if (err != cudaSuccess) return int(err);

  AttnArgs args;
  args.q = static_cast<const bf*>(qkv_buf);
  args.q_bs = int64_t(S) * n_in;
  args.q_rs = n_in;
  if (self_attn) {
    args.k = args.q + D;
    args.v = args.q + 2 * D;
    args.kv_bs = args.q_bs;
    args.kv_rs = args.q_rs;
    args.L = S;
    args.kv_len = S;
  } else {
    args.k = static_cast<const bf*>(kv);
    args.v = args.k + D;
    args.kv_bs = int64_t(L) * 2 * D;
    args.kv_rs = 2 * D;
    args.L = L;
    args.kv_len = kv_len;
  }
  args.out = static_cast<bf*>(attn_buf);
  args.o_bs = int64_t(S) * D;
  args.o_rs = D;
  args.S = S;
  args.scale = 1.0f / sqrtf(float(kHeadDim));
  err = launch_attention(args, B, H, stream);
  if (err != cudaSuccess) return int(err);

  err = muse::launch_gemm_tn<kProjTile>(muse::RowLoader{static_cast<const bf*>(attn_buf), D},
                             static_cast<const bf*>(w_out), static_cast<bf*>(out), rows, D, D,
                             stream);
  return int(err);
}
