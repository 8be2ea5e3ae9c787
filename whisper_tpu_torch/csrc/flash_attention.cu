// Encoder self-attention on the natural (B, S, d) layout, FlashAttention-2
// style: one block per (q-tile, head, batch), an online softmax over K/V
// tiles, bf16 tensor-core products (WMMA m16n16k16) with f32 accumulation.
//
// Replaces: whisper_tpu/ops/pallas/flash_attention.py::_attn_bsd_kernel
// (entry attention_bhsd -> _attention_bsd). The TPU kernel keeps a head's
// whole K and V resident in VMEM and normalises p before PV. At S = 1500,
// hd = 64 one head's K+V is 384 KB of bf16, over the 227 KB of shared
// memory a Hopper block can use, so this kernel streams 64-key tiles and
// rescales a running f32 output instead (normalising once at the end).
//
// Bound on the H100 at large-v2 (B = 1, S = 1500, d = 1280, 20 heads):
// 4 * S^2 * d = 11.5 GFLOP per layer against 3 * S * d * 2 B = 11.5 MB of
// q/k/v (plus K/V re-read once per q-tile from L2: 24 tiles * 7.7 MB), so
// it is compute-bound on the tensor cores. This first version runs WMMA
// from shared memory with synchronous tile loads; TMA, wgmma and a
// producer warp are later work.
//
// Queries and keys may differ in length (Sq, Sk); `causal` masks key j
// for query i when j > i (every row sees key 0, so no row is empty).
//
// Each tensor comes with a batch, a head and a row stride. On the (B, S, d)
// layout (K1) the head stride is 64: heads are column slices
// [h*64, h*64+64) of each row, so q/k/v may be the strided slices of the
// fused QKV projection (no HBM transpose, no copy).
//
// Also replaces: whisper_tpu/ops/pallas/flash_attention.py::_attn_kernel
// (K9, entry flash_attention, the legacy (B, H, S, hd) path of
// attention_bhsd). The same kernel serves it with the head strides of the
// (B, H, S, hd) views and scale 1 (its q comes pre-scaled): the (B, S, H, hd)
// views of the projections are handed over as they are. K9 computes its
// scores as f32 products of the f32-cast q and k; for bf16 inputs a
// bf16 x bf16 product is exact in f32, so these WMMA scores with f32
// accumulation are K9's scores up to the order of the f32 sums. K9 pads the
// keys to a multiple of 128 and masks keys >= Sk with -1e30, normalises p
// before casting it to bf16 and masks j > i for causal; here the keys past
// Sk are zero-filled and masked with -inf, p is cast before the division
// (once at the end), and the causal mask is the same compare on the
// absolute query row.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int HD = 64;           // head dim: every Whisper size
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per K/V tile
constexpr int WARPS = BQ / 16;   // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int LDH = HD + 8;      // bf16 smem row stride (144 B rows)
constexpr int LDS = BK + 4;      // f32 smem row stride for scores / PV

constexpr int SQ_BYTES = BQ * LDH * 2;
constexpr int SK_BYTES = BK * LDH * 2;
constexpr int SS_BYTES = WARPS * 16 * LDS * 4;
constexpr int SP_BYTES = WARPS * 16 * LDH * 2;
constexpr int SO_BYTES = WARPS * 16 * HD * 4;
constexpr int SML_BYTES = 2 * WARPS * 16 * 4;
constexpr int SMEM_BYTES =
    SQ_BYTES + 2 * SK_BYTES + SS_BYTES + SP_BYTES + SO_BYTES + SML_BYTES;

// Copy `rows` rows of one head (64 bf16 = 8 x 16 B each) into a smem tile,
// zero-filling rows at or past `valid` so masked keys never carry NaN.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int rows, int valid) {
  for (int i = threadIdx.x; i < rows * (HD / 8); i += THREADS) {
    int r = i / (HD / 8);
    int c = (i % (HD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                       int causal, long long q_sb, long long q_sh, long long q_ss,
                       long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                       long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                       long long o_ss, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + SQ_BYTES);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + SQ_BYTES + SK_BYTES);
  float* sS = reinterpret_cast<float*>(smem + SQ_BYTES + 2 * SK_BYTES);
  __nv_bfloat16* sP =
      reinterpret_cast<__nv_bfloat16*>(smem + SQ_BYTES + 2 * SK_BYTES + SS_BYTES);
  float* sO = reinterpret_cast<float*>(smem + SQ_BYTES + 2 * SK_BYTES + SS_BYTES + SP_BYTES);
  float* sM = reinterpret_cast<float*>(smem + SQ_BYTES + 2 * SK_BYTES + SS_BYTES +
                                       SP_BYTES + SO_BYTES);
  float* sL = sM + WARPS * 16;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh + (long long)q0 * q_ss;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  load_tile(sQ, qb, q_ss, BQ, Sq - q0);
  for (int i = threadIdx.x; i < WARPS * 16 * HD; i += THREADS) sO[i] = 0.f;
  for (int i = threadIdx.x; i < WARPS * 16; i += THREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }
  __syncthreads();

  // This warp's 16 query rows stay in registers for the whole K sweep.
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * LDH + kk * 16, LDH);

  float* wS = sS + warp * 16 * LDS;
  __nv_bfloat16* wP = sP + warp * 16 * LDH;
  float* wO = sO + warp * 16 * HD;
  const int row = lane / 2;          // softmax / output row of this lane
  const int col0 = (lane % 2) * 32;  // its 32 of the tile's 64 columns

  const int qi = q0 + warp * 16 + row;  // this lane's query row
  // causal: keys past the block's last query row are never visible
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int j0 = 0; j0 < k_end; j0 += BK) {
    load_tile(sK, kb + (long long)j0 * k_ss, k_ss, BK, Sk - j0);
    load_tile(sV, vb + (long long)j0 * v_ss, v_ss, BK, Sk - j0);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (f32 accumulate).
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + nt * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(wS + nt * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax: two lanes per row, 32 columns each.
    float s[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      float val = wS[row * LDS + col0 + c] * scale;
      const int j = j0 + col0 + c;
      if (j >= Sk || (causal && j > qi)) val = -INFINITY;
      s[c] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = sM[warp * 16 + row];
    const float m_new = fmaxf(m_old, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      float p = expf(s[c] - m_use);
      sum += p;
      wP[row * LDH + col0 + c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_old - m_use);
    __syncwarp();
    if (lane % 2 == 0) {
      sM[warp * 16 + row] = m_new;
      sL[warp * 16 + row] = sL[warp * 16 + row] * alpha + sum;
    }

    // PV for this tile (into the score scratch), then O = O * alpha + PV.
#pragma unroll
    for (int nt = 0; nt < HD / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, wP + kk * 16, LDH);
        wmma::load_matrix_sync(vf, sV + kk * 16 * LDH + nt * 16, LDH);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(wS + nt * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c)
      wO[row * HD + col0 + c] = wO[row * HD + col0 + c] * alpha + wS[row * LDS + col0 + c];
    __syncthreads();  // every warp is done with sK / sV before the next load
  }

  if (qi < Sq) {
    const float inv = 1.f / sL[warp * 16 + row];
    __nv_bfloat16* orow = out + b * o_sb + h * o_sh + (long long)qi * o_ss + col0;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      __align__(16) __nv_bfloat16 pack[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) pack[e] = __float2bfloat16(wO[row * HD + col0 + c + e] * inv);
      *reinterpret_cast<uint4*>(orow + c) = *reinterpret_cast<const uint4*>(pack);
    }
  }
}

}  // namespace

extern "C" int wtt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int B, int Sq, int Sk, int H, int causal,
                                   long long q_sb, long long q_sh, long long q_ss,
                                   long long k_sb, long long k_sh, long long k_ss,
                                   long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss,
                                   float scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)out, Sq, Sk, causal, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
      o_sb, o_sh, o_ss, scale);
  return (int)cudaGetLastError();
}
