// Encoder self-attention on the natural (B, S, d) layout for Hopper: a
// warp-specialised FlashAttention-3-shaped kernel (TMA copies into a ring
// of shared-memory stages, wgmma products, the online softmax in
// registers). Head dim 64, bf16 in and out, f32 accumulation.
//
// Replaces: whisper_tpu/ops/pallas/flash_attention.py::_attn_bsd_kernel
// (K1, entry attention_bhsd -> _attention_bsd) and ::_attn_kernel (K9,
// entry flash_attention, the legacy (B, H, S, hd) path). The TPU kernel
// keeps a head's whole K and V resident in VMEM and normalises p before PV.
// At S = 1500, hd = 64 one head's K+V is 384 KB of bf16, over the 227 KB of
// shared memory a Hopper block can use, so this kernel streams 128-key
// tiles and rescales a running f32 output instead (normalising once at the
// end).
//
// What bounds it on the H100: 4 * S^2 * d FLOP against 3 * S * d * 2 B of
// q/k/v. At large-v2 (B = 1, S = 750, d = 1280, 20 heads) that is
// 2.9 GFLOP against 5.8 MB, ~500 FLOP a byte, above the card's ~295 for
// bf16: the tensor cores bound it, and only wgmma reaches their rate.
// What the design does about it:
//   * one block per (128 query rows, head, batch): 120 blocks at B = 1,
//     S = 750, one wave on 132 SMs;
//   * a producer warpgroup (its first thread issues every copy) and two
//     consumer warpgroups of 64 query rows each; `setmaxnreg` moves the
//     producer to 24 registers and the consumers to 240;
//   * Q is loaded once, and K/V tiles of 128 keys stream through a ring of
//     STAGES shared-memory stages, each with a full and an empty mbarrier,
//     by `cp.async.bulk.tensor` (TMA) with the 128-byte swizzle: a 64-wide
//     bf16 row is exactly 128 bytes, the layout the wgmma descriptors read;
//     the copies of later tiles overlap the math of the current one;
//   * S = Q K^T is `wgmma.mma_async` m64n128k16 with both operands in
//     shared memory; the online softmax runs on the accumulator fragment in
//     registers (exp2 with scale * log2(e) folded into one FMA); P is
//     rounded to bf16 in registers, where the accumulator's fragment is
//     already wgmma's register A fragment, and O += P V is m64n64k16 with
//     V as the transposed (MN-major) shared-memory B operand;
//   * O stays in registers and is normalised once at the end, staged
//     through the consumer's own Q rows, and written with 16-byte stores.
// Registers and shared memory from `-Xptxas -v` are in PERF.md.
//
// Tensors come as base pointer plus batch, head and row strides; the host
// entry builds one 4-D TMA map (hd, S, H, B) for each of q, k and v with
// those strides. On the (B, S, d) layout (K1) the head stride is 64 (heads
// are column slices), so q/k/v may be the strided slices of the fused QKV
// projection: no HBM transpose, no copy. K9 hands over (B, H, S, hd) views
// and scale 1 (its q comes pre-scaled). Rows past Sq and Sk lie outside the
// maps, so TMA fills them with zeros and never reads the next batch's rows;
// keys >= Sk are masked to -inf (a zero key would otherwise score 0).
// `causal` masks key j for query i when j > i on the absolute query row;
// key tiles wholly above a block's diagonal are skipped, and only tiles that
// cross it (or Sk) are masked.
//
// Numerics (K1 and K9): scores are f32 sums of exact bf16 x bf16 products;
// p = exp(s * scale - m) is rounded to bf16 unnormalised for PV, the row sum
// is taken over the f32 p, and the output is divided once at the end, so it
// stays within the wrapper's tolerance of the plain version (which
// normalises p before rounding).
#include "common.cuh"

namespace {

constexpr int HD = 64;             // head dim: every Whisper size
constexpr int BQ = 128;            // query rows per block
constexpr int BK = 128;            // keys per K/V tile
constexpr int STAGES = 3;          // K/V ring depth
constexpr int THREADS = 3 * 128;   // producer warpgroup + two consumers
constexpr int ROW_BYTES = HD * 2;  // 128: one swizzle row
constexpr int Q_BYTES = BQ * ROW_BYTES;
constexpr int KV_BYTES = BK * ROW_BYTES;
constexpr int SMEM_BYTES = 1024 /* alignment slack */ + Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
constexpr int REGS = 168;          // 65536 / 384, rounded down to a multiple of 8
constexpr int PRODUCER_REGS = 24;  // REGS - 144: frees 144 * 128 registers...
constexpr int CONSUMER_REGS = 240; // ...that lift the 256 consumer threads by 72
static_assert((REGS - PRODUCER_REGS) * 128 >= (CONSUMER_REGS - REGS) * 256,
              "setmaxnreg: the consumers would wait for registers no one frees");

// wgmma descriptors, fences and products: common.cuh.
using wtt::ex2;
using wtt::fence_regs;
using wtt::pack_bf16;
using wtt::sw128_desc;
using wtt::wgmma_commit;
using wtt::wgmma_fence;
using wtt::wgmma_rs_n64_tb;
using wtt::wgmma_ss_n128;
using wtt::wgmma_wait0;

__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                       int Sq, int Sk, int causal, long long o_sb, long long o_sh, long long o_ss,
                       float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 B: align the tiles to it
  unsigned char* smem = smem_raw + ((1024 - (wtt::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;  // [BQ][128 B], swizzled
  unsigned char* sK = smem + Q_BYTES;                      // [STAGES][BK][128 B]
  unsigned char* sV = smem + Q_BYTES + STAGES * KV_BYTES;  // [STAGES][BK][128 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Q_BYTES + 2 * STAGES * KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;             // [STAGES]
  uint64_t* empty = bars + 1 + STAGES;   // [STAGES]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wg = threadIdx.x / 128;  // 0 producer, 1-2 consumers
  // causal: keys past the block's last query row are never visible
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    wtt::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      wtt::mbar_init(&full[s], 1);
      wtt::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every copy; the warpgroup keeps 24
    // registers a thread and never rejoins the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      wtt::mbar_expect_tx(q_full, Q_BYTES);
      wtt::tma_load_4d(sQ, &q_map, q_full, 0, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) wtt::mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        wtt::mbar_expect_tx(&full[s], 2 * KV_BYTES);
        wtt::tma_load_4d(sK + s * KV_BYTES, &k_map, &full[s], 0, t * BK, h, b);
        wtt::tma_load_4d(sV + s * KV_BYTES, &v_map, &full[s], 0, t * BK, h, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;            // consumer: query rows [c*64, c*64 + 64)
  const int t128 = threadIdx.x % 128;
  const int warp = t128 / 32;
  const int lane = t128 % 32;
  // This thread's two rows of the accumulator fragments (within the 64) and
  // the first of its two columns in every 8-column block.
  const int r_lo = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int qi_lo = q0 + c * 64 + r_lo;  // absolute query rows
  const int qi_hi = qi_lo + 8;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of s * scale_log2
  float l_lo = 0.f, l_hi = 0.f;              // this thread's share of the row sums

  const uint64_t q_desc = sw128_desc(sQ + c * 64 * ROW_BYTES);
  wtt::mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const int k0 = t * BK;
    wtt::mbar_wait(&full[st], (t / STAGES) & 1);

    // S = Q K^T over hd = 64: four k16 steps of 32 B each.
    const uint64_t k_desc = sw128_desc(sK + st * KV_BYTES);
    fence_regs<64>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss_n128(s, q_desc + 2 * kk, k_desc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<64>(s);

    // Mask keys >= Sk and, for causal, keys past the row; only tiles that
    // reach past Sk or cross this consumer's diagonal need it.
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + c * 64)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + col + (e & 1);
          const int qi = e < 2 ? qi_lo : qi_hi;
          if (key >= Sk || (causal && key > qi)) s[4 * j + e] = -INFINITY;
        }
      }
    }

    // Online softmax on the fragment: rows r_lo (e = 0, 1) and r_lo + 8
    // (e = 2, 3); the four lanes of a quad share a row.
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2);
    const float mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
    const float mu_lo = mn_lo == -INFINITY ? 0.f : mn_lo;  // an all-masked row
    const float mu_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float a_lo = ex2(m_lo - mu_lo);
    const float a_hi = ex2(m_hi - mu_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
    uint32_t p[BK / 16][4];  // wgmma A fragments of P, one per k16 step
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(fmaf(s[4 * j], scale_log2, -mu_lo));
      const float p1 = ex2(fmaf(s[4 * j + 1], scale_log2, -mu_lo));
      const float p2 = ex2(fmaf(s[4 * j + 2], scale_log2, -mu_hi));
      const float p3 = ex2(fmaf(s[4 * j + 3], scale_log2, -mu_hi));
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      // 8-column block j holds keys 8j..8j+7: the A fragment of k16 step
      // j / 2 takes blocks 2i (regs 0, 1) and 2i + 1 (regs 2, 3).
      p[j / 2][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      p[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= a_lo;
      o[4 * j + 1] *= a_lo;
      o[4 * j + 2] *= a_hi;
      o[4 * j + 3] *= a_hi;
    }

    // O += P V: eight k16 steps over the tile's 128 keys, 2048 B each.
    const uint64_t v_desc = sw128_desc(sV + st * KV_BYTES);
    fence_regs<32>(o);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs_n64_tb(o, p[kc], v_desc + 128 * kc);
    wgmma_commit();
    wgmma_wait0();
    fence_regs<32>(o);
    __syncwarp();
    if (lane == 0) wtt::mbar_arrive(&empty[st]);  // this warp is done with the stage
  }

  // Normalise, stage the bf16 rows in this consumer's own (now unused) 64
  // rows of sQ with the same 16-byte XOR swizzle, then 16-byte stores.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  unsigned char* stage = sQ + c * 64 * ROW_BYTES;
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int r0 = r_lo, r1 = r_lo + 8;
    const int byte = col * 2;  // within the 16-byte chunk j
    *reinterpret_cast<uint32_t*>(stage + r0 * ROW_BYTES + ((j ^ (r0 & 7)) << 4) + byte) =
        pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(stage + r1 * ROW_BYTES + ((j ^ (r1 & 7)) << 4) + byte) =
        pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  __nv_bfloat16* ob = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = t128; i < 64 * (HD / 8); i += 128) {
    const int r = i / (HD / 8), ch = i % (HD / 8);
    const int qi = q0 + c * 64 + r;
    if (qi < Sq)
      *reinterpret_cast<uint4*>(ob + (long long)qi * o_ss + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * ROW_BYTES + ((ch ^ (r & 7)) << 4));
  }
}

// A 4-D map (hd, rows, H, B) over bf16 with the given element strides, and
// a box of one head's 128 rows.
bool make_map(CUtensorMap* map, const void* base, int rows, int H, int B, long long sb,
              long long sh, long long ss) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)rows, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {HD, BK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return wtt::encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Strides are in elements; each row of 64 channels must be 16-byte aligned
// (the wrapper checks). Returns a cudaError_t: cudaErrorInvalidValue when
// the tensor maps cannot be built, cudaErrorInvalidConfiguration when the
// kernel was not compiled to the register count its setmaxnreg split
// assumes (a launch would wait forever for registers).
extern "C" int wtt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int B, int Sq, int Sk, int H, int causal,
                                   long long q_sb, long long q_sh, long long q_ss,
                                   long long k_sb, long long k_sh, long long k_ss,
                                   long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss,
                                   float scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, flash_attention_kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs != REGS) return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(flash_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || wtt::encode_tiled() == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, Sq, H, B, q_sb, q_sh, q_ss) ||
      !make_map(&km, k, Sk, H, B, k_sb, k_sh, k_ss) ||
      !make_map(&vm, v, Sk, H, B, v_sb, v_sh, v_ss))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, Sq, Sk, causal, o_sb, o_sh, o_ss,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
