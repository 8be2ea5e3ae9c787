// Fused encoder MLP sub-block:
//   out = x + gelu_exact(layer_norm(x) @ w1 + b1) @ w2 + b2
//
// Replaces: whisper_tpu/ops/pallas/encoder_block.py::_mlp_kernel (entry
// fused_mlp_block -> _mlp_call). The TPU kernel holds a (1024, d) f32
// output accumulator in VMEM across a sweep over hidden blocks, so the
// hidden activations never leave the chip. On Hopper the d-wide f32
// accumulator of even one 64-row wgmma tile (64 x 1280 x 4 B = 320 KB)
// fits neither the registers nor the 227 KB of shared memory, so this
// design runs three launches and passes the hidden through device memory:
//   1. layer_norm_kernel: LN(x) in f32 (two-pass variance), rounded to bf16;
//   2. mlp_gemm_kernel<256, true> (GEMM1): hn @ w1 in f32, + b1, exact-erf
//      GELU in f32, rounded to bf16: the (M, h) hidden, 7.7 MB at M = 750,
//      d = 1280, which stays in the 50 MB L2 for GEMM2;
//   3. mlp_gemm_kernel<128, false> (GEMM2): hidden @ w2 in f32, then
//      x + acc + b2 in f32, rounded once.
// The rounding order is the plain version's exactly; only the f32 sums run
// in another order.
//
// Bound on the H100: the tensor cores. At large-v2 (M = 750 rows, one
// window; d = 1280, h = 5120) the two GEMMs are 4 * M * d * h = 19.7 GFLOP,
// 0.0199 ms at 989 TFLOP/s, against 26 MB of weights and 3.8 MB of x and
// out from HBM (0.0089 ms at 3.35 TB/s) plus the hidden's 15 MB of L2
// traffic. The first version (WMMA 16x16x16 fragments on 16-row tiles,
// re-reading all 26 MB of weights from L2 for each of 47 row tiles) took
// 0.469 ms. What this design does about it:
//   * the GEMMs are warp-specialised wgmma kernels, as K1's attention is
//     (csrc/flash_attention.cu): one producer warpgroup whose first thread
//     issues every TMA copy, a ring of STAGES shared-memory stages with a
//     full and an empty mbarrier each, and two consumer warpgroups of 64
//     rows that run `wgmma.mma_async` on the stages that have landed,
//     one wgmma group kept in flight while the previous stage is released;
//     `setmaxnreg` moves the producer to 24 registers, the consumers to 240;
//   * a block owns a 128-row tile: the weights are read once per 128 rows
//     (6 times at M = 750, not 47);
//   * A (hn or the hidden, row-major M x K) is the K-major operand, B (w1 or
//     w2 as stored, row-major K x N) the MN-major one: TMA writes both with
//     the 128-byte swizzle, 64 values of K a stage (one swizzle row of A),
//     B as BN / 64 boxes of 64 x 64, so no weight is transposed;
//   * GEMM1 takes 128 x 256 tiles: 6 x 20 = 120 blocks at M = 750, one
//     wave of the 132 SMs;
//   * GEMM2 has only d / 128 column tiles (60 blocks of 128 x 128 at
//     M = 750), so where that leaves the SMs idle it splits K over a
//     cluster of 2 blocks (`ksplit`, planned by ops/kernels/encoder_block.py
//     ::plan_ksplit): rank 1 stores its f32 accumulators into rank 0's
//     shared memory (distributed shared memory), rank 0 adds them in a
//     fixed order and writes the tile. One launch, no atomics, no f32
//     partials in device memory, the same bits on every run;
//   * rows past M: TMA fills them with zeros, the epilogue stores are masked.
// The wrapper allocates hn and the hidden with torch.empty; the kernels
// allocate nothing. One wrapper call is three launches (LN, GEMM1, GEMM2).
// Tried and dropped, none faster on the card (PERF.md section 6): pairs of
// row tiles sharing their weight tiles by TMA multicast, a K-major copy
// of the weights, five stages for GEMM2, a wgmma wait of 0 a stage. At one
// window the whole call takes 0.9x the time of the composed cuBLAS path
// and reaches ~36% of the tensor-core bound; what is left is the next
// design's (a persistent grid whose epilogues overlap the next tile's
// loads, two consumers on different tiles).
//
// Widths: d in {256, 384, 512, 768, 1024, 1280} (every Whisper size; a
// 64-wide bf16 K slice is one 128-byte swizzle row) and h a multiple of 256
// (h = 4d for all of them). This is the one list: any other width returns
// cudaErrorInvalidValue without a launch.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;            // rows of a GEMM tile: two consumer warpgroups of 64
constexpr int BK = 64;             // K of a stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;          // ring depth
constexpr int THREADS = 3 * 128;   // producer warpgroup + two consumers
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BOX = BK * 64 * 2;  // one 64 x 64 box of B: 8 KB
constexpr int REGS = 168;          // 65536 / 384, rounded down to a multiple of 8
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert((REGS - PRODUCER_REGS) * 128 >= (CONSUMER_REGS - REGS) * 256,
              "setmaxnreg: the consumers would wait for registers no one frees");

// Shared memory of a BN-wide GEMM: the stages, then (GEMM2) rank 1's f32
// accumulators for the K split, then the mbarriers.
template <int BN, bool GELU>
struct Gemm {
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ACC = BN / 2;  // f32 accumulators of a consumer thread
  static constexpr int RED = GELU ? 0 : 256 * ACC * 4;
  static constexpr int BARS = STAGES * STAGE + RED;
  static constexpr int SMEM = 1024 /* alignment slack */ + BARS + 2 * STAGES * 8;
};

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* acc, uint64_t da, uint64_t db) {
  if constexpr (BN == 256) wtt::wgmma_ss_n256_tb(acc, da, db, 1);
  else wtt::wgmma_ss_n128_tb(acc, da, db, 1);
}

// LN of D-wide bf16 rows, one warp a row: f32 mean, then the f32 variance
// of x - mean (two passes over registers), (x - mean) * rstd * g + b
// rounded to bf16.
template <int D>
__global__ void __launch_bounds__(256)
layer_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  const bf16* __restrict__ b, bf16* __restrict__ hn, int M, float eps) {
  constexpr int NV = D / 8;              // 16-byte vectors a row
  constexpr int VPL = (NV + 31) / 32;    // vectors a lane
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + (long long)row * D;
  float v[VPL][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < D) {
      wtt::Vec16<bf16>::load(xr + c, v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[i][e];
    }
  }
  const float mean = wtt::warp_sum(s) / D;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if ((lane + 32 * i) * 8 < D) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dv = v[i][e] - mean;
        s2 += dv * dv;
      }
    }
  }
  const float rstd = rsqrtf(wtt::warp_sum(s2) / D + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < D) {
      float gv[8], bv[8];
      wtt::Vec16<bf16>::load(g + c, gv);
      wtt::Vec16<bf16>::load(b + c, bv);
      uint4 packed;
      uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = wtt::pack_bf16((v[i][2 * e] - mean) * rstd * gv[2 * e] + bv[2 * e],
                              (v[i][2 * e + 1] - mean) * rstd * gv[2 * e + 1] + bv[2 * e + 1]);
      *reinterpret_cast<uint4*>(hn + (long long)row * D + c) = packed;
    }
  }
}

// out[M, N] = epilogue(A[M, K] @ B[K, N]) for one BM x BN tile, bf16 in,
// f32 accumulation. GELU: out = bf16(gelu(acc + bias)). Otherwise: out =
// bf16(resid + acc + bias). With a cluster of 2 along z (GEMM2's K split)
// each rank takes half of K and rank 0 adds rank 1's sums.
template <int BN, bool GELU>
__global__ void __launch_bounds__(THREADS, 1)
mlp_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap b_map, const bf16* __restrict__ bias,
                const bf16* __restrict__ resid, bf16* __restrict__ out, int M, int N, int K) {
  using L = Gemm<BN, GELU>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 B: align the tiles to it
  unsigned char* smem = smem_raw + ((1024 - (wtt::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sA = smem;                           // [STAGES][BM][128 B]
  unsigned char* sB = smem + STAGES * A_BYTES;        // [STAGES][BN / 64][BK][128 B]
  float* red = reinterpret_cast<float*>(smem + STAGES * L::STAGE);  // [ACC][256]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);     // [STAGES]
  uint64_t* empty = full + STAGES;                                  // [STAGES]

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ksplit = gridDim.z;  // the cluster spans z
  const int rank = blockIdx.z;
  const int k_tiles = K / BK / ksplit;
  const int kt0 = rank * k_tiles;
  const int wg = threadIdx.x / 128;  // 0 producer, 1-2 consumers

  // A block may store into another's shared memory only once that block
  // runs: arrive now, wait before the first such store.
  if (ksplit > 1) wtt::cluster_arrive_relaxed();
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wtt::mbar_init(&full[s], 1);
      wtt::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every copy; the warpgroup takes part in
    // the cluster's two barriers and leaves.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int t = 0; t < k_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) wtt::mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        wtt::mbar_expect_tx(&full[s], L::STAGE);
        const int k0 = (kt0 + t) * BK;
        wtt::tma_load_2d(sA + s * A_BYTES, &a_map, &full[s], k0, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          wtt::tma_load_2d(sB + s * L::B_BYTES + c * B_BOX, &b_map, &full[s], n0 + 64 * c, k0);
      }
    }
    if (ksplit > 1) {
      wtt::cluster_wait();
      wtt::cluster_sync();
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int c = wg - 1;  // consumer: tile rows [c*64, c*64 + 64)
  const int t128 = threadIdx.x % 128;
  const int warp = t128 / 32;
  const int lane = t128 % 32;

  float acc[L::ACC];
#pragma unroll
  for (int i = 0; i < L::ACC; ++i) acc[i] = 0.f;

  for (int t = 0; t < k_tiles; ++t) {
    const int s = t % STAGES;
    wtt::mbar_wait(&full[s], (t / STAGES) & 1);
    const uint64_t da = wtt::sw128_desc(sA + s * A_BYTES + c * 64 * 128);
    const uint64_t db = wtt::sw128_desc(sB + s * L::B_BYTES, B_BOX);
    wtt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_tile<BN>(acc, da + 2 * kk, db + 128 * kk);
    wtt::wgmma_commit();
    // the previous tile's products are done: release its stage
    wtt::wgmma_wait1();
    if (t > 0 && lane == 0) wtt::mbar_arrive(&empty[(t - 1) % STAGES]);
  }
  wtt::wgmma_wait0();
  wtt::fence_regs<L::ACC>(acc);

  // This thread's rows of the accumulator fragment (within the 64) and the
  // first of its two columns in every 8-column block.
  const int r_lo = warp * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int slot = c * 128 + t128;
  if constexpr (!GELU) {
    if (ksplit > 1) {
      wtt::cluster_wait();  // rank 0 runs: its shared memory may be written
      if (rank == 1) {
        float* to0 = cg::this_cluster().map_shared_rank(red, 0);
#pragma unroll
        for (int i = 0; i < L::ACC; ++i) to0[i * 256 + slot] = acc[i];
      }
      wtt::cluster_sync();
      if (rank == 1) return;
#pragma unroll
      for (int i = 0; i < L::ACC; ++i) acc[i] += red[i * 256 + slot];
    }
  }

#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + col;
    const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + n));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + c * 64 + r_lo + 8 * half;
      if (m >= M) continue;
      const long long o = (long long)m * N + n;
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if constexpr (GELU) {
        v0 = gelu_exact(v0 + bv.x);
        v1 = gelu_exact(v1 + bv.y);
      } else {
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resid + o));
        v0 = xv.x + v0 + bv.x;
        v1 = xv.y + v1 + bv.y;
      }
      *reinterpret_cast<uint32_t*>(out + o) = wtt::pack_bf16(v0, v1);
    }
  }
}

// A 2-D bf16 map (cols, rows) of a row-major matrix and a (64, box_rows)
// box with the 128-byte swizzle.
bool matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return wtt::cached_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// Once per instantiation: the register count the setmaxnreg split assumes
// (the consumers' setmaxnreg.inc would otherwise wait forever) and the
// dynamic shared memory opt-in.
template <int BN, bool GELU>
int configure() {
  static int state = -1;
  if (state < 0) {
    auto kernel = mlp_gemm_kernel<BN, GELU>;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs != REGS) return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Gemm<BN, GELU>::SMEM);
    if (err != cudaSuccess) return (int)err;
    state = 0;
  }
  return state;
}

template <int BN, bool GELU>
int launch_gemm(const void* a, const void* b, const void* bias, const void* resid, void* out,
                int M, int N, int K, int ksplit, cudaStream_t stream) {
  const int err = configure<BN, GELU>();
  if (err != cudaSuccess) return err;
  CUtensorMap am, bm;
  if (!matrix_map(&am, a, M, K, BM) || !matrix_map(&bm, b, K, N, BK))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN, (M + BM - 1) / BM, ksplit);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Gemm<BN, GELU>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ksplit;
  cfg.attrs = attr;
  cfg.numAttrs = ksplit > 1;  // one block a cluster: a plain launch
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mlp_gemm_kernel<BN, GELU>, am, bm,
                                           (const bf16*)bias, (const bf16*)resid, (bf16*)out,
                                           M, N, K);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* x, const void* g, const void* b, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, void* hn, void* hidden, int M, int H,
           int ksplit, float eps, cudaStream_t stream) {
  layer_norm_kernel<D><<<(M + 7) / 8, 256, 0, stream>>>((const bf16*)x, (const bf16*)g,
                                                         (const bf16*)b, (bf16*)hn, M, eps);
  int err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_gemm<256, true>(hn, w1, b1, nullptr, hidden, M, H, D, 1, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<128, false>(hidden, w2, b2, x, out, M, D, H, ksplit, stream);
}

}  // namespace

// x, out: (M, D) bf16; ln_g, ln_b, b2: (D,); w1: (D, H); b1: (H,); w2:
// (H, D); hn: (M, D) and hidden: (M, H) bf16 scratch the wrapper
// allocates; ksplit: GEMM2's cluster size over K (1 or 2). D must be a
// Whisper width (256, 384, 512, 768, 1024, 1280) and H a multiple of 256:
// this is the one list of the widths the kernel takes, any other d or h
// returns cudaErrorInvalidValue without a launch; so does a base that TMA
// cannot take. cudaErrorInvalidConfiguration: a GEMM was not compiled to
// the register count its setmaxnreg split assumes.
extern "C" int wtt_encoder_mlp(const void* x, const void* ln_g, const void* ln_b,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, void* out, void* hn, void* hidden, int M, int D,
                               int H, int ksplit, float eps, void* stream) {
  if (M < 1 || H < 256 || H % 256 || ksplit < 1 || ksplit > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define WTT_MLP(D) \
  launch<D>(x, ln_g, ln_b, w1, b1, w2, b2, out, hn, hidden, M, H, ksplit, eps, s)
  switch (D) {
    case 256: return WTT_MLP(256);
    case 384: return WTT_MLP(384);
    case 512: return WTT_MLP(512);
    case 768: return WTT_MLP(768);
    case 1024: return WTT_MLP(1024);
    case 1280: return WTT_MLP(1280);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WTT_MLP
}
