// W8A8 matrix product: per-row dynamic int8 activations times int8 (or
// packed int4) weights, exact int32 accumulation, f32 (row scale x column
// scale) epilogue.
//
//   xs[m]  = absmax_m > 0 ? absmax_m * (1/127) : 1          (absmax over row m)
//   xq     = clip(rint(x / xs), -127, 127)       K6, quantized_matmul
//          = clip(rint(x * (127 / absmax)), ...)  K7, quantized_matmul_big
//   out    = ((float(xq @ wq) * xs[m]) * ws[n]) in the output type
//
// Replaces: whisper_tpu/ops/pallas/dequant_matmul.py::_w8a8_kernel (K6,
// entry quantized_matmul, M <= 1024) and ::_w8a8_big_kernel (K7, entry
// quantized_matmul_big, M > 1024). The TPU kernels quantize the activation
// once, at the first step of their sequential grid, into VMEM scratch that
// later steps read. With IEEE division (no fast math) and rint (half to
// even) xq is bit-equal to the TPU kernel's, and the int32 sum is exact in
// any order, so the output is bit-equal to the plain version. Two paths:
//   * M <= 64 (decode rows): ONE launch, `gemm_splitk_kernel` below: the
//     row quantization runs inside the GEMM, K is split over a cluster of
//     up to 8 blocks that exchange their partial row maxima and their int32
//     sums through distributed shared memory (no scratch, no atomics in
//     device memory);
//   * M > 64 (the encoder: M = 750 a window, W x 750 batched): a prep
//     pass quantizes every row into scratch the wrapper allocates and, in
//     the same grid, copies the weight K-major (int4 unpacked) on every
//     call, then `gemm_big_kernel` runs 128 x 256 (or 128) output tiles
//     as a persistent warp-specialised TMA + wgmma kernel: two launches
//     that count as one call. (Quantizing inside each tile, one launch,
//     was measured slower there: every block of a row tile repeats the
//     row's IEEE divisions.) The two functions differ only in the
//     rounding (a flag of the prep pass).
//
// The split-K kernel's products are mma.sync.m16n8k32 s8 x s8 -> s32, the
// tile kernel's wgmma.mma_async m64nNk32 s32.s8.s8. The weight is (K, N)
// row-major int8 (N contiguous, the QTensor layout), but both instructions
// want consecutive k of one column together: 4 (k) x 4 (n) byte blocks are
// loaded as four 32-bit words along N and transposed with __byte_perm (in
// registers for the split-K kernel, into the K-major scratch copy by the
// prep pass for the tile kernel). Packed int4 weights (template flag INT4):
// (K, N / 2) uint8, two two's-complement nibbles a byte, the low nibble the
// even column (quantize.py's layout); `expand4` sign-extends four nibbles
// into the four bytes of the word the int8 load would have given, so the
// products and the epilogue are the int8 path's, bit-equal over the
// unpacked weight.
//
// Bound on the H100. At decode M (1, 5, 20 rows) the weight stream bounds
// it: 1280 x 3840 int8 is 4.9 MB, ~1.5 us at 3.35 TB/s (int4: 2.5 MB,
// ~0.7 us); 1280 x 1280 is 1.6 MB, ~0.5 us, where a launch's latency is
// several times the stream. The split-K kernel keeps each block's weight
// slice in flight (a block's 8 warps each load their first two 4 KB steps
// of 32 k rows x 128 columns into registers at the start, later steps
// during a step's products), with 80-240 blocks at the path's shapes.
// At M = 3000, K = 1280, N = 3840 the 29.5 G integer operations take
// ~15 us at 1979 TOP/s, against 4.9 MB of weight and 3.8 MB of xq: the
// tensor cores bound the tile kernel, and the prep pass adds its read of x
// and the weight and its writes of xq and wt (7.7 + 4.9 + 3.8 + 4.9 MB
// there, ~6.3 us at 3.35 TB/s).
#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;

// A row's scale (1 for a zero row) and the inverse K7 multiplies by; the
// constant (float)(1.0 / 127.0) is the one JAX and PyTorch take from a
// Python float.
__device__ __forceinline__ void row_scale(float absmax, float& scale, float& inv) {
  scale = absmax > 0.f ? absmax * (float)(1.0 / 127.0) : 1.f;
  inv = absmax > 0.f ? 127.f / absmax : 0.f;
}

template <bool MUL_INV>
__device__ __forceinline__ int quantize(float v, float scale, float inv) {
  const float r = rintf(MUL_INV ? v * inv : v / scale);  // half to even
  return (int)fminf(fmaxf(r, -127.f), 127.f);
}

// K6's rounding, rint(x / scale) with the IEEE quotient, from a product
// with rcp = 1 / scale (IEEE), as the split-K kernel takes it: for |x /
// scale| <= 127 * (1 + 2^-24) (x is at most the row's absmax) the product is
// within 3 * 2^-24 * 127.1 < 2^-15 of the IEEE quotient, so the two round
// to the same integer unless the product lies within 2^-13 of a
// half-integer (or is not finite: a reciprocal that overflowed); there the
// quotient is taken. Bit-equal to quantize<false>.

// Row quantization for the M > 64 path: `tpr` threads a row (32 to 256,
// a power of two), THREADS / tpr rows for block `blk`. A thread holds up to
// QV vectors of 8 values of its row in registers (16-byte loads, all in
// flight at once; vector c of the row is thread c % tpr's): the row's
// absmax (the warps of a row meet in shared memory), the row scale, then
// the vectors quantized to 8 int8 bytes, one 8-byte store each. Vectors
// past QV a thread (K > 32 * QV * tpr) are read again. K is a multiple of
// 128, so a row is a whole number of vectors.
constexpr int QV = 4;

template <typename T, bool MUL_INV>
__device__ __forceinline__ void quantize_rows(const T* __restrict__ x, int8_t* __restrict__ xq,
                                              float* __restrict__ xs, int M, int K, int blk,
                                              int tpr) {
  constexpr int W = 8 * (int)sizeof(T) / 16;  // 16-byte loads a vector
  __shared__ float red[THREADS / 32];
  const int row = blk * (THREADS / tpr) + threadIdx.x / tpr;
  const int t = threadIdx.x % tpr;
  const bool live = row < M;
  const T* xr = x + (long long)row * K;
  int8_t* qr = xq + (long long)row * K;
  const int nv = K / 8;
  auto load = [&](int c, uint4* r) {
#pragma unroll
    for (int j = 0; j < W; ++j)
      r[j] = *reinterpret_cast<const uint4*>(xr + 8 * c + j * 16 / (int)sizeof(T));
  };
  auto unpack = [](const uint4* r, float* v) {
    const unsigned w[8] = {r[0].x, r[0].y, r[0].z, r[0].w, r[W - 1].x, r[W - 1].y, r[W - 1].z,
                           r[W - 1].w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (W == 1)
        v[e] = __uint_as_float(e % 2 ? w[e / 2] & 0xFFFF0000u : w[e / 2] << 16);
      else
        v[e] = __uint_as_float(w[e]);
    }
  };
  uint4 r[QV][W];
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < QV; ++i) {
    const int c = t + tpr * i;
    if (live && c < nv) load(c, r[i]);
  }
  for (int c = t + tpr * QV; live && c < nv; c += tpr) {
    uint4 u[W];
    float v[8];
    load(c, u);
    unpack(u, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
#pragma unroll
  for (int i = 0; i < QV; ++i) {
    if (live && t + tpr * i < nv) {
      float v[8];
      unpack(r[i], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
    }
  }
  m = wtt::warp_max(m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  const int w0 = (threadIdx.x / tpr) * (tpr / 32);
  for (int i = 1; i < tpr / 32; ++i) m = fmaxf(m, red[w0 + i]);
  m = fmaxf(m, red[w0]);
  float scale, inv;
  row_scale(m, scale, inv);
  auto store = [&](const float* v, int c) {
    unsigned w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e / 4] |= (unsigned)(quantize<MUL_INV>(v[e], scale, inv) & 0xFF) << (8 * (e % 4));
    *reinterpret_cast<uint2*>(qr + 8 * c) = make_uint2(w[0], w[1]);
  };
#pragma unroll
  for (int i = 0; i < QV; ++i) {
    const int c = t + tpr * i;
    if (live && c < nv) {
      float v[8];
      unpack(r[i], v);
      store(v, c);
    }
  }
  for (int c = t + tpr * QV; live && c < nv; c += tpr) {
    uint4 u[W];
    float v[8];
    load(c, u);
    unpack(u, v);
    store(v, c);
  }
  if (live && t == 0) xs[row] = scale;
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four packed int4 values (16 bits, value j in bits 4j..4j+3) -> four
// sign-extended int8 bytes (byte j = value j): spread the nibbles to the
// bytes, then copy each nibble's sign bit (bit 3 of its byte) into bits 4-7
// of the same byte (s * 0x1E sets bits 4..7 from bit 3, no carry across
// bytes).
__device__ __forceinline__ unsigned expand4(unsigned h) {
  const unsigned x = (h & 0xFu) | ((h & 0xF0u) << 4) | ((h & 0xF00u) << 8) | ((h & 0xF000u) << 12);
  const unsigned s = x & 0x08080808u;
  return x | (s * 0x1Eu);
}

// rows r[0..3] hold 4 bytes (n0..n3) of k0..k3; w[j] = the 4 k bytes of n_j.
__device__ __forceinline__ void transpose4x4(const unsigned* r, unsigned* w) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}


// Two adjacent outputs, one 4- (bf16) or 8-byte (f32) store; the kernels
// compute each as ((float)acc * xs) * ws, as JAX.
template <typename O>
__device__ __forceinline__ void store_pair(O* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(__float2bfloat16(a), __float2bfloat16(b));
}
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---------------------------------------------------------------- M <= 64
// One launch: the activation rows are quantized inside the GEMM. A cluster
// of `ksplit` blocks splits K; each block takes 128 columns, a K slice of
// ks = K / ksplit and 8 rows (grid.y = ceil(M / 8) row chunks).
//   0-2. one thread sets up three mbarriers (the x rows, the ranks'
//      partial maxima, the ranks' shares of the sums); warp 0 brings the x
//      rows in by bulk copy (the slice, or with `whole` the whole rows: a
//      max is exact in any order, and a small x is cheaper read whole by
//      every block than exchanged); every warp issues the loads of its
//      first two weight steps (32 k rows x 128 columns each, 16 bytes a
//      thread and k row; int4: 8 bytes, 16 nibbles), in flight during
//      steps 3-6;
//   3-5. each row's absmax, over the slice (then sent to every rank with
//      `st.async` and read back once every rank's has arrived) or over the
//      whole row; the row scales;
//   6. the block quantizes its own slice (rint of the IEEE quotient);
//   7. mma.sync.m16n8k32 s8 with the WEIGHT as the A operand (16 output
//      columns x 32 k) and the activation as B (32 k x 8 rows). A
//      thread's 8 k rows x 16 columns are transposed
//      in registers (__byte_perm 4 x 4 blocks) into the k-consecutive
//      words the instruction takes; the k order inside an instruction is
//      permuted the same way for both operands (thread quad t holds k
//      8t..8t+3 and 8t+4..8t+7), so the activation fragment is one 8-byte
//      shared load. The step after next is loaded during a step's
//      products;
//   8. the warps store their int32 tiles, the block sums them (exact) and
//      sends each share of its sum to the block that owns it (rank q owns
//      outputs [q * share, (q + 1) * share) of the rows x 128) with
//      `st.async`; each block sums its share over the ranks once its
//      mbarrier has every rank's bytes, and writes the epilogue.
// No thread waits on a remote load or a release barrier (which compiles to
// a full memory fence and would wait for the weight loads in flight); the
// only cluster barrier is a relaxed arrive at the start, waited on before
// the first remote store. Integer sums are exact in any order, so the
// output is bit-equal to the plain version whatever the plan. The plan
// (ksplit, whole) is the wrapper's (`ops/kernels/dequant_matmul.py::
// plan_small`, from `tools/sweep_k6_plan.py`; blocks of 8 rows beat one
// block over 24 rows at M = 20 at every decode shape).
constexpr int SMALL_M = 64;
constexpr int SK_WARPS = THREADS / 32;
constexpr int SK_BN = 128;     // columns a block (8 thread groups x 16)
constexpr int SK_ROWS = 8;     // activation rows a block (one n8 tile)
constexpr int SK_MAX_SPLIT = 8;  // portable cluster size
// A warp's int32 tile: element (r, c) at r * SK_TS + c + c / 16. A warp's
// stores touch rows 2t (+1) and columns 16g + 2j: the skew of one word a
// 16-column group and a row stride of 148 words (2 rows = 8 banks apart)
// put its 32 lanes on 32 banks.
constexpr int SK_TS = 148;
__device__ __forceinline__ int tile_at(int r, int c) { return r * SK_TS + c + (c >> 4); }


// 16 columns of one k row: int8, one 16-byte load; packed int4, one
// 8-byte load of 16 nibbles. word(r, q) gives columns 4q..4q+3 as four
// int8 bytes (int4 sign-extended by expand4).
template <bool INT4>
struct WRow;
template <>
struct WRow<false> {
  uint4 v;
  __device__ __forceinline__ void load(const int8_t* wq, long long k, int col, int N) {
    v = __ldg(reinterpret_cast<const uint4*>(wq + k * N + col));
  }
  __device__ __forceinline__ unsigned word(int q) const {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  }
};
template <>
struct WRow<true> {
  uint2 v;
  __device__ __forceinline__ void load(const int8_t* wq, long long k, int col, int N) {
    v = __ldg(reinterpret_cast<const uint2*>(reinterpret_cast<const uint8_t*>(wq) +
                                             k * (N / 2) + col / 2));
  }
  __device__ __forceinline__ unsigned word(int q) const {
    const unsigned h = q < 2 ? v.x : v.y;
    return expand4(q & 1 ? h >> 16 : h & 0xFFFFu);
  }
};

// |x| max of one 16-byte vector (8 bf16 or 4 f32)
template <typename T>
__device__ __forceinline__ float absmax16(uint4 u) {
  float f[16 / sizeof(T)];
  wtt::Vec16<T>::load(reinterpret_cast<const T*>(&u), f);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) m = fmaxf(m, fabsf(f[i]));
  return m;
}

// Distributed shared memory without a cluster barrier: `st.async` stores
// into another block's shared memory and counts the bytes against an
// mbarrier there, so the receiver waits on its own barrier and no thread
// waits for its earlier loads (a release barrier compiles to a full memory
// fence, which would wait for the weight loads in flight).
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(wtt::smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, int4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
// One row of x into shared memory by the bulk-copy (TMA) engine, counted
// against `bar`: the loads of the weights keep the load pipe to themselves.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(wtt::smem_u32(dst)), "l"(src), "r"(bytes), "r"(wtt::smem_u32(bar))
      : "memory");
}

// Shared memory of the split-K kernel for `rows` activation rows of a
// ks-wide K slice (`xrows` rows of K when every block reads whole rows): a
// region that holds first the raw x rows and the slice's int8 copy (rows
// padded by 16 bytes against bank conflicts), then the warps' int32 tiles;
// the ranks' shares of their tiles (8 x (rows x 128 / 8 + 4) words), the
// ranks' partial maxima (8 x 8), the row scales and inverses, and three
// mbarriers.
__host__ __device__ constexpr int splitk_xraw(int rows, int ks, int K, int xrows, int x_bytes) {
  return (rows * ks > xrows * K ? rows * ks : xrows * K) * x_bytes;
}
__host__ __device__ constexpr int splitk_region(int rows, int ks, int K, int xrows, int x_bytes) {
  return splitk_xraw(rows, ks, K, xrows, x_bytes) + rows * (ks + 16) > SK_WARPS * rows * SK_TS * 4
             ? splitk_xraw(rows, ks, K, xrows, x_bytes) + rows * (ks + 16)
             : SK_WARPS * rows * SK_TS * 4;
}
__host__ __device__ constexpr int splitk_smem(int rows, int ks, int K, int xrows, int x_bytes) {
  return splitk_region(rows, ks, K, xrows, x_bytes) +
         SK_MAX_SPLIT * (rows * SK_BN / SK_MAX_SPLIT + 4) * 4 + SK_MAX_SPLIT * SK_ROWS * 4 +
         2 * SK_ROWS * 4 + 3 * 8;
}

// 8 x values from shared memory as floats (one 16-byte vector of bf16, two
// of f32)
template <typename T>
__device__ __forceinline__ void load8_f32(const T* p, float* f) {
  wtt::Vec16<T>::load(p, f);
  if constexpr (sizeof(T) == 4) wtt::Vec16<T>::load(p + 4, f + 4);
}

template <typename T, typename O, bool INT4>
__global__ void __launch_bounds__(THREADS, 1)
gemm_splitk_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
                   const float* __restrict__ ws, O* __restrict__ out, int M, int K, int N,
                   int ks, int mul_inv, int whole) {
  constexpr int ROWS = SK_ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ksplit = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / ksplit) * SK_BN;
  const int k0 = rank * ks;
  const int m0 = blockIdx.y * ROWS;
  const int mb = min(ROWS, M - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int xstride = ks + 16;
  const int steps = ks / 32;
  const int xrows = whole ? ROWS : 0;             // the host's layout
  const int ldx = whole ? K : ks;                 // x elements a row in xraw
  // outputs a rank owns: a multiple of 4, so a thread moves 16 bytes
  const int share = (ROWS * SK_BN / 4 + ksplit - 1) / ksplit * 4;
  const int total = mb * SK_BN;
  const int owned = max(0, min(total, (rank + 1) * share) - rank * share);
  T* xraw = reinterpret_cast<T*>(smem);  // [mb][ldx]
  int8_t* xq = reinterpret_cast<int8_t*>(smem + splitk_xraw(ROWS, ks, K, xrows, sizeof(T)));
  int* wtile = reinterpret_cast<int*>(smem);  // after the products: [warp][tile_at(ROWS, 0)]
  int* recv = reinterpret_cast<int*>(smem + splitk_region(ROWS, ks, K, xrows, sizeof(T)));
  float* pabs = reinterpret_cast<float*>(recv + SK_MAX_SPLIT * (ROWS * SK_BN / SK_MAX_SPLIT + 4));
  float* xsc = pabs + SK_MAX_SPLIT * SK_ROWS;  // [SK_ROWS]
  float* xinv = xsc + SK_ROWS;                 // [SK_ROWS]
  uint64_t* bars = reinterpret_cast<uint64_t*>(xinv + SK_ROWS);  // x, maxima, sums
  const int xbytes = ldx * (int)sizeof(T);

  // 0. the barriers, each expecting its bytes: the x rows, every rank's
  //    partial maxima, every rank's part of this rank's outputs
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) wtt::mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    wtt::mbar_expect_tx(&bars[0], mb * xbytes);
    wtt::mbar_expect_tx(&bars[1], whole ? 0 : ksplit * mb * 4);
    wtt::mbar_expect_tx(&bars[2], ksplit * owned * 4);
  }
  __syncthreads();
  // 1. the x rows (the slice, or whole rows), one bulk copy a row
  if (warp == 0 && lane < mb)
    bulk_copy(xraw + lane * ldx, x + (long long)(m0 + lane) * K + (whole ? 0 : k0), xbytes,
              &bars[0]);

  // 2. this warp's first two weight steps
  WRow<INT4> cur[8], nxt[8];
  auto load = [&](int s, WRow<INT4>* r) {
    const long long k = k0 + s * 32 + 8 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i].load(wq, k + i, n0 + 16 * g, N);
  };
  int s = warp;
  if (s < steps) load(s, cur);
  if (s + SK_WARPS < steps) load(s + SK_WARPS, nxt);
  // every block of the cluster runs (and has its barriers) before anyone
  // stores into its shared memory: the wait comes before the first store
  wtt::cluster_arrive_relaxed();

  // 3. each row's maximum |x| over the slice (`whole`: the whole row) into
  //    xsc as float bits (non-negative: int order is float order); a row
  //    is read by 8 / mb warps (one warp a row from 8 rows on)
  constexpr int VE = 16 / sizeof(T);
  int* xmax = reinterpret_cast<int*>(xsc);  // until step 5
  if (tid < SK_ROWS) xmax[tid] = 0;
  wtt::mbar_wait(&bars[0], 0);
  __syncthreads();
  const int wpr = mb >= SK_WARPS ? 1 : SK_WARPS / mb;  // warps a row
  for (int r = warp / wpr; r < mb; r += SK_WARPS / wpr) {
    float m = 0.f;
    for (int v = (warp % wpr) * 32 + lane; v < ldx / VE; v += wpr * 32)
      m = fmaxf(m, absmax16<T>(*reinterpret_cast<const uint4*>(xraw + r * ldx + v * VE)));
    m = wtt::warp_max(m);
    if (lane == 0) atomicMax(xmax + r, __float_as_int(m));
  }
  __syncthreads();

  // 4. without `whole`, the partial maxima to every rank (thread tid: row
  //    tid / 8 to rank tid % 8), and every rank's here; the block barrier
  //    keeps step 5's writes of xsc after every send has read it
  if (!whole) {
    wtt::cluster_wait();
    if (tid < mb * SK_MAX_SPLIT && tid % SK_MAX_SPLIT < ksplit) {
      const int q = tid % SK_MAX_SPLIT, r = tid / SK_MAX_SPLIT;
      st_async(remote(pabs + rank * SK_ROWS + r, q), xsc[r], remote(&bars[1], q));
    }
    __syncthreads();
    wtt::mbar_wait(&bars[1], 0);
  }

  // 5. the row scales
  if (tid < mb) {
    float a = xsc[tid];
    if (!whole) {
      a = 0.f;
#pragma unroll
      for (int q = 0; q < SK_MAX_SPLIT; ++q)
        if (q < ksplit) a = fmaxf(a, pabs[q * SK_ROWS + tid]);
    }
    row_scale(a, xsc[tid], xinv[tid]);
    if (!mul_inv) xinv[tid] = 1.f / xsc[tid];  // K6: the reciprocal of the scale
  }
  __syncthreads();

  // 6. this block's int8 slice, eight k a thread; the rows past M stay as
  //    they are: their products land in outputs no one stores. K7's
  //    rounding is rint(x * inv); K6's is rint(x / scale) with the IEEE
  //    quotient, taken from x * (1 / scale) as the note above
  //    `quantize_rows` argues, the quotient itself only where a
  //    lane needs it (a vote keeps the division off the warps that do not)
  const int gpr = ks / 8;
  const int xoff = whole ? k0 : 0;
  for (int base = warp * 32; base < mb * gpr; base += THREADS) {
    const int i = base + lane;
    const bool on = i < mb * gpr;
    const int r = on ? i / gpr : 0, c = (i - r * gpr) * 8;
    const float sc = xsc[r], iv = xinv[r];
    float f[8], y[8];
    if (on) load8_f32(xraw + r * ldx + xoff + c, f);
    bool exact[8], any = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y[j] = f[j] * iv;
      exact[j] = !mul_inv && !(fabsf(y[j] - floorf(y[j]) - 0.5f) > 0x1p-13f);
      any |= exact[j];
    }
    // only the flagged values: dividing a zero (or a denormal) takes the
    // division's slow path, a subroutine call
    if (__any_sync(0xffffffffu, on && any) && on && any) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (exact[j]) y[j] = f[j] / sc;
    }
    unsigned w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qv = (int)fminf(fmaxf(rintf(y[j]), -127.f), 127.f);
      w[j >> 2] |= ((unsigned)qv & 0xFFu) << (8 * (j & 3));
    }
    if (on) *reinterpret_cast<uint2*>(xq + r * xstride + c) = make_uint2(w[0], w[1]);
  }
  __syncthreads();

  // 7. the products: per step, 8 column pairs
  int acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  const bool worked = s < steps;
  while (s < steps) {
    const uint2 b = *reinterpret_cast<const uint2*>(xq + g * xstride + s * 32 + 8 * t);
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // columns 4q..4q+3 of the thread's 16
      unsigned lo[4], hi[4], tl[4], th[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        lo[r] = cur[r].word(q);
        hi[r] = cur[4 + r].word(q);
      }
      transpose4x4(lo, tl);  // tl[j]: k 8t..8t+3 of column 4q + j
      transpose4x4(hi, th);  // th[j]: k 8t+4..8t+7
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // columns 4q+2p (row g), 4q+2p+1 (row g+8)
        const unsigned a[4] = {tl[2 * p], tl[2 * p + 1], th[2 * p], th[2 * p + 1]};
        mma_s8(acc[2 * q + p], a, b.x, b.y);
      }
    }
    s += SK_WARPS;
#pragma unroll
    for (int i = 0; i < 8; ++i) cur[i] = nxt[i];
    if (s + SK_WARPS < steps) load(s + SK_WARPS, nxt);
  }

  // 8. each warp's tile (over x's region, now read by no one), the block's
  //    sum of them sent share by share to the owning ranks, then each
  //    rank's sum over the ranks (once its barrier has every rank's bytes)
  //    and the epilogue
  __syncthreads();
  if (worked) {
    int* wt = wtile + warp * ROWS * SK_TS;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = 2 * t, c = 16 * g + 2 * j;
      wt[tile_at(r, c)] = acc[j][0];
      wt[tile_at(r, c + 1)] = acc[j][2];
      wt[tile_at(r + 1, c)] = acc[j][1];
      wt[tile_at(r + 1, c + 1)] = acc[j][3];
    }
  }
  __syncthreads();
  if (whole) wtt::cluster_wait();
  const int nwork = min(SK_WARPS, steps);
  for (int e = 4 * tid; e < total; e += 4 * THREADS) {  // four outputs of one row and owner
    const int r = e / SK_BN, c = e - r * SK_BN, q = e / share;
    int sum[4] = {0, 0, 0, 0};
#pragma unroll
    for (int w = 0; w < SK_WARPS; ++w)
      if (w < nwork) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[j] += wtile[w * ROWS * SK_TS + tile_at(r, c + j)];
      }
    st_async(remote(recv + rank * share + (e - q * share), q),
             make_int4(sum[0], sum[1], sum[2], sum[3]), remote(&bars[2], q));
  }
  wtt::mbar_wait(&bars[2], 0);
  for (int e = rank * share + 4 * tid; e < rank * share + owned; e += 4 * THREADS) {
    int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int q = 0; q < SK_MAX_SPLIT; ++q)
      if (q < ksplit) {
        const int4 v = *reinterpret_cast<const int4*>(recv + q * share + e - rank * share);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    const int r = e / SK_BN, c = e - r * SK_BN;
    const float x_s = xsc[r];
    O* o = out + (long long)(m0 + r) * N + n0 + c;
    store_pair<O>(o, ((float)sum.x * x_s) * ws[n0 + c], ((float)sum.y * x_s) * ws[n0 + c + 1]);
    store_pair<O>(o + 2, ((float)sum.z * x_s) * ws[n0 + c + 2],
                  ((float)sum.w * x_s) * ws[n0 + c + 3]);
  }
}

// ---------------------------------------------------------------- M > 64
// Two launches. `prep_kernel` runs two jobs side by side in one grid: its
// first blocks quantize the rows (`quantize_rows`, held in registers) into the scratch xq (M, K) int8 and xs (M,) f32; the others transpose the
// weight, 64 k x 64 columns a block, into the scratch wt (N, K) int8:
// K-major, the layout wgmma takes for 8-bit operands (packed int4 is
// sign-extended on the way, so the GEMM reads int8 either way). Then
// `gemm_big_kernel`, a warp-specialised wgmma GEMM over 128 x BN output
// tiles (BN = 256 or 128, whole K), int8 x int8 -> int32 on the tensor
// cores (`wgmma.mma_async ... .s32.s8.s8`):
//   * a persistent grid, a block an SM, walks the output tiles (tile
//     blockIdx.x, then every gridDim.x-th), so a block's loads of its next
//     tile overlap its epilogue of the last one;
//   * one producer thread issues every TMA copy into a ring of STAGES
//     stages: the xq tile (128 rows x 128 k bytes) and the wt tile (BN rows
//     x 128 k bytes), both with the 128-byte swizzle, the A and B operands
//     as they land;
//   * two consumer warpgroups (64 rows each) issue 4 wgmma of k = 32 a
//     stage, keep one group in flight and release the previous stage;
//   * epilogue: ((float)acc * xs[m]) * ws[n] in the output type, rows past
//     M masked (TMA fills them with zeros).
// Transposing the weight inside the GEMM instead (every block its tiles,
// by three warps of the producer warpgroup, a stage at a time) was measured
// slower: each weight tile was transposed once for every row tile (24 times
// at M = 3000), and the transposing warps, not the tensor cores, set the
// pace; so was splitting K over a cluster of two blocks once the ring had
// four to six stages (PERF.md section 6). The tile width is the wrapper's
// (`ops/kernels/dequant_matmul.py::plan_big`, from
// `tools/sweep_k7_plan.py`).
constexpr int BG_BM = 128;        // rows of a tile: two consumer warpgroups of 64
constexpr int BG_BK = 128;        // k of a stage: one 128-byte swizzle row of int8
constexpr int BG_THREADS = 384;   // producer warpgroup + two consumers
constexpr int BG_REGS = 168;      // 65536 / 384, rounded down to a multiple of 8
constexpr int BG_PRODUCER_REGS = 40;
constexpr int BG_CONSUMER_REGS = 232;
static_assert((BG_REGS - BG_PRODUCER_REGS) * 128 >= (BG_CONSUMER_REGS - BG_REGS) * 256,
              "setmaxnreg: the consumers would wait for registers no one frees");
constexpr int TP = 64;            // k rows and columns of a transpose block

// Shared memory of one block: the A and B stages, then the mbarriers.
template <int BN>
struct Big {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int A_BYTES = BG_BM * BG_BK;
  static constexpr int B_BYTES = BN * BG_BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int ACC = BN / 2;  // int32 sums of a consumer thread
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int SMEM = 1024 /* alignment slack */ + BARS + 2 * STAGES * 8;
};

// The first `qblocks` blocks quantize THREADS / tpr rows each; every other
// block transposes one 64 x 64 tile of the weight: a thread reads a 4 (k)
// x 4 (column) byte block (int4: four 16-bit halves, expand4), transposes
// it with __byte_perm into shared memory, and the block writes the tile's
// 64 rows of wt 16 bytes a thread.
template <typename T, bool MUL_INV, bool INT4>
__global__ void __launch_bounds__(THREADS)
prep_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
            const int8_t* __restrict__ wq, int8_t* __restrict__ wt, int M, int K, int N,
            int qblocks, int tpr) {
  if ((int)blockIdx.x < qblocks) {
    quantize_rows<T, MUL_INV>(x, xq, xs, M, K, blockIdx.x, tpr);
    return;
  }
  __shared__ unsigned tile[TP][TP / 4 + 1];  // [column][k word], padded
  const int t = blockIdx.x - qblocks;
  const int k0 = (t % (K / TP)) * TP, n0 = (t / (K / TP)) * TP;
  const int kb = threadIdx.x / 16, nb = threadIdx.x % 16;  // a 4 x 4 block
  unsigned r[4], w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long k = k0 + 4 * kb + i;
    if constexpr (INT4)
      r[i] = expand4(*reinterpret_cast<const unsigned short*>(
          reinterpret_cast<const uint8_t*>(wq) + k * (N / 2) + (n0 + 4 * nb) / 2));
    else
      r[i] = *reinterpret_cast<const unsigned*>(wq + k * N + n0 + 4 * nb);
  }
  transpose4x4(r, w);  // w[j]: k 4 kb..4 kb + 3 of column 4 nb + j
#pragma unroll
  for (int j = 0; j < 4; ++j) tile[4 * nb + j][kb] = w[j];
  __syncthreads();
  const int n = threadIdx.x / 4, q = threadIdx.x % 4;  // a row of wt, 16 bytes
  *reinterpret_cast<uint4*>(wt + (long long)(n0 + n) * K + k0 + 16 * q) =
      make_uint4(tile[n][4 * q], tile[n][4 * q + 1], tile[n][4 * q + 2], tile[n][4 * q + 3]);
}

// D(64 x 128, s32) += A(64 x 32, smem, K-major) * B(32 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// D(64 x 256, s32) += A(64 x 32, smem, K-major) * B(32 x 256, smem, K-major)
__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 256) wgmma_s8_n256(d, da, db);
  else wgmma_s8_n128(d, da, db);
}

template <int N>
__device__ __forceinline__ void fence_regs_s32(int* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A consumer thread's outputs of a tile: rows m and m + 8 (m past the
// tile's first row by the thread's fragment row), columns n + 8 j and
// n + 8 j + 1: ((float)acc * xs[m]) * ws[n] in the output type, rows past
// M masked.
template <typename O, int BN>
__device__ __forceinline__ void epilogue(const int* acc, const float* __restrict__ xs,
                                         const float* __restrict__ ws, O* __restrict__ out,
                                         int M, int N, int m, int n) {
  float x_s[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) x_s[half] = m + 8 * half < M ? xs[m + 8 * half] : 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float w0 = ws[n + 8 * j], w1 = ws[n + 8 * j + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (m + 8 * half >= M) continue;
      store_pair<O>(out + (long long)(m + 8 * half) * N + n + 8 * j,
                    ((float)acc[4 * j + 2 * half] * x_s[half]) * w0,
                    ((float)acc[4 * j + 2 * half + 1] * x_s[half]) * w1);
    }
  }
}

template <typename O, int BN>
__global__ void __launch_bounds__(BG_THREADS, 1)
gemm_big_kernel(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap b_map, const float* __restrict__ xs,
                const float* __restrict__ ws, O* __restrict__ out, int M, int N, int K) {
  using L = Big<BN>;
  constexpr int S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 B: align the tiles to it
  unsigned char* smem = smem_raw + ((1024 - (wtt::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sA = smem;                 // [S][128 rows][128 B]
  unsigned char* sB = sA + S * L::A_BYTES;  // [S][BN rows][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);  // [S]
  uint64_t* empty = full + S;                                     // [S]

  const int tiles_n = N / BN;
  const int tiles = tiles_n * ((M + BG_BM - 1) / BG_BM);
  const int k_tiles = K / BG_BK;
  const int wg = threadIdx.x / 128;  // 0 producer, 1-2 consumers
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      wtt::mbar_init(&full[s], 1);
      wtt::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(BG_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int g = 0;  // stages issued by this block, over all its tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % tiles_n) * BN, m0 = (tile / tiles_n) * BG_BM;
        for (int t = 0; t < k_tiles; ++t, ++g) {
          const int s = g % S;
          if (g >= S) wtt::mbar_wait(&empty[s], ((g / S) & 1) ^ 1);
          wtt::mbar_expect_tx(&full[s], L::STAGE);
          wtt::tma_load_2d(sA + s * L::A_BYTES, &a_map, &full[s], t * BG_BK, m0);
          wtt::tma_load_2d(sB + s * L::B_BYTES, &b_map, &full[s], t * BG_BK, n0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(BG_CONSUMER_REGS));
  const int c = wg - 1;  // consumer: tile rows [c*64, c*64 + 64)
  const int t128 = threadIdx.x % 128;
  const int cw = t128 / 32;

  // This thread's rows of the accumulator fragment (within the 64) and the
  // first of its two columns in every 8-column block.
  const int r_lo = cw * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  int g = 0;  // stages consumed, over all this block's tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % tiles_n) * BN, m0 = (tile / tiles_n) * BG_BM;
    int acc[L::ACC];
#pragma unroll
    for (int i = 0; i < L::ACC; ++i) acc[i] = 0;
    for (int t = 0; t < k_tiles; ++t, ++g) {
      const int s = g % S;
      wtt::mbar_wait(&full[s], (g / S) & 1);
      const uint64_t da = wtt::sw128_desc(sA + s * L::A_BYTES + c * 64 * 128);
      const uint64_t db = wtt::sw128_desc(sB + s * L::B_BYTES);
      wtt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BG_BK / 32; ++kk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk);
      wtt::wgmma_commit();
      // the previous stage's products are done: release it
      wtt::wgmma_wait1();
      if (t > 0 && lane == 0) wtt::mbar_arrive(&empty[(g - 1) % S]);
    }
    wtt::wgmma_wait0();
    fence_regs_s32<L::ACC>(acc);
    if (lane == 0) wtt::mbar_arrive(&empty[(g - 1) % S]);  // the tile's last stage
    epilogue<O, BN>(acc, xs, ws, out, M, N, m0 + c * 64 + r_lo, n0 + col);
  }
}

template <typename T, typename O, bool INT4>
int launch_splitk(const void* x, const int8_t* wq, const float* ws, void* out, int M, int K,
                  int N, int ksplit, bool big, bool whole, cudaStream_t st) {
  const int ks = K / ksplit;
  const int smem = splitk_smem(SK_ROWS, ks, K, whole ? SK_ROWS : 0, sizeof(T));
  auto kernel = gemm_splitk_kernel<T, O, INT4>;
  static int opted = 48 * 1024;  // this instantiation's dynamic limit so far
  if (smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N / SK_BN) * ksplit, (M + SK_ROWS - 1) / SK_ROWS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ksplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, (const T*)x, wq, ws, (O*)out, M, K, N, ks,
                                 (int)big, (int)whole);
}

// A 2-D byte map (cols, rows) of a row-major matrix, a (128, box_rows) box
// with the 128-byte swizzle. xq and wt are fresh scratch each call, so the
// map is encoded directly (not kept by `wtt::cached_map`).
bool byte_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const wtt::EncodeTiled encode = wtt::encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)BG_BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once per instantiation: the register count the setmaxnreg split assumes
// (the consumers' setmaxnreg.inc would otherwise wait forever) and the
// dynamic shared memory opt-in.
template <typename O, int BN>
int configure_big() {
  static int state = -1;
  if (state < 0) {
    auto kernel = gemm_big_kernel<O, BN>;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs != BG_REGS) return (int)cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Big<BN>::SMEM);
    if (err != cudaSuccess) return (int)err;
    state = 0;
  }
  return state;
}

template <typename O, int BN>
int launch_big(const int8_t* xq, const float* xs, const int8_t* wt, const float* ws, void* out,
               int M, int K, int N, cudaStream_t st) {
  const int err = configure_big<O, BN>();
  if (err != cudaSuccess) return err;
  CUtensorMap am, bm;
  if (!byte_map(&am, xq, M, K, BG_BM) || !byte_map(&bm, wt, N, K, BN))
    return (int)cudaErrorInvalidValue;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  const int tiles = (N / BN) * ((M + BG_BM - 1) / BG_BM);
  gemm_big_kernel<O, BN><<<min(tiles, n_sm), BG_THREADS, Big<BN>::SMEM, st>>>(am, bm, xs, ws,
                                                                            (O*)out, M, N, K);
  return (int)cudaGetLastError();
}

// How a call runs: the split-K kernel (ksplit > 0, with `whole`), or the
// prep pass and the tile kernel (ksplit = 0) over bn-wide tiles; `big`
// picks K7's rounding.
struct Plan {
  int ksplit, bn;
  bool whole, big, int4;
};

// Scratch of the M > 64 path: xq (M, K) int8, xs (M,) f32, wt (N, K) int8.
struct Scratch {
  int8_t* xq;
  float* xs;
  int8_t* wt;
};

template <typename T, typename O, bool INT4>
int launch(const void* x, const int8_t* wq, const float* ws, void* out, const Scratch& sc,
           int M, int K, int N, const Plan& p, cudaStream_t st) {
  if (p.ksplit > 0)
    return launch_splitk<T, O, INT4>(x, wq, ws, out, M, K, N, p.ksplit, p.big, p.whole, st);
  // threads a row: the fewest (a power of two, 32 to 256) that hold the
  // row's vectors QV a thread
  int tpr = 32;
  while (tpr < THREADS && tpr * QV * 8 < K) tpr *= 2;
  const int qblocks = (M + THREADS / tpr - 1) / (THREADS / tpr);
  // the one limit of the two launches' 1-D grids: the prep pass's blocks
  if ((long long)qblocks + (long long)(K / TP) * (N / TP) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int blocks = qblocks + (K / TP) * (N / TP);
  if (p.big)
    prep_kernel<T, true, INT4><<<blocks, THREADS, 0, st>>>((const T*)x, sc.xq, sc.xs, wq, sc.wt,
                                                           M, K, N, qblocks, tpr);
  else
    prep_kernel<T, false, INT4><<<blocks, THREADS, 0, st>>>((const T*)x, sc.xq, sc.xs, wq, sc.wt,
                                                            M, K, N, qblocks, tpr);
  const int err = (int)cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.bn == 256) return launch_big<O, 256>(sc.xq, sc.xs, sc.wt, ws, out, M, K, N, st);
  return launch_big<O, 128>(sc.xq, sc.xs, sc.wt, ws, out, M, K, N, st);
}

template <typename T, typename O>
int launch_w(const void* x, const int8_t* wq, const float* ws, void* out, const Scratch& sc,
             int M, int K, int N, const Plan& p, cudaStream_t st) {
  if (p.int4) return launch<T, O, true>(x, wq, ws, out, sc, M, K, N, p, st);
  return launch<T, O, false>(x, wq, ws, out, sc, M, K, N, p, st);
}

}  // namespace

// x: (M, K) contiguous, 16-byte aligned, x_dtype 0 = bf16, 1 = f32; wq:
// (K, N) int8 row-major, or with w_int4 = 1 (K, N / 2) uint8 of packed int4
// (low nibble = even column); ws: (N,) f32; out: (M, N), out_dtype 0 =
// bf16, 1 = f32. big = 0: K6's rounding (x / xs), 1: K7's (x * 127 /
// absmax). ksplit > 0 (M <= 64): the one-launch split-K kernel over a
// cluster of ksplit blocks (K / ksplit a multiple of 32), 8 rows a block;
// the scratch and bn are unused. whole = 1 (split-K only): every
// block takes each row's absmax over the whole row (read from the L2)
// instead of exchanging slice maxima in the cluster. ksplit = 0: the prep
// pass into the scratch xq (M, K) int8, xs (M,) f32 and wt (N, K) int8
// (all 16-byte aligned), then the wgmma tile kernel over 128 x bn tiles
// (bn 128 or 256, a divisor of N). Returns cudaErrorInvalidValue for
// shapes, plans or pointers the kernels do not take,
// cudaErrorInvalidConfiguration if the tile kernel was not compiled to the
// register count its setmaxnreg split assumes.
extern "C" int wtt_w8a8_matmul(const void* x, const void* wq, const void* ws, void* out,
                               void* xq, void* xs, void* wt, int M, int K, int N, int x_dtype,
                               int out_dtype, int big, int w_int4, int ksplit, int whole,
                               int bn, void* stream) {
  auto misaligned = [](const void* p, unsigned a) {
    return reinterpret_cast<unsigned long long>(p) % a != 0;
  };
  if (M < 1 || K < 128 || K % 128 || N < 128 || N % 128 ||
      x_dtype < 0 || x_dtype > 1 || out_dtype < 0 || out_dtype > 1 || misaligned(wq, 16) ||
      misaligned(x, 16) || misaligned(out, 8) || ksplit < 0 || ksplit > SK_MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  if (ksplit > 0 &&
      (M > SMALL_M || K % (32 * ksplit) ||
       splitk_smem(SK_ROWS, K / ksplit, K, whole ? SK_ROWS : 0, x_dtype == 0 ? 2 : 4) >
           227 * 1024))
    return (int)cudaErrorInvalidValue;
  if (ksplit == 0 &&
      (misaligned(xq, 16) || misaligned(wt, 16) || xs == nullptr || (bn != 128 && bn != 256) ||
       N % bn))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* w = (const int8_t*)wq;
  const float* s = (const float*)ws;
  const Scratch sc{(int8_t*)xq, (float*)xs, (int8_t*)wt};
  const Plan p{ksplit, bn, whole != 0, big != 0, w_int4 != 0};
  int err;
  if (x_dtype == 0 && out_dtype == 0)
    err = launch_w<__nv_bfloat16, __nv_bfloat16>(x, w, s, out, sc, M, K, N, p, st);
  else if (x_dtype == 0)
    err = launch_w<__nv_bfloat16, float>(x, w, s, out, sc, M, K, N, p, st);
  else if (out_dtype == 0)
    err = launch_w<float, __nv_bfloat16>(x, w, s, out, sc, M, K, N, p, st);
  else
    err = launch_w<float, float>(x, w, s, out, sc, M, K, N, p, st);
  if (err != (int)cudaSuccess) return err;
  return (int)cudaGetLastError();
}
