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
//   * M > 64 (the encoder: M = 750 a window, W x 750 batched): one block
//     per row quantizes every row into scratch the wrapper allocates, then
//     `gemm_big_kernel` runs 128 x 128 output tiles: two launches that
//     count as one call. (Quantizing inside each tile, one launch, was
//     measured slower there: every block of a row tile repeats the row's
//     IEEE divisions.) The two functions differ only in the rounding (a
//     flag of the quantize step).
//
// The products are mma.sync.m16n8k32 s8 x s8 -> s32 on the tensor cores.
// The weight is (K, N) row-major int8 (N contiguous, the QTensor layout),
// but the instruction wants four consecutive k of one column in a register:
// a thread loads 4 (k) x 4 (n) byte blocks as four 32-bit words along N
// (neighbouring threads on neighbouring addresses) and transposes them with
// __byte_perm. Packed int4 weights (template flag INT4): (K, N / 2) uint8,
// two two's-complement nibbles a byte, the low nibble the even column
// (quantize.py's layout); `expand4` sign-extends four nibbles into the four
// bytes of the word the int8 load would have given, so the products and the
// epilogue are the int8 path's, bit-equal over the unpacked weight.
//
// Bound on the H100. At decode M (1, 5, 20 rows) the weight stream bounds
// it: 1280 x 3840 int8 is 4.9 MB, ~1.5 us at 3.35 TB/s (int4: 2.5 MB,
// ~0.7 us); 1280 x 1280 is 1.6 MB, ~0.5 us, where a launch's latency is
// several times the stream. The split-K kernel keeps each block's weight
// slice in flight (a block's 8 warps each load their first two 4 KB steps
// of 32 k rows x 128 columns into registers at the start, later steps
// during a step's products), with 80-240 blocks at the path's shapes.
// At M = 3000, K = 1280, N = 3840 the 29.5 G integer operations take
// ~15 us at 1979 TOP/s; the big-M kernel has no wgmma, TMA or cp.async
// pipeline, so it reaches a fraction of that (later PRs).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;           // K bytes per step
constexpr int A_STRIDE = BK + 16;  // 80 bytes: 16-byte aligned rows, no conflicts on reads
constexpr int B_STRIDE = BK + 4;   // 68 bytes: n-major rows of k, 32-bit reads

template <typename T>
__device__ __forceinline__ float load_f32(const T* p) { return wtt::to_f32(*p); }

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

// One block per row: absmax, the row scale and the int8 row.
template <typename T, bool MUL_INV>
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ xs, int K) {
  __shared__ float red[THREADS / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * K;
  float m = 0.f;
  for (int i = threadIdx.x; i < K; i += THREADS) m = fmaxf(m, fabsf(load_f32(xr + i)));
  m = wtt::warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  float absmax = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) absmax = fmaxf(absmax, red[w]);
  float scale, inv;
  row_scale(absmax, scale, inv);
  int8_t* qr = xq + row * K;
  for (int i = threadIdx.x; i < K; i += THREADS)
    qr[i] = (int8_t)quantize<MUL_INV>(load_f32(xr + i), scale, inv);
  if (threadIdx.x == 0) xs[row] = scale;
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

// The 4 int8 weights of columns [col, col + 4) of k row `row` as one
// 32-bit word (byte j = column col + j); INT4 reads them from the packed
// (K, N / 2) layout (col is a multiple of 4, so the load is 2-byte aligned).
template <bool INT4>
__device__ __forceinline__ unsigned load_w4(const int8_t* wq, long long row, int col, int N) {
  if constexpr (INT4) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(wq) + row * (N / 2) + col / 2;
    return expand4(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  return __ldg(reinterpret_cast<const unsigned*>(wq + row * N + col));
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
  //    `quantize_rows_kernel` argues, the quotient itself only where a
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
// grid (N / 128, ceil(M / 128)); 8 warps as 2 (m) x 4 (n), each 64 x 32.
constexpr int BG_BM = 128, BG_BN = 128;

template <typename O, bool INT4>
__global__ void __launch_bounds__(THREADS)
gemm_big_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                const int8_t* __restrict__ wq, const float* __restrict__ ws,
                O* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) unsigned char as[BG_BM * A_STRIDE];
  __shared__ __align__(16) unsigned char bs[BG_BN * B_STRIDE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * BG_BN, m0 = blockIdx.y * BG_BM;
  const int steps = K / BK;

  int acc[4][4][4] = {};
  uint4 ra[2];
  unsigned rb[2][4];
  auto load = [&](int s) {
    const int k0 = s * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of 16 bytes
      const int idx = tid + THREADS * i, r = idx >> 2, c = idx & 3;
      ra[i] = m0 + r < M ? *reinterpret_cast<const uint4*>(xq + (long long)(m0 + r) * K + k0 + c * 16)
                         : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 16 k-blocks x 32 n-blocks of 4 x 4 bytes
      const int kb = (tid >> 5) + 8 * i, nb = tid & 31;
#pragma unroll
      for (int r = 0; r < 4; ++r) rb[i][r] = load_w4<INT4>(wq, k0 + 4 * kb + r, n0 + 4 * nb, N);
    }
  };

  load(0);
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + THREADS * i, r = idx >> 2, c = idx & 3;
      *reinterpret_cast<uint4*>(as + r * A_STRIDE + c * 16) = ra[i];
      const int kb = (tid >> 5) + 8 * i, nb = tid & 31;
      unsigned w[4];
      transpose4x4(rb[i], w);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<unsigned*>(bs + (4 * nb + j) * B_STRIDE + 4 * kb) = w[j];
    }
    __syncthreads();
    if (s + 1 < steps) load(s + 1);  // in flight during the products below
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned char* bp = bs + (wn * 32 + nt * 8 + g) * B_STRIDE + ks + 4 * t;
        b[nt][0] = *reinterpret_cast<const unsigned*>(bp);
        b[nt][1] = *reinterpret_cast<const unsigned*>(bp + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned char* ap = as + (wm * 64 + mt * 16 + g) * A_STRIDE + ks + 4 * t;
        unsigned a[4];
        a[0] = *reinterpret_cast<const unsigned*>(ap);
        a[1] = *reinterpret_cast<const unsigned*>(ap + 8 * A_STRIDE);
        a[2] = *reinterpret_cast<const unsigned*>(ap + 16);
        a[3] = *reinterpret_cast<const unsigned*>(ap + 8 * A_STRIDE + 16);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = n0 + wn * 32 + nt * 8 + 2 * t;
    const float w0 = ws[c], w1 = ws[c + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * 64 + mt * 16 + g + 8 * h;
        if (r >= M) continue;
        const float x_s = xs[r];
        store_pair<O>(out + (long long)r * N + c,
                      ((float)acc[mt][nt][2 * h] * x_s) * w0,
                      ((float)acc[mt][nt][2 * h + 1] * x_s) * w1);
      }
    }
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

template <typename T, typename O, bool INT4>
int launch(const void* x, const int8_t* wq, const float* ws, void* out, int8_t* xq, float* xs,
           int M, int K, int N, int ksplit, bool big, bool whole, cudaStream_t st) {
  if (ksplit > 0) return launch_splitk<T, O, INT4>(x, wq, ws, out, M, K, N, ksplit, big, whole, st);
  if (big)
    quantize_rows_kernel<T, true><<<M, THREADS, 0, st>>>((const T*)x, xq, xs, K);
  else
    quantize_rows_kernel<T, false><<<M, THREADS, 0, st>>>((const T*)x, xq, xs, K);
  dim3 grid(N / BG_BN, (M + BG_BM - 1) / BG_BM);
  gemm_big_kernel<O, INT4><<<grid, THREADS, 0, st>>>(xq, xs, wq, ws, (O*)out, M, K, N);
  return (int)cudaSuccess;
}

template <typename T, typename O>
int launch_w(const void* x, const int8_t* wq, const float* ws, void* out, int8_t* xq, float* xs,
             int M, int K, int N, int ksplit, bool big, bool whole, bool int4,
             cudaStream_t st) {
  if (int4) return launch<T, O, true>(x, wq, ws, out, xq, xs, M, K, N, ksplit, big, whole, st);
  return launch<T, O, false>(x, wq, ws, out, xq, xs, M, K, N, ksplit, big, whole, st);
}

}  // namespace

// x: (M, K) contiguous, 16-byte aligned, x_dtype 0 = bf16, 1 = f32; wq:
// (K, N) int8 row-major, or with w_int4 = 1 (K, N / 2) uint8 of packed int4
// (low nibble = even column); ws: (N,) f32; out: (M, N), out_dtype 0 =
// bf16, 1 = f32. big = 0: K6's rounding (x / xs), 1: K7's (x * 127 /
// absmax). ksplit > 0 (M <= 64): the one-launch split-K kernel over a
// cluster of ksplit blocks (K / ksplit a multiple of 32), 8 rows a block;
// xq and xs are unused. ksplit = 0: the row-quantize pass
// into the scratch xq (M, K) int8 and xs (M,) f32, then the 128 x 128 tile
// kernel. whole = 1 (split-K
// only): every block takes each row's absmax over the whole row (read from
// the L2) instead of exchanging slice maxima in the cluster. Returns
// cudaErrorInvalidValue for shapes, plans or pointers the kernels do not
// take.
extern "C" int wtt_w8a8_matmul(const void* x, const void* wq, const void* ws, void* out,
                               void* xq, void* xs, int M, int K, int N, int x_dtype,
                               int out_dtype, int big, int w_int4, int ksplit, int whole,
                               void* stream) {
  auto misaligned = [](const void* p, unsigned a) {
    return reinterpret_cast<unsigned long long>(p) % a != 0;
  };
  if (M < 1 || M > 65535 * BG_BM || K < 128 || K % 128 || N < 128 || N % 128 ||
      x_dtype < 0 || x_dtype > 1 || out_dtype < 0 || out_dtype > 1 || misaligned(wq, 16) ||
      misaligned(out, 8) || ksplit < 0 || ksplit > SK_MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  if (ksplit > 0 &&
      (M > SMALL_M || K % (32 * ksplit) || misaligned(x, 16) ||
       splitk_smem(SK_ROWS, K / ksplit, K, whole ? SK_ROWS : 0, x_dtype == 0 ? 2 : 4) >
           227 * 1024))
    return (int)cudaErrorInvalidValue;
  if (ksplit == 0 && (misaligned(xq, 16) || xs == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* w = (const int8_t*)wq;
  const float* s = (const float*)ws;
  int8_t* q = (int8_t*)xq;
  float* xsp = (float*)xs;
  const bool b = big != 0, i4 = w_int4 != 0, wh = whole != 0;
  int err;
  if (x_dtype == 0 && out_dtype == 0)
    err = launch_w<__nv_bfloat16, __nv_bfloat16>(x, w, s, out, q, xsp, M, K, N, ksplit, b, wh, i4, st);
  else if (x_dtype == 0)
    err = launch_w<__nv_bfloat16, float>(x, w, s, out, q, xsp, M, K, N, ksplit, b, wh, i4, st);
  else if (out_dtype == 0)
    err = launch_w<float, __nv_bfloat16>(x, w, s, out, q, xsp, M, K, N, ksplit, b, wh, i4, st);
  else
    err = launch_w<float, float>(x, w, s, out, q, xsp, M, K, N, ksplit, b, wh, i4, st);
  if (err != (int)cudaSuccess) return err;
  return (int)cudaGetLastError();
}
