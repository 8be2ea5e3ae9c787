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
// later steps read. Blocks on Hopper run in no order, so here one small pass
// quantizes every row first (one block per row, into scratch the wrapper
// allocates), then the GEMM runs: two launches that count as one call.
// (Quantizing inside each GEMM block instead, one launch, was measured
// slower: every block of a row tile repeats the row's IEEE divisions; see
// PERF.md.) The two functions differ only in the rounding (a template flag
// of the quantize pass); with IEEE division (no fast math) and rint (half to
// even) xq is bit-equal to the TPU kernel's, and the int32 sum is exact in
// any order, so the output is bit-equal to the plain version.
//
// The GEMM is mma.sync.m16n8k32 s8 x s8 -> s32 on the tensor cores. The
// weight is (K, N) row-major int8 (N contiguous, the QTensor layout), but
// the instruction wants four consecutive k of one column in a register:
// each thread loads a 4 (k) x 4 (n) byte block as four 32-bit words along N
// (neighbouring threads on neighbouring addresses), transposes it with
// __byte_perm and stores it n-major in shared memory, padded against bank
// conflicts; fragments are then single 32-bit shared loads. The next K
// step's loads are issued into registers before the current step's products
// (one stage of register double buffering).
//
// Packed int4 weights (the same kernels, template flag INT4): (K, N / 2)
// uint8, two two's-complement nibbles a byte, the low nibble the even
// column (quantize.py's layout). The 4 columns a thread takes from a k row
// are one 16-bit load; `expand4` sign-extends its four nibbles into the four
// bytes of the 32-bit word the int8 load would have given, before the
// transpose, so the n-major shared tiles, the s8 x s8 mma and the f32
// epilogue are the int8 path's. The int32 sums of the same integer values
// are exact, so the output is bit-equal to the int8 kernel's over the
// unpacked weight (and to the plain version).
//
// Bound on the H100. At decode M (1, 5, 20 rows) the weight stream bounds
// it: 1280 x 3840 int8 is 4.9 MB, ~1.5 us at 3.35 TB/s (int4: 2.5 MB,
// ~0.7 us). Two tile shapes:
//   * M <= 64 (decode, prefill): 16-row tiles, 32 columns a block, the K
//     steps split over the block's 8 warps (each with its own shared tiles
//     and one K step in flight), the partial int32 sums added in shared
//     memory at the end. 120 blocks at N = 3840, 40 at N = 1280: too few
//     bytes in flight to stream at the full rate -- a split over K across
//     blocks is the next step;
//   * M > 64 (the encoder: M = 750 a window, W x 750 batched): 128 x 128
//     output tiles, 8 warps of 64 x 32, 64-byte K steps. At M = 3000,
//     K = 1280, N = 3840 the 29.5 G integer operations take ~15 us at
//     1979 TOP/s; this kernel has no wgmma, TMA or cp.async pipeline, so
//     it reaches a fraction of that (later PRs).
#include "common.cuh"

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

template <typename O>
__device__ __forceinline__ O epilogue(int acc, float xs, float ws) {
  return wtt::from_f32<O>(((float)acc * xs) * ws);  // (acc * xs) * ws, as JAX
}

// ---------------------------------------------------------------- M <= 64
// grid (N / 32, ceil(M / 16)); warp w takes the K steps w, w + 8, ...
constexpr int SMALL_M = 64;
constexpr int SM_BN = 32;
constexpr int SM_WARPS = THREADS / 32;

template <typename O, bool INT4>
__global__ void __launch_bounds__(THREADS)
gemm_small_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const int8_t* __restrict__ wq, const float* __restrict__ ws,
                  O* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) unsigned char a_s[SM_WARPS][16 * A_STRIDE];
  __shared__ __align__(16) unsigned char b_s[SM_WARPS][SM_BN * B_STRIDE];
  __shared__ int red[SM_WARPS][16 * SM_BN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * SM_BN, m0 = blockIdx.y * 16;
  const int steps = K / BK;
  unsigned char* as = a_s[warp];
  unsigned char* bs = b_s[warp];

  int acc[4][4] = {};
  uint4 ra[2];
  unsigned rb[4][4];
  auto load = [&](int s) {
    const int k0 = s * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 16 rows x 4 chunks of 16 bytes
      const int idx = lane + 32 * i, r = idx >> 2, c = idx & 3;
      ra[i] = m0 + r < M ? *reinterpret_cast<const uint4*>(xq + (long long)(m0 + r) * K + k0 + c * 16)
                         : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // 16 k-blocks x 8 n-blocks of 4 x 4 bytes
      const int kb = (lane >> 3) + 4 * i, nb = lane & 7;
#pragma unroll
      for (int r = 0; r < 4; ++r) rb[i][r] = load_w4<INT4>(wq, k0 + 4 * kb + r, n0 + 4 * nb, N);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = lane + 32 * i, r = idx >> 2, c = idx & 3;
      *reinterpret_cast<uint4*>(as + r * A_STRIDE + c * 16) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kb = (lane >> 3) + 4 * i, nb = lane & 7;
      unsigned w[4];
      transpose4x4(rb[i], w);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<unsigned*>(bs + (4 * nb + j) * B_STRIDE + 4 * kb) = w[j];
    }
  };

  int s = warp;
  if (s < steps) load(s);
  while (s < steps) {
    store();
    const int next = s + SM_WARPS;
    if (next < steps) load(next);  // in flight during the products below
    __syncwarp();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[4];
      a[0] = *reinterpret_cast<const unsigned*>(as + g * A_STRIDE + ks + 4 * t);
      a[1] = *reinterpret_cast<const unsigned*>(as + (g + 8) * A_STRIDE + ks + 4 * t);
      a[2] = *reinterpret_cast<const unsigned*>(as + g * A_STRIDE + ks + 16 + 4 * t);
      a[3] = *reinterpret_cast<const unsigned*>(as + (g + 8) * A_STRIDE + ks + 16 + 4 * t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const unsigned char* bp = bs + (nt * 8 + g) * B_STRIDE + ks + 4 * t;
        mma_s8(acc[nt], a, *reinterpret_cast<const unsigned*>(bp),
               *reinterpret_cast<const unsigned*>(bp + 16));
      }
    }
    __syncwarp();
    s = next;
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = nt * 8 + 2 * t;
    red[warp][g * SM_BN + c] = acc[nt][0];
    red[warp][g * SM_BN + c + 1] = acc[nt][1];
    red[warp][(g + 8) * SM_BN + c] = acc[nt][2];
    red[warp][(g + 8) * SM_BN + c + 1] = acc[nt][3];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 16 * SM_BN; o += THREADS) {
    const int r = o / SM_BN, c = o % SM_BN;
    if (m0 + r >= M) continue;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < SM_WARPS; ++w) sum += red[w][o];
    out[(long long)(m0 + r) * N + n0 + c] = epilogue<O>(sum, xs[m0 + r], ws[n0 + c]);
  }
}

// ---------------------------------------------------------------- M > 64
// grid (N / 128, ceil(M / 128)); 8 warps as 2 (m) x 4 (n), each 64 x 32.
constexpr int BG_BM = 128, BG_BN = 128;

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
void launch(const void* x, const int8_t* wq, const float* ws, void* out, int8_t* xq, float* xs,
            int M, int K, int N, bool big, cudaStream_t st) {
  if (big)
    quantize_rows_kernel<T, true><<<M, THREADS, 0, st>>>((const T*)x, xq, xs, K);
  else
    quantize_rows_kernel<T, false><<<M, THREADS, 0, st>>>((const T*)x, xq, xs, K);
  if (M <= SMALL_M) {
    dim3 grid(N / SM_BN, (M + 15) / 16);
    gemm_small_kernel<O, INT4><<<grid, THREADS, 0, st>>>(xq, xs, wq, ws, (O*)out, M, K, N);
  } else {
    dim3 grid(N / BG_BN, (M + BG_BM - 1) / BG_BM);
    gemm_big_kernel<O, INT4><<<grid, THREADS, 0, st>>>(xq, xs, wq, ws, (O*)out, M, K, N);
  }
}

template <typename T, typename O>
void launch_w(const void* x, const int8_t* wq, const float* ws, void* out, int8_t* xq,
              float* xs, int M, int K, int N, bool big, bool int4, cudaStream_t st) {
  if (int4)
    launch<T, O, true>(x, wq, ws, out, xq, xs, M, K, N, big, st);
  else
    launch<T, O, false>(x, wq, ws, out, xq, xs, M, K, N, big, st);
}

}  // namespace

// x: (M, K) contiguous, x_dtype 0 = bf16, 1 = f32; wq: (K, N) int8
// row-major, or with w_int4 = 1 (K, N / 2) uint8 of packed int4 (low nibble
// = even column); ws: (N,) f32; out: (M, N), out_dtype 0 = bf16, 1 = f32; xq
// (M, K) int8 and xs (M,) f32: scratch. big = 0: K6's rounding (x / xs), 1:
// K7's (x * 127 / absmax). Returns cudaErrorInvalidValue for shapes or
// pointers the kernels do not take.
extern "C" int wtt_w8a8_matmul(const void* x, const void* wq, const void* ws, void* out,
                               void* xq, void* xs, int M, int K, int N, int x_dtype,
                               int out_dtype, int big, int w_int4, void* stream) {
  auto misaligned = [](const void* p, unsigned a) {
    return reinterpret_cast<unsigned long long>(p) % a != 0;
  };
  if (M < 1 || M > 65535 * BG_BM || K < 128 || K % 128 || N < 128 || N % 128 ||
      x_dtype < 0 || x_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      misaligned(wq, 16) || misaligned(xq, 16) || misaligned(out, 8) || xs == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* w = (const int8_t*)wq;
  const float* s = (const float*)ws;
  int8_t* q = (int8_t*)xq;
  float* xsp = (float*)xs;
  const bool b = big != 0, i4 = w_int4 != 0;
  if (x_dtype == 0 && out_dtype == 0)
    launch_w<__nv_bfloat16, __nv_bfloat16>(x, w, s, out, q, xsp, M, K, N, b, i4, st);
  else if (x_dtype == 0)
    launch_w<__nv_bfloat16, float>(x, w, s, out, q, xsp, M, K, N, b, i4, st);
  else if (out_dtype == 0)
    launch_w<float, __nv_bfloat16>(x, w, s, out, q, xsp, M, K, N, b, i4, st);
  else
    launch_w<float, float>(x, w, s, out, q, xsp, M, K, N, b, i4, st);
  return (int)cudaGetLastError();
}
