// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel in this directory is compiled by ops/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// into one library with a plain C interface that Python loads with ctypes.
// Entry points launch on the stream they are given, allocate nothing, and
// return cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wtt {

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch/XLA cast
}
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Unpack one 16-byte vector of T into floats (8 bf16 or 4 f32 values).
template <typename T>
struct Vec16;

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    float4 raw = *reinterpret_cast<const float4*>(p);
    out[0] = raw.x;
    out[1] = raw.y;
    out[2] = raw.z;
    out[3] = raw.w;
  }
};

// Cache storage types, as the decode-attention kernels (K3/K3g/K3s) and the
// fused beam kernel (K5) read them: 8 channels of a row at a time. E is the
// stored element, CPE the channels per element. The integer types also
// expose the raw bytes of 8 channels (Raw: 8 bytes of int8, 4 bytes of
// packed int4), so a kernel that copies rows (K5) stores exactly what it
// read and unpacks the same registers.
struct Int4 {};  // storage tag: packed int4 in uint8 (two's-complement
                 // nibbles, low nibble = even channel)

template <typename S>
struct Store;

template <>
struct Store<__nv_bfloat16> {
  using E = __nv_bfloat16;
  static constexpr int CPE = 1;
  __device__ __forceinline__ static void load8(const E* p, float* out) {
    Vec16<__nv_bfloat16>::load(p, out);
  }
};

template <>
struct Store<float> {
  using E = float;
  static constexpr int CPE = 1;
  __device__ __forceinline__ static void load8(const E* p, float* out) {
    Vec16<float>::load(p, out);
    Vec16<float>::load(p + 4, out + 4);
  }
};

template <>
struct Store<int8_t> {
  using E = int8_t;
  using Raw = uint2;
  static constexpr int CPE = 1;
  __device__ __forceinline__ static Raw raw8(const E* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ static void unpack8(Raw raw, float* out) {
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = (float)v[i];
  }
  __device__ __forceinline__ static void load8(const E* p, float* out) {
    unpack8(raw8(p), out);
  }
};

template <>
struct Store<Int4> {
  using E = uint8_t;
  using Raw = uint32_t;
  static constexpr int CPE = 2;
  __device__ __forceinline__ static Raw raw8(const E* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  // nibble i (bits 4i..4i+3) is channel i: shift it to the top, then an
  // arithmetic shift back sign-extends it
  __device__ __forceinline__ static void unpack8(Raw raw, float* out) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = (float)((int)(raw << (28 - 4 * i)) >> 28);
  }
  __device__ __forceinline__ static void load8(const E* p, float* out) {
    unpack8(raw8(p), out);
  }
};

// mbarriers and TMA (Hopper): the shared-memory address of a generic
// pointer, barrier init / arrive / expect-tx, a wait on a phase, a TMA box
// copy, and libcuda's tensor-map encoder.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of the given parity has completed. A phase that never
// completes (a copy that faulted, a miscounted arrival) traps after ~2^32
// clock cycles, so a fault ends the launch with an error instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// A TMA copy of one box of a 4-D tensor map into shared memory, counted
// against `bar`'s expected bytes (rows outside the map arrive as zeros).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime, so the
// library links against the runtime alone (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace wtt
