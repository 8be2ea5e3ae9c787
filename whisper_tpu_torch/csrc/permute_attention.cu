// Fused beam reshuffle + append + single-query self-attention over ONE layer
// of the quantized self-KV cache (int8 or packed int4) with per-row scales
// (K5).
//
// Replaces: whisper_tpu/ops/pallas/permute_attention.py::_fused_kernel
// (entry decode_attention_permute_fused). For each lane i: read its parent
// slab's rows [0, pos) (K, V and their f32 row scales) from slot
// parents[i], take row pos from the lane's own new row (the quantized K/V of
// this step and their scales), attend with the lane's query exactly as K3s
// does, and write the slab to slot dests[i]: a lane that moves
// (dests[i] != parents[i]) writes rows [0, pos], a lane that stays writes
// only row pos. Rows past pos are left as they were.
//
// In-place safety. The TPU kernel stages every slab of a window in VMEM
// before any write-back, because outputs alias inputs. Blocks on Hopper run
// in no order, so this kernel relies on the copy-on-write slot map instead
// (decode/beam.py::_cow_assign): one block per (head, lane); the first
// claimant of each parent slab stays in its slot and later claimants move to
// slots that no lane reads this step. With one pos for every lane (a beam
// step) every write lands where no block reads: a staying lane writes only
// row pos of its own slot, and every lane reads rows [0, pos) of its parent
// and row pos from its own new row, never from a slab; a moving lane writes
// a free slot. The row scales do not depend on the head, so the head-0
// block of each lane writes them (the same rows as its K/V writes), and the
// other heads' blocks only read. A call without that guarantee (dests =
// None: identity slots, where a lane may overwrite a slab another lane
// reads; or a pos per lane, where a staying lane's row pos may lie inside
// another claimant's read) passes source pointers into a staged copy of the
// layer, made by the wrapper.
//
// Storage (template parameter S, common.cuh's Store): int8 rows of d bytes,
// or packed int4 rows of d / 2 bytes (two's-complement nibbles, low nibble
// = even channel); a head's part of a row is 64 (int8) or 32 (int4) bytes.
//
// Design (one block of 256 threads per (head, lane), three block barriers,
// one round trip to device memory):
//   1. every row the block needs -- the K and V rows [0, pos) of the parent
//      slab, the lane's new rows at pos, and both rows of scales -- is
//      requested at once with cp.async into shared memory (16-byte copies
//      for the rows, 4-byte for the scales); the V rows never waited for
//      the scores. The query's 8 channels a thread go straight to
//      registers. One wait, one barrier;
//   2. a lane that moves stores rows [0, pos] to its destination slot from
//      shared memory (a staying lane: row pos), the head-0 block the
//      scales; the stores overlap the arithmetic below;
//   3. scores: 8 threads a row, 8 channels each, unpacked from shared
//      memory (int4: sign-extended), reduced with shuffles, times K's row
//      scale; a barrier;
//   4. every warp takes the max and the sum over all scores itself (warp
//      shuffles, no block reduction), then the softmax weights of its own
//      rows, times V's row scale, rounded once to the query's type, and its
//      rows' weighted V sum; one barrier for the warps' partial sums.
// The parent and destination indices are read as int64 (the decoder step
// passes `_cow_assign`'s int64 tensors as they are), and an int pos is a
// kernel argument: a call on the in-place path is one launch.
//
// Numerics are K3s's (csrc/decode_attention.cu): exact f32 scores of the
// pre-scaled query with the integer keys, times K's row scale; f32 softmax
// over rows [0, pos]; weights times V's row scale, rounded once to bf16 for
// a bf16 query; f32 value sum; output in the query's type. The written
// caches and scales are copies of the bytes read: bit-equal to the plain
// version.
//
// Bound on the H100: device-memory bandwidth, and at the beam path's sizes
// the latency of one dependent chain. At large-v2 beam 5 one layer call
// reads at most 5 * 2 * 128 * 1280 B = 1.6 MB of int8 prefix (0.8 MB of
// int4) plus 5 KB of scales, and writes the movers' prefixes plus one row
// per staying lane: ~0.3 us at 3.35 TB/s at pos 60. The read that feeds the
// dot product is the one whose bytes a moving lane stores, so the
// reshuffle costs no extra read, and a staying lane writes one row instead
// of its slab.
#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CPT = 8;            // channels of a row per thread
constexpr int LPR = HD / CPT;     // threads per row of one head
constexpr int RPW = 32 / LPR;
constexpr int RPB = RPW * WARPS;

using wtt::Int4;
using wtt::Store;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(wtt::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(wtt::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Cache pointers are untyped here; the kernel reads them as Store<S>::E.
struct Args {
  const void* q;
  const void* k_src;
  const void* v_src;
  const float* ks_src;
  const float* vs_src;
  void* k_dst;
  void* v_dst;
  float* ks_dst;
  float* vs_dst;
  const void* new_k;
  const void* new_v;
  const float* new_ks;
  const float* new_vs;
  const long long* parents;  // (B,)
  const long long* dests;
  const long long* pos;  // (B,), or nullptr: every lane at pos_all
  void* out;
  // strides in stored elements (bytes for the caches, floats for the
  // scales); the src/dst pointers are at the layer, lane 0
  long long q_sb, src_lane, src_row, src_slane, dst_lane, dst_row, dst_slane, new_sb, o_sb;
  int c_used, n_cap, pos_all;
};

// Shared memory of one block for n_cap rows: K and V rows of a head, both
// rows of scales, the scores, and the warps' partial sums.
template <typename S>
__host__ __device__ constexpr size_t block_smem(int n_cap) {
  return (size_t)n_cap * (2 * (HD / Store<S>::CPE) + 3 * sizeof(float)) +
         WARPS * HD * sizeof(float);
}

template <typename S, typename Q>
__global__ void __launch_bounds__(THREADS) permute_attention_kernel(const Args a) {
  using ST = Store<S>;
  using E = typename ST::E;
  using Raw = typename ST::Raw;
  constexpr int RB = HD / ST::CPE;  // stored bytes of one head's row
  constexpr int CH = RB / 16;       // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kr = smem;                  // [n_cap][RB]
  unsigned char* vr = kr + a.n_cap * RB;     // [n_cap][RB]
  float* kss = reinterpret_cast<float*>(vr + a.n_cap * RB);  // [n_cap]
  float* vss = kss + a.n_cap;                // [n_cap]
  float* sc = vss + a.n_cap;                 // [n_cap]
  float* part = sc + a.n_cap;                // [WARPS][HD]

  const int h = blockIdx.x;
  const int i = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sub = lane % LPR;
  const int rin = lane / LPR;

  const int par = (int)a.parents[i];
  const int dst = (int)a.dests[i];
  const int ps = a.pos ? (int)a.pos[i] : a.pos_all;
  const bool moved = dst != par;
  const int n = min(ps + 1, a.c_used);  // rows [0, pos] (pos < c_used by contract)
  const long long hoff = (long long)h * RB;  // bytes of the head in a row
  const unsigned char* kp = (const unsigned char*)a.k_src + par * a.src_lane + hoff;
  const unsigned char* vp = (const unsigned char*)a.v_src + par * a.src_lane + hoff;
  const unsigned char* nkp = (const unsigned char*)a.new_k + i * a.new_sb + hoff;
  const unsigned char* nvp = (const unsigned char*)a.new_v + i * a.new_sb + hoff;
  const float* ksp = a.ks_src + par * a.src_slane;
  const float* vsp = a.vs_src + par * a.src_slane;

  // 1. every row and scale at once
  for (int e = tid; e < n * CH; e += THREADS) {
    const int c = e / CH, o = (e % CH) * 16;
    cp_async16(kr + c * RB + o, c == ps ? nkp + o : kp + c * a.src_row + o);
    cp_async16(vr + c * RB + o, c == ps ? nvp + o : vp + c * a.src_row + o);
  }
  for (int c = tid; c < n; c += THREADS) {
    cp_async4(kss + c, c == ps ? a.new_ks + i : ksp + c);
    cp_async4(vss + c, c == ps ? a.new_vs + i : vsp + c);
  }
  const Q* q = (const Q*)a.q + i * a.q_sb + h * HD + sub * CPT;
  float qv[CPT];
  Store<Q>::load8(q, qv);
  cp_async_wait_all();
  __syncthreads();

  // 2. the write-back: rows [0, pos] of a moving lane, row pos of a staying one
  const int w0 = moved ? 0 : ps;
  E* kd = (E*)a.k_dst + dst * a.dst_lane;
  E* vd = (E*)a.v_dst + dst * a.dst_lane;
  for (int e = w0 * CH + tid; e < n * CH; e += THREADS) {
    const int c = e / CH, o = (e % CH) * 16;
    *reinterpret_cast<uint4*>((unsigned char*)(kd + c * a.dst_row) + hoff + o) =
        *reinterpret_cast<const uint4*>(kr + c * RB + o);
    *reinterpret_cast<uint4*>((unsigned char*)(vd + c * a.dst_row) + hoff + o) =
        *reinterpret_cast<const uint4*>(vr + c * RB + o);
  }
  if (h == 0) {  // the head-independent row scales
    for (int c = w0 + tid; c < n; c += THREADS) {
      a.ks_dst[dst * a.dst_slane + c] = kss[c];
      a.vs_dst[dst * a.dst_slane + c] = vss[c];
    }
  }

  // 3. scores
  for (int base = 0; base < n; base += RPB) {
    const int c = base + warp * RPW + rin;
    float dot = 0.f;
    if (c < n) {
      float kv[CPT];
      ST::unpack8(*reinterpret_cast<const Raw*>(kr + c * RB + sub * sizeof(Raw)), kv);
#pragma unroll
      for (int e = 0; e < CPT; ++e) dot += qv[e] * kv[e];
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (c < n && sub == 0) sc[c] = dot * kss[c];
  }
  __syncthreads();

  // 4. softmax statistics in every warp, then its rows' weighted V sum
  float mx = -INFINITY;
  for (int c = lane; c < n; c += 32) mx = fmaxf(mx, sc[c]);
  mx = wtt::warp_max(mx);
  float sum = 0.f;
  for (int c = lane; c < n; c += 32) sum += expf(sc[c] - mx);
  sum = wtt::warp_sum(sum);
  float acc[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) acc[e] = 0.f;
  for (int c = warp * RPW + rin; c < n; c += RPB) {
    const float w = wtt::to_f32(wtt::from_f32<Q>(expf(sc[c] - mx) / sum * vss[c]));
    float vv[CPT];
    ST::unpack8(*reinterpret_cast<const Raw*>(vr + c * RB + sub * sizeof(Raw)), vv);
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[e] += w * vv[e];
  }
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (rin == 0) {
#pragma unroll
    for (int e = 0; e < CPT; ++e) part[warp * HD + sub * CPT + e] = acc[e];
  }
  __syncthreads();
  if (tid < HD) {
    float r = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) r += part[w * HD + tid];
    ((Q*)a.out)[i * a.o_sb + h * HD + tid] = wtt::from_f32<Q>(r);
  }
}

template <typename S, typename Q>
int launch(const Args& a, int B, int H, cudaStream_t stream) {
  const size_t smem = block_smem<S>(a.n_cap);
  static size_t opted = 48 * 1024;  // this instantiation's dynamic limit so far
  if (smem > opted) {
    const int err = (int)cudaFuncSetAttribute(
        permute_attention_kernel<S, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  permute_attention_kernel<S, Q><<<dim3(H, B), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// src/dst pointers point at the layer's rows of lane 0; strides are in
// stored elements (bytes for the int8 and packed int4 caches, floats for
// the scales, whose rows are contiguous). parents/dests: device (B,)
// int64. pos: device int64 (B,), or nullptr with every lane at pos_all. n_cap bounds every lane's pos + 1 (it sizes the
// shared memory). int4 selects packed int4 caches and new rows (else int8);
// q_f32 an f32 query and output (else bf16).
extern "C" int wtt_permute_attention(
    const void* q, const void* k_src, const void* v_src, const void* ks_src,
    const void* vs_src, void* k_dst, void* v_dst, void* ks_dst, void* vs_dst,
    const void* new_k, const void* new_v, const void* new_ks, const void* new_vs,
    const void* parents, const void* dests, const void* pos, void* out, int B, int H,
    int c_used, int n_cap, int pos_all, int int4, int q_f32, long long q_sb,
    long long src_lane, long long src_row, long long src_slane, long long dst_lane,
    long long dst_row, long long dst_slane, long long new_sb, long long o_sb, void* stream) {
  if (B < 1 || B > 65535 || c_used < 1 || n_cap < 1 || n_cap > c_used ||
      (pos == nullptr && (pos_all < 0 || pos_all >= n_cap)) ||
      block_smem<int8_t>(n_cap) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_src, v_src, (const float*)ks_src, (const float*)vs_src, k_dst, v_dst,
               (float*)ks_dst, (float*)vs_dst, new_k, new_v, (const float*)new_ks,
               (const float*)new_vs, (const long long*)parents, (const long long*)dests,
               (const long long*)pos, out, q_sb, src_lane,
               src_row, src_slane, dst_lane, dst_row, dst_slane, new_sb, o_sb, c_used, n_cap,
               pos_all};
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (int4) return q_f32 ? launch<Int4, float>(a, B, H, s) : launch<Int4, bf16>(a, B, H, s);
  return q_f32 ? launch<int8_t, float>(a, B, H, s) : launch<int8_t, bf16>(a, B, H, s);
}
