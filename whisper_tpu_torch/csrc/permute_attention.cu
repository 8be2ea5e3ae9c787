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
// = even channel). A thread holds 8 channels of a row either way: 8 bytes
// of int8 or 4 bytes of int4, read once into registers, stored to the
// destination slot from those registers, and unpacked (int4: sign-extended)
// from them for the dot product and the value sum, as K3s unpacks.
//
// Numerics are K3s's (csrc/decode_attention.cu): exact f32 scores of the
// pre-scaled query with the integer keys, times K's row scale; f32 softmax
// over rows [0, pos]; weights times V's row scale, rounded once to bf16 for
// a bf16 query; f32 value sum; output in the query's type. The written
// caches and scales are copies of the bytes read: bit-equal to the plain
// version.
//
// Bound on the H100: device-memory bandwidth. At large-v2 beam 5 one layer
// call reads at most 5 * 2 * 128 * 1280 B = 1.6 MB of int8 prefix (0.8 MB
// of int4; less where lanes share a parent and the L2 serves the second
// read) plus 5 KB of scales, and writes the movers' prefixes plus one row
// per staying lane; against 4 FLOP per cache value. The design moves each
// byte once: the read that feeds the dot product is the one whose bytes a
// moving lane stores, so the reshuffle costs no extra read, and a staying
// lane writes one row instead of its slab. What the separate path pays on
// top -- K4's read and write of every slab and a second buffer pair -- is
// gone.
#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CPT = 8;            // channels of a row per thread
constexpr int LPR = HD / CPT;     // threads per row of one head
constexpr int RPW = 32 / LPR;
constexpr int RPB = RPW * WARPS;

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  v = is_max ? wtt::warp_max(v) : wtt::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

using wtt::Int4;
using wtt::Store;

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
  const int* parents;
  const int* dests;
  const int* pos;
  void* out;
  // strides in stored elements (bytes for the caches, floats for the
  // scales); the src/dst pointers are at the layer, lane 0
  long long q_sb, src_lane, src_row, src_slane, dst_lane, dst_row, dst_slane, new_sb, o_sb;
  int c_used;
};

template <typename S, typename Q>
__global__ void __launch_bounds__(THREADS) permute_attention_kernel(const Args a) {
  using ST = Store<S>;
  using E = typename ST::E;
  using Raw = typename ST::Raw;
  extern __shared__ float scores[];  // [c_used]
  __shared__ float sq[HD];
  __shared__ float red[WARPS];
  __shared__ float part[WARPS * HD];

  const int h = blockIdx.x;
  const int i = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LPR;
  const int rin = lane / LPR;

  const Q* q = (const Q*)a.q;
  if (threadIdx.x < HD) sq[threadIdx.x] = wtt::to_f32(q[i * a.q_sb + h * HD + threadIdx.x]);
  const int par = a.parents[i];
  const int dst = a.dests[i];
  const int ps = a.pos[i];
  const bool moved = dst != par;
  const int n = min(ps + 1, a.c_used);  // rows [0, pos] (pos < c_used by contract)
  const int choff = (h * HD + sub * CPT) / ST::CPE;
  const E* kp = (const E*)a.k_src + par * a.src_lane + choff;
  const E* vp = (const E*)a.v_src + par * a.src_lane + choff;
  E* kd = (E*)a.k_dst + dst * a.dst_lane + choff;
  E* vd = (E*)a.v_dst + dst * a.dst_lane + choff;
  const E* nkp = (const E*)a.new_k + i * a.new_sb + choff;
  const E* nvp = (const E*)a.new_v + i * a.new_sb + choff;
  const float* ksp = a.ks_src + par * a.src_slane;
  const float* vsp = a.vs_src + par * a.src_slane;
  const float nks = a.new_ks[i];
  const float nvs = a.new_vs[i];
  __syncthreads();

  float qv[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) qv[e] = sq[sub * CPT + e];

  // Scores: row c from the parent slab (row pos from the new row), written
  // back to the destination slot from the same registers.
  float mx = -INFINITY;
  for (int base = 0; base < n; base += RPB) {
    const int c = base + warp * RPW + rin;
    float dot = 0.f;
    if (c < n) {
      const Raw raw = ST::raw8(c == ps ? nkp : kp + c * a.src_row);
      if (moved || c == ps) *reinterpret_cast<Raw*>(kd + c * a.dst_row) = raw;
      float kv[CPT];
      ST::unpack8(raw, kv);
#pragma unroll
      for (int e = 0; e < CPT; ++e) dot += qv[e] * kv[e];
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (c < n && sub == 0) {
      dot *= c == ps ? nks : ksp[c];
      scores[c] = dot;
      mx = fmaxf(mx, dot);
    }
  }
  mx = block_reduce(mx, red, true);

  float sum = 0.f;
  for (int c = threadIdx.x; c < n; c += THREADS) {
    const float p = expf(scores[c] - mx);
    scores[c] = p;
    sum += p;
  }
  sum = block_reduce(sum, red, false);
  for (int c = threadIdx.x; c < n; c += THREADS) {
    const float w = scores[c] / sum * (c == ps ? nvs : vsp[c]);
    scores[c] = wtt::to_f32(wtt::from_f32<Q>(w));
    if (h == 0 && (moved || c == ps)) {  // the head-independent row scales
      a.ks_dst[dst * a.dst_slane + c] = c == ps ? nks : ksp[c];
      a.vs_dst[dst * a.dst_slane + c] = c == ps ? nvs : vsp[c];
    }
  }
  __syncthreads();

  float acc[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) acc[e] = 0.f;
  for (int c = warp * RPW + rin; c < n; c += RPB) {
    const Raw raw = ST::raw8(c == ps ? nvp : vp + c * a.src_row);
    if (moved || c == ps) *reinterpret_cast<Raw*>(vd + c * a.dst_row) = raw;
    float vv[CPT];
    ST::unpack8(raw, vv);
    const float w = scores[c];
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
  if (threadIdx.x < HD) {
    float r = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) r += part[w * HD + threadIdx.x];
    ((Q*)a.out)[i * a.o_sb + h * HD + threadIdx.x] = wtt::from_f32<Q>(r);
  }
}

template <typename S, typename Q>
int launch(const Args& a, int B, int H, cudaStream_t stream) {
  const size_t smem = (size_t)a.c_used * sizeof(float);
  if (smem > 32 * 1024) {  // beside 2.3 KB of static arrays: opt in above 48 KB
    const int err = (int)cudaFuncSetAttribute(
        permute_attention_kernel<S, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  permute_attention_kernel<S, Q><<<dim3(H, B), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// src/dst pointers point at the layer's rows of lane 0; strides are in
// stored elements (bytes for the int8 and packed int4 caches, floats for
// the scales, whose rows are contiguous). parents/dests/pos: device int32
// (B,). int4 selects packed int4 caches and new rows (else int8); q_f32 an
// f32 query and output (else bf16).
extern "C" int wtt_permute_attention(
    const void* q, const void* k_src, const void* v_src, const void* ks_src,
    const void* vs_src, void* k_dst, void* v_dst, void* ks_dst, void* vs_dst,
    const void* new_k, const void* new_v, const void* new_ks, const void* new_vs,
    const void* parents, const void* dests, const void* pos, void* out, int B, int H,
    int c_used, int int4, int q_f32, long long q_sb, long long src_lane, long long src_row,
    long long src_slane, long long dst_lane, long long dst_row, long long dst_slane,
    long long new_sb, long long o_sb, void* stream) {
  if (B < 1 || B > 65535 || c_used < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k_src, v_src, (const float*)ks_src, (const float*)vs_src, k_dst, v_dst,
               (float*)ks_dst, (float*)vs_dst, new_k, new_v, (const float*)new_ks,
               (const float*)new_vs, (const int*)parents, (const int*)dests,
               (const int*)pos, out, q_sb, src_lane, src_row, src_slane, dst_lane,
               dst_row, dst_slane, new_sb, o_sb, c_used};
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (int4) return q_f32 ? launch<Int4, float>(a, B, H, s) : launch<Int4, bf16>(a, B, H, s);
  return q_f32 ? launch<int8_t, float>(a, B, H, s) : launch<int8_t, bf16>(a, B, H, s);
}
