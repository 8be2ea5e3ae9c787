// Single-query ("decode step") attention over ONE layer of a layer-stacked
// KV cache, per lane and head.
//
// Replaces: whisper_tpu/ops/pallas/decode_attention.py::
// _decode_attn_stacked_kernel (K3, entry decode_attention_stacked) and
// _decode_attn_stacked_scaled_kernel (K3s, the int8 self cache with per-row
// scales). The kernel takes the base pointer of the whole stacked cache, its
// (lane, layer, row) strides and the layer index, so both stackings are
// served without a per-layer staging copy:
//   self cache  (B, L, C, d)  batch-major
//   cross cache (L, B, Sa, d) layer-major
// One block per (head, lane). Each thread holds 8 channels of a row of one
// head, 8 neighbouring threads a row: a load is 16 bytes of bf16, 8 bytes of
// int8 or 4 bytes of packed int4 (two's-complement nibbles, low nibble =
// even channel, sign-extended in registers), 2 x 16 bytes of f32. Keeping
// the channels per thread fixed across storage types keeps K3g's per-lane
// register arrays the same size for every type.
//
// Storage and query types: a bf16 cache takes a bf16 query, an f32 cache an
// f32 one; an int8 or int4 cache takes either, and the output is in the
// query's type (the TPU kernel's out_shape for an integer cache). The
// per-channel scales of a quantized cross cache are folded into the query
// and the output by the caller, so the kernel itself is scale-free; the
// per-row scales of the int8 self cache (K3s) are read here.
//
// Numerics follow the TPU kernel's _attend: scores are exact f32 dot
// products of the (pre-scaled) query with the stored keys (integers are
// exact), times K's row scale for K3s; the softmax is f32; K3s multiplies
// each weight by V's row scale; the weights are rounded to bf16 once before
// the value sum when the query is bf16 (the TPU's exact one-pass path, taken
// for bf16/int8/int4 storage with a bf16 query), kept f32 otherwise; the
// value sum accumulates in f32. Rows past pos[b] are masked and never read,
// so the scale of an uninitialised tail row (NaN after a prefix-only
// reshuffle) cannot reach the output: this is the TPU kernel's sanitising
// `w * where(row > pos, 0, vs)`. Rows at or past c_used are never read.
//
// Bound on the H100: device-memory bandwidth. Every step reads each
// layer's visible K and V rows once: at large-v2 greedy the cross cache is
// 2 * Sa * d * 2 B = 3.84 MB per lane per layer in bf16 (Sa = 750), half
// that in int8 and a quarter in int4; the self cache at most
// 2 * C * d * 2 B = 0.66 MB per lane per layer (C = 128), 0.33 MB in int8
// plus 1 KB of row scales; against 2 FLOP per value. Reading only the
// visible prefix (n = min(pos + 1, c_used) rows) and storing fewer bits are
// what the design does about it; a split over Sa for B = 1 (only B * 20
// blocks) is later work.
#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int WARPS = 8;  // 256 threads: more rows in flight for a small batch
constexpr int THREADS = WARPS * 32;
constexpr int CPT = 8;             // channels of a row per thread
constexpr int LPR = HD / CPT;      // threads per row of one head
constexpr int RPW = 32 / LPR;      // rows a warp reads at once
constexpr int RPB = RPW * WARPS;   // rows the block reads at once
constexpr int GROUP = 8;           // most q lanes one K3g block holds

struct Int4 {};  // storage tag: packed int4 in uint8

// Load 8 channels of one row (p points at the first) as floats.
template <typename S>
struct Store;

template <>
struct Store<__nv_bfloat16> {
  using E = __nv_bfloat16;
  static constexpr int CPE = 1;  // channels per stored element
  __device__ __forceinline__ static void load8(const E* p, float* out) {
    wtt::Vec16<__nv_bfloat16>::load(p, out);
  }
};

template <>
struct Store<float> {
  using E = float;
  static constexpr int CPE = 1;
  __device__ __forceinline__ static void load8(const E* p, float* out) {
    wtt::Vec16<float>::load(p, out);
    wtt::Vec16<float>::load(p + 4, out + 4);
  }
};

template <>
struct Store<int8_t> {
  using E = int8_t;
  static constexpr int CPE = 1;
  __device__ __forceinline__ static void load8(const E* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = (float)v[i];
  }
};

template <>
struct Store<Int4> {
  using E = uint8_t;
  static constexpr int CPE = 2;
  __device__ __forceinline__ static void load8(const E* p, float* out) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = (float)((int)(raw << (28 - 4 * i)) >> 28);
  }
};

// The softmax weight as the value sum sees it: rounded to bf16 once for a
// bf16 query, f32 otherwise.
template <typename Q>
__device__ __forceinline__ float weight(float w) {
  return wtt::to_f32(wtt::from_f32<Q>(w));
}

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  v = is_max ? wtt::warp_max(v) : wtt::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

struct Strides {
  long long q_sb, k_lane, k_layer, k_row, v_lane, v_layer, v_row, s_lane, s_layer, o_sb;
};

// K3 (SCALED = false) and K3s (SCALED = true: ks/vs are the (B, L, C) f32
// row scales, s_lane/s_layer their strides, rows contiguous).
template <typename S, typename Q, bool SCALED>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const Q* __restrict__ q, const typename Store<S>::E* __restrict__ k,
                        const typename Store<S>::E* __restrict__ v, const int* __restrict__ pos,
                        const float* __restrict__ ks, const float* __restrict__ vs,
                        Q* __restrict__ out, int c_used, int layer, const Strides st) {
  using ST = Store<S>;
  using E = typename ST::E;

  extern __shared__ float scores[];  // [c_used]
  __shared__ float sq[HD];
  __shared__ float red[WARPS];
  __shared__ float part[WARPS * HD];  // one HD-vector per warp

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LPR;   // which 8 channels of the row
  const int rin = lane / LPR;   // which row of the warp's group

  if (threadIdx.x < HD) sq[threadIdx.x] = wtt::to_f32(q[b * st.q_sb + h * HD + threadIdx.x]);
  const int n = min(pos[b] + 1, c_used);  // visible rows
  const int choff = (h * HD + sub * CPT) / ST::CPE;
  const E* kb = k + b * st.k_lane + layer * st.k_layer + choff;
  const E* vb = v + b * st.v_lane + layer * st.v_layer + choff;
  const float* ksb = SCALED ? ks + b * st.s_lane + layer * st.s_layer : nullptr;
  const float* vsb = SCALED ? vs + b * st.s_lane + layer * st.s_layer : nullptr;
  __syncthreads();

  float qv[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) qv[e] = sq[sub * CPT + e];

  // Scores (exact f32 dot products, times K's row scale), masked rows are
  // never touched.
  float mx = -INFINITY;
  for (int base = 0; base < n; base += RPB) {
    const int c = base + warp * RPW + rin;
    float dot = 0.f;
    if (c < n) {
      float kv[CPT];
      ST::load8(kb + c * st.k_row, kv);
#pragma unroll
      for (int e = 0; e < CPT; ++e) dot += qv[e] * kv[e];
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (c < n && sub == 0) {
      if (SCALED) dot *= ksb[c];
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
    float w = scores[c] / sum;
    if (SCALED) w *= vsb[c];
    scores[c] = weight<Q>(w);
  }
  __syncthreads();

  // Weighted value sum: each thread accumulates 8 channels over its rows.
  float acc[CPT];
#pragma unroll
  for (int e = 0; e < CPT; ++e) acc[e] = 0.f;
  for (int c = warp * RPW + rin; c < n; c += RPB) {
    float vv[CPT];
    ST::load8(vb + c * st.v_row, vv);
    const float w = scores[c];
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[e] += w * vv[e];
  }
  // Reduce over the RPW rows of the warp (lanes with the same `sub`)...
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  // ...then over the warps through shared memory.
  if (rin == 0) {
#pragma unroll
    for (int e = 0; e < CPT; ++e) part[warp * HD + sub * CPT + e] = acc[e];
  }
  __syncthreads();
  if (threadIdx.x < HD) {
    float r = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) r += part[w * HD + threadIdx.x];
    out[b * st.o_sb + h * HD + threadIdx.x] = wtt::from_f32<Q>(r);
  }
}

// K3g: R query lanes share one kv row (the beam lanes of one window against
// that window's cross cache: kv row j serves q rows [j*R, (j+1)*R)).
//
// Replaces: whisper_tpu/ops/pallas/decode_attention.py::
// _decode_attn_stacked_group_kernel (and its `_attend_group`), plus the f32
// per-lane kv_rep path of _decode_attn_stacked_kernel. Same numerics as the
// kernel above, lane by lane: exact f32 scores of each pre-scaled query,
// rows past that lane's pos masked, f32 softmax, weights rounded once to
// bf16 for a bf16 query (f32 otherwise), f32 value sum, output in the
// query's type. Any R >= 2, as the TPU kernel.
//
// Bound on the H100: device-memory bandwidth. R lanes per kv row read the
// same K/V rows, so the per-lane kernel would stream the window's cross
// cache R times; at large-v2 beam 5 one layer's cross K+V is
// 2 * 750 * 1280 * 2 B = 3.84 MB per window in bf16 (1.92 MB int8, 0.96 MB
// int4), ~1.15 us at 3.35 TB/s, against 5x that per lane. The design reads
// each visible K and V row of a head once per block and scores it against
// the block's G <= 8 queries held in registers; the block keeps G score rows
// in shared memory and one warp runs each lane's softmax. R > 8 lanes split
// into ceil(R / 8) groups of G = ceil(R / groups), one block per (head, kv
// row, group): each group reads the rows again (from L2 after the first),
// and registers and shared memory stay bounded for any R.
template <typename S, typename Q, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_group_kernel(const Q* __restrict__ q, const typename Store<S>::E* __restrict__ k,
                              const typename Store<S>::E* __restrict__ v,
                              const int* __restrict__ pos, Q* __restrict__ out, int R,
                              int c_used, int layer, const Strides st) {
  using ST = Store<S>;
  using E = typename ST::E;

  extern __shared__ float scores[];  // [G][c_used]
  __shared__ float sq[G * HD];
  __shared__ int sn[G];
  __shared__ float part[G * WARPS * HD];

  const int h = blockIdx.x;
  const int j = blockIdx.y;           // kv row
  const int r0 = blockIdx.z * G;      // first lane of this block's group
  const int ng = min(G, R - r0);      // live lanes of the group
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LPR;
  const int rin = lane / LPR;

  for (int t = threadIdx.x; t < G * HD; t += THREADS) {
    const int g = t / HD;
    sq[t] = g < ng ? wtt::to_f32(q[(long long)(j * R + r0 + g) * st.q_sb + h * HD + t % HD])
                   : 0.f;
  }
  if (threadIdx.x < G)
    sn[threadIdx.x] = threadIdx.x < ng ? min(pos[j * R + r0 + threadIdx.x] + 1, c_used) : 0;
  const int choff = (h * HD + sub * CPT) / ST::CPE;
  const E* kb = k + j * st.k_lane + layer * st.k_layer + choff;
  const E* vb = v + j * st.v_lane + layer * st.v_layer + choff;
  __syncthreads();

  int n_max = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) n_max = max(n_max, sn[g]);

  float qv[G][CPT];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < CPT; ++e) qv[g][e] = sq[g * HD + sub * CPT + e];

  // Scores: each K row is loaded once and dotted with all G queries.
  for (int base = 0; base < n_max; base += RPB) {
    const int c = base + warp * RPW + rin;
    float kv[CPT];
#pragma unroll
    for (int e = 0; e < CPT; ++e) kv[e] = 0.f;
    if (c < n_max) ST::load8(kb + c * st.k_row, kv);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < CPT; ++e) dot += qv[g][e] * kv[e];
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (c < n_max && sub == 0) scores[g * c_used + c] = dot;
    }
  }
  __syncthreads();

  // Softmax: one warp per lane g; rows past that lane's pos weigh 0.
  for (int g = warp; g < G; g += WARPS) {
    float* sr = scores + g * c_used;
    const int n = sn[g];
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, sr[c]);
    mx = wtt::warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float p = expf(sr[c] - mx);
      sr[c] = p;
      sum += p;
    }
    sum = wtt::warp_sum(sum);
    for (int c = lane; c < n; c += 32) sr[c] = weight<Q>(sr[c] / sum);
    for (int c = n + lane; c < n_max; c += 32) sr[c] = 0.f;
  }
  __syncthreads();

  // Weighted value sums: each V row is loaded once for all G lanes.
  float acc[G][CPT];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[g][e] = 0.f;
  for (int c = warp * RPW + rin; c < n_max; c += RPB) {
    float vv[CPT];
    ST::load8(vb + c * st.v_row, vv);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float w = scores[g * c_used + c];
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[g][e] += w * vv[e];
    }
  }
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  }
  if (rin == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < CPT; ++e) part[(g * WARPS + warp) * HD + sub * CPT + e] = acc[g][e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ng * HD; t += THREADS) {
    const int g = t / HD, ch = t % HD;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[(g * WARPS + w) * HD + ch];
    out[(long long)(j * R + r0 + g) * st.o_sb + h * HD + ch] = wtt::from_f32<Q>(s);
  }
}

// Static plus dynamic shared memory above 48 KB needs the opt-in. The
// kernels here hold at most 19 KB statically (K3g at 8 lanes), so a dynamic
// size up to 16 KB never does; above it, opt in to exactly that size.
int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 16 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename S, typename Q, bool SCALED>
int launch(const void* q, const void* k, const void* v, const int* pos, const void* ks,
           const void* vs, void* out, int B, int H, int c_used, int layer, const Strides& st,
           cudaStream_t stream) {
  using E = typename Store<S>::E;
  auto kernel = decode_attention_kernel<S, Q, SCALED>;
  const size_t smem = (size_t)c_used * sizeof(float);
  const int err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, B), THREADS, smem, stream>>>((const Q*)q, (const E*)k, (const E*)v, pos,
                                                (const float*)ks, (const float*)vs, (Q*)out,
                                                c_used, layer, st);
  return (int)cudaGetLastError();
}

template <typename S, typename Q, int G>
int launch_group(const void* q, const void* k, const void* v, const int* pos, void* out, int B,
                 int R, int H, int c_used, int layer, const Strides& st, cudaStream_t stream) {
  using E = typename Store<S>::E;
  auto kernel = decode_attention_group_kernel<S, Q, G>;
  const size_t smem = (size_t)G * c_used * sizeof(float);
  const int err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int groups = (R + G - 1) / G;
  kernel<<<dim3(H, B / R, groups), THREADS, smem, stream>>>(
      (const Q*)q, (const E*)k, (const E*)v, pos, (Q*)out, R, c_used, layer, st);
  return (int)cudaGetLastError();
}

template <typename S, typename Q>
int dispatch(int rep, const void* q, const void* k, const void* v, const int* pos, void* out,
             int B, int H, int c_used, int layer, const Strides& st, cudaStream_t s) {
  if (rep == 1)
    return launch<S, Q, false>(q, k, v, pos, nullptr, nullptr, out, B, H, c_used, layer, st, s);
  // R lanes in ceil(R / GROUP) groups of G = ceil(R / groups) <= GROUP
  const int groups = (rep + GROUP - 1) / GROUP;
  const int g = (rep + groups - 1) / groups;
#define WTT_GROUP(G) \
  case G:            \
    return launch_group<S, Q, G>(q, k, v, pos, out, B, rep, H, c_used, layer, st, s);
  switch (g) {
    WTT_GROUP(2)
    WTT_GROUP(3)
    WTT_GROUP(4)
    WTT_GROUP(5)
    WTT_GROUP(6)
    WTT_GROUP(7)
    WTT_GROUP(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WTT_GROUP
}

}  // namespace

// Strides are in stored elements (bytes for int8 and packed int4); the lane
// strides step over kv rows. B is the number of q rows, rep the q rows per
// kv row (1: the per-lane K3 kernel, >= 2: the grouped K3g kernel).
// storage: 0 bf16, 1 f32, 2 int8, 3 packed int4; q_f32 selects an f32
// query and output (else bf16). ks/vs (K3s): null, or the int8 cache's f32
// row scales with strides s_lane/s_layer (rep must be 1).
extern "C" int wtt_decode_attention(const void* q, const void* k, const void* v,
                                    const void* pos, void* out, const void* ks, const void* vs,
                                    int B, int H, int rep, int c_used, int layer, int storage,
                                    int q_f32, long long q_sb, long long k_lane,
                                    long long k_layer, long long k_row, long long v_lane,
                                    long long v_layer, long long v_row, long long s_lane,
                                    long long s_layer, long long o_sb, void* stream) {
  if (rep < 1 || B % rep || c_used < 1 || B < 1 || B / rep > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* p = (const int*)pos;
  const Strides st{q_sb, k_lane, k_layer, k_row, v_lane, v_layer, v_row, s_lane, s_layer, o_sb};
  using bf16 = __nv_bfloat16;
  if (ks != nullptr || vs != nullptr) {
    if (ks == nullptr || vs == nullptr || rep != 1 || storage != 2)
      return (int)cudaErrorInvalidValue;
    return q_f32 ? launch<int8_t, float, true>(q, k, v, p, ks, vs, out, B, H, c_used, layer, st, s)
                 : launch<int8_t, bf16, true>(q, k, v, p, ks, vs, out, B, H, c_used, layer, st, s);
  }
  switch (storage) {
    case 0:
      if (q_f32) return (int)cudaErrorInvalidValue;
      return dispatch<bf16, bf16>(rep, q, k, v, p, out, B, H, c_used, layer, st, s);
    case 1:
      if (!q_f32) return (int)cudaErrorInvalidValue;
      return dispatch<float, float>(rep, q, k, v, p, out, B, H, c_used, layer, st, s);
    case 2:
      return q_f32 ? dispatch<int8_t, float>(rep, q, k, v, p, out, B, H, c_used, layer, st, s)
                   : dispatch<int8_t, bf16>(rep, q, k, v, p, out, B, H, c_used, layer, st, s);
    case 3:
      return q_f32 ? dispatch<Int4, float>(rep, q, k, v, p, out, B, H, c_used, layer, st, s)
                   : dispatch<Int4, bf16>(rep, q, k, v, p, out, B, H, c_used, layer, st, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
