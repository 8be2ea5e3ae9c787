// Single-query ("decode step") attention over ONE layer of a layer-stacked
// KV cache, per lane and head.
//
// Replaces: whisper_tpu/ops/pallas/decode_attention.py::
// _decode_attn_stacked_kernel (entry decode_attention_stacked), the bf16 /
// f32 per-lane variant. The kernel takes the base pointer of the whole
// stacked cache, its (lane, layer, row) strides and the layer index, so
// both stackings are served without a per-layer staging copy:
//   self cache  (B, L, C, d)  batch-major
//   cross cache (L, B, Sa, d) layer-major
// One block per (head, lane); a row of one head is 64 values = 128 B of
// bf16, read as eight 16-byte vectors by eight neighbouring lanes.
//
// Numerics follow the TPU kernel's _attend: scores are exact f32 dot
// products of the (pre-scaled) query with the bf16 keys; the softmax is
// f32; the weights are rounded to bf16 once before the value sum when the
// cache is bf16 (kept f32 for an f32 cache, as the TPU slow path does); the
// value sum accumulates in f32; the output is in the cache dtype. Rows past
// pos[b] are masked, and rows at or past c_used are never read.
//
// Bound on the H100: device-memory bandwidth. Every step reads each
// layer's visible K and V rows once: at large-v2 greedy the cross cache is
// 2 * Sa * d * 2 B = 7.7 MB per lane per layer (0.49 GB per layer per step
// at B = 64), the self cache at most 2 * C * d * 2 B = 0.66 MB per lane per
// layer (C = 128), against 2 FLOP per byte. Reading only the visible
// prefix (n = min(pos + 1, c_used) rows) is what the design does about it;
// a split over Sa for B = 1 (only B * 20 blocks) is later work.
#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int WARPS = 8;  // 256 threads: more rows in flight for a small batch
constexpr int THREADS = WARPS * 32;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, int c_used, int layer, long long q_sb,
                        long long k_lane, long long k_layer, long long k_row,
                        long long v_lane, long long v_layer, long long v_row,
                        long long o_sb) {
  using V = wtt::Vec16<T>;
  constexpr int VEC = V::N;          // values per 16-byte load
  constexpr int LPR = HD / VEC;      // lanes per cache row (8 bf16, 16 f32)
  constexpr int RPW = 32 / LPR;      // rows a warp reads at once
  constexpr int RPB = RPW * WARPS;   // rows the block reads at once

  extern __shared__ float scores[];  // [c_used]
  __shared__ float sq[HD];
  __shared__ float red[WARPS];
  __shared__ float part[RPB / RPW * HD];  // one HD-vector per warp

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LPR;   // which 16-byte slice of the row
  const int rin = lane / LPR;   // which row of the warp's group

  if (threadIdx.x < HD) sq[threadIdx.x] = wtt::to_f32(q[b * q_sb + h * HD + threadIdx.x]);
  const int n = min(pos[b] + 1, c_used);  // visible rows
  const T* kb = k + b * k_lane + layer * k_layer + h * HD + sub * VEC;
  const T* vb = v + b * v_lane + layer * v_layer + h * HD + sub * VEC;
  __syncthreads();

  float qv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) qv[e] = sq[sub * VEC + e];

  // Scores (exact f32 dot products), masked rows are never touched.
  float mx = -INFINITY;
  for (int base = 0; base < n; base += RPB) {
    const int c = base + warp * RPW + rin;
    float dot = 0.f;
    if (c < n) {
      float kv[VEC];
      V::load(kb + c * k_row, kv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot += qv[e] * kv[e];
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (c < n && sub == 0) {
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
    const float w = scores[c] / sum;
    scores[c] = wtt::to_f32(wtt::from_f32<T>(w));  // bf16 weights for a bf16 cache
  }
  __syncthreads();

  // Weighted value sum: each lane accumulates VEC channels over its rows.
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int c = warp * RPW + rin; c < n; c += RPB) {
    float vv[VEC];
    V::load(vb + c * v_row, vv);
    const float w = scores[c];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += w * vv[e];
  }
  // Reduce over the RPW rows of the warp (lanes with the same `sub`)...
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  // ...then over the warps through shared memory.
  if (rin == 0) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) part[warp * HD + sub * VEC + e] = acc[e];
  }
  __syncthreads();
  if (threadIdx.x < HD) {
    float r = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) r += part[w * HD + threadIdx.x];
    out[b * o_sb + h * HD + threadIdx.x] = wtt::from_f32<T>(r);
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
// bf16 for a bf16 cache (f32 for an f32 cache), f32 value sum, output in
// the cache dtype.
//
// Bound on the H100: device-memory bandwidth. R lanes per kv row read the
// same K/V rows, so the per-lane kernel would stream the window's cross
// cache R times; at large-v2 beam 5 one layer's cross K+V is
// 2 * 750 * 1280 * 2 B = 3.84 MB per window, ~1.15 us at 3.35 TB/s, against
// 5x that per lane. The design reads each visible K and V row of a head
// ONCE per block, one block per (head, kv row), and scores it against all R
// queries held in registers; the block keeps R score rows in shared memory
// and one warp runs each lane's softmax.
template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
decode_attention_group_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const int* __restrict__ pos,
                              T* __restrict__ out, int c_used, int layer, long long q_sb,
                              long long k_lane, long long k_layer, long long k_row,
                              long long v_lane, long long v_layer, long long v_row,
                              long long o_sb) {
  using V = wtt::Vec16<T>;
  constexpr int VEC = V::N;
  constexpr int LPR = HD / VEC;
  constexpr int RPW = 32 / LPR;
  constexpr int RPB = RPW * WARPS;

  extern __shared__ float scores[];  // [R][c_used]
  __shared__ float sq[R * HD];
  __shared__ int sn[R];
  __shared__ float part[R * WARPS * HD];

  const int h = blockIdx.x;
  const int j = blockIdx.y;  // kv row; q rows j*R .. j*R + R - 1
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LPR;
  const int rin = lane / LPR;

  for (int t = threadIdx.x; t < R * HD; t += THREADS)
    sq[t] = wtt::to_f32(q[(long long)(j * R + t / HD) * q_sb + h * HD + t % HD]);
  if (threadIdx.x < R) sn[threadIdx.x] = min(pos[j * R + threadIdx.x] + 1, c_used);
  const T* kb = k + j * k_lane + layer * k_layer + h * HD + sub * VEC;
  const T* vb = v + j * v_lane + layer * v_layer + h * HD + sub * VEC;
  __syncthreads();

  int n_max = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) n_max = max(n_max, sn[r]);

  float qv[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) qv[r][e] = sq[r * HD + sub * VEC + e];

  // Scores: each K row is loaded once and dotted with all R queries.
  for (int base = 0; base < n_max; base += RPB) {
    const int c = base + warp * RPW + rin;
    float kv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) kv[e] = 0.f;
    if (c < n_max) V::load(kb + c * k_row, kv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot += qv[r][e] * kv[e];
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (c < n_max && sub == 0) scores[r * c_used + c] = dot;
    }
  }
  __syncthreads();

  // Softmax: one warp per lane r; rows past that lane's pos weigh 0.
  for (int r = warp; r < R; r += WARPS) {
    float* sr = scores + r * c_used;
    const int n = sn[r];
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
    for (int c = lane; c < n; c += 32) sr[c] = wtt::to_f32(wtt::from_f32<T>(sr[c] / sum));
    for (int c = n + lane; c < n_max; c += 32) sr[c] = 0.f;
  }
  __syncthreads();

  // Weighted value sums: each V row is loaded once for all R lanes.
  float acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  for (int c = warp * RPW + rin; c < n_max; c += RPB) {
    float vv[VEC];
    V::load(vb + c * v_row, vv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float w = scores[r * c_used + c];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] += w * vv[e];
    }
  }
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
  }
  if (rin == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e) part[(r * WARPS + warp) * HD + sub * VEC + e] = acc[r][e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < R * HD; t += THREADS) {
    const int r = t / HD, ch = t % HD;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[(r * WARPS + w) * HD + ch];
    out[(long long)(j * R + r) * o_sb + h * HD + ch] = wtt::from_f32<T>(s);
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out, int B,
           int H, int c_used, int layer, long long q_sb, long long k_lane, long long k_layer,
           long long k_row, long long v_lane, long long v_layer, long long v_row,
           long long o_sb, cudaStream_t stream) {
  const size_t smem = (size_t)c_used * sizeof(float);
  const int err = set_smem(decode_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  decode_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, pos, (T*)out, c_used, layer, q_sb, k_lane,
      k_layer, k_row, v_lane, v_layer, v_row, o_sb);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int launch_group(const void* q, const void* k, const void* v, const int* pos, void* out,
                 int B, int H, int c_used, int layer, long long q_sb, long long k_lane,
                 long long k_layer, long long k_row, long long v_lane, long long v_layer,
                 long long v_row, long long o_sb, cudaStream_t stream) {
  const size_t smem = (size_t)R * c_used * sizeof(float);
  const int err = set_smem(decode_attention_group_kernel<T, R>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B / R);
  decode_attention_group_kernel<T, R><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, pos, (T*)out, c_used, layer, q_sb, k_lane,
      k_layer, k_row, v_lane, v_layer, v_row, o_sb);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int rep, const void* q, const void* k, const void* v, const int* pos, void* out,
             int B, int H, int c_used, int layer, long long q_sb, long long k_lane,
             long long k_layer, long long k_row, long long v_lane, long long v_layer,
             long long v_row, long long o_sb, cudaStream_t s) {
#define WTT_GROUP(R)                                                                     \
  case R:                                                                                \
    return launch_group<T, R>(q, k, v, pos, out, B, H, c_used, layer, q_sb, k_lane,      \
                              k_layer, k_row, v_lane, v_layer, v_row, o_sb, s);
  switch (rep) {
    case 1:
      return launch<T>(q, k, v, pos, out, B, H, c_used, layer, q_sb, k_lane, k_layer, k_row,
                       v_lane, v_layer, v_row, o_sb, s);
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

// Strides are in elements; the lane strides step over kv rows. B is the
// number of q rows, rep the q rows per kv row (1: the per-lane K3 kernel,
// 2..MAX_REP: the grouped K3g kernel). is_f32 selects the f32 cache variant
// (else bf16).
extern "C" int wtt_decode_attention(const void* q, const void* k, const void* v,
                                    const void* pos, void* out, int B, int H, int rep,
                                    int c_used, int layer, int is_f32, long long q_sb,
                                    long long k_lane, long long k_layer, long long k_row,
                                    long long v_lane, long long v_layer, long long v_row,
                                    long long o_sb, void* stream) {
  if (rep < 1 || B % rep) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* p = (const int*)pos;
  if (is_f32)
    return dispatch<float>(rep, q, k, v, p, out, B, H, c_used, layer, q_sb, k_lane, k_layer,
                           k_row, v_lane, v_layer, v_row, o_sb, s);
  return dispatch<__nv_bfloat16>(rep, q, k, v, p, out, B, H, c_used, layer, q_sb, k_lane,
                                 k_layer, k_row, v_lane, v_layer, v_row, o_sb, s);
}
