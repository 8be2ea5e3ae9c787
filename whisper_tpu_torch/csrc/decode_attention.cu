// Single-query ("decode step") attention over ONE layer of a layer-stacked
// KV cache, per lane and head.
//
// Replaces: whisper_tpu/ops/pallas/decode_attention.py::
// _decode_attn_stacked_kernel (K3, entry decode_attention_stacked) and
// _decode_attn_stacked_scaled_kernel (K3s, the int8 or packed-int4 self
// cache with per-row scales). The kernel takes the base pointer of the
// whole stacked cache, its (lane, layer, row) strides and the layer index,
// so both stackings are served without a per-layer staging copy:
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
// per-row scales of the int8 / int4 self cache (K3s) are read here.
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
// Bound on the H100: device-memory bandwidth, and at a few lanes latency.
// Every step reads each layer's visible K and V rows once: at large-v2
// greedy the cross cache is 2 * Sa * d * 2 B = 3.84 MB per lane per layer
// in bf16 (Sa = 750), half that in int8 and a quarter in int4, 1.15 us at
// 3.35 TB/s; the self cache at most 2 * C * d * 2 B = 0.66 MB per lane per
// layer (C = 128), 0.33 MB in int8 and 0.16 MB in int4, plus 1 KB of row
// scales; against 2 FLOP per value. Reading only the visible prefix
// (n = min(pos + 1, c_used) rows) and storing fewer bits are what both
// kernels do about it. Over a self cache (a few hundred rows at most) the
// bytes take well under a microsecond, so a call is bound by its chain of
// dependent steps: the one-block kernel issues every row it reads in one
// round of cp.async copies and keeps the softmax statistics per warp, with
// two block barriers (the first version: two dependent rounds of loads and
// seven barriers). At one greedy lane over a long cross cache it would run
// only 20 blocks (one per head) for 132 SMs, each walking 750 rows: 0.0111
// ms, 10% of the bound. So over a long cache (ops/kernels/
// decode_attention.py::plan_lane_splits: from 512 rows, past the decoder's
// 448-row context, so never a self cache) the per-lane call takes the
// split kernel below with one lane a group (G = 1): clusters of 8 blocks
// at one or two lanes, 4 at three or four, 2 over long rows beyond. K3s
// (row scales) comes only with a batch-major self cache of at most 448
// rows, so it always takes the one-block kernel.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HD = 64;
constexpr int WARPS = 8;     // the split kernel's warps
constexpr int OB_WARPS = 4;  // the one-block kernel's warps
constexpr int THREADS = WARPS * 32;
constexpr int CPT = 8;             // channels of a row per thread
constexpr int LPR = HD / CPT;      // threads per row of one head
constexpr int RPW = 32 / LPR;      // rows a warp reads at once
constexpr int RPB = RPW * WARPS;   // rows the block reads at once
constexpr int GROUP = 8;           // most q lanes one K3g block holds
constexpr int MAX_SPLITS = 8;      // most blocks of a K3g cluster (portable)

// Load 8 channels of one row (p points at the first) as floats: common.cuh.
using wtt::Int4;
using wtt::Store;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(wtt::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(wtt::smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Values of one 32-bit word of stored row bytes, as floats: 2 bf16, 1 f32,
// 4 int8 or 8 packed int4 (sign-extended).
template <typename S>
struct Word;
template <>
struct Word<__nv_bfloat16> {
  static constexpr int N = 2;
  __device__ __forceinline__ static void get(unsigned w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xFFFF0000u);
  }
};
template <>
struct Word<float> {
  static constexpr int N = 1;
  __device__ __forceinline__ static void get(unsigned w, float* v) { v[0] = __uint_as_float(w); }
};
template <>
struct Word<int8_t> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void get(unsigned w, float* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = (float)((int)(w << (24 - 8 * i)) >> 24);
  }
};
template <>
struct Word<Int4> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void get(unsigned w, float* v) {
    Store<Int4>::unpack8(w, v);
  }
};

// A float max over the warp in one instruction: the float's bits mapped to
// an int of the same order, `redux.sync`, mapped back.
__device__ __forceinline__ float warp_max_redux(float v) {
  const int i = __float_as_int(v);
  const int r = __reduce_max_sync(0xffffffffu, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(r >= 0 ? r : r ^ 0x7fffffff);
}

// Bytes of one head's shared memory in the one-block kernel: c_used rows
// of K (each padded by 16 bytes: one lane reads one row, and the pad puts
// neighbouring lanes' 16-byte reads on different banks) and of V (and of
// both row scales for K3s), then the weights of all rows; rounded up to 16
// so the next head's rows stay aligned.
template <typename S, bool SCALED>
__host__ __device__ constexpr int head_smem(int c_used) {
  return (c_used * (2 * (HD / Store<S>::CPE) * (int)sizeof(typename Store<S>::E) + 16 +
                    (SCALED ? 2 * (int)sizeof(float) : 0) + (int)sizeof(float)) +
          15) / 16 * 16;
}

constexpr int ROWS_PER_LANE = 4;  // the most rows a lane of the one-block kernel takes

// The one-block kernel: K3 and K8 over every self cache (and over a cross
// cache the planner leaves whole, where its rows fit), and K3s (SCALED:
// ks/vs are the (B, L, C) f32 row scales, s_lane/s_layer their strides,
// rows contiguous) always. One block per (head, lane) of OB_WARPS warps;
// each warp owns a contiguous chunk of at most 32 x ROWS_PER_LANE of the
// visible rows, so everything up to the softmax merge is the warp's
// own (no block barrier), and a lane owns a row wherever a step is per
// row:
//   1. one load round: each warp issues its chunk's K rows, V rows and row
//      scales and its own copy of the query at once with cp.async into
//      shared memory (16 bytes a copy, 4 for a scale), then waits for its
//      own copies (cp.async.wait_all and __syncwarp). With one pos for
//      every lane of the batch (pos == nullptr: pos_all, as the decoder
//      step passes it) the copies start without a load of pos;
//   2. a lane takes the query into registers and its rows' whole dot
//      products (no shuffles), times K's row scale, into registers; the
//      warp's max m_w (one redux) and exp-sum l_w = sum exp(s - m_w);
//   3. one merge (block barrier): each warp takes the block's pairs, one
//      lane a pair: M = max m_w, L = sum l_w exp(m_w - M);
//   4. one lane a row, each weight round(exp(s - M) / L [* vs]) with the
//      global M and L, the once-rounded weight of the plain version
//      (partial weights rescaled afterwards would round differently), into
//      shared memory; then the warp's value sum over its rows, a lane two
//      channels;
//   5. the second merge (block barrier): the warps' value sums added and
//      written.
// Two heads a block, and 8 warps, were measured slower (PERF.md section 6).
template <typename S, typename Q, bool SCALED>
__global__ void __launch_bounds__(OB_WARPS * 32)
decode_attention_kernel(const Q* __restrict__ q, const typename Store<S>::E* __restrict__ k,
                        const typename Store<S>::E* __restrict__ v, const int* __restrict__ pos,
                        int pos_all, const float* __restrict__ ks,
                        const float* __restrict__ vs, Q* __restrict__ out, int c_used,
                        int layer, const Strides st) {
  using ST = Store<S>;
  using E = typename ST::E;
  using WD = Word<S>;
  constexpr int RB = HD / ST::CPE * (int)sizeof(E);  // bytes of one head's row
  constexpr int KB = RB + 16;                         // K's padded row stride
  constexpr int CH = RB / 16;                         // 16-byte copies a row
  constexpr int QB = HD * (int)sizeof(Q);             // bytes of one head's query
  constexpr int VB2 = 2 * RB / HD;                    // bytes of two channels: 4, 8, 2 or 1
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float stat_m[OB_WARPS], stat_l[OB_WARPS];
  __shared__ float part[OB_WARPS * HD];
  __shared__ __align__(16) unsigned char qbuf[OB_WARPS][HD * sizeof(float)];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;

  unsigned char* kbuf = dyn;                                        // [c_used][KB]
  unsigned char* vbuf = kbuf + c_used * KB;                         // [c_used][RB]
  float* kss = reinterpret_cast<float*>(vbuf + c_used * RB);        // [c_used] (SCALED)
  float* vss = kss + (SCALED ? c_used : 0);                         // [c_used] (SCALED)
  float* wgt = vss + (SCALED ? c_used : 0);                         // [c_used]

  // 1. this warp's rows [a, e) of the n visible ones, all copies at once
  const int n = min((pos ? pos[b] : pos_all) + 1, c_used);
  const int per = (n + OB_WARPS - 1) / OB_WARPS;
  const int a = min(n, warp * per), e = min(n, a + per);
  const long long choff = (long long)h * (HD / ST::CPE);
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k + b * st.k_lane + layer * st.k_layer + choff);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v + b * st.v_lane + layer * st.v_layer + choff);
  const long long krow = st.k_row * (long long)sizeof(E), vrow = st.v_row * (long long)sizeof(E);
  if (lane < QB / 16)
    cp_async16(qbuf[warp] + 16 * lane,
               reinterpret_cast<const unsigned char*>(q + b * st.q_sb + h * HD) + 16 * lane);
  for (int i = lane; i < (e - a) * CH; i += 32) {
    const int c = a + i / CH, o = (i % CH) * 16;
    cp_async16(kbuf + c * KB + o, kb + c * krow + o);
    cp_async16(vbuf + c * RB + o, vb + c * vrow + o);
  }
  if (SCALED) {
    const float* ksb = ks + b * st.s_lane + layer * st.s_layer;
    const float* vsb = vs + b * st.s_lane + layer * st.s_layer;
    for (int c = a + lane; c < e; c += 32) {
      cp_async4(kss + c, ksb + c);
      cp_async4(vss + c, vsb + c);
    }
  }
  cp_async_wait_all();
  __syncwarp();

  // 2. a lane's rows c = a + lane + 32 j: dot products, max, exp-sum
  float qv[HD];
#pragma unroll
  for (int i = 0; i < HD; i += 8)
    Store<Q>::load8(reinterpret_cast<const Q*>(qbuf[warp]) + i, qv + i);
  float s[ROWS_PER_LANE];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < ROWS_PER_LANE; ++j) {
    const int c = a + lane + 32 * j;
    s[j] = -INFINITY;
    if (c < e) {
      const unsigned char* kr = kbuf + c * KB;
      float d[4] = {0.f, 0.f, 0.f, 0.f};  // four short chains of products
#pragma unroll
      for (int x = 0; x < CH; ++x) {
        const uint4 u = *reinterpret_cast<const uint4*>(kr + 16 * x);
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float kv[WD::N];
          WD::get(w[t], kv);
#pragma unroll
          for (int i = 0; i < WD::N; ++i) d[t] += qv[(4 * x + t) * WD::N + i] * kv[i];
        }
      }
      const float dot = (d[0] + d[1]) + (d[2] + d[3]);
      s[j] = SCALED ? dot * kss[c] : dot;
      mx = fmaxf(mx, s[j]);
    }
  }
  mx = warp_max_redux(mx);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < ROWS_PER_LANE; ++j)
    if (a + lane + 32 * j < e) sum += expf(s[j] - mx);
  sum = wtt::warp_sum(sum);

  // 3. the merge of the warps' (max, exp-sum) pairs
  if (lane == 0) {
    stat_m[warp] = mx;
    stat_l[warp] = sum;
  }
  __syncthreads();
  const float mi = lane < OB_WARPS ? stat_m[lane] : -INFINITY;
  const float m_all = warp_max_redux(mi);
  const float l_all = wtt::warp_sum(mi > -INFINITY ? stat_l[lane] * expf(mi - m_all) : 0.f);

  // 4. the weights, one lane a row; the value sums, a lane channels
  //    2 lane and 2 lane + 1
#pragma unroll
  for (int j = 0; j < ROWS_PER_LANE; ++j) {
    const int c = a + lane + 32 * j;
    if (c < e) {
      const float w = expf(s[j] - m_all) / l_all;
      wgt[c] = weight<Q>(SCALED ? w * vss[c] : w);
    }
  }
  __syncwarp();
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
  for (int c = a; c < e; ++c) {
    const float w = wgt[c];
    const unsigned char* vr = vbuf + c * RB + VB2 * lane;
    float v2[2];
    if constexpr (VB2 == 8) {
      const float2 f = *reinterpret_cast<const float2*>(vr);
      v2[0] = f.x;
      v2[1] = f.y;
    } else if constexpr (VB2 == 4) {
      WD::get(*reinterpret_cast<const unsigned*>(vr), v2);
    } else if constexpr (VB2 == 2) {
      const unsigned u = *reinterpret_cast<const unsigned short*>(vr);
      v2[0] = (float)(int8_t)(u & 0xFF);
      v2[1] = (float)(int8_t)(u >> 8);
    } else {
      const int u = (int)*reinterpret_cast<const int8_t*>(vr);
      v2[0] = (float)((u << 28) >> 28);
      v2[1] = (float)(u >> 4);
    }
    acc0 += w * v2[0];
    acc1 += w * v2[1];
  }
  part[warp * HD + 2 * lane] = acc0;
  part[warp * HD + 2 * lane + 1] = acc1;
  // 5. ...then over the warps
  __syncthreads();
  if (threadIdx.x < HD) {
    float r = 0.f;
#pragma unroll
    for (int i = 0; i < OB_WARPS; ++i) r += part[i * HD + threadIdx.x];
    out[b * st.o_sb + h * HD + threadIdx.x] = wtt::from_f32<Q>(r);
  }
}

// The split kernel. K3g: R query lanes share one kv row (the beam lanes of
// one window against that window's cross cache: kv row j serves q rows
// [j*R, (j+1)*R)). K3 and K8 at splits > 1: R = G = 1, each lane
// against its own rows. Row scales (K3s) are not taken here.
//
// Replaces: whisper_tpu/ops/pallas/decode_attention.py::
// _decode_attn_stacked_group_kernel (and its `_attend_group`), plus the f32
// per-lane kv_rep path of _decode_attn_stacked_kernel, and over long rows
// _decode_attn_stacked_kernel (K3) and _decode_attn_kernel (K8). Same numerics as the kernel above,
// lane by lane: exact f32 scores of each pre-scaled query,
// rows past that lane's pos masked, f32 softmax, each weight
// round_bf16(exp(s - m) / sum) for a bf16 query (f32 otherwise) with the
// lane's global max m and sum, f32 value sum, output in the query's type.
// Any R >= 2, as the TPU kernel. Only the order of the f32 sums differs
// from the plain version.
//
// Bound on the H100: device-memory bandwidth, and at one window latency.
// R lanes per kv row read the same K/V rows, so the per-lane kernel would
// stream the window's cross cache R times; at large-v2 beam 5 one layer's
// cross K+V is 2 * 750 * 1280 * 2 B = 3.84 MB per window in bf16 (1.92 MB
// int8, 0.96 MB int4), ~1.15 us at 3.35 TB/s. One block per (head, kv row)
// gives only 20 blocks at one window: 20 SMs of 132, each walking its 750
// rows with one 16-byte load a thread in flight, so the kernel waited on
// latency at ~6% of that bound. The design:
//   * R > 8 lanes split into ceil(R / 8) groups of G = ceil(R / groups)
//     lanes (registers and shared memory bounded for any R); each block
//     scores its rows against its group's G queries held in registers;
//   * the visible rows of a (head, kv row, group) are split over a thread
//     block cluster of `splits` blocks (<= 8; K3g's plan takes <= 4, at
//     least 96 rows a block, until ~264 blocks are in flight: 4 up to six
//     windows of large-v2, 2 at seven to thirteen), each taking a
//     contiguous chunk of ~Sa / splits rows;
//   * a block brings its chunk's K and V rows of its head into shared memory
//     as one TMA box each (`cp.async.bulk.tensor`, a byte-typed map of the
//     whole stacked cache over all its layers, encoded on the host once per
//     cache and reused at every layer and step: `wtt::cached_map`), both in
//     flight at once, V's while
//     the scores are computed (a chunk over 256 rows, a box's limit, goes
//     in boxes: K's for the scores, then V's for the value sums). One copy
//     per row, tried first, left the TMA unit's per-copy rate as the limit
//     at 375-row chunks; staging a long chunk through a ring of two
//     128-row boxes, or all its boxes at once, ran no faster on the card;
//   * the cluster combines through distributed shared memory, three
//     cluster barriers in all: each block stores its G local maxima into
//     every block, then its G local exp-sums against the global maxima;
//     every block forms each weight with the global max and sum; each
//     block stores its G x 64 partial value sums into rank 0, which adds
//     them and writes the output.
// One launch per call, as before: the decode step is bound by host
// launches, so a second combine kernel would cost more than the split
// saves. A block whose chunk holds no visible row of a lane contributes
// max -inf, sum 0 and value 0 for it.
template <typename S, typename Q, int G>
__global__ void __launch_bounds__(THREADS)
decode_attention_group_kernel(const Q* __restrict__ q, const int* __restrict__ pos, int pos_all,
                              Q* __restrict__ out, int R, int c_used, int layer, const Strides st,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map, int chunk_cap,
                              int box_rows) {
  using ST = Store<S>;
  using E = typename ST::E;
  constexpr int ROW_E = HD / ST::CPE;                  // stored elements of a head's row
  constexpr int ROW_BYTES = ROW_E * (int)sizeof(E);    // 128, 256, 64 or 32

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // A block may store into another's shared memory only once that block
  // runs: arrive now, wait before the first such store. A cluster of one
  // block (a plain launch) needs no cluster barrier at all.
  auto cluster_sync = [&]() {
    if (splits > 1) cluster.sync();
    else __syncthreads();
  };
  if (splits > 1) wtt::cluster_arrive_relaxed();

  extern __shared__ unsigned char dyn_raw[];
  // TMA writes to 128-byte aligned shared memory
  unsigned char* dyn = dyn_raw + ((128 - (wtt::smem_u32(dyn_raw) & 127)) & 127);
  const int piece = box_rows;  // rows a staging buffer holds: one TMA box
  E* kbuf = reinterpret_cast<E*>(dyn);                        // [piece][ROW_E]
  E* vbuf = reinterpret_cast<E*>(dyn + piece * ROW_BYTES);    // [piece][ROW_E]
  float* scores = reinterpret_cast<float*>(dyn + 2 * piece * ROW_BYTES);  // [G][chunk_cap]
  __shared__ float sq[G * HD];
  __shared__ int sn[G];
  __shared__ float part[G * WARPS * HD];
  // What the cluster's blocks push into each other's shared memory: every
  // rank's G local maxima and exp-sums, and (rank 0's copy only) every
  // rank's G x 64 value sums.
  __shared__ float all_max[MAX_SPLITS][G], all_sum[MAX_SPLITS][G];
  __shared__ float gathered[MAX_SPLITS * G * HD];
  __shared__ float red[WARPS];  // block reductions (one lane a group)
  __shared__ __align__(8) uint64_t bars[2];  // K and V staging

  const int h = blockIdx.x;
  const int j = blockIdx.y;               // kv row
  const int r0 = (blockIdx.z / splits) * G;  // first lane of this block's group
  const int ng = min(G, R - r0);          // live lanes of the group
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LPR;
  const int rin = lane / LPR;

  // This block's rows [rb, re): its chunk of the c_used rows, known before
  // pos is read, so the copies start first. Rows past every lane's pos are
  // neither scored nor summed.
  const int rb = min(c_used, rank * chunk_cap);
  const int re = min(c_used, rb + chunk_cap);
  // Stage rows [p0, p0 + piece) of this head into buf: one TMA box (the map
  // is (row bytes, rows, kv rows, layers) in bytes; rows past c_used arrive
  // as zeros and are never read).
  auto stage = [&](E* buf, uint64_t* bar, const CUtensorMap* map, int p0) {
    if (threadIdx.x == 0) {
      wtt::mbar_expect_tx(bar, (uint32_t)(piece * ROW_BYTES));
      wtt::tma_load_4d(buf, map, bar, h * ROW_BYTES, p0, j, layer);
    }
  };
  if (threadIdx.x == 0) {
    wtt::mbar_init(&bars[0], 1);
    wtt::mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (rb < re) {
      stage(kbuf, &bars[0], &k_map, rb);
      stage(vbuf, &bars[1], &v_map, rb);  // lands during the scores
    }
  }
  for (int t = threadIdx.x; t < G * HD; t += THREADS) {
    const int g = t / HD;
    sq[t] = g < ng ? wtt::to_f32(q[(long long)(j * R + r0 + g) * st.q_sb + h * HD + t % HD])
                   : 0.f;
  }
  if (threadIdx.x < G)
    sn[threadIdx.x] =
        threadIdx.x < ng ? min((pos ? pos[j * R + r0 + threadIdx.x] : pos_all) + 1, c_used) : 0;
  __syncthreads();

  int n_max = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) n_max = max(n_max, sn[g]);
  const int rv = min(re, n_max);  // end of the rows some lane sees
  uint32_t k_phase = 0, v_phase = 0;

  float qv[G][CPT];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < CPT; ++e) qv[g][e] = sq[g * HD + sub * CPT + e];

  // Scores: each staged K row is read once and dotted with all G queries.
  for (int p0 = rb; p0 < re; p0 += piece) {
    const int n = max(0, min(piece, rv - p0));
    if (p0 > rb) {
      __syncthreads();  // every thread is done with the previous piece
      stage(kbuf, &bars[0], &k_map, p0);
    }
    wtt::mbar_wait(&bars[0], k_phase);
    k_phase ^= 1;
    for (int base = 0; base < n; base += RPB) {
      const int c = base + warp * RPW + rin;
      float kv[CPT];
#pragma unroll
      for (int e = 0; e < CPT; ++e) kv[e] = 0.f;
      if (c < n) ST::load8(kbuf + c * ROW_E + (sub * CPT) / ST::CPE, kv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < CPT; ++e) dot += qv[g][e] * kv[e];
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (c < n && sub == 0)
          scores[g * chunk_cap + p0 - rb + c] = dot;
      }
    }
  }
  __syncthreads();

  // Softmax across the cluster; rows past a lane's pos weigh 0. First the
  // global max, then the global sum against it. One lane (K3, K8): the
  // whole block takes the chunk's rows; several (K3g): one warp a lane.
  if (splits > 1) wtt::cluster_wait();
  if constexpr (G == 1) {
    float* sr = scores - rb;
    const int n = min(re, sn[0]);
    float mx = -INFINITY;
    for (int c = rb + threadIdx.x; c < n; c += THREADS) mx = fmaxf(mx, sr[c]);
    mx = block_reduce(mx, red, true);
    if (threadIdx.x < splits) *cluster.map_shared_rank(&all_max[rank][0], threadIdx.x) = mx;
    cluster_sync();
    float mg = -INFINITY;
    for (int r = 0; r < splits; ++r) mg = fmaxf(mg, all_max[r][0]);
    float sum = 0.f;
    for (int c = rb + threadIdx.x; c < n; c += THREADS) {
      const float p = expf(sr[c] - mg);
      sr[c] = p;
      sum += p;
    }
    sum = block_reduce(sum, red, false);
    if (threadIdx.x < splits) *cluster.map_shared_rank(&all_sum[rank][0], threadIdx.x) = sum;
    cluster_sync();
    float total = 0.f;
    for (int r = 0; r < splits; ++r) total += all_sum[r][0];
    for (int c = rb + threadIdx.x; c < n; c += THREADS)
      sr[c] = weight<Q>(sr[c] / total);
    for (int c = max(n, rb) + threadIdx.x; c < re; c += THREADS) sr[c] = 0.f;
  } else {
    for (int g = warp; g < G; g += WARPS) {
      const float* sr = scores + g * chunk_cap - rb;
      const int n = min(re, sn[g]);
      float mx = -INFINITY;
      for (int c = rb + lane; c < n; c += 32) mx = fmaxf(mx, sr[c]);
      mx = wtt::warp_max(mx);
      if (lane < splits) *cluster.map_shared_rank(&all_max[rank][g], lane) = mx;
    }
    cluster_sync();
    for (int g = warp; g < G; g += WARPS) {
      float* sr = scores + g * chunk_cap - rb;
      const int n = min(re, sn[g]);
      float mg = -INFINITY;
      for (int r = 0; r < splits; ++r) mg = fmaxf(mg, all_max[r][g]);
      float sum = 0.f;
      for (int c = rb + lane; c < n; c += 32) {
        const float p = expf(sr[c] - mg);
        sr[c] = p;
        sum += p;
      }
      sum = wtt::warp_sum(sum);
      if (lane < splits) *cluster.map_shared_rank(&all_sum[rank][g], lane) = sum;
    }
    cluster_sync();
    for (int g = warp; g < G; g += WARPS) {
      float* sr = scores + g * chunk_cap - rb;
      const int n = min(re, sn[g]);
      float sum = 0.f;
      for (int r = 0; r < splits; ++r) sum += all_sum[r][g];
      for (int c = rb + lane; c < n; c += 32)
        sr[c] = weight<Q>(sr[c] / sum);
      for (int c = max(n, rb) + lane; c < re; c += 32) sr[c] = 0.f;
    }
  }
  __syncthreads();

  // Weighted value sums: each staged V row is read once for all G lanes.
  float acc[G][CPT];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[g][e] = 0.f;
  for (int p0 = rb; p0 < re; p0 += piece) {
    const int n = max(0, min(piece, rv - p0));
    if (p0 > rb) {
      __syncthreads();
      stage(vbuf, &bars[1], &v_map, p0);
    }
    wtt::mbar_wait(&bars[1], v_phase);
    v_phase ^= 1;
    for (int c = warp * RPW + rin; c < n; c += RPB) {
      float vv[CPT];
      ST::load8(vbuf + c * ROW_E + (sub * CPT) / ST::CPE, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float w = scores[g * chunk_cap + p0 - rb + c];
#pragma unroll
        for (int e = 0; e < CPT; ++e) acc[g][e] += w * vv[e];
      }
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
  float* to_rank0 = cluster.map_shared_rank(gathered, 0) + rank * G * HD;
  for (int t = threadIdx.x; t < ng * HD; t += THREADS) {
    const int g = t / HD, ch = t % HD;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[(g * WARPS + w) * HD + ch];
    to_rank0[t] = s;
  }
  // After this barrier no block touches another's shared memory, so every
  // block but rank 0 may leave.
  cluster_sync();
  if (rank == 0) {
    for (int t = threadIdx.x; t < ng * HD; t += THREADS) {
      float s = 0.f;
      for (int r = 0; r < splits; ++r) s += gathered[r * G * HD + t];
      const int g = t / HD, ch = t % HD;
      out[(long long)(j * R + r0 + g) * st.o_sb + h * HD + ch] = wtt::from_f32<Q>(s);
    }
  }
}

// The one-block launch: a block per (head, lane) of OB_WARPS warps, whose
// shared memory holds all c_used rows of its head (one round of copies).
// It takes a cache whose rows fit ONE_BLOCK_SMEM and ROWS_PER_LANE rows a
// lane (every self cache, and K3s always: 448 rows of int8 take 69 KB);
// `one_block_fits` says whether it does.
constexpr int ONE_BLOCK_SMEM = 160 * 1024;

template <typename S, bool SCALED>
bool one_block_fits(int c_used) {
  return head_smem<S, SCALED>(c_used) <= ONE_BLOCK_SMEM && c_used <= 32 * ROWS_PER_LANE * OB_WARPS;
}

template <typename S, typename Q, bool SCALED>
int launch(const void* q, const void* k, const void* v, const int* pos, const void* ks,
           const void* vs, void* out, int B, int H, int c_used, int layer, int pos_all,
           const Strides& st, cudaStream_t stream) {
  using E = typename Store<S>::E;
  if (!one_block_fits<S, SCALED>(c_used)) return (int)cudaErrorInvalidValue;
  auto kernel = decode_attention_kernel<S, Q, SCALED>;
  const int smem = head_smem<S, SCALED>(c_used);
  static int opted = 48 * 1024 - (int)((2 + 2 * HD) * OB_WARPS * sizeof(float));  // dynamic limit
  if (smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  kernel<<<dim3(H, B), OB_WARPS * 32, smem, stream>>>((const Q*)q, (const E*)k, (const E*)v, pos,
                                                      pos_all, (const float*)ks, (const float*)vs,
                                                      (Q*)out, c_used, layer, st);
  return (int)cudaGetLastError();
}

// The split launch (K3g, and K3 / K8 at splits > 1): `splits` blocks of a
// cluster share the rows of each (head, kv row, group). A block stages its
// chunk of ceil(c_used / splits) rows (rounded up to 8) as one TMA box of
// at most 256 rows a tensor; a larger chunk goes in boxes of 256. Dynamic
// shared memory: the K and V boxes, the G score rows of a chunk, and 128 B
// of alignment slack.
constexpr int MAX_BOX_ROWS = 256;  // a TMA box dimension's limit
constexpr int SMEM_LIMIT = 227 * 1024;

// A byte-typed 4-D map (row bytes, rows, kv rows, layers) of a whole
// stacked cache with the given strides in bytes, and a box of one head's
// `rows`. It covers every layer, so one map serves a cache at every layer
// and step, and `wtt::cached_map` encodes it once.
bool cache_map(CUtensorMap* map, const void* base, int H, int row_bytes, int c_used, int n_kv,
               int n_layer, long long row, long long lane, long long lay, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)H * row_bytes, (cuuint64_t)c_used, (cuuint64_t)n_kv,
                              (cuuint64_t)n_layer};
  const cuuint64_t strides[3] = {(cuuint64_t)row, (cuuint64_t)lane, (cuuint64_t)lay};
  const cuuint32_t box[4] = {(cuuint32_t)row_bytes, (cuuint32_t)rows, 1, 1};
  return wtt::cached_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename S, typename Q, int G>
int launch_group(const void* q, const void* k, const void* v, const int* pos, int pos_all,
                 void* out, int B,
                 int R, int H, int c_used, int layer, int n_layer, int splits, const Strides& st,
                 cudaStream_t stream) {
  using E = typename Store<S>::E;
  constexpr int es = (int)sizeof(E);
  constexpr int row_bytes = HD / Store<S>::CPE * es;
  auto kernel = decode_attention_group_kernel<S, Q, G>;
  static int static_smem = -1;  // this instantiation's static shared memory
  if (static_smem < 0) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return (int)e;
    static_smem = (int)fa.sharedSizeBytes;
  }
  const int chunk_cap = (c_used + splits - 1) / splits;
  const int box_rows = min(MAX_BOX_ROWS, (chunk_cap + 7) / 8 * 8);
  const int smem = 128 + 2 * box_rows * row_bytes + G * chunk_cap * (int)sizeof(float);
  if (smem > SMEM_LIMIT - static_smem) return (int)cudaErrorInvalidValue;
  CUtensorMap km, vm;
  if (!cache_map(&km, k, H, row_bytes, c_used, B / R, n_layer, st.k_row * es, st.k_lane * es,
                 st.k_layer * es, box_rows) ||
      !cache_map(&vm, v, H, row_bytes, c_used, B / R, n_layer, st.v_row * es, st.v_lane * es,
                 st.v_layer * es, box_rows))
    return (int)cudaErrorInvalidValue;
  static int opted = 48 * 1024 - static_smem;  // this instantiation's dynamic limit so far
  if (smem > opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B / R, ((R + G - 1) / G) * splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1;  // one block a cluster: a plain launch
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, (const Q*)q, pos, pos_all, (Q*)out, R, c_used, layer, st,
                         km, vm,
                         chunk_cap, box_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename S, typename Q>
int dispatch(int rep, int splits, const void* q, const void* k, const void* v, const int* pos,
             void* out, int B, int H, int c_used, int layer, int n_layer, int pos_all,
             const Strides& st, cudaStream_t s) {
  // one q row per kv row (K3, K8): the one-block kernel at splits = 1 where
  // the rows fit it, else the split kernel with G = 1 (a cluster of splits
  // blocks, one plain block at splits = 1: a cross cache of 512 to 1199
  // rows that plan_lane_splits leaves whole, as large-v2's Sa = 750 under
  // a greedy batch of five windows or more, or an f32 cache past ~300 rows)
  if (rep == 1 && splits == 1 && one_block_fits<S, false>(c_used))
    return launch<S, Q, false>(q, k, v, pos, nullptr, nullptr, out, B, H, c_used, layer, pos_all,
                               st, s);
  if (rep == 1)
    return launch_group<S, Q, 1>(q, k, v, pos, pos_all, out, B, 1, H, c_used, layer, n_layer,
                                 splits, st, s);
  // R lanes in ceil(R / GROUP) groups of G = ceil(R / groups) <= GROUP
  const int groups = (rep + GROUP - 1) / GROUP;
  const int g = (rep + groups - 1) / groups;
#define WTT_GROUP(G)                                                                      \
  case G:                                                                                 \
    return launch_group<S, Q, G>(q, k, v, pos, pos_all, out, B, rep, H, c_used, layer,      \
                                 n_layer, splits, st, s);
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
// kv row (1: per lane, K3 / K3s; >= 2: grouped, K3g), splits the cluster
// size each kv row's visible rows are split over (1..8; per lane, 1 is the
// one-block kernel), n_layer the layers of the stacked cache (the TMA maps
// cover them all). storage: 0 bf16, 1 f32, 2 int8, 3 packed int4; q_f32
// selects an f32 query and output (else bf16). ks/vs (K3s): null, or the
// int8 / int4 cache's f32 row scales with strides s_lane/s_layer (rep and
// splits must be 1: K3s takes the one-block kernel). pos: device (B,)
// int32, or null with every lane at pos_all (>= 0).
extern "C" int wtt_decode_attention(const void* q, const void* k, const void* v,
                                    const void* pos, int pos_all, void* out, const void* ks,
                                    const void* vs, int B, int H, int rep, int splits,
                                    int c_used, int layer, int n_layer, int storage, int q_f32,
                                    long long q_sb,
                                    long long k_lane, long long k_layer, long long k_row,
                                    long long v_lane, long long v_layer, long long v_row,
                                    long long s_lane, long long s_layer, long long o_sb,
                                    void* stream) {
  if (rep < 1 || B % rep || c_used < 1 || B < 1 || B / rep > 65535 || splits < 1 ||
      splits > MAX_SPLITS || layer < 0 || layer >= n_layer || (pos == nullptr && pos_all < 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* p = (const int*)pos;
  const Strides st{q_sb, k_lane, k_layer, k_row, v_lane, v_layer, v_row, s_lane, s_layer, o_sb};
  using bf16 = __nv_bfloat16;
  if (ks != nullptr || vs != nullptr) {
    if (ks == nullptr || vs == nullptr || rep != 1 || splits != 1 ||
        (storage != 2 && storage != 3))
      return (int)cudaErrorInvalidValue;
#define WTT_SCALED(S, Q) \
  launch<S, Q, true>(q, k, v, p, ks, vs, out, B, H, c_used, layer, pos_all, st, s)
    if (storage == 3) return q_f32 ? WTT_SCALED(Int4, float) : WTT_SCALED(Int4, bf16);
    return q_f32 ? WTT_SCALED(int8_t, float) : WTT_SCALED(int8_t, bf16);
#undef WTT_SCALED
  }
#define WTT_DISPATCH(S, Q) \
  dispatch<S, Q>(rep, splits, q, k, v, p, out, B, H, c_used, layer, n_layer, pos_all, st, s)
  switch (storage) {
    case 0:
      if (q_f32) return (int)cudaErrorInvalidValue;
      return WTT_DISPATCH(bf16, bf16);
    case 1:
      if (!q_f32) return (int)cudaErrorInvalidValue;
      return WTT_DISPATCH(float, float);
    case 2:
      return q_f32 ? WTT_DISPATCH(int8_t, float) : WTT_DISPATCH(int8_t, bf16);
    case 3:
      return q_f32 ? WTT_DISPATCH(Int4, float) : WTT_DISPATCH(Int4, bf16);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WTT_DISPATCH
}
