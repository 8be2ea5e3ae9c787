// Lane permute of several arrays in one launch: out[a][i] = in[a][parents[i]]
// over the leading (lane) axis -- the beam-search reshuffle of the self-KV
// cache.
//
// Replaces: whisper_tpu/ops/pallas/permute.py::_permute_dma_kernel (whole
// slabs) and ::_permute_prefix_kernel (only rows [0, ceil(valid/chunk)*chunk)
// of the chunked arrays), entry permute_lanes_arrays. The TPU kernel starts
// one HBM-to-HBM DMA per (array, lane); here a grid of blocks copies, one
// block per (slab chunk, lane, array), 16 bytes per thread per load.
//
// Each array a is described, per lane, as n_seg segments of seg_bytes to
// copy, seg_stride bytes apart, inside a slab of lane_bytes. A whole-slab
// copy is one segment of lane_bytes; the prefix copy of a (B, L, C, d) cache
// is L segments of rows * d * esize bytes, C * d * esize apart.
//
// Bound on the H100: device-memory bandwidth, and nothing else (no
// arithmetic). At large-v2 beam 5 the self K+V slabs of 5 lanes are
// 2 * 5 * 32 * 128 * 1280 * 2 B = 105 MB, read once and written once:
// 210 MB, ~63 us at 3.35 TB/s. What the design does about it: every byte
// moves once, in 16-byte vectors by neighbouring threads on neighbouring
// addresses, with UNROLL independent loads in flight per thread before the
// stores, and enough blocks (thousands at that shape) to keep every SM's
// load queue full. The source is read through the non-coherent path (the
// wrapper guarantees that no output aliases an input).
#include "common.cuh"

namespace {

constexpr int MAX_ARRAYS = 8;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr long long VECS_PER_BLOCK = (long long)THREADS * UNROLL;

struct PermuteArgs {
  const char* src[MAX_ARRAYS];
  char* dst[MAX_ARRAYS];
  long long lane_bytes[MAX_ARRAYS];  // distance between two lanes' slabs
  long long n_seg[MAX_ARRAYS];       // segments copied per lane
  long long seg_stride[MAX_ARRAYS];  // distance between segments
  long long seg_vecs[MAX_ARRAYS];    // 16-byte vectors copied per segment
};

__global__ void __launch_bounds__(THREADS)
permute_kernel(const PermuteArgs args, const int* __restrict__ parents) {
  const int a = blockIdx.z;
  const int lane = blockIdx.y;
  const long long seg_vecs = args.seg_vecs[a];
  const long long total = args.n_seg[a] * seg_vecs;
  const long long first = (long long)blockIdx.x * VECS_PER_BLOCK + threadIdx.x;
  if (first >= total) return;
  const int parent = parents[lane];
  const char* src = args.src[a] + (long long)parent * args.lane_bytes[a];
  char* dst = args.dst[a] + (long long)lane * args.lane_bytes[a];
  const long long stride = args.seg_stride[a];
  const bool one_seg = args.n_seg[a] == 1;  // whole slab: no division

  uint4 buf[UNROLL];
  long long off[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long idx = first + (long long)u * THREADS;
    off[u] = -1;
    if (idx < total) {
      const long long seg = one_seg ? 0 : idx / seg_vecs;
      off[u] = seg * stride + (idx - seg * seg_vecs) * 16;
      buf[u] = __ldg(reinterpret_cast<const uint4*>(src + off[u]));
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    if (off[u] >= 0) *reinterpret_cast<uint4*>(dst + off[u]) = buf[u];
  }
}

}  // namespace

// src/dst: host arrays of n_arr device pointers; geom: host array of
// 4 * n_arr int64 (lane_bytes, n_seg, seg_stride, seg_bytes) per array, all
// byte counts multiples of 16; parents: device int32 (B,). Returns
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int wtt_permute_lanes(int n_arr, int B, const void* parents,
                                 const unsigned long long* src,
                                 const unsigned long long* dst,
                                 const long long* geom, void* stream) {
  if (n_arr < 1 || n_arr > MAX_ARRAYS || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  PermuteArgs args;
  long long max_vecs = 0;
  for (int a = 0; a < n_arr; ++a) {
    const long long* g = geom + 4 * a;
    if (g[0] % 16 || g[2] % 16 || g[3] % 16 || g[1] < 1 || src[a] % 16 || dst[a] % 16)
      return (int)cudaErrorInvalidValue;
    args.src[a] = reinterpret_cast<const char*>(src[a]);
    args.dst[a] = reinterpret_cast<char*>(dst[a]);
    args.lane_bytes[a] = g[0];
    args.n_seg[a] = g[1];
    args.seg_stride[a] = g[2];
    args.seg_vecs[a] = g[3] / 16;
    const long long vecs = g[1] * (g[3] / 16);
    if (vecs > max_vecs) max_vecs = vecs;
  }
  if (max_vecs == 0) return (int)cudaSuccess;
  const long long blocks = (max_vecs + VECS_PER_BLOCK - 1) / VECS_PER_BLOCK;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, B, n_arr);
  permute_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(args, (const int*)parents);
  return (int)cudaGetLastError();
}
