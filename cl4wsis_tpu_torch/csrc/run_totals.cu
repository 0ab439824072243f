// Run totals over sorted key rows: for each element of an ascending-sorted
// int32 key row, the length of its equal-key run and the run's sums of three
// int32 payloads, exact in int32.
//
// Replaces cl4wsis_tpu/ops/pallas_seg.py::run_totals_pallas, which keeps a
// whole row in VMEM and runs a forward segmented-sum doubling pass and a
// backward fill pass, log2(N) shifted copies each. Here nothing segmented is
// scanned at all:
//   1. a plain inclusive prefix sum of each payload per row, in uint32, as a
//      two-level scan (1024-element tiles in shared memory, then the tile
//      offsets);
//   2. each element finds its run's [start, end) by binary search for the
//      lower and upper bound of its own key, writes end - start as the area,
//      and each payload's run total as prefix[end-1] - prefix[start-1].
// The differences are taken in uint32: wraparound cancels, so a total is
// exact whenever it fits in int32, the contract the JAX kernel already has.
// Any N >= 1 and any number of rows are taken.
//
// Bound on the H100: bytes. One (1, 262144) call reads four int32 rows and
// writes four (8.4 MB, about 2.5 us at 3.35 TB/s). This design also writes
// and reads the three prefix rows and reads keys log2(N) times per element
// in the searches, mostly from L2; a later change can fuse the scan into the
// totals pass and find run bounds from neighbouring keys in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;

__global__ void __launch_bounds__(kTile)
rt_tile_scan(const int* __restrict__ v1, const int* __restrict__ v2,
             const int* __restrict__ v3, int N, unsigned* __restrict__ prefix,
             unsigned* __restrict__ tile_sums) {
  __shared__ unsigned s[3][kTile];
  const int row = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  const int n_tiles = gridDim.x;
  const long long B = gridDim.y;
  const long long j = (long long)tile * kTile + t;
  const long long at = (long long)row * N + j;
  const bool in = j < N;
  s[0][t] = in ? (unsigned)v1[at] : 0u;
  s[1][t] = in ? (unsigned)v2[at] : 0u;
  s[2][t] = in ? (unsigned)v3[at] : 0u;
  __syncthreads();
  for (int d = 1; d < kTile; d <<= 1) {
    const unsigned a0 = t >= d ? s[0][t - d] : 0u;
    const unsigned a1 = t >= d ? s[1][t - d] : 0u;
    const unsigned a2 = t >= d ? s[2][t - d] : 0u;
    __syncthreads();
    s[0][t] += a0;
    s[1][t] += a1;
    s[2][t] += a2;
    __syncthreads();
  }
  const long long plane = B * N;
  if (in) {
    prefix[at] = s[0][t];
    prefix[plane + at] = s[1][t];
    prefix[2 * plane + at] = s[2][t];
  }
  if (t == kTile - 1) {
    for (int q = 0; q < 3; ++q)
      tile_sums[((long long)row * 3 + q) * n_tiles + tile] = s[q][t];
  }
}

// exclusive scan of the tile sums in place, one thread per (row, payload)
__global__ void rt_tile_offsets(unsigned* tile_sums, int rows3, int n_tiles) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= rows3) return;
  unsigned* t = tile_sums + (long long)g * n_tiles;
  unsigned acc = 0u;
  for (int i = 0; i < n_tiles; ++i) {
    const unsigned v = t[i];
    t[i] = acc;
    acc += v;
  }
}

__global__ void __launch_bounds__(kTile)
rt_totals(const int* __restrict__ key, const unsigned* __restrict__ prefix,
                          const unsigned* __restrict__ tile_offs, int B, int N,
                          int n_tiles, int* __restrict__ area, int* __restrict__ s1,
                          int* __restrict__ s2, int* __restrict__ s3) {
  const int row = blockIdx.y;
  const long long jj = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (jj >= N) return;
  const int j = (int)jj;
  const int* k = key + (long long)row * N;
  const int v = k[j];
  int lo = 0, hi = j;  // first position with k >= v
  while (lo < hi) {
    const int m = lo + ((hi - lo) >> 1);
    if (k[m] < v) lo = m + 1; else hi = m;
  }
  const int start = lo;
  lo = j + 1;
  hi = N;  // first position with k > v
  while (lo < hi) {
    const int m = lo + ((hi - lo) >> 1);
    if (k[m] <= v) lo = m + 1; else hi = m;
  }
  const int end = lo;
  const long long at = (long long)row * N + j;
  area[at] = end - start;
  int* outs[3] = {s1, s2, s3};
  const long long plane = (long long)B * N;
  for (int q = 0; q < 3; ++q) {
    const unsigned* p = prefix + q * plane + (long long)row * N;
    const unsigned* off = tile_offs + ((long long)row * 3 + q) * n_tiles;
    const unsigned hi_sum = p[end - 1] + off[(end - 1) / kTile];
    const unsigned lo_sum = start > 0 ? p[start - 1] + off[(start - 1) / kTile] : 0u;
    outs[q][at] = (int)(hi_sum - lo_sum);
  }
}

}  // namespace

extern "C" int cl4_run_totals_tile() { return kTile; }

// key, v1, v2, v3, area, s1, s2, s3: (B, N) int32, key sorted ascending per
// row. prefix: 3 * B * N int32 of scratch; tile_sums: 3 * B * ceil(N / kTile).
extern "C" int cl4_run_totals(const int* key, const int* v1, const int* v2,
                              const int* v3, int B, int N, int* area, int* s1,
                              int* s2, int* s3, int* prefix, int* tile_sums,
                              void* stream) {
  if (B < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (N + kTile - 1) / kTile;
  unsigned* p = (unsigned*)prefix;
  unsigned* ts = (unsigned*)tile_sums;
  rt_tile_scan<<<dim3(n_tiles, B), kTile, 0, st>>>(v1, v2, v3, N, p, ts);
  rt_tile_offsets<<<(3 * B + 127) / 128, 128, 0, st>>>(ts, 3 * B, n_tiles);
  rt_totals<<<dim3(n_tiles, B), kTile, 0, st>>>(key, p, ts, B, N, n_tiles, area, s1, s2,
                                                s3);
  return (int)cudaGetLastError();
}
