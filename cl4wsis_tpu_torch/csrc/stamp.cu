// Gaussian center stamp: (B, K) slots -> (B, C, H, W) float32 heatmaps. Each
// live slot max-composes the (2r+1)^2 template, r = 3*sigma+1, centred at its
// integer pixel (iy, ix) into channel sel of its image; a slot with sel < 0
// (invalid, off the plane) stamps nothing, and a pixel no window covers is 0.
//
// Replaces cl4wsis_tpu/ops/pallas_stamp.py::stamp_centers_batched_pallas. That
// kernel zeroes a padded plane in VMEM per (image, class), walks the K slots
// and max-updates each window there, rotating a 256-lane template into place
// because Mosaic wants 128-aligned lane offsets; the rotate pad caps sigma at
// 21. Here the form is a gather: a pixel takes the max over the template
// values of the slots whose window covers it. Max is order-free: no atomics
// on the output, a deterministic result, no limit on sigma and no padded
// plane at the edges.
//
// Bound on the H100: bytes. Every output value is written once: 16 x 20 x
// 512 x 512 x 4 B = 335.5 MB, 0.100 ms at 3.35 TB/s; the slots and the
// template are a few KB. And the output is almost all zeros: 120 slots of
// 39 x 39 px cover at most 3.5 % of an image's 20 planes at sigma 6, and the
// train step stamps a handful of slots or none. The first design gave every
// 32 x 8 tile of every (image, class) plane a block of its own that walked
// all K slots in device memory and crossed two barriers before each thread
// stored one float: 327,680 blocks, 40 M slot reads and 655 k barriers around
// 1 KB of stores each. This design is a fill with rare exceptions:
//   - one block owns one spatial tile of one image and loops over the C
//     channels, so the slots are read and binned once per tile (coalesced
//     loads, the hits and a per-channel "has a slot" bit mask in shared
//     memory) and the grid falls to a few thousand blocks that each write
//     tens of KB;
//   - a (tile, channel) without a slot is stored as zeros, 16 bytes a thread,
//     neighbouring threads on neighbouring addresses, with streaming stores
//     (nothing reads the tile again here); no template read, no slot loop;
//   - a (tile, channel) with slots gathers over the tile's list, with the
//     template staged in shared memory when it fits there (sigma <= 14) and
//     read through the read-only cache when it does not.
// A W that is not a multiple of 4, or an output off 16 bytes, takes scalar
// stores. The list holds every slot of an image (K <= 1024), so it cannot
// overflow however the slots pile up. The tile shape is what a sweep on the
// card chose: every shape from 64 x 16 to 512 x 8 fills alike, and the
// smallest gathers fastest when windows are wide (sigma 30). Streaming and
// plain stores timed alike too; streaming leaves the L2 to the caller's
// tensors.
//
// The wrapper computes the template with torch.exp on the card, by the
// expression of the plain version, and folds validity, the floor, the clip
// and the channel into (iy, ix, sel) exactly as that version does; the
// kernel only reads template values, so the two are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 64;
constexpr int kTileY = 16;
constexpr int kThreads = 256;
constexpr int kMaxSlots = 1024;   // slots of one image a block can hold
constexpr int kMaskBits = 2048;   // channels with a bit; later ones scan the list
constexpr int kStageBytes = 32768;  // largest template staged in shared memory

static_assert(kTileX % 4 == 0 && (kTileX * kTileY / 4) % kThreads == 0,
              "a tile is a whole number of 16-byte stores per thread");

template <bool VEC>
__device__ __forceinline__ void store_px(float* p, const float (&v)[VEC ? 4 : 1]) {
  if constexpr (VEC) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    __stcs(p, v[0]);
  }
}

// VEC: a thread stores 4 neighbouring pixels at once. STAGED: the template
// lies in shared memory.
template <bool VEC, bool STAGED>
__global__ void __launch_bounds__(kThreads)
stamp_tiles(const int* __restrict__ iy, const int* __restrict__ ix,
            const int* __restrict__ sel, const float* __restrict__ tmpl,
            float* __restrict__ out, int K, int C, int H, int W, int r,
            int tiles_x, int tiles_y) {
  extern __shared__ float s_tmpl[];
  __shared__ int s_y[kMaxSlots];
  __shared__ int s_x[kMaxSlots];
  __shared__ int s_c[kMaxSlots];
  __shared__ unsigned s_mask[kMaskBits / 32];
  __shared__ int s_n;
  constexpr int PX = VEC ? 4 : 1;               // pixels a store carries
  constexpr int kCols = kTileX / PX;            // stores across a tile row
  constexpr int kPer = kTileX * kTileY / PX / kThreads;  // stores per thread
  const int tid = threadIdx.x;
  const int tx = blockIdx.x % tiles_x;
  const int ty = (blockIdx.x / tiles_x) % tiles_y;
  const long long b = blockIdx.x / tiles_x / tiles_y;
  const int x0 = tx * kTileX, y0 = ty * kTileY;
  const int win = 2 * r + 1;

  // bin: the image's slots whose window meets the tile, in any order, and
  // the channels they stamp
  if (tid < kMaskBits / 32) s_mask[tid] = 0u;
  if (tid == 0) s_n = 0;
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) {
    const long long o = b * K + k;
    const int c = sel[o];
    if (c < 0) continue;
    const int sy = iy[o];
    const int sx = ix[o];
    if (y0 - sy > r || sy - (y0 + kTileY - 1) > r || x0 - sx > r ||
        sx - (x0 + kTileX - 1) > r)
      continue;
    const int j = atomicAdd(&s_n, 1);
    s_y[j] = sy;
    s_x[j] = sx;
    s_c[j] = c;
    if (c < kMaskBits) atomicOr(&s_mask[c >> 5], 1u << (c & 31));
  }
  __syncthreads();
  const int n = s_n;
  if (STAGED && n > 0) {
    for (int i = tid; i < win * win; i += kThreads) s_tmpl[i] = tmpl[i];
    __syncthreads();
  }

  // where this thread stores, the same in every channel
  long long off[kPer];
  int py[kPer], px[kPer];
  bool in[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int it = tid + p * kThreads;
    py[p] = y0 + it / kCols;
    px[p] = x0 + (it % kCols) * PX;
    in[p] = py[p] < H && px[p] < W;   // VEC: W % 4 == 0, so px + 3 < W too
    off[p] = (long long)py[p] * W + px[p];
  }

  const long long plane = (long long)H * W;
  float* dst = out + b * C * plane;
  for (int c = 0; c < C; ++c, dst += plane) {
    const bool covered =
        n > 0 && (c >= kMaskBits || ((s_mask[c >> 5] >> (c & 31)) & 1u));
    if (!covered) {
      const float zero[PX] = {};
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        if (in[p]) store_px<VEC>(dst + off[p], zero);
      continue;
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (!in[p]) continue;
      float v[PX] = {};
      for (int j = 0; j < n; ++j) {
        if (s_c[j] != c) continue;
        const int dy = py[p] - s_y[j];
        if (dy < -r || dy > r) continue;
        const int dx0 = px[p] - s_x[j];
        const long long at = (long long)(dy + r) * win + r + dx0;
#pragma unroll
        for (int i = 0; i < PX; ++i) {
          const int dx = dx0 + i;
          if (dx >= -r && dx <= r)
            v[i] = fmaxf(v[i], STAGED ? s_tmpl[at + i] : __ldg(tmpl + at + i));
        }
      }
      store_px<VEC>(dst + off[p], v);
    }
  }
}

template <bool VEC, bool STAGED>
int launch(const int* iy, const int* ix, const int* sel, const float* tmpl,
           float* out, int B, int K, int C, int H, int W, int r, cudaStream_t st) {
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int tiles_y = (H + kTileY - 1) / kTileY;
  const long long blocks = (long long)B * tiles_x * tiles_y;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const long long win = 2LL * r + 1;
  const size_t smem = STAGED ? (size_t)(win * win) * sizeof(float) : 0;
  stamp_tiles<VEC, STAGED><<<(unsigned)blocks, kThreads, smem, st>>>(
      iy, ix, sel, tmpl, out, K, C, H, W, r, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cl4_stamp_max_slots() { return kMaxSlots; }

// iy, ix, sel: (B, K) int32; tmpl: (2r+1, 2r+1) float32; out: (B, C, H, W)
// float32. All contiguous.
extern "C" int cl4_stamp(const int* iy, const int* ix, const int* sel,
                         const float* tmpl, float* out, int B, int K, int C, int H,
                         int W, int r, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || K < 0 || K > kMaxSlots || r < 0 ||
      r > (1 << 30) - 1)  // 2r + 1 must fit an int
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = W % 4 == 0 && ((uintptr_t)out & 15u) == 0u;
  const long long win = 2LL * r + 1;
  const bool staged = win * win * (long long)sizeof(float) <= kStageBytes;
  if (vec)
    return staged ? launch<true, true>(iy, ix, sel, tmpl, out, B, K, C, H, W, r, st)
                  : launch<true, false>(iy, ix, sel, tmpl, out, B, K, C, H, W, r, st);
  return staged ? launch<false, true>(iy, ix, sel, tmpl, out, B, K, C, H, W, r, st)
                : launch<false, false>(iy, ix, sel, tmpl, out, B, K, C, H, W, r, st);
}
