// Gaussian center stamp: (B, K) slots -> (B, C, H, W) float32 heatmaps. Each
// live slot max-composes the (2r+1)^2 template, r = 3*sigma+1, centred at its
// integer pixel (iy, ix) into channel sel of its image; a slot with sel < 0
// (invalid, off the plane) stamps nothing, and a pixel no window covers is 0.
//
// Replaces cl4wsis_tpu/ops/pallas_stamp.py::stamp_centers_batched_pallas. That
// kernel zeroes a padded plane in VMEM per (image, class), walks the K slots
// and max-updates each window there, rotating a 256-lane template into place
// because Mosaic wants 128-aligned lane offsets; the rotate pad caps sigma at
// 21. Here the form is a gather: one thread owns one output pixel of one
// (b, c) plane and takes the max over the template values of the slots whose
// window covers it. Each block first collects, in shared memory, the slots
// of its channel whose window meets its 32 x 8 tile, so a thread tests only
// those. Max is order-free: no atomics on the output, a deterministic
// result, no limit on sigma and no padded plane at the edges.
//
// The wrapper computes the template with torch.exp on the card, by the
// expression of the plain version, and folds validity, the floor, the clip
// and the channel into (iy, ix, sel) exactly as that version does; the
// kernel only reads template values, so the two are bit-equal.
//
// Bound on the H100: bytes. Every output value is written once: 16 x 20 x
// 512 x 512 x 4 B = 335.5 MB, 0.100 ms at 3.35 TB/s; the slots and the
// template are a few KB. Each thread writes one float, neighbouring threads
// neighbouring addresses, so the writes are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kMaxSlots = 1024;  // slots of one image a block can hold

__global__ void stamp_gather(const int* __restrict__ iy, const int* __restrict__ ix,
                             const int* __restrict__ sel,
                             const float* __restrict__ tmpl, float* __restrict__ out,
                             int K, int C, int H, int W, int r) {
  __shared__ int s_y[kMaxSlots];
  __shared__ int s_x[kMaxSlots];
  __shared__ int s_n;
  const int plane = blockIdx.z;  // b * C + c
  const int b = plane / C;
  const int c = plane - b * C;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  if (tid == 0) s_n = 0;
  __syncthreads();
  // the slots of this channel whose window meets the tile, in any order
  for (int k = tid; k < K; k += kTileX * kTileY) {
    const long long o = (long long)b * K + k;
    if (sel[o] != c) continue;
    const int sy = iy[o];
    const int sx = ix[o];
    if (sy + r < y0 || sy - r > y0 + kTileY - 1 || sx + r < x0 ||
        sx - r > x0 + kTileX - 1)
      continue;
    const int j = atomicAdd(&s_n, 1);
    s_y[j] = sy;
    s_x[j] = sx;
  }
  __syncthreads();
  const int y = y0 + threadIdx.y;
  const int x = x0 + threadIdx.x;
  if (y >= H || x >= W) return;
  const int win = 2 * r + 1;
  const int n = s_n;
  float v = 0.f;
  for (int j = 0; j < n; ++j) {
    const int dy = y - s_y[j];
    const int dx = x - s_x[j];
    if (dy >= -r && dy <= r && dx >= -r && dx <= r)
      v = fmaxf(v, __ldg(tmpl + (dy + r) * win + (dx + r)));
  }
  out[((long long)plane * H + y) * W + x] = v;
}

}  // namespace

extern "C" int cl4_stamp_max_slots() { return kMaxSlots; }

// iy, ix, sel: (B, K) int32; tmpl: (2r+1, 2r+1) float32; out: (B, C, H, W)
// float32. All contiguous.
extern "C" int cl4_stamp(const int* iy, const int* ix, const int* sel,
                         const float* tmpl, float* out, int B, int K, int C, int H,
                         int W, int r, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || K < 0 || K > kMaxSlots || r < 0 ||
      (long long)B * C > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, B * C);
  stamp_gather<<<grid, block, 0, (cudaStream_t)stream>>>(iy, ix, sel, tmpl, out, K,
                                                          C, H, W, r);
  return (int)cudaGetLastError();
}
