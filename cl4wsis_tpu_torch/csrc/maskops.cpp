// Native host-side mask ops for cl4wsis_tpu.
//
// Replaces the C/C++ dependencies of the reference input/eval pipeline:
//  * pycocotools (C): compressed-RLE decode/encode, pycocotools-exact
//    polygon rasterization (5x upsampled boundary walk + even-odd scanline)
//    — reference dataset/voc.py:295-305, dataset/coco.py:59-107
//  * cv2.connectedComponentsWithStats (C++): two-pass union-find CC with
//    area/centroid stats — host fallback for eval-only paths
//    (modules/utils.py:224,307,627)
//  * chainercv mask_iou (numpy) — metrics/voc_evaluation.py:7-8
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------- RLE

// Decode a COCO compressed RLE counts string into run lengths.
// Returns number of runs written (<= max_runs).
int rle_from_string(const char* s, int len, int64_t* runs, int max_runs) {
  int p = 0, n = 0;
  while (p < len && n < max_runs) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more && p < len) {
      int64_t c = s[p] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      p++;
      k++;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (n > 2) x += runs[n - 2];
    runs[n++] = x;
  }
  return n;
}

// Expand run lengths (column-major, starting with zeros) into a row-major
// uint8 mask of shape (h, w).
void rle_decode(const int64_t* runs, int n_runs, int h, int w, uint8_t* out) {
  std::memset(out, 0, (size_t)h * w);
  int64_t pos = 0;
  for (int i = 0; i < n_runs; i++) {
    int64_t cnt = runs[i];
    if (i % 2 == 1) {
      for (int64_t j = pos; j < pos + cnt && j < (int64_t)h * w; j++) {
        // column-major j -> (row, col)
        out[(j % h) * w + (j / h)] = 1;
      }
    }
    pos += cnt;
  }
}

// Encode a row-major (h, w) mask into column-major run lengths.
// Returns the number of runs.
int rle_encode(const uint8_t* mask, int h, int w, int64_t* runs, int max_runs) {
  int n = 0;
  int64_t cnt = 0;
  uint8_t cur = 0;
  for (int64_t j = 0; j < (int64_t)h * w; j++) {
    uint8_t v = mask[(j % h) * w + (j / h)];
    if (v != cur) {
      if (n >= max_runs) return -1;
      runs[n++] = cnt;
      cnt = 0;
      cur = v;
    }
    cnt++;
  }
  if (n < max_runs) runs[n++] = cnt;
  return n;
}

// ------------------------------------------------ polygon rasterization
// Exact rleFrPoly semantics (the published COCO CRLE algorithm): 5x-upsample
// vertices, walk integer boundary points densely along every edge, detect
// x-crossings and downsample them to pixel-column toggle positions, then
// even-odd fill in the column-major run domain. The sorted-diff RLE the
// original builds is equivalent to XOR toggles at the crossing positions
// (duplicate crossings cancel pairwise exactly like its zero-run merge).

void poly_to_mask(const double* xy, int n_pts, int h, int w, uint8_t* out) {
  // out must be zeroed by the caller (accumulates with OR across polygons)
  const double scale = 5.0;
  int n = n_pts;
  std::vector<long> x(n + 1), y(n + 1);
  for (int j = 0; j < n; j++) {
    x[j] = (long)(scale * xy[2 * j] + 0.5);
    y[j] = (long)(scale * xy[2 * j + 1] + 0.5);
  }
  x[n] = x[0];
  y[n] = y[0];

  // densely sampled integer boundary points on the 5x grid
  std::vector<long> u, v;
  for (int j = 0; j < n; j++) {
    long xs = x[j], xe = x[j + 1], ys = y[j], ye = y[j + 1];
    long dx = std::labs(xe - xs), dy = std::labs(ys - ye);
    bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
    if (flip) { std::swap(xs, xe); std::swap(ys, ye); }
    double s = dx >= dy ? (dx == 0 ? 0.0 : (double)(ye - ys) / dx)
                        : (double)(xe - xs) / dy;
    if (dx >= dy) {
      for (long d = 0; d <= dx; d++) {
        long t = flip ? dx - d : d;
        u.push_back(t + xs);
        v.push_back((long)(ys + s * t + 0.5));
      }
    } else {
      for (long d = 0; d <= dy; d++) {
        long t = flip ? dy - d : d;
        v.push_back(t + ys);
        u.push_back((long)(xs + s * t + 0.5));
      }
    }
  }
  // x-crossings -> pixel toggle positions: a crossing between upsampled
  // columns lands in pixel column xd only when (xd+.5)/scale-.5 is integral
  std::vector<long> px, py;
  long m = (long)u.size();
  for (long j = 1; j < m; j++) {
    if (u[j] == u[j - 1]) continue;
    double xd = (double)(u[j] < u[j - 1] ? u[j] : u[j] - 1);
    xd = (xd + 0.5) / scale - 0.5;
    if (std::floor(xd) != xd || xd < 0 || xd > w - 1) continue;
    double yd = (double)(v[j] < v[j - 1] ? v[j] : v[j - 1]);
    yd = (yd + 0.5) / scale - 0.5;
    if (yd < 0) yd = 0; else if (yd > h) yd = h;
    yd = std::ceil(yd);
    px.push_back((long)xd);
    py.push_back((long)yd);
  }
  // even-odd fill in column-major order (== the original's sorted-diff RLE)
  std::vector<uint8_t> colmaj((size_t)h * w, 0);
  for (size_t j = 0; j < px.size(); j++) {
    long idx = px[j] * h + py[j];
    if (idx < (long)h * w) colmaj[idx] ^= 1;
  }
  uint8_t inside = 0;
  for (long j = 0; j < (long)h * w; j++) {
    inside ^= colmaj[j];
    if (inside) out[(j % h) * w + (j / h)] = 1;
  }
}

// ------------------------------------------- connected components + stats

// 8- or 4-connected components of a (h, w) uint8 mask via union-find.
// labels: int32 (h, w) output, 0 = background, components numbered 1..K
// in first-pixel order. stats: per component [area, sum_y, sum_x] triplets
// (float64), capacity max_comp. Returns K (number of components), or -1 if
// max_comp exceeded.
int connected_components_stats(const uint8_t* mask, int h, int w,
                               int connectivity, int32_t* labels,
                               double* stats, int max_comp) {
  std::vector<int32_t> parent((size_t)h * w);
  auto find = [&](int32_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  };
  auto unite = [&](int32_t a, int32_t b) {
    a = find(a); b = find(b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
  };

  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      int32_t id = i * w + j;
      parent[id] = id;
      if (!mask[id]) continue;
      if (j > 0 && mask[id - 1]) unite(id, id - 1);
      if (i > 0 && mask[id - w]) unite(id, id - w);
      if (connectivity == 8 && i > 0) {
        if (j > 0 && mask[id - w - 1]) unite(id, id - w - 1);
        if (j < w - 1 && mask[id - w + 1]) unite(id, id - w + 1);
      }
    }

  std::vector<int32_t> remap((size_t)h * w, 0);
  int k = 0;
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      int32_t id = i * w + j;
      if (!mask[id]) { labels[id] = 0; continue; }
      int32_t r = find(id);
      if (remap[r] == 0) {
        if (k >= max_comp) return -1;
        remap[r] = ++k;
        stats[3 * (k - 1)] = 0;
        stats[3 * (k - 1) + 1] = 0;
        stats[3 * (k - 1) + 2] = 0;
      }
      int32_t lab = remap[r];
      labels[id] = lab;
      stats[3 * (lab - 1)] += 1;
      stats[3 * (lab - 1) + 1] += i;
      stats[3 * (lab - 1) + 2] += j;
    }
  return k;
}

// ------------------------------------------------------------- mask IoU

// IoU matrix between n row-major (h*w) uint8 masks A and m masks B.
void mask_iou(const uint8_t* a, int n, const uint8_t* b, int m, int64_t hw,
              double* out) {
  std::vector<int64_t> area_a(n, 0), area_b(m, 0);
  for (int i = 0; i < n; i++)
    for (int64_t p = 0; p < hw; p++) area_a[i] += a[i * hw + p];
  for (int j = 0; j < m; j++)
    for (int64_t p = 0; p < hw; p++) area_b[j] += b[j * hw + p];
  for (int i = 0; i < n; i++)
    for (int j = 0; j < m; j++) {
      int64_t inter = 0;
      const uint8_t* pa = a + i * hw;
      const uint8_t* pb = b + j * hw;
      for (int64_t p = 0; p < hw; p++) inter += pa[p] & pb[p];
      int64_t uni = area_a[i] + area_b[j] - inter;
      out[i * m + j] = uni > 0 ? (double)inter / uni : 0.0;
    }
}

}  // extern "C"
