// intentbev native host ops.
//
// First-party C++ replacements for the third-party native kernels the
// reference leans on from its host data path (SURVEY.md §2.1): OpenCV's
// fillPoly/polylines (utils.py:155-180), scipy's quaternion transforms
// (dataset.py:293-341), and numpy's np.maximum.at scatter loop
// (utils.py:98-105). These run in the input-pipeline worker threads and
// release the GIL for real parallelism; Python binds them via ctypes
// (intentbev/utils/native.py) with a pure-numpy fallback when the shared
// library is absent.
//
// Build: cpp/build.sh  (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Scanline even-odd polygon fill into a uint8 mask (row-major h x w).
// pts: int32 (col, row) pairs, n vertices. Matches the semantics of
// intentbev.bev.rasterize.fill_polygon.
// ---------------------------------------------------------------------------
void ib_fill_polygon(uint8_t* mask, int64_t h, int64_t w,
                     const int32_t* pts, int64_t n) {
  if (n < 3) return;
  double ymin = 1e30, ymax = -1e30;
  for (int64_t i = 0; i < n; ++i) {
    ymin = std::min(ymin, (double)pts[2 * i + 1]);
    ymax = std::max(ymax, (double)pts[2 * i + 1]);
  }
  int64_t y0 = std::max<int64_t>((int64_t)std::floor(ymin), 0);
  int64_t y1 = std::min<int64_t>((int64_t)std::ceil(ymax), h - 1);
  std::vector<double> xs;
  xs.reserve(16);
  for (int64_t y = y0; y <= y1; ++y) {
    const double yc = (double)y;
    xs.clear();
    for (int64_t i = 0; i < n; ++i) {
      const double x1 = pts[2 * i], yy1 = pts[2 * i + 1];
      const int64_t j = (i + 1) % n;
      const double x2 = pts[2 * j], yy2 = pts[2 * j + 1];
      const bool crosses = (yy1 <= yc && yy2 > yc) || (yy2 <= yc && yy1 > yc);
      if (!crosses) continue;
      const double t = (yc - yy1) / (yy2 - yy1);
      xs.push_back(x1 + t * (x2 - x1));
    }
    if (xs.empty()) continue;
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      int64_t a = std::max<int64_t>((int64_t)std::ceil(xs[k] - 0.5), 0);
      int64_t b = std::min<int64_t>((int64_t)std::floor(xs[k + 1] + 0.5), w - 1);
      if (b >= a) std::memset(mask + y * w + a, 1, (size_t)(b - a + 1));
    }
  }
}

// ---------------------------------------------------------------------------
// 1-px polyline (sampled-line equivalent of intentbev draw_polyline).
// ---------------------------------------------------------------------------
void ib_draw_polyline(uint8_t* mask, int64_t h, int64_t w,
                      const int32_t* pts, int64_t n) {
  for (int64_t i = 0; i + 1 < n; ++i) {
    const int64_t x0 = pts[2 * i], y0 = pts[2 * i + 1];
    const int64_t x1 = pts[2 * i + 2], y1 = pts[2 * i + 3];
    const int64_t steps = std::max(std::llabs(x1 - x0), std::llabs(y1 - y0));
    if (steps == 0) {
      if (y0 >= 0 && y0 < h && x0 >= 0 && x0 < w) mask[y0 * w + x0] = 1;
      continue;
    }
    for (int64_t s = 0; s <= steps; ++s) {
      const double t = (double)s / (double)steps;
      const int64_t x = (int64_t)std::floor(x0 + t * (double)(x1 - x0) + 0.5);
      const int64_t y = (int64_t)std::floor(y0 + t * (double)(y1 - y0) + 0.5);
      if (y >= 0 && y < h && x >= 0 && x < w) mask[y * w + x] = 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Multi-sweep BEV scatter-max voxelizer (host twin of voxelize_packed).
// points: f32 (x, y, z, intensity) * n, already in the current ego frame.
// bev: f32 row-major [h, w, c] with c = z_channels * num_sweeps,
// channel = sweep_idx * z_channels + z_slice.
// ---------------------------------------------------------------------------

// The f32 binning constants of intentbev.bev.voxelize.bin_constants: each
// computed in f64 and rounded once, so that a point bins as
// floor((v - lo) * scale) -- one f32 subtract, one f32 multiply -- exactly
// as numpy and XLA bin it.
struct BinConsts {
  float y_lo, x_hi, inv_v, z_lo, z_hi, z_scale;
  BinConsts(double vox, double off_x, double off_y, double z_min,
            double z_max, int64_t z_ch)
      : y_lo((float)(-off_x * vox)), x_hi((float)(off_y * vox)),
        inv_v((float)(1.0 / vox)), z_lo((float)z_min), z_hi((float)z_max),
        z_scale((float)((double)z_ch / (z_max - z_min))) {}
  int64_t col(float y) const { return (int64_t)std::floor((y - y_lo) * inv_v); }
  int64_t row(float x) const { return (int64_t)std::floor((x_hi - x) * inv_v); }
  int64_t slice(float z, int64_t z_ch) const {
    const int64_t zi = (int64_t)std::floor((z - z_lo) * z_scale);
    return std::min(std::max(zi, (int64_t)0), z_ch - 1);
  }
};

void ib_voxelize_sweep(float* bev, int64_t h, int64_t w, int64_t c,
                       const float* points, int64_t n, int64_t sweep_idx,
                       int64_t z_channels, double voxel_size,
                       double offset_col, double offset_row,
                       double z_min, double z_max) {
  const BinConsts bins(voxel_size, offset_col, offset_row, z_min, z_max, z_channels);
  for (int64_t i = 0; i < n; ++i) {
    const float x = points[4 * i], y = points[4 * i + 1];
    const float z = points[4 * i + 2], inten = points[4 * i + 3];
    if (!(z >= bins.z_lo && z < bins.z_hi)) continue;
    const int64_t col = bins.col(y), row = bins.row(x);
    if (col < 0 || col >= w || row < 0 || row >= h) continue;
    const int64_t zi = bins.slice(z, z_channels);
    float* cell = bev + (row * w + col) * c + sweep_idx * z_channels + zi;
    if (inten > *cell) *cell = inten;
  }
}

// ---------------------------------------------------------------------------
// Rigid transform of Nx3 points by a row-major 4x4 matrix, f64 in/f32 out.
// ---------------------------------------------------------------------------
void ib_transform_points(const double* pts_in, int64_t n, const double* m,
                         float* pts_out) {
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts_in[3 * i], y = pts_in[3 * i + 1], z = pts_in[3 * i + 2];
    pts_out[3 * i] = (float)(m[0] * x + m[1] * y + m[2] * z + m[3]);
    pts_out[3 * i + 1] = (float)(m[4] * x + m[5] * y + m[6] * z + m[7]);
    pts_out[3 * i + 2] = (float)(m[8] * x + m[9] * y + m[10] * z + m[11]);
  }
}

// ---------------------------------------------------------------------------
// Pairwise rotated-rectangle IoU (Sutherland-Hodgman), host twin of the
// device kernel in intentbev.boxes.iou — for host-side tooling/tests.
// boxes: (cx, cy, w, l, yaw) * n. out: f32 [n1, n2].
// ---------------------------------------------------------------------------
static void box_corners(const float* b, double cx[4], double cy[4]) {
  const double hw = b[2] / 2.0, hl = b[3] / 2.0;
  const double ca = std::cos((double)b[4]), sa = std::sin((double)b[4]);
  const double lx[4] = {-hw, hw, hw, -hw};
  const double ly[4] = {-hl, -hl, hl, hl};
  for (int k = 0; k < 4; ++k) {
    cx[k] = lx[k] * ca - ly[k] * sa + b[0];
    cy[k] = lx[k] * sa + ly[k] * ca + b[1];
  }
}

static double clip_area(const double* px, const double* py,
                        const double* qx, const double* qy) {
  double ax[16], ay[16], bx[16], by[16];
  int an = 4;
  std::memcpy(ax, px, 4 * sizeof(double));
  std::memcpy(ay, py, 4 * sizeof(double));
  for (int e = 0; e < 4 && an > 0; ++e) {
    const double x1 = qx[e], y1 = qy[e];
    const double x2 = qx[(e + 1) % 4], y2 = qy[(e + 1) % 4];
    const double ex = x2 - x1, ey = y2 - y1;
    int bn = 0;
    for (int i = 0; i < an; ++i) {
      const int j = (i + 1) % an;
      const double s_cur = ex * (ay[i] - y1) - ey * (ax[i] - x1);
      const double s_nxt = ex * (ay[j] - y1) - ey * (ax[j] - x1);
      const bool cin = s_cur >= 0, nin = s_nxt >= 0;
      if (cin != nin) {
        const double t = s_cur / (s_cur - s_nxt);
        bx[bn] = ax[i] + t * (ax[j] - ax[i]);
        by[bn] = ay[i] + t * (ay[j] - ay[i]);
        ++bn;
      }
      if (nin) { bx[bn] = ax[j]; by[bn] = ay[j]; ++bn; }
    }
    an = bn;
    std::memcpy(ax, bx, (size_t)bn * sizeof(double));
    std::memcpy(ay, by, (size_t)bn * sizeof(double));
  }
  double area = 0.0;
  for (int i = 0; i < an; ++i) {
    const int j = (i + 1) % an;
    area += ax[i] * ay[j] - ax[j] * ay[i];
  }
  return std::fabs(area) * 0.5;
}

void ib_rotated_iou(const float* boxes1, int64_t n1, const float* boxes2,
                    int64_t n2, float* out) {
  for (int64_t i = 0; i < n1; ++i) {
    double pxi[4], pyi[4];
    box_corners(boxes1 + 5 * i, pxi, pyi);
    const double a1 = std::fabs((double)boxes1[5 * i + 2] * boxes1[5 * i + 3]);
    for (int64_t j = 0; j < n2; ++j) {
      double pxj[4], pyj[4];
      box_corners(boxes2 + 5 * j, pxj, pyj);
      const double a2 = std::fabs((double)boxes2[5 * j + 2] * boxes2[5 * j + 3]);
      double v = 0.0;
      if (a1 >= 1e-6 && a2 >= 1e-6) {
        const double inter = clip_area(pxi, pyi, pxj, pyj);
        const double uni = a1 + a2 - inter;
        if (inter > 1e-7 && uni > 1e-6) v = inter / uni;
      }
      out[i * n2 + j] = (float)v;
    }
  }
}

// ---------------------------------------------------------------------------
// Voxel placement-chunk builder for the chunk transport
// (intentbev/ops/voxel_embed.py). Mirrors the numpy build_voxel_chunks
// exactly: flat cell ids binned as point_cells bins them (BinConsts),
// per-cell max over duplicates, values clamped to >= 0
// (reference zeros-init np.maximum.at semantics, utils.py:101-105), cells
// grouped by `window`-pixel windows into chunks of <= cap cells.
//
// points [s, p, 4] f32 (x, y, z, intensity); valid [s, p] u8.
// Outputs (caller-zeroed): wid i32[nb, nc]; sl/ch i32[nb, nc, cap];
// val f32[nb, nc, cap]; count i32[nb]. Returns the largest per-band chunk
// count the data NEEDS — if > nc, the excess chunks were dropped and the
// caller decides whether to raise (mirrors on_overflow).
// ---------------------------------------------------------------------------
int64_t ib_build_chunks(const float* points, const uint8_t* valid, int64_t s,
                        int64_t p, int64_t h, int64_t w, int64_t z_ch,
                        double vox, double off_x, double off_y, double z_min,
                        double z_max, int64_t window, int64_t cap, int64_t nb,
                        int64_t nc, int32_t* wid, int32_t* sl, int32_t* ch,
                        float* val, int32_t* count) {
  const int64_t C = s * z_ch;
  const int64_t band_px = (h / nb) * w;
  const int64_t wins_per_band = band_px / window;
  // (cell id, value) packed into one u64: id (< 2^27 at full scale) in the
  // high 32 bits, the f32 bit pattern in the low 32. Values are clamped to
  // >= 0 BEFORE packing (max-then-clamp == clamp-then-max), so the float
  // bits are order-preserving as u32 and the per-cell MAX is simply the
  // LAST element of each sorted id-run — one scalar sort, no pair structs.
  const BinConsts bins(vox, off_x, off_y, z_min, z_max, z_ch);
  std::vector<uint64_t> cells;
  cells.reserve((size_t)(s * p));
  for (int64_t i = 0; i < s; ++i) {
    for (int64_t j = 0; j < p; ++j) {
      if (!valid[i * p + j]) continue;
      const float* pt = points + (i * p + j) * 4;
      const float x = pt[0], y = pt[1], z = pt[2];
      const int64_t col = bins.col(y), row = bins.row(x);
      if (col < 0 || col >= w || row < 0 || row >= h) continue;
      if (!(z >= bins.z_lo && z < bins.z_hi)) continue;
      const int64_t zi = bins.slice(z, z_ch);
      const int64_t id = (row * w + col) * C + i * z_ch + zi;
      const float vc = pt[3] < 0.0f ? 0.0f : pt[3];
      uint32_t vb;
      std::memcpy(&vb, &vc, 4);
      cells.push_back(((uint64_t)id << 32) | vb);
    }
  }
  // LSD radix sort on the id digits only (11-bit digits over the id's bit
  // width; ~3 passes at full scale, each O(n) sequential) — ~4x faster
  // than comparison-sorting the u64s. Values are left unordered within an
  // id-run; the emit scan below takes the max explicitly.
  {
    const uint64_t max_id = (uint64_t)(h * w * C);
    int bits = 0;
    while ((max_id >> bits) != 0) ++bits;
    const int DIG = 11;
    const size_t NB_ = (size_t)1 << DIG;
    std::vector<uint64_t> tmp(cells.size());
    std::vector<uint32_t> cnt(NB_);
    for (int lo = 0; lo < bits; lo += DIG) {
      std::fill(cnt.begin(), cnt.end(), 0u);
      const int sh = 32 + lo;
      for (uint64_t c0 : cells) ++cnt[(c0 >> sh) & (NB_ - 1)];
      uint32_t run = 0;
      for (size_t b = 0; b < NB_; ++b) { uint32_t t = cnt[b]; cnt[b] = run; run += t; }
      for (uint64_t c0 : cells) tmp[cnt[(c0 >> sh) & (NB_ - 1)]++] = c0;
      cells.swap(tmp);
    }
  }

  const int64_t mcw = (window * C + cap - 1) / cap;
  // full per-band chunk demand, counted PAST nc so the returned `needed`
  // is exact (the caller's auto-size retry must be able to size precisely;
  // saturating at nc+1 would make a second overflow silent)
  std::vector<int64_t> full_count((size_t)nb, 0);
  int64_t needed = 0;
  int64_t prev_win = -1, rank = -1, prev_chunk_key = -1, local = -1;
  const size_t n = cells.size();
  for (size_t i = 0; i < n; ++i) {
    const int64_t id = (int64_t)(cells[i] >> 32);
    uint32_t vb = (uint32_t)cells[i];
    while (i + 1 < n && (int64_t)(cells[i + 1] >> 32) == id) {
      ++i;
      const uint32_t vb2 = (uint32_t)cells[i];
      if (vb2 > vb) vb = vb2;  // non-negative floats order as u32 bits
    }
    float v;
    std::memcpy(&v, &vb, 4);
    const int64_t pix = id / C;
    const int64_t chn = id % C;
    const int64_t win = pix / window;
    const int64_t slot = pix % window;
    const int64_t band = pix / band_px;
    if (win != prev_win) { prev_win = win; rank = 0; } else { ++rank; }
    const int64_t chunk_in_win = rank / cap;
    const int64_t k = rank % cap;
    const int64_t ckey = win * mcw + chunk_in_win;
    if (ckey != prev_chunk_key) {
      prev_chunk_key = ckey;
      local = full_count[band]++;
      if (local < nc) {
        count[band] = (int32_t)(local + 1);
        wid[band * nc + local] = (int32_t)(win % wins_per_band);
      }
      needed = std::max(needed, local + 1);
    }
    if (local >= nc) continue;  // overflow chunk dropped whole
    const int64_t base = (band * nc + local) * cap + k;
    sl[base] = (int32_t)slot;
    ch[base] = (int32_t)chn;
    val[base] = v;  // already clamped >= 0 at pack time
  }
  return needed;
}

}  // extern "C"
