// Native vision kernels (C++17, no external deps), carried over unchanged
// from eincm_tpu/native/vision.cpp.
//
// Host-side replacements for the OpenCV/scipy native routines the reference
// leans on (SURVEY.md §2.2): non-local-means denoise, CLAHE, bilateral
// filter, Canny edge detection, and the exact Euclidean distance transform
// (Meijster's algorithm — the same algorithm the reference ports to Python at
// src/utils/img_utils.py:236-410; here in its intended native form).
//
// Build: see build.py (g++ -O3 -march=native -shared -fPIC).
// Binding: ctypes (eincm_tpu_torch/native/vision.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Gaussian blur (separable, reflect-101 borders), float64
// ---------------------------------------------------------------------------
void gaussian_blur_f64(const double* src, double* dst, int h, int w,
                       double sigma) {
  int radius = std::max(1, (int)std::ceil(3.0 * sigma));
  std::vector<double> k(2 * radius + 1);
  double s = 0;
  for (int i = -radius; i <= radius; ++i) {
    k[i + radius] = std::exp(-0.5 * (i / sigma) * (i / sigma));
    s += k[i + radius];
  }
  for (auto& v : k) v /= s;

  auto reflect = [](int i, int n) {
    // BORDER_REFLECT_101: -1 -> 1, n -> n-2
    if (n == 1) return 0;
    while (i < 0 || i >= n) {
      if (i < 0) i = -i;
      if (i >= n) i = 2 * n - 2 - i;
    }
    return i;
  };

  std::vector<double> tmp((size_t)h * w);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      double acc = 0;
      for (int d = -radius; d <= radius; ++d)
        acc += k[d + radius] * src[(size_t)y * w + reflect(x + d, w)];
      tmp[(size_t)y * w + x] = acc;
    }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      double acc = 0;
      for (int d = -radius; d <= radius; ++d)
        acc += k[d + radius] * tmp[(size_t)reflect(y + d, h) * w + x];
      dst[(size_t)y * w + x] = acc;
    }
}

// ---------------------------------------------------------------------------
// Non-local means denoise, uint8 (Buades et al.; equivalent of
// cv.fastNlMeansDenoising with patch/search windows)
// ---------------------------------------------------------------------------
void nl_means_u8(const uint8_t* src, uint8_t* dst, int h, int w, double hpar,
                 int template_win, int search_win) {
  int tr = template_win / 2;
  int sr = search_win / 2;
  double patch_area = (double)template_win * template_win;
  double h2 = hpar * hpar * patch_area;

  std::vector<double> img((size_t)h * w);
  for (size_t i = 0; i < (size_t)h * w; ++i) img[i] = src[i];

  auto clampi = [](int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
  };

  // integral images of squared differences per shift
  std::vector<double> acc((size_t)h * w, 0.0), wacc((size_t)h * w, 0.0);
  std::vector<double> d2((size_t)h * w);
  std::vector<double> box((size_t)h * w);

  for (int dy = -sr; dy <= sr; ++dy) {
    for (int dx = -sr; dx <= sr; ++dx) {
      // squared difference to the (mirrored-roll) shifted image
      for (int y = 0; y < h; ++y) {
        int ys = ((y - dy) % h + h) % h;  // roll, matching the numpy fallback
        for (int x = 0; x < w; ++x) {
          int xs = ((x - dx) % w + w) % w;
          double d = img[(size_t)y * w + x] - img[(size_t)ys * w + xs];
          d2[(size_t)y * w + x] = d * d;
        }
      }
      // box filter (mirror borders) over the patch window
      for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
          double sum = 0;
          for (int py = -tr; py <= tr; ++py) {
            int yy = clampi(y + py, 0, h - 1);
            for (int px = -tr; px <= tr; ++px) {
              int xx = clampi(x + px, 0, w - 1);
              sum += d2[(size_t)yy * w + xx];
            }
          }
          box[(size_t)y * w + x] = sum;
        }
      }
      for (int y = 0; y < h; ++y) {
        int ys = ((y - dy) % h + h) % h;
        for (int x = 0; x < w; ++x) {
          int xs = ((x - dx) % w + w) % w;
          double wgt = std::exp(-box[(size_t)y * w + x] / h2);
          acc[(size_t)y * w + x] += wgt * img[(size_t)ys * w + xs];
          wacc[(size_t)y * w + x] += wgt;
        }
      }
    }
  }
  for (size_t i = 0; i < (size_t)h * w; ++i) {
    double v = acc[i] / wacc[i];
    dst[i] = (uint8_t)std::min(255.0, std::max(0.0, std::round(v)));
  }
}

// ---------------------------------------------------------------------------
// CLAHE, uint8
// ---------------------------------------------------------------------------
void clahe_u8(const uint8_t* src, uint8_t* dst, int h, int w,
              double clip_limit, int grid_h, int grid_w) {
  const int nbins = 256;
  int th = (h + grid_h - 1) / grid_h;
  int tw = (w + grid_w - 1) / grid_w;
  double clip = std::max(1.0, clip_limit * th * tw / nbins);

  std::vector<double> luts((size_t)grid_h * grid_w * nbins);
  std::vector<double> hist(nbins);
  for (int gi = 0; gi < grid_h; ++gi) {
    for (int gj = 0; gj < grid_w; ++gj) {
      std::fill(hist.begin(), hist.end(), 0.0);
      for (int y = gi * th; y < std::min((gi + 1) * th, h + (th * grid_h - h));
           ++y) {
        int yy = std::min(y, h - 1);  // edge-pad partial tiles
        for (int x = gj * tw; x < (gj + 1) * tw; ++x) {
          int xx = std::min(x, w - 1);
          hist[src[(size_t)yy * w + xx]] += 1.0;
        }
      }
      double excess = 0;
      for (int b = 0; b < nbins; ++b)
        if (hist[b] > clip) {
          excess += hist[b] - clip;
          hist[b] = clip;
        }
      double redist = excess / nbins;
      double cdf = 0, total = 0;
      for (int b = 0; b < nbins; ++b) total += hist[b] + redist;
      double* lut = &luts[((size_t)gi * grid_w + gj) * nbins];
      for (int b = 0; b < nbins; ++b) {
        cdf += hist[b] + redist;
        lut[b] = cdf / total * (nbins - 1);
      }
    }
  }

  for (int y = 0; y < h; ++y) {
    double ty = (y + 0.5) / th - 0.5;
    int y0 = std::clamp((int)std::floor(ty), 0, grid_h - 1);
    int y1 = std::min(y0 + 1, grid_h - 1);
    double fy = std::clamp(ty - y0, 0.0, 1.0);
    for (int x = 0; x < w; ++x) {
      double tx = (x + 0.5) / tw - 0.5;
      int x0 = std::clamp((int)std::floor(tx), 0, grid_w - 1);
      int x1 = std::min(x0 + 1, grid_w - 1);
      double fx = std::clamp(tx - x0, 0.0, 1.0);
      int v = src[(size_t)y * w + x];
      double v00 = luts[((size_t)y0 * grid_w + x0) * nbins + v];
      double v01 = luts[((size_t)y0 * grid_w + x1) * nbins + v];
      double v10 = luts[((size_t)y1 * grid_w + x0) * nbins + v];
      double v11 = luts[((size_t)y1 * grid_w + x1) * nbins + v];
      double out = v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx +
                   v10 * fy * (1 - fx) + v11 * fy * fx;
      dst[(size_t)y * w + x] =
          (uint8_t)std::min(255.0, std::max(0.0, std::round(out)));
    }
  }
}

// ---------------------------------------------------------------------------
// Bilateral filter, uint8 (circular neighborhood like OpenCV)
// ---------------------------------------------------------------------------
void bilateral_u8(const uint8_t* src, uint8_t* dst, int h, int w, int diameter,
                  double sigma_color, double sigma_space) {
  int r = diameter / 2;
  double inv2sc2 = 1.0 / (2.0 * sigma_color * sigma_color);
  double inv2ss2 = 1.0 / (2.0 * sigma_space * sigma_space);

  // precompute spatial weights for the circular window
  std::vector<double> sw;
  std::vector<int> offs;
  for (int dy = -r; dy <= r; ++dy)
    for (int dx = -r; dx <= r; ++dx) {
      if (dx * dx + dy * dy > r * r) continue;
      sw.push_back(std::exp(-(dx * dx + dy * dy) * inv2ss2));
      offs.push_back(dy);
      offs.push_back(dx);
    }
  // color-difference weight LUT
  double clut[256];
  for (int d = 0; d < 256; ++d) clut[d] = std::exp(-(double)d * d * inv2sc2);

  auto reflect = [](int i, int n) {
    while (i < 0 || i >= n) {
      if (i < 0) i = -i - 1;  // symmetric
      if (i >= n) i = 2 * n - 1 - i;
    }
    return i;
  };

  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      double center = src[(size_t)y * w + x];
      double acc = 0, wacc = 0;
      for (size_t i = 0; i < sw.size(); ++i) {
        int yy = reflect(y + offs[2 * i], h);
        int xx = reflect(x + offs[2 * i + 1], w);
        double v = src[(size_t)yy * w + xx];
        double wgt = sw[i] * clut[(int)std::abs(v - center)];
        acc += wgt * v;
        wacc += wgt;
      }
      dst[(size_t)y * w + x] =
          (uint8_t)std::min(255.0, std::max(0.0, std::round(acc / wacc)));
    }
}

// ---------------------------------------------------------------------------
// Canny edge detection, uint8 -> uint8 (0/255), Sobel aperture 3, L2 option
// ---------------------------------------------------------------------------
void canny_u8(const uint8_t* src, uint8_t* dst, int h, int w, double th1,
              double th2, int l2gradient) {
  double lo = std::min(th1, th2), hi = std::max(th1, th2);
  size_t n = (size_t)h * w;
  std::vector<double> gx(n, 0.0), gy(n, 0.0), mag(n, 0.0);

  auto at = [&](int y, int x) {
    y = std::clamp(y, 0, h - 1);
    x = std::clamp(x, 0, w - 1);
    return (double)src[(size_t)y * w + x];
  };
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      double sx = -at(y - 1, x - 1) + at(y - 1, x + 1) - 2 * at(y, x - 1) +
                  2 * at(y, x + 1) - at(y + 1, x - 1) + at(y + 1, x + 1);
      double sy = -at(y - 1, x - 1) - 2 * at(y - 1, x) - at(y - 1, x + 1) +
                  at(y + 1, x - 1) + 2 * at(y + 1, x) + at(y + 1, x + 1);
      gx[(size_t)y * w + x] = sx;
      gy[(size_t)y * w + x] = sy;
      mag[(size_t)y * w + x] =
          l2gradient ? std::sqrt(sx * sx + sy * sy)
                     : std::abs(sx) + std::abs(sy);
    }

  const double tan225 = 0.4142135623730951, tan675 = 2.414213562373095;
  std::vector<uint8_t> state(n, 0);  // 0 none, 1 weak, 2 strong
  auto m = [&](int y, int x) -> double {
    if (y < 0 || y >= h || x < 0 || x >= w) return 0.0;
    return mag[(size_t)y * w + x];
  };
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      size_t i = (size_t)y * w + x;
      double v = mag[i];
      if (v <= lo) continue;
      double ax = std::abs(gx[i]), ay = std::abs(gy[i]);
      bool keep;
      if (ay <= tan225 * ax)
        keep = v > m(y, x - 1) && v >= m(y, x + 1);
      else if (ay >= tan675 * ax)
        keep = v > m(y - 1, x) && v >= m(y + 1, x);
      else if (gx[i] * gy[i] > 0)
        keep = v > m(y - 1, x - 1) && v >= m(y + 1, x + 1);
      else
        keep = v > m(y - 1, x + 1) && v >= m(y + 1, x - 1);
      if (keep) state[i] = v > hi ? 2 : 1;
    }

  // hysteresis: BFS from strong pixels through weak neighbors
  std::vector<size_t> stack;
  for (size_t i = 0; i < n; ++i)
    if (state[i] == 2) stack.push_back(i);
  std::vector<uint8_t> out(n, 0);
  while (!stack.empty()) {
    size_t i = stack.back();
    stack.pop_back();
    if (out[i]) continue;
    out[i] = 255;
    int y = (int)(i / w), x = (int)(i % w);
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        int yy = y + dy, xx = x + dx;
        if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
        size_t j = (size_t)yy * w + xx;
        if (state[j] >= 1 && !out[j]) stack.push_back(j);
      }
  }
  std::memcpy(dst, out.data(), n);
}

// ---------------------------------------------------------------------------
// Exact Euclidean distance transform (Meijster), bool edge mask -> double
// distances to the nearest TRUE pixel.
// ---------------------------------------------------------------------------
void exact_edt(const uint8_t* edge, double* dist, int h, int w) {
  const int64_t INF = (int64_t)1 << 40;
  std::vector<int64_t> g((size_t)h * w);

  // phase 1: per-row 1-D distance to nearest edge pixel
  for (int y = 0; y < h; ++y) {
    int64_t* row = &g[(size_t)y * w];
    row[0] = edge[(size_t)y * w] ? 0 : INF;
    for (int x = 1; x < w; ++x)
      row[x] = edge[(size_t)y * w + x]
                   ? 0
                   : (row[x - 1] >= INF ? INF : row[x - 1] + 1);
    for (int x = w - 2; x >= 0; --x)
      if (row[x + 1] + 1 < row[x]) row[x] = row[x + 1] + 1;
  }

  // phase 2: per-column lower envelope of parabolas (Meijster / Felzenszwalb)
  std::vector<int> v(h);
  std::vector<double> z(h + 1);
  std::vector<int64_t> f(h);
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y) {
      int64_t gy = g[(size_t)y * w + x];
      f[y] = gy >= INF ? INF : gy * gy;
    }
    int k = 0;
    v[0] = 0;
    z[0] = -1e30;
    z[1] = 1e30;
    for (int q = 1; q < h; ++q) {
      if (f[q] >= INF) continue;
      double s;
      while (true) {
        int p = v[k];
        if (f[p] >= INF) {
          // previous vertex is at infinity: replace it
          if (k > 0) { --k; continue; }
          v[0] = q; z[0] = -1e30; z[1] = 1e30; s = -1e30; break;
        }
        s = ((double)(f[q] + (int64_t)q * q) - (double)(f[p] + (int64_t)p * p)) /
            (2.0 * (q - p));
        if (s <= z[k]) {
          if (k == 0) { v[0] = q; z[0] = -1e30; z[1] = 1e30; break; }
          --k;
        } else {
          ++k;
          v[k] = q;
          z[k] = s;
          z[k + 1] = 1e30;
          break;
        }
      }
    }
    k = 0;
    for (int y = 0; y < h; ++y) {
      while (z[k + 1] < y) ++k;
      int p = v[k];
      double d;
      if (f[p] >= INF)
        d = 1e30;  // whole column unreachable (no edge pixels anywhere)
      else
        d = std::sqrt((double)((int64_t)(y - p) * (y - p)) + (double)f[p]);
      dist[(size_t)y * w + x] = d;
    }
  }
}

}  // extern "C"
