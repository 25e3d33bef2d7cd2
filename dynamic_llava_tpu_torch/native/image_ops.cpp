// Native image ingest for the training/eval data loaders: the port's own
// copy of dynamic_llava_tpu/native/image_ops.cpp (host code, no CUDA).
//
// Replaces the reference's PIL + torchvision host pipeline (the C inside
// Pillow; the reference's llava/mm_utils.py:163-199) with a single fused,
// OpenMP-threaded pass: pad-to-square (dataset-mean background) -> separable
// antialiased bicubic resize (Pillow-compatible Keys a=-0.5 kernel with
// support scaling) -> CLIP mean/std normalization, uint8 in, fp32 NHWC out.
//
// Exposed via a C ABI for ctypes. Built at first use by native/__init__.py:
//   g++ -O3 -fopenmp -shared -fPIC image_ops.cpp -o <_build>/libimage_ops_<digest>.so
// (the JAX package's flags, so that both libraries compute the same bits).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Keys bicubic kernel, a = -0.5 (Pillow's "bicubic" filter)
inline double bicubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct FilterBank {
  // per output pixel: [first source index, weight count], flat weights
  std::vector<int> bounds;     // 2 * out_size
  std::vector<double> weights; // out_size * max_taps
  int max_taps = 0;
};

// Pillow-style coefficient precomputation (antialias: support scales with
// the downscale factor).
FilterBank make_filter(int in_size, int out_size) {
  FilterBank fb;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale; // bicubic support = 2
  const int max_taps = static_cast<int>(std::ceil(support)) * 2 + 1;
  fb.max_taps = max_taps;
  fb.bounds.resize(2 * out_size);
  fb.weights.assign(static_cast<size_t>(out_size) * max_taps, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int taps = xmax - xmin;
    double* w = &fb.weights[static_cast<size_t>(xx) * max_taps];
    double total = 0.0;
    for (int i = 0; i < taps; ++i) {
      w[i] = bicubic((xmin + i - center + 0.5) / filterscale);
      total += w[i];
    }
    if (total != 0.0)
      for (int i = 0; i < taps; ++i) w[i] /= total;
    fb.bounds[2 * xx] = xmin;
    fb.bounds[2 * xx + 1] = taps;
  }
  return fb;
}

}  // namespace

extern "C" {

// One image: uint8 HWC [h, w, 3] -> fp32 HWC [out, out, 3], fused
// pad-to-square + bicubic resize + (x/255 - mean)/std.
// bg: background RGB in 0..255 (dataset mean), mean/std: CLIP stats.
void clip_preprocess_one(const uint8_t* img, int h, int w, int out_size,
                         const float* bg, const float* mean, const float* std_,
                         float* out) {
  const int side = std::max(h, w);
  const int top = (side - h) / 2;
  const int left = (side - w) / 2;

  FilterBank fx = make_filter(side, out_size);
  FilterBank fy = make_filter(side, out_size);

  // horizontal pass on the virtual padded image: [side, out_size, 3]
  std::vector<double> tmp(static_cast<size_t>(side) * out_size * 3);
  for (int y = 0; y < side; ++y) {
    const int sy = y - top;  // source row, or padding
    const bool row_is_pad = (sy < 0 || sy >= h);
    for (int xx = 0; xx < out_size; ++xx) {
      const int xmin = fx.bounds[2 * xx];
      const int taps = fx.bounds[2 * xx + 1];
      const double* wv = &fx.weights[static_cast<size_t>(xx) * fx.max_taps];
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < taps; ++i) {
        const int sx = xmin + i - left;  // source col, or padding
        double px[3];
        if (row_is_pad || sx < 0 || sx >= w) {
          px[0] = bg[0]; px[1] = bg[1]; px[2] = bg[2];
        } else {
          const uint8_t* p = img + (static_cast<size_t>(sy) * w + sx) * 3;
          px[0] = p[0]; px[1] = p[1]; px[2] = p[2];
        }
        acc[0] += wv[i] * px[0];
        acc[1] += wv[i] * px[1];
        acc[2] += wv[i] * px[2];
      }
      // Pillow re-quantizes each separable pass to uint8: negatives clamp
      // to 0 and overshoot to 255. Without this the two passes' ringing
      // multiplies and diverges from the reference pipeline.
      double* t = &tmp[(static_cast<size_t>(y) * out_size + xx) * 3];
      for (int c = 0; c < 3; ++c)
        t[c] = std::round(std::min(255.0, std::max(0.0, acc[c])));
    }
  }

  // vertical pass + clamp (Pillow clips each separable pass back to uint8
  // range) + normalize
  for (int yy = 0; yy < out_size; ++yy) {
    const int ymin = fy.bounds[2 * yy];
    const int taps = fy.bounds[2 * yy + 1];
    const double* wv = &fy.weights[static_cast<size_t>(yy) * fy.max_taps];
    for (int xx = 0; xx < out_size; ++xx) {
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < taps; ++i) {
        const double* t =
            &tmp[(static_cast<size_t>(ymin + i) * out_size + xx) * 3];
        acc[0] += wv[i] * t[0];
        acc[1] += wv[i] * t[1];
        acc[2] += wv[i] * t[2];
      }
      float* o = out + (static_cast<size_t>(yy) * out_size + xx) * 3;
      for (int c = 0; c < 3; ++c) {
        double v = std::min(255.0, std::max(0.0, acc[c])) / 255.0;
        o[c] = static_cast<float>((v - mean[c]) / std_[c]);
      }
    }
  }
}

// Batched entry: images are ragged (offsets into a flat uint8 buffer).
void clip_preprocess_batch(const uint8_t* data, const int64_t* offsets,
                           const int* heights, const int* widths, int n,
                           int out_size, const float* bg, const float* mean,
                           const float* std_, float* out) {
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    clip_preprocess_one(data + offsets[i], heights[i], widths[i], out_size,
                        bg, mean, std_,
                        out + static_cast<size_t>(i) * out_size * out_size * 3);
  }
}

int image_ops_version() { return 1; }

}  // extern "C"
