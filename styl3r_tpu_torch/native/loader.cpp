// Host data loading: batched JPEG decode + Lanczos resize (the port's copy
// of styl3r_tpu/native/loader.cpp, which its dataset holds bit for bit).
//
// The counterpart of the reference's DataLoader worker hot loop (JPEG
// decode via PIL + LANCZOS resize): a C ABI library driven from Python via
// ctypes. Decodes a batch of JPEG buffers in a thread pool and resizes each
// frame of another shape to the target size with a separable Lanczos-3
// filter (PIL-compatible: the filter support widens by the scale factor
// when downscaling), emitting float32 [0,1] HWC.
//
// Build: styl3r_tpu_torch/native/__init__.py (g++ -O3 -march=native -fPIC
// -shared -std=c++17 loader.cpp -ljpeg -lpthread).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <csetjmp>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG into an RGB uint8 buffer. Returns false on failure.
bool decode_one(const uint8_t* data, size_t size, std::vector<uint8_t>& rgb,
                int& width, int& height) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  width = cinfo.output_width;
  height = cinfo.output_height;
  rgb.resize(static_cast<size_t>(width) * height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

double lanczos3(double x) {
  if (x == 0.0) return 1.0;
  if (x <= -3.0 || x >= 3.0) return 0.0;
  const double pi = 3.14159265358979323846;
  double px = pi * x;
  return 3.0 * std::sin(px) * std::sin(px / 3.0) / (px * px);
}

// Precomputed per-output-pixel filter taps (PIL-style).
struct Taps {
  std::vector<int> starts;       // first source index per output pixel
  std::vector<int> sizes;        // number of taps per output pixel
  std::vector<double> weights;   // concatenated weights
  std::vector<int> offsets;      // offset of each output pixel's weights
};

Taps make_taps(int in_size, int out_size) {
  Taps taps;
  double scale = static_cast<double>(in_size) / out_size;
  double support = 3.0 * std::max(scale, 1.0);
  taps.starts.resize(out_size);
  taps.sizes.resize(out_size);
  taps.offsets.resize(out_size);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int lo = std::max(0, static_cast<int>(std::floor(center - support)));
    int hi = std::min(in_size, static_cast<int>(std::ceil(center + support)));
    taps.starts[i] = lo;
    taps.sizes[i] = hi - lo;
    taps.offsets[i] = static_cast<int>(taps.weights.size());
    double total = 0.0;
    for (int j = lo; j < hi; ++j) {
      double w = lanczos3((j + 0.5 - center) / std::max(scale, 1.0));
      taps.weights.push_back(w);
      total += w;
    }
    if (total != 0.0) {
      for (int j = 0; j < taps.sizes[i]; ++j)
        taps.weights[taps.offsets[i] + j] /= total;
    }
  }
  return taps;
}

// Separable Lanczos resize uint8 HWC -> float32 HWC in [0, 1].
void resize_lanczos(const uint8_t* src, int in_h, int in_w, float* dst,
                    int out_h, int out_w) {
  Taps tx = make_taps(in_w, out_w);
  Taps ty = make_taps(in_h, out_h);
  // Horizontal pass: (in_h, out_w, 3) float.
  std::vector<float> wx(tx.weights.begin(), tx.weights.end());
  std::vector<float> tmp(static_cast<size_t>(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * in_w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      float acc0 = 0, acc1 = 0, acc2 = 0;
      const float* w = wx.data() + tx.offsets[x];
      const uint8_t* px = row + static_cast<size_t>(tx.starts[x]) * 3;
      for (int k = 0; k < tx.sizes[x]; ++k, px += 3) {
        acc0 += w[k] * px[0];
        acc1 += w[k] * px[1];
        acc2 += w[k] * px[2];
      }
      trow[x * 3 + 0] = acc0;
      trow[x * 3 + 1] = acc1;
      trow[x * 3 + 2] = acc2;
    }
  }
  // Vertical pass (row-major accumulation so the inner loop vectorizes),
  // then normalize to [0, 1] with clamping (PIL clamps to uint8).
  const int row_elems = out_w * 3;
  std::vector<float> acc(row_elems);
  for (int y = 0; y < out_h; ++y) {
    std::fill(acc.begin(), acc.end(), 0.0f);
    const double* w = ty.weights.data() + ty.offsets[y];
    int s = ty.starts[y];
    for (int k = 0; k < ty.sizes[y]; ++k) {
      const float wk = static_cast<float>(w[k]);
      const float* trow = tmp.data() + static_cast<size_t>(s + k) * row_elems;
      for (int j = 0; j < row_elems; ++j) acc[j] += wk * trow[j];
    }
    float* drow = dst + static_cast<size_t>(y) * row_elems;
    for (int j = 0; j < row_elems; ++j) {
      float clamped = std::min(255.0f, std::max(0.0f, acc[j]));
      drow[j] = clamped * (1.0f / 255.0f);
    }
  }
}

}  // namespace

extern "C" {

// Decode a batch of JPEGs and resize each to (out_h, out_w).
// datas: concatenated jpeg bytes; sizes/offsets: per-image extents;
// out: (n, out_h, out_w, 3) float32. Returns number of successful decodes.
// out_h/out_w <= 0 disables resizing ONLY if all images already match —
// callers must pass explicit sizes; failures leave zeros.
int styl3r_decode_jpeg_batch(const uint8_t* datas, const int64_t* offsets,
                             const int64_t* sizes, int n, float* out,
                             int out_h, int out_w, int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> ok(0);
  int n_threads = std::max(1, std::min(num_threads, 64));

  auto worker = [&]() {
    std::vector<uint8_t> rgb;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      if (!decode_one(datas + offsets[i], static_cast<size_t>(sizes[i]), rgb, w, h))
        continue;
      float* dst = out + static_cast<size_t>(i) * out_h * out_w * 3;
      if (w == out_w && h == out_h) {
        for (size_t j = 0; j < static_cast<size_t>(out_h) * out_w * 3; ++j)
          dst[j] = rgb[j] / 255.0f;
      } else {
        resize_lanczos(rgb.data(), h, w, dst, out_h, out_w);
      }
      ok.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

// Standalone Lanczos resize: float32 [0,1] HWC -> float32 [0,1] HWC.
void styl3r_resize_lanczos_f32(const float* src, int in_h, int in_w,
                               float* dst, int out_h, int out_w) {
  std::vector<uint8_t> as_u8(static_cast<size_t>(in_h) * in_w * 3);
  for (size_t i = 0; i < as_u8.size(); ++i) {
    float v = src[i] * 255.0f;
    as_u8[i] = static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, v)) + 0.5f);
  }
  resize_lanczos(as_u8.data(), in_h, in_w, dst, out_h, out_w);
}

}  // extern "C"
