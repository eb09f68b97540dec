// dirjax native host pipeline: JPEG/PNG decode + PIL-exact bilinear resize.
//
// The TPU side of extraction sustains >400 img/s (bench.py); PIL's
// Python-level decode+resize cannot feed that from one process because it
// holds the GIL for most of its work. This module is the native data-loader
// analog of the reference's torch DataLoader workers
// (dirtorch/utils/pytorch_loader.py:67-73): plain C entry points called via
// ctypes (which releases the GIL), so an ordinary ThreadPoolExecutor scales
// across cores with no pickling or worker processes.
//
// Parity contract (enforced by tests/test_native.py):
//   * decode: bit-identical to PIL Image.open().convert("RGB") for baseline
//     and progressive JPEG and for PNG — we link the same libjpeg-turbo /
//     libpng the system Pillow uses, with the same settings (ISLOW DCT,
//     fancy upsampling).
//   * resize: bit-identical to PIL Image.resize(size, Image.BILINEAR) —
//     a reimplementation of Pillow's two-pass convolution resampler
//     (triangle filter, 22-bit fixed-point coefficients, horizontal pass
//     first), NOT a naive 2x2 bilinear.
//
// Everything here is thread-safe: per-call codec state, no globals except
// a thread-local error string.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

void set_error(const char* msg) { g_error = msg ? msg : "unknown error"; }

// ---------------------------------------------------------------------------
// PIL-exact bilinear resampling (Pillow src/libImaging/Resample.c, 8bpc path)
// ---------------------------------------------------------------------------

constexpr int PRECISION_BITS = 32 - 8 - 2;  // 22, as in Pillow

inline uint8_t clip8(int in) {
  if (in >= (1 << (PRECISION_BITS + 8))) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> PRECISION_BITS);
}

inline double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Coefficient precomputation: identical arithmetic to Pillow's
// precompute_coeffs + normalize_coeffs_8bpc (support=1.0 for BILINEAR,
// scaled by the downscale factor so shrinking antialiases).
void precompute_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                       std::vector<int>* kk, int* ksize_out) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  bounds->assign(out_size * 2, 0);
  std::vector<double> prekk(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &prekk[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      double w = triangle_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    (*bounds)[xx * 2 + 0] = xmin;
    (*bounds)[xx * 2 + 1] = xmax;
  }
  kk->resize(prekk.size());
  for (size_t i = 0; i < prekk.size(); ++i) {
    (*kk)[i] = static_cast<int>(
        prekk[i] < 0 ? prekk[i] * (1 << PRECISION_BITS) - 0.5
                     : prekk[i] * (1 << PRECISION_BITS) + 0.5);
  }
  *ksize_out = ksize;
}

// Horizontal pass: (h, in_w, c) -> (h, out_w, c), interleaved uint8.
void resample_horizontal(const uint8_t* in, int h, int in_w, int c,
                         uint8_t* out, int out_w, const std::vector<int>& bounds,
                         const std::vector<int>& kk, int ksize) {
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = in + static_cast<size_t>(yy) * in_w * c;
    uint8_t* orow = out + static_cast<size_t>(yy) * out_w * c;
    for (int xx = 0; xx < out_w; ++xx) {
      int xmin = bounds[xx * 2 + 0];
      int xmax = bounds[xx * 2 + 1];
      const int* k = &kk[static_cast<size_t>(xx) * ksize];
      for (int ch = 0; ch < c; ++ch) {
        int ss = 1 << (PRECISION_BITS - 1);
        const uint8_t* px = row + (static_cast<size_t>(xmin)) * c + ch;
        for (int x = 0; x < xmax; ++x) ss += px[static_cast<size_t>(x) * c] * k[x];
        orow[static_cast<size_t>(xx) * c + ch] = clip8(ss);
      }
    }
  }
}

// Vertical pass: (in_h, w, c) -> (out_h, w, c).
void resample_vertical(const uint8_t* in, int in_h, int w, int c, uint8_t* out,
                       int out_h, const std::vector<int>& bounds,
                       const std::vector<int>& kk, int ksize) {
  for (int yy = 0; yy < out_h; ++yy) {
    int ymin = bounds[yy * 2 + 0];
    int ymax = bounds[yy * 2 + 1];
    const int* k = &kk[static_cast<size_t>(yy) * ksize];
    uint8_t* orow = out + static_cast<size_t>(yy) * w * c;
    for (int xx = 0; xx < w * c; ++xx) {
      int ss = 1 << (PRECISION_BITS - 1);
      const uint8_t* px = in + static_cast<size_t>(ymin) * w * c + xx;
      for (int y = 0; y < ymax; ++y) ss += px[static_cast<size_t>(y) * w * c] * k[y];
      orow[xx] = clip8(ss);
    }
  }
}

int resize_bilinear(const uint8_t* in, int in_h, int in_w, int c, uint8_t* out,
                    int out_h, int out_w) {
  if (in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || c <= 0) {
    set_error("resize: non-positive dimension");
    return -1;
  }
  bool need_h = out_w != in_w;
  bool need_v = out_h != in_h;
  if (!need_h && !need_v) {
    std::memcpy(out, in, static_cast<size_t>(in_h) * in_w * c);
    return 0;
  }
  std::vector<int> bounds, kk;
  int ksize;
  // Pillow order: horizontal first, then vertical.
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int cur_h = in_h, cur_w = in_w;
  if (need_h) {
    precompute_coeffs(in_w, out_w, &bounds, &kk, &ksize);
    if (need_v) {
      tmp.resize(static_cast<size_t>(in_h) * out_w * c);
      resample_horizontal(src, in_h, in_w, c, tmp.data(), out_w, bounds, kk,
                          ksize);
      src = tmp.data();
    } else {
      resample_horizontal(src, in_h, in_w, c, out, out_w, bounds, kk, ksize);
      return 0;
    }
    cur_w = out_w;
  }
  precompute_coeffs(cur_h, out_h, &bounds, &kk, &ksize);
  resample_vertical(src, cur_h, cur_w, c, out, out_h, bounds, kk, ksize);
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG (libjpeg-turbo, the codec Pillow links)
// ---------------------------------------------------------------------------

struct JpegError {
  jpeg_error_mgr mgr;
  jmp_buf env;
  char msg[JMSG_LENGTH_MAX];
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegError* err = reinterpret_cast<JpegError*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->msg);
  longjmp(err->env, 1);
}

// Decode a JPEG to RGB at native size. Returns 0 (ok), -1 (error),
// -2 (unsupported color space: caller should fall back to PIL).
int decode_jpeg(const uint8_t* buf, size_t len, uint8_t* out, int expect_w,
                int expect_h) {
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.env)) {
    set_error(jerr.msg);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    set_error("CMYK JPEG: fall back to PIL");
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  // Pillow defaults: ISLOW DCT, fancy upsampling — keep them for bit parity.
  cinfo.dct_method = JDCT_ISLOW;
  cinfo.do_fancy_upsampling = TRUE;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != expect_w ||
      static_cast<int>(cinfo.output_height) != expect_h ||
      cinfo.output_components != 3) {
    set_error("JPEG dims changed between probe and decode");
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  size_t stride = static_cast<size_t>(cinfo.output_width) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int probe_jpeg(const uint8_t* buf, size_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.env)) {
    set_error(jerr.msg);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  *w = static_cast<int>(cinfo.output_width);
  *h = static_cast<int>(cinfo.output_height);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG (libpng16 simplified API: handles palette/gray/alpha/16-bit for us)
// ---------------------------------------------------------------------------

int decode_png(const uint8_t* buf, size_t len, uint8_t* out, int expect_w,
               int expect_h) {
  png_image image;
  std::memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, buf, len)) {
    set_error(image.message);
    return -1;
  }
  if (static_cast<int>(image.width) != expect_w ||
      static_cast<int>(image.height) != expect_h) {
    png_image_free(&image);
    set_error("PNG dims changed between probe and decode");
    return -1;
  }
  if (image.format & PNG_FORMAT_FLAG_LINEAR) {
    // 16-bit PNG: PIL's I;16 -> RGB conversion differs from libpng's
    // 16->8 scaling; keep parity by falling back.
    png_image_free(&image);
    set_error("16-bit PNG: fall back to PIL");
    return -2;
  }
  bool has_alpha = (image.format & PNG_FORMAT_FLAG_ALPHA) != 0;
  if (!has_alpha) {
    image.format = PNG_FORMAT_RGB;
    if (!png_image_finish_read(&image, nullptr, out, 0, nullptr)) {
      set_error(image.message);
      return -1;
    }
    return 0;
  }
  // PIL's convert("RGB") DROPS alpha (no compositing); libpng's RGB format
  // would composite onto a background, so read RGBA and strip the channel.
  image.format = PNG_FORMAT_RGBA;
  size_t n = static_cast<size_t>(expect_w) * expect_h;
  std::vector<uint8_t> rgba(n * 4);
  if (!png_image_finish_read(&image, nullptr, rgba.data(), 0, nullptr)) {
    set_error(image.message);
    return -1;
  }
  for (size_t i = 0; i < n; ++i) {
    out[i * 3 + 0] = rgba[i * 4 + 0];
    out[i * 3 + 1] = rgba[i * 4 + 1];
    out[i * 3 + 2] = rgba[i * 4 + 2];
  }
  return 0;
}

int probe_png(const uint8_t* buf, size_t len, int* w, int* h) {
  png_image image;
  std::memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, buf, len)) {
    set_error(image.message);
    return -1;
  }
  *w = static_cast<int>(image.width);
  *h = static_cast<int>(image.height);
  png_image_free(&image);
  return 0;
}

constexpr int FMT_JPEG = 1;
constexpr int FMT_PNG = 2;

int sniff(const uint8_t* buf, size_t len) {
  if (len >= 3 && buf[0] == 0xFF && buf[1] == 0xD8 && buf[2] == 0xFF)
    return FMT_JPEG;
  if (len >= 8 && std::memcmp(buf, "\x89PNG\r\n\x1a\n", 8) == 0)
    return FMT_PNG;
  return 0;
}

}  // namespace

extern "C" {

const char* dj_last_error() { return g_error.c_str(); }

// Identify format and native RGB dimensions. 0 ok; -2 unsupported format.
int dj_probe(const uint8_t* buf, size_t len, int* w, int* h, int* fmt) {
  *fmt = sniff(buf, len);
  if (*fmt == FMT_JPEG) return probe_jpeg(buf, len, w, h);
  if (*fmt == FMT_PNG) return probe_png(buf, len, w, h);
  set_error("unrecognized image format");
  return -2;
}

// Decode to RGB uint8 HWC at native size (out must hold w*h*3 where (w, h)
// came from dj_probe). 0 ok; -2 means "fall back to PIL".
int dj_decode(const uint8_t* buf, size_t len, uint8_t* out, int w, int h) {
  int fmt = sniff(buf, len);
  if (fmt == FMT_JPEG) return decode_jpeg(buf, len, out, w, h);
  if (fmt == FMT_PNG) return decode_png(buf, len, out, w, h);
  set_error("unrecognized image format");
  return -2;
}

// PIL-exact Image.resize((out_w, out_h), Image.BILINEAR) on uint8 HWC.
int dj_resize_bilinear(const uint8_t* in, int in_h, int in_w, int channels,
                       uint8_t* out, int out_h, int out_w) {
  return resize_bilinear(in, in_h, in_w, channels, out, out_h, out_w);
}

// Fused decode + optional resize: decode at native (w, h), bilinear-resize
// into out at (out_w, out_h). One temp buffer, zero Python in the loop.
int dj_decode_resize(const uint8_t* buf, size_t len, int w, int h,
                     uint8_t* out, int out_w, int out_h) {
  if (w == out_w && h == out_h) return dj_decode(buf, len, out, w, h);
  std::vector<uint8_t> tmp(static_cast<size_t>(w) * h * 3);
  int rc = dj_decode(buf, len, tmp.data(), w, h);
  if (rc != 0) return rc;
  return resize_bilinear(tmp.data(), h, w, 3, out, out_h, out_w);
}

}  // extern "C"
