// Fused image decode + NEAREST-resize + crop (+ ImageNet normalize) for the
// host input pipeline.
//
// Why native: the reference delegates decode to torch DataLoader's native
// worker pool (src/train_segmentation.py:453 num_workers=24); this framework's
// loader is a Python thread, and PIL's decode-full-image -> resize -> numpy
// normalize chain is the measured host bottleneck (~5.4 ms/JPEG, ~14 ms/PNG at
// 640x480 on this host). This file decodes ONLY the scanlines the NEAREST
// resize keeps (jpeg_skip_scanlines / PNG row skipping), gathers the kept
// columns straight into the output buffer, and optionally fuses the float32
// ImageNet normalization — one pass, no intermediate full-resolution image.
// Called via ctypes, which releases the GIL, so the Python DataLoader can
// decode batch items on a thread pool that scales with host cores.
//
// Parity: the resize reproduces PIL's NEAREST pixel selection bit-exactly
// (accumulated-double source coordinate: xo = scale/2; idx = floor(xo);
// xo += scale — verified against PIL in tests/test_native_io.py), decode uses
// the same libjpeg-turbo family PIL bundles, and unsupported inputs (CMYK,
// interlaced or 16-bit PNG, size mismatches) return nonzero so the Python
// caller falls back to the PIL path. Reference transform semantics:
// src/utils.py:128-183 (NEAREST-even-for-images quirk).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// Error codes (negative): tell Python *why* we punted (useful in tests).
enum {
  OK = 0,
  E_OPEN = -1,
  E_FORMAT = -2,        // not JPEG/PNG magic
  E_COLORSPACE = -3,    // CMYK/YCCK jpeg, gray+alpha png, ...
  E_BITDEPTH = -4,      // non-8-bit png
  E_INTERLACED = -5,    // interlaced png
  E_DIMS = -6,          // decoded dims != expected dims
  E_DECODE = -7,        // library-level decode failure
  E_ARGS = -8,          // crop box outside resized image, bad mode
};

// PIL NEAREST source-index map (bit-exact: accumulated double, truncation).
void nearest_map(int src, int dst, std::vector<int>& idx) {
  idx.resize(dst);
  const double s = static_cast<double>(src) / static_cast<double>(dst);
  double xo = s * 0.5;
  for (int i = 0; i < dst; ++i) {
    int v = static_cast<int>(xo);  // xo >= 0 always
    idx[i] = v < src ? v : src - 1;
    xo += s;
  }
}

struct RowPlan {
  // For dst rows [top, top+out_h) of the resized image: source row per dst
  // row (non-decreasing) and source column per dst column.
  std::vector<int> src_row;  // size out_h
  std::vector<int> src_col;  // size out_w
  int max_row;               // last source row we need
};

bool make_plan(int src_h, int src_w, int resized_h, int resized_w, int top,
               int left, int out_h, int out_w, RowPlan* plan) {
  if (top < 0 || left < 0 || out_h <= 0 || out_w <= 0 ||
      top + out_h > resized_h || left + out_w > resized_w)
    return false;
  std::vector<int> ys, xs;
  nearest_map(src_h, resized_h, ys);
  nearest_map(src_w, resized_w, xs);
  plan->src_row.assign(ys.begin() + top, ys.begin() + top + out_h);
  plan->src_col.assign(xs.begin() + left, xs.begin() + left + out_w);
  plan->max_row = plan->src_row.back();
  return true;
}

// Modes (keep in sync with stego_tpu/data/native_io.py).
enum { MODE_IMG_RGB = 0, MODE_IMG_KEEP_ALPHA = 1, MODE_LABEL = 2 };

// Write one output row from a decoded source row.
// src: interleaved u8 row with src_c channels; out channel count out_c.
void emit_row(const unsigned char* src, int src_c, const std::vector<int>& cols,
              int mode, int normalize, int out_c, const float* mean,
              const float* stdv, void* out_row) {
  const int ow = static_cast<int>(cols.size());
  if (mode == MODE_LABEL) {
    int32_t* o = static_cast<int32_t*>(out_row);
    for (int j = 0; j < ow; ++j) o[j] = src[cols[j] * src_c];  // channel 0
    return;
  }
  if (normalize) {
    float* o = static_cast<float*>(out_row);
    for (int j = 0; j < ow; ++j) {
      const unsigned char* p = src + cols[j] * src_c;
      for (int c = 0; c < out_c; ++c) {
        // Bitwise-matches numpy: (u8 -> f32)/255.0f, then (v - mean)/std, f32.
        float v = static_cast<float>(p[c < src_c ? c : src_c - 1]) / 255.0f;
        o[j * out_c + c] = (v - mean[c]) / stdv[c];
      }
    }
  } else {
    unsigned char* o = static_cast<unsigned char*>(out_row);
    for (int j = 0; j < ow; ++j) {
      const unsigned char* p = src + cols[j] * src_c;
      for (int c = 0; c < out_c; ++c) o[j * out_c + c] = p[c < src_c ? c : src_c - 1];
    }
  }
}

size_t out_row_bytes(int mode, int normalize, int out_c, int out_w) {
  if (mode == MODE_LABEL) return sizeof(int32_t) * out_w;
  return (normalize ? sizeof(float) : 1) * static_cast<size_t>(out_c) * out_w;
}

// ------------------------------- JPEG ---------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

struct Geometry {
  int resized_h, resized_w, top, left, out_h, out_w;
};

int decode_jpeg(FILE* f, int exp_w, int exp_h, const Geometry& g, int mode,
                int normalize, int fast, const float* mean, const float* stdv,
                int out_c, unsigned char* out, size_t row_bytes) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  std::vector<unsigned char> rowbuf;
  RowPlan plan;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return E_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return E_COLORSPACE;
  }
  if (static_cast<int>(cinfo.image_width) != exp_w ||
      static_cast<int>(cinfo.image_height) != exp_h) {
    jpeg_destroy_decompress(&cinfo);
    return E_DIMS;
  }
  const bool gray_label =
      (mode == MODE_LABEL && cinfo.jpeg_color_space == JCS_GRAYSCALE);
  cinfo.out_color_space = gray_label ? JCS_GRAYSCALE : JCS_RGB;
  if (fast && mode != MODE_LABEL) {
    // Opt-in non-parity mode: decode at the largest DCT scale 1/d whose
    // output still covers the resize target, then NEAREST from that. The
    // IDCT does the downscale nearly for free (quality >= NEAREST-from-full;
    // pixels differ from PIL, hence the config gate).
    for (int d = 8; d >= 2; d /= 2) {
      // libjpeg computes scaled dims as ceil(dim * num / denom)
      long sw = (static_cast<long>(exp_w) + d - 1) / d;
      long sh = (static_cast<long>(exp_h) + d - 1) / d;
      if (sw >= g.resized_w && sh >= g.resized_h) {
        cinfo.scale_num = 1;
        cinfo.scale_denom = d;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  if (!make_plan(static_cast<int>(cinfo.output_height),
                 static_cast<int>(cinfo.output_width), g.resized_h,
                 g.resized_w, g.top, g.left, g.out_h, g.out_w, &plan)) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return E_ARGS;
  }
  const int src_c = cinfo.output_components;  // 1 (gray label) or 3
  rowbuf.resize(static_cast<size_t>(src_c) * cinfo.output_width);
  unsigned char* rptr = rowbuf.data();
  const int out_h = static_cast<int>(plan.src_row.size());
  int have_row = -1;  // source row currently in rowbuf
  for (int i = 0; i < out_h; ++i) {
    const int want = plan.src_row[i];
    if (want != have_row) {
      // Skip undecoded rows wholesale (libjpeg-turbo elides IDCT + color
      // conversion for them), then read the one we keep.
      while (static_cast<int>(cinfo.output_scanline) < want) {
        JDIMENSION left_over = want - cinfo.output_scanline;
        if (jpeg_skip_scanlines(&cinfo, left_over) == 0)
          jpeg_read_scanlines(&cinfo, &rptr, 1);  // defensive: force progress
      }
      jpeg_read_scanlines(&cinfo, &rptr, 1);
      have_row = want;
    }
    emit_row(rowbuf.data(), src_c, plan.src_col, mode, normalize, out_c, mean,
             stdv, out + static_cast<size_t>(i) * row_bytes);
  }
  jpeg_abort_decompress(&cinfo);  // we intentionally did not drain the image
  jpeg_destroy_decompress(&cinfo);
  return OK;
}

// ------------------------------- PNG ----------------------------------------

int decode_png(FILE* f, int exp_w, int exp_h, const Geometry& g, int mode,
               int normalize, const float* mean, const float* stdv, int out_c,
               unsigned char* out, size_t row_bytes) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return E_DECODE;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return E_DECODE;
  }
  std::vector<unsigned char> rowbuf;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return E_DECODE;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 0);
  png_read_info(png, info);
  const int w = static_cast<int>(png_get_image_width(png, info));
  const int h = static_cast<int>(png_get_image_height(png, info));
  const int depth = png_get_bit_depth(png, info);
  const int ctype = png_get_color_type(png, info);
  if (png_get_interlace_type(png, info) != PNG_INTERLACE_NONE) {
    png_destroy_read_struct(&png, &info, nullptr);
    return E_INTERLACED;
  }
  if (depth != 8 && !(ctype == PNG_COLOR_TYPE_PALETTE && depth < 8)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return E_BITDEPTH;
  }
  if (w != exp_w || h != exp_h) {
    png_destroy_read_struct(&png, &info, nullptr);
    return E_DIMS;
  }
  RowPlan plan;
  if (!make_plan(h, w, g.resized_h, g.resized_w, g.top, g.left, g.out_h,
                 g.out_w, &plan)) {
    png_destroy_read_struct(&png, &info, nullptr);
    return E_ARGS;
  }
  if (mode == MODE_LABEL) {
    // Palette labels stay raw indices (PIL np.asarray on mode-P semantics);
    // gray stays gray; RGB(A) -> channel 0 in emit_row.
    if (ctype == PNG_COLOR_TYPE_PALETTE && depth < 8)
      png_set_packing(png);  // expand 1/2/4-bit indices to one byte each
    if (ctype == PNG_COLOR_TYPE_GRAY_ALPHA) {
      png_destroy_read_struct(&png, &info, nullptr);
      return E_COLORSPACE;
    }
  } else {
    // Image semantics mirror the PIL path (transforms.py:117-118 +
    // dataset-level .convert("RGB")): palette -> RGB via the palette (tRNS
    // ignored, like PIL P->RGB), gray -> RGB, RGBA kept only in
    // MODE_IMG_KEEP_ALPHA, alpha dropped (not composited) otherwise.
    if (ctype == PNG_COLOR_TYPE_PALETTE) {
      png_set_palette_to_rgb(png);
      if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_strip_alpha(png);
    } else if (ctype == PNG_COLOR_TYPE_GRAY) {
      png_set_gray_to_rgb(png);
    } else if (ctype == PNG_COLOR_TYPE_GRAY_ALPHA) {
      png_destroy_read_struct(&png, &info, nullptr);
      return E_COLORSPACE;
    } else if (ctype == PNG_COLOR_TYPE_RGB_ALPHA && mode == MODE_IMG_RGB) {
      png_set_strip_alpha(png);
    }
  }
  png_read_update_info(png, info);
  const int src_c = static_cast<int>(png_get_channels(png, info));
  rowbuf.resize(png_get_rowbytes(png, info));
  const int out_h = static_cast<int>(plan.src_row.size());
  int cur = 0;  // next source row png_read_row will produce
  int have_row = -1;
  for (int i = 0; i < out_h; ++i) {
    const int want = plan.src_row[i];
    if (want != have_row) {
      // PNG rows must be inflated+defiltered sequentially, but rows we skip
      // never leave rowbuf — no per-pixel work, no full-image buffer.
      while (cur <= want) {
        png_read_row(png, rowbuf.data(), nullptr);
        ++cur;
      }
      have_row = want;
    }
    emit_row(rowbuf.data(), src_c, plan.src_col, mode, normalize, out_c, mean,
             stdv, out + static_cast<size_t>(i) * row_bytes);
  }
  png_destroy_read_struct(&png, &info, nullptr);  // rest of file unread: fine
  return OK;
}

}  // namespace

extern "C" {

// Decode `path` (JPEG or PNG), NEAREST-resize to (resized_h, resized_w) with
// PIL-exact pixel selection, crop [top:top+out_h, left:left+out_w], and write:
//   mode 0: u8/f32 HWC RGB (out_c must be 3)
//   mode 1: u8/f32 HWC, alpha kept if the source has it (out_c 3 or 4,
//           caller passes the channel count it expects from the header)
//   mode 2: int32 HW label (palette indices raw, RGB -> channel 0)
// normalize (images): write float32 (u8/255 - mean[c]) / stdv[c] instead of u8.
// exp_w/exp_h: dimensions the caller read from the header; mismatch -> E_DIMS.
// Returns 0 on success, a negative code when the caller should fall back to
// the PIL path.
// fast != 0 additionally allows DCT-scaled JPEG decode (image modes only) —
// faster but not PIL-bit-identical; gated by the fast_decode config key.
int stego_decode_transform(const char* path, int exp_w, int exp_h,
                           int resized_h, int resized_w, int top, int left,
                           int out_h, int out_w, int mode, int normalize,
                           int fast, const float* mean, const float* stdv,
                           int out_c, void* out) {
  if (mode < 0 || mode > 2 || out_c < 1 || out_c > 4) return E_ARGS;
  FILE* f = std::fopen(path, "rb");
  if (!f) return E_OPEN;
  unsigned char magic[8] = {0};
  size_t got = std::fread(magic, 1, 8, f);
  std::rewind(f);
  int ret;
  const Geometry g{resized_h, resized_w, top, left, out_h, out_w};
  const size_t rb = out_row_bytes(mode, normalize, out_c, out_w);
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ret = decode_jpeg(f, exp_w, exp_h, g, mode, normalize, fast, mean, stdv,
                      out_c, static_cast<unsigned char*>(out), rb);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ret = decode_png(f, exp_w, exp_h, g, mode, normalize, mean, stdv, out_c,
                     static_cast<unsigned char*>(out), rb);
  } else {
    ret = E_FORMAT;
  }
  std::fclose(f);
  return ret;
}

}  // extern "C"
