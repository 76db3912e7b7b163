// The host image loader: threaded image decode + resize + batch assembly.
//
// The JAX package's runtime/loader.cpp, copied (the port builds its own
// copy, with ops/cuda/build.py: g++ -ljpeg -lpng -lpthread):
//
//   - otm_load_images:   decode (libjpeg/libpng) -> grayscale/RGB ->
//                         bilinear resize (torch half-pixel convention) ->
//                         packed uint8 [N,H,W,C] tensor, parallel over files.
//   - otm_assemble_batch: gather rows by index, optional horizontal flip,
//                         normalize to float32 [-1,1] (x * (1 / 127.5) - 1)
//                         in one pass, no Python per-image loop.
//
// Exposed as a plain C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <atomic>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ------------------------------------------------------------- decode

struct Image {
  std::vector<uint8_t> data;  // HWC, C in {1,3}
  int h = 0, w = 0, c = 0;
  bool ok = false;
};

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto *err = reinterpret_cast<JpegErrorMgr *>(cinfo->err);
  longjmp(err->jump, 1);
}

Image decode_jpeg(FILE *f, int want_c) {
  Image img;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return img;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = want_c == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img.w = cinfo.output_width;
  img.h = cinfo.output_height;
  img.c = cinfo.output_components;
  img.data.resize(size_t(img.h) * img.w * img.c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t *row = img.data.data() + size_t(cinfo.output_scanline) * img.w * img.c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  img.ok = true;
  return img;
}

Image decode_png(FILE *f, int want_c) {
  Image img;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return img;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return img;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return img;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_packing(png);
  png_set_strip_alpha(png);
  int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (want_c == 1) {
    if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
        color == PNG_COLOR_TYPE_PALETTE)
      png_set_rgb_to_gray(png, 1, -1, -1);
  } else {
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    if (color == PNG_COLOR_TYPE_GRAY && png_get_bit_depth(png, info) < 8)
      png_set_expand_gray_1_2_4_to_8(png);
  }
  png_read_update_info(png, info);

  img.w = png_get_image_width(png, info);
  img.h = png_get_image_height(png, info);
  img.c = png_get_channels(png, info);
  img.data.resize(size_t(img.h) * img.w * img.c);
  std::vector<png_bytep> rows(img.h);
  for (int y = 0; y < img.h; ++y)
    rows[y] = img.data.data() + size_t(y) * img.w * img.c;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  img.ok = true;
  return img;
}

Image decode_file(const char *path, int want_c) {
  Image img;
  FILE *f = fopen(path, "rb");
  if (!f) return img;
  uint8_t magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    img = decode_jpeg(f, want_c);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    img = decode_png(f, want_c);
  }
  fclose(f);
  return img;
}

// ------------------------------------------------------------- resize

// Bilinear resize, torch align_corners=False / antialias=False convention
// (PIL's bilinear resize differs: it filters when it shrinks).
void resize_bilinear(const Image &src, uint8_t *dst, int oh, int ow, int c) {
  const float sy = float(src.h) / oh, sx = float(src.w) / ow;
  std::vector<int> x0(ow), x1(ow);
  std::vector<float> fx(ow);
  for (int x = 0; x < ow; ++x) {
    float s = (x + 0.5f) * sx - 0.5f;
    if (s < 0) s = 0;
    int lo = int(s);
    if (lo > src.w - 1) lo = src.w - 1;
    x0[x] = lo;
    x1[x] = lo + 1 < src.w ? lo + 1 : src.w - 1;
    fx[x] = s - lo;
  }
  for (int y = 0; y < oh; ++y) {
    float s = (y + 0.5f) * sy - 0.5f;
    if (s < 0) s = 0;
    int y0 = int(s);
    if (y0 > src.h - 1) y0 = src.h - 1;
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    float fy = s - y0;
    const uint8_t *r0 = src.data.data() + size_t(y0) * src.w * src.c;
    const uint8_t *r1 = src.data.data() + size_t(y1) * src.w * src.c;
    uint8_t *out = dst + size_t(y) * ow * c;
    for (int x = 0; x < ow; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        float v00 = r0[size_t(x0[x]) * src.c + ch];
        float v01 = r0[size_t(x1[x]) * src.c + ch];
        float v10 = r1[size_t(x0[x]) * src.c + ch];
        float v11 = r1[size_t(x1[x]) * src.c + ch];
        float top = v00 + (v01 - v00) * fx[x];
        float bot = v10 + (v11 - v10) * fx[x];
        float v = top + (bot - top) * fy;
        out[size_t(x) * c + ch] = uint8_t(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode + resize `n` files into out [n, h, w, c] uint8 with `threads`
// workers. paths: array of NUL-terminated strings. Returns number of
// successfully loaded images (failures leave zeros and are reported in
// ok_flags when non-null).
int otm_load_images(const char **paths, int n, int h, int w, int c,
                    int threads, uint8_t *out, uint8_t *ok_flags) {
  if (threads < 1) threads = 1;
  std::atomic<int> next(0), loaded(0);
  const size_t stride = size_t(h) * w * c;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image img = decode_file(paths[i], c);
      if (img.ok && img.c == c) {
        resize_bilinear(img, out + size_t(i) * stride, h, w, c);
        if (ok_flags) ok_flags[i] = 1;
        loaded.fetch_add(1);
      } else if (ok_flags) {
        ok_flags[i] = 0;
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto &t : pool) t.join();
  return loaded.load();
}

// Gather rows of images [N,h,w,c] u8 by `indices` [b], horizontally flip
// where flips[i] != 0, and normalize to float32 [-1, 1] into out [b,h,w,c].
void otm_assemble_batch(const uint8_t *images, const int64_t *indices, int b,
                        int h, int w, int c, const uint8_t *flips, float *out) {
  const size_t stride = size_t(h) * w * c;
  constexpr float kScale = 1.0f / 127.5f;
  for (int i = 0; i < b; ++i) {
    const uint8_t *src = images + size_t(indices[i]) * stride;
    float *dst = out + size_t(i) * stride;
    if (flips && flips[i]) {
      for (int y = 0; y < h; ++y) {
        const uint8_t *row = src + size_t(y) * w * c;
        float *orow = dst + size_t(y) * w * c;
        for (int x = 0; x < w; ++x) {
          const uint8_t *px = row + size_t(w - 1 - x) * c;
          for (int ch = 0; ch < c; ++ch)
            orow[size_t(x) * c + ch] = px[ch] * kScale - 1.0f;
        }
      }
    } else {
      for (size_t k = 0; k < stride; ++k) dst[k] = src[k] * kScale - 1.0f;
    }
  }
}

}  // extern "C"
