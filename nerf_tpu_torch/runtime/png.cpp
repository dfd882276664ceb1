// The port's PNG decoder: section 1 of the JAX package's native runtime
// (nerf_tpu/runtime/runtime.cpp), with the same C interface and the same
// arithmetic, so one file decodes to the same floats bit for bit. Each PNG
// is decoded to RGBA8 with libpng (16-bit channels stripped, palettes, grey
// and tRNS expanded), resized bilinearly to the requested size and, where
// asked, composited onto a white background (rgb * a + (1 - a)); the
// images are shared among threads.
//
// A library of its own (libnerf_png), so that the ray producer
// (runtime.cpp) does not depend on libpng. A plain C ABI bound with ctypes
// (nerf_tpu_torch/runtime/__init__.py), built there with
// g++ -O3 -fPIC -std=c++17 -pthread -shared -ffp-contract=off ... -lpng -lz.

#include <png.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// Decode one PNG to RGBA8. Returns 0 on success.
static int decode_png_rgba(const char* path, std::vector<uint8_t>* out,
                           uint32_t* w, uint32_t* h) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) { fclose(fp); return 2; }
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); fclose(fp); return 2; }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_GRAY ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_filler(png, 0xFF, PNG_FILLER_AFTER);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  out->resize(size_t(*w) * *h * 4);
  std::vector<png_bytep> rows(*h);
  for (uint32_t y = 0; y < *h; y++) rows[y] = out->data() + size_t(y) * *w * 4;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return 0;
}

// Bilinear resize RGBA8 [sh, sw] -> float RGB [dh, dw] with white-background
// compositing (rgb * a + (1 - a)) when white_bkgd. At the source's own size
// every weight is 0, so a pixel is its bytes / 255 (then composited).
static void resize_composite(const uint8_t* src, uint32_t sw, uint32_t sh,
                             float* dst, uint32_t dw, uint32_t dh,
                             int white_bkgd) {
  const float sx = dw > 1 ? float(sw - 1) / float(dw - 1) : 0.f;
  const float sy = dh > 1 ? float(sh - 1) / float(dh - 1) : 0.f;
  for (uint32_t y = 0; y < dh; y++) {
    float fy = y * sy;
    uint32_t y0 = (uint32_t)fy;
    uint32_t y1 = y0 + 1 < sh ? y0 + 1 : y0;
    float wy = fy - y0;
    for (uint32_t x = 0; x < dw; x++) {
      float fx = x * sx;
      uint32_t x0 = (uint32_t)fx;
      uint32_t x1 = x0 + 1 < sw ? x0 + 1 : x0;
      float wx = fx - x0;
      float px[4];
      for (int c = 0; c < 4; c++) {
        float v00 = src[(size_t(y0) * sw + x0) * 4 + c];
        float v01 = src[(size_t(y0) * sw + x1) * 4 + c];
        float v10 = src[(size_t(y1) * sw + x0) * 4 + c];
        float v11 = src[(size_t(y1) * sw + x1) * 4 + c];
        px[c] = ((v00 * (1 - wx) + v01 * wx) * (1 - wy) +
                 (v10 * (1 - wx) + v11 * wx) * wy) / 255.f;
      }
      float a = px[3];
      float* o = dst + (size_t(y) * dw + x) * 3;
      for (int c = 0; c < 3; c++)
        o[c] = white_bkgd ? px[c] * a + (1.f - a) : px[c];
    }
  }
}

// Decode n PNGs (newline-joined paths) into out [n, dh, dw, 3] float32.
// Threaded across images (n_threads <= 0: one per hardware thread). Returns
// the number of failures; a failed image's slot is left as it was.
int nerf_decode_png_batch(const char* joined_paths, int n_paths,
                          float* out, uint32_t dw, uint32_t dh,
                          int white_bkgd, int n_threads) {
  std::vector<std::string> paths;
  {
    const char* p = joined_paths;
    for (int i = 0; i < n_paths; i++) {
      const char* e = strchr(p, '\n');
      if (!e) e = p + strlen(p);
      paths.emplace_back(p, e - p);
      p = (*e ? e + 1 : e);
    }
  }
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_paths) return;
      std::vector<uint8_t> rgba;
      uint32_t w = 0, h = 0;
      if (decode_png_rgba(paths[i].c_str(), &rgba, &w, &h) != 0) {
        failures.fetch_add(1);
        continue;
      }
      resize_composite(rgba.data(), w, h,
                       out + size_t(i) * dw * dh * 3, dw, dh, white_bkgd);
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++) ts.emplace_back(worker);
  for (auto& t : ts) t.join();
  return failures.load();
}

}  // extern "C"
