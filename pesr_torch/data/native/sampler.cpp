// Native data-loader core (SURVEY.md §1: the reference's closest thing
// to a runtime scheduler is torch DataLoader's native worker pool; this
// is the TPU-framework equivalent).  Two GIL-free services, exposed via
// a plain C ABI for ctypes (no pybind11 in this image):
//
//   * pesr_png_probe / pesr_png_decode — libpng RGB8 decode into a
//     caller-provided buffer (callers parallelize across files with a
//     thread pool; each decode releases no Python state).
//   * pesr_sample_patches — multithreaded assembly of an aligned random
//     HR crop batch from a cached image list, deterministic in
//     (seed, step) via SplitMix64 (bitwise-reproducible across runs and
//     thread counts: one RNG stream per batch element).
//
// Build: g++ -O3 -shared -fPIC sampler.cpp -lpng -o libpesr_data.so
// (pesr_tpu/data/native/__init__.py builds lazily and falls back to the
// pure-Python pipeline when the toolchain or libpng is missing).

#include <png.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// SplitMix64: tiny, seedable, excellent mixing for (seed, step, lane).
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

inline uint64_t mix3(uint64_t a, uint64_t b, uint64_t c) {
  uint64_t s = a * 0x9E3779B97F4A7C15ULL + b * 0xC2B2AE3D27D4EB4FULL + c;
  (void)splitmix64(s);
  return s;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------

int pesr_png_probe(const char* path, int* h, int* w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                           nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  // Row pointers live on the heap and are declared BEFORE setjmp: a
  // libpng error longjmps here, and jumping over a live std::vector
  // skips its destructor (UB + leak) — plain malloc/free is longjmp-safe.
  png_bytep* rows = nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    std::free(rows);
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *h = static_cast<int>(png_get_image_height(png, info));
  *w = static_cast<int>(png_get_image_width(png, info));
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// Decode into out[h*w*3] RGB8 (any bit depth/palette/gray/alpha input).
int pesr_png_decode(const char* path, unsigned char* out, int h, int w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                           nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  // Row pointers live on the heap and are declared BEFORE setjmp: a
  // libpng error longjmps here, and jumping over a live std::vector
  // skips its destructor (UB + leak) — plain malloc/free is longjmp-safe.
  png_bytep* rows = nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    std::free(rows);
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  if (static_cast<int>(png_get_image_height(png, info)) != h ||
      static_cast<int>(png_get_image_width(png, info)) != w) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 3;
  }

  // Normalize every input flavor to 8-bit RGB.
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA ||
      png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);

  rows = static_cast<png_bytep*>(std::malloc(sizeof(png_bytep) * h));
  if (!rows) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  for (int y = 0; y < h; ++y) {
    rows[y] = out + static_cast<size_t>(y) * w * 3;
  }
  png_read_image(png, rows);
  std::free(rows);
  rows = nullptr;
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------
// PNG encode
// ---------------------------------------------------------------------

// Write img[h*w*3] RGB8 as a PNG.  `level` is zlib 0-9 (test.py exports
// feed an offline metric pass, so the default caller favors speed over
// ratio).  Returns 0 on success.
int pesr_png_encode(const char* path, const unsigned char* img, int h,
                    int w, int level) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return 1;
  png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING,
                                            nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  png_bytep* rows = nullptr;  // see decode: longjmp-safe heap buffer
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    std::free(rows);
    if (png) png_destroy_write_struct(&png, &info);
    std::fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_set_compression_level(png, level);
  png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  rows = static_cast<png_bytep*>(std::malloc(sizeof(png_bytep) * h));
  if (!rows) {
    png_destroy_write_struct(&png, &info);
    std::fclose(fp);
    return 2;
  }
  for (int y = 0; y < h; ++y) {
    rows[y] = const_cast<png_bytep>(img + static_cast<size_t>(y) * w * 3);
  }
  png_write_image(png, rows);
  png_write_end(png, info);
  std::free(rows);
  rows = nullptr;
  png_destroy_write_struct(&png, &info);
  std::fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------
// Patch sampling
// ---------------------------------------------------------------------

// Assemble out_hr[batch, patch, patch, 3] of random aligned crops from
// nimg cached HWC-RGB8 images.  Deterministic in (seed, step).
void pesr_sample_patches(const unsigned char** imgs, const int* hs,
                         const int* ws, int nimg, int batch, int patch,
                         uint64_t seed, uint64_t step,
                         unsigned char* out_hr, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int b0, int b1) {
    for (int b = b0; b < b1; ++b) {
      uint64_t rng = mix3(seed, step, static_cast<uint64_t>(b));
      const int idx = static_cast<int>(splitmix64(rng) % nimg);
      const int maxy = hs[idx] - patch;
      const int maxx = ws[idx] - patch;
      const int y = maxy > 0 ? static_cast<int>(splitmix64(rng) % (maxy + 1)) : 0;
      const int x = maxx > 0 ? static_cast<int>(splitmix64(rng) % (maxx + 1)) : 0;
      const unsigned char* src = imgs[idx];
      const size_t src_stride = static_cast<size_t>(ws[idx]) * 3;
      unsigned char* dst =
          out_hr + static_cast<size_t>(b) * patch * patch * 3;
      for (int r = 0; r < patch; ++r) {
        std::memcpy(dst + static_cast<size_t>(r) * patch * 3,
                    src + (static_cast<size_t>(y + r)) * src_stride +
                        static_cast<size_t>(x) * 3,
                    static_cast<size_t>(patch) * 3);
      }
    }
  };
  if (nthreads == 1 || batch < 2 * nthreads) {
    work(0, batch);
    return;
  }
  std::vector<std::thread> pool;
  const int chunk = (batch + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int b0 = t * chunk;
    const int b1 = b0 + chunk < batch ? b0 + chunk : batch;
    if (b0 >= b1) break;
    pool.emplace_back(work, b0, b1);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
