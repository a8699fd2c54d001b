// Native multi-threaded image loader: JPEG decode -> fused
// resize+crop+flip bilinear -> normalize, all in one pass per output
// pixel.
//
// This is the TPU-native equivalent of the reference's native data path
// (torch DataLoader worker processes + mmcv's C image ops feeding
// LoadMultiViewImageFromFiles / ResizeCropFlipImage,
// datasets/pipelines/loading.py + transform_3d.py:362-468): the 12
// JPEG decodes per sample dominate host time, so they run here in C++
// threads outside the GIL.
//
// C ABI (ctypes-friendly), no Python headers required:
//   grd4d_load_images(paths, n, resize, crop_x, crop_y, out_h, out_w,
//                     flip, mean, std, out, num_threads) -> 0 on success
//
// Build: g++ -O3 -shared -fPIC loader.cpp -o libgrd4dloader.so -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode a JPEG file to packed RGB8. Returns true on success.
bool decode_jpeg(const char* path, std::vector<uint8_t>* pixels, int* width,
                 int* height) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  // reject absurd headers (truncated/corrupt files can declare huge
  // dimensions) before attempting a multi-GB allocation
  if (cinfo.image_width == 0 || cinfo.image_height == 0 ||
      uint64_t(cinfo.image_width) * cinfo.image_height > (64ull << 20)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *width = cinfo.output_width;
  *height = cinfo.output_height;
  pixels->resize(size_t(*width) * *height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = pixels->data() + size_t(cinfo.output_scanline) * *width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Fused resize(scale)+crop+flip via direct bilinear sampling of the source.
// ONE copy of the sampling math; Emit turns the bilinear float into the
// output element (normalize-to-f32, or round-to-uint8). Per-column
// coefficients are precomputed once (they do not depend on the row), so
// the inner loop is table-driven float FMA.
template <typename OutT, typename Emit>
void sample_core(const uint8_t* src, int sh, int sw, double resize,
                 int crop_x, int crop_y, int out_h, int out_w, int flip,
                 OutT* out, Emit emit) {
  std::vector<int> xo0(out_w), xo1(out_w);
  std::vector<float> xlx(out_w);
  for (int xo = 0; xo < out_w; ++xo) {
    int xi = flip ? (out_w - 1 - xo) : xo;
    double xs = (crop_x + xi + 0.5) / resize - 0.5;
    int x0 = (int)std::floor(xs);
    xlx[xo] = float(xs - x0);
    xo0[xo] = (x0 < 0 ? 0 : (x0 >= sw ? sw - 1 : x0)) * 3;
    xo1[xo] = (x0 + 1 < 0 ? 0 : (x0 + 1 >= sw ? sw - 1 : x0 + 1)) * 3;
  }
  for (int yo = 0; yo < out_h; ++yo) {
    // resized coords -> source coords (align_corners=false bilinear)
    double ys = (crop_y + yo + 0.5) / resize - 0.5;
    int y0 = (int)std::floor(ys);
    float ly = float(ys - y0);
    const uint8_t* row0 =
        src + size_t(y0 < 0 ? 0 : (y0 >= sh ? sh - 1 : y0)) * sw * 3;
    const uint8_t* row1 =
        src + size_t(y0 + 1 < 0 ? 0 : (y0 + 1 >= sh ? sh - 1 : y0 + 1)) *
                  sw * 3;
    OutT* orow = out + size_t(yo) * out_w * 3;
    float omly = 1.0f - ly;
    for (int xo = 0; xo < out_w; ++xo) {
      float lx = xlx[xo];
      float omlx = 1.0f - lx;
      float w00 = omly * omlx, w01 = omly * lx;
      float w10 = ly * omlx, w11 = ly * lx;
      const uint8_t* p00 = row0 + xo0[xo];
      const uint8_t* p01 = row0 + xo1[xo];
      const uint8_t* p10 = row1 + xo0[xo];
      const uint8_t* p11 = row1 + xo1[xo];
      for (int c = 0; c < 3; ++c) {
        float v = w00 * p00[c] + w01 * p01[c] + w10 * p10[c] + w11 * p11[c];
        orow[xo * 3 + c] = emit(v, c);
      }
    }
  }
}

// (x - mean) / std into float32 HWC output.
void sample_one(const uint8_t* src, int sh, int sw, double resize, int crop_x,
                int crop_y, int out_h, int out_w, int flip, const float* mean,
                const float* inv_std, float* out) {
  sample_core(src, sh, sw, resize, crop_x, crop_y, out_h, out_w, flip, out,
              [&](float v, int c) { return (v - mean[c]) * inv_std[c]; });
}

// RAW uint8 output (no normalize): the device_normalize serving path ships
// raw pixels and applies (x - mean)/std on the accelerator, so h2d moves
// 1/4 the bytes of f32. Round-to-nearest matches cv2's uint8 INTER_LINEAR
// within 1 LSB.
void sample_one_u8(const uint8_t* src, int sh, int sw, double resize,
                   int crop_x, int crop_y, int out_h, int out_w, int flip,
                   uint8_t* out) {
  sample_core(src, sh, sw, resize, crop_x, crop_y, out_h, out_w, flip, out,
              [](float v, int) {
                v += 0.5f;
                return (uint8_t)(v < 0.0f ? 0 : (v > 255.0f ? 255 : (int)v));
              });
}

}  // namespace

extern "C" int grd4d_load_images(const char** paths, int n, double resize,
                                 int crop_x, int crop_y, int out_h, int out_w,
                                 int flip, const float* mean, const float* std_,
                                 float* out, int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};

  auto worker = [&]() {
    std::vector<uint8_t> pixels;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      // an exception escaping a std::thread entry calls std::terminate
      // and takes the whole Python process with it — count the image as
      // failed instead (std::bad_alloc from a corrupt header's resize,
      // or anything else)
      try {
        int sw = 0, sh = 0;
        if (!decode_jpeg(paths[i], &pixels, &sw, &sh)) {
          failed.fetch_add(1);
          continue;
        }
        sample_one(pixels.data(), sh, sw, resize, crop_x, crop_y, out_h,
                   out_w, flip, mean, inv_std,
                   out + size_t(i) * out_h * out_w * 3);
      } catch (...) {
        failed.fetch_add(1);
      }
    }
  };

  int nt = num_threads < 1 ? 1 : num_threads;
  if (nt > n) nt = n;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return failed.load();
}

extern "C" int grd4d_load_images_u8(const char** paths, int n, double resize,
                                    int crop_x, int crop_y, int out_h,
                                    int out_w, int flip, uint8_t* out,
                                    int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failed(0);

  auto worker = [&]() {
    std::vector<uint8_t> pixels;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      try {
        int sw = 0, sh = 0;
        if (!decode_jpeg(paths[i], &pixels, &sw, &sh)) {
          failed.fetch_add(1);
          continue;
        }
        sample_one_u8(pixels.data(), sh, sw, resize, crop_x, crop_y, out_h,
                      out_w, flip, out + size_t(i) * out_h * out_w * 3);
      } catch (...) {
        failed.fetch_add(1);
      }
    }
  };

  int nt = num_threads < 1 ? 1 : num_threads;
  if (nt > n) nt = n;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return failed.load();
}
