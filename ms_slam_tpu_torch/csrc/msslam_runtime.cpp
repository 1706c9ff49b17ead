// Native host runtime of ms_slam_tpu_torch.
//
// Copied from csrc/msslam_runtime.cpp of the JAX package (same C interface,
// same code); the port builds and loads its own copy
// (ms_slam_tpu_torch/utils/native.py) so that it runs no file of that
// package.
//
// The reference system's CLI drivers decode and rectify (cv::imread +
// cv::remap, with precomputed rectification maps) inline on the tracking
// thread. Here that work runs in a prefetch pipeline: a worker-thread pool
// decodes (libpng/libjpeg) and rectifies frames into a bounded ring of
// preallocated buffers ahead of the Python tracking loop, so host I/O
// overlaps device compute. Also provides the VmRSS sampler the KITTI
// driver's memory report reads.
//
// Exposed via a plain C ABI for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// image decoding (grayscale u8)
// ---------------------------------------------------------------------------

bool decode_png_gray(const char* path, uint8_t* out, int out_w, int out_h) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  std::vector<uint8_t> row(png_get_rowbytes(png, info));
  const int copy_w = std::min<int>(out_w, (int)w);
  const int copy_h = std::min<int>(out_h, (int)h);
  for (int y = 0; y < (int)h; ++y) {
    png_read_row(png, row.data(), nullptr);
    if (y < copy_h) {
      std::memcpy(out + (size_t)y * out_w, row.data(), copy_w);
      if (copy_w < out_w)
        std::memset(out + (size_t)y * out_w + copy_w, 0, out_w - copy_w);
    }
  }
  for (int y = copy_h; y < out_h; ++y)
    std::memset(out + (size_t)y * out_w, 0, out_w);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
}

bool decode_jpeg_gray(const char* path, uint8_t* out, int out_w, int out_h) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width, h = cinfo.output_height;
  std::vector<uint8_t> row(w);
  const int copy_w = std::min(out_w, w);
  const int copy_h = std::min(out_h, h);
  JSAMPROW rp = row.data();
  for (int y = 0; y < h; ++y) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    if (y < copy_h) {
      std::memcpy(out + (size_t)y * out_w, row.data(), copy_w);
      if (copy_w < out_w)
        std::memset(out + (size_t)y * out_w + copy_w, 0, out_w - copy_w);
    }
  }
  for (int y = copy_h; y < out_h; ++y)
    std::memset(out + (size_t)y * out_w, 0, out_w);
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return true;
}

bool decode_gray(const char* path, uint8_t* out, int w, int h) {
  const char* dot = strrchr(path, '.');
  if (dot && (!strcmp(dot, ".jpg") || !strcmp(dot, ".jpeg")))
    return decode_jpeg_gray(path, out, w, h);
  return decode_png_gray(path, out, w, h);
}

// ---------------------------------------------------------------------------
// bilinear remap (stereo rectification, ref cv::remap usage)
// ---------------------------------------------------------------------------

void remap_bilinear(const uint8_t* src, int w, int h, const float* map_x,
                    const float* map_y, uint8_t* dst) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const size_t i = (size_t)y * w + x;
      const float fx = map_x[i], fy = map_y[i];
      int x0 = (int)fx, y0 = (int)fy;
      if (fx < 0 || fy < 0 || x0 >= w - 1 || y0 >= h - 1) {
        dst[i] = 0;
        continue;
      }
      const float ax = fx - x0, ay = fy - y0;
      const uint8_t* p = src + (size_t)y0 * w + x0;
      const float v = (1 - ay) * ((1 - ax) * p[0] + ax * p[1]) +
                      ay * ((1 - ax) * p[w] + ax * p[w + 1]);
      dst[i] = (uint8_t)(v + 0.5f);
    }
  }
}

// ---------------------------------------------------------------------------
// prefetch pipeline
// ---------------------------------------------------------------------------

struct Pipeline {
  int width = 0, height = 0, n_frames = 0, depth = 0;
  bool stereo = false;
  std::vector<std::string> paths_l, paths_r;
  std::vector<float> rect_maps;  // 4*w*h (xl,yl,xr,yr) or empty
  std::vector<std::vector<uint8_t>> slots;  // depth * (1|2) * w*h
  std::vector<std::atomic<int>> ready;      // per slot: frame idx or -1
  std::atomic<int> next_submit{0};
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<bool> stop{false};
  int next_consume = 0;

  void worker() {
    std::vector<uint8_t> tmp((size_t)width * height);
    for (;;) {
      int idx = next_submit.fetch_add(1);
      if (idx >= n_frames || stop.load()) return;
      const int slot = idx % depth;
      {
        // The slot is frame idx's only once frame idx - depth has been
        // consumed: a worker holding idx + depth must not take it first,
        // or the consumer waits for idx in a slot that never gets it.
        // next_consume is written under mu, so it is read under mu.
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          return stop.load() ||
                 (ready[slot].load() == -1 && idx < next_consume + depth);
        });
        if (stop.load()) return;
        ready[slot].store(-2);  // claimed
      }
      uint8_t* buf_l = slots[slot].data();
      uint8_t* buf_r = stereo ? buf_l + (size_t)width * height : nullptr;
      const bool rect = !rect_maps.empty();
      uint8_t* dst_l = rect ? tmp.data() : buf_l;
      decode_gray(paths_l[idx].c_str(), dst_l, width, height);
      if (rect) {
        remap_bilinear(tmp.data(), width, height, rect_maps.data(),
                       rect_maps.data() + (size_t)width * height, buf_l);
      }
      if (stereo) {
        uint8_t* dst_r = rect ? tmp.data() : buf_r;
        decode_gray(paths_r[idx].c_str(), dst_r, width, height);
        if (rect) {
          remap_bilinear(tmp.data(), width, height,
                         rect_maps.data() + 2 * (size_t)width * height,
                         rect_maps.data() + 3 * (size_t)width * height, buf_r);
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready[slot].store(idx);
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* msslam_pipeline_create(const char** paths_l, const char** paths_r,
                             int n_frames, int width, int height, int depth,
                             int n_workers, const float* rect_maps) {
  auto* p = new Pipeline();
  p->width = width;
  p->height = height;
  p->n_frames = n_frames;
  p->depth = depth;
  p->stereo = paths_r != nullptr;
  for (int i = 0; i < n_frames; ++i) {
    p->paths_l.emplace_back(paths_l[i]);
    if (p->stereo) p->paths_r.emplace_back(paths_r[i]);
  }
  if (rect_maps)
    p->rect_maps.assign(rect_maps, rect_maps + 4 * (size_t)width * height);
  const size_t frame_bytes = (size_t)width * height * (p->stereo ? 2 : 1);
  p->slots.resize(depth);
  for (auto& s : p->slots) s.resize(frame_bytes);
  p->ready = std::vector<std::atomic<int>>(depth);
  for (auto& r : p->ready) r.store(-1);
  for (int i = 0; i < n_workers; ++i)
    p->workers.emplace_back(&Pipeline::worker, p);
  return p;
}

// Blocks until frame `idx` (must be consumed in order) is decoded; copies it
// into out_l/out_r. Returns 0 on success.
int msslam_pipeline_next(void* handle, uint8_t* out_l, uint8_t* out_r) {
  auto* p = static_cast<Pipeline*>(handle);
  const int idx = p->next_consume;
  if (idx >= p->n_frames) return 1;
  const int slot = idx % p->depth;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_ready.wait(lk, [&] { return p->ready[slot].load() == idx; });
  }
  const size_t n = (size_t)p->width * p->height;
  std::memcpy(out_l, p->slots[slot].data(), n);
  if (p->stereo && out_r) std::memcpy(out_r, p->slots[slot].data() + n, n);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->ready[slot].store(-1);
    p->next_consume++;
  }
  p->cv_free.notify_all();
  return 0;
}

void msslam_pipeline_destroy(void* handle) {
  auto* p = static_cast<Pipeline*>(handle);
  p->stop.store(true);
  p->cv_free.notify_all();
  p->cv_ready.notify_all();
  for (auto& w : p->workers) w.join();
  delete p;
}

// Single-image decode (for tools/tests).
int msslam_decode_gray(const char* path, uint8_t* out, int w, int h) {
  return decode_gray(path, out, w, h) ? 0 : 1;
}

void msslam_remap(const uint8_t* src, int w, int h, const float* map_x,
                  const float* map_y, uint8_t* dst) {
  remap_bilinear(src, w, h, map_x, map_y, dst);
}

// VmRSS in kB (the reference driver's mem_usage).
long msslam_vmrss_kb() {
  FILE* f = fopen("/proc/self/status", "r");
  if (!f) return -1;
  char line[256];
  long kb = -1;
  while (fgets(line, sizeof line, f)) {
    if (!strncmp(line, "VmRSS:", 6)) {
      sscanf(line + 6, "%ld", &kb);
      break;
    }
  }
  fclose(f);
  return kb;
}

}  // extern "C"
