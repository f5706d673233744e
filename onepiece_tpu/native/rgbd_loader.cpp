// Native RGB-D dataset loader: libpng decode + threaded prefetch ring.
//
// Host-side counterpart of the reference's frame-loading loop
// (ref: example/DenseFusion/DenseFusion.cpp:41-47 cv::imread per frame,
// src/Tool/IO.cpp:59-108 ReadImageSequence) — the reference decodes PNGs
// synchronously on the render thread with OpenCV; here a worker pool
// decodes ahead of the consumer into a ring buffer so the host never
// stalls the device pipeline on IO. Decoding is libpng directly (no
// OpenCV anywhere in this framework).
//
// Formats (TUM RGB-D on-disk conventions):
//   depth: 16-bit grayscale PNG, big-endian per PNG spec -> swapped to
//          host little-endian on decode
//   rgb:   8-bit RGB (or grayscale) PNG
//
// Exposed C API (ctypes, see onepiece_tpu/io/native_loader.py):
//   png_probe / png_decode_u16 / png_decode_u8  — single-image decode
//   loader_create / loader_next / loader_destroy — prefetching iterator

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct PngImage {
  int w = 0, h = 0, channels = 0, bitdepth = 0;
  std::vector<uint8_t> data;  // row-major, native endian for 16-bit
};

// Decode a PNG from disk. Grayscale 16-bit stays 16-bit (endian-swapped);
// everything 8-bit is expanded to the file's channel count (palette ->
// rgb, <8-bit gray -> 8-bit). Returns 0 on success.
int decode_png(const char* path, PngImage* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return -2;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -3;
  }
  if (setjmp(png_jmpbuf(png))) {  // libpng error handling
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -4;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bitdepth, color;
  png_get_IHDR(png, info, &w, &h, &bitdepth, &color, nullptr, nullptr, nullptr);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bitdepth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bitdepth == 16) png_set_swap(png);  // PNG is big-endian; host is LE
  png_read_update_info(png, info);

  png_get_IHDR(png, info, &w, &h, &bitdepth, &color, nullptr, nullptr, nullptr);
  int channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);

  out->w = static_cast<int>(w);
  out->h = static_cast<int>(h);
  out->channels = channels;
  out->bitdepth = bitdepth;
  out->data.resize(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 r = 0; r < h; ++r) rows[r] = out->data.data() + r * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

struct Frame {
  std::vector<uint16_t> depth;
  std::vector<uint8_t> rgb;
  int index = -1;
  int status = 0;  // 0 ok, <0 decode error
};

struct Loader {
  std::vector<std::string> depth_paths;
  std::vector<std::string> rgb_paths;  // may be empty (depth-only)
  int w = 0, h = 0, rgb_channels = 0;
  int n = 0;

  std::vector<Frame> ring;
  std::vector<int> slot_state;  // 0 empty, 1 decoding, 2 ready, 3 consumed
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_free;
  std::atomic<int> next_to_decode{0};
  int next_to_consume = 0;
  bool stop = false;
  std::vector<std::thread> workers;

  int ring_size() const { return static_cast<int>(ring.size()); }

  void worker() {
    for (;;) {
      int idx = next_to_decode.fetch_add(1);
      if (idx >= n) return;
      int slot = idx % ring_size();
      {
        // wait until the slot's previous occupant (idx - ring_size) has
        // been consumed
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] {
          return stop || next_to_consume > idx - ring_size();
        });
        if (stop) return;
        slot_state[slot] = 1;
      }
      Frame& f = ring[slot];
      f.index = idx;
      f.status = 0;
      PngImage d;
      int rc = decode_png(depth_paths[idx].c_str(), &d);
      if (rc != 0 || d.w != w || d.h != h || d.bitdepth != 16) {
        f.status = rc != 0 ? rc : -10;
      } else {
        std::memcpy(f.depth.data(), d.data.data(),
                    sizeof(uint16_t) * w * h);
      }
      if (!rgb_paths.empty() && f.status == 0) {
        PngImage c;
        rc = decode_png(rgb_paths[idx].c_str(), &c);
        if (rc != 0 || c.w != w || c.h != h || c.bitdepth != 8) {
          f.status = rc != 0 ? rc : -11;
        } else if (c.channels == rgb_channels) {
          std::memcpy(f.rgb.data(), c.data.data(),
                      static_cast<size_t>(w) * h * rgb_channels);
        } else if (c.channels == 3 && rgb_channels == 1) {
          // luma fold (matches ImageProcessing gray conversion weights)
          for (int i = 0; i < w * h; ++i) {
            const uint8_t* p = c.data.data() + 3 * i;
            f.rgb[i] = static_cast<uint8_t>(
                (299 * p[0] + 587 * p[1] + 114 * p[2]) / 1000);
          }
        } else if (c.channels == 1 && rgb_channels == 3) {
          for (int i = 0; i < w * h; ++i) {
            f.rgb[3 * i] = f.rgb[3 * i + 1] = f.rgb[3 * i + 2] = c.data[i];
          }
        } else if (c.channels == 4 && rgb_channels == 3) {
          for (int i = 0; i < w * h; ++i) {
            std::memcpy(&f.rgb[3 * i], &c.data[4 * i], 3);
          }
        } else {
          f.status = -12;
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        slot_state[slot] = 2;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int png_probe(const char* path, int* w, int* h, int* channels, int* bitdepth) {
  PngImage img;
  int rc = decode_png(path, &img);
  if (rc != 0) return rc;
  *w = img.w;
  *h = img.h;
  *channels = img.channels;
  *bitdepth = img.bitdepth;
  return 0;
}

int png_decode_u16(const char* path, uint16_t* out, int w, int h) {
  PngImage img;
  int rc = decode_png(path, &img);
  if (rc != 0) return rc;
  if (img.w != w || img.h != h || img.bitdepth != 16 || img.channels != 1)
    return -10;
  std::memcpy(out, img.data.data(), sizeof(uint16_t) * w * h);
  return 0;
}

int png_decode_u8(const char* path, uint8_t* out, int w, int h, int channels) {
  PngImage img;
  int rc = decode_png(path, &img);
  if (rc != 0) return rc;
  if (img.w != w || img.h != h || img.bitdepth != 8 ||
      img.channels != channels)
    return -10;
  std::memcpy(out, img.data.data(), static_cast<size_t>(w) * h * channels);
  return 0;
}

void* loader_create(const char** depth_paths, const char** rgb_paths, int n,
                    int w, int h, int rgb_channels, int n_threads, int ring) {
  auto* L = new Loader();
  L->n = n;
  L->w = w;
  L->h = h;
  L->rgb_channels = rgb_paths ? rgb_channels : 0;
  L->depth_paths.reserve(n);
  for (int i = 0; i < n; ++i) L->depth_paths.emplace_back(depth_paths[i]);
  if (rgb_paths) {
    L->rgb_paths.reserve(n);
    for (int i = 0; i < n; ++i) L->rgb_paths.emplace_back(rgb_paths[i]);
  }
  if (ring < 2) ring = 2;
  if (n_threads < 1) n_threads = 1;
  L->ring.resize(ring);
  L->slot_state.assign(ring, 0);
  for (auto& f : L->ring) {
    f.depth.resize(static_cast<size_t>(w) * h);
    if (rgb_paths) f.rgb.resize(static_cast<size_t>(w) * h * rgb_channels);
  }
  for (int t = 0; t < n_threads; ++t)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Blocks until the next frame (in sequence order) is decoded, copies it to
// the caller's buffers, and frees the ring slot. Returns the frame index,
// -1 at end of sequence, or the negative decode error of that frame.
int loader_next(void* handle, uint16_t* depth_out, uint8_t* rgb_out) {
  auto* L = static_cast<Loader*>(handle);
  if (L->next_to_consume >= L->n) return -1;
  int idx = L->next_to_consume;
  int slot = idx % L->ring_size();
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] {
      return L->slot_state[slot] == 2 && L->ring[slot].index == idx;
    });
  }
  Frame& f = L->ring[slot];
  int status = f.status;
  if (status == 0) {
    std::memcpy(depth_out, f.depth.data(),
                sizeof(uint16_t) * L->w * L->h);
    if (rgb_out && !L->rgb_paths.empty())
      std::memcpy(rgb_out, f.rgb.data(),
                  static_cast<size_t>(L->w) * L->h * L->rgb_channels);
  }
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->slot_state[slot] = 0;
    L->next_to_consume = idx + 1;
  }
  L->cv_free.notify_all();
  return status == 0 ? idx : status;
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
    L->next_to_consume = L->n + L->ring_size();  // unblock waiting workers
  }
  L->cv_free.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
