// Native EuRoC image loader: libpng grayscale decode + threaded prefetch
// ring. Native equivalent of the reference's dataloader IO path
// (ref: /root/reference/gmmloc/src/utils/dataloader.cpp:53-116 — OpenCV
// imread per frame) and the per-frame ephemeral decode threads
// (ref: gmmloc.cpp:241-249). Exposed to Python via ctypes
// (gmmloc/pipeline/dataloader.py); the index/CSV parse stays on the
// host in Python where it is trivial.
//
// Build: make -C native  (produces libgmmloc_io.so)

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

// Decode one PNG to 8-bit grayscale. Returns 0 on success.
int decode_png_gray_impl(const char* path, uint8_t* out, int64_t cap,
                         int32_t* out_w, int32_t* out_h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return -2;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return -3;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -4;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    // ITU-R BT.709 luma coefficients (error action: silently convert)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  if (static_cast<int64_t>(w) * h > cap) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -5;
  }
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out + y * w;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *out_w = static_cast<int32_t>(w);
  *out_h = static_cast<int32_t>(h);
  return 0;
}

// Threaded prefetch ring over a fixed frame list (stereo pairs). Workers
// claim frame indices in order and decode into the slot idx % capacity;
// the consumer takes frames strictly in order (the tracking loop is
// sequential). Slot s serves frames s, s+capacity, s+2*capacity, ... in
// strict turn order (slot_turn), so two workers can never occupy the same
// slot buffer concurrently. Replaces the Python-thread prefetcher for the
// image path.
struct Prefetcher {
  std::vector<std::string> left, right;
  int64_t slot_cap;  // bytes per image slot
  int capacity;
  std::vector<uint8_t> buf_l, buf_r;
  std::vector<int32_t> dims;      // (capacity, 4): wl, hl, wr, hr
  std::vector<int> status;        // per-slot: -1 not ready, 0 ok, >0 error
  std::vector<int64_t> slot_turn;   // next frame allowed to use the slot
  std::atomic<int64_t> next_claim{0};
  int64_t next_consume = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  Prefetcher(std::vector<std::string> l, std::vector<std::string> r,
             int64_t cap_bytes, int capacity_, int n_threads)
      : left(std::move(l)),
        right(std::move(r)),
        slot_cap(cap_bytes),
        capacity(capacity_),
        buf_l(static_cast<size_t>(capacity_) * cap_bytes),
        buf_r(static_cast<size_t>(capacity_) * cap_bytes),
        dims(static_cast<size_t>(capacity_) * 4),
        status(capacity_, -1),
        slot_turn(capacity_) {
    for (int i = 0; i < capacity_; ++i) slot_turn[i] = i;
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { this->work(); });
  }

  ~Prefetcher() {
    stop.store(true);
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) t.join();
  }

  void work() {
    const int64_t n = static_cast<int64_t>(left.size());
    while (!stop.load()) {
      int64_t f = next_claim.fetch_add(1);
      if (f >= n) return;
      int slot = static_cast<int>(f % capacity);
      {
        // wait until it is this frame's turn on the slot (previous
        // occupant decoded AND consumed)
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || slot_turn[slot] == f; });
        if (stop.load()) return;
      }
      int32_t wl = 0, hl = 0, wr = 0, hr = 0;
      int rc1 = decode_png_gray_impl(left[f].c_str(),
                                     buf_l.data() + slot * slot_cap,
                                     slot_cap, &wl, &hl);
      int rc2 = decode_png_gray_impl(right[f].c_str(),
                                     buf_r.data() + slot * slot_cap,
                                     slot_cap, &wr, &hr);
      {
        std::lock_guard<std::mutex> lk(mu);
        dims[slot * 4 + 0] = wl;
        dims[slot * 4 + 1] = hl;
        dims[slot * 4 + 2] = wr;
        dims[slot * 4 + 3] = hr;
        status[slot] = (rc1 == 0 && rc2 == 0) ? 0 : 1;
      }
      cv_ready.notify_all();
    }
  }

  // Blocking in-order take. Returns 0 ok, >0 decode error, -1 exhausted.
  int take(uint8_t* out_l, uint8_t* out_r, int32_t* whwh) {
    const int64_t n = static_cast<int64_t>(left.size());
    if (next_consume >= n) return -1;
    int64_t f = next_consume++;
    int slot = static_cast<int>(f % capacity);
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [&] {
      return stop.load() || (slot_turn[slot] == f && status[slot] != -1);
    });
    if (stop.load()) return -2;
    int rc = status[slot];
    std::memcpy(whwh, dims.data() + slot * 4, 4 * sizeof(int32_t));
    if (rc == 0) {
      int64_t nl = static_cast<int64_t>(whwh[0]) * whwh[1];
      int64_t nr = static_cast<int64_t>(whwh[2]) * whwh[3];
      std::memcpy(out_l, buf_l.data() + slot * slot_cap, nl);
      std::memcpy(out_r, buf_r.data() + slot * slot_cap, nr);
    }
    status[slot] = -1;
    slot_turn[slot] = f + capacity;
    lk.unlock();
    cv_free.notify_all();
    return rc;
  }
};

std::vector<std::string> split_lines(const char* joined) {
  std::vector<std::string> out;
  const char* p = joined;
  while (*p) {
    const char* nl = std::strchr(p, '\n');
    if (!nl) {
      out.emplace_back(p);
      break;
    }
    out.emplace_back(p, nl - p);
    p = nl + 1;
  }
  return out;
}

}  // namespace

extern "C" {

int euroc_decode_png_gray(const char* path, uint8_t* out, int64_t cap,
                          int32_t* w, int32_t* h) {
  return decode_png_gray_impl(path, out, cap, w, h);
}

void* euroc_prefetcher_create(const char* left_joined,
                              const char* right_joined, int64_t slot_cap,
                              int capacity, int n_threads) {
  auto l = split_lines(left_joined);
  auto r = split_lines(right_joined);
  if (l.size() != r.size() || l.empty() || capacity < 1 || n_threads < 1)
    return nullptr;
  return new Prefetcher(std::move(l), std::move(r), slot_cap, capacity,
                        n_threads);
}

int euroc_prefetcher_take(void* handle, uint8_t* out_l, uint8_t* out_r,
                          int32_t* whwh) {
  return static_cast<Prefetcher*>(handle)->take(out_l, out_r, whwh);
}

void euroc_prefetcher_destroy(void* handle) {
  delete static_cast<Prefetcher*>(handle);
}

}  // extern "C"
