// Native PNG decode/encode + worker thread pool for batched folder mode.
//
// Replacement for the reference's image-I/O layer:
//   - stb_image / stb_image_write PNG codecs (VkResample.cpp:1362, 1754)
//   - the per-thread std::thread decode workers that exist "to speed up
//     png reads" (VkResample.cpp:1958-1969; README.md:53)
// Built on the system libpng/zlib instead of vendored single-header
// codecs; exposed to Python via a plain C ABI consumed with ctypes.
//
// All decodes force 3-channel RGB output (the reference passes
// req_comp=3 to stbi_load, VkResample.cpp:1362) — grayscale expands,
// alpha strips, 16-bit narrows.
//
// Build: make -C vkresample_tpu/native  (or io/png.py builds lazily).

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// single-image decode: returns malloc'd RGB8 buffer (caller frees via
// vkr_free), fills width/height. Returns nullptr on failure.
// ---------------------------------------------------------------------
unsigned char* vkr_png_decode(const char* path, int* width, int* height) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;

  png_byte sig[8];
  if (fread(sig, 1, 8, fp) != 8 || png_sig_cmp(sig, 0, 8)) {
    fclose(fp);
    return nullptr;
  }

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return nullptr;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    fclose(fp);
    return nullptr;
  }

  // volatile: assigned between setjmp and longjmp, read in the handler —
  // without it the handler may see a stale value (UB) and leak/free garbage
  unsigned char* volatile out = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    free(out);
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return nullptr;
  }

  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const png_uint_32 w = png_get_image_width(png, info);
  const png_uint_32 h = png_get_image_height(png, info);
  const int color = png_get_color_type(png, info);
  const int depth = png_get_bit_depth(png, info);

  // normalize every input to 8-bit RGB
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  // strip alpha down to RGB (req_comp=3 semantics)
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  const int passes = png_set_interlace_handling(png);
  png_read_update_info(png, info);

  const size_t stride = (size_t)w * 3;
  out = (unsigned char*)malloc(stride * h);
  if (!out) longjmp(png_jmpbuf(png), 1);
  for (int p = 0; p < passes; p++)
    for (png_uint_32 y = 0; y < h; y++)
      png_read_row(png, out + y * stride, nullptr);
  png_read_end(png, nullptr);

  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  *width = (int)w;
  *height = (int)h;
  return out;
}

// ---------------------------------------------------------------------
// single-image encode: RGB8 buffer -> PNG file.  Returns 0 on success.
// compression_level: 0-9 (stb_image_write used zlib default ~8; we take
// the level as a knob — folder mode wants fast encodes).
// ---------------------------------------------------------------------
int vkr_png_encode(const char* path, const unsigned char* rgb, int width,
                   int height, int compression_level) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;

  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(fp);
    return -2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return -3;
  }

  png_init_io(png, fp);
  png_set_compression_level(png, compression_level);
  // speed-oriented filter choice for synthetic upscaler output
  png_set_filter(png, 0, PNG_FILTER_SUB);
  png_set_IHDR(png, info, width, height, 8, PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);

  const size_t stride = (size_t)width * 3;
  for (int y = 0; y < height; y++)
    png_write_row(png, (png_const_bytep)(rgb + (size_t)y * stride));
  png_write_end(png, info);

  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
}

void vkr_free(void* p) { free(p); }

// ---------------------------------------------------------------------
// planar encode: channels as separate planes (r, g, b each w*h bytes).
// The device pipeline produces planar output (like the reference GPU
// buffers, VkResample.cpp:1437); interleaving happens here during row
// encoding instead of a host-side transpose.
// ---------------------------------------------------------------------
int vkr_png_encode_planar(const char* path, const unsigned char* r,
                          const unsigned char* g, const unsigned char* b,
                          int width, int height, int compression_level) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;

  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(fp);
    return -2;
  }
  std::vector<unsigned char> row((size_t)width * 3);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return -3;
  }

  png_init_io(png, fp);
  png_set_compression_level(png, compression_level);
  png_set_filter(png, 0, PNG_FILTER_SUB);
  png_set_IHDR(png, info, width, height, 8, PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);

  for (int y = 0; y < height; y++) {
    const size_t off = (size_t)y * width;
    for (int x = 0; x < width; x++) {
      row[3 * x + 0] = r[off + x];
      row[3 * x + 1] = g[off + x];
      row[3 * x + 2] = b[off + x];
    }
    png_write_row(png, row.data());
  }
  png_write_end(png, info);

  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------
// parity-planar encode: the device pipeline's per-parity CAS emits even
// rows and odd rows as two separate (3, H/2, W) uint8 plane stacks (no
// device-side row weave — see ops/cas.py cas_parity_planes).  Row
// pointers are arbitrary in libpng, so the
// interleave is free here: row y reads from plane stack (y & 1).
// ---------------------------------------------------------------------
int vkr_png_encode_planar_parity(const char* path, const unsigned char* e,
                                 const unsigned char* d, int width,
                                 int height, int compression_level) {
  if (height % 2) return -4;
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;

  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(fp);
    return -2;
  }
  std::vector<unsigned char> row((size_t)width * 3);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return -3;
  }

  png_init_io(png, fp);
  png_set_compression_level(png, compression_level);
  png_set_filter(png, 0, PNG_FILTER_SUB);
  png_set_IHDR(png, info, width, height, 8, PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);

  const size_t plane = (size_t)(height / 2) * width;
  for (int y = 0; y < height; y++) {
    const unsigned char* src = (y & 1) ? d : e;
    const size_t off = (size_t)(y >> 1) * width;
    for (int x = 0; x < width; x++) {
      row[3 * x + 0] = src[off + x];
      row[3 * x + 1] = src[plane + off + x];
      row[3 * x + 2] = src[2 * plane + off + x];
    }
    png_write_row(png, row.data());
  }
  png_write_end(png, info);

  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------
// quad-parity encode: the quad pipeline splits BOTH axes by parity —
// four (3, H/2, W/2) uint8 plane stacks (p[row parity][col parity]).
// The row loop assembles each output row from two plane stacks.
// ---------------------------------------------------------------------
int vkr_png_encode_planar_parity4(const char* path, const unsigned char* p00,
                                  const unsigned char* p01,
                                  const unsigned char* p10,
                                  const unsigned char* p11, int width,
                                  int height, int compression_level) {
  if (height % 2 || width % 2) return -4;
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;

  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(fp);
    return -2;
  }
  std::vector<unsigned char> row((size_t)width * 3);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return -3;
  }

  png_init_io(png, fp);
  png_set_compression_level(png, compression_level);
  png_set_filter(png, 0, PNG_FILTER_SUB);
  png_set_IHDR(png, info, width, height, 8, PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);

  const int wh = width / 2;
  const size_t plane = (size_t)(height / 2) * wh;
  for (int y = 0; y < height; y++) {
    const unsigned char* even_cols = (y & 1) ? p10 : p00;
    const unsigned char* odd_cols = (y & 1) ? p11 : p01;
    const size_t off = (size_t)(y >> 1) * wh;
    for (int x = 0; x < wh; x++) {
      for (int c = 0; c < 3; c++) {
        row[3 * (2 * x) + c] = even_cols[c * plane + off + x];
        row[3 * (2 * x + 1) + c] = odd_cols[c * plane + off + x];
      }
    }
    png_write_row(png, row.data());
  }
  png_write_end(png, info);

  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------
// grid-parity encode (u >= 2 generic): u*u plane stacks, row-major
// p[ry][rx], each (3, H/u, W/u) uint8 — output pixel (u*t+ry, u*s+rx)
// lives at plane (ry, rx) index (t, s).  The u^2-phase analog of the
// quad encoder above; the u-generic staged pipeline's native layout.
// ---------------------------------------------------------------------
int vkr_png_encode_planar_grid(const char* path,
                               const unsigned char* const* planes, int u,
                               int width, int height,
                               int compression_level) {
  if (u < 2 || height % u || width % u) return -4;
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;

  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(fp);
    return -2;
  }
  std::vector<unsigned char> row((size_t)width * 3);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return -3;
  }

  png_init_io(png, fp);
  png_set_compression_level(png, compression_level);
  png_set_filter(png, 0, PNG_FILTER_SUB);
  png_set_IHDR(png, info, width, height, 8, PNG_COLOR_TYPE_RGB,
               PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
               PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);

  const int ws = width / u;
  const size_t plane = (size_t)(height / u) * ws;
  for (int y = 0; y < height; y++) {
    const unsigned char* const* prow = planes + (size_t)(y % u) * u;
    const size_t off = (size_t)(y / u) * ws;
    for (int x = 0; x < ws; x++) {
      for (int rx = 0; rx < u; rx++) {
        const unsigned char* src = prow[rx] + off + x;
        for (int c = 0; c < 3; c++)
          row[3 * ((size_t)u * x + rx) + c] = src[c * plane];
      }
    }
    png_write_row(png, row.data());
  }
  png_write_end(png, info);

  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------
// worker pool: parallel decode/encode of file batches.
// Replaces the reference's one-OS-thread-per-worker design
// (VkResample.cpp:1958-1969) with a reusable pool.
// ---------------------------------------------------------------------
namespace {

class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    for (int i = 0; i < n; i++)
      threads_.emplace_back([this] { run(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  void submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      q_.push(std::move(f));
    }
    cv_.notify_one();
  }
  void wait_idle() {
    std::unique_lock<std::mutex> lk(mu_);
    idle_cv_.wait(lk, [this] { return q_.empty() && active_ == 0; });
  }

 private:
  void run() {
    for (;;) {
      std::function<void()> f;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        f = std::move(q_.front());
        q_.pop();
        active_++;
      }
      f();
      {
        std::lock_guard<std::mutex> lk(mu_);
        active_--;
        if (q_.empty() && active_ == 0) idle_cv_.notify_all();
      }
    }
  }
  std::mutex mu_;
  std::condition_variable cv_, idle_cv_;
  std::queue<std::function<void()>> q_;
  std::vector<std::thread> threads_;
  int active_ = 0;
  bool stop_;
};

}  // namespace

void* vkr_pool_create(int num_threads) {
  if (num_threads < 1) num_threads = 1;
  return new Pool(num_threads);
}

void vkr_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Decode a batch of same-sized images into one contiguous (n, h, w, 3)
// uint8 buffer provided by the caller.  status[i]: 0 ok, <0 error
// (-1 open/decode failure, -2 size mismatch with (exp_w, exp_h)).
void vkr_pool_decode_batch(void* pool, const char** paths, int n,
                           unsigned char* out, int exp_w, int exp_h,
                           int* status) {
  Pool* p = static_cast<Pool*>(pool);
  const size_t frame = (size_t)exp_w * exp_h * 3;
  for (int i = 0; i < n; i++) {
    p->submit([=] {
      int w = 0, h = 0;
      unsigned char* buf = vkr_png_decode(paths[i], &w, &h);
      if (!buf) {
        status[i] = -1;
        return;
      }
      if (w != exp_w || h != exp_h) {
        free(buf);
        status[i] = -2;
        return;
      }
      memcpy(out + (size_t)i * frame, buf, frame);
      free(buf);
      status[i] = 0;
    });
  }
  p->wait_idle();
}

// Encode a batch from one contiguous (n, h, w, 3) uint8 buffer.
void vkr_pool_encode_batch(void* pool, const char** paths, int n,
                           const unsigned char* data, int w, int h,
                           int compression_level, int* status) {
  Pool* p = static_cast<Pool*>(pool);
  const size_t frame = (size_t)w * h * 3;
  for (int i = 0; i < n; i++) {
    p->submit([=] {
      status[i] =
          vkr_png_encode(paths[i], data + (size_t)i * frame, w, h,
                         compression_level);
    });
  }
  p->wait_idle();
}

// Encode a batch from one contiguous PLANAR (n, 3, h, w) uint8 buffer.
void vkr_pool_encode_batch_planar(void* pool, const char** paths, int n,
                                  const unsigned char* data, int w, int h,
                                  int compression_level, int* status) {
  Pool* p = static_cast<Pool*>(pool);
  const size_t plane = (size_t)w * h;
  for (int i = 0; i < n; i++) {
    p->submit([=] {
      const unsigned char* base = data + (size_t)i * 3 * plane;
      status[i] = vkr_png_encode_planar(paths[i], base, base + plane,
                                        base + 2 * plane, w, h,
                                        compression_level);
    });
  }
  p->wait_idle();
}

// Encode a batch from two contiguous parity-plane buffers, each
// (n, 3, h/2, w): e holds even output rows, d odd output rows.
void vkr_pool_encode_batch_planar_parity(void* pool, const char** paths,
                                         int n, const unsigned char* e,
                                         const unsigned char* d, int w,
                                         int h, int compression_level,
                                         int* status) {
  Pool* p = static_cast<Pool*>(pool);
  const size_t frame = (size_t)w * (h / 2) * 3;
  for (int i = 0; i < n; i++) {
    p->submit([=] {
      status[i] = vkr_png_encode_planar_parity(
          paths[i], e + (size_t)i * frame, d + (size_t)i * frame, w, h,
          compression_level);
    });
  }
  p->wait_idle();
}

// Encode a batch from four contiguous quad-parity buffers, each
// (n, 3, h/2, w/2): p[row parity][col parity].
void vkr_pool_encode_batch_planar_parity4(
    void* pool, const char** paths, int n, const unsigned char* p00,
    const unsigned char* p01, const unsigned char* p10,
    const unsigned char* p11, int w, int h, int compression_level,
    int* status) {
  Pool* p = static_cast<Pool*>(pool);
  const size_t frame = (size_t)(w / 2) * (h / 2) * 3;
  for (int i = 0; i < n; i++) {
    p->submit([=] {
      const size_t o = (size_t)i * frame;
      status[i] = vkr_png_encode_planar_parity4(
          paths[i], p00 + o, p01 + o, p10 + o, p11 + o, w, h,
          compression_level);
    });
  }
  p->wait_idle();
}

// Encode a batch from u*u contiguous grid-parity buffers (row-major
// (ry, rx)), each (n, 3, h/u, w/u).
void vkr_pool_encode_batch_planar_grid(void* pool, const char** paths,
                                       int n,
                                       const unsigned char* const* planes,
                                       int u, int w, int h,
                                       int compression_level, int* status) {
  Pool* p = static_cast<Pool*>(pool);
  const int nplanes = u * u;
  const size_t frame = (size_t)(w / u) * (h / u) * 3;
  // copy the pointer table: the ctypes caller's array may not outlive
  // the submit loop
  std::vector<const unsigned char*> base(planes, planes + nplanes);
  for (int i = 0; i < n; i++) {
    p->submit([=] {
      std::vector<const unsigned char*> ps(nplanes);
      for (int j = 0; j < nplanes; j++) ps[j] = base[j] + (size_t)i * frame;
      status[i] = vkr_png_encode_planar_grid(paths[i], ps.data(), u, w, h,
                                             compression_level);
    });
  }
  p->wait_idle();
}

}  // extern "C"
