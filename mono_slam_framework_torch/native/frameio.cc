// Native frame IO: PNG/PGM decode + background prefetch ring.
//
// TPU-native twin of the reference application's C++ frame-acquisition path
// (src/main.cpp:122-128 grabs camera frames and gamma-corrects them with the
// GammaCorrector LUT, src/main.cpp:21-39). Offline dataset runs replace the
// Webots camera with on-disk PNG/PGM sequences (TUM/KITTI/EuRoC); this module
// keeps that acquisition path native: a C++ decoder (zlib inflate + PNG
// unfilter, PGM P5/P2) producing grayscale f32 [H,W] 0..255 frames, and a
// decode-ahead worker thread so the SLAM step never waits on disk or inflate.
//
// Grayscale conversion for color PNGs matches PIL's convert("L") rounding
// exactly: L = (19595 R + 38470 G + 7471 B + 32768) >> 16 (ITU-R 601-2).
// Unsupported encodings (palette, interlaced, 16-bit) return an error so the
// Python caller can fall back to PIL transparently.
//
// Exposed via ctypes (no pybind11 in this image): see native/frameio.py.

#include <zlib.h>

#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;       // not a PNG/PGM we handle
constexpr int kErrUnsupported = -3;  // valid PNG, encoding we don't decode
constexpr int kErrTooLarge = -4;     // exceeds caller's buffer
constexpr int kErrInflate = -5;

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  out.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(out.data(), 1, out.size(), f) : 0;
  std::fclose(f);
  return got == out.size();
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

// Decode an 8-bit non-interlaced gray/RGB/gray+alpha/RGBA PNG to grayscale
// f32. Returns kOk or an error code.
int decode_png(const std::vector<uint8_t>& buf, float* out, int* h, int* w,
               int max_h, int max_w) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || std::memcmp(buf.data(), sig, 8) != 0)
    return kErrFormat;

  size_t pos = 8;
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  bool saw_ihdr = false;

  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    if (pos + 12 + len > buf.size()) return kErrFormat;
    const uint8_t* type = &buf[pos + 4];
    const uint8_t* data = &buf[pos + 8];
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return kErrFormat;
      width = be32(data);
      height = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
      saw_ihdr = true;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (!saw_ihdr || idat.empty()) return kErrFormat;
  if (bit_depth != 8 || interlace != 0) return kErrUnsupported;

  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // RGB
    case 4: channels = 2; break;  // gray + alpha
    case 6: channels = 4; break;  // RGBA
    default: return kErrUnsupported;  // 3 = palette
  }
  if (int(height) > max_h || int(width) > max_w) return kErrTooLarge;

  const size_t stride = size_t(width) * channels;
  std::vector<uint8_t> raw(height * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return kErrInflate;

  // unfilter in place into `img`
  std::vector<uint8_t> img(height * stride);
  const int bpp = channels;  // bytes per pixel (8-bit)
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &img[y * stride];
    const uint8_t* up = y ? &img[(y - 1) * stride] : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (i >= size_t(bpp) ? dst[i - bpp] : 0));
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (up ? up[i] : 0));
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? dst[i - bpp] : 0;
          int b = up ? up[i] : 0;
          dst[i] = uint8_t(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? dst[i - bpp] : 0;
          int b = up ? up[i] : 0;
          int c = (up && i >= size_t(bpp)) ? up[i - bpp] : 0;
          dst[i] = uint8_t(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return kErrFormat;
    }
  }

  // grayscale conversion (PIL convert("L") rounding for color)
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t* row = &img[y * stride];
    float* orow = out + size_t(y) * width;
    if (channels == 1) {
      for (uint32_t x = 0; x < width; ++x) orow[x] = float(row[x]);
    } else if (channels == 2) {
      for (uint32_t x = 0; x < width; ++x) orow[x] = float(row[2 * x]);
    } else {
      for (uint32_t x = 0; x < width; ++x) {
        const uint8_t* px = row + size_t(x) * channels;
        uint32_t l =
            (19595u * px[0] + 38470u * px[1] + 7471u * px[2] + 0x8000u) >> 16;
        orow[x] = float(l);
      }
    }
  }
  *h = int(height);
  *w = int(width);
  return kOk;
}

// PGM: binary P5 and ascii P2, 8-bit (maxval <= 255).
int decode_pgm(const std::vector<uint8_t>& buf, float* out, int* h, int* w,
               int max_h, int max_w) {
  if (buf.size() < 2 || buf[0] != 'P' || (buf[1] != '5' && buf[1] != '2'))
    return kErrFormat;
  const bool binary = buf[1] == '5';
  size_t pos = 2;
  auto next_int = [&](long* v) -> bool {
    // skip whitespace and '#' comments
    while (pos < buf.size()) {
      if (buf[pos] == '#') {
        while (pos < buf.size() && buf[pos] != '\n') ++pos;
      } else if (std::isspace(buf[pos])) {
        ++pos;
      } else {
        break;
      }
    }
    long r = 0;
    bool any = false;
    while (pos < buf.size() && std::isdigit(buf[pos])) {
      r = r * 10 + (buf[pos] - '0');
      ++pos;
      any = true;
    }
    *v = r;
    return any;
  };
  long width, height, maxval;
  if (!next_int(&width) || !next_int(&height) || !next_int(&maxval))
    return kErrFormat;
  if (maxval <= 0 || maxval > 255) return kErrUnsupported;
  if (height > max_h || width > max_w) return kErrTooLarge;
  const size_t n = size_t(width) * height;
  if (binary) {
    ++pos;  // single whitespace after maxval
    if (pos + n > buf.size()) return kErrFormat;
    for (size_t i = 0; i < n; ++i) out[i] = float(buf[pos + i]);
  } else {
    for (size_t i = 0; i < n; ++i) {
      long v;
      if (!next_int(&v)) return kErrFormat;
      out[i] = float(v);
    }
  }
  *h = int(height);
  *w = int(width);
  return kOk;
}

int decode_path(const char* path, float* out, int* h, int* w, int max_h,
                int max_w, float gamma) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return kErrOpen;
  int rc = decode_png(buf, out, h, w, max_h, max_w);
  if (rc == kErrFormat) rc = decode_pgm(buf, out, h, w, max_h, max_w);
  if (rc != kOk) return rc;
  if (gamma > 0.0f && gamma != 1.0f) {
    // GammaCorrector LUT twin (src/main.cpp:21-39): u8 -> u8 table applied
    // to every pixel; values here are exact u8 levels, so the LUT is exact.
    float lut[256];
    for (int i = 0; i < 256; ++i)
      lut[i] = std::floor(std::pow(float(i) / 255.0f, gamma) * 255.0f + 0.5f);
    const size_t n = size_t(*h) * size_t(*w);
    for (size_t i = 0; i < n; ++i) out[i] = lut[int(out[i])];
  }
  return kOk;
}

// ---- background prefetch ring -------------------------------------------

struct Slot {
  std::vector<float> pix;
  int h = 0, w = 0, rc = kOk;
};

struct Prefetcher {
  std::vector<std::string> paths;
  int max_h, max_w;
  float gamma;
  size_t ring;
  std::vector<Slot> slots;
  size_t head = 0;  // next slot the worker fills
  size_t tail = 0;  // next slot the consumer reads
  std::mutex mu;
  std::condition_variable cv_fill, cv_drain;
  std::atomic<bool> stop{false};
  std::thread worker;

  void run() {
    for (size_t i = 0; i < paths.size() && !stop.load(); ++i) {
      Slot local;
      local.pix.resize(size_t(max_h) * max_w);
      local.rc = decode_path(paths[i].c_str(), local.pix.data(), &local.h,
                             &local.w, max_h, max_w, gamma);
      std::unique_lock<std::mutex> lk(mu);
      cv_fill.wait(lk, [&] { return stop.load() || head - tail < ring; });
      if (stop.load()) return;
      slots[head % ring] = std::move(local);
      ++head;
      cv_drain.notify_one();
    }
  }
};

}  // namespace

extern "C" {

int fio_decode(const char* path, float* out, int* h, int* w, int max_h,
               int max_w, float gamma) {
  return decode_path(path, out, h, w, max_h, max_w, gamma);
}

void* fio_prefetch_create(const char** paths, int n, int max_h, int max_w,
                          int ring, float gamma) {
  auto* p = new Prefetcher;
  p->paths.reserve(n);
  for (int i = 0; i < n; ++i) p->paths.emplace_back(paths[i]);
  p->max_h = max_h;
  p->max_w = max_w;
  p->gamma = gamma;
  p->ring = ring > 0 ? size_t(ring) : 4;
  p->slots.resize(p->ring);
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Blocks until the next decoded frame is available; copies it into `out`
// ([max_h*max_w] floats, row-major [h,w] valid region). Returns the decode
// rc (0 ok, <0 error for that frame), or -100 when the stream is exhausted.
int fio_prefetch_next(void* handle, float* out, int* h, int* w) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_drain.wait(lk, [&] {
    return p->head > p->tail || p->tail >= p->paths.size();
  });
  if (p->tail >= p->paths.size()) return -100;
  Slot& s = p->slots[p->tail % p->ring];
  int rc = s.rc;
  if (rc == kOk)
    std::memcpy(out, s.pix.data(), sizeof(float) * size_t(s.h) * s.w);
  *h = s.h;
  *w = s.w;
  ++p->tail;
  p->cv_fill.notify_one();
  return rc;
}

void fio_prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->cv_fill.notify_all();
    p->cv_drain.notify_all();
  }
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

}  // extern "C"
