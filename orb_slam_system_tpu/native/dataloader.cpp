// Native dataset loader: PNG/PGM/PPM grayscale decoding + threaded
// prefetching.
//
// The reference's image IO is OpenCV imread on the driver thread
// (Examples/Monocular/mono_tum.cc:73). For an accelerator pipeline the host must
// keep the device fed; this loader decodes and grayscale-converts frames on
// background threads with a bounded ring of prefetched images, so tracking
// never stalls on IO. Exposed as a C ABI consumed via ctypes
// (orb_slam_system_tpu/native/__init__.py).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC dataloader.cpp -o
//        libslamdata.so -lz -lpthread

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// Bound file-declared dimensions so a corrupt header cannot drive a
// multi-gigabyte allocation (256 MPix covers any SLAM dataset frame).
constexpr long kMaxDim = 1 << 20;
constexpr long kMaxPixels = 256L * 1024 * 1024;


namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<float> gray;  // [h*w], 0..255
  bool ok = false;
};

// ---------------------------------------------------------------------------
// PNM (P5/P6) decoding
// ---------------------------------------------------------------------------

bool decode_pnm(const std::vector<uint8_t>& data, Image* out, bool raw16) {
  size_t i = 0;
  auto skip_ws = [&]() {
    while (i < data.size()) {
      if (data[i] == '#') {
        while (i < data.size() && data[i] != '\n') i++;
      } else if (isspace(data[i])) {
        i++;
      } else {
        break;
      }
    }
  };
  auto read_int = [&]() -> long {
    skip_ws();
    long v = 0;
    while (i < data.size() && isdigit(data[i])) v = v * 10 + (data[i++] - '0');
    return v;
  };
  if (data.size() < 2 || data[0] != 'P') return false;
  char magic = data[1];
  i = 2;
  long w = read_int(), h = read_int(), maxval = read_int();
  if (w <= 0 || h <= 0 || maxval <= 0) return false;
  if (w > kMaxDim || h > kMaxDim || w * h > kMaxPixels) return false;
  i++;  // single whitespace after maxval
  out->w = (int)w;
  out->h = (int)h;
  out->gray.resize(w * h);
  const double scale = (maxval >= 256 && !raw16) ? 255.0 / maxval : 1.0;
  if (magic == '5') {
    if (maxval < 256) {
      if (i + w * h > data.size()) return false;
      for (long k = 0; k < w * h; k++) out->gray[k] = (float)data[i + k];
    } else {
      if (i + 2 * w * h > data.size()) return false;
      for (long k = 0; k < w * h; k++) {
        uint16_t v = (uint16_t)((data[i + 2 * k] << 8) | data[i + 2 * k + 1]);
        out->gray[k] = (float)(v * scale);
      }
    }
  } else if (magic == '6') {
    if (maxval >= 256 || i + 3 * w * h > data.size()) return false;
    for (long k = 0; k < w * h; k++) {
      const uint8_t* p = &data[i + 3 * k];
      out->gray[k] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
    }
  } else {
    return false;
  }
  out->ok = true;
  return true;
}

// ---------------------------------------------------------------------------
// PNG decoding (zlib inflate + per-row unfiltering), 8/16-bit gray/RGB/RGBA
// ---------------------------------------------------------------------------

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}

bool decode_png(const std::vector<uint8_t>& data, Image* out, bool raw16) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (data.size() < 8 || memcmp(data.data(), sig, 8) != 0) return false;
  size_t i = 8;
  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (i + 8 <= data.size()) {
    uint32_t len = be32(&data[i]);
    if (i + 12 + len > data.size()) break;
    const char* type = (const char*)&data[i + 4];
    const uint8_t* payload = &data[i + 8];
    if (!memcmp(type, "IHDR", 4)) {
      if (len < 13) return false;  // truncated IHDR: fields below read 13 bytes
      w = be32(payload);
      h = be32(payload + 4);
      bit_depth = payload[8];
      color_type = payload[9];
      interlace = payload[12];
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    i += 12 + len;
  }
  if (w <= 0 || h <= 0 || interlace != 0) return false;
  if (w > kMaxDim || h > kMaxDim || (long)w * h > kMaxPixels) return false;
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // rgb
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // rgba
    default: return false;        // palette unsupported
  }
  if (bit_depth != 8 && bit_depth != 16) return false;
  const int bpp = channels * bit_depth / 8;        // bytes per pixel
  const size_t stride = (size_t)w * bpp;
  std::vector<uint8_t> rawbuf((stride + 1) * h);
  uLongf raw_len = rawbuf.size();
  if (uncompress(rawbuf.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
    return false;
  // Unfilter rows.
  std::vector<uint8_t> img(stride * h);
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; y++) {
    const uint8_t* src = &rawbuf[(stride + 1) * y];
    uint8_t filter = src[0];
    src++;
    uint8_t* dst = &img[stride * y];
    for (size_t x = 0; x < stride; x++) {
      int a = x >= (size_t)bpp ? dst[x - bpp] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= (size_t)bpp) ? prev[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: {
          int p = a + b - c;
          int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          v += (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return false;
      }
      dst[x] = (uint8_t)v;
    }
    prev = dst;
  }
  // Convert to gray float.
  out->w = w;
  out->h = h;
  out->gray.resize((size_t)w * h);
  const int bytes_per_sample = bit_depth / 8;
  const double scale16 = raw16 ? 1.0 : 255.0 / 65535.0;
  for (int y = 0; y < h; y++) {
    const uint8_t* row = &img[stride * y];
    for (int x = 0; x < w; x++) {
      const uint8_t* p = row + (size_t)x * bpp;
      double v;
      auto sample = [&](int c) -> double {
        const uint8_t* q = p + c * bytes_per_sample;
        return bit_depth == 8 ? (double)q[0]
                              : (double)((q[0] << 8) | q[1]) * scale16;
      };
      if (channels <= 2) {
        v = sample(0);
      } else {
        v = 0.299 * sample(0) + 0.587 * sample(1) + 0.114 * sample(2);
      }
      out->gray[(size_t)y * w + x] = (float)v;
    }
  }
  out->ok = true;
  return true;
}

bool decode_file(const std::string& path, Image* out, bool raw16) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(n);
  size_t rd = fread(data.data(), 1, n, f);
  fclose(f);
  if ((long)rd != n) return false;
  if (n > 8 && data[0] == 137 && data[1] == 'P') return decode_png(data, out, raw16);
  if (n > 2 && data[0] == 'P') return decode_pnm(data, out, raw16);
  return false;
}

// ---------------------------------------------------------------------------
// Threaded prefetching loader
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> paths;
  bool raw16 = false;
  size_t next_submit = 0;
  size_t next_emit = 0;
  int depth;
  std::deque<std::pair<size_t, Image*>> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<size_t> claim{0};
  // Index the consumer is currently blocked on (SIZE_MAX = none). A
  // worker holding this index may push past the capacity gate: workers
  // claim an index BEFORE decoding, so with a slow consumer the ready
  // queue can fill with later indices while the needed one is stranded
  // in a capacity-blocked worker's hand -- consumer waits for the index,
  // workers wait for space, deadlock. (Found by the runbook stand-in
  // test: tracking at seconds/frame on cold compiles consumed slower
  // than 4 decode threads filled the ring.)
  size_t wanted = (size_t)-1;

  Loader(std::vector<std::string> p, int d, bool r)
      : paths(std::move(p)), raw16(r), depth(d) {
    int n_threads = std::min(4, std::max(1, d));
    for (int t = 0; t < n_threads; t++)
      workers.emplace_back([this]() { run(); });
  }

  void run() {
    while (!stop.load()) {
      size_t idx = claim.fetch_add(1);
      if (idx >= paths.size()) return;
      Image* im = new Image();
      decode_file(paths[idx], im, raw16);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&]() {
        return stop.load() || idx == wanted ||
               ready.size() < (size_t)depth + workers.size();
      });
      if (stop.load()) {
        delete im;
        return;
      }
      ready.emplace_back(idx, im);
      cv_ready.notify_all();
    }
  }

  // Blocking fetch of frame `idx` (frames arrive out of order from workers).
  Image* get(size_t idx) {
    std::unique_lock<std::mutex> lk(mu);
    wanted = idx;
    cv_space.notify_all();  // release a worker stranded holding `idx`
    while (!stop.load()) {
      for (auto it = ready.begin(); it != ready.end(); ++it) {
        if (it->first == idx) {
          Image* im = it->second;
          ready.erase(it);
          wanted = (size_t)-1;
          cv_space.notify_all();
          return im;
        }
      }
      cv_ready.wait(lk);
    }
    return nullptr;
  }

  ~Loader() {
    stop.store(true);
    cv_ready.notify_all();
    cv_space.notify_all();
    for (auto& t : workers) t.join();
    for (auto& kv : ready) delete kv.second;
  }
};

}  // namespace

extern "C" {

void* sd_create(const char** paths, int n, int prefetch_depth, int raw16) {
  std::vector<std::string> v(paths, paths + n);
  return new Loader(std::move(v), prefetch_depth, raw16 != 0);
}

// Fetch frame `idx` into out (caller-allocated, cap floats). Returns 0 on
// success, -1 decode failure, -2 buffer too small.
int sd_get(void* handle, long idx, float* out, long cap, int* w, int* h) {
  Loader* l = (Loader*)handle;
  Image* im = l->get(idx);
  if (!im) return -1;
  int rc = 0;
  if (!im->ok) {
    rc = -1;
  } else if ((long)im->gray.size() > cap) {
    rc = -2;
  } else {
    memcpy(out, im->gray.data(), im->gray.size() * sizeof(float));
    *w = im->w;
    *h = im->h;
  }
  delete im;
  return rc;
}

void sd_destroy(void* handle) { delete (Loader*)handle; }

// One-shot decode (no prefetching).
int sd_decode(const char* path, int raw16, float* out, long cap, int* w,
              int* h) {
  Image im;
  if (!decode_file(path, &im, raw16 != 0)) return -1;
  if ((long)im.gray.size() > cap) return -2;
  memcpy(out, im.gray.data(), im.gray.size() * sizeof(float));
  *w = im.w;
  *h = im.h;
  return 0;
}

}  // extern "C"
