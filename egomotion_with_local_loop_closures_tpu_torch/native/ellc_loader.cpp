// ELLC native frame loader (the PyTorch port's copy).
//
// A replacement for the reference's host-side video ingest
// (cv::VideoCapture + resize + BGR->gray in frame::frame,
// reference src/Frame.cpp:34-124 and src/main.cpp:147-166): a C++
// shared library that scans an image-sequence directory, decodes
// JPEG (libjpeg) / PGM / PPM frames on a background thread pool,
// converts to grayscale, resizes (bilinear, matching cv::resize's
// default INTER_LINEAR), and hands frames to Python strictly in order
// through a bounded queue — so decode overlaps device compute instead
// of serializing with it like the reference's in-loop decode.
//
// C ABI (consumed via ctypes in runtime/native_loader.py):
//   void* ellc_loader_open(const char* dir, int rows, int cols,
//                          int n_threads, int queue_cap);
//   int   ellc_loader_count(void* h);
//   int   ellc_loader_next(void* h, float* out);   // 1 ok, 0 end
//   void  ellc_loader_skip(void* h, int n);        // fast-forward
//   void  ellc_loader_close(void* h);

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <csetjmp>

namespace {

struct GrayImage {
  int rows = 0, cols = 0;
  std::vector<float> px;  // rows*cols, 0..255
  bool ok = false;
};

// ---------------------------------------------------------------- decoding

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

GrayImage decode_jpeg(const std::string& path) {
  GrayImage out;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return out;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;  // libjpeg does RGB->gray
  jpeg_start_decompress(&cinfo);
  out.rows = cinfo.output_height;
  out.cols = cinfo.output_width;
  out.px.resize((size_t)out.rows * out.cols);
  std::vector<JSAMPLE> row(out.cols);
  JSAMPROW rp = row.data();
  for (int y = 0; y < out.rows; ++y) {
    jpeg_read_scanlines(&cinfo, &rp, 1);
    float* dst = out.px.data() + (size_t)y * out.cols;
    for (int x = 0; x < out.cols; ++x) dst[x] = (float)row[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  out.ok = true;
  return out;
}

bool pnm_token(FILE* f, char* buf, int cap) {
  int c;
  do {
    c = fgetc(f);
    if (c == '#') {
      while (c != '\n' && c != EOF) c = fgetc(f);
    }
  } while (c == ' ' || c == '\t' || c == '\n' || c == '\r');
  int i = 0;
  while (c != EOF && c != ' ' && c != '\t' && c != '\n' && c != '\r' &&
         i < cap - 1) {
    buf[i++] = (char)c;
    c = fgetc(f);
  }
  buf[i] = 0;
  return i > 0;
}

GrayImage decode_pnm(const std::string& path) {
  GrayImage out;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return out;
  char tok[64];
  if (!pnm_token(f, tok, 64)) { fclose(f); return out; }
  bool p5 = !strcmp(tok, "P5"), p6 = !strcmp(tok, "P6");
  if (!p5 && !p6) { fclose(f); return out; }
  int w, h, maxv;
  if (!pnm_token(f, tok, 64)) { fclose(f); return out; }
  w = atoi(tok);
  if (!pnm_token(f, tok, 64)) { fclose(f); return out; }
  h = atoi(tok);
  if (!pnm_token(f, tok, 64)) { fclose(f); return out; }
  maxv = atoi(tok);
  if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 255) { fclose(f); return out; }
  int ch = p6 ? 3 : 1;
  std::vector<uint8_t> raw((size_t)w * h * ch);
  if (fread(raw.data(), 1, raw.size(), f) != raw.size()) {
    fclose(f);
    return out;
  }
  fclose(f);
  out.rows = h;
  out.cols = w;
  out.px.resize((size_t)w * h);
  if (p5) {
    for (size_t i = 0; i < out.px.size(); ++i) out.px[i] = (float)raw[i];
  } else {
    // ITU-R BT.601 luma, same as OpenCV's cvtColor BGR2GRAY weights
    for (size_t i = 0; i < out.px.size(); ++i) {
      const uint8_t* p = raw.data() + 3 * i;
      out.px[i] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
    }
  }
  out.ok = true;
  return out;
}

GrayImage decode_any(const std::string& path) {
  size_t dot = path.rfind('.');
  std::string ext = dot == std::string::npos ? "" : path.substr(dot);
  for (auto& c : ext) c = (char)tolower(c);
  if (ext == ".jpg" || ext == ".jpeg") return decode_jpeg(path);
  if (ext == ".pgm" || ext == ".ppm" || ext == ".pnm")
    return decode_pnm(path);
  return GrayImage{};
}

// ------------------------------------------------------------------ resize

// Bilinear resize replicating cv::resize INTER_LINEAR coordinate mapping:
// src = (dst + 0.5) * scale - 0.5, edge-clamped (reference Frame.cpp:60
// resizes 1920x1080 -> 480x270 with the OpenCV default interpolation).
void resize_bilinear(const GrayImage& src, int rows, int cols, float* out) {
  if (src.rows == rows && src.cols == cols) {
    memcpy(out, src.px.data(), sizeof(float) * (size_t)rows * cols);
    return;
  }
  const float sy = (float)src.rows / rows, sx = (float)src.cols / cols;
  for (int y = 0; y < rows; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y0c = std::min(std::max(y0, 0), src.rows - 1);
    int y1c = std::min(std::max(y0 + 1, 0), src.rows - 1);
    const float* r0 = src.px.data() + (size_t)y0c * src.cols;
    const float* r1 = src.px.data() + (size_t)y1c * src.cols;
    float* dst = out + (size_t)y * cols;
    for (int x = 0; x < cols; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)floorf(fx);
      float wx = fx - x0;
      int x0c = std::min(std::max(x0, 0), src.cols - 1);
      int x1c = std::min(std::max(x0 + 1, 0), src.cols - 1);
      float top = r0[x0c] * (1.f - wx) + r0[x1c] * wx;
      float bot = r1[x0c] * (1.f - wx) + r1[x1c] * wx;
      dst[x] = top * (1.f - wy) + bot * wy;
    }
  }
}

// ------------------------------------------------------------------ loader

struct Loader {
  std::vector<std::string> files;
  int rows, cols;
  size_t queue_cap;

  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::map<size_t, std::vector<float>> ready;  // decoded, ordered by index
  std::atomic<size_t> next_to_decode{0};
  size_t next_to_deliver = 0;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      if (stop.load()) return;
      size_t idx = next_to_decode.fetch_add(1);
      if (idx >= files.size()) return;
      GrayImage img = decode_any(files[idx]);
      std::vector<float> frame((size_t)rows * cols, 0.f);
      if (img.ok) resize_bilinear(img, rows, cols, frame.data());
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || ready.size() < queue_cap ||
               idx < next_to_deliver + queue_cap;
      });
      if (stop.load()) return;
      ready.emplace(idx, std::move(frame));
      cv_data.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ellc_loader_open(const char* dir, int rows, int cols, int n_threads,
                       int queue_cap) {
  auto* L = new Loader();
  L->rows = rows;
  L->cols = cols;
  L->queue_cap = queue_cap > 0 ? (size_t)queue_cap : 8;
  DIR* d = opendir(dir);
  if (!d) {
    delete L;
    return nullptr;
  }
  while (dirent* e = readdir(d)) {
    std::string n = e->d_name;
    size_t dot = n.rfind('.');
    if (dot == std::string::npos) continue;
    std::string ext = n.substr(dot);
    for (auto& c : ext) c = (char)tolower(c);
    if (ext == ".jpg" || ext == ".jpeg" || ext == ".pgm" || ext == ".ppm" ||
        ext == ".pnm")
      L->files.push_back(std::string(dir) + "/" + n);
  }
  closedir(d);
  std::sort(L->files.begin(), L->files.end());
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back(&Loader::worker, L);
  return L;
}

int ellc_loader_count(void* h) {
  return (int)static_cast<Loader*>(h)->files.size();
}

int ellc_loader_next(void* h, float* out) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_to_deliver >= L->files.size()) return 0;
  size_t want = L->next_to_deliver;
  L->cv_data.wait(lk, [&] { return L->ready.count(want) > 0; });
  auto it = L->ready.find(want);
  memcpy(out, it->second.data(),
         sizeof(float) * (size_t)L->rows * L->cols);
  L->ready.erase(it);
  L->next_to_deliver++;
  L->cv_space.notify_all();
  return 1;
}

void ellc_loader_skip(void* h, int n) {
  // fast-forward like the reference's seek to BATCH_START_ID
  // (main.cpp:156-166) — decoded frames before the target are discarded
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  size_t target = std::min(L->next_to_deliver + (size_t)n, L->files.size());
  while (L->next_to_deliver < target) {
    size_t want = L->next_to_deliver;
    L->cv_data.wait(lk, [&] { return L->ready.count(want) > 0; });
    L->ready.erase(want);
    L->next_to_deliver++;
    L->cv_space.notify_all();
  }
}

void ellc_loader_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_data.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
