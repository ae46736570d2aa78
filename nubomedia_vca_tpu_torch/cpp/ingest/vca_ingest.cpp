// vca_ingest — native multi-stream frame ingest / batching feeder, with a
// media-plane return path.
//
// The reference's ingest is GStreamer: one streaming thread per filter maps
// each GstBuffer, processes it in place, and the (annotated) frame continues
// downstream (kmsfacedetect.cpp:282-306,857-898). The TPU-native equivalent
// must instead keep a device fed with *batches* of frames from many streams
// (SURVEY.md §7 "host↔device streaming") and return annotated frames to each
// stream. This library is that feeder's native core:
//
//   * producers (one per stream, any thread) push BGR/BGRA/I420 frames;
//     colorspace→gray happens at push time in native code (bit-exact Q15
//     BGR→gray, matching ops/color.py); optionally the frame is ALSO
//     downscaled at push to the detection working resolution (bit-exact
//     INTER_LINEAR_EXACT, matching ops/resize.py) so only ~work_w×work_h
//     luma ever crosses host→device — the reference also downscales on the
//     CPU before detecting (kmsfacedetect.cpp:805);
//   * a consumer drains ready frames into one contiguous [B,H,W] uint8
//     slab (plus pts + stream ids) sized for direct device transfer;
//   * annotated output frames are sent back over each stream's own TCP
//     connection (vca_ingest_send) — the media-plane product the reference
//     delivers by mutating the frame in place and letting it continue to
//     autovideosink (run_plugin.sh:3).
//   * each queued frame carries a steady_clock stamp; collect adds the
//     frames it drains and their waits in the queue to two running sums
//     (vca_ingest_collected, vca_ingest_collect_wait_ns) that the media
//     loop reads while tracing.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).
//
// Build: make -C nubomedia_vca_tpu/cpp/ingest

// Live sources: vca_ingest_listen() opens a TCP port accepting raw-video
// byte streams (one connection per stream) — the wire format produced by
//   gst-launch-1.0 v4l2src ! videoconvert !
//     video/x-raw,format=GRAY8,width=W,height=H ! tcpclientsink ...
// or  ffmpeg -i src -f rawvideo -pix_fmt gray tcp://host:port
// replacing the reference's in-process GStreamer element attachment
// (run_plugin.sh pipelines) with a wire boundary any media stack can feed.
// Connections are full-duplex: annotated GRAY8 frames queued with
// vca_ingest_send() are written back on the same socket.

#include <atomic>
#include <cfenv>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

struct Slot {
  std::vector<uint8_t> gray;
  std::vector<uint8_t> color;  // tight BGR copy when retain_color is on
  int64_t pts;
  int32_t stream;
  int64_t pushed_ns;  // steady_clock when queued (CLOCK_MONOTONIC)
};

int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// One full-duplex TCP connection (= one stream). The reader thread owns the
// fd lifecycle: it joins the writer before closing, so the fd is closed
// exactly once and never while the writer still uses it. The output queue
// is BOUNDED with a drop-oldest policy (out_dropped counts) — a client
// that feeds frames but reads its annotated return stream slowly (or
// never: a one-way ffmpeg feeder) must not grow process memory without
// bound.
struct Conn {
  static constexpr size_t kMaxOutQueue = 64;
  int fd = -1;
  std::deque<std::vector<uint8_t>> outq;
  std::mutex mu;
  std::condition_variable cv;
  bool closed = false;
  int64_t out_dropped = 0;
};

// Bilinear INTER_LINEAR_EXACT tables — the same fixed-point scheme as
// ops/resize.py (verified bit-exact vs OpenCV 4.6): Q8 horizontal, Q16
// vertical, (v + 2^15) >> 16 final rounding; frac clamped to 0 when sx < 0;
// coefficients rounded half-to-even (nearbyint in the default FE_TONEAREST
// mode, matching numpy.round).
struct LinTab {
  std::vector<int32_t> s0, s1, c0, c1;
};

LinTab make_lin_tab(int src, int dst) {
  LinTab t;
  t.s0.resize(dst);
  t.s1.resize(dst);
  t.c0.resize(dst);
  t.c1.resize(dst);
  for (int x = 0; x < dst; x++) {
    double fx = ((2.0 * x + 1.0) * src - dst) / (2.0 * dst);
    double sx = std::floor(fx);
    double frac = sx < 0 ? 0.0 : fx - sx;
    int s0 = static_cast<int>(sx);
    if (s0 < 0) s0 = 0;
    if (s0 > src - 1) s0 = src - 1;
    int s1 = s0 + 1 > src - 1 ? src - 1 : s0 + 1;
    int c1 = static_cast<int>(std::nearbyint(frac * 256.0));
    t.s0[x] = s0;
    t.s1[x] = s1;
    t.c1[x] = c1;
    t.c0[x] = 256 - c1;
  }
  return t;
}

// Immutable downscale-table snapshot, swapped atomically under Ingest::mu;
// pushes take a shared_ptr so a concurrent set_work can never free tables
// out from under an in-flight resize.
struct WorkTabs {
  int w, h;
  LinTab tx, ty;
};

struct Ingest {
  int width, height, capacity;
  // optional downscale-at-push target (null = off); when set, collect()
  // yields [B, work_h, work_w] and only that much luma crosses H2D
  std::shared_ptr<const WorkTabs> work;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Slot> ready;
  int64_t dropped = 0;
  // frames collected, and the sum of their waits in `ready` (collect time
  // less push stamp), for the media loop's ingest-wait counters
  int64_t collected = 0;
  int64_t collect_wait_ns = 0;
  // retain a tight BGR copy of each color push so the media loop can draw
  // annotations on the COLOR frame (the reference mutates the color frame
  // in place, kmsfacedetect.cpp:857-898); full-resolution pushes only
  std::atomic<int> retain_color{0};
  // live TCP listener state
  int listen_fd = -1;
  int listen_channels = 1;
  std::atomic<bool> stop{false};
  std::atomic<int32_t> next_stream{0};
  std::thread accept_thread;
  std::mutex conn_mu;
  std::vector<std::thread> conn_threads;           // reader threads
  std::map<int32_t, std::shared_ptr<Conn>> conns;  // stream -> connection
};

inline uint8_t bgr2gray(uint8_t b, uint8_t g, uint8_t r) {
  // bit-exact OpenCV Q15: (9798 R + 19235 G + 3735 B + 2^14) >> 15
  return static_cast<uint8_t>(
      (9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15);
}

// gray [sh, sw] -> out [dh, dw], bit-exact with ops/resize.py.
void resize_linear_exact(const uint8_t* src, int sw, int sh, uint8_t* out,
                         const LinTab& tx, const LinTab& ty, int dw, int dh) {
  // horizontal pass in Q8 into a [sh, dw] int32 buffer
  std::vector<int32_t> h(static_cast<size_t>(sh) * dw);
  for (int y = 0; y < sh; y++) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw;
    int32_t* hrow = h.data() + static_cast<size_t>(y) * dw;
    for (int x = 0; x < dw; x++)
      hrow[x] = row[tx.s0[x]] * tx.c0[x] + row[tx.s1[x]] * tx.c1[x];
  }
  // vertical pass in Q16, round, clip
  for (int y = 0; y < dh; y++) {
    const int32_t* r0 = h.data() + static_cast<size_t>(ty.s0[y]) * dw;
    const int32_t* r1 = h.data() + static_cast<size_t>(ty.s1[y]) * dw;
    uint8_t* orow = out + static_cast<size_t>(y) * dw;
    for (int x = 0; x < dw; x++) {
      int32_t v = (r0[x] * ty.c0[y] + r1[x] * ty.c1[y] + (1 << 15)) >> 16;
      orow[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

}  // namespace

extern "C" {

void* vca_ingest_create(int width, int height, int capacity) {
  auto* h = new Ingest;
  h->width = width;
  h->height = height;
  h->capacity = capacity;
  return h;
}

// Enable downscale-at-push to (work_w, work_h); pass 0,0 to disable.
// Call before pushing; collect() buffers must then be [B, work_h, work_w].
void vca_ingest_set_work(void* p, int work_w, int work_h) {
  auto* h = static_cast<Ingest*>(p);
  std::shared_ptr<const WorkTabs> tabs;
  if (work_w > 0 && work_h > 0 &&
      (work_w != h->width || work_h != h->height)) {
    auto t = std::make_shared<WorkTabs>();
    t->w = work_w;
    t->h = work_h;
    t->tx = make_lin_tab(h->width, work_w);
    t->ty = make_lin_tab(h->height, work_h);
    tabs = t;
  }
  std::lock_guard<std::mutex> lk(h->mu);
  h->work = tabs;
  h->ready.clear();  // queued frames have the old shape (collect also
                     // shape-guards against any in-flight stragglers)
}

void vca_ingest_stop_listen(void* p) {
  auto* h = static_cast<Ingest*>(p);
  h->stop = true;
  if (h->listen_fd >= 0) {
    ::shutdown(h->listen_fd, SHUT_RDWR);
    ::close(h->listen_fd);
    h->listen_fd = -1;
  }
  if (h->accept_thread.joinable()) h->accept_thread.join();
  std::vector<std::thread> readers;
  {
    std::lock_guard<std::mutex> lk(h->conn_mu);
    readers.swap(h->conn_threads);
    // unblock every reader (recv) and writer (cv wait)
    for (auto& kv : h->conns) {
      std::lock_guard<std::mutex> clk(kv.second->mu);
      if (kv.second->fd >= 0) ::shutdown(kv.second->fd, SHUT_RDWR);
      kv.second->cv.notify_all();
    }
  }
  for (auto& t : readers)
    if (t.joinable()) t.join();
  std::lock_guard<std::mutex> lk(h->conn_mu);
  h->conns.clear();
}

void vca_ingest_destroy(void* p) {
  vca_ingest_stop_listen(p);
  delete static_cast<Ingest*>(p);
}

int64_t vca_ingest_dropped(void* p) {
  auto* h = static_cast<Ingest*>(p);
  std::lock_guard<std::mutex> lk(h->mu);
  return h->dropped;
}

int64_t vca_ingest_collected(void* p) {
  auto* h = static_cast<Ingest*>(p);
  std::lock_guard<std::mutex> lk(h->mu);
  return h->collected;
}

int64_t vca_ingest_collect_wait_ns(void* p) {
  auto* h = static_cast<Ingest*>(p);
  std::lock_guard<std::mutex> lk(h->mu);
  return h->collect_wait_ns;
}

// Total annotated frames dropped across live connections because a client
// read its return stream too slowly (Conn::kMaxOutQueue drop-oldest).
int64_t vca_ingest_out_dropped(void* p) {
  auto* h = static_cast<Ingest*>(p);
  std::lock_guard<std::mutex> lk(h->conn_mu);
  int64_t total = 0;
  for (auto& kv : h->conns) {
    std::lock_guard<std::mutex> clk(kv.second->mu);
    total += kv.second->out_dropped;
  }
  return total;
}

namespace {

// Fused colorspace + downscale: when pushing BGR/BGRA frames with a work
// resolution set, only the source pixels the bilinear taps actually read
// are converted to gray — for a 1280→160 downscale that is ~16x less
// convert work than full-frame gray, which matters when one CPU core
// feeds the chip. Bit-identical to convert-then-resize (same Q15 gray,
// same Q8/Q16 resize tables).
void fused_gray_resize(const uint8_t* data, int stride, int channels,
                       uint8_t* out, const LinTab& tx, const LinTab& ty,
                       int dw, int dh) {
  auto gray_at = [&](int sy, int sx) -> int32_t {
    const uint8_t* px = data + static_cast<size_t>(sy) * stride +
                        static_cast<size_t>(sx) * channels;
    return bgr2gray(px[0], px[1], px[2]);
  };
  std::vector<int32_t> h0(dw), h1(dw);
  for (int oy = 0; oy < dh; oy++) {
    const int r0 = ty.s0[oy], r1 = ty.s1[oy];
    for (int ox = 0; ox < dw; ox++) {
      h0[ox] = gray_at(r0, tx.s0[ox]) * tx.c0[ox] +
               gray_at(r0, tx.s1[ox]) * tx.c1[ox];
      h1[ox] = (r1 == r0) ? h0[ox]
                          : gray_at(r1, tx.s0[ox]) * tx.c0[ox] +
                                gray_at(r1, tx.s1[ox]) * tx.c1[ox];
    }
    uint8_t* orow = out + static_cast<size_t>(oy) * dw;
    for (int ox = 0; ox < dw; ox++) {
      int32_t v = (h0[ox] * ty.c0[oy] + h1[ox] * ty.c1[oy] + (1 << 15)) >> 16;
      orow[ox] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

}  // namespace

// channels: 1 = already gray / I420 luma plane, 3 = BGR, 4 = BGRA
int vca_ingest_push(void* p, int stream, const uint8_t* data, int stride,
                    int channels, int64_t pts) {
  auto* h = static_cast<Ingest*>(p);
  const int w = h->width, ht = h->height;
  if (channels != 1 && channels != 3 && channels != 4) return -1;
  Slot s;
  s.pts = pts;
  s.stream = stream;
  std::shared_ptr<const WorkTabs> wt;
  {
    std::lock_guard<std::mutex> lk(h->mu);
    wt = h->work;
  }
  if (h->retain_color && channels >= 3) {
    // tight BGR copy (alpha stripped), always FULL resolution — with a
    // work downscale set this is the host-side annotation canvas (the
    // media loop detects from the downscaled luma and draws on the
    // retained color frame host-side, matching the reference's
    // detect-downscaled / draw-full-res shape, kmsfacedetect.cpp:805,
    // 832-850); the retained copy never crosses H2D
    s.color.resize(static_cast<size_t>(w) * ht * 3);
    for (int y = 0; y < ht; y++) {
      const uint8_t* row = data + static_cast<size_t>(y) * stride;
      uint8_t* out = s.color.data() + static_cast<size_t>(y) * w * 3;
      if (channels == 3) {
        std::memcpy(out, row, static_cast<size_t>(w) * 3);
      } else {
        for (int x = 0; x < w; x++) {
          out[3 * x] = row[4 * x];
          out[3 * x + 1] = row[4 * x + 1];
          out[3 * x + 2] = row[4 * x + 2];
        }
      }
    }
  }
  if (wt && channels != 1) {
    // fused convert+downscale (touches only the bilinear tap pixels)
    s.gray.resize(static_cast<size_t>(wt->w) * wt->h);
    fused_gray_resize(data, stride, channels, s.gray.data(), wt->tx,
                      wt->ty, wt->w, wt->h);
  } else if (wt) {
    // gray input: resize straight from the caller's buffer
    s.gray.resize(static_cast<size_t>(wt->w) * wt->h);
    if (stride == w) {
      resize_linear_exact(data, w, ht, s.gray.data(), wt->tx, wt->ty,
                          wt->w, wt->h);
    } else {
      std::vector<uint8_t> gray(static_cast<size_t>(w) * ht);
      for (int y = 0; y < ht; y++)
        std::memcpy(gray.data() + static_cast<size_t>(y) * w,
                    data + static_cast<size_t>(y) * stride, w);
      resize_linear_exact(gray.data(), w, ht, s.gray.data(), wt->tx,
                          wt->ty, wt->w, wt->h);
    }
  } else {
    std::vector<uint8_t> gray(static_cast<size_t>(w) * ht);
    for (int y = 0; y < ht; y++) {
      const uint8_t* row = data + static_cast<size_t>(y) * stride;
      uint8_t* out = gray.data() + static_cast<size_t>(y) * w;
      if (channels == 1) {
        std::memcpy(out, row, w);
      } else if (channels == 3) {
        for (int x = 0; x < w; x++)
          out[x] = bgr2gray(row[3 * x], row[3 * x + 1], row[3 * x + 2]);
      } else {
        for (int x = 0; x < w; x++)
          out[x] = bgr2gray(row[4 * x], row[4 * x + 1], row[4 * x + 2]);
      }
    }
    s.gray = std::move(gray);
  }
  {
    std::lock_guard<std::mutex> lk(h->mu);
    if (static_cast<int>(h->ready.size()) >= h->capacity) {
      h->ready.pop_front();  // drop-oldest backpressure policy
      h->dropped++;
    }
    s.pushed_ns = now_ns();
    h->ready.push_back(std::move(s));
  }
  h->cv.notify_one();
  return 0;
}

// Drain up to max_frames into out[B,H,W] (work-resolution when set);
// returns the number collected. wait_ms < 0: block until at least
// min_frames are available.
int vca_ingest_collect(void* p, uint8_t* out, int64_t* pts_out,
                       int32_t* stream_out, int max_frames, int min_frames,
                       int wait_ms) {
  auto* h = static_cast<Ingest*>(p);
  std::unique_lock<std::mutex> lk(h->mu);
  auto have = [&] {
    return static_cast<int>(h->ready.size()) >= min_frames;
  };
  if (wait_ms < 0) {
    h->cv.wait(lk, have);
  } else if (wait_ms > 0 && !have()) {
    h->cv.wait_for(lk, std::chrono::milliseconds(wait_ms), have);
  }
  const size_t frame_sz =
      h->work ? static_cast<size_t>(h->work->w) * h->work->h
              : static_cast<size_t>(h->width) * h->height;
  const int64_t now = now_ns();
  int n = 0;
  while (n < max_frames && !h->ready.empty()) {
    Slot& s = h->ready.front();
    if (s.gray.size() != frame_sz) {
      // straggler pushed around a set_work transition: wrong shape, drop
      h->ready.pop_front();
      h->dropped++;
      continue;
    }
    std::memcpy(out + n * frame_sz, s.gray.data(), frame_sz);
    pts_out[n] = s.pts;
    stream_out[n] = s.stream;
    h->collect_wait_ns += now - s.pushed_ns;
    h->ready.pop_front();
    n++;
  }
  h->collected += n;
  return n;
}

// Enable/disable tight-BGR retention of color pushes (for color-annotated
// media output). Clears queued frames: their retention state is stale.
void vca_ingest_set_retain_color(void* p, int on) {
  auto* h = static_cast<Ingest*>(p);
  h->retain_color = on;
  std::lock_guard<std::mutex> lk(h->mu);
  h->ready.clear();
}

// collect() variant that also drains the retained BGR copies into
// color_out[B,H,W,3]; slots without one (gray/I420 pushes, retain off at
// push time) zero-fill their color frame. The gray plane follows the work
// resolution when a downscale is set (like vca_ingest_collect); the color
// plane is ALWAYS full resolution — it is the host-side annotation canvas.
int vca_ingest_collect_color(void* p, uint8_t* out, uint8_t* color_out,
                             int64_t* pts_out, int32_t* stream_out,
                             int max_frames, int min_frames, int wait_ms) {
  auto* h = static_cast<Ingest*>(p);
  std::unique_lock<std::mutex> lk(h->mu);
  auto have = [&] {
    return static_cast<int>(h->ready.size()) >= min_frames;
  };
  if (wait_ms < 0) {
    h->cv.wait(lk, have);
  } else if (wait_ms > 0 && !have()) {
    h->cv.wait_for(lk, std::chrono::milliseconds(wait_ms), have);
  }
  const size_t gray_sz =
      h->work ? static_cast<size_t>(h->work->w) * h->work->h
              : static_cast<size_t>(h->width) * h->height;
  const size_t color_sz = static_cast<size_t>(h->width) * h->height;
  const int64_t now = now_ns();
  int n = 0;
  while (n < max_frames && !h->ready.empty()) {
    Slot& s = h->ready.front();
    if (s.gray.size() != gray_sz) {
      h->ready.pop_front();
      h->dropped++;
      continue;
    }
    std::memcpy(out + n * gray_sz, s.gray.data(), gray_sz);
    if (s.color.size() == color_sz * 3) {
      std::memcpy(color_out + n * color_sz * 3, s.color.data(),
                  color_sz * 3);
    } else {
      std::memset(color_out + n * color_sz * 3, 0, color_sz * 3);
    }
    pts_out[n] = s.pts;
    stream_out[n] = s.stream;
    h->collect_wait_ns += now - s.pushed_ns;
    h->ready.pop_front();
    n++;
  }
  h->collected += n;
  return n;
}

int vca_ingest_pending(void* p) {
  auto* h = static_cast<Ingest*>(p);
  std::lock_guard<std::mutex> lk(h->mu);
  return static_cast<int>(h->ready.size());
}

// Queue nbytes of annotated frame data for write-back on `stream`'s TCP
// connection (the media-plane output). Returns 0 if queued, -1 when the
// stream has no live connection (in-process pushes, or already closed).
int vca_ingest_send(void* p, int stream, const uint8_t* data, int nbytes) {
  auto* h = static_cast<Ingest*>(p);
  std::shared_ptr<Conn> c;
  {
    std::lock_guard<std::mutex> lk(h->conn_mu);
    auto it = h->conns.find(stream);
    if (it == h->conns.end()) return -1;
    c = it->second;
  }
  std::lock_guard<std::mutex> clk(c->mu);
  if (c->closed || c->fd < 0) return -1;
  if (c->outq.size() >= Conn::kMaxOutQueue) {
    c->outq.pop_front();   // drop-oldest: slow/absent reader backpressure
    c->out_dropped++;
  }
  c->outq.emplace_back(data, data + nbytes);
  c->cv.notify_all();
  return 0;
}

// Accept raw-video TCP connections on `port` (0 = ephemeral); each
// connection becomes one stream whose fixed-size frames (tightly packed)
// are pushed with pts = per-stream frame index. channels: 1 = GRAY8,
// 3 = BGR, 4 = BGRA, -1 = I420/NV12 (W*H*3/2 bytes per frame; the luma
// plane leads in both formats and is all the detectors consume — the
// chroma tail is framed and discarded). Returns the bound port, -1 on
// error.
int vca_ingest_listen(void* p, int port, int channels) {
  auto* h = static_cast<Ingest*>(p);
  if (h->listen_fd >= 0) return -1;  // already listening
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 16) < 0) {
    ::close(fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  h->listen_fd = fd;
  h->listen_channels = channels;
  h->stop = false;

  h->accept_thread = std::thread([h] {
    while (!h->stop) {
      int cfd = ::accept(h->listen_fd, nullptr, nullptr);
      if (cfd < 0) break;
      int32_t stream = h->next_stream++;
      auto conn = std::make_shared<Conn>();
      conn->fd = cfd;
      std::lock_guard<std::mutex> lk(h->conn_mu);
      h->conns[stream] = conn;
      h->conn_threads.emplace_back([h, conn, stream] {
        // writer: drains the output queue onto the socket
        std::thread writer([h, conn] {
          std::unique_lock<std::mutex> lk(conn->mu);
          while (true) {
            conn->cv.wait(lk, [&] {
              return !conn->outq.empty() || conn->closed || h->stop;
            });
            if (conn->outq.empty() && (conn->closed || h->stop)) return;
            if (conn->outq.empty()) continue;
            std::vector<uint8_t> buf = std::move(conn->outq.front());
            conn->outq.pop_front();
            int fd = conn->fd;
            lk.unlock();
            size_t sent = 0;
            while (sent < buf.size()) {
              ssize_t n = ::send(fd, buf.data() + sent, buf.size() - sent,
                                 MSG_NOSIGNAL);
              if (n <= 0) {
                lk.lock();
                conn->closed = true;
                return;
              }
              sent += static_cast<size_t>(n);
            }
            lk.lock();
          }
        });
        // reader: fixed-size frames -> push (I420/NV12: luma + chroma
        // tail; only the leading W*H luma is pushed)
        const size_t luma_bytes =
            static_cast<size_t>(h->width) * h->height;
        const size_t frame_bytes =
            h->listen_channels == -1 ? luma_bytes * 3 / 2
                                     : luma_bytes * h->listen_channels;
        std::vector<uint8_t> buf(frame_bytes);
        int64_t pts = 0;
        while (!h->stop) {
          size_t got = 0;
          while (got < frame_bytes) {
            ssize_t n = ::recv(conn->fd, buf.data() + got,
                               frame_bytes - got, 0);
            if (n <= 0) goto done;
            got += static_cast<size_t>(n);
          }
          if (h->listen_channels == -1) {
            vca_ingest_push(h, stream, buf.data(), h->width, 1, pts++);
          } else {
            vca_ingest_push(h, stream, buf.data(),
                            h->width * h->listen_channels,
                            h->listen_channels, pts++);
          }
        }
      done:
        {
          std::lock_guard<std::mutex> clk(conn->mu);
          conn->closed = true;
          conn->cv.notify_all();
        }
        writer.join();
        {
          std::lock_guard<std::mutex> clk(conn->mu);
          ::close(conn->fd);
          conn->fd = -1;
        }
        std::lock_guard<std::mutex> lk2(h->conn_mu);
        h->conns.erase(stream);
      });
    }
  });
  return ntohs(addr.sin_port);
}

}  // extern "C"
