// Native IO runtime for lfvio_tpu_torch (a copy of lfvio_tpu/native/io_runtime.cpp).
//
// C++ equivalent of the reference's measurement plumbing
// (reference vins_estimator/src/estimator_node.cpp):
//   * lock-free SPSC ring buffers for IMU and frame measurements (replacing
//     the m_buf mutex + condition variable queues, estimator_node.cpp:24-27)
//   * the td-aware measurement synchronizer of getMeasurements
//     (estimator_node.cpp:96-134) including linear IMU interpolation at the
//     frame boundary (estimator_node.cpp:216-258)
//   * stream-discontinuity detection (feature_tracker_node.cpp:38-48)
//   * a buffered TUM trajectory writer (visualization.cpp:173-179)
//
// Exposed as a plain C API consumed from Python via ctypes; images never
// cross this boundary (they stay in device/host arrays), only timing and
// inertial data do.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct ImuSample {
  double t;
  double acc[3];
  double gyr[3];
};

struct FrameStamp {
  double t;
  int64_t id;
};

// Single-producer single-consumer lock-free ring buffer.
template <typename T>
class SpscRing {
 public:
  explicit SpscRing(size_t capacity)
      : buf_(capacity + 1), cap_(capacity + 1) {}

  bool push(const T& v) {
    const size_t head = head_.load(std::memory_order_relaxed);
    const size_t next = (head + 1) % cap_;
    if (next == tail_.load(std::memory_order_acquire)) return false;  // full
    buf_[head] = v;
    head_.store(next, std::memory_order_release);
    return true;
  }

  bool peek(T* out) const {
    const size_t tail = tail_.load(std::memory_order_relaxed);
    if (tail == head_.load(std::memory_order_acquire)) return false;  // empty
    *out = buf_[tail];
    return true;
  }

  bool pop(T* out) {
    const size_t tail = tail_.load(std::memory_order_relaxed);
    if (tail == head_.load(std::memory_order_acquire)) return false;
    *out = buf_[tail];
    tail_.store((tail + 1) % cap_, std::memory_order_release);
    return true;
  }

  size_t size() const {
    const size_t h = head_.load(std::memory_order_acquire);
    const size_t t = tail_.load(std::memory_order_acquire);
    return (h + cap_ - t) % cap_;
  }

  // Consumer-side random access relative to the tail (valid for i < size()).
  const T& at(size_t i) const {
    const size_t t = tail_.load(std::memory_order_relaxed);
    return buf_[(t + i) % cap_];
  }

 private:
  std::vector<T> buf_;
  size_t cap_;
  alignas(64) std::atomic<size_t> head_{0};
  alignas(64) std::atomic<size_t> tail_{0};
};

struct Synchronizer {
  SpscRing<ImuSample> imu;
  SpscRing<FrameStamp> frames;
  double td;                 // frame clock + td = IMU clock
  double last_frame_t = -1;  // for discontinuity detection
  ImuSample last_popped{};   // previous IMU sample (interval start)
  bool has_last = false;

  Synchronizer(double td_, int imu_cap, int frame_cap)
      : imu(imu_cap), frames(frame_cap), td(td_) {}
};

}  // namespace

extern "C" {

void* vio_sync_create(double td, int imu_capacity, int frame_capacity) {
  return new (std::nothrow) Synchronizer(td, imu_capacity, frame_capacity);
}

void vio_sync_destroy(void* h) { delete static_cast<Synchronizer*>(h); }

int vio_sync_push_imu(void* h, double t, const double* acc, const double* gyr) {
  auto* s = static_cast<Synchronizer*>(h);
  ImuSample m;
  m.t = t;
  std::memcpy(m.acc, acc, 3 * sizeof(double));
  std::memcpy(m.gyr, gyr, 3 * sizeof(double));
  return s->imu.push(m) ? 0 : -1;
}

// Returns 1 and sets *restart if the stream is discontinuous (gap > 1 s or
// time going backwards, feature_tracker_node.cpp:38-48), else 0.
int vio_sync_push_frame(void* h, double t, int64_t id, int* restart) {
  auto* s = static_cast<Synchronizer*>(h);
  int r = 0;
  if (s->last_frame_t >= 0 &&
      (t - s->last_frame_t > 1.0 || t < s->last_frame_t)) {
    r = 1;
  }
  s->last_frame_t = t;
  if (restart) *restart = r;
  FrameStamp f{t, id};
  return s->frames.push(f) ? 0 : -1;
}

// Pop the next frame once its IMU interval is fully buffered.
//
// Writes up to max_n samples as (dt, acc, gyr) triples covering
// (prev_frame, frame]: all raw samples strictly before the frame time plus
// one interpolated boundary sample exactly at frame_t + td. Returns the
// number of samples written (>= 0), the frame id via *frame_id and its
// timestamp via *frame_t; returns -1 if no frame is ready yet (more IMU
// needed — the reference's wait condition, estimator_node.cpp:101-113).
int64_t vio_sync_pop(void* h, double* out_dt, double* out_acc, double* out_gyr,
                     int64_t max_n, double* frame_t, int64_t* frame_id) {
  auto* s = static_cast<Synchronizer*>(h);
  FrameStamp f;
  if (!s->frames.peek(&f)) return -1;
  const double t_sync = f.t + s->td;

  // Transactional readiness check: a covering sample (t >= t_sync) must be
  // buffered, otherwise report not-ready WITHOUT consuming anything
  // (the reference blocks on its condvar here, estimator_node.cpp:208-212).
  const size_t count = s->imu.size();
  size_t cover = count;
  for (size_t i = 0; i < count; ++i) {
    if (s->imu.at(i).t >= t_sync) {
      cover = i;
      break;
    }
  }
  if (cover == count) return -1;

  int64_t n = 0;
  ImuSample prev = s->last_popped;
  bool has_prev = s->has_last;

  // Consume samples strictly before t_sync.
  for (size_t i = 0; i < cover; ++i) {
    ImuSample m;
    s->imu.pop(&m);
    if (has_prev && n < max_n) {
      out_dt[n] = m.t - prev.t;
      std::memcpy(&out_acc[3 * n], m.acc, 3 * sizeof(double));
      std::memcpy(&out_gyr[3 * n], m.gyr, 3 * sizeof(double));
      ++n;
    }
    prev = m;
    has_prev = true;
  }
  // Boundary sample: interpolate at t_sync against the covering sample,
  // which stays buffered for the next interval (estimator_node.cpp:232-254).
  ImuSample m;
  s->imu.peek(&m);
  if (has_prev && n < max_n && t_sync > prev.t) {
    const double w = (t_sync - prev.t) / (m.t - prev.t);
    out_dt[n] = t_sync - prev.t;
    for (int k = 0; k < 3; ++k) {
      out_acc[3 * n + k] = (1 - w) * prev.acc[k] + w * m.acc[k];
      out_gyr[3 * n + k] = (1 - w) * prev.gyr[k] + w * m.gyr[k];
    }
    ImuSample interp;
    interp.t = t_sync;
    std::memcpy(interp.acc, &out_acc[3 * n], 3 * sizeof(double));
    std::memcpy(interp.gyr, &out_gyr[3 * n], 3 * sizeof(double));
    prev = interp;
    ++n;
  }

  s->last_popped = prev;
  s->has_last = has_prev;
  s->frames.pop(&f);
  if (frame_t) *frame_t = f.t;
  if (frame_id) *frame_id = f.id;
  return n;
}

int64_t vio_sync_imu_count(void* h) {
  return static_cast<int64_t>(static_cast<Synchronizer*>(h)->imu.size());
}

int64_t vio_sync_frame_count(void* h) {
  return static_cast<int64_t>(static_cast<Synchronizer*>(h)->frames.size());
}

// ---------------------------------------------------------------- TUM writer

struct TumWriter {
  FILE* f;
};

void* vio_tum_open(const char* path) {
  FILE* f = std::fopen(path, "w");
  if (!f) return nullptr;
  auto* w = new (std::nothrow) TumWriter{f};
  return w;
}

int vio_tum_write(void* h, double t, const double* p, const double* q_wxyz) {
  auto* w = static_cast<TumWriter*>(h);
  if (!w || !w->f) return -1;
  // TUM: time tx ty tz qx qy qz qw
  return std::fprintf(w->f, "%.9f %.9f %.9f %.9f %.9f %.9f %.9f %.9f\n", t,
                      p[0], p[1], p[2], q_wxyz[1], q_wxyz[2], q_wxyz[3],
                      q_wxyz[0]) > 0
             ? 0
             : -1;
}

void vio_tum_close(void* h) {
  auto* w = static_cast<TumWriter*>(h);
  if (w) {
    if (w->f) std::fclose(w->f);
    delete w;
  }
}

}  // extern "C"
