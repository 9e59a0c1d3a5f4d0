// Native ERA5 sample reader of the PyTorch port, a copy of the JAX package's
// swin_v2_weather_tpu/data/native/era5_native.cpp (the port imports nothing of
// that package): the host-side replacement for NVIDIA DALI's C++ pipeline
// (reference utils/data_loader_era5_dali.py + dali_era5_es_helper.py).
//
// Design: the yearly ERA5 archives store one contiguous, uncompressed fp32
// dataset 'fields' of shape [T, C, H, W]. Python (h5py) resolves the
// dataset's byte offset once at open time; this library then serves every
// sample with plain positional pread(2) — no libhdf5 in the hot path, no
// global HDF5 lock, fully parallel across threads and files.
//
// Per sample it gathers an arbitrary channel subset, crops to [crop_h,
// crop_w] and optionally fuses per-channel mean/std normalization into the
// copy — the work DALI did with worker processes + GPU normalize
// (reference utils/data_loader_era5_dali.py:45-90) done in one pass over
// the data on the host.
//
// An internal persistent thread pool parallelizes over channels; the
// Python caller additionally overlaps whole samples (ctypes releases the
// GIL for the duration of the call).
//
// Build: g++ -O3 -shared -fPIC -pthread era5_native.cpp -o era5_native.so
// (reader.py builds it at first use into swin_v2_weather_torch/_build/)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct FileEntry {
  int fd = -1;
  int64_t base_offset = 0;  // byte offset of dataset[0,0,0,0]
  int64_t t = 0, c = 0, h = 0, w = 0;
};

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { Loop(); });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto &t : workers_) t.join();
  }
  void Submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Loop() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = std::move(jobs_.front());
        jobs_.pop();
      }
      job();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> jobs_;
  std::vector<std::thread> workers_;
  bool stop_ = false;
};

struct Reader {
  std::vector<FileEntry> files;
  std::unique_ptr<ThreadPool> pool;
  int n_threads = 1;
};

// Read exactly `count` bytes at `offset`; returns 0 on success.
int PReadFull(int fd, void *buf, size_t count, int64_t offset) {
  char *p = static_cast<char *>(buf);
  while (count > 0) {
    ssize_t n = pread(fd, p, count, offset);
    if (n <= 0) return -1;
    p += n;
    offset += n;
    count -= static_cast<size_t>(n);
  }
  return 0;
}

// Read one channel's cropped plane into out (already normalized if stats).
int ReadChannel(const FileEntry &f, int64_t t, int64_t chan, int crop_h,
                int crop_w, float mean, float inv_std, bool normalize,
                float *out) {
  const int64_t plane_off =
      f.base_offset + ((t * f.c + chan) * f.h) * f.w * 4;
  if (crop_w == f.w) {
    // rows are contiguous: one pread straight into the output
    if (PReadFull(f.fd, out, (size_t)crop_h * f.w * 4, plane_off)) return -1;
    if (normalize) {
      const int64_t n = (int64_t)crop_h * f.w;
      for (int64_t i = 0; i < n; ++i) out[i] = (out[i] - mean) * inv_std;
    }
    return 0;
  }
  // cropped width: read row by row into a stack scratch per row
  std::vector<float> row(f.w);
  for (int r = 0; r < crop_h; ++r) {
    if (PReadFull(f.fd, row.data(), (size_t)f.w * 4, plane_off + (int64_t)r * f.w * 4))
      return -1;
    float *dst = out + (int64_t)r * crop_w;
    if (normalize) {
      for (int j = 0; j < crop_w; ++j) dst[j] = (row[j] - mean) * inv_std;
    } else {
      std::memcpy(dst, row.data(), (size_t)crop_w * 4);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

void *era5_create(const char **paths, const int64_t *offsets,
                  const int64_t *dims /* n_files x 4 */, int n_files,
                  int n_threads) {
  auto *r = new Reader();
  r->files.resize(n_files);
  for (int i = 0; i < n_files; ++i) {
    FileEntry &f = r->files[i];
    f.fd = open(paths[i], O_RDONLY);
    if (f.fd < 0) {
      delete r;
      return nullptr;
    }
#ifdef POSIX_FADV_RANDOM
    posix_fadvise(f.fd, 0, 0, POSIX_FADV_RANDOM);
#endif
    f.base_offset = offsets[i];
    f.t = dims[i * 4 + 0];
    f.c = dims[i * 4 + 1];
    f.h = dims[i * 4 + 2];
    f.w = dims[i * 4 + 3];
  }
  r->n_threads = n_threads > 0 ? n_threads : 1;
  if (r->n_threads > 1) r->pool.reset(new ThreadPool(r->n_threads));
  return r;
}

void era5_destroy(void *handle) {
  auto *r = static_cast<Reader *>(handle);
  if (!r) return;
  for (auto &f : r->files)
    if (f.fd >= 0) close(f.fd);
  delete r;
}

// Gather `n_ch` channels of frame `t` (file `file_idx`), cropped to
// [crop_h, crop_w], into `out` [n_ch, crop_h, crop_w]. When `means` and
// `stds` are non-null, normalization is fused into the copy.
// Returns 0 on success.
int era5_read_sample(void *handle, int file_idx, int64_t t,
                     const int32_t *channels, int n_ch, int crop_h,
                     int crop_w, const float *means, const float *stds,
                     float *out) {
  auto *r = static_cast<Reader *>(handle);
  if (!r || file_idx < 0 || file_idx >= (int)r->files.size()) return -1;
  const FileEntry &f = r->files[file_idx];
  if (t < 0 || t >= f.t || crop_h > f.h || crop_w > f.w) return -2;
  const bool norm = means != nullptr && stds != nullptr;

  std::atomic<int> err{0};
  const int64_t plane = (int64_t)crop_h * crop_w;

  if (r->pool && n_ch > 1) {
    // Completion latch on the heap (shared_ptr): the waiter may return the
    // moment remaining hits 0, so workers must never touch synchronization
    // state on the waiter's stack. Decrement + notify happen under the
    // lock, so the waiter cannot observe 0 between them.
    struct Latch {
      std::mutex mu;
      std::condition_variable cv;
      int remaining;
    };
    auto latch = std::make_shared<Latch>();
    latch->remaining = n_ch;
    for (int i = 0; i < n_ch; ++i) {
      r->pool->Submit([&, latch, i] {
        const int64_t chan = channels[i];
        const float mean = norm ? means[i] : 0.f;
        const float inv_std = norm ? 1.f / stds[i] : 1.f;
        if (chan < 0 || chan >= f.c ||
            ReadChannel(f, t, chan, crop_h, crop_w, mean, inv_std, norm,
                        out + (int64_t)i * plane))
          err.store(-3);
        std::lock_guard<std::mutex> lk(latch->mu);
        if (--latch->remaining == 0) latch->cv.notify_one();
      });
    }
    std::unique_lock<std::mutex> lk(latch->mu);
    latch->cv.wait(lk, [&] { return latch->remaining == 0; });
  } else {
    for (int i = 0; i < n_ch; ++i) {
      const int64_t chan = channels[i];
      const float mean = norm ? means[i] : 0.f;
      const float inv_std = norm ? 1.f / stds[i] : 1.f;
      if (chan < 0 || chan >= f.c ||
          ReadChannel(f, t, chan, crop_h, crop_w, mean, inv_std, norm,
                      out + (int64_t)i * plane)) {
        err.store(-3);
        break;
      }
    }
  }
  return err.load();
}

// Multi-frame variant for multi-step targets: frames t, t+dt, ...,
// t+(n_frames-1)*dt gathered into out [n_frames, n_ch, crop_h, crop_w].
int era5_read_frames(void *handle, int file_idx, int64_t t, int64_t dt,
                     int n_frames, const int32_t *channels, int n_ch,
                     int crop_h, int crop_w, const float *means,
                     const float *stds, float *out) {
  const int64_t plane = (int64_t)n_ch * crop_h * crop_w;
  for (int s = 0; s < n_frames; ++s) {
    int rc = era5_read_sample(handle, file_idx, t + (int64_t)s * dt, channels,
                              n_ch, crop_h, crop_w, means, stds,
                              out + (int64_t)s * plane);
    if (rc) return rc;
  }
  return 0;
}

}  // extern "C"
