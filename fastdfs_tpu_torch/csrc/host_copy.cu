// The engine's staging copy on the host: a segment's bytes into pinned
// staging, split over a pool of C++ threads shared by every caller in the
// process.  Host code only; it lives in the kernel library so that one
// ctypes call copies the whole segment with the interpreter lock released
// once, where a pool of Python threads would need the lock back after
// every slice (each such wait can last a switch interval behind another
// thread's Python work).
//
// fdfs_host_copy(dst, src, n, step, threads) copies n bytes in slices of
// `step` bytes (the last one shorter).  The caller and the pool's threads
// each claim the next slice not yet taken, so slices the pool cannot take
// at once stay with the caller, and a caller waits only for slices a pool
// thread is already copying, never for a thread that has not started.  A
// job outlives its call while a pool thread still holds it: such a thread
// claims nothing, since every slice was claimed before the caller
// returned.  The pool starts on the first call with `threads` threads
// (later calls' `threads` is ignored) and lives as long as the process.
// Returns the number of slices pool threads copied.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>

namespace {

struct Job {
  char* dst;
  const char* src;
  long long n;
  long long step;
  int slices;
  std::atomic<int> next{0};
  std::atomic<int> pooled{0};
  int left;  // slices not yet copied, guarded by mu
  std::mutex mu;
  std::condition_variable done;

  Job(char* d, const char* s, long long n_, long long step_)
      : dst(d), src(s), n(n_), step(step_),
        slices(static_cast<int>((n_ + step_ - 1) / step_)), left(slices) {}

  // Copies slices not yet claimed until none is left; returns how many.
  int work() {
    int did = 0;
    for (int i; (i = next.fetch_add(1)) < slices; ++did) {
      const long long a = i * step;
      std::memcpy(dst + a, src + a, std::min(step, n - a));
    }
    return did;
  }

  void finish(int did) {
    std::lock_guard<std::mutex> g(mu);
    left -= did;
    if (left == 0) done.notify_all();
  }
};

class Pool {
 public:
  explicit Pool(int threads) {
    for (int i = 0; i < threads; ++i) std::thread([this] { serve(); }).detach();
  }

  void give(const std::shared_ptr<Job>& job, int tokens) {
    {
      std::lock_guard<std::mutex> g(mu_);
      for (int i = 0; i < tokens; ++i) queue_.push_back(job);
    }
    cv_.notify_all();
  }

 private:
  void serve() {
    for (;;) {
      std::shared_ptr<Job> job;
      {
        std::unique_lock<std::mutex> l(mu_);
        cv_.wait(l, [this] { return !queue_.empty(); });
        job = std::move(queue_.front());
        queue_.pop_front();
      }
      const int did = job->work();
      if (did) {
        job->pooled.fetch_add(did);
        job->finish(did);
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::shared_ptr<Job>> queue_;
};

Pool& shared_pool(int threads) {
  // Never destroyed: its threads run until the process exits.
  static Pool* pool = new Pool(threads);
  return *pool;
}

}  // namespace

extern "C" int fdfs_host_copy(void* dst, const void* src, long long n,
                              long long step, int threads) {
  if (n <= 0 || step <= 0) return 0;
  auto job = std::make_shared<Job>(static_cast<char*>(dst),
                                   static_cast<const char*>(src), n, step);
  if (job->slices > 1 && threads > 0)
    shared_pool(threads).give(job, std::min(job->slices - 1, threads));
  job->finish(job->work());
  std::unique_lock<std::mutex> l(job->mu);
  job->done.wait(l, [&] { return job->left == 0; });
  return job->pooled.load();
}
