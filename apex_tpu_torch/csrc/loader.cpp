// Native data loader — threaded, double-buffered batch assembly.
//
// ref role: the reference's input pipeline is DALI / torch DataLoader
// worker processes (examples/imagenet/main_amp.py builds DALI or
// torchvision loaders); the C++ machinery lives in those libraries.  This
// is the TPU framework's equivalent runtime piece: a worker pool that
// memory-maps a fixed-record dataset, shuffles per epoch (seeded
// Fisher-Yates, reproducible), and assembles batches into a ring of
// reusable buffers so Python only ever touches completed batches
// (zero-copy numpy views via ctypes; jax.device_put overlaps with the
// next batch's assembly).
//
// C API (ctypes):
//   ldr_open(path, record_bytes, batch, workers, prefetch, shuffle, seed)
//   ldr_len(h)                 -> number of records
//   ldr_start_epoch(h, epoch)  -> begin assembling epoch batches
//   ldr_next(h)                -> pointer to a completed batch buffer
//                                 (valid until ldr_release(h, ptr)), or
//                                 NULL at epoch end
//   ldr_release(h, ptr)        -> recycle the buffer
//   ldr_close(h)
//
// Build: g++ -O2 -shared -fPIC -std=c++17 -pthread (see loader.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Batch {
  uint8_t* data;
  int64_t index;  // batch index within the epoch (for ordered delivery)
};

struct Loader {
  // dataset
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t file_bytes = 0;
  int64_t record_bytes = 0;
  int64_t n_records = 0;

  // config
  int64_t batch = 0;
  int workers = 0;
  int prefetch = 0;
  bool shuffle = false;
  uint64_t seed = 0;

  // epoch state
  std::vector<int64_t> order;
  std::atomic<int64_t> next_batch_idx{0};
  int64_t n_batches = 0;

  // buffer ring
  std::vector<std::vector<uint8_t>> buffers;
  std::deque<uint8_t*> free_bufs;       // buffers ready to be filled
  std::deque<Batch> ready;              // filled, awaiting delivery
  int64_t deliver_next = 0;             // next batch index to hand out

  std::mutex mu;
  std::condition_variable cv_free;      // waiting for a free buffer
  std::condition_variable cv_ready;     // waiting for a ready batch
  std::vector<std::thread> pool;
  std::atomic<bool> stop{false};

  ~Loader() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop = true;
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : pool) {
      if (t.joinable()) t.join();
    }
    if (base) munmap(const_cast<uint8_t*>(base), file_bytes);
    if (fd >= 0) close(fd);
  }

  void worker() {
    for (;;) {
      uint8_t* buf;
      int64_t bi;
      {
        // claim the batch index and its buffer ATOMICALLY: claiming the
        // index first can deadlock the in-order consumer (all buffers
        // fill with later batches while the next-to-deliver batch's
        // worker waits for a buffer the consumer will never release)
        std::unique_lock<std::mutex> l(mu);
        cv_free.wait(l, [&] { return stop || !free_bufs.empty(); });
        if (stop) return;
        bi = next_batch_idx.fetch_add(1);
        if (bi >= n_batches) return;
        buf = free_bufs.front();
        free_bufs.pop_front();
      }
      // assemble: gather `batch` records in epoch order
      for (int64_t j = 0; j < batch; ++j) {
        const int64_t rec = order[bi * batch + j];
        std::memcpy(buf + j * record_bytes, base + rec * record_bytes,
                    record_bytes);
      }
      {
        std::lock_guard<std::mutex> l(mu);
        ready.push_back({buf, bi});
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ldr_open(const char* path, int64_t record_bytes, int64_t batch,
               int workers, int prefetch, int shuffle, uint64_t seed) {
  auto* L = new Loader();
  L->fd = open(path, O_RDONLY);
  if (L->fd < 0) {
    delete L;
    return nullptr;
  }
  struct stat st;
  if (fstat(L->fd, &st) != 0) {
    delete L;
    return nullptr;
  }
  L->file_bytes = static_cast<size_t>(st.st_size);
  L->record_bytes = record_bytes;
  L->n_records = static_cast<int64_t>(L->file_bytes / record_bytes);
  L->base = static_cast<const uint8_t*>(
      mmap(nullptr, L->file_bytes, PROT_READ, MAP_PRIVATE, L->fd, 0));
  if (L->base == MAP_FAILED) {
    L->base = nullptr;
    delete L;
    return nullptr;
  }
  madvise(const_cast<uint8_t*>(L->base), L->file_bytes, MADV_WILLNEED);
  L->batch = batch;
  L->workers = workers > 0 ? workers : 1;
  L->prefetch = prefetch > 1 ? prefetch : 2;
  L->shuffle = shuffle != 0;
  L->seed = seed;
  L->buffers.resize(L->prefetch);
  for (auto& b : L->buffers) b.resize(static_cast<size_t>(batch * record_bytes));
  return L;
}

int64_t ldr_len(void* h) { return static_cast<Loader*>(h)->n_records; }

void ldr_start_epoch(void* h, int64_t epoch) {
  auto* L = static_cast<Loader*>(h);
  // join any previous epoch's workers
  {
    std::lock_guard<std::mutex> l(L->mu);
    L->stop = true;
  }
  L->cv_free.notify_all();
  for (auto& t : L->pool)
    if (t.joinable()) t.join();
  L->pool.clear();
  L->stop = false;

  L->order.resize(static_cast<size_t>(L->n_records));
  std::iota(L->order.begin(), L->order.end(), 0);
  if (L->shuffle) {
    std::mt19937_64 rng(L->seed + static_cast<uint64_t>(epoch) * 0x9E3779B97F4A7C15ULL);
    for (int64_t i = L->n_records - 1; i > 0; --i) {
      std::uniform_int_distribution<int64_t> d(0, i);
      std::swap(L->order[i], L->order[d(rng)]);
    }
  }
  L->n_batches = L->n_records / L->batch;  // drop remainder (ref drop_last)
  L->next_batch_idx = 0;
  L->deliver_next = 0;
  {
    std::lock_guard<std::mutex> l(L->mu);
    L->ready.clear();
    L->free_bufs.clear();
    for (auto& b : L->buffers) L->free_bufs.push_back(b.data());
  }
  for (int i = 0; i < L->workers; ++i)
    L->pool.emplace_back([L] { L->worker(); });
}

const uint8_t* ldr_next(void* h) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> l(L->mu);
  if (L->deliver_next >= L->n_batches) return nullptr;  // epoch done
  // in-order delivery: wait for the batch with index deliver_next
  for (;;) {
    for (auto it = L->ready.begin(); it != L->ready.end(); ++it) {
      if (it->index == L->deliver_next) {
        uint8_t* p = it->data;
        L->ready.erase(it);
        L->deliver_next++;
        return p;
      }
    }
    if (L->stop) return nullptr;
    L->cv_ready.wait(l);
  }
}

void ldr_release(void* h, const uint8_t* p) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> l(L->mu);
    L->free_bufs.push_back(const_cast<uint8_t*>(p));
  }
  L->cv_free.notify_all();
}

void ldr_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
