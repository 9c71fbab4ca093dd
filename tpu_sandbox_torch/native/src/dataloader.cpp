// Native data pipeline: multithreaded batch gather + normalize + prefetch.
//
// Role parity: the reference leans on torch's C++ DataLoader machinery
// (reference mnist_onegpu.py:55-59 — though it ran num_workers=0, the
// loader itself is C++) and torchvision's per-image host transforms. Here
// the host-side work per batch is: gather rows by index, convert uint8 ->
// float32/255 (ToTensor semantics). This library does that off the Python
// thread with a worker pool and a bounded in-order prefetch ring, so the
// accelerator never waits on the GIL.
//
// C ABI (ctypes-friendly); see tpu_sandbox_torch/data/native_loader.py.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<float> images;
  std::vector<int32_t> labels;
  int64_t count = 0;     // rows in this batch
  int64_t expected = 0;  // the only job id allowed to write this slot next
  bool ready = false;
};

struct Loader {
  const uint8_t* images;   // [n, item_len] row-major, borrowed
  const uint8_t* labels;   // [n], borrowed
  int64_t item_len;
  int64_t batch;
  std::vector<int64_t> indices;
  int64_t n_batches;

  std::vector<Slot> ring;
  std::atomic<int64_t> next_job{0};
  int64_t next_out = 0;

  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for slot ready
  std::condition_variable cv_free;    // workers wait for slot freed
  bool stopping = false;

  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      int64_t job = next_job.fetch_add(1);
      if (job >= n_batches) return;
      int64_t slot_idx = job % (int64_t)ring.size();
      Slot& slot = ring[slot_idx];
      {
        std::unique_lock<std::mutex> lk(mu);
        // wait for our turn on this slot: drained AND this job is next in
        // its rotation (two jobs ring-distance apart must not both write
        // after a single drain)
        cv_free.wait(lk, [&] {
          return stopping || (!slot.ready && slot.expected == job);
        });
        if (stopping) return;
      }
      int64_t start = job * batch;
      int64_t count = std::min(batch, (int64_t)indices.size() - start);
      slot.count = count;
      float* out = slot.images.data();
      for (int64_t r = 0; r < count; ++r) {
        const uint8_t* src = images + indices[start + r] * item_len;
        float* dst = out + r * item_len;
        for (int64_t i = 0; i < item_len; ++i) dst[i] = src[i] * (1.0f / 255.0f);
        slot.labels[(size_t)r] = labels[indices[start + r]];
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        slot.ready = true;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

Loader* loader_create(const uint8_t* images, const uint8_t* labels, int64_t n,
                      int64_t item_len, int64_t batch, const int64_t* indices,
                      int64_t n_indices, int threads, int prefetch) {
  if (!images || !labels || batch <= 0 || n_indices <= 0 || n <= 0) return nullptr;
  for (int64_t i = 0; i < n_indices; ++i)
    if (indices[i] < 0 || indices[i] >= n) return nullptr;
  auto* ld = new Loader();
  ld->images = images;
  ld->labels = labels;
  ld->item_len = item_len;
  ld->batch = batch;
  ld->indices.assign(indices, indices + n_indices);
  ld->n_batches = (n_indices + batch - 1) / batch;
  int slots = std::max(2, prefetch);
  ld->ring.resize(slots);
  for (int i = 0; i < slots; ++i) {
    ld->ring[i].images.resize((size_t)batch * item_len);
    ld->ring[i].labels.resize((size_t)batch);
    ld->ring[i].expected = i;
  }
  int nthreads = std::max(1, threads);
  for (int t = 0; t < nthreads; ++t)
    ld->workers.emplace_back([ld] { ld->worker(); });
  return ld;
}

// Copies the next batch (in order) into out_images/out_labels.
// Returns the row count, or 0 when the epoch is exhausted.
int64_t loader_next(Loader* ld, float* out_images, int32_t* out_labels) {
  if (!ld || ld->next_out >= ld->n_batches) return 0;
  int64_t slot_idx = ld->next_out % (int64_t)ld->ring.size();
  Slot& slot = ld->ring[slot_idx];
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->cv_ready.wait(lk, [&] { return slot.ready; });
  }
  int64_t count = slot.count;
  std::memcpy(out_images, slot.images.data(),
              (size_t)count * ld->item_len * sizeof(float));
  std::memcpy(out_labels, slot.labels.data(), (size_t)count * sizeof(int32_t));
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    slot.ready = false;
    slot.expected += (int64_t)ld->ring.size();
  }
  ld->cv_free.notify_all();
  ld->next_out++;
  return count;
}

int64_t loader_num_batches(Loader* ld) { return ld ? ld->n_batches : 0; }

void loader_destroy(Loader* ld) {
  if (!ld) return;
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stopping = true;
    ld->next_job.store(ld->n_batches);
  }
  ld->cv_free.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
