// Native ray-batch assembler.
//
// The hot host-side loop of NeRF training is: draw a per-epoch permutation
// of N rays, then for every step gather batch_size rows from three (N, 3)
// float32 arrays (pixels, origins, directions).  In Python/numpy this is
// three fancy-index gathers per step on the main thread, serialized with
// the dispatch of the train step.  This module does the same work in C++
// with a background thread and a small ring of pre-assembled batches, so
// batch i+1 is gathered while the device runs step i.
//
// The PyTorch port's copy of nerf_keras_tpu/data/native/batcher.cc, the
// same source: the reference delegates this to tf.data (shuffle buffer +
// batch + prefetch, reference data_utils.py:140-170).  Exposed through
// ctypes; see ../native.py for the Python side, which builds it into
// nerf_keras_tpu_torch/_build/.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libray_batcher.so batcher.cc

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr int kRing = 4;  // prefetched batches in flight

// Optional permutation provider supplied by the caller: fills `order` with
// a permutation of [0, n) for the given epoch.  The Python binding passes a
// numpy default_rng((seed, epoch)) permutation so the native and numpy
// pipelines yield byte-identical batch orders for a given (seed, epoch) —
// resumed runs reproduce the continuous run's order on either path.
typedef void (*reshuffle_fn)(uint64_t epoch, int64_t* order, int64_t n);

struct Batcher {
  // Source arrays (borrowed pointers; caller keeps them alive).
  const float* pixels = nullptr;
  const float* origins = nullptr;
  const float* directions = nullptr;
  int64_t n_rays = 0;
  int64_t batch_size = 0;
  uint64_t seed = 0;
  reshuffle_fn shuffle_cb = nullptr;

  // Epoch state.
  std::vector<int64_t> order;
  int64_t cursor = 0;       // next ray index into `order`
  uint64_t epoch = 0;

  // Ring buffer of assembled batches: each slot holds 3 * batch_size * 3
  // floats laid out [pixels | origins | directions].
  std::vector<std::vector<float>> ring;
  std::atomic<int64_t> produced{0};
  std::atomic<int64_t> consumed{0};

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_can_produce;
  std::condition_variable cv_can_consume;
  std::atomic<bool> stop{false};

  int64_t steps_per_epoch() const { return n_rays / batch_size; }

  void reshuffle() {
    // Fresh permutation derived from (seed, epoch): every process in a
    // multi-host job shuffles its own shard identically to the Python
    // pipeline's (seed, epoch)-keyed rng.  The callback (when set) IS that
    // rng; the builtin mt19937 Fisher-Yates is the no-binding fallback.
    order.resize(n_rays);
    if (shuffle_cb != nullptr) {
      shuffle_cb(epoch, order.data(), n_rays);
      cursor = 0;
      return;
    }
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + epoch);
    for (int64_t i = 0; i < n_rays; ++i) order[i] = i;
    for (int64_t i = n_rays - 1; i > 0; --i) {
      std::uniform_int_distribution<int64_t> dist(0, i);
      std::swap(order[i], order[dist(rng)]);
    }
    cursor = 0;
  }

  void assemble(std::vector<float>& out) {
    if (cursor + batch_size > n_rays) {
      ++epoch;
      reshuffle();
    }
    float* px = out.data();
    float* og = px + batch_size * 3;
    float* dr = og + batch_size * 3;
    for (int64_t i = 0; i < batch_size; ++i) {
      const int64_t r = order[cursor + i] * 3;
      std::memcpy(px + i * 3, pixels + r, 3 * sizeof(float));
      std::memcpy(og + i * 3, origins + r, 3 * sizeof(float));
      std::memcpy(dr + i * 3, directions + r, 3 * sizeof(float));
    }
    cursor += batch_size;
  }

  void run() {
    while (true) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_can_produce.wait(lk, [&] {
          return stop.load() || produced.load() - consumed.load() < kRing;
        });
      }
      if (stop.load()) return;
      assemble(ring[produced.load() % kRing]);
      produced.fetch_add(1);
      cv_can_consume.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* batcher_create(const float* pixels, const float* origins,
                     const float* directions, int64_t n_rays,
                     int64_t batch_size, uint64_t seed,
                     uint64_t start_epoch, reshuffle_fn shuffle_cb) {
  // Defensive: a batch larger than the dataset would read order[] out of
  // bounds in assemble() and segfault in the worker thread, where no
  // Python-side try/except can catch it.
  if (batch_size <= 0 || n_rays < batch_size) return nullptr;
  auto* b = new Batcher();
  b->pixels = pixels;
  b->origins = origins;
  b->directions = directions;
  b->n_rays = n_rays;
  b->batch_size = batch_size;
  b->seed = seed;
  b->epoch = start_epoch;
  b->shuffle_cb = shuffle_cb;
  b->reshuffle();
  b->ring.assign(kRing, std::vector<float>(3 * batch_size * 3));
  b->worker = std::thread([b] { b->run(); });
  return b;
}

// Copy the next prefetched batch into `out` (3 * batch_size * 3 floats,
// [pixels | origins | directions]).  Blocks until one is ready.
void batcher_next(void* handle, float* out) {
  auto* b = static_cast<Batcher*>(handle);
  {
    std::unique_lock<std::mutex> lk(b->mu);
    b->cv_can_consume.wait(lk, [&] {
      return b->produced.load() > b->consumed.load();
    });
  }
  const auto& slot = b->ring[b->consumed.load() % kRing];
  std::memcpy(out, slot.data(), slot.size() * sizeof(float));
  b->consumed.fetch_add(1);
  b->cv_can_produce.notify_one();
}

int64_t batcher_steps_per_epoch(void* handle) {
  return static_cast<Batcher*>(handle)->steps_per_epoch();
}

void batcher_destroy(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  b->stop.store(true);
  b->cv_can_produce.notify_all();
  if (b->worker.joinable()) b->worker.join();
  delete b;
}

}  // extern "C"
