// Batched corpus loader: a C++ worker pool prefetches and decodes WAV
// files in corpus order while the accelerator computes — the data-loader
// half of the native runtime (the reference's SampleFeature file reads,
// scaled to batched training/decoding; SURVEY.md §2.1 feature row [K]).
//
// Workers claim file indices atomically and decode into an ordered ready
// map; `dsr_loader_next` emits the next `batch` consecutive utterances,
// zero-padded to the caller's row stride.  A sliding in-flight window
// bounds memory.  All exported symbols use the C ABI (ctypes on the
// Python side, dsr_tpu_torch/utils/audio.py::BatchLoader).  A copy of the
// JAX package's native/loader.cpp.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

// from wavio.cpp (audio.cpp compiles both in one translation unit)
extern "C" int dsr_wav_info(const char* path, int* rate, int* channels,
                            long long* frames);
extern "C" int dsr_wav_read(const char* path, float* out, long long max_values);

namespace {

struct Utt {
  std::vector<float> data;  // interleaved frames*channels
  long long frames = 0;
  int channels = 0;
  int rate = 0;
  int err = 0;
};

struct Loader {
  std::vector<std::string> paths;
  int batch = 1;
  long long max_values = 0;  // per-utterance row stride (truncate beyond)
  size_t window = 0;         // in-flight prefetch bound (utterances)

  std::atomic<size_t> next_idx{0};
  std::atomic<bool> closing{false};
  size_t emit_idx = 0;

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<size_t, Utt> ready;
  std::vector<std::thread> workers;
};

void worker_loop(Loader* L) {
  for (;;) {
    size_t idx = L->next_idx.fetch_add(1);
    if (idx >= L->paths.size() || L->closing.load()) return;
    {
      // bound the prefetch window so memory stays O(window · utterance)
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_space.wait(lk, [&] {
        return idx < L->emit_idx + L->window || L->closing.load();
      });
      if (L->closing.load()) return;
    }
    Utt u;
    long long frames = 0;
    int rate = 0, channels = 0;
    int rc = dsr_wav_info(L->paths[idx].c_str(), &rate, &channels, &frames);
    if (rc == 0) {
      long long total = frames * channels;
      if (total > L->max_values) total = L->max_values;
      u.data.resize(static_cast<size_t>(total));
      rc = dsr_wav_read(L->paths[idx].c_str(), u.data.data(), total);
      u.frames = total / channels;
      u.channels = channels;
      u.rate = rate;
    }
    u.err = rc;
    {
      std::lock_guard<std::mutex> lk(L->mu);
      L->ready.emplace(idx, std::move(u));
      L->cv_ready.notify_all();
    }
  }
}

}  // namespace

extern "C" {

// paths: '\n'-separated file list.  Returns handle or nullptr.
void* dsr_loader_open(const char* paths_joined, int batch,
                      long long max_values, int workers) {
  auto* L = new Loader();
  const char* p = paths_joined;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : strlen(p);
    if (len) L->paths.emplace_back(p, len);
    p += len + (nl ? 1 : 0);
  }
  if (L->paths.empty() || batch < 1 || max_values < 1) {
    delete L;
    return nullptr;
  }
  L->batch = batch;
  L->max_values = max_values;
  if (workers < 1) workers = 1;
  L->window = static_cast<size_t>(batch) * 2 + workers;
  for (int i = 0; i < workers; ++i) L->workers.emplace_back(worker_loop, L);
  return L;
}

// Fills out (batch rows of max_values floats, zero-padded), frames[b],
// channels[b], rates[b].  Returns the number of utterances emitted
// (0 = end of corpus) or -(b+1) if file at batch position b failed: its
// error code is in frames[b], rows 0..b-1 are valid, and emit_idx still
// advances past the whole consumed prefix so the loader is NOT wedged —
// the next call continues with the following utterances.
int dsr_loader_next(void* h, float* out, long long* frames, int* channels,
                    int* rates) {
  auto* L = static_cast<Loader*>(h);
  int count = 0;
  int failed_at = -1;
  for (int b = 0; b < L->batch; ++b) {
    size_t idx = L->emit_idx + static_cast<size_t>(b);
    if (idx >= L->paths.size()) break;
    Utt u;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_ready.wait(lk, [&] { return L->ready.count(idx) > 0; });
      u = std::move(L->ready[idx]);
      L->ready.erase(idx);
    }
    float* row = out + static_cast<size_t>(b) * L->max_values;
    if (u.err != 0) {
      frames[b] = u.err;  // negative error code
      failed_at = b;
      ++count;            // the failing slot is consumed too
      break;
    }
    std::memcpy(row, u.data.data(), u.data.size() * sizeof(float));
    std::memset(row + u.data.size(), 0,
                (static_cast<size_t>(L->max_values) - u.data.size()) * sizeof(float));
    frames[b] = u.frames;
    channels[b] = u.channels;
    rates[b] = u.rate;
    ++count;
  }
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->emit_idx += static_cast<size_t>(count);
    L->cv_space.notify_all();
  }
  return failed_at >= 0 ? -(failed_at + 1) : count;
}

void dsr_loader_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->closing.store(true);
    L->cv_space.notify_all();
  }
  for (auto& t : L->workers)
    if (t.joinable()) t.join();
  delete L;
}

}  // extern "C"
