// Native audio I/O + streaming runtime of dsr_tpu_torch (a copy of the
// JAX package's native/wavio.cpp, built into the port's audio library by
// ops/cuda/build.py through audio.cpp).
//
// Plays the role of the reference's libsndfile-backed SampleFeature /
// BlockSizeConversion stages (SURVEY.md §2.1 feature row [K]): RIFF/WAVE
// read/write (PCM16 + IEEE float32, any channel count) and a threaded
// ring-buffer sample streamer that re-blocks an input file into arbitrary
// fixed-size frames for the PyTorch pipeline (the pull-model stream core's
// native runtime analogue).
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11 in
// this environment).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float
  uint64_t num_frames = 0;
  uint64_t data_offset = 0;
};

bool parse_header(FILE* f, WavInfo* info) {
  char id[4];
  uint32_t sz;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "RIFF", 4)) return false;
  if (fread(&sz, 4, 1, f) != 1) return false;
  if (fread(id, 1, 4, f) != 4 || memcmp(id, "WAVE", 4)) return false;
  bool have_fmt = false;
  while (fread(id, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
    if (!memcmp(id, "fmt ", 4)) {
      uint16_t fmt, ch, block, bits;
      uint32_t rate, byterate;
      if (fread(&fmt, 2, 1, f) != 1 || fread(&ch, 2, 1, f) != 1 ||
          fread(&rate, 4, 1, f) != 1 || fread(&byterate, 4, 1, f) != 1 ||
          fread(&block, 2, 1, f) != 1 || fread(&bits, 2, 1, f) != 1)
        return false;
      info->format = fmt;
      info->channels = ch;
      info->sample_rate = rate;
      info->bits = bits;
      if (sz > 16) fseek(f, sz - 16, SEEK_CUR);
      have_fmt = true;
    } else if (!memcmp(id, "data", 4)) {
      info->data_offset = static_cast<uint64_t>(ftell(f));
      if (have_fmt && info->bits >= 8) {
        info->num_frames = sz / (info->channels * (info->bits / 8));
      }
      return have_fmt;
    } else {
      fseek(f, sz + (sz & 1), SEEK_CUR);
    }
  }
  return false;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- wav io
// Returns 0 on success; fills rate/channels/frames.
int dsr_wav_info(const char* path, int* rate, int* channels, long long* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_header(f, &info);
  fclose(f);
  if (!ok) return -2;
  *rate = static_cast<int>(info.sample_rate);
  *channels = info.channels;
  *frames = static_cast<long long>(info.num_frames);
  return 0;
}

// Reads the whole file as float32 interleaved into out (frames*channels).
int dsr_wav_read(const char* path, float* out, long long max_values) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  uint64_t total = info.num_frames * info.channels;
  if (static_cast<long long>(total) > max_values) total = max_values;
  fseek(f, static_cast<long>(info.data_offset), SEEK_SET);
  int rc = 0;
  if (info.format == 3 && info.bits == 32) {
    if (fread(out, 4, total, f) != total) rc = -3;
  } else if (info.format == 1 && info.bits == 16) {
    std::vector<int16_t> buf(total);
    if (fread(buf.data(), 2, total, f) != total) {
      rc = -3;
    } else {
      for (uint64_t i = 0; i < total; ++i) out[i] = buf[i] / 32768.0f;
    }
  } else {
    rc = -4;  // unsupported encoding
  }
  fclose(f);
  return rc;
}

// Writes float32 samples as PCM16 (pcm16=1) or float32 (pcm16=0).
int dsr_wav_write(const char* path, const float* data, long long frames,
                  int channels, int rate, int pcm16) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint16_t bits = pcm16 ? 16 : 32;
  uint16_t fmt = pcm16 ? 1 : 3;
  uint32_t data_bytes = static_cast<uint32_t>(frames * channels * (bits / 8));
  uint32_t riff = 36 + data_bytes;
  uint16_t block = static_cast<uint16_t>(channels * (bits / 8));
  uint32_t byterate = rate * block;
  fwrite("RIFF", 1, 4, f);
  fwrite(&riff, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  uint32_t fmtsz = 16;
  fwrite(&fmtsz, 4, 1, f);
  uint16_t ch = static_cast<uint16_t>(channels);
  fwrite(&fmt, 2, 1, f);
  fwrite(&ch, 2, 1, f);
  uint32_t r32 = static_cast<uint32_t>(rate);
  fwrite(&r32, 4, 1, f);
  fwrite(&byterate, 4, 1, f);
  fwrite(&block, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_bytes, 4, 1, f);
  long long total = frames * channels;
  if (pcm16) {
    std::vector<int16_t> buf(total);
    for (long long i = 0; i < total; ++i) {
      float v = data[i] * 32768.0f;
      if (v > 32767.0f) v = 32767.0f;
      if (v < -32768.0f) v = -32768.0f;
      buf[i] = static_cast<int16_t>(v);
    }
    fwrite(buf.data(), 2, total, f);
  } else {
    fwrite(data, 4, total, f);
  }
  fclose(f);
  return 0;
}

// ------------------------------------------------- streaming ring buffer
// A producer thread reads the WAV file in chunks into a ring buffer; the
// consumer pops fixed-size blocks (BlockSizeConversion): the native
// runtime under a streaming pipeline.

}  // extern "C"

namespace {

struct SampleStream {
  std::vector<float> ring;
  size_t cap = 0;
  std::atomic<size_t> head{0};  // write position (values)
  std::atomic<size_t> tail{0};  // read position (values)
  std::atomic<bool> done{false};
  std::atomic<bool> closing{false};
  std::atomic<int> error{0};
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::thread producer;
  WavInfo info;
  FILE* f = nullptr;

  size_t used() const { return head.load() - tail.load(); }
};

void producer_loop(SampleStream* s) {
  const size_t CHUNK = 16384;
  std::vector<float> tmp(CHUNK);
  std::vector<int16_t> tmp16(CHUNK);
  uint64_t remaining = s->info.num_frames * s->info.channels;
  while (remaining > 0) {
    size_t want = remaining < CHUNK ? static_cast<size_t>(remaining) : CHUNK;
    size_t got = 0;
    if (s->info.format == 3 && s->info.bits == 32) {
      got = fread(tmp.data(), 4, want, s->f);
    } else {
      got = fread(tmp16.data(), 2, want, s->f);
      for (size_t i = 0; i < got; ++i) tmp[i] = tmp16[i] / 32768.0f;
    }
    if (got == 0) break;
    size_t written = 0;
    while (written < got) {
      std::unique_lock<std::mutex> lk(s->mu);
      s->cv_space.wait(lk, [&] { return s->cap - s->used() > 0 || s->closing.load(); });
      if (s->closing.load()) { remaining = 0; break; }
      size_t space = s->cap - s->used();
      size_t n = std::min(space, got - written);
      for (size_t i = 0; i < n; ++i)
        s->ring[(s->head.load() + i) % s->cap] = tmp[written + i];
      s->head.store(s->head.load() + n);
      written += n;
      s->cv_data.notify_all();
    }
    remaining -= got;
  }
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->done.store(true);
    s->cv_data.notify_all();
  }
}

}  // namespace

extern "C" {

void* dsr_stream_open(const char* path, long long capacity_values) {
  auto* s = new SampleStream();
  s->f = fopen(path, "rb");
  if (!s->f || !parse_header(s->f, &s->info)) {
    if (s->f) fclose(s->f);
    delete s;
    return nullptr;
  }
  fseek(s->f, static_cast<long>(s->info.data_offset), SEEK_SET);
  s->cap = static_cast<size_t>(capacity_values);
  s->ring.resize(s->cap);
  s->producer = std::thread(producer_loop, s);
  return s;
}

int dsr_stream_channels(void* h) { return static_cast<SampleStream*>(h)->info.channels; }
int dsr_stream_rate(void* h) { return static_cast<SampleStream*>(h)->info.sample_rate; }

// Pops exactly `values` floats (blocking); returns count actually written
// (< values only at end of stream; trailing shortfall zero-filled).
long long dsr_stream_pop(void* h, float* out, long long values) {
  auto* s = static_cast<SampleStream*>(h);
  long long written = 0;
  while (written < values) {
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_data.wait(lk, [&] { return s->used() > 0 || s->done.load(); });
    size_t avail = s->used();
    if (avail == 0 && s->done.load()) break;
    size_t n = std::min<size_t>(avail, static_cast<size_t>(values - written));
    for (size_t i = 0; i < n; ++i)
      out[written + i] = s->ring[(s->tail.load() + i) % s->cap];
    s->tail.store(s->tail.load() + n);
    written += static_cast<long long>(n);
    s->cv_space.notify_all();
  }
  for (long long i = written; i < values; ++i) out[i] = 0.0f;
  return written;
}

void dsr_stream_close(void* h) {
  auto* s = static_cast<SampleStream*>(h);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->closing.store(true);
    s->cv_space.notify_all();
  }
  if (s->producer.joinable()) s->producer.join();
  if (s->f) fclose(s->f);
  delete s;
}

}  // extern "C"
