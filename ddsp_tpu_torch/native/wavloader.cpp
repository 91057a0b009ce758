// Parallel WAV corpus decoder for the dataset-build path.
//
// The reference parallelizes audio ingest with DataLoader(num_workers=4)
// worker processes (reference: train/train.py:48, dataset/audio_dataset.py);
// the native equivalent here is a std::thread pool that RIFF-parses,
// PCM/float-decodes, and mono-mixes every file of a corpus concurrently.
// Decode semantics mirror ddsp_tpu_torch/data/audio_io.read_wav exactly
// (per-bit-depth scaling, WAVE_FORMAT_EXTENSIBLE tag resolution, trailing
// partial-frame truncation) so the native and Python paths agree
// bit-for-bit (tests/test_torch_native.py).  A copy of the JAX package's
// ddsp_tpu/native/wavloader.cpp.
//
// C ABI (bound via ctypes in ddsp_tpu_torch/native/__init__.py):
//   corpus_load(paths, n_files, n_threads) -> Corpus*
//   corpus_samples / corpus_rate / corpus_error / corpus_copy / corpus_free

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

struct FileResult {
  std::vector<float> mono;
  uint32_t rate = 0;
  std::string error;
};

void decode_wav(const std::string& path, FileResult* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    out->error = "open failed";
    return;
  }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz < 12) {
    fclose(f);
    out->error = "file too short";
    return;
  }
  std::vector<uint8_t> data(static_cast<size_t>(sz));
  size_t got = fread(data.data(), 1, data.size(), f);
  fclose(f);
  data.resize(got);
  if (data.size() < 12 || memcmp(data.data(), "RIFF", 4) != 0 ||
      memcmp(data.data() + 8, "WAVE", 4) != 0) {
    out->error = "not a WAV file";
    return;
  }

  size_t pos = 12;
  bool have_fmt = false;
  uint16_t audio_format = 0, n_channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  const uint8_t* raw = nullptr;
  size_t raw_len = 0;
  while (pos + 8 <= data.size()) {
    const uint8_t* chunk = data.data() + pos;
    uint32_t size = rd_u32(chunk + 4);
    size_t body = pos + 8;
    size_t avail = data.size() - body;
    size_t use = size < avail ? size : avail;
    if (memcmp(chunk, "fmt ", 4) == 0 && use >= 16) {
      audio_format = rd_u16(data.data() + body);
      n_channels = rd_u16(data.data() + body + 2);
      sample_rate = rd_u32(data.data() + body + 4);
      bits = rd_u16(data.data() + body + 14);
      if (audio_format == 0xFFFE) {  // WAVE_FORMAT_EXTENSIBLE
        if (use >= 26) {
          audio_format = rd_u16(data.data() + body + 24);
        } else {
          out->error = "EXTENSIBLE fmt with truncated extension";
          return;
        }
      }
      have_fmt = true;
    } else if (memcmp(chunk, "data", 4) == 0) {
      raw = data.data() + body;
      raw_len = use;
    }
    pos = body + size + (size & 1);
  }
  if (!have_fmt || raw == nullptr) {
    out->error = "missing fmt/data chunk";
    return;
  }
  if (n_channels == 0) {
    out->error = "zero channels";
    return;
  }

  // Decode to per-sample float32 (interleaved order preserved).
  std::vector<float> flat;
  if (audio_format == 1) {  // integer PCM
    if (bits == 8) {
      flat.resize(raw_len);
      for (size_t i = 0; i < raw_len; ++i)
        flat[i] = (static_cast<float>(raw[i]) - 128.0f) / 127.0f;
    } else if (bits == 16) {
      size_t n = raw_len / 2;
      flat.resize(n);
      for (size_t i = 0; i < n; ++i) {
        int16_t v;
        memcpy(&v, raw + 2 * i, 2);
        flat[i] = static_cast<float>(v) / 32768.0f;
      }
    } else if (bits == 24) {
      size_t n = raw_len / 3;
      flat.resize(n);
      for (size_t i = 0; i < n; ++i) {
        const uint8_t* b = raw + 3 * i;
        int32_t v = static_cast<int32_t>(b[0]) |
                    (static_cast<int32_t>(b[1]) << 8) |
                    (static_cast<int32_t>(b[2]) << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        flat[i] = static_cast<float>(v) / 8388608.0f;  // 2^23
      }
    } else if (bits == 32) {
      size_t n = raw_len / 4;
      flat.resize(n);
      for (size_t i = 0; i < n; ++i) {
        int32_t v;
        memcpy(&v, raw + 4 * i, 4);
        flat[i] = static_cast<float>(v) / 2147483648.0f;  // 2^31
      }
    } else {
      out->error = "unsupported PCM bit depth";
      return;
    }
  } else if (audio_format == 3) {  // IEEE float
    if (bits == 32) {
      size_t n = raw_len / 4;
      flat.resize(n);
      memcpy(flat.data(), raw, n * 4);
    } else {
      size_t n = raw_len / 8;
      flat.resize(n);
      for (size_t i = 0; i < n; ++i) {
        double v;
        memcpy(&v, raw + 8 * i, 8);
        flat[i] = static_cast<float>(v);
      }
    }
  } else {
    out->error = "unsupported WAV format tag";
    return;
  }

  // Mono mix: drop any trailing partial frame, mean over channels
  // (float32 accumulation, matching numpy's mean over a small axis).
  size_t frames = flat.size() / n_channels;
  out->mono.resize(frames);
  if (n_channels == 1) {
    memcpy(out->mono.data(), flat.data(), frames * 4);
  } else {
    float inv = 1.0f / static_cast<float>(n_channels);
    for (size_t i = 0; i < frames; ++i) {
      float acc = 0.0f;
      for (uint16_t c = 0; c < n_channels; ++c)
        acc += flat[i * n_channels + c];
      out->mono[i] = acc * inv;
    }
  }
  out->rate = sample_rate;
}

}  // namespace

extern "C" {

struct Corpus {
  std::vector<FileResult> files;
};

Corpus* corpus_load(const char** paths, uint64_t n_files, int n_threads) {
  Corpus* c = new Corpus();
  c->files.resize(n_files);
  std::vector<std::string> names(n_files);
  for (uint64_t i = 0; i < n_files; ++i) names[i] = paths[i];
  if (n_threads < 1) n_threads = 1;
  unsigned hw = std::thread::hardware_concurrency();
  if (hw && static_cast<unsigned>(n_threads) > hw) n_threads = hw;
  std::atomic<uint64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      uint64_t i = next.fetch_add(1);
      if (i >= n_files) return;
      decode_wav(names[i], &c->files[i]);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return c;
}

uint64_t corpus_samples(Corpus* c, uint64_t i) {
  return i < c->files.size() ? c->files[i].mono.size() : 0;
}

uint32_t corpus_rate(Corpus* c, uint64_t i) {
  return i < c->files.size() ? c->files[i].rate : 0;
}

uint64_t corpus_error(Corpus* c, uint64_t i, char* buf, uint64_t cap) {
  if (i >= c->files.size()) return 0;
  const std::string& e = c->files[i].error;
  if (buf && cap) {
    uint64_t n = e.size() < cap - 1 ? e.size() : cap - 1;
    memcpy(buf, e.data(), n);
    buf[n] = 0;
  }
  return e.size();
}

void corpus_copy(Corpus* c, uint64_t i, float* out) {
  if (i < c->files.size() && !c->files[i].mono.empty())
    memcpy(out, c->files[i].mono.data(), c->files[i].mono.size() * 4);
}

void corpus_free(Corpus* c) { delete c; }

}  // extern "C"
