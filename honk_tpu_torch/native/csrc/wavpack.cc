// Native batched WAV decoder/packer for corpus loading (the port's copy of
// honk_tpu/native/wavpack.cc, built by honk_tpu_torch/native/wavpack.py).
//
// The whole corpus is decoded once at startup into a packed int16 array
// that the training loop moves to the device, so decode throughput gates
// only startup time; this loader spreads the decode over a thread pool.
//
// C ABI (ctypes, see wavpack.py):
//   wavpack_load_files(paths, n_files, target_len, out, lengths, rates, n_threads)
//     paths:   array of n_files NUL-terminated file paths
//     out:     preallocated n_files * target_len int16 buffer (zero-padded)
//     lengths: per-file decoded sample count, or -1 on error
//     rates:   per-file sample rate (may be null)
//   returns number of successfully decoded files.
//
// Supports RIFF/WAVE PCM16 (mono or multi-channel, averaged to mono) and
// PCM8; ignores unknown chunks (LIST, fact, ...). Sample rate is reported
// in rates[] for the caller to validate; no resampling here.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavData {
  int sample_rate = 0;
  int n_samples = 0;  // decoded (mono) samples actually written
};

// Reads little-endian u32/u16 from a byte buffer.
static inline uint32_t rd_u32(const unsigned char* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static inline uint16_t rd_u16(const unsigned char* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Decode one wav file into out[0..target_len), zero-padding the tail.
// Returns decoded mono sample count (clamped to target_len), or -1.
static int decode_wav(const char* path, int target_len, int16_t* out,
                      int* sample_rate_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 44) {
    std::fclose(f);
    return -1;
  }
  std::vector<unsigned char> buf((size_t)size);
  if (std::fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  if (std::memcmp(buf.data(), "RIFF", 4) != 0 ||
      std::memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return -1;

  uint16_t audio_format = 0, n_channels = 0, bits = 0;
  uint32_t sample_rate = 0;
  const unsigned char* data = nullptr;
  uint32_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= (size_t)size) {
    const unsigned char* hdr = buf.data() + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const unsigned char* body = hdr + 8;
    if (std::memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16) {
      audio_format = rd_u16(body);
      n_channels = rd_u16(body + 2);
      sample_rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      data = body;
      data_len = chunk_len;
      if ((size_t)(body - buf.data()) + data_len > (size_t)size)
        data_len = (uint32_t)(size - (body - buf.data()));
      break;  // fmt always precedes data in practice
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }
  // WAVE_FORMAT_EXTENSIBLE (0xFFFE) wraps PCM; accept if bits match.
  if (!data || n_channels == 0 ||
      (audio_format != 1 && audio_format != 0xFFFE))
    return -1;
  if (sample_rate_out) *sample_rate_out = (int)sample_rate;

  int n_frames;
  if (bits == 16) {
    n_frames = (int)(data_len / (2 * n_channels));
  } else if (bits == 8) {
    n_frames = (int)(data_len / n_channels);
  } else {
    return -1;
  }
  int n = n_frames < target_len ? n_frames : target_len;

  if (bits == 16) {
    const unsigned char* p = data;
    if (n_channels == 1) {
      std::memcpy(out, p, (size_t)n * 2);  // already little-endian int16
    } else {
      for (int i = 0; i < n; ++i) {
        int32_t acc = 0;
        for (int c = 0; c < n_channels; ++c)
          acc += (int16_t)rd_u16(p + (size_t)(i * n_channels + c) * 2);
        out[i] = (int16_t)(acc / n_channels);
      }
    }
  } else {  // PCM8 unsigned
    for (int i = 0; i < n; ++i) {
      int32_t acc = 0;
      for (int c = 0; c < n_channels; ++c)
        acc += ((int)data[(size_t)i * n_channels + c] - 128) << 8;
      out[i] = (int16_t)(acc / n_channels);
    }
  }
  if (n < target_len) std::memset(out + n, 0, (size_t)(target_len - n) * 2);
  return n;
}

}  // namespace

extern "C" {

int wavpack_load_files(const char** paths, int n_files, int target_len,
                       int16_t* out, int* lengths, int* rates,
                       int n_threads) {
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n_files) n_threads = n_files > 0 ? n_files : 1;

  std::atomic<int> next(0), ok(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_files) return;
      int sr = 0;
      int n = decode_wav(paths[i], target_len, out + (size_t)i * target_len, &sr);
      lengths[i] = n;
      if (rates) rates[i] = sr;
      if (n < 0) {
        std::memset(out + (size_t)i * target_len, 0, (size_t)target_len * 2);
      } else {
        ok.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve((size_t)n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return ok.load();
}

}  // extern "C"
