// Native IO runtime for shennong_tpu_torch (a copy of the JAX
// package's shennong_tpu/native/shennong_io.cpp).
//
// Host-side data loading is the one part of the pipeline that stays
// off the device; this library implements it in C++ with a thread pool:
//
//  - batched WAV loading: decode N PCM16/PCM32/float32 WAV files
//    concurrently straight into a caller-provided padded float32
//    batch (the executor's device upload buffer), including optional
//    segment extraction — replacing the per-file Python
//    scipy.io.wavfile path;
//  - Kaldi ark scanning/reading: index the records of a binary ark
//    file and bulk-read matrices without per-byte Python loops.
//
// Exposed as a plain C ABI consumed through ctypes
// (shennong_tpu_torch/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = 0;      // file offset of the sample data
  uint32_t data_bytes = 0;
};

// Parse the RIFF header chunks until the data chunk is located.
bool parse_wav_header(std::FILE* fp, WavInfo* info) {
  char magic[4];
  uint32_t riff_size;
  if (std::fread(magic, 1, 4, fp) != 4 || std::memcmp(magic, "RIFF", 4))
    return false;
  if (std::fread(&riff_size, 4, 1, fp) != 1) return false;
  if (std::fread(magic, 1, 4, fp) != 4 || std::memcmp(magic, "WAVE", 4))
    return false;

  while (true) {
    char chunk_id[4];
    uint32_t chunk_size;
    if (std::fread(chunk_id, 1, 4, fp) != 4) return false;
    if (std::fread(&chunk_size, 4, 1, fp) != 1) return false;

    if (!std::memcmp(chunk_id, "fmt ", 4)) {
      uint8_t fmt[16];
      if (chunk_size < 16 || std::fread(fmt, 1, 16, fp) != 16)
        return false;
      std::memcpy(&info->format, fmt + 0, 2);
      std::memcpy(&info->channels, fmt + 2, 2);
      std::memcpy(&info->sample_rate, fmt + 4, 4);
      std::memcpy(&info->bits, fmt + 14, 2);
      if (chunk_size > 16) std::fseek(fp, chunk_size - 16, SEEK_CUR);
    } else if (!std::memcmp(chunk_id, "data", 4)) {
      info->data_offset = std::ftell(fp);
      info->data_bytes = chunk_size;
      // reject malformed headers whose bits/channels would divide
      // by zero in every caller (hostile or truncated fmt chunks)
      return info->format != 0 && info->bits >= 8 &&
             info->channels > 0;
    } else {
      // chunks are word aligned
      std::fseek(fp, chunk_size + (chunk_size & 1), SEEK_CUR);
    }
  }
}

// Decode one mono WAV segment into int16-range float32.
// Returns the number of samples written, or -1 on error.
int64_t load_wav_segment(const char* path, int64_t start_sample,
                         int64_t max_samples, float* out) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  WavInfo info;
  if (!parse_wav_header(fp, &info) || info.channels != 1) {
    std::fclose(fp);
    return -1;
  }

  const int bytes_per = info.bits / 8;
  int64_t total = info.data_bytes / bytes_per;
  if (start_sample >= total) {
    std::fclose(fp);
    return 0;
  }
  int64_t count = std::min<int64_t>(total - start_sample, max_samples);
  std::fseek(fp, info.data_offset + start_sample * bytes_per, SEEK_SET);

  std::vector<uint8_t> raw(count * bytes_per);
  if (std::fread(raw.data(), 1, raw.size(), fp) != raw.size()) {
    std::fclose(fp);
    return -1;
  }
  std::fclose(fp);

  if (info.format == 1 && info.bits == 16) {
    const int16_t* samples =
        reinterpret_cast<const int16_t*>(raw.data());
    for (int64_t i = 0; i < count; ++i)
      out[i] = static_cast<float>(samples[i]);
  } else if (info.format == 1 && info.bits == 32) {
    const int32_t* samples =
        reinterpret_cast<const int32_t*>(raw.data());
    // int32 -> int16 range, truncated toward zero exactly like the
    // Python path's astype(int16)
    for (int64_t i = 0; i < count; ++i)
      out[i] = std::trunc(static_cast<float>(
          static_cast<double>(samples[i]) / 32768.0));
  } else if (info.format == 3 && info.bits == 32) {
    const float* samples = reinterpret_cast<const float*>(raw.data());
    // float [-1, 1] -> int16 range, truncated like astype(int16)
    for (int64_t i = 0; i < count; ++i)
      out[i] = std::trunc(samples[i] * 32768.0f);
  } else {
    return -1;
  }
  return count;
}

}  // namespace

extern "C" {

// Scan a WAV header: fills (channels, sample_rate, nsamples), returns
// 0 on success.
int shennong_wav_scan(const char* path, int32_t* channels,
                      int32_t* sample_rate, int64_t* nsamples) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  WavInfo info;
  bool ok = parse_wav_header(fp, &info);
  std::fclose(fp);
  if (!ok) return -1;
  *channels = info.channels;
  *sample_rate = info.sample_rate;
  *nsamples = info.data_bytes / (info.bits / 8) / info.channels;
  return 0;
}

// Scan a WAV header with format details: fills (channels,
// sample_rate, nsamples, format, bits), returns 0 on success.
// format is the WAV tag: 1 = PCM, 3 = IEEE float.
int shennong_wav_scan2(const char* path, int32_t* channels,
                       int32_t* sample_rate, int64_t* nsamples,
                       int32_t* format, int32_t* bits) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  WavInfo info;
  bool ok = parse_wav_header(fp, &info);
  std::fclose(fp);
  if (!ok) return -1;
  *channels = info.channels;
  *sample_rate = info.sample_rate;
  *nsamples = info.data_bytes / (info.bits / 8) / info.channels;
  *format = info.format;
  *bits = info.bits;
  return 0;
}

// Load a batch of mono PCM16 WAV segments concurrently into a padded
// int16 matrix [batch, row_stride]. The int16 variant exists because
// PCM16 is by far the common case and a straight 2-byte copy halves
// the fresh pages the host must touch compared to the float32 path
// (page faults dominate bulk loads on slow-memory hosts) AND halves
// the later host-device upload. Non-PCM16 rows fail (the caller then
// falls back to the float32 loader for the whole batch, keeping the
// exact truncation semantics of shennong_load_wav_batch).
//
//   out: [batch * row_stride] int16, zero-padded rows
//
// Returns the number of rows that failed.
int shennong_load_wav_batch_i16(const char* paths, int32_t batch,
                                const int64_t* start_samples,
                                const int64_t* max_counts,
                                int64_t row_stride, int16_t* out,
                                int64_t* out_counts,
                                int32_t num_threads) {
  std::vector<const char*> path_list(batch);
  const char* cursor = paths;
  for (int32_t i = 0; i < batch; ++i) {
    path_list[i] = cursor;
    cursor += std::strlen(cursor) + 1;
  }

  std::atomic<int32_t> next(0), failures(0);
  auto worker = [&]() {
    while (true) {
      int32_t row = next.fetch_add(1);
      if (row >= batch) break;
      int16_t* dest = out + static_cast<int64_t>(row) * row_stride;
      int64_t wanted =
          std::min<int64_t>(max_counts[row], row_stride);
      int64_t got = -1;
      std::FILE* fp = std::fopen(path_list[row], "rb");
      if (fp) {
        WavInfo info;
        if (parse_wav_header(fp, &info) && info.channels == 1 &&
            info.format == 1 && info.bits == 16) {
          int64_t total = info.data_bytes / 2;
          int64_t start = start_samples[row];
          int64_t count = start >= total
              ? 0 : std::min<int64_t>(total - start, wanted);
          std::fseek(fp, info.data_offset + start * 2, SEEK_SET);
          if (count == 0 ||
              std::fread(dest, 2, count, fp) ==
                  static_cast<size_t>(count)) {
            got = count;
          }
        }
        std::fclose(fp);
      }
      if (got >= 0 && got < row_stride)
        std::fill(dest + got, dest + row_stride,
                  static_cast<int16_t>(0));
      out_counts[row] = got;
      if (got < 0) failures.fetch_add(1);
    }
  };

  int nthreads = std::max(1, std::min<int>(num_threads, batch));
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int i = 0; i < nthreads; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Load a batch of mono WAV segments concurrently into a padded
// float32 matrix [batch, max_samples] (int16-range values).
//
//   paths:         batch concatenated NUL-terminated path strings
//   start_samples: per-row first sample of the segment
//   max_counts:    per-row maximum samples to read
//   out:           [batch * row_stride] float32, zero-padded rows
//   out_counts:    per-row samples actually read (-1 on failure)
//
// Returns the number of rows that failed.
int shennong_load_wav_batch(const char* paths, int32_t batch,
                            const int64_t* start_samples,
                            const int64_t* max_counts,
                            int64_t row_stride, float* out,
                            int64_t* out_counts, int32_t num_threads) {
  // split the packed path list
  std::vector<const char*> path_list(batch);
  const char* cursor = paths;
  for (int32_t i = 0; i < batch; ++i) {
    path_list[i] = cursor;
    cursor += std::strlen(cursor) + 1;
  }

  std::atomic<int32_t> next(0), failures(0);
  auto worker = [&]() {
    while (true) {
      int32_t row = next.fetch_add(1);
      if (row >= batch) break;
      float* dest = out + static_cast<int64_t>(row) * row_stride;
      std::fill(dest, dest + row_stride, 0.0f);
      int64_t got = load_wav_segment(
          path_list[row], start_samples[row],
          std::min<int64_t>(max_counts[row], row_stride), dest);
      out_counts[row] = got;
      if (got < 0) failures.fetch_add(1);
    }
  };

  int nthreads = std::max(1, std::min<int>(num_threads, batch));
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int i = 0; i < nthreads; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Index a Kaldi binary ark file: for each record store the key, the
// dtype ('F' or 'D'), the matrix dims and the data offset.
//
//   keys_out:   caller buffer receiving NUL-separated keys
//   meta_out:   [max_records * 4] int64 (offset, rows, cols, is_double)
//
// Returns the number of records, or -1 on a parse error.
int64_t shennong_ark_index(const char* path, char* keys_out,
                           int64_t keys_capacity, int64_t* meta_out,
                           int64_t max_records) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;

  int64_t count = 0;
  int64_t keys_used = 0;
  while (count < max_records) {
    // read the key up to the space separator
    std::string key;
    int c;
    while ((c = std::fgetc(fp)) != EOF && c != ' ')
      key.push_back(static_cast<char>(c));
    if (c == EOF) break;

    char marker[2];
    char token[3];
    if (std::fread(marker, 1, 2, fp) != 2 || marker[0] != '\0' ||
        marker[1] != 'B') {
      std::fclose(fp);
      return -1;
    }
    if (std::fread(token, 1, 3, fp) != 3) {
      std::fclose(fp);
      return -1;
    }
    bool is_double = token[0] == 'D';

    auto read_int = [&](int32_t* value) {
      int size = std::fgetc(fp);
      return size == 4 && std::fread(value, 4, 1, fp) == 1;
    };
    int32_t rows, cols;
    if (!read_int(&rows) || !read_int(&cols)) {
      std::fclose(fp);
      return -1;
    }

    if (keys_used + static_cast<int64_t>(key.size()) + 1 >
        keys_capacity) {
      std::fclose(fp);
      return -1;
    }
    std::memcpy(keys_out + keys_used, key.c_str(), key.size() + 1);
    keys_used += key.size() + 1;

    meta_out[count * 4 + 0] = std::ftell(fp);
    meta_out[count * 4 + 1] = rows;
    meta_out[count * 4 + 2] = cols;
    meta_out[count * 4 + 3] = is_double ? 1 : 0;
    ++count;

    int64_t bytes =
        static_cast<int64_t>(rows) * cols * (is_double ? 8 : 4);
    std::fseek(fp, bytes, SEEK_CUR);
  }
  std::fclose(fp);
  return count;
}

// Bulk-read one matrix record given its offset (from
// shennong_ark_index) into a caller buffer. Returns 0 on success.
int shennong_ark_read(const char* path, int64_t offset, int64_t bytes,
                      void* out) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::fseek(fp, offset, SEEK_SET);
  size_t got = std::fread(out, 1, static_cast<size_t>(bytes), fp);
  std::fclose(fp);
  return got == static_cast<size_t>(bytes) ? 0 : -1;
}

// Bulk-read one double-matrix record converted to float32. Converting
// through a small staging buffer touches each destination page once;
// reading the doubles into a fresh numpy array and calling astype
// afterwards would write (and fault in) 3x the bytes.
int shennong_ark_read_f32(const char* path, int64_t offset,
                          int64_t count, float* out) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::fseek(fp, offset, SEEK_SET);

  constexpr int64_t kStage = 1 << 16;  // 64k doubles = 512 KB
  std::vector<double> buffer(static_cast<size_t>(
      count < kStage ? count : kStage));
  int64_t done = 0;
  while (done < count) {
    const int64_t chunk =
        (count - done) < kStage ? (count - done) : kStage;
    const size_t got = std::fread(
        buffer.data(), sizeof(double), static_cast<size_t>(chunk), fp);
    if (got != static_cast<size_t>(chunk)) {
      std::fclose(fp);
      return -1;
    }
    for (int64_t i = 0; i < chunk; ++i)
      out[done + i] = static_cast<float>(buffer[i]);
    done += chunk;
  }
  std::fclose(fp);
  return 0;
}

}  // extern "C"
