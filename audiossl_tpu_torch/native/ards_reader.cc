// Native batched reader for .ards packs (audiossl_tpu_torch/datasets/
// packed.py; the port's own copy of native/ards_reader.cc, built by
// audiossl_tpu_torch/datasets/native.py).
//
// The reference feeds its trainers from LMDB via per-sample Python
// deserialization in DataLoader workers (reference datasets/lmdb.py).
// This reader assembles whole padded batches off the GIL: mmap the pack,
// parse the .idx (npy uint64 offsets), and gather + convert (int16 ->
// float32/32768 or int16 as stored, channel mean) with a thread pool.
//
// C ABI (ctypes):
//   void*  ards_open(const char* pack_path);
//   long   ards_len(void* h);
//   long   ards_num_samples(void* h, long i);
//   int    ards_read_batch(void* h, const long* idx, int n,
//                          long pad_samples, int n_threads,
//                          float* out_wav, int* out_valid);
//   int    ards_read_batch_i16(void* h, const long* idx, int n,
//                              long pad_samples, int n_threads,
//                              int16_t* out_wav, int* out_valid);
//   void   ards_close(void* h);
//
// Returns 0 on success, negative error codes otherwise.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Header {
  uint32_t wav_bytes;
  uint32_t label_bytes;
  uint8_t dtype;    // 0=int16, 1=float32
  uint8_t channels;
  uint16_t _pad;
  uint32_t sample_rate;
  uint8_t _reserved[8];
} __attribute__((packed));

static_assert(sizeof(Header) == 24, "header must be 24 bytes");

struct Pack {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;
  std::vector<uint64_t> offsets;
};

// Minimal .npy parser for a 1-D little-endian uint64 array.
bool load_npy_u64(const std::string& path, std::vector<uint64_t>* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  uint8_t magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    fclose(f);
    return false;
  }
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    uint16_t h16;
    if (fread(&h16, 2, 1, f) != 1) { fclose(f); return false; }
    hlen = h16;
  } else {
    if (fread(&hlen, 4, 1, f) != 1) { fclose(f); return false; }
  }
  std::string header(hlen, '\0');
  if (fread(&header[0], 1, hlen, f) != hlen) { fclose(f); return false; }
  if (header.find("'<u8'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    fclose(f);
    return false;
  }
  // read the rest of the file as u64 payload
  long pos = ftell(f);
  fseek(f, 0, SEEK_END);
  long end = ftell(f);
  fseek(f, pos, SEEK_SET);
  size_t count = (end - pos) / 8;
  out->resize(count);
  bool ok = fread(out->data(), 8, count, f) == count;
  fclose(f);
  return ok;
}

inline const Header* record(const Pack* p, long i) {
  return reinterpret_cast<const Header*>(p->data + p->offsets[i]);
}

void decode_one(const Pack* p, long rec_idx, long pad_samples,
                float* out, int32_t* valid) {
  const Header* h = record(p, rec_idx);
  const uint8_t* payload =
      reinterpret_cast<const uint8_t*>(h) + sizeof(Header);
  int ch = h->channels ? h->channels : 1;
  long n;
  if (h->dtype == 0) {
    n = h->wav_bytes / 2 / ch;
  } else {
    n = h->wav_bytes / 4 / ch;
  }
  long keep = n < pad_samples ? n : pad_samples;
  if (h->dtype == 0) {
    const int16_t* w = reinterpret_cast<const int16_t*>(payload);
    if (ch == 1) {
      for (long t = 0; t < keep; ++t) out[t] = w[t] * (1.0f / 32768.0f);
    } else {
      for (long t = 0; t < keep; ++t) {
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) acc += w[c * n + t];
        out[t] = acc / ch * (1.0f / 32768.0f);
      }
    }
  } else {
    const float* w = reinterpret_cast<const float*>(payload);
    if (ch == 1) {
      memcpy(out, w, keep * sizeof(float));
    } else {
      for (long t = 0; t < keep; ++t) {
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) acc += w[c * n + t];
        out[t] = acc / ch;
      }
    }
  }
  if (keep < pad_samples)
    memset(out + keep, 0, (pad_samples - keep) * sizeof(float));
  *valid = static_cast<int32_t>(keep);
}

void decode_one_i16(const Pack* p, long rec_idx, long pad_samples,
                    int16_t* out, int32_t* valid) {
  // int16 emit: halves the host->device batch bytes (the device
  // dequantizes with the same /32768 scale, bitwise-identical f32).
  // float32 records are re-quantized to 16 bits (source audio is
  // 16-bit PCM in practice; see datasets/pipeline.py wav_dtype).
  const Header* h = record(p, rec_idx);
  const uint8_t* payload =
      reinterpret_cast<const uint8_t*>(h) + sizeof(Header);
  int ch = h->channels ? h->channels : 1;
  long n = h->dtype == 0 ? h->wav_bytes / 2 / ch : h->wav_bytes / 4 / ch;
  long keep = n < pad_samples ? n : pad_samples;
  auto q = [](float v) {
    float s = v * 32768.0f;
    if (s > 32767.f) s = 32767.f;
    if (s < -32768.f) s = -32768.f;
    return static_cast<int16_t>(s);
  };
  if (h->dtype == 0) {
    const int16_t* w = reinterpret_cast<const int16_t*>(payload);
    if (ch == 1) {
      memcpy(out, w, keep * sizeof(int16_t));
    } else {
      for (long t = 0; t < keep; ++t) {
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) acc += w[c * n + t];
        out[t] = static_cast<int16_t>(acc / ch);
      }
    }
  } else {
    const float* w = reinterpret_cast<const float*>(payload);
    if (ch == 1) {
      for (long t = 0; t < keep; ++t) out[t] = q(w[t]);
    } else {
      for (long t = 0; t < keep; ++t) {
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) acc += w[c * n + t];
        out[t] = q(acc / ch);
      }
    }
  }
  if (keep < pad_samples)
    memset(out + keep, 0, (pad_samples - keep) * sizeof(int16_t));
  *valid = static_cast<int32_t>(keep);
}

}  // namespace

extern "C" {

void* ards_open(const char* pack_path) {
  auto* p = new Pack();
  if (!load_npy_u64(std::string(pack_path) + ".idx", &p->offsets)) {
    delete p;
    return nullptr;
  }
  p->fd = open(pack_path, O_RDONLY);
  if (p->fd < 0) {
    delete p;
    return nullptr;
  }
  struct stat st;
  fstat(p->fd, &st);
  p->size = st.st_size;
  p->data = static_cast<const uint8_t*>(
      mmap(nullptr, p->size, PROT_READ, MAP_PRIVATE, p->fd, 0));
  if (p->data == MAP_FAILED) {
    close(p->fd);
    delete p;
    return nullptr;
  }
  madvise(const_cast<uint8_t*>(p->data), p->size, MADV_WILLNEED);
  return p;
}

long ards_len(void* h) {
  auto* p = static_cast<Pack*>(h);
  return static_cast<long>(p->offsets.size()) - 1;
}

long ards_num_samples(void* h, long i) {
  auto* p = static_cast<Pack*>(h);
  const Header* r = record(p, i);
  int ch = r->channels ? r->channels : 1;
  return r->dtype == 0 ? r->wav_bytes / 2 / ch : r->wav_bytes / 4 / ch;
}

int ards_read_batch(void* h, const long* idx, int n, long pad_samples,
                    int n_threads, float* out_wav, int* out_valid) {
  auto* p = static_cast<Pack*>(h);
  long num = ards_len(h);
  for (int i = 0; i < n; ++i)
    if (idx[i] < 0 || idx[i] >= num) return -2;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      decode_one(p, idx[i], pad_samples, out_wav + (long)i * pad_samples,
                 out_valid + i);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  return 0;
}

int ards_read_batch_i16(void* h, const long* idx, int n,
                        long pad_samples, int n_threads,
                        int16_t* out_wav, int* out_valid) {
  auto* p = static_cast<Pack*>(h);
  long num = ards_len(h);
  for (int i = 0; i < n; ++i)
    if (idx[i] < 0 || idx[i] >= num) return -2;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      decode_one_i16(p, idx[i], pad_samples,
                     out_wav + (long)i * pad_samples, out_valid + i);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; ++t) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  return 0;
}

void ards_close(void* h) {
  auto* p = static_cast<Pack*>(h);
  if (p->data && p->data != MAP_FAILED)
    munmap(const_cast<uint8_t*>(p->data), p->size);
  if (p->fd >= 0) close(p->fd);
  delete p;
}

}  // extern "C"
