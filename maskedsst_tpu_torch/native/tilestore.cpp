// Packed hyperspectral tile store: the native reader of the PyTorch port
// (the same file format as the JAX package's reader, so that a file either
// package packs, the other reads).
//
// Tiles are served from one packed, memory-mapped binary file instead of
// one GeoTIFF read per tile and epoch: a batch gather is a set of parallel
// copies, optionally fused with band-wise standardization and cropping.
//
// File layout (little-endian):
//   magic   "MSTS"            4 bytes
//   version u32               (1)
//   n_tiles u32
//   bands   u32
//   height  u32
//   width   u32
//   flags   u32               bit0: labels present
//   reserved u32               (header is 8 u32 fields = 32 bytes total)
//   data    f32[n_tiles, bands, height, width]
//   labels  i32[n_tiles, height, width]        (if flags & 1)
//
// Standardization computes (x - mean[b]) * (1.0f / std[b]) in fp32, which the
// numpy reader of tilestore.py repeats bit for bit.
//
// C ABI (ctypes-friendly); thread-safe for concurrent gathers on one handle.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x5354534Du;  // "MSTS" little-endian
constexpr uint32_t kHeaderBytes = 32;

struct Store {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t mapped_bytes = 0;
  uint32_t n_tiles = 0, bands = 0, height = 0, width = 0, flags = 0;

  size_t tile_floats() const {
    return static_cast<size_t>(bands) * height * width;
  }
  const float* tile(size_t idx) const {
    return reinterpret_cast<const float*>(base + kHeaderBytes) +
           idx * tile_floats();
  }
  const int32_t* label(size_t idx) const {
    const uint8_t* labels_base =
        base + kHeaderBytes + sizeof(float) * n_tiles * tile_floats();
    return reinterpret_cast<const int32_t*>(labels_base) +
           idx * static_cast<size_t>(height) * width;
  }
};

void parallel_for(int64_t n, int threads, const std::function<void(int64_t)>& fn) {
  if (threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  int use = std::min<int64_t>(threads, n);
  pool.reserve(use);
  for (int t = 0; t < use; ++t) {
    pool.emplace_back([&] {
      while (true) {
        int64_t i = next.fetch_add(1);
        if (i >= n) break;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Opens a packed store; returns an opaque handle or nullptr.
void* ts_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) < kHeaderBytes) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(base);
  s->mapped_bytes = st.st_size;
  const uint32_t* h = reinterpret_cast<const uint32_t*>(base);
  if (h[0] != kMagic || h[1] != 1) {
    munmap(base, st.st_size);
    ::close(fd);
    delete s;
    return nullptr;
  }
  s->n_tiles = h[2];
  s->bands = h[3];
  s->height = h[4];
  s->width = h[5];
  s->flags = h[6];
  size_t want = kHeaderBytes + sizeof(float) * s->n_tiles * s->tile_floats();
  if (s->flags & 1) {
    want += sizeof(int32_t) * s->n_tiles * static_cast<size_t>(s->height) * s->width;
  }
  if (s->mapped_bytes < want) {
    munmap(base, st.st_size);
    ::close(fd);
    delete s;
    return nullptr;
  }
  return s;
}

void ts_close(void* handle) {
  auto* s = static_cast<Store*>(handle);
  if (!s) return;
  munmap(const_cast<uint8_t*>(s->base), s->mapped_bytes);
  ::close(s->fd);
  delete s;
}

// info[0..4] = n_tiles, bands, height, width, has_labels
void ts_info(void* handle, uint32_t* info) {
  auto* s = static_cast<Store*>(handle);
  info[0] = s->n_tiles;
  info[1] = s->bands;
  info[2] = s->height;
  info[3] = s->width;
  info[4] = s->flags & 1;
}

// Gather n whole tiles into out [n, bands, height, width].
// mean/std (length bands) are optional band-wise standardization; pass
// nullptr to copy raw. Returns 0 on success.
int ts_gather(void* handle, const int32_t* idx, int64_t n, float* out,
              const float* mean, const float* stdv, int threads) {
  auto* s = static_cast<Store*>(handle);
  const size_t tf = s->tile_floats();
  const size_t plane = static_cast<size_t>(s->height) * s->width;
  std::atomic<int> bad(0);
  parallel_for(n, threads, [&](int64_t i) {
    int32_t t = idx[i];
    if (t < 0 || static_cast<uint32_t>(t) >= s->n_tiles) {
      bad.store(1);
      return;
    }
    const float* src = s->tile(t);
    float* dst = out + i * tf;
    if (!mean || !stdv) {
      std::memcpy(dst, src, tf * sizeof(float));
    } else {
      for (uint32_t b = 0; b < s->bands; ++b) {
        const float m = mean[b];
        const float inv = 1.0f / stdv[b];
        const float* sp = src + b * plane;
        float* dp = dst + b * plane;
        for (size_t p = 0; p < plane; ++p) dp[p] = (sp[p] - m) * inv;
      }
    }
  });
  return bad.load();
}

// Gather n cropped tiles: out [n, bands, size, size]; (x, y) per tile.
int ts_gather_crop(void* handle, const int32_t* idx, const int32_t* xs,
                   const int32_t* ys, int64_t n, int32_t size, float* out,
                   const float* mean, const float* stdv, int threads) {
  auto* s = static_cast<Store*>(handle);
  const size_t plane = static_cast<size_t>(s->height) * s->width;
  const size_t out_tile = static_cast<size_t>(s->bands) * size * size;
  std::atomic<int> bad(0);
  parallel_for(n, threads, [&](int64_t i) {
    int32_t t = idx[i];
    int32_t x = xs[i], y = ys[i];
    if (t < 0 || static_cast<uint32_t>(t) >= s->n_tiles || x < 0 || y < 0 ||
        x + size > static_cast<int32_t>(s->height) ||
        y + size > static_cast<int32_t>(s->width)) {
      bad.store(1);
      return;
    }
    const float* src = s->tile(t);
    float* dst = out + i * out_tile;
    for (uint32_t b = 0; b < s->bands; ++b) {
      const float m = mean ? mean[b] : 0.0f;
      const float inv = stdv ? 1.0f / stdv[b] : 1.0f;
      const float* sp = src + b * plane + static_cast<size_t>(x) * s->width + y;
      float* dp = dst + static_cast<size_t>(b) * size * size;
      for (int32_t r = 0; r < size; ++r) {
        if (mean && stdv) {
          for (int32_t c2 = 0; c2 < size; ++c2) dp[c2] = (sp[c2] - m) * inv;
        } else {
          std::memcpy(dp, sp, size * sizeof(float));
        }
        sp += s->width;
        dp += size;
      }
    }
  });
  return bad.load();
}

// Gather labels for n tiles into out [n, height, width]. Returns 0 on ok,
// 2 when the store has no labels.
int ts_gather_labels(void* handle, const int32_t* idx, int64_t n, int32_t* out,
                     int threads) {
  auto* s = static_cast<Store*>(handle);
  if (!(s->flags & 1)) return 2;
  const size_t plane = static_cast<size_t>(s->height) * s->width;
  std::atomic<int> bad(0);
  parallel_for(n, threads, [&](int64_t i) {
    int32_t t = idx[i];
    if (t < 0 || static_cast<uint32_t>(t) >= s->n_tiles) {
      bad.store(1);
      return;
    }
    std::memcpy(out + i * plane, s->label(t), plane * sizeof(int32_t));
  });
  return bad.load();
}

}  // extern "C"
