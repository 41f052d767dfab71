// Helpers shared by the package's CUDA kernels: fp32 <-> storage-type
// conversion, rounding to the compute type, warp reductions, and the error
// string export that the Python bindings use to report a failed launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace msst {

constexpr float kLnEps = 1e-5f;  // torch nn.LayerNorm default, fp32 statistics

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to the compute type C and widened back: the cast the TPU kernels
// apply to every matmul operand before an fp32-accumulated product
template <typename C> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<C>(v));
}

// v rounded to C and stored as O (O is fp32, or C itself)
template <typename C, typename O> __device__ __forceinline__ O rounded(float v) {
  return from_f<O>(round_to<C>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The buffers of a kernel's plan by level (the layer kernels): each level
// moves one more buffer, the first `level` bits of `order`, from shared
// memory to the block's scratch in device memory.
__host__ __device__ inline unsigned spill_bits(const unsigned* order, int level) {
  unsigned bits = 0;
  for (int i = 0; i < level; ++i) bits |= order[i];
  return bits;
}

// Bump allocators over shared memory and the block's device scratch: a
// buffer whose bit is in `spill` goes to the scratch; sizes rounded up to
// `align` (units are the caller's: bytes or floats).
struct Placer {
  unsigned spill;
  size_t align;
  size_t shared = 0, device = 0;

  __host__ __device__ Placer(unsigned spill_, size_t align_) : spill(spill_), align(align_) {}
  __host__ __device__ size_t put(size_t n, unsigned bit) {
    size_t& off = (spill & bit) ? device : shared;
    const size_t at = off;
    off += (n + align - 1) / align * align;
    return at;
  }
};

__device__ __forceinline__ float gelu(float u) {  // exact (erf) GELU
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float u) {
  return 0.5f * (1.f + erff(u * 0.70710678118654752f)) +
         u * expf(-0.5f * u * u) * 0.39894228040143268f;
}

// ---------------------------------------------------------------------------
// Dropout masks from a counter-based hash. A site's mask bit for element idx
// (its logical row-major index in the site's tensor) depends only on (layer
// seed, site, idx), so the forward kernel, the backward kernel and the plain
// PyTorch version (ops/fused_layer.py::dropout_mask, the same arithmetic in
// int64 masked to 32 bits) produce identical bits whatever block size each
// uses. Keep rule as the TPU kernel: bits >= rate * 2^32, kept values scaled
// by 1 / (1 - rate).

__host__ __device__ inline uint32_t fmix32(uint32_t h) {  // murmur3 finalizer
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

struct DropCfg {
  int on;          // train and rate > 0
  int proj;        // the post-projection site is active (no identity projection)
  uint32_t seed;   // the layer's seed
  uint32_t thr;    // uint32(rate * 2^32)
  float scale;     // float32(1 / (1 - rate))
  // when not null, the seed is read from here in the kernel's prologue
  // instead: a replayed CUDA graph passes the arguments it captured, so a
  // seed that changes from replay to replay lives in device memory
  const uint32_t* seed_ptr = nullptr;
};

// a kernel's first statement: the seed from device memory when it is there
__device__ __forceinline__ void load_seed(DropCfg& dc) {
  if (dc.seed_ptr) dc.seed = *dc.seed_ptr;
}

enum DropSite : uint32_t { kSiteAttn = 1, kSiteProj = 3, kSiteFfMid = 5, kSiteFfOut = 7 };

// the hash key of a site's indices whose high 32 bits are hi
__device__ __forceinline__ uint32_t drop_key(const DropCfg& dc, uint32_t site, uint32_t hi) {
  return fmix32(dc.seed ^ fmix32(site * 0x9E3779B9u + hi * 0x632BE5ABu + 0x7F4A7C15u));
}

// the multiplier (0 or scale) of the index whose low 32 bits are lo, under
// its key
__device__ __forceinline__ float drop_mult_keyed(const DropCfg& dc, uint32_t key, uint32_t lo) {
  const uint32_t bits = fmix32(fmix32(lo ^ key) + key);
  return bits >= dc.thr ? dc.scale : 0.f;
}

// the dropout multiplier (0 or scale) of element idx of a site; 1 when off
__device__ __forceinline__ float drop_mult(const DropCfg& dc, uint32_t site, uint64_t idx) {
  if (!dc.on) return 1.f;
  return drop_mult_keyed(dc, drop_key(dc, site, static_cast<uint32_t>(idx >> 32)),
                         static_cast<uint32_t>(idx));
}

// drop_mult over a run of one site's indices (a row) shorter than 2^32:
// the keys of the high words of the run's first index and of the next are
// taken once, so that an index of the run costs one hash and a select, no
// branch. The same bits as drop_mult for every index in [first, first +
// 2^32).
struct DropRun {
  uint32_t lo0, key0, key1;

  __device__ DropRun(const DropCfg& dc, uint32_t site, uint64_t first)
      : lo0(static_cast<uint32_t>(first)),
        key0(dc.on ? drop_key(dc, site, static_cast<uint32_t>(first >> 32)) : 0u),
        key1(dc.on ? drop_key(dc, site, static_cast<uint32_t>(first >> 32) + 1u) : 0u) {}

  // the multiplier (0 or scale; 1 when off) of index idx of the run: past
  // a multiple of 2^32 exactly where its low word is below first's
  __device__ __forceinline__ float operator()(const DropCfg& dc, uint64_t idx) const {
    if (!dc.on) return 1.f;
    const uint32_t lo = static_cast<uint32_t>(idx);
    return drop_mult_keyed(dc, lo >= lo0 ? key0 : key1, lo);
  }
};

}  // namespace msst

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
