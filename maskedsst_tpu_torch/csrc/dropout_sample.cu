// dropout_sample: one dropout site's fp32 multiplier, drawn alone.
//
// Replaces the Pallas kernel `kern` of scripts/tpu_kernel_check.py (launched
// by `sample`), which draws the fused layer's keep-mask
// (maskedsst_tpu/ops/fused_layer.py::_keep_mask) on its own so that the
// dropout generator's invariants can be checked on the device. Here the
// generator is the counter-based hash of common.cuh, and this kernel calls
// the very drop_mult the layer kernels call: what it writes is what they
// apply. out[i] = drop_mult(seed, site, base + i) for i < numel, each 0 or
// float32(1 / (1 - rate)); base is 64-bit, so indices at and above 2^32
// reach the hash's high-word branch.
//
// The strided form: out is [rows, width] and out[r * width + c] is the
// multiplier of base + r * row_stride + c, a slice of a site's tensor (the
// head-split layer's local heads of the attention site, its local columns of
// the GELU site). With row_stride == width it is the contiguous form above,
// bit for bit: every element takes the index base + i either way.
//
// What bounds it on the H100: bytes. It reads nothing and writes 4 bytes per
// element after ~20 integer operations: at 3.35 TB/s a store of 167.8 MB
// (the spatial attention site of a batch-64 training step) takes 50 us.
//
// What this design does about it: a grid-stride loop, each thread storing
// consecutive elements of a warp-wide run, so every warp's stores coalesce
// into full 128-byte lines; enough blocks to fill every SM. The strided form
// finds an element's row by a multiply and a shift, not a division, whose
// ~20 instructions an element would weigh beside the hash's.

#include <cstdint>

#include "common.cuh"

using namespace msst;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    dropout_sample_kernel(float* __restrict__ out, long long numel, uint32_t width,
                          uint64_t row_stride, uint64_t magic, uint32_t shift, uint64_t base,
                          DropCfg dc, uint32_t site) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const bool contiguous = row_stride == width;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < numel;
       i += stride) {
    uint64_t idx = static_cast<uint64_t>(i);
    if (!contiguous) {  // r = i / width by a multiply and a shift (see row_divisor)
      const uint32_t r = static_cast<uint32_t>((idx * magic) >> shift);
      idx = r * row_stride + (static_cast<uint32_t>(i) - r * width);
    }
    out[i] = drop_mult(dc, site, base + idx);
  }
}

// The row form: out[r * width + c] is the multiplier of base + r * width +
// c, drawn by one DropRun over each row, as the layer kernels draw a row of
// a site: the bits of the contiguous form, which a test holds it to.
__global__ void __launch_bounds__(kThreads)
    dropout_sample_rows_kernel(float* __restrict__ out, int rows, int width, uint64_t base,
                               DropCfg dc, uint32_t site) {
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < rows; r += gridDim.x * kThreads) {
    const uint64_t first = base + static_cast<uint64_t>(r) * width;
    const DropRun run(dc, site, first);
    for (int c = 0; c < width; ++c) out[static_cast<size_t>(r) * width + c] = run(dc, first + c);
  }
}

// i / width == (i * magic) >> shift for every i < 2^31: with l = ceil(log2
// width), magic = floor(2^(32 + l) / width) + 1 and shift = 32 + l
// (Granlund and Montgomery, 1994, theorem 4.2, for 32-bit numerators);
// magic <= 2^33 + 1, so i * magic stays below 2^64.
void row_divisor(uint32_t width, uint64_t* magic, uint32_t* shift) {
  uint32_t l = 0;
  while ((1ULL << l) < width) ++l;
  *shift = 32 + l;
  *magic = (1ULL << *shift) / width + 1;
}

}  // namespace

// out: fp32 [numel / width, width]. base = (base_hi << 32) | base_lo and
// row_stride = (stride_hi << 32) | stride_lo; seed, site and thr
// (uint32(rate * 2^32)) are uint32 values passed in ints of the same bits;
// scale = float32(1 / (1 - rate)). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int dropout_sample(void* out, int numel, int width, int base_lo, int base_hi,
                              int stride_lo, int stride_hi, int seed, int site, int thr,
                              float scale, void* stream) {
  if (numel <= 0) return static_cast<int>(cudaSuccess);
  if (width <= 0 || numel % width) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks_needed = (static_cast<long long>(numel) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(blocks_needed < 8LL * sms ? blocks_needed : 8LL * sms);
  DropCfg dc;
  dc.on = 1;
  dc.proj = 1;
  dc.seed = static_cast<uint32_t>(seed);
  dc.thr = static_cast<uint32_t>(thr);
  dc.scale = scale;
  const uint64_t b = (static_cast<uint64_t>(static_cast<uint32_t>(base_hi)) << 32) |
                     static_cast<uint32_t>(base_lo);
  const uint64_t rs = (static_cast<uint64_t>(static_cast<uint32_t>(stride_hi)) << 32) |
                      static_cast<uint32_t>(stride_lo);
  uint64_t magic = 0;
  uint32_t shift = 0;
  row_divisor(static_cast<uint32_t>(width), &magic, &shift);
  dropout_sample_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), numel, static_cast<uint32_t>(width), rs, magic, shift, b, dc,
      static_cast<uint32_t>(site));
  return static_cast<int>(cudaGetLastError());
}

// out: fp32 [rows, width] by the row form; the other arguments as
// dropout_sample's.
extern "C" int dropout_sample_rows(void* out, int rows, int width, int base_lo, int base_hi,
                                   int seed, int site, int thr, float scale, void* stream) {
  if (rows <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  DropCfg dc;
  dc.on = 1;
  dc.proj = 1;
  dc.seed = static_cast<uint32_t>(seed);
  dc.thr = static_cast<uint32_t>(thr);
  dc.scale = scale;
  const uint64_t b = (static_cast<uint64_t>(static_cast<uint32_t>(base_hi)) << 32) |
                     static_cast<uint32_t>(base_lo);
  const int blocks = (rows + kThreads - 1) / kThreads;
  dropout_sample_rows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), rows, width, b, dc, static_cast<uint32_t>(site));
  return static_cast<int>(cudaGetLastError());
}
