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
// What bounds it on the H100: bytes. It reads nothing and writes 4 bytes per
// element after ~20 integer operations: at 3.35 TB/s a store of 167.8 MB
// (the spatial attention site of a batch-64 training step) takes 50 us.
//
// What this design does about it: a grid-stride loop, each thread storing
// consecutive elements of a warp-wide run, so every warp's stores coalesce
// into full 128-byte lines; enough blocks to fill every SM.

#include <cstdint>

#include "common.cuh"

using namespace msst;

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    dropout_sample_kernel(float* __restrict__ out, long long numel, uint64_t base, DropCfg dc,
                          uint32_t site) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < numel;
       i += stride)
    out[i] = drop_mult(dc, site, base + static_cast<uint64_t>(i));
}

}  // namespace

// out: fp32 [numel]. base = (base_hi << 32) | base_lo; seed, site and thr
// (uint32(rate * 2^32)) are uint32 values passed in ints of the same bits;
// scale = float32(1 / (1 - rate)). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int dropout_sample(void* out, int numel, int base_lo, int base_hi, int seed, int site,
                              int thr, float scale, void* stream) {
  if (numel <= 0) return static_cast<int>(cudaSuccess);
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
  dropout_sample_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), numel, b, dc, static_cast<uint32_t>(site));
  return static_cast<int>(cudaGetLastError());
}
