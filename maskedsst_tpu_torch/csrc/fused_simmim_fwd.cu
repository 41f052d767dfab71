// fused_simmim_fwd: the SimMIM per-block decode + weighted-L1 loss, forward.
//
// Replaces the Pallas kernel maskedsst_tpu/ops/fused_simmim.py::_fwd_kernel
// (with _decode; entry _fwd_impl, pallas_call there). For encoded
// [B, G, N, D], patches [B, G, P, N], the decoder kernel [G, D, P], bias
// [G, P] and the 0/1 weights [B, G * N] it computes the unnormalized scalar
//   sum_{b, g, q, n} w[b, g, n] * |sum_d enc[b, g, n, d] * kern[g, d, q]
//                                  + bias[g, q] - patches[b, g, q, n]|
// over every token: a token of weight 0 still enters as 0 * |diff|, so a NaN
// anywhere in `encoded` reaches the loss, as on the TPU. Numeric contract of
// _bdot: enc and kern rounded to the compute type C, fp32 products and
// sums; the bias added in fp32.
//
// What bounds it on the H100: bytes. At the recipe shapes (B 64, G 20, N 64,
// D 96, P 10) it reads 7.9 M encoded values and 0.8 M pixels for 2 * D * P
// flop per token: ~10 flop per encoded byte in bf16, far below the card's
// ~295 flop/byte ridge.
//
// What this design does about it, in its first form: each block owns one
// spectral block g and a contiguous range of batch rows; per row it stages
// the [N, D] slab of block g (contiguous in memory, so the loads coalesce)
// in shared memory, rounded to C, with an odd row stride so that threads
// walking n read distinct banks; one thread per (q, n) output computes the
// D-long dot against the staged decoder slice and adds its weighted |diff|
// to a running sum. Each block writes one fp32 partial, and a second kernel
// sums the partials in a fixed order: the loss is bit-identical from call
// to call (no float atomics). The products are FMA loops: P = 10 fits no
// tensor-core tile, and the bound is the bytes.

#include <cstdint>

#include "common.cuh"

using namespace msst;

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline size_t smem_floats(int N, int D, int P) {
  return static_cast<size_t>(N) * (D + 1) + static_cast<size_t>(D) * P + P + kThreads / 32;
}

template <typename E, typename C>
__global__ void __launch_bounds__(kThreads)
fused_simmim_fwd_kernel(const E* __restrict__ enc, const float* __restrict__ patches,
                        const C* __restrict__ kern, const float* __restrict__ bias,
                        const float* __restrict__ w, float* __restrict__ ws, int B, int G, int N,
                        int D, int P, int chunks, int per) {
  extern __shared__ float smem[];
  const int lde = D + 1;           // odd row stride: walks over n are conflict-free
  float* es = smem;                // [N, lde] encoded slab of (b, g), rounded to C
  float* kw = es + N * lde;        // [D, P] decoder slice of block g, rounded to C
  float* bs = kw + D * P;          // [P]
  float* red = bs + P;             // [warps] the block reduction

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int g = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int b_lo = chunk * per, b_hi = min(B, b_lo + per);

  for (int i = tid; i < D * P; i += nthr) kw[i] = to_f(kern[static_cast<size_t>(g) * D * P + i]);
  for (int i = tid; i < P; i += nthr) bs[i] = bias[g * P + i];

  float sum = 0.f;
  for (int b = b_lo; b < b_hi; ++b) {
    const size_t bg = static_cast<size_t>(b) * G + g;
    const E* e = enc + bg * N * D;
    __syncthreads();  // the previous row's slab is no longer read
    for (int i = tid; i < N * D; i += nthr) es[(i / D) * lde + i % D] = round_to<C>(to_f(e[i]));
    __syncthreads();
    const float* pat = patches + bg * P * N;
    const float* wr = w + bg * N;
    for (int i = tid; i < P * N; i += nthr) {
      const int q = i / N, c = i % N;
      const float* row = es + c * lde;
      float a = 0.f;
      for (int d = 0; d < D; ++d) a += row[d] * kw[d * P + q];
      sum += wr[c] * fabsf(a + bs[q] - pat[i]);
    }
  }

  // block sum in a fixed order: warps by shuffle, then warp 0 over the warps
  sum = warp_sum(sum);
  const int lane = tid % 32, warp = tid / 32;
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nthr / 32 ? red[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) ws[blockIdx.x] = s;
  }
}

// the loss from the blocks' partials, summed in block order by one block
__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ ws, float* __restrict__ out, int blocks) {
  __shared__ float red[kThreads / 32];
  float s = 0.f;
  for (int i = threadIdx.x; i < blocks; i += blockDim.x) s += ws[i];
  s = warp_sum(s);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    float t = lane < blockDim.x / 32 ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) *out = t;
  }
}

template <typename E, typename C>
cudaError_t launch(const void* enc, const void* patches, const void* kern, const void* bias,
                   const void* w, void* ws, void* out, int B, int G, int N, int D, int P,
                   int chunks, int per, cudaStream_t stream) {
  const size_t bytes = smem_floats(N, D, P) * sizeof(float);
  auto kernel = fused_simmim_fwd_kernel<E, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<G * chunks, kThreads, bytes, stream>>>(
      static_cast<const E*>(enc), static_cast<const float*>(patches),
      static_cast<const C*>(kern), static_cast<const float*>(bias),
      static_cast<const float*>(w), static_cast<float*>(ws), B, G, N, D, P, chunks, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials<<<1, kThreads, 0, stream>>>(static_cast<const float*>(ws),
                                           static_cast<float*>(out), G * chunks);
  return cudaGetLastError();
}

}  // namespace

// enc [B, G, N, D] in bf16 when enc_bf16, else fp32; patches [B, G, P, N],
// bias [G, P] and w [B, G * N] in fp32; kern [G, D, P] in the compute type
// (bf16 when compute_bf16, else fp32). ws: fp32 workspace of G * chunks
// partials; out: the fp32 scalar. Block i owns g = i / chunks and the batch
// rows [(i % chunks) * per, min(B, (i % chunks + 1) * per)). Launches the
// block kernel and the reduction on `stream`; returns cudaGetLastError().
extern "C" int fused_simmim_fwd(const void* enc, const void* patches, const void* kern,
                                const void* bias, const void* w, void* ws, void* out, int B,
                                int G, int N, int D, int P, int chunks, int per, int enc_bf16,
                                int compute_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (enc_bf16 && compute_bf16)
    err = launch<bf16, bf16>(enc, patches, kern, bias, w, ws, out, B, G, N, D, P, chunks, per, st);
  else if (enc_bf16)
    err = launch<bf16, float>(enc, patches, kern, bias, w, ws, out, B, G, N, D, P, chunks, per, st);
  else if (compute_bf16)
    err = launch<float, bf16>(enc, patches, kern, bias, w, ws, out, B, G, N, D, P, chunks, per, st);
  else
    err = launch<float, float>(enc, patches, kern, bias, w, ws, out, B, G, N, D, P, chunks, per,
                               st);
  return static_cast<int>(err);
}
