// fused_simmim_bwd: the SimMIM per-block decode + weighted-L1 loss, backward.
//
// Replaces the Pallas kernel maskedsst_tpu/ops/fused_simmim.py::_bwd_kernel
// (rule _bwd_rule, pallas_call there). For the scalar cotangent gout (read
// from device memory, as the TPU kernel reads it from SMEM) it recomputes
// the decode of ops/fused_simmim.py per (b, g) and forms
//   dpred[q, n]    = sign(diff[q, n]) * w[n] * gout      (fp32, sign(0) = 0)
//   d enc [n, d]   = sum_q dpred[q, n] * kern[g, d, q]   (stored in enc's type)
//   d kern [G, D, P] += sum_n enc[n, d] * dpred[q, n]    (fp32, over the batch)
//   d bias [G, P]    += sum_n dpred[q, n]                (fp32, unrounded dpred)
// Numeric contract of _bdot: enc, kern and dpred rounded to the compute
// type C as product operands, fp32 products and sums.
//
// What bounds it on the H100: bytes. It reads encoded and the pixels and
// writes d encoded (~35 MB in bf16 at the recipe shapes) for ~6 * D * P
// flop per token.
//
// What this design does about it, in its first form: the forward's grid
// (block g, a contiguous range of batch rows per block). Per row the block
// stages the [N, D] slab in shared memory, recomputes dpred [P, N] there,
// writes d enc with one thread per (n, d) (coalesced along d), and adds
// its d kern and d bias contributions into per-thread running sums that
// live in shared memory, each entry owned by one thread. At the end every
// block writes its fp32 partials to a workspace, and a second kernel sums
// them over the batch ranges of each g in a fixed order: gradients are
// bit-identical from call to call (no float atomics).

#include <cstdint>

#include "common.cuh"

using namespace msst;

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline size_t smem_floats(int N, int D, int P) {
  return static_cast<size_t>(N) * (D + 1) + static_cast<size_t>(D) * P + P +
         static_cast<size_t>(P) * (N + 1) + static_cast<size_t>(D) * P + P;
}

__device__ __forceinline__ float sign_of(float v) {  // torch.sign / jnp.sign: NaN stays NaN
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : v);
}

template <typename E, typename C>
__global__ void __launch_bounds__(kThreads)
fused_simmim_bwd_kernel(const float* __restrict__ gout, const E* __restrict__ enc,
                        const float* __restrict__ patches, const C* __restrict__ kern,
                        const float* __restrict__ bias, const float* __restrict__ w,
                        E* __restrict__ denc, float* __restrict__ ws, int B, int G, int N, int D,
                        int P, int chunks, int per) {
  extern __shared__ float smem[];
  const int lde = D + 1;           // odd row strides: walks over n are conflict-free
  const int ldp = N + 1;
  float* es = smem;                // [N, lde] encoded slab of (b, g), rounded to C
  float* kw = es + N * lde;        // [D, P] decoder slice of block g, rounded to C
  float* bs = kw + D * P;          // [P]
  float* dp = bs + P;              // [P, ldp] dpred, fp32
  float* acc = dp + P * ldp;       // [D * P + P] running d kern, d bias

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int g = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int b_lo = chunk * per, b_hi = min(B, b_lo + per);
  const float gs = *gout;

  for (int i = tid; i < D * P; i += nthr) kw[i] = to_f(kern[static_cast<size_t>(g) * D * P + i]);
  for (int i = tid; i < P; i += nthr) bs[i] = bias[g * P + i];
  for (int i = tid; i < D * P + P; i += nthr) acc[i] = 0.f;

  for (int b = b_lo; b < b_hi; ++b) {
    const size_t bg = static_cast<size_t>(b) * G + g;
    const E* e = enc + bg * N * D;
    __syncthreads();  // the previous row's slab and dpred are no longer read
    for (int i = tid; i < N * D; i += nthr) es[(i / D) * lde + i % D] = round_to<C>(to_f(e[i]));
    __syncthreads();
    const float* pat = patches + bg * P * N;
    const float* wr = w + bg * N;
    for (int i = tid; i < P * N; i += nthr) {
      const int q = i / N, c = i % N;
      const float* row = es + c * lde;
      float a = 0.f;
      for (int d = 0; d < D; ++d) a += row[d] * kw[d * P + q];
      dp[q * ldp + c] = sign_of(a + bs[q] - pat[i]) * wr[c] * gs;
    }
    __syncthreads();
    // d enc [n, d] = sum_q round(dpred[q, n]) * kern[d, q]
    E* de = denc + bg * N * D;
    for (int i = tid; i < N * D; i += nthr) {
      const int c = i / D, d = i % D;
      float a = 0.f;
      for (int q = 0; q < P; ++q) a += round_to<C>(dp[q * ldp + c]) * kw[d * P + q];
      de[i] = from_f<E>(a);
    }
    // d kern [d, q] += sum_n enc[n, d] * round(dpred[q, n]); d bias [q] +=
    // sum_n dpred[q, n], unrounded
    for (int i = tid; i < D * P + P; i += nthr) {
      float a = 0.f;
      if (i < D * P) {
        const int d = i / P, q = i % P;
        for (int c = 0; c < N; ++c) a += es[c * lde + d] * round_to<C>(dp[q * ldp + c]);
      } else {
        const int q = i - D * P;
        for (int c = 0; c < N; ++c) a += dp[q * ldp + c];
      }
      acc[i] += a;
    }
  }
  __syncthreads();
  float* part = ws + static_cast<size_t>(blockIdx.x) * (D * P + P);
  for (int i = tid; i < D * P + P; i += nthr) part[i] = acc[i];
}

// d kern [G, D, P] then d bias [G, P] from the partials, each summed over
// the chunks of its g in chunk order
__global__ void reduce_partials(const float* __restrict__ ws, float* __restrict__ out, int G,
                                int D, int P, int chunks) {
  const size_t part = static_cast<size_t>(D) * P + P;
  const size_t nk = static_cast<size_t>(G) * D * P, total = nk + static_cast<size_t>(G) * P;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    size_t g, off;
    if (i < nk) {
      g = i / (static_cast<size_t>(D) * P);
      off = i % (static_cast<size_t>(D) * P);
    } else {
      g = (i - nk) / P;
      off = static_cast<size_t>(D) * P + (i - nk) % P;
    }
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += ws[(g * chunks + c) * part + off];
    out[i] = s;
  }
}

template <typename E, typename C>
cudaError_t launch(const void* gout, const void* enc, const void* patches, const void* kern,
                   const void* bias, const void* w, void* denc, void* ws, void* grads, int B,
                   int G, int N, int D, int P, int chunks, int per, cudaStream_t stream) {
  const size_t bytes = smem_floats(N, D, P) * sizeof(float);
  auto kernel = fused_simmim_bwd_kernel<E, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<G * chunks, kThreads, bytes, stream>>>(
      static_cast<const float*>(gout), static_cast<const E*>(enc),
      static_cast<const float*>(patches), static_cast<const C*>(kern),
      static_cast<const float*>(bias), static_cast<const float*>(w), static_cast<E*>(denc),
      static_cast<float*>(ws), B, G, N, D, P, chunks, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(G) * D * P + static_cast<size_t>(G) * P;
  const int threads = 256;
  reduce_partials<<<static_cast<int>((total + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(grads), G, D, P, chunks);
  return cudaGetLastError();
}

}  // namespace

// gout: the fp32 scalar cotangent; enc and denc [B, G, N, D] in bf16 when
// enc_bf16, else fp32; patches [B, G, P, N], bias [G, P] and w [B, G * N]
// in fp32; kern [G, D, P] in the compute type (bf16 when compute_bf16, else
// fp32). ws: fp32 workspace of G * chunks partials of D * P + P floats;
// grads: d kern [G, D, P] then d bias [G, P], fp32. Block i owns
// g = i / chunks and the batch rows [(i % chunks) * per, min(B, ... + per)).
// Launches the block kernel and the reduction on `stream`; returns
// cudaGetLastError().
extern "C" int fused_simmim_bwd(const void* gout, const void* enc, const void* patches,
                                const void* kern, const void* bias, const void* w, void* denc,
                                void* ws, void* grads, int B, int G, int N, int D, int P,
                                int chunks, int per, int enc_bf16, int compute_bf16,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (enc_bf16 && compute_bf16)
    err = launch<bf16, bf16>(gout, enc, patches, kern, bias, w, denc, ws, grads, B, G, N, D, P,
                             chunks, per, st);
  else if (enc_bf16)
    err = launch<bf16, float>(gout, enc, patches, kern, bias, w, denc, ws, grads, B, G, N, D, P,
                              chunks, per, st);
  else if (compute_bf16)
    err = launch<float, bf16>(gout, enc, patches, kern, bias, w, denc, ws, grads, B, G, N, D, P,
                              chunks, per, st);
  else
    err = launch<float, float>(gout, enc, patches, kern, bias, w, denc, ws, grads, B, G, N, D, P,
                               chunks, per, st);
  return static_cast<int>(err);
}
