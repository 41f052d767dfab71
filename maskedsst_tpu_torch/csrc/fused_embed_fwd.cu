// fused_embed_fwd: the blockwise tokenization head, forward.
//
// Replaces the Pallas kernel maskedsst_tpu/ops/fused_embed.py::_fwd_kernel
// (math in _fwd_body; entry fused_embed_mask, pallas_call in _fwd_impl).
// For patches [B, g, p, n]:
//   pre-LN over p (per pixel column) -> per-block [p] x [p, d] + bias ->
//   post-LN over d -> + pos [g, n, d] -> tokens * (1 - m) + (pos + mask_token) * m
// with the 0/1 mask m [B, g, n]; tokens [B, g, n, d] in the compute type C.
// Numeric contract: fp32 LN statistics with eps 1e-5; the pre-LN output and
// the embed kernel rounded to C and the product accumulated in fp32; the
// rest in fp32; one cast to C at the store.
//
// What bounds it on the H100: bytes. K = p = 10 is far too shallow for the
// tensor cores and each (b, g) reads 2.5 KB of pixels but writes 24 KB of fp32
// tokens (12 KB in bf16): ~2 flop per byte moved.
//
// What this design does about it: one block of 256 threads per (b, g). The
// pixel tile, the block's [p, d] kernel slice and the [n, d] pre-LN tokens
// stay in shared memory (31 KB at p 10, n 64, d 96); the K = 10 product is
// an FMA loop; post-LN, + pos and the mask select run in the warp that
// stores the token, so device memory sees each input once and each output
// once, with coalesced stores along d.

#include "common.cuh"

using namespace msst;

namespace {

constexpr int kThreads = 256;

template <typename Tin, typename C>
__global__ void __launch_bounds__(kThreads)
fused_embed_fwd_kernel(const Tin* __restrict__ patches, const float* __restrict__ mask,
                       const float* __restrict__ prs, const float* __restrict__ prb,
                       const C* __restrict__ kern, const float* __restrict__ bias,
                       const float* __restrict__ pls, const float* __restrict__ plb,
                       const float* __restrict__ pos, const float* __restrict__ mtok,
                       C* __restrict__ out, int G, int P, int N, int D) {
  extern __shared__ float smem[];
  float* xln = smem;        // [P, N] pre-LN output, rounded to C
  float* kw = xln + P * N;  // [P, D] this block's kernel slice
  float* t = kw + P * D;    // [N, D] embedded tokens + bias, before the post-LN

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % 32, nwarps = nthr / 32;
  const int bg = blockIdx.x, g = bg % G;
  const Tin* pat = patches + static_cast<size_t>(bg) * P * N;

  // pre-LN over p, one thread per pixel column
  for (int c = tid; c < N; c += nthr) {
    float mu = 0.f;
    for (int p = 0; p < P; ++p) mu += to_f(pat[p * N + c]);
    mu /= P;
    float var = 0.f;
    for (int p = 0; p < P; ++p) {
      const float d = to_f(pat[p * N + c]) - mu;
      var += d * d;
    }
    const float rsig = rsqrtf(var / P + kLnEps);
    for (int p = 0; p < P; ++p)
      xln[p * N + c] = round_to<C>((to_f(pat[p * N + c]) - mu) * rsig * prs[p] + prb[p]);
  }
  for (int i = tid; i < P * D; i += nthr) kw[i] = to_f(kern[static_cast<size_t>(g) * P * D + i]);
  __syncthreads();

  // t[n, d] = sum_p xln[p, n] * kw[p, d] + bias[g, d]
  for (int i = tid; i < N * D; i += nthr) {
    const int n = i / D, d = i % D;
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc += xln[p * N + n] * kw[p * D + d];
    t[i] = acc + bias[g * D + d];
  }
  __syncthreads();

  // post-LN over d, + pos, mask select; one warp per token
  for (int n = tid / 32; n < N; n += nwarps) {
    const float* row = t + n * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += row[d];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float e = row[d] - mu;
      v += e * e;
    }
    const float rsig = rsqrtf(warp_sum(v) / D + kLnEps);
    const float m = mask[static_cast<size_t>(bg) * N + n];
    const float* pe = pos + (static_cast<size_t>(g) * N + n) * D;
    C* o = out + (static_cast<size_t>(bg) * N + n) * D;
    for (int d = lane; d < D; d += 32) {
      const float tok = (row[d] - mu) * rsig * pls[d] + plb[d] + pe[d];
      const float masked = pe[d] + mtok[d];
      o[d] = from_f<C>(tok * (1.f - m) + masked * m);
    }
  }
}

template <typename Tin, typename C>
cudaError_t launch(const void* patches, const void* mask, const void* prs, const void* prb,
                   const void* kern, const void* bias, const void* pls, const void* plb,
                   const void* pos, const void* mtok, void* out,
                   int B, int G, int P, int N, int D, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(P * N + P * D + N * D) * sizeof(float);
  auto kernel = fused_embed_fwd_kernel<Tin, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<B * G, kThreads, bytes, stream>>>(
      static_cast<const Tin*>(patches), static_cast<const float*>(mask),
      static_cast<const float*>(prs), static_cast<const float*>(prb),
      static_cast<const C*>(kern), static_cast<const float*>(bias),
      static_cast<const float*>(pls), static_cast<const float*>(plb),
      static_cast<const float*>(pos), static_cast<const float*>(mtok),
      static_cast<C*>(out), G, P, N, D);
  return cudaGetLastError();
}

}  // namespace

// patches [B, G, P, N] in fp32 (bf16 when in_bf16); mask [B, G, N], LN
// scales/biases, bias [G, D], pos [G, N, D] and mask_token [D] in fp32;
// kern [G, P, D] and out [B, G, N, D] in the compute type (bf16 when
// compute_bf16, else fp32). Launches on `stream`; returns cudaGetLastError().
extern "C" int fused_embed_fwd(const void* patches, const void* mask, const void* prs,
                               const void* prb, const void* kern, const void* bias,
                               const void* pls, const void* plb, const void* pos,
                               const void* mtok, void* out,
                               int B, int G, int P, int N, int D,
                               int in_bf16, int compute_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16 && compute_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(patches, mask, prs, prb, kern, bias, pls, plb,
                                               pos, mtok, out, B, G, P, N, D, st);
  else if (in_bf16)
    err = launch<__nv_bfloat16, float>(patches, mask, prs, prb, kern, bias, pls, plb,
                                       pos, mtok, out, B, G, P, N, D, st);
  else if (compute_bf16)
    err = launch<float, __nv_bfloat16>(patches, mask, prs, prb, kern, bias, pls, plb,
                                       pos, mtok, out, B, G, P, N, D, st);
  else
    err = launch<float, float>(patches, mask, prs, prb, kern, bias, pls, plb,
                               pos, mtok, out, B, G, P, N, D, st);
  return static_cast<int>(err);
}
