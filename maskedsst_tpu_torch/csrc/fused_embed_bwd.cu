// fused_embed_bwd: the blockwise tokenization head, backward (parameter
// gradients).
//
// Replaces the Pallas kernel maskedsst_tpu/ops/fused_embed.py::_bwd_kernel
// (rule _bwd_rule, pallas_call there). For patches [B, G, P, N], the 0/1 mask
// [B, G, N] and the tokens' gradient dtok [B, G, N, D] it recomputes the
// forward of ops/fused_embed.py per (b, g) and reduces, in fp32:
//   d preln scale/bias [P]   = sum dxln * z1, sum dxln   (dxln = kern . dt)
//   d kernel [G, P, D]       = sum_{b, n} xln[p, n] dt[n, d]
//   d bias [G, D]            = sum_{b, n} dt          (the TPU rule reduced over n
//                                                      outside its kernel; here inside)
//   d postln scale/bias [D]  = sum dkept * z2, sum dkept (dkept = dtok * (1 - m))
//   d pos [G, N, D]          = sum_b dkept + sum_b dtok * m  (kept branch + masked table)
//   d mask_token [D]         = sum_{b, g, n} dtok * m
// into one flat vector in that order. dt is the post-LN input's gradient.
// Numeric contract: fp32 LN statistics (eps 1e-5); xln, the embed kernel
// and dt rounded to the compute type C before each product (fp32
// accumulation), as _bwd_kernel's _bdot casts them.
//
// What bounds it on the H100: bytes. Each (b, g) reads 2.5 KB of pixels and
// 24 KB of fp32 (12 KB bf16) token gradients for ~4 x P x N x D flop, ~2
// flop per byte.
//
// What this design does about it, in its first form: one block of 256
// threads per (g, chunk of b); it keeps its running sums of every gradient
// of block g in shared memory (~113 KB at P 10, N 64, D 96) while it walks
// its b's in order, so device memory sees each input once; it then writes
// its partial sums to a workspace, and a second kernel adds the partials in
// a fixed order (deterministic, no atomics).

#include <cstdint>

#include "common.cuh"

using namespace msst;

namespace {

constexpr int kThreads = 256;

// one block's partial sums, in floats: kern [P, D], bias [D], pos [N, D],
// masked [N, D], mask_token [D], preln s/b [P], postln s/b [D]
struct Part {
  size_t kern, bias, pos, msk, mtok, prs, prb, pls, plb, total;

  __host__ __device__ Part(int P, int N, int D) {
    size_t o = 0;
    kern = o; o += static_cast<size_t>(P) * D;
    bias = o; o += D;
    pos = o;  o += static_cast<size_t>(N) * D;
    msk = o;  o += static_cast<size_t>(N) * D;
    mtok = o; o += D;
    prs = o;  o += P;
    prb = o;  o += P;
    pls = o;  o += D;
    plb = o;  o += D;
    total = o;
  }
};

// the final gradients: prs [P], prb [P], kern [G, P, D], bias [G, D],
// pls [D], plb [D], pos [G, N, D], mask_token [D]
struct Out {
  size_t prs, prb, kern, bias, pls, plb, pos, mtok, total;

  __host__ __device__ Out(int G, int P, int N, int D) {
    size_t o = 0;
    prs = o;  o += P;
    prb = o;  o += P;
    kern = o; o += static_cast<size_t>(G) * P * D;
    bias = o; o += static_cast<size_t>(G) * D;
    pls = o;  o += D;
    plb = o;  o += D;
    pos = o;  o += static_cast<size_t>(G) * N * D;
    mtok = o; o += D;
    total = o;
  }
};

__host__ __device__ inline size_t smem_floats(int P, int N, int D) {
  const int ldt = D + 1;
  return Part(P, N, D).total + static_cast<size_t>(P) * D + 2 * static_cast<size_t>(P) * N +
         2 * static_cast<size_t>(N) * ldt + N;
}

template <typename Tin, typename C>
__global__ void __launch_bounds__(kThreads)
fused_embed_bwd_kernel(const Tin* __restrict__ patches, const float* __restrict__ mask,
                       const float* __restrict__ prs, const float* __restrict__ prb,
                       const C* __restrict__ kern, const float* __restrict__ bias,
                       const float* __restrict__ pls, const float* __restrict__ plb,
                       const C* __restrict__ dtok, float* __restrict__ ws,
                       int B, int G, int P, int N, int D, int chunks) {
  extern __shared__ float smem[];
  const Part pt(P, N, D);
  const int ldt = D + 1;  // odd row stride: column walks over n are conflict-free
  float* acc = smem;                 // the block's running sums (layout Part)
  float* kw = acc + pt.total;        // [P, D] kernel slice of block g, rounded to C
  float* xln = kw + P * D;           // [P, N] pre-LN output, rounded to C
  float* z1 = xln + P * N;           // [P, N] pre-LN normalized input
  float* t = z1 + P * N;             // [N, ldt] tokens + bias, then z2
  float* dt = t + N * ldt;           // [N, ldt] dkept, then the post-LN input's gradient
  float* rs2 = dt + N * ldt;         // [N]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % 32, nwarps = nthr / 32;
  const int g = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int per = (B + chunks - 1) / chunks;
  const int b_lo = chunk * per, b_hi = min(B, b_lo + per);

  for (int i = tid; i < static_cast<int>(pt.total); i += nthr) acc[i] = 0.f;
  for (int i = tid; i < P * D; i += nthr) kw[i] = to_f(kern[static_cast<size_t>(g) * P * D + i]);
  __syncthreads();

  for (int b = b_lo; b < b_hi; ++b) {
    const size_t bg = static_cast<size_t>(b) * G + g;
    const Tin* pat = patches + bg * P * N;
    const C* dtk = dtok + bg * N * D;

    // pre-LN over p, one thread per pixel column
    for (int c = tid; c < N; c += nthr) {
      float mu = 0.f;
      for (int p = 0; p < P; ++p) mu += to_f(pat[p * N + c]);
      mu /= P;
      float var = 0.f;
      for (int p = 0; p < P; ++p) {
        const float e = to_f(pat[p * N + c]) - mu;
        var += e * e;
      }
      const float rsig = rsqrtf(var / P + kLnEps);
      for (int p = 0; p < P; ++p) {
        const float z = (to_f(pat[p * N + c]) - mu) * rsig;
        z1[p * N + c] = z;
        xln[p * N + c] = round_to<C>(z * prs[p] + prb[p]);
      }
    }
    __syncthreads();
    for (int i = tid; i < N * D; i += nthr) {
      const int n = i / D, d = i % D;
      float a = 0.f;
      for (int p = 0; p < P; ++p) a += xln[p * N + n] * kw[p * D + d];
      t[n * ldt + d] = a + bias[g * D + d];
    }
    __syncthreads();

    // post-LN statistics (t becomes z2); dkept = dtok * (1 - m); the pos
    // and masked-table sums. One warp per token row: every (n, d) has one
    // owner.
    for (int n = tid / 32; n < N; n += nwarps) {
      float* row = t + n * ldt;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += row[d];
      const float mu = warp_sum(s) / D;
      float v = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float e = row[d] - mu;
        v += e * e;
      }
      const float rsig = rsqrtf(warp_sum(v) / D + kLnEps);
      const float m = mask[bg * N + n];
      for (int d = lane; d < D; d += 32) {
        row[d] = (row[d] - mu) * rsig;
        const float gt = to_f(dtk[n * D + d]);
        const float kept = gt * (1.f - m);
        dt[n * ldt + d] = kept;
        acc[pt.pos + n * D + d] += kept;
        acc[pt.msk + n * D + d] += gt * m;
      }
      if (lane == 0) rs2[n] = rsig;
    }
    __syncthreads();
    for (int d = tid; d < D; d += nthr) {  // post-LN scale/bias
      float s1 = 0.f, s2 = 0.f;
      for (int n = 0; n < N; ++n) {
        s1 += dt[n * ldt + d] * t[n * ldt + d];
        s2 += dt[n * ldt + d];
      }
      acc[pt.pls + d] += s1;
      acc[pt.plb + d] += s2;
    }
    __syncthreads();
    // dt = rsig2 * (dz - mean(dz) - z2 * mean(dz z2)), dz = dkept * pls
    for (int n = tid / 32; n < N; n += nwarps) {
      float* gr = dt + n * ldt;
      const float* z = t + n * ldt;
      float s1 = 0.f, s2 = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float dz = gr[d] * pls[d];
        s1 += dz;
        s2 += dz * z[d];
      }
      const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
      __syncwarp();
      for (int d = lane; d < D; d += 32) gr[d] = rs2[n] * (gr[d] * pls[d] - m1 - z[d] * m2);
    }
    __syncthreads();
    // d bias (fp32 dt); d kernel = xln . round(dt) over n
    for (int i = tid; i < P * D + D; i += nthr) {
      if (i < P * D) {
        const int p = i / D, d = i % D;
        float s = 0.f;
        for (int n = 0; n < N; ++n) s += xln[p * N + n] * round_to<C>(dt[n * ldt + d]);
        acc[pt.kern + i] += s;
      } else {
        const int d = i - P * D;
        float s = 0.f;
        for (int n = 0; n < N; ++n) s += dt[n * ldt + d];
        acc[pt.bias + d] += s;
      }
    }
    // dxln[p, n] = kern[p, :] . round(dt[n, :]); pre-LN scale/bias sums,
    // one warp per p
    for (int p = tid / 32; p < P; p += nwarps) {
      float s1 = 0.f, s2 = 0.f;
      for (int n = lane; n < N; n += 32) {
        float a = 0.f;
        for (int d = 0; d < D; ++d) a += kw[p * D + d] * round_to<C>(dt[n * ldt + d]);
        s1 += a * z1[p * N + n];
        s2 += a;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        acc[pt.prs + p] += s1;
        acc[pt.prb + p] += s2;
      }
    }
    __syncthreads();
  }

  // the masked-table sum over n gives this block's d mask_token
  for (int d = tid; d < D; d += nthr) {
    float s = 0.f;
    for (int n = 0; n < N; ++n) s += acc[pt.msk + n * D + d];
    acc[pt.mtok + d] = s;
  }
  __syncthreads();
  float* part = ws + static_cast<size_t>(blockIdx.x) * pt.total;
  for (int i = tid; i < static_cast<int>(pt.total); i += nthr) part[i] = acc[i];
}

// the final gradients from the partials, summed in block order
__global__ void reduce_partials(const float* __restrict__ ws, float* __restrict__ out, int G,
                                int P, int N, int D, int chunks) {
  const Part pt(P, N, D);
  const Out ot(G, P, N, D);
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < ot.total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    // which partial entries make output i, over which blocks
    int g_lo = 0, g_hi = G;  // all blocks unless the output belongs to one g
    size_t off, off2 = SIZE_MAX;
    if (i < ot.prb) {
      off = pt.prs + (i - ot.prs);
    } else if (i < ot.kern) {
      off = pt.prb + (i - ot.prb);
    } else if (i < ot.bias) {
      const size_t j = i - ot.kern;
      g_lo = static_cast<int>(j / (static_cast<size_t>(P) * D));
      g_hi = g_lo + 1;
      off = pt.kern + j % (static_cast<size_t>(P) * D);
    } else if (i < ot.pls) {
      const size_t j = i - ot.bias;
      g_lo = static_cast<int>(j / D);
      g_hi = g_lo + 1;
      off = pt.bias + j % D;
    } else if (i < ot.plb) {
      off = pt.pls + (i - ot.pls);
    } else if (i < ot.pos) {
      off = pt.plb + (i - ot.plb);
    } else if (i < ot.mtok) {
      const size_t j = i - ot.pos;
      g_lo = static_cast<int>(j / (static_cast<size_t>(N) * D));
      g_hi = g_lo + 1;
      off = pt.pos + j % (static_cast<size_t>(N) * D);
      off2 = pt.msk + j % (static_cast<size_t>(N) * D);
    } else {
      off = pt.mtok + (i - ot.mtok);
    }
    float s = 0.f, s2 = 0.f;
    for (int g = g_lo; g < g_hi; ++g)
      for (int c = 0; c < chunks; ++c) {
        const float* part = ws + (static_cast<size_t>(g) * chunks + c) * pt.total;
        s += part[off];
        if (off2 != SIZE_MAX) s2 += part[off2];
      }
    out[i] = s + s2;
  }
}

template <typename Tin, typename C>
cudaError_t launch(const void* patches, const void* mask, const void* prs, const void* prb,
                   const void* kern, const void* bias, const void* pls, const void* plb,
                   const void* dtok, void* ws, void* grads, int B, int G, int P, int N, int D,
                   int chunks, cudaStream_t stream) {
  const size_t bytes = smem_floats(P, N, D) * sizeof(float);
  auto kernel = fused_embed_bwd_kernel<Tin, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<G * chunks, kThreads, bytes, stream>>>(
      static_cast<const Tin*>(patches), static_cast<const float*>(mask),
      static_cast<const float*>(prs), static_cast<const float*>(prb),
      static_cast<const C*>(kern), static_cast<const float*>(bias),
      static_cast<const float*>(pls), static_cast<const float*>(plb),
      static_cast<const C*>(dtok), static_cast<float*>(ws), B, G, P, N, D, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = Out(G, P, N, D).total;
  const int threads = 256;
  reduce_partials<<<static_cast<int>((total + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(grads), G, P, N, D, chunks);
  return cudaGetLastError();
}

}  // namespace

// patches [B, G, P, N] in fp32 (bf16 when in_bf16); mask [B, G, N], LN
// scales/biases and bias [G, D] in fp32; kern [G, P, D] and dtok
// [B, G, N, D] in the compute type (bf16 when compute_bf16, else fp32).
// ws: fp32 workspace of G * chunks blocks' partials; grads: the fp32
// gradients (prs, prb, kern, bias, pls, plb, pos, mask_token). Launches
// the block kernel (G * chunks blocks, each over a contiguous range of b)
// and the reduction on `stream`; returns cudaGetLastError().
extern "C" int fused_embed_bwd(const void* patches, const void* mask, const void* prs,
                               const void* prb, const void* kern, const void* bias,
                               const void* pls, const void* plb, const void* dtok, void* ws,
                               void* grads, int B, int G, int P, int N, int D, int chunks,
                               int in_bf16, int compute_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (in_bf16 && compute_bf16)
    err = launch<bf16, bf16>(patches, mask, prs, prb, kern, bias, pls, plb, dtok, ws, grads,
                             B, G, P, N, D, chunks, st);
  else if (in_bf16)
    err = launch<bf16, float>(patches, mask, prs, prb, kern, bias, pls, plb, dtok, ws, grads,
                              B, G, P, N, D, chunks, st);
  else if (compute_bf16)
    err = launch<float, bf16>(patches, mask, prs, prb, kern, bias, pls, plb, dtok, ws, grads,
                              B, G, P, N, D, chunks, st);
  else
    err = launch<float, float>(patches, mask, prs, prb, kern, bias, pls, plb, dtok, ws, grads,
                               B, G, P, N, D, chunks, st);
  return static_cast<int>(err);
}
