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
// tensor cores to bound it, and each (b, g) reads 2.5 KB of pixels but
// writes 12 KB of bf16 tokens (24 KB fp32): ~2 flop per byte moved. At
// batch 256 the bound is the 63 MB of bf16 tokens written, 0.023 ms.
//
// Two forms, chosen at launch from what the call gives:
//  - tensor cores (bf16 compute, P <= 16, D a multiple of 8 and at most
//    128, any N; tc_widths). The first form (one 256-thread block per
//    (b, g), the rest below) ran at 7 % of the bound: each of the 5,120
//    blocks at batch 256 staged the kernel slice and 24 KB of fp32 pos
//    again (126 MB of L2 reads), and its K = 10 FMA product, two shared
//    loads per FMA, took a third of its time (PERF.md §6). This form:
//    one warp owns 16 tokens of one (b, g); a block of four warps covers
//    one g and up to 64 tokens and walks a chunk of b, so the kernel slice
//    (as ldmatrix B fragments kept in registers), bias, the LN vectors and
//    the fp32 pos rows (in shared memory) are loaded once per block. The
//    pre-LN: the four lanes of a quad hold one token's pixel column, 4
//    values each, read once from device memory; the statistics come from
//    quad shuffles, and the lanes write xln, rounded to bf16, straight into
//    the m16k16 A fragment with p padded to 16 by zeros (the padded
//    products are exact zeros). The product: D / 8 mma.sync.m16n8k16 tiles
//    (12 at D 96). The epilogue works on the accumulator fragments: + bias,
//    the post-LN by quad shuffles, + pos, the mask select. Each warp
//    stages its [16, D] bf16 tile in shared memory and stores it as
//    16-byte vectors, the tile's rows being contiguous in device memory.
//    The fp32 sums that feed a bf16 rounding take the plain version's
//    order: pairwise sums, a mean as the sum times fl(1/D), separate
//    roundings where it rounds twice (no fused multiply-add).
//    Register and shared-memory plan: 128 registers at D 96, no spills
//    (acc 48, the kernel's B fragments 24, pixels 8), four 128-thread
//    blocks per SM (__launch_bounds__); shared memory FwdPlan: the kernel
//    slice [16, 104] bf16, pos [64, 104] fp32, four [D] vectors and four
//    [16, 104] bf16 store tiles, 44,800 bytes at D 96. chunk_plan
//    (ops/fused_embed.py) gives a block as few b's as keep the grid within
//    two waves of resident blocks: 5 b's a block at batch 256;
//  - FMA loops (fp32 compute, or widths the tensor-core form does not
//    take), the first form: one block of 256 threads per (b, g); the pixel
//    tile, the [p, d] kernel slice and the [n, d] pre-LN tokens in shared
//    memory (31 KB at p 10, n 64, d 96); the K = 10 product an FMA loop;
//    post-LN, + pos and the mask select in the warp that stores the token.
#include <cstdint>

#include "common.cuh"
#include "embed_tiles.cuh"
#include "warp_mma.cuh"

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
cudaError_t launch_fma(const void* patches, const void* mask, const void* prs, const void* prb,
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

// ---------------------------------------------------------------------------
// Tensor-core form (bf16 compute)

using bf16 = __nv_bfloat16;

constexpr int kBlocksPerSm = 4;  // ops/fused_embed.py FWD_BLOCKS_PER_SM

// Byte offsets of the form's shared memory: the kernel slice [16, dp + kPad]
// bf16 (rows p >= P and columns d >= D zero, dp = D rounded up to 16), the
// group's pos rows [64, D + 8] fp32, bias[g], postln scale/bias and the mask
// token [4, D] fp32, and each warp's store tile [16, D + kPad] bf16.
struct FwdPlan {
  int dp, ld_k, ld_p, ld_o;
  size_t kern, pos, vec, out, bytes;

  __host__ __device__ FwdPlan(int N, int D) {
    dp = round_up(D, 16);
    ld_k = dp + kPad;
    ld_p = D + 8;
    ld_o = D + kPad;
    const int rows = 16 * min(kWarps, (N + 15) / 16);
    size_t off = 0;
    kern = off; off += align128(sizeof(bf16) * 16 * ld_k);
    pos = off;  off += align128(sizeof(float) * rows * ld_p);
    vec = off;  off += align128(sizeof(float) * 4 * D);
    out = off;  off += align128(sizeof(bf16) * kWarps * 16 * ld_o);
    bytes = off;
  }
};

// NT: 8-column tiles of D (EXACT: D == 8 NT; else their maximum, D read at
// run time).
template <typename Tin, int NT, bool EXACT>
__global__ void __launch_bounds__(kTcThreads, kBlocksPerSm)
fused_embed_fwd_tc_kernel(const Tin* __restrict__ patches, const float* __restrict__ mask,
                          const float* __restrict__ prs, const float* __restrict__ prb,
                          const bf16* __restrict__ kern, const float* __restrict__ bias,
                          const float* __restrict__ pls, const float* __restrict__ plb,
                          const float* __restrict__ pos, const float* __restrict__ mtok,
                          bf16* __restrict__ out, int B, int G, int P, int N, int D, int per,
                          int chunks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const FwdPlan plan(N, D);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + plan.kern);
  float* ps = reinterpret_cast<float*>(smem_raw + plan.pos);
  float* vs = reinterpret_cast<float*>(smem_raw + plan.vec);
  const int nt = EXACT ? NT : D / 8;
  const Walk wk(B, G, N, per, chunks);
  const int tid = threadIdx.x, lane = tid % 32, c = lane % 4;

  // the block's operands, once: pos rows by cp.async under the rest
  const int vec4 = D / 4;
  for (int i = tid; i < wk.rows * vec4; i += kTcThreads) {
    const int r = i / vec4, c4 = (i % vec4) * 4;
    cp_async16(ps + r * plan.ld_p + c4, pos + (static_cast<size_t>(wk.g) * N + wk.row0 + r) * D + c4);
  }
  for (int i = tid; i < 16 * plan.dp; i += kTcThreads) {
    const int p = i / plan.dp, d = i % plan.dp;
    ks[p * plan.ld_k + d] =
        p < P && d < D ? kern[(static_cast<size_t>(wk.g) * P + p) * D + d] : __float2bfloat16(0.f);
  }
  for (int d = tid; d < D; d += kTcThreads) {
    vs[d] = bias[wk.g * D + d];
    vs[D + d] = pls[d];
    vs[2 * D + d] = plb[d];
    vs[3 * D + d] = mtok[d];
  }
  cp_async_wait_all();
  __syncthreads();
  if (!wk.active) return;

  // the kernel slice as the product's B fragments, kept for every b
  uint32_t bw[NT / 2][4];
#pragma unroll
  for (int jj = 0; jj < NT / 2; ++jj)
    if (2 * jj < nt) ldsm_kn(bw[jj], ks, plan.ld_k, 0, 16 * jj, lane);
  float sc[4], bi[4];
  lane_p(sc, prs, P, c);
  lane_p(bi, prb, P, c);
  const float inv_d = 1.f / D;
  const int ra = wk.tile * 16 + lane / 4;  // the lane's rows in the group: ra, ra + 8
  const int na = wk.row0 + ra;
  const int vrows = min(16, N - wk.row0 - wk.tile * 16);  // the tile's rows that exist
  bf16* ot = reinterpret_cast<bf16*>(smem_raw + plan.out) + (tid / 32) * 16 * plan.ld_o;
  const int cpr = D / 8;  // 16-byte pieces of a token row

  float px[8];
  int b = wk.b_lo + wk.boff;
  if (b < wk.b_hi)
    load_pixels(px, patches + (static_cast<size_t>(b) * G + wk.g) * P * N, P, N, na, c);
  for (; b < wk.b_hi; b += wk.wpt) {
    const size_t bg = static_cast<size_t>(b) * G + wk.g;
    const float m[2] = {na < N ? mask[bg * N + na] : 0.f, na + 8 < N ? mask[bg * N + na + 8] : 0.f};
    uint32_t a[4];
    {
      float z[8];
      pre_ln(a, z, px, sc, bi, P, c);
    }
    if (b + wk.wpt < wk.b_hi)  // the next b's pixels, under this one's work
      load_pixels(px, patches + (bg + static_cast<size_t>(wk.wpt) * G) * P * N, P, N, na, c);

    float acc[NT][4];
    zero(acc);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      if (2 * jj >= nt) continue;
      mma16816(acc[2 * jj], a, bw[jj][0], bw[jj][1]);
      mma16816(acc[2 * jj + 1], a, bw[jj][2], bw[jj][3]);
    }

    // + bias, post-LN over D, + pos, mask select; rounded to bf16 into the
    // warp's store tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t[2 * NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[j][2 * h + e] = j < nt ? __fadd_rn(acc[j][2 * h + e], vs[8 * j + 2 * c + e]) : 0.f;
          t[2 * j + e] = acc[j][2 * h + e];
        }
      const float mu = __fmul_rn(quad_sum(t), inv_d);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = __fsub_rn(acc[j][2 * h + e], mu);
          t[2 * j + e] = j < nt ? __fmul_rn(d, d) : 0.f;
        }
      const float rsig = rsqrtf(__fadd_rn(__fmul_rn(quad_sum(t), inv_d), kLnEps));
      const float keep = 1.f - m[h];
      const float* prow = ps + (ra + 8 * h) * plan.ld_p;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt) continue;
        const int col = 8 * j + 2 * c;
        const float2 pe = *reinterpret_cast<const float2*>(prow + col);
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = e ? pe.y : pe.x;
          const float z = __fmul_rn(__fsub_rn(acc[j][2 * h + e], mu), rsig);
          const float tok =
              __fadd_rn(__fadd_rn(__fmul_rn(z, vs[D + col + e]), vs[2 * D + col + e]), pv);
          const float masked = __fadd_rn(pv, vs[3 * D + col + e]);
          o[e] = __fadd_rn(__fmul_rn(tok, keep), __fmul_rn(masked, m[h]));
        }
        *reinterpret_cast<uint32_t*>(ot + (lane / 4 + 8 * h) * plan.ld_o + col) =
            pack_bf16(o[0], o[1]);
      }
    }
    __syncwarp();
    // the tile's rows are contiguous in device memory: 16-byte stores
    bf16* dst = out + (bg * N + wk.row0 + wk.tile * 16) * D;
    for (int k = lane; k < vrows * cpr; k += 32) {
      const int r = k / cpr, piece = k - r * cpr;
      *reinterpret_cast<uint4*>(dst + 8 * k) =
          *reinterpret_cast<const uint4*>(ot + r * plan.ld_o + 8 * piece);
    }
    __syncwarp();
  }
}

template <typename Tin, int NT, bool EXACT>
cudaError_t launch_tc_as(const void* patches, const void* mask, const void* prs,
                         const void* prb, const void* kern, const void* bias, const void* pls,
                         const void* plb, const void* pos, const void* mtok, void* out,
                         int B, int G, int P, int N, int D, int per, int chunks,
                         cudaStream_t stream) {
  const FwdPlan plan(N, D);
  auto kernel = fused_embed_fwd_tc_kernel<Tin, NT, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return err;
  const int groups = ((N + 15) / 16 + kWarps - 1) / kWarps;
  kernel<<<G * groups * chunks, kTcThreads, plan.bytes, stream>>>(
      static_cast<const Tin*>(patches), static_cast<const float*>(mask),
      static_cast<const float*>(prs), static_cast<const float*>(prb),
      static_cast<const bf16*>(kern), static_cast<const float*>(bias),
      static_cast<const float*>(pls), static_cast<const float*>(plb),
      static_cast<const float*>(pos), static_cast<const float*>(mtok),
      static_cast<bf16*>(out), B, G, P, N, D, per, chunks);
  return cudaGetLastError();
}

// the model's width (D 96) takes the instantiation with D fixed; the rest of
// tc_widths the one with D's maximum
template <typename Tin>
cudaError_t launch_tc(const void* patches, const void* mask, const void* prs, const void* prb,
                      const void* kern, const void* bias, const void* pls, const void* plb,
                      const void* pos, const void* mtok, void* out, int B, int G, int P, int N,
                      int D, int per, int chunks, cudaStream_t stream) {
  if (D == 96)
    return launch_tc_as<Tin, 12, true>(patches, mask, prs, prb, kern, bias, pls, plb, pos, mtok,
                                       out, B, G, P, N, D, per, chunks, stream);
  return launch_tc_as<Tin, 16, false>(patches, mask, prs, prb, kern, bias, pls, plb, pos, mtok,
                                      out, B, G, P, N, D, per, chunks, stream);
}


}  // namespace

// patches [B, G, P, N] in fp32 (bf16 when in_bf16); mask [B, G, N], LN
// scales/biases, bias [G, D], pos [G, N, D] and mask_token [D] in fp32;
// kern [G, P, D] and out [B, G, N, D] in the compute type (bf16 when
// compute_bf16, else fp32). bf16 compute at the widths tc_widths takes
// launches the tensor-core form over G x groups x chunks blocks, each
// walking per b's (pos 16-byte aligned, else cudaErrorMisalignedAddress);
// the rest the FMA form (per and chunks unused). Launches on `stream`;
// returns cudaGetLastError().
extern "C" int fused_embed_fwd(const void* patches, const void* mask, const void* prs,
                               const void* prb, const void* kern, const void* bias,
                               const void* pls, const void* plb, const void* pos,
                               const void* mtok, void* out,
                               int B, int G, int P, int N, int D, int per, int chunks,
                               int in_bf16, int compute_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (compute_bf16 && tc_widths(P, D)) {
    if (!aligned16(pos)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (in_bf16)
      err = launch_tc<__nv_bfloat16>(patches, mask, prs, prb, kern, bias, pls, plb, pos, mtok,
                                     out, B, G, P, N, D, per, chunks, st);
    else
      err = launch_tc<float>(patches, mask, prs, prb, kern, bias, pls, plb, pos, mtok, out,
                             B, G, P, N, D, per, chunks, st);
  } else if (in_bf16 && compute_bf16) {
    err = launch_fma<__nv_bfloat16, __nv_bfloat16>(patches, mask, prs, prb, kern, bias, pls, plb,
                                                   pos, mtok, out, B, G, P, N, D, st);
  } else if (in_bf16) {
    err = launch_fma<__nv_bfloat16, float>(patches, mask, prs, prb, kern, bias, pls, plb,
                                           pos, mtok, out, B, G, P, N, D, st);
  } else if (compute_bf16) {
    err = launch_fma<float, __nv_bfloat16>(patches, mask, prs, prb, kern, bias, pls, plb,
                                           pos, mtok, out, B, G, P, N, D, st);
  } else {
    err = launch_fma<float, float>(patches, mask, prs, prb, kern, bias, pls, plb,
                                   pos, mtok, out, B, G, P, N, D, st);
  }
  return static_cast<int>(err);
}
