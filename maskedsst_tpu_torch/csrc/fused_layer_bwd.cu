// fused_layer_bwd: one pre-norm transformer layer, backward.
//
// Replaces the Pallas kernel maskedsst_tpu/ops/fused_layer.py::_layer_bwd_kernel
// (rule _bwd_rule, pallas_call there) together with layer_wgrad.cu. Given x
// [B, S, D] and dy, it returns dx [B, S, D] in x's type and the 11 parameter
// gradients in fp32 (ln1 scale/bias, wqkv, wout, bout, ln2 scale/bias, w1,
// b1, w2, b2) as one flat vector in that order (layer_grads.cuh), the
// dropout masks of fused_layer_fwd.cu regenerated from the same hash
// (common.cuh). The gradient of the folded q scale is not undone here: the
// wrapper multiplies the q block of dwqkv by dh^-1/2.
//
// Numeric contract (the TPU kernel's): every product operand rounded to the
// compute type C at the points where _layer_bwd_kernel casts them (LN
// outputs, q/k/v, the dropped probabilities a_d, dO, ds, dq/dk/dv, the
// dropped GELU output, dp2, du, dp1, the head outputs); fp32 accumulation,
// fp32 LN statistics, softmax and residual stream; ds = (da - sum(da a)) a
// with da = da_d * mask on the undropped a. Sums run in a fixed order: two
// calls give the same bits (no atomics).
//
// Two forms, chosen by the wrapper:
//
// Tensor cores (bf16 compute; D, dh and F multiples of 16): the row kernel
// here, then layer_wgrad.cu. What bounds it on the H100: latency, not
// operations or bytes: ~60 small products per row block of 64 rows, each
// ending in a barrier, at one 512-thread block per SM (226 KB of shared
// memory at S = 64, D = 96, dh = 64). What the design does about it:
//  - the forward wrote x1 = x0 + attention (fp32) in the training call, so
//    the kernel starts from it and recomputes the attention only once, per
//    head inside its backward (q/k/v, scores, softmax);
//  - the four weight gradients are not summed here: the kernel writes
//    their bf16 operands to device memory (5,120 bytes a row at the EnMAP
//    widths) and layer_wgrad.cu takes the products over all rows at once;
//    only the small vectors (LN scales/biases, biases) are summed, into a
//    per-block partial row that a second kernel sums in block order;
//  - the whole row block lives in shared memory (the residual and gradient
//    streams in fp32, the product operands in bf16 with padded rows; the
//    MLP buffers alias the attention buffers); every product is a 16x16x16
//    bf16 WMMA with fp32 accumulation; attention is one block-diagonal
//    [rows, rows] tile per head (entries outside a row's own sequence are
//    exact zeros in a and ds);
//  - weight slices are staged from L2 with cp.async into their buffer as
//    soon as the previous head has read it for the last time, so the copy
//    runs under the products of the rest of the head.
//
// Past 64 rows a block (ViTRGB's cls-token sequence of 65 at the EnMAP
// widths: R = 80) the whole row block no longer fits the card's opt-in
// 227 KB of shared memory (278,016 bytes for the row kernel, 242,784 for
// the FMA form). Each form then takes a plan of a higher level
// (fused_layer_bwd_plan): the row kernel first reads its weight slices
// from device memory instead of staging them (226,304 bytes at S = 65),
// then each level moves one more buffer (the [rows, D] fp32 streams, the
// score tiles, the MLP's fp32 buffers; for the FMA form also the bf16
// streams) to a per-block scratch in device memory, reached through L1
// and L2, until the plan fits. Every geometry of the tensor-core widths
// (at most 128 rows) fits; the wrapper refuses one that no level fits,
// naming it. Level 0 is the layout above, and its instantiation keeps
// every pointer a shared one.
//
// FMA loops (fp32 compute, other widths): a persistent grid of at most one
// block per SM walks row blocks (up to 64 rows of whole sequences) in a
// fixed order, keeps the row block in shared memory (215 KB at S = 64), and
// adds each row block's 11 parameter gradients into its own fp32 partial
// row (8-row register tiles per thread for products with a weight from L2,
// an 8-column tile for the weight gradients, per-sequence attention loops);
// a second kernel sums the partials in block order. The forward is
// recomputed twice (once for the residual stream, once per head).

#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "layer_grads.cuh"

using namespace msst;
using namespace nvcuda;

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 8;

__host__ __device__ inline int seqs_per_block(int S) { return S >= 64 ? 1 : 64 / S; }

// Where a form's buffers live. A plan of level 0 keeps every buffer in
// shared memory (and, in the tensor-core form, stages the weight slices
// there); each higher level moves one more buffer, in the order of the
// form's spill order, to a per-block scratch area in device memory, which
// the block reaches through L1 and L2 (the tensor-core form reads its
// weights from device memory from level 1 on). The launch takes the lowest
// level whose shared memory fits the card's opt-in limit.

// the FMA form's buffers that may live in device memory, in the order the
// levels move them there: the [rows, D] streams first, then the score tiles
enum FmaSpill : unsigned {
  kFAcc = 1, kFXs = 2, kFDp1 = 4, kFHb = 8, kFDsc = 16, kFPb = 32, kFSc = 64
};
__host__ __device__ inline unsigned fma_spill(int level) {
  const unsigned order[] = {kFAcc, kFXs, kFDp1, kFHb, kFDsc, kFPb, kFSc};
  return spill_bits(order, level);
}
constexpr int kFmaLevels = 8;

// the FMA form's plan, in floats: shared memory (`floats`) and the block's
// device scratch (`gfloats`); a buffer's offset counts in the space its
// bit in `spill` names. Level 0's layout is written out (the arithmetic of
// the form before the plans, whose code it keeps); a higher level places
// the same buffers again.
struct BwdPlan {
  int rcap, ldh, region;
  unsigned spill;
  size_t xs, acc, hb, dp1, q, k, v, dO, sc, dsc, pb, u, g, dp2, stats, floats, gfloats;

  __host__ __device__ BwdPlan(int S, int D, int dh, int F, int level = 0) {
    rcap = round_up(seqs_per_block(S) * S, kRowTile);
    ldh = dh + 1;  // odd stride: the k/v column walks are free of bank conflicts
    const int attn = 4 * ldh + 3 * S, mlp = 2 * F + D;
    region = attn > mlp ? attn : mlp;  // per row
    size_t o = 0;
    xs = o;  o += static_cast<size_t>(rcap) * D;   // x1, then the dh1 accumulator
    acc = o; o += static_cast<size_t>(rcap) * D;   // projection sum, then dh2, then dx1
    hb = o;  o += static_cast<size_t>(rcap) * D;   // h1 / h2 rounded to C
    dp1 = o; o += static_cast<size_t>(rcap) * D;   // dx1 * mask3 rounded to C
    const size_t r0 = o;
    q = o;   o += static_cast<size_t>(rcap) * ldh;
    k = o;   o += static_cast<size_t>(rcap) * ldh;
    v = o;   o += static_cast<size_t>(rcap) * ldh;
    dO = o;  o += static_cast<size_t>(rcap) * ldh;
    sc = o;  o += static_cast<size_t>(rcap) * S;   // scores, then probabilities a (fp32)
    dsc = o; o += static_cast<size_t>(rcap) * S;   // da_d, then ds rounded
    pb = o;  o += static_cast<size_t>(rcap) * S;   // a * mask1 rounded
    // MLP phase, over the attention buffers
    u = r0;
    g = u + static_cast<size_t>(rcap) * F;         // dropped GELU output, then dgd
    dp2 = g + static_cast<size_t>(rcap) * F;
    o = r0 + static_cast<size_t>(rcap) * region;
    stats = o; o += 4 * static_cast<size_t>(rcap);  // mu1, rsig1, mu2, rsig2
    floats = o;
    spill = fma_spill(level);
    gfloats = 0;
    if (!spill) return;
    Placer pl(spill, 1);
    const size_t rd = static_cast<size_t>(rcap) * D, rh = static_cast<size_t>(rcap) * ldh,
                 rs = static_cast<size_t>(rcap) * S;
    xs = pl.put(rd, kFXs);
    acc = pl.put(rd, kFAcc);
    hb = pl.put(rd, kFHb);
    dp1 = pl.put(rd, kFDp1);
    const size_t r1 = pl.shared;
    q = pl.put(rh, 0);
    k = pl.put(rh, 0);
    v = pl.put(rh, 0);
    dO = pl.put(rh, 0);
    sc = pl.put(rs, kFSc);
    dsc = pl.put(rs, kFDsc);
    pb = pl.put(rs, kFPb);
    u = r1;
    g = u + static_cast<size_t>(rcap) * F;
    dp2 = g + static_cast<size_t>(rcap) * F;
    o = pl.shared > dp2 + rd ? pl.shared : dp2 + rd;
    stats = o; o += 4 * static_cast<size_t>(rcap);
    floats = o;
    gfloats = pl.device;
  }
};

// write (the block's first row block) or add into the block's partials
__device__ __forceinline__ void put(float* p, float v, bool first) { *p = first ? v : *p + v; }

enum Out { kRounded, kF32, kAdd, kBiasF32 };

// out[r, c] <op>= sum_k A[r, k] * W(k, c) for r < rows, c < N, where
// W(k, c) = W[k * ldw + c], or W[c * ldw + k] when TRANS (a product with a
// weight's transpose). A: shared fp32, row stride lda, round_up(rows, 8)
// rows allocated. W: device memory in C.
template <typename C, int OUT, bool TRANS>
__device__ void mm_w(const float* A, int lda, int rows, int K, const C* __restrict__ W,
                     int ldw, int N, const float* __restrict__ bias, float* out, int ldo) {
  const int groups = (rows + kRowTile - 1) / kRowTile;
  for (int t = threadIdx.x; t < groups * N; t += blockDim.x) {
    const int c = t % N, r0 = (t / N) * kRowTile;
    float acc[kRowTile];
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = to_f(TRANS ? W[static_cast<size_t>(c) * ldw + k]
                                 : W[static_cast<size_t>(k) * ldw + c]);
#pragma unroll
      for (int i = 0; i < kRowTile; ++i) acc[i] += A[(r0 + i) * lda + k] * w;
    }
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) {
      const int r = r0 + i;
      if (r >= rows) break;
      float* o = out + r * ldo + c;
      if (OUT == kRounded) *o = round_to<C>(acc[i]);
      else if (OUT == kF32) *o = acc[i];
      else if (OUT == kAdd) *o += acc[i];
      else *o = acc[i] + bias[c];
    }
  }
}

// partial[kk, n] (+)= sum_{r < rows} A[r, kk] * Bm[r, n] for kk < K, n < N:
// a weight gradient, written into the block's partials (row stride ldg).
// Consecutive threads take consecutive n: the Bm loads are conflict-free,
// the A loads a broadcast and the partial updates coalesced.
__device__ void mm_tn_partial(const float* A, int lda, const float* Bm, int ldb, int rows,
                              int K, int N, float* part, int ldg, bool first) {
  const int groups = (K + kRowTile - 1) / kRowTile;
  for (int t = threadIdx.x; t < groups * N; t += blockDim.x) {
    const int n = t % N, k0 = (t / N) * kRowTile;
    float acc[kRowTile];
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) acc[i] = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float b = Bm[r * ldb + n];
#pragma unroll
      for (int i = 0; i < kRowTile; ++i) acc[i] += A[r * lda + min(k0 + i, K - 1)] * b;
    }
#pragma unroll
    for (int i = 0; i < kRowTile; ++i)
      if (k0 + i < K) put(part + static_cast<size_t>(k0 + i) * ldg + n, acc[i], first);
  }
}

// out[r, j] = sum_d A[r, d] * Bm[s(r) + j, d] within each sequence (j < S):
// the scores (q, k) and da_d (dO, v)
__device__ void seq_abt(const float* A, const float* Bm, int ldh, int rows, int S, int dh,
                        float* out) {
  for (int t = threadIdx.x; t < rows * S; t += blockDim.x) {
    const int r = t / S, j = t % S;
    const float* a = A + r * ldh;
    const float* b = Bm + (r / S * S + j) * ldh;
    float acc = 0.f;
    for (int d = 0; d < dh; ++d) acc += a[d] * b[d];
    out[t] = acc;
  }
}

// out[r, d] = sum_j P[r, j] * V[s(r) + j, d], rounded to C: the head output
// (a_d, v) and dq (ds, k)
template <typename C>
__device__ void seq_pv(const float* P, const float* V, int ldh, int rows, int S, int dh,
                       float* out) {
  for (int t = threadIdx.x; t < rows * dh; t += blockDim.x) {
    const int r = t / dh, d = t % dh;
    const float* p = P + r * S;
    const float* v = V + (r / S * S) * ldh + d;
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc += p[j] * v[j * ldh];
    out[r * ldh + d] = round_to<C>(acc);
  }
}

// out[s + j, d] = sum_i P[s + i, j] * V[s + i, d], rounded to C: dv (a_d,
// dO) and dk (ds, q)
template <typename C>
__device__ void seq_ptv(const float* P, const float* V, int ldh, int rows, int S, int dh,
                        float* out) {
  for (int t = threadIdx.x; t < rows * dh; t += blockDim.x) {
    const int rj = t / dh, d = t % dh;
    const int s0 = rj / S * S, j = rj % S;
    float acc = 0.f;
    for (int i = 0; i < S; ++i) acc += P[(s0 + i) * S + j] * V[(s0 + i) * ldh + d];
    out[rj * ldh + d] = round_to<C>(acc);
  }
}

// row statistics of src [rows, D] (fp32, two-pass, one warp per row) into
// mu/rsig; dst = (src - mu) * rsig * scale + bias rounded to C
template <typename C>
__device__ void ln_rows(const float* src, int rows, int D, const float* __restrict__ scale,
                        const float* __restrict__ bias, float* mu_out, float* rs_out,
                        float* dst) {
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < rows; r += nwarps) {
    const float* x = src + r * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += x[c];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float t = x[c] - mu;
      v += t * t;
    }
    const float rsig = rsqrtf(warp_sum(v) / D + kLnEps);
    for (int c = lane; c < D; c += 32) dst[r * D + c] = round_to<C>((x[c] - mu) * rsig * scale[c] + bias[c]);
    if (lane == 0) {
      mu_out[r] = mu;
      rs_out[r] = rsig;
    }
  }
}

// in place: g [rows, D] (the LN output's gradient) -> the LN input's
// gradient plus `resid` (fp32, or the input type T), where z = (x - mu) *
// rsig is rebuilt from x (fp32 shared, or T in device memory):
// dx = rsig * (dz - mean(dz) - z * mean(dz * z)), dz = g * scale
template <typename X, typename Rz>
__device__ void ln_bwd_rows(float* g, const X* x, const float* mu, const float* rs, int rows,
                            int D, const float* __restrict__ scale, const Rz* resid) {
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < rows; r += nwarps) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float z = (to_f(x[r * D + c]) - mu[r]) * rs[r];
      const float dz = g[r * D + c] * scale[c];
      s1 += dz;
      s2 += dz * z;
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
    for (int c = lane; c < D; c += 32) {
      const float z = (to_f(x[r * D + c]) - mu[r]) * rs[r];
      const float dz = g[r * D + c] * scale[c];
      g[r * D + c] = to_f(resid[r * D + c]) + rs[r] * (dz - m1 - z * m2);
    }
  }
}

// LN parameter gradients of one row block: sum_r g * z and sum_r g
template <typename X>
__device__ void ln_param_partials(const float* g, const X* x, const float* mu,
                                  const float* rs, int rows, int D, float* dscale,
                                  float* dbias, bool first) {
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < rows; ++r) {
      const float z = (to_f(x[r * D + c]) - mu[r]) * rs[r];
      s1 += g[r * D + c] * z;
      s2 += g[r * D + c];
    }
    put(dscale + c, s1, first);
    put(dbias + c, s2, first);
  }
}

// FLEX: the plan's level (> 0) places some buffers in the block's slice of
// `scratch` (device memory); without it every buffer is in shared memory
// and the pointers are known to be shared ones
template <typename T, typename C, bool FLEX>
__global__ void __launch_bounds__(kThreads)
fused_layer_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                       const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                       const C* __restrict__ wqkv, const C* __restrict__ wout,
                       const float* __restrict__ bout,
                       const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                       const C* __restrict__ w1, const float* __restrict__ b1,
                       const C* __restrict__ w2, const float* __restrict__ b2,
                       float* __restrict__ ws, float* __restrict__ scratch, int B, int S, int D,
                       int H, int dh, int F, int level, DropCfg dc) {
  extern __shared__ float smem[];
  const BwdPlan plan(S, D, dh, F, FLEX ? level : 0);
  const int I = H * dh, ldh = plan.ldh;
  const GradLayout gl(D, I, F);
  float* xs = smem + plan.xs;
  float* acc = smem + plan.acc;
  float* hb = smem + plan.hb;
  float* dp1 = smem + plan.dp1;
  float* q = smem + plan.q;
  float* k = smem + plan.k;
  float* v = smem + plan.v;
  float* dO = smem + plan.dO;
  float* sc = smem + plan.sc;
  float* dsc = smem + plan.dsc;
  float* pb = smem + plan.pb;
  if constexpr (FLEX) {  // some buffers in the block's slice of the scratch
    float* gblk = scratch + static_cast<size_t>(blockIdx.x) * plan.gfloats;
    auto at = [&](size_t off, unsigned bit) { return plan.spill & bit ? gblk + off : smem + off; };
    xs = at(plan.xs, kFXs);
    acc = at(plan.acc, kFAcc);
    hb = at(plan.hb, kFHb);
    dp1 = at(plan.dp1, kFDp1);
    sc = at(plan.sc, kFSc);
    dsc = at(plan.dsc, kFDsc);
    pb = at(plan.pb, kFPb);
  }
  float* u = smem + plan.u;
  float* g = smem + plan.g;
  float* dp2 = smem + plan.dp2;
  float* mu1 = smem + plan.stats;
  float* rs1 = mu1 + plan.rcap;
  float* mu2 = rs1 + plan.rcap;
  float* rs2 = mu2 + plan.rcap;
  float* part = ws + static_cast<size_t>(blockIdx.x) * gl.total;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % 32, nwarps = nthr / 32;
  const int seqs = seqs_per_block(S);
  const int nblocks = (B + seqs - 1) / seqs;
  bool first = true;

  for (int blk = blockIdx.x; blk < nblocks; blk += gridDim.x, first = false) {
    const int seq0 = blk * seqs;
    const int rows = min(seqs, B - seq0) * S;
    const long long row0 = static_cast<long long>(seq0) * S;
    const T* x0 = x + row0 * D;
    const T* dyb = dy + row0 * D;

    // ---- recompute the forward up to x1 = x0 + attention -------------------
    for (int i = tid; i < rows * D; i += nthr) {
      xs[i] = to_f(x0[i]);
      acc[i] = 0.f;
    }
    __syncthreads();
    ln_rows<C>(xs, rows, D, ln1s, ln1b, mu1, rs1, hb);
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      mm_w<C, kRounded, false>(hb, D, rows, D, wqkv + h * dh, 3 * I, dh, nullptr, q, ldh);
      mm_w<C, kRounded, false>(hb, D, rows, D, wqkv + I + h * dh, 3 * I, dh, nullptr, k, ldh);
      mm_w<C, kRounded, false>(hb, D, rows, D, wqkv + 2 * I + h * dh, 3 * I, dh, nullptr, v, ldh);
      __syncthreads();
      seq_abt(q, k, ldh, rows, S, dh, sc);
      __syncthreads();
      for (int r = tid / 32; r < rows; r += nwarps) {
        float* s = sc + r * S;
        float m = __int_as_float(0xff800000);  // -inf
        for (int j = lane; j < S; j += 32) m = fmaxf(m, s[j]);
        m = warp_max(m);
        float sum = 0.f;
        for (int j = lane; j < S; j += 32) sum += expf(s[j] - m);
        const float inv = 1.f / warp_sum(sum);
        const uint64_t idx0 = ((static_cast<uint64_t>(seq0 + r / S) * H + h) * S + r % S) * S;
        for (int j = lane; j < S; j += 32)
          pb[r * S + j] = round_to<C>(expf(s[j] - m) * inv * drop_mult(dc, kSiteAttn, idx0 + j));
      }
      __syncthreads();
      seq_pv<C>(pb, v, ldh, rows, S, dh, q);  // the head's output over q
      __syncthreads();
      mm_w<C, kAdd, false>(q, ldh, rows, dh, wout + static_cast<size_t>(h) * dh * D, D, D,
                           nullptr, acc, D);
      __syncthreads();
    }
    for (int i = tid; i < rows * D; i += nthr) {
      const float m = dc.proj ? drop_mult(dc, kSiteProj, row0 * D + i) : 1.f;
      xs[i] = xs[i] + (acc[i] + bout[i % D]) * m;
    }
    __syncthreads();
    ln_rows<C>(xs, rows, D, ln2s, ln2b, mu2, rs2, hb);
    __syncthreads();

    // ---- MLP: forward, then backward ---------------------------------------
    mm_w<C, kBiasF32, false>(hb, D, rows, D, w1, F, F, b1, u, F);
    for (int c = tid; c < D; c += nthr) {  // dp2 = dy * mask7; db2
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float val = to_f(dyb[r * D + c]) *
                          drop_mult(dc, kSiteFfOut, static_cast<uint64_t>(row0 + r) * D + c);
        s += val;
        dp2[r * D + c] = round_to<C>(val);
      }
      put(part + gl.b2 + c, s, first);
    }
    __syncthreads();
    for (int i = tid; i < rows * F; i += nthr)
      g[i] = round_to<C>(gelu(u[i]) * drop_mult(dc, kSiteFfMid, static_cast<uint64_t>(row0) * F + i));
    __syncthreads();
    mm_tn_partial(g, F, dp2, D, rows, F, D, part + gl.w2, D, first);  // dw2 = gd^T dp2
    __syncthreads();
    mm_w<C, kF32, true>(dp2, D, rows, D, w2, D, F, nullptr, g, F);  // dgd = dp2 w2^T, over gd
    __syncthreads();
    for (int c = tid; c < F; c += nthr) {  // du = dgd * mask5 * gelu'(u); db1
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float du = g[r * F + c] *
                         drop_mult(dc, kSiteFfMid, static_cast<uint64_t>(row0 + r) * F + c) *
                         gelu_grad(u[r * F + c]);
        s += du;
        u[r * F + c] = round_to<C>(du);
      }
      put(part + gl.b1 + c, s, first);
    }
    __syncthreads();
    mm_tn_partial(hb, D, u, F, rows, D, F, part + gl.w1, F, first);  // dw1 = h2^T du
    mm_w<C, kF32, true>(u, F, rows, F, w1, F, D, nullptr, acc, D);   // dh2 = du w1^T
    __syncthreads();
    ln_param_partials(acc, xs, mu2, rs2, rows, D, part + gl.ln2s, part + gl.ln2b, first);
    __syncthreads();
    ln_bwd_rows(acc, xs, mu2, rs2, rows, D, ln2s, dyb);  // acc = dx1 = dy + LN2'(dh2)
    __syncthreads();
    for (int c = tid; c < D; c += nthr) {  // dp1 = dx1 * mask3; dbout
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float m = dc.proj ? drop_mult(dc, kSiteProj, (row0 + r) * D + c) : 1.f;
        const float val = acc[r * D + c] * m;
        s += val;
        dp1[r * D + c] = round_to<C>(val);
      }
      put(part + gl.bout + c, s, first);
    }
    for (int i = tid; i < rows * D; i += nthr) {  // h1 again, from the saved statistics
      const int r = i / D, c = i % D;
      hb[i] = round_to<C>((to_f(x0[i]) - mu1[r]) * rs1[r] * ln1s[c] + ln1b[c]);
      xs[i] = 0.f;  // the dh1 accumulator
    }
    __syncthreads();

    // ---- attention backward, one head at a time ----------------------------
    for (int h = 0; h < H; ++h) {
      const C* wq = wqkv + h * dh;
      mm_w<C, kRounded, false>(hb, D, rows, D, wq, 3 * I, dh, nullptr, q, ldh);
      mm_w<C, kRounded, false>(hb, D, rows, D, wq + I, 3 * I, dh, nullptr, k, ldh);
      mm_w<C, kRounded, false>(hb, D, rows, D, wq + 2 * I, 3 * I, dh, nullptr, v, ldh);
      __syncthreads();
      seq_abt(q, k, ldh, rows, S, dh, sc);
      __syncthreads();
      for (int r = tid / 32; r < rows; r += nwarps) {  // sc = a; pb = a * mask1
        float* s = sc + r * S;
        float m = __int_as_float(0xff800000);
        for (int j = lane; j < S; j += 32) m = fmaxf(m, s[j]);
        m = warp_max(m);
        float sum = 0.f;
        for (int j = lane; j < S; j += 32) sum += expf(s[j] - m);
        const float inv = 1.f / warp_sum(sum);
        __syncwarp();
        const uint64_t idx0 = ((static_cast<uint64_t>(seq0 + r / S) * H + h) * S + r % S) * S;
        for (int j = lane; j < S; j += 32) {
          const float a = expf(s[j] - m) * inv;
          s[j] = a;
          pb[r * S + j] = round_to<C>(a * drop_mult(dc, kSiteAttn, idx0 + j));
        }
      }
      __syncthreads();
      seq_pv<C>(pb, v, ldh, rows, S, dh, dO);  // the head's output o_h
      __syncthreads();
      const C* wo = wout + static_cast<size_t>(h) * dh * D;
      mm_tn_partial(dO, ldh, dp1, D, rows, dh, D, part + gl.wout + static_cast<size_t>(h) * dh * D,
                    D, first);  // dwout_h = o_h^T dp1
      __syncthreads();
      mm_w<C, kRounded, true>(dp1, D, rows, D, wo, D, dh, nullptr, dO, ldh);  // dO = dp1 wout_h^T
      __syncthreads();
      seq_abt(dO, v, ldh, rows, S, dh, dsc);  // da_d = dO v^T
      __syncthreads();
      seq_ptv<C>(pb, dO, ldh, rows, S, dh, v);  // dv = a_d^T dO, over v
      for (int r = tid / 32; r < rows; r += nwarps) {  // ds = (da - sum(da a)) a
        const uint64_t idx0 = ((static_cast<uint64_t>(seq0 + r / S) * H + h) * S + r % S) * S;
        float* da = dsc + r * S;
        const float* a = sc + r * S;
        float s = 0.f;
        for (int j = lane; j < S; j += 32) {
          const float d = da[j] * drop_mult(dc, kSiteAttn, idx0 + j);
          da[j] = d;
          s += d * a[j];
        }
        s = warp_sum(s);
        __syncwarp();
        for (int j = lane; j < S; j += 32) da[j] = round_to<C>((da[j] - s) * a[j]);
      }
      __syncthreads();
      seq_pv<C>(dsc, k, ldh, rows, S, dh, dO);  // dq = ds k, over dO
      __syncthreads();
      seq_ptv<C>(dsc, q, ldh, rows, S, dh, k);  // dk = ds^T q, over k
      __syncthreads();
      const float* dqkv[3] = {dO, k, v};
      for (int j = 0; j < 3; ++j) {
        // dwqkv[:, j*I + h*dh ...] = h1^T dq/dk/dv; dh1 += dq/dk/dv W_j,h^T.
        // The same thread owns the same dh1 elements in each of the three
        // products, so they need no barrier between them.
        mm_tn_partial(hb, D, dqkv[j], ldh, rows, D, dh, part + gl.wqkv + j * I + h * dh, 3 * I,
                      first);
        mm_w<C, kAdd, true>(dqkv[j], ldh, rows, dh, wq + j * I, 3 * I, D, nullptr, xs, D);
      }
      __syncthreads();
    }

    // ---- LN1 backward: dx0 = dx1 + LN1'(dh1) --------------------------------
    ln_param_partials(xs, x0, mu1, rs1, rows, D, part + gl.ln1s, part + gl.ln1b, first);
    __syncthreads();
    ln_bwd_rows(xs, x0, mu1, rs1, rows, D, ln1s, acc);
    __syncthreads();
    for (int i = tid; i < rows * D; i += nthr) dx[row0 * D + i] = from_f<T>(xs[i]);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Tensor-core form (bf16 compute): the row kernel of the split backward

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 512;
constexpr int kPad = 8;  // bf16 row padding: keeps WMMA strides a multiple of 8 and staggers banks

__host__ __device__ inline size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }
__host__ __device__ inline size_t larger(size_t a, size_t b) { return a > b ? a : b; }

// the tensor-core form's buffers that may live in device memory, in the
// order the levels move them there (level 1 moves none: it stops staging
// the weights)
enum TcSpill : unsigned { kTAcc = 1, kTXs = 2, kTDsc = 4, kTSc = 8, kTDgd = 16, kTU = 32 };
__host__ __device__ inline unsigned tc_spill(int level) {
  const unsigned order[] = {0u, kTAcc, kTXs, kTDsc, kTSc, kTDgd, kTU};
  return spill_bits(order, level);
}
constexpr int kTcLevels = 8;

// Byte offsets of the tensor-core form's buffers, each on a 128-byte
// boundary: in shared memory (`bytes`) or, by its bit in `spill`, in the
// block's device scratch (`gbytes`). R is the block's row count rounded up
// to 16; rows past the block's real rows are kept zero in the products'
// operands. Level 0 stages the weights in shared memory (`staged`); higher
// levels read them from device memory.
struct TcBwdPlan {
  int R, ld_h, ld_q, ld_sc, ld_p, ld_u, ld_g, ld_w3, ld_wd, ld_w1;
  bool staged;
  unsigned spill;
  size_t xs, acc, hb, dp1, q, k, v, dO, sc, dsc, p, u, dgd, g, dp2, wst, wst2, w1s, w2s;
  size_t stage, stats, bytes, gbytes;

  __host__ __device__ TcBwdPlan(int S, int D, int dh, int F, int nwarps, int level = 0) {
    R = round_up(seqs_per_block(S) * S, 16);
    ld_h = D + kPad;
    ld_q = dh + kPad;
    ld_sc = R + 4;
    ld_p = R + kPad;
    ld_u = F + 4;
    ld_g = F + kPad;
    ld_w3 = 3 * dh + kPad;
    ld_wd = D + kPad;
    ld_w1 = F + kPad;
    staged = level == 0;
    spill = tc_spill(level);
    Placer pl(spill, 128);
    xs = pl.put(sizeof(float) * R * D, kTXs);     // x1, then the dh1 accumulator
    acc = pl.put(sizeof(float) * R * D, kTAcc);   // projection sum, then dh2, then dx1
    hb = pl.put(sizeof(bf16) * R * ld_h, 0);      // h1 / h2
    dp1 = pl.put(sizeof(bf16) * R * ld_h, 0);     // dx1 * mask3
    const size_t region = pl.shared;
    q = pl.put(sizeof(bf16) * R * ld_q, 0);       // q, then the head's output
    k = pl.put(sizeof(bf16) * R * ld_q, 0);       // k, then dk
    v = pl.put(sizeof(bf16) * R * ld_q, 0);       // v, then dv
    dO = pl.put(sizeof(bf16) * R * ld_q, 0);      // o_h, then dO, then dq
    sc = pl.put(sizeof(float) * R * ld_sc, kTSc);   // scores, then a
    dsc = pl.put(sizeof(float) * R * ld_sc, kTDsc); // da_d
    p = pl.put(sizeof(bf16) * R * ld_p, 0);       // a * mask1, then ds
    size_t m = region;  // the MLP phase, over the attention buffers in shared memory
    auto put_mlp = [&](size_t n, unsigned bit) {
      if (spill & bit) return pl.put(n, bit);
      const size_t at = m;
      m += align128(n);
      return at;
    };
    u = put_mlp(sizeof(float) * R * ld_u, kTU);      // fc1 pre-activation
    dgd = put_mlp(sizeof(float) * R * ld_u, kTDgd);  // the dropped GELU output's gradient
    g = put_mlp(sizeof(bf16) * R * ld_g, 0);         // dropped GELU output, then du
    dp2 = put_mlp(sizeof(bf16) * R * ld_h, 0);       // dy * mask7
    size_t o = larger(pl.shared, m);
    // staged weights: q/k/v of one head [D, 3dh] and its out-projection
    // rows [dh, D]; in the MLP phase w1 [D, F] and w2 [F, D]
    wst = o;
    wst2 = wst + align128(sizeof(bf16) * D * ld_w3);
    w1s = wst;
    w2s = wst + align128(sizeof(bf16) * D * ld_w1);
    if (staged)
      o = larger(wst2 + align128(sizeof(bf16) * dh * ld_wd),
                 w2s + align128(sizeof(bf16) * F * ld_wd));
    stage = o; o += align128(sizeof(float) * 256 * nwarps);  // one 16x16 tile per warp
    stats = o; o += align128(sizeof(float) * 4 * R);          // mu1, rsig1, mu2, rsig2
    bytes = o;
    gbytes = pl.device;
  }
};

// dst [K, N] (row stride ldd) = src [K, N] (row stride lds), both bf16 with
// 16-byte aligned rows and N a multiple of 8: weight slices from L2 into
// shared memory, and the weight-gradient operands out to device memory
__device__ void copy_rows(const bf16* __restrict__ src, size_t lds, int K, int N,
                          bf16* __restrict__ dst, size_t ldd) {
  const int vec = N / 8;
  for (int i = threadIdx.x; i < K * vec; i += blockDim.x) {
    const int r = i / vec, c = (i % vec) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// dst [K, N] (row stride ldd, shared memory) = src [K, N] (row stride lds,
// device memory), bf16 as copy_rows, issued with cp.async: the copy lands
// while the block computes; cp_async_wait_all() and a barrier come before
// dst is read
__device__ void stage_async(const bf16* __restrict__ src, size_t lds, int K, int N, bf16* dst,
                            int ldd) {
  const int vec = N / 8;
  for (int i = threadIdx.x; i < K * vec; i += blockDim.x) {
    const int r = i / vec, c = (i % vec) * 8;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ldd + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + r * lds + c));
  }
}

// wait until this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

enum TcOut { kTcBf16, kTcF32, kTcAccF32, kTcBiasF32 };

// out [M, N] <op>= A [M, K] x B [K, N] on the tensor cores, one 16x16
// output tile per warp at a time (the same warp owns the same tile in every
// call with the same M and N). A is row-major (A[m * lda + k]) or, with
// wmma::col_major, a transposed view (A[k * lda + m]); B likewise
// (B[k * ldb + n], or B[n * ldb + k]).
template <int EPI, typename AL, typename BL>
__device__ void tcmm(const bf16* A, int lda, int M, int K, const bf16* B, int ldb, int N,
                     void* out, int ldo, const float* __restrict__ bias, float* stage) {
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32, lane = threadIdx.x % 32;
  const int tn = N / 16, tiles = (M / 16) * tn;
  float* st = stage + warp * 256;
  for (int t = warp; t < tiles; t += nwarps) {
    const int r0 = (t / tn) * 16, c0 = (t % tn) * 16;
    float* o32 = static_cast<float*>(out) + static_cast<size_t>(r0) * ldo + c0;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (EPI == kTcAccF32)
      wmma::load_matrix_sync(acc, o32, ldo, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, AL> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BL> b;
      if constexpr (std::is_same<AL, wmma::row_major>::value)
        wmma::load_matrix_sync(a, A + r0 * lda + kk, lda);
      else
        wmma::load_matrix_sync(a, A + kk * lda + r0, lda);
      if constexpr (std::is_same<BL, wmma::row_major>::value)
        wmma::load_matrix_sync(b, B + kk * ldb + c0, ldb);
      else
        wmma::load_matrix_sync(b, B + c0 * ldb + kk, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    if (EPI == kTcF32 || EPI == kTcAccF32) {
      wmma::store_matrix_sync(o32, acc, ldo, wmma::mem_row_major);
      continue;
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = r0 + e / 16, c = c0 + e % 16;
      if (EPI == kTcBf16)
        static_cast<bf16*>(out)[r * ldo + c] = __float2bfloat16(st[e]);
      else  // kTcBiasF32
        static_cast<float*>(out)[r * ldo + c] = st[e] + bias[c];
    }
    __syncwarp();
  }
}

// LN over the rows of src [rows, D] (fp32) with statistics saved, rounded
// to bf16 into dst (row stride ldd); one warp per row
__device__ void ln_rows_bf16(const float* src, int rows, int D, const float* __restrict__ scale,
                             const float* __restrict__ bias, float* mu_out, float* rs_out,
                             bf16* dst, int ldd) {
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < rows; r += nwarps) {
    const float* x = src + r * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += x[c];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float t = x[c] - mu;
      v += t * t;
    }
    const float rsig = rsqrtf(warp_sum(v) / D + kLnEps);
    for (int c = lane; c < D; c += 32)
      dst[r * ldd + c] = __float2bfloat16((x[c] - mu) * rsig * scale[c] + bias[c]);
    if (lane == 0) {
      mu_out[r] = mu;
      rs_out[r] = rsig;
    }
  }
}

// two-pass fp32 statistics of the rows of x [rows, D] (device memory), one
// warp per row, as ln_rows_bf16 takes them
template <typename T>
__device__ void ln_stats_rows(const T* x, int rows, int D, float* mu_out, float* rs_out) {
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < rows; r += nwarps) {
    const T* xr = x + static_cast<size_t>(r) * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += to_f(xr[c]);
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float t = to_f(xr[c]) - mu;
      v += t * t;
    }
    const float rsig = rsqrtf(warp_sum(v) / D + kLnEps);
    if (lane == 0) {
      mu_out[r] = mu;
      rs_out[r] = rsig;
    }
  }
}

// The row kernel: dx, the weight gradients' bf16 operands (OperandLayout)
// and the block's partial sums of the small vectors (SmallLayout), with no
// weight-gradient product of its own. FLEX: a plan of level > 0 (weights
// read from device memory, some buffers in the block's slice of `scratch`);
// without it the plan of level 0, every pointer a shared one.
template <typename T, bool FLEX>
__global__ void __launch_bounds__(kTcThreads)
fused_layer_bwd_tc_kernel(const T* __restrict__ x, const float* __restrict__ x1,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                          const bf16* __restrict__ wqkv, const bf16* __restrict__ wout,
                          const float* __restrict__ bout,
                          const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                          const bf16* __restrict__ w1, const float* __restrict__ b1,
                          const bf16* __restrict__ w2, const float* __restrict__ b2,
                          bf16* __restrict__ ops, float* __restrict__ ws,
                          unsigned char* __restrict__ scratch, int B, int S, int D, int H, int dh,
                          int F, int level, DropCfg dc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % 32, nwarps = nthr / 32;
  const TcBwdPlan pl(S, D, dh, F, nwarps, FLEX ? level : 0);
  const int R = pl.R, I = H * dh;
  const SmallLayout sl(D, F);
  const OperandLayout ol(static_cast<long long>(B) * S, D, I, F);
  unsigned char* gblk = FLEX ? scratch + static_cast<size_t>(blockIdx.x) * pl.gbytes : nullptr;
  auto at = [&](size_t off, unsigned bit) {
    return FLEX && (pl.spill & bit) ? gblk + off : smem_raw + off;
  };
  float* xs = reinterpret_cast<float*>(at(pl.xs, kTXs));
  float* acc = reinterpret_cast<float*>(at(pl.acc, kTAcc));
  bf16* hb = reinterpret_cast<bf16*>(smem_raw + pl.hb);
  bf16* dp1 = reinterpret_cast<bf16*>(smem_raw + pl.dp1);
  bf16* q = reinterpret_cast<bf16*>(smem_raw + pl.q);
  bf16* k = reinterpret_cast<bf16*>(smem_raw + pl.k);
  bf16* v = reinterpret_cast<bf16*>(smem_raw + pl.v);
  bf16* dO = reinterpret_cast<bf16*>(smem_raw + pl.dO);
  float* sc = reinterpret_cast<float*>(at(pl.sc, kTSc));
  float* dsc = reinterpret_cast<float*>(at(pl.dsc, kTDsc));
  bf16* p = reinterpret_cast<bf16*>(smem_raw + pl.p);
  float* u = reinterpret_cast<float*>(at(pl.u, kTU));
  float* dgd = reinterpret_cast<float*>(at(pl.dgd, kTDgd));
  bf16* g = reinterpret_cast<bf16*>(smem_raw + pl.g);
  bf16* dp2 = reinterpret_cast<bf16*>(smem_raw + pl.dp2);
  bf16* wst = reinterpret_cast<bf16*>(smem_raw + pl.wst);
  bf16* wst2 = reinterpret_cast<bf16*>(smem_raw + pl.wst2);
  bf16* w1s = reinterpret_cast<bf16*>(smem_raw + pl.w1s);
  bf16* w2s = reinterpret_cast<bf16*>(smem_raw + pl.w2s);
  float* stage = reinterpret_cast<float*>(smem_raw + pl.stage);
  float* mu1 = reinterpret_cast<float*>(smem_raw + pl.stats);
  float* rs1 = mu1 + R;
  float* mu2 = rs1 + R;
  float* rs2 = mu2 + R;
  float* part = ws + static_cast<size_t>(blockIdx.x) * sl.total;
  const bf16 zero = __float2bfloat16(0.f);

  const int seqs = seqs_per_block(S);
  const int nblocks = (B + seqs - 1) / seqs;
  bool first = true;

  // the weight slices, staged with cp.async as soon as their buffer is free:
  // head h's q, k or v columns (j = 0, 1, 2) side by side in wst, its
  // out-projection rows in wst2; w1 and w2 over them for the MLP phase.
  // Under FLEX nothing is staged: the products read the weights where they
  // lie in device memory.
  auto stage_qkv = [&](int h, int j) {
    if (!FLEX) stage_async(wqkv + j * I + h * dh, 3 * I, D, dh, wst + j * dh, pl.ld_w3);
  };
  auto stage_out = [&](int h) {
    if (!FLEX) stage_async(wout + static_cast<size_t>(h) * dh * D, D, dh, D, wst2, pl.ld_wd);
  };
  auto stage_mlp = [&]() {
    if (FLEX) return;
    stage_async(w1, F, D, F, w1s, pl.ld_w1);
    stage_async(w2, D, F, D, w2s, pl.ld_wd);
  };
  // head h's q, k or v columns [D, dh], its out-projection rows [dh, D], w1
  // and w2: staged, or in device memory
  auto wj = [&](int h, int j) -> const bf16* { return FLEX ? wqkv + j * I + h * dh : wst + j * dh; };
  const int ld_wj = FLEX ? 3 * I : pl.ld_w3;
  auto wo = [&](int h) -> const bf16* { return FLEX ? wout + static_cast<size_t>(h) * dh * D : wst2; };
  const int ld_wo = FLEX ? D : pl.ld_wd;
  const bf16* w1m = FLEX ? w1 : w1s;
  const int ld_w1m = FLEX ? F : pl.ld_w1;
  const bf16* w2m = FLEX ? w2 : w2s;
  const int ld_w2m = FLEX ? D : pl.ld_wd;
  // q, k, v of head h from hb and the head's slices; scores into sc
  auto qkv_scores = [&](int h) {
    for (int j = 0; j < 3; ++j)
      tcmm<kTcBf16, wmma::row_major, wmma::row_major>(hb, pl.ld_h, R, D, wj(h, j), ld_wj,
                                                      dh, j == 0 ? q : (j == 1 ? k : v), pl.ld_q,
                                                      nullptr, stage);
    __syncthreads();
    tcmm<kTcF32, wmma::row_major, wmma::col_major>(q, pl.ld_q, R, dh, k, pl.ld_q, R, sc, pl.ld_sc,
                                                   nullptr, stage);
    __syncthreads();
  };
  // softmax over each row's own sequence; p = a * mask1 rounded (exact
  // zeros elsewhere and on the padding rows); with keep_a, sc = a
  auto softmax = [&](int h, int seq0, int rows, bool keep_a) {
    for (int r = tid / 32; r < R; r += nwarps) {
      bf16* pr = p + r * pl.ld_p;
      float* s = sc + r * pl.ld_sc;
      if (r >= rows) {
        for (int c = lane; c < R; c += 32) pr[c] = zero;
        continue;
      }
      const int lo = r / S * S, hi = lo + S;
      float m = __int_as_float(0xff800000);  // -inf
      for (int c = lo + lane; c < hi; c += 32) m = fmaxf(m, s[c]);
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lo + lane; c < hi; c += 32) sum += expf(s[c] - m);
      const float inv = 1.f / warp_sum(sum);
      __syncwarp();
      const uint64_t idx0 = ((static_cast<uint64_t>(seq0 + r / S) * H + h) * S + r % S) * S;
      for (int c = lane; c < R; c += 32) {
        const bool own = c >= lo && c < hi;
        const float a = own ? expf(s[c] - m) * inv : 0.f;
        if (keep_a) s[c] = a;
        pr[c] = __float2bfloat16(own ? a * drop_mult(dc, kSiteAttn, idx0 + c - lo) : 0.f);
      }
    }
  };

  for (size_t i = tid; i < pl.bytes / sizeof(uint4); i += nthr)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  if (FLEX)
    for (size_t i = tid; i < pl.gbytes / sizeof(uint4); i += nthr)
      reinterpret_cast<uint4*>(gblk)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  stage_mlp();

  for (int blk = blockIdx.x; blk < nblocks; blk += gridDim.x, first = false) {
    const int seq0 = blk * seqs;
    const int rows = min(seqs, B - seq0) * S;
    const long long row0 = static_cast<long long>(seq0) * S;
    const T* x0 = x + row0 * D;
    const T* dyb = dy + row0 * D;

    // ---- x1 from the forward; LN1's statistics from x0 -----------------------
    for (int i = tid; i < R * D; i += nthr) xs[i] = i < rows * D ? x1[row0 * D + i] : 0.f;
    for (int i = tid; i < R * pl.ld_h; i += nthr) {
      hb[i] = zero;
      dp1[i] = zero;
    }
    ln_stats_rows(x0, rows, D, mu1, rs1);
    __syncthreads();
    ln_rows_bf16(xs, rows, D, ln2s, ln2b, mu2, rs2, hb, pl.ld_h);
    cp_async_wait_all();  // w1, w2
    __syncthreads();

    // ---- MLP: forward, then backward ---------------------------------------
    copy_rows(hb, pl.ld_h, rows, D, ops + ol.h2 + row0 * D, D);
    tcmm<kTcBiasF32, wmma::row_major, wmma::row_major>(hb, pl.ld_h, R, D, w1m, ld_w1m, F, u,
                                                       pl.ld_u, b1, stage);
    for (int c = tid; c < D; c += nthr) {  // dp2 = dy * mask7; db2
      float s = 0.f;
      for (int r = 0; r < R; ++r) {
        float val = 0.f;
        if (r < rows) {
          val = to_f(dyb[r * D + c]) *
                drop_mult(dc, kSiteFfOut, static_cast<uint64_t>(row0 + r) * D + c);
          s += val;
        }
        dp2[r * pl.ld_h + c] = __float2bfloat16(val);
      }
      put(part + sl.b2 + c, s, first);
    }
    __syncthreads();
    copy_rows(dp2, pl.ld_h, rows, D, ops + ol.dp2 + row0 * D, D);
    for (int i = tid; i < R * F; i += nthr) {
      const int r = i / F, c = i % F;
      g[r * pl.ld_g + c] = __float2bfloat16(
          r < rows ? gelu(u[r * pl.ld_u + c]) *
                         drop_mult(dc, kSiteFfMid, static_cast<uint64_t>(row0 + r) * F + c)
                   : 0.f);
    }
    __syncthreads();
    copy_rows(g, pl.ld_g, rows, F, ops + ol.gd + row0 * F, F);
    tcmm<kTcF32, wmma::row_major, wmma::col_major>(dp2, pl.ld_h, R, D, w2m, ld_w2m, F, dgd,
                                                   pl.ld_u, nullptr, stage);  // dp2 w2^T
    __syncthreads();
    for (int c = tid; c < F; c += nthr) {  // du = dgd * mask5 * gelu'(u); db1
      float s = 0.f;
      for (int r = 0; r < R; ++r) {
        float du = 0.f;
        if (r < rows) {
          du = dgd[r * pl.ld_u + c] *
               drop_mult(dc, kSiteFfMid, static_cast<uint64_t>(row0 + r) * F + c) *
               gelu_grad(u[r * pl.ld_u + c]);
          s += du;
        }
        g[r * pl.ld_g + c] = __float2bfloat16(du);
      }
      put(part + sl.b1 + c, s, first);
    }
    __syncthreads();
    copy_rows(g, pl.ld_g, rows, F, ops + ol.du + row0 * F, F);
    tcmm<kTcF32, wmma::row_major, wmma::col_major>(g, pl.ld_g, R, F, w1m, ld_w1m, D, acc, D,
                                                   nullptr, stage);  // dh2 = du w1^T
    __syncthreads();
    for (int j = 0; j < 3; ++j) stage_qkv(0, j);  // w1 and w2 are done with
    stage_out(0);
    ln_param_partials(acc, xs, mu2, rs2, rows, D, part + sl.ln2s, part + sl.ln2b, first);
    __syncthreads();
    ln_bwd_rows(acc, xs, mu2, rs2, rows, D, ln2s, dyb);  // acc = dx1 = dy + LN2'(dh2)
    __syncthreads();
    for (int c = tid; c < D; c += nthr) {  // dp1 = dx1 * mask3; dbout
      float s = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float m = dc.proj ? drop_mult(dc, kSiteProj, (row0 + r) * D + c) : 1.f;
        const float val = acc[r * D + c] * m;
        s += val;
        dp1[r * pl.ld_h + c] = __float2bfloat16(val);
      }
      put(part + sl.bout + c, s, first);
    }
    for (int i = tid; i < rows * D; i += nthr) {  // h1 again, from the saved statistics
      const int r = i / D, c = i % D;
      hb[r * pl.ld_h + c] =
          __float2bfloat16((to_f(x0[i]) - mu1[r]) * rs1[r] * ln1s[c] + ln1b[c]);
    }
    for (int i = tid; i < R * D; i += nthr) xs[i] = 0.f;  // the dh1 accumulator
    __syncthreads();
    copy_rows(dp1, pl.ld_h, rows, D, ops + ol.dp1 + row0 * D, D);
    copy_rows(hb, pl.ld_h, rows, D, ops + ol.h1 + row0 * D, D);

    // ---- attention backward, one head at a time ----------------------------
    // Head h + 1's slices are staged into each buffer once head h has read
    // it for the last time: the out-projection after dO, v, q and k after
    // the dh1 product that uses each; after the last head, w1 and w2 of the
    // block's next row block.
    for (int h = 0; h < H; ++h) {
      const bool next = h + 1 < H;
      cp_async_wait_all();
      __syncthreads();
      qkv_scores(h);
      softmax(h, seq0, rows, true);  // sc = a, p = a * mask1
      __syncthreads();
      tcmm<kTcBf16, wmma::row_major, wmma::row_major>(p, pl.ld_p, R, R, v, pl.ld_q, dh, dO,
                                                      pl.ld_q, nullptr, stage);  // o_h
      __syncthreads();
      copy_rows(dO, pl.ld_q, rows, dh, ops + ol.o + row0 * I + h * dh, I);
      __syncthreads();
      tcmm<kTcBf16, wmma::row_major, wmma::col_major>(dp1, pl.ld_h, R, D, wo(h), ld_wo, dh, dO,
                                                      pl.ld_q, nullptr, stage);  // dO
      __syncthreads();
      if (next) stage_out(h + 1);
      tcmm<kTcF32, wmma::row_major, wmma::col_major>(dO, pl.ld_q, R, dh, v, pl.ld_q, R, dsc,
                                                     pl.ld_sc, nullptr, stage);  // da_d = dO v^T
      __syncthreads();
      tcmm<kTcBf16, wmma::col_major, wmma::row_major>(p, pl.ld_p, R, R, dO, pl.ld_q, dh, v,
                                                      pl.ld_q, nullptr, stage);  // dv = a_d^T dO
      __syncthreads();
      // dv out to device memory; dh1 += dv W_v,h^T (the dh1 products touch
      // only xs, so each overlaps the product beside it)
      copy_rows(v, pl.ld_q, rows, dh, ops + ol.dqkv + row0 * 3 * I + 2 * I + h * dh, 3 * I);
      tcmm<kTcAccF32, wmma::row_major, wmma::col_major>(v, pl.ld_q, R, dh, wj(h, 2), ld_wj,
                                                        D, xs, D, nullptr, stage);
      for (int r = tid / 32; r < rows; r += nwarps) {  // ds = (da - sum(da a)) a, over p
        const int lo = r / S * S, hi = lo + S;
        const uint64_t idx0 = ((static_cast<uint64_t>(seq0 + r / S) * H + h) * S + r % S) * S;
        const float* a = sc + r * pl.ld_sc;
        float* da = dsc + r * pl.ld_sc;
        float s = 0.f;
        for (int c = lo + lane; c < hi; c += 32) {
          const float d = da[c] * drop_mult(dc, kSiteAttn, idx0 + c - lo);
          da[c] = d;
          s += d * a[c];
        }
        s = warp_sum(s);
        __syncwarp();
        for (int c = lane; c < R; c += 32)
          p[r * pl.ld_p + c] = __float2bfloat16(c >= lo && c < hi ? (da[c] - s) * a[c] : 0.f);
      }
      __syncthreads();
      if (next) stage_qkv(h + 1, 2);
      tcmm<kTcBf16, wmma::row_major, wmma::row_major>(p, pl.ld_p, R, R, k, pl.ld_q, dh, dO,
                                                      pl.ld_q, nullptr, stage);  // dq = ds k
      __syncthreads();
      copy_rows(dO, pl.ld_q, rows, dh, ops + ol.dqkv + row0 * 3 * I + h * dh, 3 * I);
      tcmm<kTcAccF32, wmma::row_major, wmma::col_major>(dO, pl.ld_q, R, dh, wj(h, 0), ld_wj, D, xs,
                                                        D, nullptr, stage);  // dh1 += dq W_q,h^T
      tcmm<kTcBf16, wmma::col_major, wmma::row_major>(p, pl.ld_p, R, R, q, pl.ld_q, dh, k,
                                                      pl.ld_q, nullptr, stage);  // dk = ds^T q
      __syncthreads();
      if (next) stage_qkv(h + 1, 0);
      copy_rows(k, pl.ld_q, rows, dh, ops + ol.dqkv + row0 * 3 * I + I + h * dh, 3 * I);
      tcmm<kTcAccF32, wmma::row_major, wmma::col_major>(k, pl.ld_q, R, dh, wj(h, 1), ld_wj, D,
                                                        xs, D, nullptr, stage);  // dh1 += dk W_k,h^T
      __syncthreads();
      if (next)
        stage_qkv(h + 1, 1);
      else if (blk + static_cast<int>(gridDim.x) < nblocks)
        stage_mlp();
    }

    // ---- LN1 backward: dx0 = dx1 + LN1'(dh1) --------------------------------
    ln_param_partials(xs, x0, mu1, rs1, rows, D, part + sl.ln1s, part + sl.ln1b, first);
    __syncthreads();
    ln_bwd_rows(xs, x0, mu1, rs1, rows, D, ln1s, acc);
    __syncthreads();
    for (int i = tid; i < rows * D; i += nthr) dx[row0 * D + i] = from_f<T>(xs[i]);
    __syncthreads();
  }
}

// out[i] = sum over blocks b (in order) of ws[b, i]
__global__ void reduce_partials(const float* __restrict__ ws, float* __restrict__ out,
                                int nparts, size_t total) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nparts; ++b) s += ws[static_cast<size_t>(b) * total + i];
    out[i] = s;
  }
}

// the small vectors' entries of the gradient vector: the row kernel's
// partials (SmallLayout) summed over blocks in order
__global__ void reduce_small(const float* __restrict__ ws, float* __restrict__ grads, int nparts,
                             int D, int I, int F) {
  const SmallLayout sl(D, F);
  const GradLayout gl(D, I, F);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < sl.total; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nparts; ++b) s += ws[static_cast<size_t>(b) * sl.total + i];
    // ln1 scale/bias and bout, ln2 scale/bias are runs of the gradient vector
    const size_t at = i < sl.bout ? gl.ln1s + i
                      : i < sl.b1 ? gl.bout + (i - sl.bout)
                      : i < sl.b2 ? gl.b1 + (i - sl.b1)
                                  : gl.b2 + (i - sl.b2);
    grads[at] = s;
  }
}

// the card's opt-in limit on one block's shared memory, in bytes
cudaError_t smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

size_t fma_bytes(int S, int D, int dh, int F, int level) {
  return BwdPlan(S, D, dh, F, level).floats * sizeof(float);
}

size_t tc_bytes(int S, int D, int dh, int F, int level) {
  return TcBwdPlan(S, D, dh, F, kTcThreads / 32, level).bytes;
}

// the FMA form's block kernel, then the reduction of its partials
template <typename T, typename C, bool FLEX>
cudaError_t launch_as(const void* x, const void* dy, void* dx, const void* ln1s, const void* ln1b,
                      const void* wqkv, const void* wout, const void* bout, const void* ln2s,
                      const void* ln2b, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* ws, void* scratch, void* grads, int B, int S, int D,
                      int H, int dh, int F, int nparts, int level, DropCfg dc,
                      cudaStream_t stream) {
  auto kernel = fused_layer_bwd_kernel<T, C, FLEX>;
  const size_t bytes = fma_bytes(S, D, dh, F, level);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<nparts, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<const float*>(ln1s), static_cast<const float*>(ln1b),
      static_cast<const C*>(wqkv), static_cast<const C*>(wout), static_cast<const float*>(bout),
      static_cast<const float*>(ln2s), static_cast<const float*>(ln2b),
      static_cast<const C*>(w1), static_cast<const float*>(b1), static_cast<const C*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(ws), static_cast<float*>(scratch), B,
      S, D, H, dh, F, level, dc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = GradLayout(D, H * dh, F).total;
  const int threads = 256;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  reduce_partials<<<blocks, threads, 0, stream>>>(static_cast<const float*>(ws),
                                                  static_cast<float*>(grads), nparts, total);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch(const void* x, const void* dy, void* dx, const void* ln1s, const void* ln1b,
                   const void* wqkv, const void* wout, const void* bout, const void* ln2s,
                   const void* ln2b, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* ws, void* scratch, void* grads, int B, int S, int D,
                   int H, int dh, int F, int nparts, int level, DropCfg dc, cudaStream_t stream) {
  return (level ? launch_as<T, C, true> : launch_as<T, C, false>)(
      x, dy, dx, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1, w2, b2, ws, scratch, grads, B,
      S, D, H, dh, F, nparts, level, dc, stream);
}

// the row kernel, then the reduction of its small-vector partials
template <typename T, bool FLEX>
cudaError_t launch_tc_as(const void* x, const void* x1, const void* dy, void* dx,
                         const void* ln1s, const void* ln1b, const void* wqkv, const void* wout,
                         const void* bout, const void* ln2s, const void* ln2b, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* ops, void* ws,
                         void* scratch, void* grads, int B, int S, int D, int H, int dh, int F,
                         int nparts, int level, DropCfg dc, cudaStream_t stream) {
  auto kernel = fused_layer_bwd_tc_kernel<T, FLEX>;
  const size_t bytes = tc_bytes(S, D, dh, F, level);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<nparts, kTcThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(x1), static_cast<const T*>(dy),
      static_cast<T*>(dx),
      static_cast<const float*>(ln1s), static_cast<const float*>(ln1b),
      static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wout),
      static_cast<const float*>(bout), static_cast<const float*>(ln2s),
      static_cast<const float*>(ln2b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<bf16*>(ops), static_cast<float*>(ws), static_cast<unsigned char*>(scratch), B,
      S, D, H, dh, F, level, dc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = SmallLayout(D, F).total;
  reduce_small<<<(total + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                        static_cast<float*>(grads), nparts, D,
                                                        H * dh, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc(const void* x, const void* x1, const void* dy, void* dx,
                      const void* ln1s, const void* ln1b, const void* wqkv, const void* wout,
                      const void* bout, const void* ln2s, const void* ln2b, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* ops, void* ws,
                      void* scratch, void* grads, int B, int S, int D, int H, int dh, int F,
                      int nparts, int level, DropCfg dc, cudaStream_t stream) {
  return (level ? launch_tc_as<T, true> : launch_tc_as<T, false>)(
      x, x1, dy, dx, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1, w2, b2, ops, ws, scratch,
      grads, B, S, D, H, dh, F, nparts, level, dc, stream);
}

bool aligned(const void* ptr, uintptr_t n) { return reinterpret_cast<uintptr_t>(ptr) % n == 0; }
DropCfg drop_cfg(int on, int proj, int seed, int thr, float scale) {
  return DropCfg{on, proj, static_cast<uint32_t>(seed), static_cast<uint32_t>(thr), scale};
}

}  // namespace

// The plan a launch takes at this geometry. form: 0 the FMA form, 1 the
// tensor-core form. out[0]: the lowest level whose shared memory fits the
// card's opt-in limit, or -1 when none does; out[1]: that level's shared
// bytes (when none fits, the last level's, the least the form can take);
// out[2]: its device scratch bytes per block; out[3]: the card's limit.
// Returns a CUDA error code.
extern "C" int fused_layer_bwd_plan(int S, int D, int dh, int F, int form, long long* out) {
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int levels = form ? kTcLevels : kFmaLevels;
  out[0] = -1;
  out[3] = limit;
  for (int level = 0; level < levels; ++level) {
    const size_t bytes = form ? tc_bytes(S, D, dh, F, level) : fma_bytes(S, D, dh, F, level);
    out[1] = static_cast<long long>(bytes);
    out[2] = static_cast<long long>(
        form ? TcBwdPlan(S, D, dh, F, kTcThreads / 32, level).gbytes
             : BwdPlan(S, D, dh, F, level).gfloats * sizeof(float));
    if (bytes <= static_cast<size_t>(limit)) {
      out[0] = level;
      break;
    }
  }
  return 0;
}

// The FMA form. x, dy, dx: [B, S, D] in T (fp32, or bf16 when io_bf16).
// Weights as for fused_layer_fwd (wqkv's q block pre-scaled) in the compute
// type (bf16 when compute_bf16, else fp32); LN scales/biases and biases in
// fp32. ws: fp32 workspace of nparts x (gradient count) floats, where nparts
// is the grid (at most the number of row blocks); scratch: nparts x the
// plan's scratch bytes (fused_layer_bwd_plan, form 0, at `level`; null when
// those are 0); grads: the fp32 gradient vector in the order ln1s, ln1b,
// wqkv, wout, bout, ln2s, ln2b, w1, b1, w2, b2. Dropout arguments as for
// fused_layer_fwd. Launches the block kernel and the reduction on `stream`;
// returns cudaGetLastError().
extern "C" int fused_layer_bwd(const void* x, const void* dy, void* dx, const void* ln1s,
                               const void* ln1b, const void* wqkv, const void* wout,
                               const void* bout, const void* ln2s, const void* ln2b,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* ws, void* scratch, void* grads, int B, int S, int D, int H,
                               int dh, int F, int io_bf16, int compute_bf16, int nparts,
                               int level, int drop_on, int drop_proj, int drop_seed, int drop_thr,
                               float drop_scale, void* stream) {
  if (level < 0 || level >= kFmaLevels) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const DropCfg dc = drop_cfg(drop_on, drop_proj, drop_seed, drop_thr, drop_scale);
  cudaError_t err;
  if (io_bf16 && compute_bf16)
    err = launch<bf16, bf16>(x, dy, dx, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1, w2, b2,
                             ws, scratch, grads, B, S, D, H, dh, F, nparts, level, dc, st);
  else if (io_bf16)
    err = launch<bf16, float>(x, dy, dx, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1, w2,
                              b2, ws, scratch, grads, B, S, D, H, dh, F, nparts, level, dc, st);
  else if (compute_bf16)
    err = launch<float, bf16>(x, dy, dx, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1, w2,
                              b2, ws, scratch, grads, B, S, D, H, dh, F, nparts, level, dc, st);
  else
    err = launch<float, float>(x, dy, dx, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1, w2,
                               b2, ws, scratch, grads, B, S, D, H, dh, F, nparts, level, dc, st);
  return static_cast<int>(err);
}

// The tensor-core form's row kernel (bf16 compute; D, dh and F multiples of
// 16; bf16 weights 16-byte aligned, 32-byte aligned from level 1, where the
// products read them in place). Arguments as for fused_layer_bwd, and:
// x1, the fp32 [B, S, D] residual stream after attention that
// fused_layer_fwd wrote for this x;
// ops, the bf16 operand buffer of OperandLayout (N = B * S rows, 16-byte
// aligned) that layer_wgrad.cu reads; ws, nparts x (6D + F) floats of
// small-vector partials; scratch as for fused_layer_bwd (form 1, 128-byte
// aligned). Writes dx, ops and the small vectors' entries of grads
// (layer_wgrad writes the four weight gradients).
extern "C" int fused_layer_bwd_tc(const void* x, const void* x1, const void* dy, void* dx,
                                  const void* ln1s,
                                  const void* ln1b, const void* wqkv, const void* wout,
                                  const void* bout, const void* ln2s, const void* ln2b,
                                  const void* w1, const void* b1, const void* w2, const void* b2,
                                  void* ops, void* ws, void* scratch, void* grads, int B, int S,
                                  int D, int H, int dh, int F, int io_bf16, int nparts, int level,
                                  int drop_on, int drop_proj, int drop_seed, int drop_thr,
                                  float drop_scale, void* stream) {
  const uintptr_t wal = level ? 32 : 16;
  if (D % 16 || dh % 16 || F % 16 || level < 0 || level >= kTcLevels || !aligned(wqkv, wal) ||
      !aligned(wout, wal) || !aligned(w1, wal) || !aligned(w2, wal) || !aligned(ops, 16) ||
      !aligned(scratch, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const DropCfg dc = drop_cfg(drop_on, drop_proj, drop_seed, drop_thr, drop_scale);
  const cudaError_t err =
      io_bf16 ? launch_tc<bf16>(x, x1, dy, dx, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1,
                                w2, b2, ops, ws, scratch, grads, B, S, D, H, dh, F, nparts, level,
                                dc, st)
              : launch_tc<float>(x, x1, dy, dx, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1,
                                 w2, b2, ops, ws, scratch, grads, B, S, D, H, dh, F, nparts,
                                 level, dc, st);
  return static_cast<int>(err);
}
