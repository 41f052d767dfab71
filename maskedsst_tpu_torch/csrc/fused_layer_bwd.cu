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
// Tensor cores (bf16 compute; D, dh and F multiples of 16): a row kernel
// here, then layer_wgrad.cu. The row kernel writes dx, the bf16 operands of
// the four weight gradients (5,120 bytes a row at the EnMAP widths, which
// layer_wgrad.cu multiplies over all rows at once) and, per block, partial
// sums of the small vectors (LN scales/biases, biases), which reduce_small
// adds in block order. It starts from x1 = x0 + attention, which the
// forward's training call wrote (fp32), so the attention forward is
// recomputed only once, per head inside its backward.
//
// What bounds it on the H100: neither operations nor bytes (its bound, set
// by its operand writes, is 0.149 ms a launch at batch 64) but latency and
// the issue of its epilogues' instructions: the softmax, the dropout hash
// and the LN backward cost far more instructions than its ~4,400
// mma.sync a warp and row block. The WMMA layout this form replaces held
// the whole 64-row block in 226 KB of shared memory, one 512-thread block
// per SM, and walked ~60 small products per row block, one 16x16 tile per
// warp at a time, each ending in a block-wide barrier (3.58 ms a launch).
//
// What this design does about it, up to 64 rows a block (the forward's
// layout): a block owns the rows of whole sequences (one at S 64, three at
// S 20, twelve at S 5), one warp 16 of them from the x1 load to the dx
// store, and a persistent grid of two blocks per SM walks the row blocks.
// Every product is mma.sync.m16n8k16 (bf16, fp32 sums) with A fragments in
// registers and B fragments by ldmatrix from shared memory; every epilogue
// (rounding, the dropout masks, GELU', the LN backward with quad shuffles)
// works on the accumulator fragments:
//  - the MLP: LN2 of x1, u = h2 w1 + b1, dp2 = dy * mask7, du, dh2 = du
//    w1^T, dx1 = dy + LN2'(dh2) and dp1 = dx1 * mask3; LN1 from x again;
//  - attention backward per head: q, k, v and dO = dp1 wout_h^T of the
//    warp's rows (h1 and dp1 read back from the operand buffer, each by the
//    thread that wrote it), the scores and the probabilities a (fp32) only
//    as fragments over the warp's key window, o = a_d v, da = (dO v^T) *
//    mask1 (the mask's bits kept from the softmax), ds = (da - sum(da a))
//    a, dq = ds k; dh1 += dq W_q,h^T in registers across heads. Products
//    over the key window issue every 16-key step (rows clamped into the
//    tile, A zero past the window) so that no branch divides a warp around
//    ldmatrix;
//  - dk = ds^T q and dv = a_d^T dO sum over query rows of several warps:
//    each warp writes its rows of q, dO, a_d and ds to shared memory and,
//    after a barrier, takes as the owner of its 16 key rows the sums over
//    the query rows that see them in k-step order (ldmatrix.trans of a_d
//    and ds): one warp per output row, no atomics, two calls give the same
//    bits. dh1 += dk W_k,h^T + dv W_v,h^T;
//  - after the last head, dx = dx1 + LN1'(dh1), with dx1 computed again
//    bit for bit from du and w1, so that it holds no registers through the
//    heads;
//  - the small vectors' column sums: over a warp's 16 rows by shuffles in
//    a fixed order, staged in shared memory, then over the warps in warp
//    order into the block's partial row;
//  - shared memory holds the head's q/k/v columns of wqkv and its
//    out-projection rows (w1 and w2 over them in the MLP phase), and k, v,
//    q, dO, a_d and ds of the block's rows: 107,008 bytes at the EnMAP
//    widths, so two 128-thread blocks fit on an SM (255 registers a
//    thread). Four barriers a head; cp.async stages the next head's W_q and
//    out-projection rows under the key pass, its W_k and W_v under its q
//    and dO products.
//
// Past 64 rows a block (ViTRGB's cls-token sequence of 65 at the EnMAP
// widths: 80 rows) the row kernel is the planned WMMA kernel below, chosen
// by shape in the wrapper: the whole row block in shared memory (the fp32
// streams, the bf16 operands with padded rows, one block-diagonal [rows,
// rows] attention tile per head, the MLP buffers over the attention
// buffers), products of 16x16x16 WMMA tiles, one 512-thread block per SM.
// Its rows no longer fit the card's opt-in 227 KB of shared memory
// (278,016 bytes at S = 65, 242,784 for the FMA form), so each form takes
// a plan of a higher level (fused_layer_bwd_plan): the WMMA kernel first
// reads its weight slices from device memory instead of staging them
// (226,304 bytes at S = 65), then each level moves one more buffer (the
// [rows, D] fp32 streams, the score tiles, the MLP's fp32 buffers; for the
// FMA form also the bf16 streams) to a per-block scratch in device memory,
// reached through L1 and L2, until the plan fits. Every geometry of the
// tensor-core widths (at most 128 rows) fits; the wrapper refuses one that
// no level fits, naming it.
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
#include "warp_mma.cuh"

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
  load_seed(dc);
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
// Tensor-core forms (bf16 compute): the row kernels of the split backward

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 row padding: 16-byte rows, ldmatrix and WMMA free of bank conflicts

__host__ __device__ inline size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }
__host__ __device__ inline size_t larger(size_t a, size_t b) { return a > b ? a : b; }

// dst [K, N] (row stride ldd, shared memory) = src [K, N] (row stride lds,
// device memory), bf16 with 16-byte aligned rows and N a multiple of 8,
// issued with cp.async: the copy lands while the block computes; a wait and
// a barrier come before dst is read
__device__ void stage_async(const bf16* __restrict__ src, size_t lds, int K, int N, bf16* dst,
                            int ldd) {
  const int vec = N / 8;
  for (int i = threadIdx.x; i < K * vec; i += blockDim.x) {
    const int r = i / vec, c = (i % vec) * 8;
    cp_async16(dst + r * ldd + c, src + r * lds + c);
  }
}

// the cp.async copies this thread issued since the last commit form a group
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until all but the N most recent groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows (whole sequences, rounded up to 16) of a row block.
__host__ __device__ inline int block_rows(int S) { return round_up(seqs_per_block(S) * S, 16); }

// ---------------------------------------------------------------------------
// The row kernel on register-resident warp tiles (row blocks of at most
// kWarpRows rows)

constexpr int kWarpRows = 64;
constexpr int kKT = kWarpRows / 8;  // 8-key score tiles: a warp's keys are at most a block's rows

// Byte offsets of the row kernel's shared memory: `wa` holds one head's q,
// k and v columns of wqkv side by side [D, 3dh] and, in the MLP phase, w1
// [D, F]; `wb` the head's out-projection rows [dh, D], and w2 [F, D]; then
// q, k, v and dO of the block's R rows [R, dh] and a_d and ds [R, R], over
// which the warps stage their small-vector partials [R / 16, 6D + F] (fp32)
// outside the heads.
struct WarpPlan {
  int R, ld_w3, ld_w1, ld_wd, ld_kv, ld_p;
  size_t wa, wb, q, k, v, dO, ad, ds, bytes;

  __host__ __device__ WarpPlan(int S, int D, int dh, int F) {
    R = block_rows(S);
    ld_w3 = 3 * dh + kPad;
    ld_w1 = F + kPad;
    ld_wd = D + kPad;
    ld_kv = dh + kPad;
    ld_p = R + kPad;
    size_t o = 0;
    wa = o; o += align128(sizeof(bf16) * D * larger(ld_w3, ld_w1));
    wb = o; o += align128(sizeof(bf16) * larger(dh, F) * ld_wd);
    q = o;  o += align128(sizeof(bf16) * R * ld_kv);
    k = o;  o += align128(sizeof(bf16) * R * ld_kv);
    v = o;  o += align128(sizeof(bf16) * R * ld_kv);
    dO = o; o += align128(sizeof(bf16) * R * ld_kv);
    const size_t tile = align128(sizeof(bf16) * R * ld_p);
    ad = o;
    ds = o + tile;
    o += larger(2 * tile, align128(sizeof(float) * (R / 16) * (6 * D + F)));
    bytes = o;
  }
};

// The rows up to hi (at most R) of the sequences of the block rows [r0,
// r0 + 16), from base (the first such row rounded down to 16): the keys
// the warp owning those rows sees (its score tile j holds keys base + 8j),
// and, the other way round, the query rows that see those rows as keys.
struct KeyWindow {
  int hi, base;

  __host__ __device__ KeyWindow(int S, int R, int r0)
      : hi(min(R, ((r0 + 15) / S + 1) * S)), base(r0 / S * S / 16 * 16) {}
};

// acc[j] (the 8-column tile at column n0 + 8j, j in [j_lo, j_hi), j_lo
// even) += A x B over the k-steps [k_lo, k_hi): A as register fragments, B
// from shared memory (TRANS: stored transposed, element (k, n) at W[n * ld
// + k]); KS and NT the maxima, the run-time bounds skip the rest
template <int KS, int NT, bool TRANS = false>
__device__ __forceinline__ void warp_mm(float (&acc)[NT][4], const uint32_t (&a)[KS][4],
                                        int k_lo, int k_hi, const bf16* W, int ld, int n0,
                                        int j_lo, int j_hi, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk < k_lo || kk >= k_hi) continue;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j < j_lo || j >= j_hi) continue;
      uint32_t b[4];
      if (TRANS)
        ldsm_nk(b, W, ld, 16 * kk, n0 + 8 * j, lane);
      else
        ldsm_kn(b, W, ld, 16 * kk, n0 + 8 * j, lane);
      mma16816(acc[j], a[kk], b[0], b[1]);
      mma16816(acc[j + 1], a[kk], b[2], b[3]);
    }
  }
}

// Products over a warp's key window (KeyWindow: from row `base` of tiles of
// R rows, `steps` 16-row steps): every step is issued, steps past the
// window on rows clamped into the tile with a zero A (or, for key columns,
// into scores the caller masks), so that no branch divides the warp around
// ldmatrix.
__device__ __forceinline__ int win_row(int base, int kk, int R) {
  return min(base + 16 * kk, R - 16);
}

// acc[j] (the 8 keys at base + 8j) += A x K^T, K [R, *] row-major in shared
// memory: the scores q k^T and da = dO v^T
template <int KS, int NT>
__device__ __forceinline__ void warp_mm_keys_n(float (&acc)[NT][4], const uint32_t (&a)[KS][4],
                                               int ks, const bf16* K, int ld, int base, int R,
                                               int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk >= ks) continue;
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_nk(b, K, ld, 16 * kk, win_row(base, j / 2, R), lane);
      mma16816(acc[j], a[kk], b[0], b[1]);
      mma16816(acc[j + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[j] (j < nt) += A x V over the window's key steps, A's fragments over
// the keys in registers, V [R, *] row-major in shared memory: o = a_d v and
// dq = ds k
template <int KS, int NT>
__device__ __forceinline__ void warp_mm_keys_k(float (&acc)[NT][4], const uint32_t (&a)[KS][4],
                                               int steps, const bf16* V, int ld, int base, int R,
                                               int nt, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const bool live = kk < steps;
    const uint32_t ak[4] = {live ? a[kk][0] : 0u, live ? a[kk][1] : 0u, live ? a[kk][2] : 0u,
                            live ? a[kk][3] : 0u};
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= nt) continue;
      uint32_t b[4];
      ldsm_kn(b, V, ld, win_row(base, kk, R), 8 * j, lane);
      mma16816(acc[j], ak, b[0], b[1]);
      mma16816(acc[j + 1], ak, b[2], b[3]);
    }
  }
}

// acc[j] (j < nt) += P^T x B over the window's query steps, where P^T is
// the [K, 16] slice at column m0 of a row-major shared tile P (read
// transposed by ldmatrix) and B [R, *] is row-major in shared memory: the
// key pass's dv = a_d^T dO and dk = ds^T q
template <int KS, int NT>
__device__ __forceinline__ void warp_mm_keys_t(float (&acc)[NT][4], const bf16* P, int ldp, int m0,
                                               const bf16* Bm, int ldb, int base, int steps, int R,
                                               int nt, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const bool live = kk < steps;
    const int row = win_row(base, kk, R);
    uint32_t t[4];
    ldsm_kn(t, P, ldp, row, m0, lane);
    const uint32_t a[4] = {live ? t[0] : 0u, live ? t[2] : 0u, live ? t[1] : 0u,
                           live ? t[3] : 0u};
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= nt) continue;
      uint32_t b[4];
      ldsm_kn(b, Bm, ldb, row, 8 * j, lane);
      mma16816(acc[j], a, b[0], b[1]);
      mma16816(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// the A fragments of ks k-steps of the warp's 16 rows (from r0) of a
// row-major bf16 tile in shared memory, by ldmatrix, from column col0;
// the k-steps from `steps` on zero (read at column 0)
template <int KS>
__device__ __forceinline__ void ldsm_afrag(uint32_t (&a)[KS][4], const bf16* tile, int ld, int r0,
                                           int ks, int lane, int col0 = 0, int steps = KS) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk >= ks) continue;
    const bool live = kk < steps;
    uint32_t t[4];
    ldsm_nk(t, tile, ld, live ? col0 + 16 * kk : 0, r0, lane);
    a[kk][0] = live ? t[0] : 0u;
    a[kk][1] = live ? t[2] : 0u;
    a[kk][2] = live ? t[1] : 0u;
    a[kk][3] = live ? t[3] : 0u;
  }
}

// accumulator tiles (j < nt) rounded to bf16 into rows ra, ra + 8 of a
// shared [*, ld] tile
template <int NT>
__device__ __forceinline__ void store_bf16(const float (&acc)[NT][4], bf16* dst, int ld, int ra,
                                           int nt, int c) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) continue;
    *reinterpret_cast<uint32_t*>(dst + ra * ld + 8 * j + 2 * c) = pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(dst + (ra + 8) * ld + 8 * j + 2 * c) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows (row a, row a + 8) of a [*, D] matrix in device memory as the
// thread's elements of nt accumulator tiles; rows that do not exist read 0
template <int NT, typename T>
__device__ __forceinline__ void load_rows(float (&v)[NT][4], const T* src, int D, int nt,
                                          bool ok_a, bool ok_b, int c) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 a = j < nt && ok_a ? load2(src + 8 * j + 2 * c) : make_float2(0.f, 0.f);
    const float2 b = j < nt && ok_b ? load2(src + 8 * D + 8 * j + 2 * c) : make_float2(0.f, 0.f);
    v[j][0] = a.x;
    v[j][1] = a.y;
    v[j][2] = b.x;
    v[j][3] = b.y;
  }
}

template <int NT, typename T>
__device__ __forceinline__ void store_rows(const float (&v)[NT][4], T* dst, int D, int nt,
                                           bool ok_a, bool ok_b, int c) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) continue;
    if (ok_a) store2(dst + 8 * j + 2 * c, v[j][0], v[j][1]);
    if (ok_b) store2(dst + 8 * D + 8 * j + 2 * c, v[j][2], v[j][3]);
  }
}

// A fragments of ks k-steps of the thread's two rows, out to (store_afrag)
// or back from (load_afrag) a bf16 matrix in device memory whose rows start
// at pa and pb: each thread reads back just what it wrote; rows that do not
// exist are neither written nor read (0)
template <int KS>
__device__ __forceinline__ void store_afrag(const uint32_t (&a)[KS][4], bf16* pa, bf16* pb, int ks,
                                            bool ok_a, bool ok_b, int c) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk >= ks) continue;
    const int col = 16 * kk + 2 * c;
    if (ok_a) {
      *reinterpret_cast<uint32_t*>(pa + col) = a[kk][0];
      *reinterpret_cast<uint32_t*>(pa + col + 8) = a[kk][2];
    }
    if (ok_b) {
      *reinterpret_cast<uint32_t*>(pb + col) = a[kk][1];
      *reinterpret_cast<uint32_t*>(pb + col + 8) = a[kk][3];
    }
  }
}

template <int KS>
__device__ __forceinline__ void load_afrag(uint32_t (&a)[KS][4], const bf16* pa, const bf16* pb,
                                           int ks, bool ok_a, bool ok_b, int c) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int col = 16 * kk + 2 * c;
    const bool in = kk < ks;
    a[kk][0] = in && ok_a ? *reinterpret_cast<const uint32_t*>(pa + col) : 0u;
    a[kk][1] = in && ok_b ? *reinterpret_cast<const uint32_t*>(pb + col) : 0u;
    a[kk][2] = in && ok_a ? *reinterpret_cast<const uint32_t*>(pa + col + 8) : 0u;
    a[kk][3] = in && ok_b ? *reinterpret_cast<const uint32_t*>(pb + col + 8) : 0u;
  }
}

// LN statistics of the thread's two rows (v: nt accumulator tiles, 0 past
// nt), two-pass fp32 as the plain version takes them (a mean is the sum
// times fl(1/D); the quad reduces with shuffles)
template <int NT>
__device__ __forceinline__ void ln_stats(const float (&v)[NT][4], int nt, int D, float (&mu)[2],
                                         float (&rs)[2]) {
  const float inv_d = 1.f / D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float t[2 * NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) t[2 * j + e] = v[j][2 * half + e];
    mu[half] = __fmul_rn(quad_sum(t), inv_d);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = v[j][2 * half + e] - mu[half];
        t[2 * j + e] = j < nt ? __fmul_rn(d, d) : 0.f;
      }
    rs[half] = rsqrtf(__fadd_rn(__fmul_rn(quad_sum(t), inv_d), kLnEps));
  }
}

// the normalised value z = (v - mu) rsig
__device__ __forceinline__ float ln_z(float v, float mu, float rs) { return __fmul_rn(v - mu, rs); }

// the LN output z * scale + bias of the thread's two rows, rounded to bf16
// as the A fragments of the next product; 0 on rows that do not exist
template <int KS>
__device__ __forceinline__ void ln_afrag(uint32_t (&a)[KS][4], const float (&v)[2 * KS][4], int nt,
                                         const float (&mu)[2], const float (&rs)[2],
                                         const float* __restrict__ scale,
                                         const float* __restrict__ bias, bool ok_a, bool ok_b,
                                         int c) {
  float o[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * c + e % 2, half = e / 2;
      o[j][e] = j < nt && (half ? ok_b : ok_a)
                    ? __fadd_rn(__fmul_rn(ln_z(v[j][e], mu[half], rs[half]), scale[col]), bias[col])
                    : 0.f;
    }
  to_afrag<KS>(a, o);
}

// The column sum over the warp's 16 rows of one value of the thread's two
// rows (va: row a, vb: row b; 0 on rows that do not exist) in a fixed
// order (row g with row g + 8, then a tree over g), stored by lanes 0-3 at
// p: the warp's staged partial.
__device__ __forceinline__ void col_sum(float va, float vb, float* p, int lane) {
  float s = va + vb;
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  if (lane < 4) *p = s;
}

// col_sum of each of the thread's elements of nt accumulator tiles into the
// warp's staged partial row p (columns 8j + 2c + e)
template <int NT>
__device__ __forceinline__ void col_sums(const float (&t)[NT][4], int nt, float* p, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) col_sum(t[j][e], t[j][2 + e], p + 8 * j + 2 * lane + e, lane);
  }
}

// The block's partial row (written on its first row block, else added to)
// of the entries [lo, hi) of the warps' staged partials, summed in warp
// order; after a barrier that follows the staging.
__device__ void block_sums(const float* staged, int nw, int total, int lo, int hi, float* part,
                           bool first) {
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    float s = staged[i];
    for (int w = 1; w < nw; ++w) s += staged[w * total + i];
    put(part + i, s, first);
  }
}

// The LN backward of the thread's two rows in the plain version's order, in
// place: g (the output's gradient) <- rsig (dz - mean(dz) - z mean(dz z)),
// dz = g * scale, the residual left to the caller; z rebuilt from the LN
// input v and its statistics. With PARTIALS, the scale's and the bias's
// column sums (g z and g) go to the warp's staged partials.
template <int NT, bool PARTIALS>
__device__ __forceinline__ void ln_bwd(float (&g)[NT][4], const float (&v)[NT][4], int nt, int D,
                                       const float (&mu)[2], const float (&rs)[2],
                                       const float* __restrict__ scale, float* pscale,
                                       float* pbias, int lane) {
  const int c = lane % 4;
  const float inv_d = 1.f / D;
  if (PARTIALS) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * c + e;
        col_sum(__fmul_rn(g[j][e], ln_z(v[j][e], mu[0], rs[0])),
                __fmul_rn(g[j][2 + e], ln_z(v[j][2 + e], mu[1], rs[1])), pscale + col, lane);
        col_sum(g[j][e], g[j][2 + e], pbias + col, lane);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float dz[2 * NT], t[2 * NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dz[2 * j + e] = j < nt ? __fmul_rn(g[j][2 * half + e], scale[8 * j + 2 * c + e]) : 0.f;
    const float m1 = __fmul_rn(quad_sum(dz), inv_d);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        t[2 * j + e] = __fmul_rn(dz[2 * j + e], ln_z(v[j][2 * half + e], mu[half], rs[half]));
    const float m2 = __fmul_rn(quad_sum(t), inv_d);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float z = ln_z(v[j][2 * half + e], mu[half], rs[half]);
        g[j][2 * half + e] =
            j < nt ? __fmul_rn(rs[half], __fsub_rn(__fsub_rn(dz[2 * j + e], m1), __fmul_rn(z, m2)))
                   : 0.f;
      }
  }
}

// dx1 = dy + LN2'(dh2) of the thread's two rows, dh2 = du w1^T (du: the A
// fragments, w1 staged [D, F] with row stride ld_w1), LN2's input x1 and
// its statistics; with PARTIALS, LN2's column sums staged at pscale and
// pbias
template <int KD, int KF, bool PARTIALS, typename T>
__device__ __forceinline__ void dx1_rows(float (&dx1)[2 * KD][4], const uint32_t (&du)[KF][4],
                                         int kd, int kf, const bf16* w1s, int ld_w1,
                                         const float* x1r, const T* dyr, int D, bool ok_a,
                                         bool ok_b, const float (&mu)[2], const float (&rs)[2],
                                         const float* __restrict__ ln2s, float* pscale,
                                         float* pbias, int lane) {
  const int c = lane % 4;
  zero(dx1);
  warp_mm<KF, 2 * KD, true>(dx1, du, 0, kf, w1s, ld_w1, 0, 0, 2 * kd, lane);
  {
    float v[2 * KD][4];
    load_rows<2 * KD>(v, x1r, D, 2 * kd, ok_a, ok_b, c);
    ln_bwd<2 * KD, PARTIALS>(dx1, v, 2 * kd, D, mu, rs, ln2s, pscale, pbias, lane);
  }
  float t[2 * KD][4];
  load_rows<2 * KD>(t, dyr, D, 2 * kd, ok_a, ok_b, c);
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dx1[j][e] = __fadd_rn(t[j][e], dx1[j][e]);
}

// The row kernel: dx, the weight gradients' bf16 operands (OperandLayout)
// and the warps' partial sums of the small vectors (SmallLayout). KD, KH,
// KF: 16-column k-steps of D, dh and F (EXACT: the widths; else their
// maxima, the widths read at run time). One warp per 16 rows of a row block
// of at most kWarpRows rows; a persistent grid walks the row blocks; MINB
// blocks per SM bound the registers.
template <typename T, int KD, int KH, int KF, bool EXACT, int MINB>
__global__ void __launch_bounds__(2 * kWarpRows, MINB)
fused_layer_bwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ x1,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                            const bf16* __restrict__ wqkv, const bf16* __restrict__ wout,
                            const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                            const bf16* __restrict__ w1, const float* __restrict__ b1,
                            const bf16* __restrict__ w2, bf16* __restrict__ ops,
                            float* __restrict__ ws, int B, int S, int D, int H, int dh, int F,
                            DropCfg dc) {
  load_seed(dc);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const WarpPlan plan(S, D, dh, F);
  bf16* wa = reinterpret_cast<bf16*>(smem_raw + plan.wa);
  bf16* wb = reinterpret_cast<bf16*>(smem_raw + plan.wb);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + plan.q);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + plan.k);
  bf16* vs = reinterpret_cast<bf16*>(smem_raw + plan.v);
  bf16* dos = reinterpret_cast<bf16*>(smem_raw + plan.dO);
  bf16* ads = reinterpret_cast<bf16*>(smem_raw + plan.ad);
  bf16* dss = reinterpret_cast<bf16*>(smem_raw + plan.ds);
  const int kd = EXACT ? KD : D / 16, kh = EXACT ? KH : dh / 16, kf = EXACT ? KF : F / 16;
  const int lane = threadIdx.x % 32, c = lane % 4, warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32, R = plan.R, r0 = warp * 16;
  const int ra = r0 + lane / 4;  // the thread's rows: ra and ra + 8
  const int I = H * dh, seqs = seqs_per_block(S), nblocks = (B + seqs - 1) / seqs;
  const SmallLayout sl(D, F);
  const OperandLayout ol(static_cast<long long>(B) * S, D, I, F);
  float* part = ws + static_cast<size_t>(blockIdx.x) * sl.total;  // the block's partial row
  // the warps' staged small-vector partials, over a_d and ds outside the heads
  float* staged = reinterpret_cast<float*>(smem_raw + plan.ad);
  float* mine = staged + warp * sl.total;
  // the keys the warp's rows see, which are also the query rows that see
  // the warp's rows as keys; score tile j holds keys kw.base + 8j
  const KeyWindow kw(S, R, r0);
  const int steps = (kw.hi - kw.base + 15) / 16;  // 16-row k-steps over them
  const float kept = dc.on ? dc.scale : 1.f;  // a kept element's multiplier

  // The weight slices are staged with cp.async, each group into its buffer
  // once every warp is done with what the buffer held: W_q of head h + 1 and
  // its out-projection rows after head h's dq (after the last head, w2 of
  // the next row block), W_k and W_v of head h + 1 after head h's key pass
  // (after the last head, w1, for dx1 again and the next row block).
  auto stage_q_out = [&](int h) {
    stage_async(wqkv + h * dh, 3 * I, D, dh, wa, plan.ld_w3);
    stage_async(wout + static_cast<size_t>(h) * dh * D, D, dh, D, wb, plan.ld_wd);
    cp_async_commit();
  };
  auto stage_kv = [&](int h) {
    stage_async(wqkv + I + h * dh, 3 * I, D, dh, wa + dh, plan.ld_w3);
    stage_async(wqkv + 2 * I + h * dh, 3 * I, D, dh, wa + 2 * dh, plan.ld_w3);
    cp_async_commit();
  };
  auto stage_w1 = [&]() {
    stage_async(w1, F, D, F, wa, plan.ld_w1);
    cp_async_commit();
  };
  auto stage_w2 = [&]() {
    stage_async(w2, D, F, D, wb, plan.ld_wd);
    cp_async_commit();
  };
  stage_w1();
  stage_w2();

  bool first = true;
  for (int blk = blockIdx.x; blk < nblocks; blk += gridDim.x, first = false) {
    const bool more = blk + static_cast<int>(gridDim.x) < nblocks;
    const int seq0 = blk * seqs;
    const int rows = min(seqs, B - seq0) * S;
    const bool ok_a = ra < rows, ok_b = ra + 8 < rows;
    const long long tok0 = static_cast<long long>(seq0) * S;  // token row of block row 0
    const uint64_t row_a = static_cast<uint64_t>(tok0 + ra), row_b = row_a + 8;
    const size_t at = row_a * D;  // row a in x, x1, dy and dx
    // the thread's two rows of an operand in the buffer (offset, width)
    auto op_a = [&](size_t off, int width) { return ops + off + row_a * width; };
    auto op_b = [&](size_t off, int width) { return ops + off + row_b * width; };
    const DropRun d5[2] = {DropRun(dc, kSiteFfMid, row_a * F), DropRun(dc, kSiteFfMid, row_b * F)};
    cp_async_wait<0>();
    __syncthreads();  // w1 and w2

    // ---- MLP: LN2 of x1, u = h2 w1 + b1, GELU and site 5 ----------------------
    float mu2[2], rs2[2];
    uint32_t hf[KD][4];  // h2, then h1: the A fragments of the LN outputs
    {
      float v[2 * KD][4];
      load_rows<2 * KD>(v, x1 + at, D, 2 * kd, ok_a, ok_b, c);
      ln_stats<2 * KD>(v, 2 * kd, D, mu2, rs2);
      ln_afrag<KD>(hf, v, 2 * kd, mu2, rs2, ln2s, ln2b, ok_a, ok_b, c);
    }
    store_afrag<KD>(hf, op_a(ol.h2, D), op_b(ol.h2, D), kd, ok_a, ok_b, c);
    float u[2 * KF][4];
    zero(u);
    warp_mm<KD, 2 * KF>(u, hf, 0, kd, wa, plan.ld_w1, 0, 0, 2 * kf, lane);
    {
      float gd[2 * KF][4];
#pragma unroll
      for (int j = 0; j < 2 * KF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * c + e % 2;
          const float m = d5[e / 2](dc, (e < 2 ? row_a : row_b) * F + col);
          if (j < 2 * kf) u[j][e] = __fadd_rn(u[j][e], b1[col]);
          gd[j][e] = j < 2 * kf ? __fmul_rn(gelu(u[j][e]), m) : 0.f;
        }
      uint32_t gf[KF][4];
      to_afrag<KF>(gf, gd);
      store_afrag<KF>(gf, op_a(ol.gd, F), op_b(ol.gd, F), kf, ok_a, ok_b, c);
    }

    // ---- MLP backward: dp2 = dy * mask7, du, dh2 -------------------------------
    uint32_t pf[KD][4];  // dp2's A fragments
    {
      float t[2 * KD][4];
      load_rows<2 * KD>(t, dy + at, D, 2 * kd, ok_a, ok_b, c);
      const DropRun d7[2] = {DropRun(dc, kSiteFfOut, row_a * D),
                             DropRun(dc, kSiteFfOut, row_b * D)};
#pragma unroll
      for (int j = 0; j < 2 * KD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * c + e % 2;
          if (j < 2 * kd)
            t[j][e] = __fmul_rn(t[j][e], d7[e / 2](dc, (e < 2 ? row_a : row_b) * D + col));
        }
      col_sums<2 * KD>(t, 2 * kd, mine + sl.b2, lane);
      to_afrag<KD>(pf, t);
    }
    store_afrag<KD>(pf, op_a(ol.dp2, D), op_b(ol.dp2, D), kd, ok_a, ok_b, c);
    uint32_t duf[KF][4];
    {
      float g[2 * KF][4];  // dgd = dp2 w2^T, then du = dgd * mask5 * GELU'(u)
      zero(g);
      warp_mm<KD, 2 * KF, true>(g, pf, 0, kd, wb, plan.ld_wd, 0, 0, 2 * kf, lane);
#pragma unroll
      for (int j = 0; j < 2 * KF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * c + e % 2;
          const float m = d5[e / 2](dc, (e < 2 ? row_a : row_b) * F + col);
          g[j][e] = j < 2 * kf && (e < 2 ? ok_a : ok_b)
                        ? __fmul_rn(__fmul_rn(g[j][e], m), gelu_grad(u[j][e]))
                        : 0.f;
        }
      col_sums<2 * KF>(g, 2 * kf, mine + sl.b1, lane);
      to_afrag<KF>(duf, g);
    }
    store_afrag<KF>(duf, op_a(ol.du, F), op_b(ol.du, F), kf, ok_a, ok_b, c);
    // dx1 = dy + LN2'(dh2), dh2 = du w1^T (again at the end of the row block,
    // bit for bit, so that dx1 holds no registers through the heads)
    {
      float dx1[2 * KD][4];
      dx1_rows<KD, KF, true>(dx1, duf, kd, kf, wa, plan.ld_w1, x1 + at, dy + at, D, ok_a, ok_b,
                             mu2, rs2, ln2s, mine + sl.ln2s, mine + sl.ln2b, lane);
      __syncthreads();  // every warp is done with w1 and w2: head 0's slices
      stage_q_out(0);
      stage_kv(0);
      // dp1 = dx1 * mask3: bout's column sums; rounded, the operand dp1
      const DropRun d3[2] = {DropRun(dc, kSiteProj, row_a * D), DropRun(dc, kSiteProj, row_b * D)};
#pragma unroll
      for (int j = 0; j < 2 * KD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * c + e % 2;
          const float m = dc.proj ? d3[e / 2](dc, (e < 2 ? row_a : row_b) * D + col) : 1.f;
          dx1[j][e] = j < 2 * kd ? __fmul_rn(dx1[j][e], m) : 0.f;
        }
      col_sums<2 * KD>(dx1, 2 * kd, mine + sl.bout, lane);
      uint32_t f[KD][4];
      to_afrag<KD>(f, dx1);
      store_afrag<KD>(f, op_a(ol.dp1, D), op_b(ol.dp1, D), kd, ok_a, ok_b, c);
    }
    // LN1 again, from x: the operand h1, which each head reads back as the
    // q/k/v products' A fragments
    float mu1[2], rs1[2];
    {
      float v[2 * KD][4];
      load_rows<2 * KD>(v, x + at, D, 2 * kd, ok_a, ok_b, c);
      ln_stats<2 * KD>(v, 2 * kd, D, mu1, rs1);
      ln_afrag<KD>(hf, v, 2 * kd, mu1, rs1, ln1s, ln1b, ok_a, ok_b, c);
    }
    store_afrag<KD>(hf, op_a(ol.h1, D), op_b(ol.h1, D), kd, ok_a, ok_b, c);
    // h1 and dp1 as A fragments, read back from the operands for each head
    // (they hold no registers through the heads' attention)
    uint32_t pf1[KD][4];
    load_afrag<KD>(pf1, op_a(ol.dp1, D), op_b(ol.dp1, D), kd, ok_a, ok_b, c);
    float dh1[2 * KD][4];
    zero(dh1);

    // ---- attention backward, one head at a time ------------------------------
    for (int h = 0; h < H; ++h) {
      const bool next = h + 1 < H;
      if (h == 0) {
        cp_async_wait<1>();
        __syncthreads();  // W_q,0 and the out-projection rows; the MLP's staged partials
        block_sums(staged, nw, sl.total, sl.bout, sl.total, part, first);
      }
      // q (q_s), then dO = dp1 wout_h^T (dO_s), while W_k,h and W_v,h land
      {
        float acc[2 * KH][4];
        zero(acc);
        warp_mm<KD, 2 * KH>(acc, hf, 0, kd, wa, plan.ld_w3, 0, 0, 2 * kh, lane);
        store_bf16<2 * KH>(acc, qs, plan.ld_kv, ra, 2 * kh, c);
      }
      {
        float acc[2 * KH][4];
        zero(acc);
        warp_mm<KD, 2 * KH, true>(acc, pf1, 0, kd, wb, plan.ld_wd, 0, 0, 2 * kh, lane);
        store_bf16<2 * KH>(acc, dos, plan.ld_kv, ra, 2 * kh, c);
      }
      cp_async_wait<0>();
      __syncthreads();  // W_k,h and W_v,h
#pragma unroll
      for (int part_kv = 1; part_kv < 3; ++part_kv) {
        float acc[2 * KH][4];
        zero(acc);
        warp_mm<KD, 2 * KH>(acc, hf, 0, kd, wa, plan.ld_w3, part_kv * dh, 0, 2 * kh, lane);
        store_bf16<2 * KH>(acc, part_kv == 1 ? ks : vs, plan.ld_kv, ra, 2 * kh, c);
      }
      __syncthreads();  // q, k, v and dO of every row

      // scores q k^T over the keys the warp's rows see; a = softmax (fp32:
      // row-max subtraction, exp, a pairwise sum, each term times its
      // reciprocal, as the WMMA kernel takes it); a_d = a * mask1 rounded
      // into the warp's rows of ads; the mask's bits kept for da (bit
      // 16 half + 2 j + e)
      float a[kKT][4];
      uint32_t keep = 0;
      {
        uint32_t qf[KH][4];
        ldsm_afrag<KH>(qf, qs, plan.ld_kv, r0, kh, lane);
        zero(a);
        warp_mm_keys_n<KH, kKT>(a, qf, kh, ks, plan.ld_kv, kw.base, R, lane);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = ra + 8 * half;
        const bool ok = half ? ok_b : ok_a;
        const int lo = ok ? r / S * S - kw.base : 0;
        const int hi = ok ? min(r / S * S + S, R) - kw.base : 0;
        float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
        for (int j = 0; j < kKT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * c + e;
            if (col >= lo && col < hi) m = fmaxf(m, a[j][2 * half + e]);
          }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float ex[2 * kKT];
#pragma unroll
        for (int j = 0; j < kKT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * c + e;
            ex[2 * j + e] = col >= lo && col < hi ? expf(a[j][2 * half + e] - m) : 0.f;
          }
        const float inv = 1.f / quad_sum(ex);
        // site 1 on [B', H, S, S] at (sequence, head, query, key): the
        // index of the key in column col is idx0 + col
        const uint64_t idx0 =
            ((static_cast<uint64_t>(seq0 + r / S) * H + h) * S + r % S) * S - lo;
        const DropRun drop(dc, kSiteAttn, idx0 + lo);
#pragma unroll
        for (int j = 0; j < kKT; ++j) {
          float pd[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * c + e;
            const bool own = col >= lo && col < hi;
            const float pr = own ? __fmul_rn(ex[2 * j + e], inv) : 0.f;
            const float mult = own ? drop(dc, idx0 + col) : 0.f;
            if (mult != 0.f) keep |= 1u << (16 * half + 2 * j + e);
            a[j][2 * half + e] = pr;
            pd[e] = __fmul_rn(pr, mult);
          }
          if (j < 2 * steps)
            *reinterpret_cast<uint32_t*>(ads + r * plan.ld_p + kw.base + 8 * j + 2 * c) =
                pack_bf16(pd[0], pd[1]);
        }
      }
      __syncwarp();  // the warp's rows of ads
      // o = a_d v, rounded: the head's columns of the operand o
      {
        uint32_t adf[kKT / 2][4];
        ldsm_afrag<kKT / 2>(adf, ads, plan.ld_p, r0, kKT / 2, lane, kw.base, steps);
        float acc[2 * KH][4];
        zero(acc);
        warp_mm_keys_k<kKT / 2, 2 * KH>(acc, adf, steps, vs, plan.ld_kv, kw.base, R, 2 * kh,
                                        lane);
        uint32_t f[KH][4];
        to_afrag<KH>(f, acc);
        store_afrag<KH>(f, op_a(ol.o, I) + h * dh, op_b(ol.o, I) + h * dh, kh, ok_a, ok_b, c);
      }
      // da = (dO v^T) * mask1, dO's A fragments from the warp's rows of dO_s;
      // ds = (da - sum(da a)) a, rounded: ds_s and dq's A fragments
      uint32_t sf[kKT / 2][4];
      {
        float da[kKT][4];
        {
          uint32_t gf[KH][4];
          ldsm_afrag<KH>(gf, dos, plan.ld_kv, r0, kh, lane);
          zero(da);
          warp_mm_keys_n<KH, kKT>(da, gf, kh, vs, plan.ld_kv, kw.base, R, lane);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = ra + 8 * half;
          const bool ok = half ? ok_b : ok_a;
          const int lo = ok ? r / S * S - kw.base : 0;
          const int hi = ok ? min(r / S * S + S, R) - kw.base : 0;
          float t[2 * kKT];
#pragma unroll
          for (int j = 0; j < kKT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * c + e;
              const bool own = col >= lo && col < hi;
              const float d = own ? __fmul_rn(da[j][2 * half + e],
                                              (keep >> (16 * half + 2 * j + e)) & 1u ? kept : 0.f)
                                  : 0.f;
              da[j][2 * half + e] = d;
              t[2 * j + e] = __fmul_rn(d, a[j][2 * half + e]);
            }
          const float sum = quad_sum(t);
#pragma unroll
          for (int j = 0; j < kKT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * c + e;
              da[j][2 * half + e] =
                  col >= lo && col < hi
                      ? __fmul_rn(__fsub_rn(da[j][2 * half + e], sum), a[j][2 * half + e])
                      : 0.f;
            }
        }
        to_afrag<kKT / 2>(sf, da);
        store_bf16<kKT>(da, dss + kw.base, plan.ld_p, ra, 2 * steps, c);
      }
      // dq = ds k, rounded: the operand dq; dh1 += dq W_q,h^T
      {
        float acc[2 * KH][4];
        zero(acc);
        warp_mm_keys_k<kKT / 2, 2 * KH>(acc, sf, steps, ks, plan.ld_kv, kw.base, R, 2 * kh, lane);
        uint32_t f[KH][4];
        to_afrag<KH>(f, acc);
        store_afrag<KH>(f, op_a(ol.dqkv, 3 * I) + h * dh, op_b(ol.dqkv, 3 * I) + h * dh, kh, ok_a,
                        ok_b, c);
        warp_mm<KH, 2 * KD, true>(dh1, f, 0, kh, wa, plan.ld_w3, 0, 0, 2 * kd, lane);
      }
      __syncthreads();  // a_d and ds of every row; W_q,h and wout_h read for the last time
      if (next)
        stage_q_out(h + 1);
      else if (more)
        stage_w2();
      else
        cp_async_commit();

      // the key pass: the warp's rows as keys, summed over the query rows
      // that see them: dv = a_d^T dO, dk = ds^T q, rounded: the operands dv
      // and dk; dh1 += dv W_v,h^T + dk W_k,h^T
#pragma unroll
      for (int part_kv = 2; part_kv > 0; --part_kv) {
        float acc[2 * KH][4];
        zero(acc);
        if (part_kv == 2)
          warp_mm_keys_t<kKT / 2, 2 * KH>(acc, ads, plan.ld_p, r0, dos, plan.ld_kv, kw.base, steps,
                                          R, 2 * kh, lane);
        else
          warp_mm_keys_t<kKT / 2, 2 * KH>(acc, dss, plan.ld_p, r0, qs, plan.ld_kv, kw.base, steps,
                                          R, 2 * kh, lane);
        uint32_t f[KH][4];
        to_afrag<KH>(f, acc);
        const size_t col = static_cast<size_t>(part_kv) * I + h * dh;
        store_afrag<KH>(f, op_a(ol.dqkv, 3 * I) + col, op_b(ol.dqkv, 3 * I) + col, kh, ok_a, ok_b,
                        c);
        warp_mm<KH, 2 * KD, true>(dh1, f, 0, kh, wa + part_kv * dh, plan.ld_w3, 0, 0, 2 * kd,
                                  lane);
      }
      if (next) {  // in flight under the barrier
        load_afrag<KD>(hf, op_a(ol.h1, D), op_b(ol.h1, D), kd, ok_a, ok_b, c);
        load_afrag<KD>(pf1, op_a(ol.dp1, D), op_b(ol.dp1, D), kd, ok_a, ok_b, c);
      }
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the head's tiles and W_k,h, W_v,h; W_q and
                        // the out-projection rows of head h + 1 have landed
      if (next)
        stage_kv(h + 1);
      else
        stage_w1();
    }

    // ---- LN1 backward: dh1 <- LN1'(dh1); dx = dx1 + dh1 -----------------------
    {
      float v[2 * KD][4];
      load_rows<2 * KD>(v, x + at, D, 2 * kd, ok_a, ok_b, c);
      ln_bwd<2 * KD, true>(dh1, v, 2 * kd, D, mu1, rs1, ln1s, mine + sl.ln1s, mine + sl.ln1b,
                           lane);
    }
    load_afrag<KF>(duf, op_a(ol.du, F), op_b(ol.du, F), kf, ok_a, ok_b, c);
    cp_async_wait<0>();
    __syncthreads();  // w1; LN1's staged partials
    block_sums(staged, nw, sl.total, sl.ln1s, sl.bout, part, first);
    {
      float dx1[2 * KD][4];
      dx1_rows<KD, KF, false>(dx1, duf, kd, kf, wa, plan.ld_w1, x1 + at, dy + at, D, ok_a, ok_b,
                              mu2, rs2, ln2s, nullptr, nullptr, lane);
#pragma unroll
      for (int j = 0; j < 2 * KD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dx1[j][e] = __fadd_rn(dx1[j][e], dh1[j][e]);
      store_rows<2 * KD>(dx1, dx + at, D, 2 * kd, ok_a, ok_b, c);
    }
  }
}

// ---------------------------------------------------------------------------
// The planned WMMA row kernel (row blocks of more than kWarpRows rows)

constexpr int kTcThreads = 512;

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
    R = block_rows(S);
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

// The WMMA row kernel: dx, the weight gradients' bf16 operands
// (OperandLayout) and the block's partial sums of the small vectors
// (SmallLayout), with no weight-gradient product of its own. FLEX: a plan of level > 0 (weights
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
  load_seed(dc);
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
#pragma unroll 8  // the loads in flight together; the sum in block order
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

// the WMMA row kernel, then the reduction of its small-vector partials
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

// the register-resident row kernel on a grid of nparts blocks, then the
// reduction of its small-vector partials
template <typename T, int KD, int KH, int KF, bool EXACT, int MINB>
struct WarpLaunch {
  static cudaError_t prepare(const WarpPlan& plan) {
    return cudaFuncSetAttribute(fused_layer_bwd_warp_kernel<T, KD, KH, KF, EXACT, MINB>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(plan.bytes));
  }

  static cudaError_t occupancy(int S, int D, int dh, int F, int* blocks) {
    const WarpPlan plan(S, D, dh, F);
    cudaError_t err = prepare(plan);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fused_layer_bwd_warp_kernel<T, KD, KH, KF, EXACT, MINB>, 2 * plan.R, plan.bytes);
  }

  static cudaError_t run(const void* x, const void* x1, const void* dy, void* dx, const void* ln1s,
                         const void* ln1b, const void* wqkv, const void* wout, const void* ln2s,
                         const void* ln2b, const void* w1, const void* b1, const void* w2,
                         void* ops, void* ws, void* grads, int B, int S, int D, int H, int dh,
                         int F, int nparts, DropCfg dc, cudaStream_t stream) {
    const WarpPlan plan(S, D, dh, F);
    cudaError_t err = prepare(plan);
    if (err != cudaSuccess) return err;
    fused_layer_bwd_warp_kernel<T, KD, KH, KF, EXACT, MINB><<<nparts, 2 * plan.R, plan.bytes,
                                                              stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(x1), static_cast<const T*>(dy),
        static_cast<T*>(dx), static_cast<const float*>(ln1s), static_cast<const float*>(ln1b),
        static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wout),
        static_cast<const float*>(ln2s), static_cast<const float*>(ln2b),
        static_cast<const bf16*>(w1), static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<bf16*>(ops), static_cast<float*>(ws), B, S, D, H, dh, F, dc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int total = SmallLayout(D, F).total;
    reduce_small<<<(total + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                          static_cast<float*>(grads), nparts, D,
                                                          H * dh, F);
    return cudaGetLastError();
  }
};

// the widths the register-resident row kernel takes: D, dh and F multiples
// of 16, D and F at most 128, dh at most 64, at most kWarpRows rows a block
bool warp_widths(int S, int D, int dh, int F) {
  return D % 16 == 0 && dh % 16 == 0 && F % 16 == 0 && D <= 128 && dh <= 64 && F <= 128 &&
         block_rows(S) <= kWarpRows;
}

// the model's widths (D 96, dh 64, F 64) take the instantiation with every
// width fixed, two blocks per SM; the rest of warp_widths the one with the
// maxima and the widths read at run time
bool model_widths(int D, int dh, int F) { return D == 96 && dh == 64 && F == 64; }
template <typename T>
using WarpModel = WarpLaunch<T, 6, 4, 4, true, 2>;
template <typename T>
using WarpMaxima = WarpLaunch<T, 8, 4, 8, false, 1>;

bool aligned(const void* ptr, uintptr_t n) { return reinterpret_cast<uintptr_t>(ptr) % n == 0; }
DropCfg drop_cfg(int on, int proj, int seed, int thr, float scale, const void* seed_ptr) {
  return DropCfg{on, proj, static_cast<uint32_t>(seed), static_cast<uint32_t>(thr), scale,
                 static_cast<const uint32_t*>(seed_ptr)};
}

}  // namespace

// The plan a launch takes at this geometry. form: 0 the FMA form, 1 the
// tensor-core form's row kernel (the register-resident one up to kWarpRows
// rows a block, which has one plan, level 0; the planned WMMA one past
// them). out[0]: the lowest level whose shared memory fits the card's
// opt-in limit, or -1 when none does; out[1]: that level's shared bytes
// (when none fits, the last level's, the least the form can take); out[2]:
// its device scratch bytes per block; out[3]: the card's limit. Returns a
// CUDA error code.
extern "C" int fused_layer_bwd_plan(int S, int D, int dh, int F, int form, long long* out) {
  int limit = 0;
  const cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[3] = limit;
  if (form && block_rows(S) <= kWarpRows) {
    out[1] = static_cast<long long>(WarpPlan(S, D, dh, F).bytes);
    out[2] = 0;
    out[0] = out[1] <= limit ? 0 : -1;
    return 0;
  }
  const int levels = form ? kTcLevels : kFmaLevels;
  out[0] = -1;
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

// The blocks of the register-resident row kernel that one SM holds at this
// geometry (the occupancy API, for its registers and shared memory), io in
// bf16 or fp32; 0 where the kernel does not take the geometry. Returns a
// CUDA error code.
extern "C" int fused_layer_bwd_warp_occupancy(int S, int D, int dh, int F, int io_bf16,
                                              int* blocks) {
  *blocks = 0;
  if (!warp_widths(S, D, dh, F)) return 0;
  cudaError_t err;
  if (model_widths(D, dh, F))
    err = io_bf16 ? WarpModel<bf16>::occupancy(S, D, dh, F, blocks)
                  : WarpModel<float>::occupancy(S, D, dh, F, blocks);
  else
    err = io_bf16 ? WarpMaxima<bf16>::occupancy(S, D, dh, F, blocks)
                  : WarpMaxima<float>::occupancy(S, D, dh, F, blocks);
  return static_cast<int>(err);
}

// The FMA form. x, dy, dx: [B, S, D] in T (fp32, or bf16 when io_bf16).
// Weights as for fused_layer_fwd (wqkv's q block pre-scaled) in the compute
// type (bf16 when compute_bf16, else fp32); LN scales/biases and biases in
// fp32. ws: fp32 workspace of nparts x (gradient count) floats, where nparts
// is the grid (at most the number of row blocks); scratch: nparts x the
// plan's scratch bytes (fused_layer_bwd_plan, form 0, at `level`; null when
// those are 0); grads: the fp32 gradient vector in the order ln1s, ln1b,
// wqkv, wout, bout, ln2s, ln2b, w1, b1, w2, b2. Dropout arguments (the
// seed's pointer among them) as for fused_layer_fwd. Launches the block
// kernel and the reduction on `stream`; returns cudaGetLastError().
extern "C" int fused_layer_bwd(const void* x, const void* dy, void* dx, const void* ln1s,
                               const void* ln1b, const void* wqkv, const void* wout,
                               const void* bout, const void* ln2s, const void* ln2b,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               void* ws, void* scratch, void* grads, const void* drop_seed_ptr,
                               int B, int S, int D, int H, int dh, int F, int io_bf16,
                               int compute_bf16, int nparts,
                               int level, int drop_on, int drop_proj, int drop_seed, int drop_thr,
                               float drop_scale, void* stream) {
  if (level < 0 || level >= kFmaLevels) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const DropCfg dc = drop_cfg(drop_on, drop_proj, drop_seed, drop_thr, drop_scale, drop_seed_ptr);
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
// 16; bf16 weights 16-byte aligned, 32-byte aligned where the WMMA kernel
// reads them in place, from level 1). warp: the register-resident kernel
// (the widths of warp_widths, level 0), else the planned WMMA kernel at
// `level`. Arguments as for fused_layer_bwd, and: x1, the fp32 [B, S, D]
// residual stream after attention that fused_layer_fwd wrote for this x;
// ops, the bf16 operand buffer of OperandLayout (N = B * S rows, 16-byte
// aligned) that layer_wgrad.cu reads; ws, nparts x (6D + F) floats of
// small-vector partials; scratch as for fused_layer_bwd (form 1, 128-byte
// aligned; the WMMA kernel's alone). Writes dx, ops and the small
// vectors' entries of grads (layer_wgrad writes the four weight gradients).
extern "C" int fused_layer_bwd_tc(const void* x, const void* x1, const void* dy, void* dx,
                                  const void* ln1s,
                                  const void* ln1b, const void* wqkv, const void* wout,
                                  const void* bout, const void* ln2s, const void* ln2b,
                                  const void* w1, const void* b1, const void* w2, const void* b2,
                                  void* ops, void* ws, void* scratch, void* grads,
                                  const void* drop_seed_ptr, int B, int S,
                                  int D, int H, int dh, int F, int io_bf16, int nparts, int level,
                                  int warp, int drop_on, int drop_proj, int drop_seed,
                                  int drop_thr, float drop_scale, void* stream) {
  const uintptr_t wal = level ? 32 : 16;
  if (D % 16 || dh % 16 || F % 16 || level < 0 || level >= kTcLevels || !aligned(wqkv, wal) ||
      !aligned(wout, wal) || !aligned(w1, wal) || !aligned(w2, wal) || !aligned(ops, 16) ||
      !aligned(scratch, 128) || (warp && (level || !warp_widths(S, D, dh, F))))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const DropCfg dc = drop_cfg(drop_on, drop_proj, drop_seed, drop_thr, drop_scale, drop_seed_ptr);
  cudaError_t err;
  if (warp) {
    const auto run = model_widths(D, dh, F)
                         ? (io_bf16 ? WarpModel<bf16>::run : WarpModel<float>::run)
                         : (io_bf16 ? WarpMaxima<bf16>::run : WarpMaxima<float>::run);
    err = run(x, x1, dy, dx, ln1s, ln1b, wqkv, wout, ln2s, ln2b, w1, b1, w2, ops, ws, grads, B, S,
              D, H, dh, F, nparts, dc, st);
  } else {
    err = io_bf16 ? launch_tc<bf16>(x, x1, dy, dx, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1,
                                    b1, w2, b2, ops, ws, scratch, grads, B, S, D, H, dh, F, nparts,
                                    level, dc, st)
                  : launch_tc<float>(x, x1, dy, dx, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1,
                                     b1, w2, b2, ops, ws, scratch, grads, B, S, D, H, dh, F,
                                     nparts, level, dc, st);
  }
  return static_cast<int>(err);
}
