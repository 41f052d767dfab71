// fused_layer_fwd: one pre-norm transformer layer, forward, with dropout.
//
// Replaces the Pallas kernel maskedsst_tpu/ops/fused_layer.py::_layer_fwd_kernel
// (entry fused_transformer_layer, pallas_call in _fwd_impl). Per token:
//   LN1 -> QKV (no bias, q pre-scaled by dh^-1/2 in the weights) -> softmax
//   attention per head -> out-projection + bias -> residual -> LN2 ->
//   fc1 + b1 -> erf GELU -> fc2 + b2 -> residual.
// Numeric contract (same as the TPU kernel): LN eps 1e-5 with fp32
// statistics; every matmul operand rounded to the compute type C (fp32 or
// bf16) and accumulated in fp32 (LN outputs, q/k/v, softmax probabilities,
// per-head attention outputs, the GELU output); fp32 softmax; an fp32
// residual stream; the output cast to the input type T. Dropout (training)
// at the TPU kernel's four sites: the attention probabilities (before the
// AV product), the projection output (unless the projection is the
// identity), the GELU output and the MLP output, with masks from the
// counter-based hash in common.cuh keyed by (layer seed, site, logical
// index), so fused_layer_bwd.cu regenerates the same bits.
//
// What bounds it on the H100: operations. At dim 96, inner width 512 and
// seq 64 a token costs ~5.5e5 flop against 2 x 96 values of slab traffic,
// i.e. thousands of flop per byte; the QKV projection is over half of it.
//
// What this design does about it. One block owns up to 64 rows (one
// sequence at seq 64, three at seq 20, twelve at seq 5) and keeps the whole
// layer in dynamic shared memory: the residual stream, the LN output, the
// projection accumulator, q/k/v of one head, the scores and the MLP hidden
// layer. It loops over heads; each head's output is multiplied straight
// into the [rows, dim] projection accumulator, so the [rows, 512]
// concatenation never exists, and only the token slab crosses device
// memory. Two forms share that plan, chosen at launch from what the call
// gives:
//  - tensor cores (bf16 compute, dim, dim_head and mlp dim multiples of 16):
//    every product is a 16x16x16 bf16 WMMA with fp32 accumulation, operands
//    kept in shared memory as bf16; each weight slice is first copied from
//    L2 into shared memory with 16-byte loads; attention runs as one
//    block-diagonal [rows, rows] score tile per head, the entries outside a
//    row's own sequence masked out of the softmax, so short and odd
//    sequences need no special case;
//  - FMA loops (fp32 compute, or widths the tensor-core form does not
//    take): an 8-row register tile per thread, weights read from L2.
// The fp32 form is far below even the FMA peak; wgmma, TMA and pipelining
// are later work.

#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace msst;
using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTargetRows = 64;  // rows (sequences x seq) a block owns

__host__ __device__ inline int seqs_per_block(int S) {
  return S >= kTargetRows ? 1 : kTargetRows / S;
}

// LayerNorm over the last axis of src [rows, D] (fp32), rounded to C, into
// dst (row stride ldd); one warp per row, two-pass fp32 statistics as the
// TPU kernel takes them.
template <typename C, typename O>
__device__ void layer_norm_rows(const float* src, O* dst, int ldd, int rows, int D,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias) {
  const int lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int r = threadIdx.x / 32; r < rows; r += nwarps) {
    const float* x = src + r * D;
    float s = 0.f;
    for (int k = lane; k < D; k += 32) s += x[k];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float t = x[k] - mu;
      v += t * t;
    }
    const float rsig = rsqrtf(warp_sum(v) / D + kLnEps);
    for (int k = lane; k < D; k += 32)
      dst[r * ldd + k] = rounded<C, O>((x[k] - mu) * rsig * scale[k] + bias[k]);
  }
}

// ---------------------------------------------------------------------------
// FMA form

constexpr int kThreads = 256;
constexpr int kRowTile = 8;  // rows each thread carries through a block product

enum Epilogue { kStoreRounded, kAccumulate, kBiasGeluRounded, kBiasResidual };

// out[r, c] <op>= sum_k A[r, k] * W[k, c] for r < rows, c < N.
// A: shared fp32 (already rounded to C), row stride lda, with at least
// round_up(rows, kRowTile) rows allocated. W: device memory in C, row
// stride ldw. Consecutive threads take consecutive columns: W loads are
// coalesced and the A loads of a warp are one broadcast. The GELU and
// residual epilogues apply dropout sites 5 and 7 to element (row0 + r, c)
// of the [rows, N] site tensor.
template <typename C, int EPI>
__device__ void block_mm(const float* A, int lda, int rows, int K,
                         const C* __restrict__ W, int ldw, int N,
                         const float* __restrict__ bias, float* out, int ldo,
                         const DropCfg& dc = DropCfg{}, long long row0 = 0) {
  const int groups = (rows + kRowTile - 1) / kRowTile;
  for (int t = threadIdx.x; t < groups * N; t += blockDim.x) {
    const int c = t % N, r0 = (t / N) * kRowTile;
    float acc[kRowTile];
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = to_f(W[static_cast<size_t>(k) * ldw + c]);
#pragma unroll
      for (int i = 0; i < kRowTile; ++i) acc[i] += A[(r0 + i) * lda + k] * w;
    }
#pragma unroll
    for (int i = 0; i < kRowTile; ++i) {
      const int r = r0 + i;
      if (r >= rows) break;
      float* o = out + r * ldo + c;
      if (EPI == kStoreRounded) {
        *o = round_to<C>(acc[i]);
      } else if (EPI == kAccumulate) {
        *o += acc[i];
      } else if (EPI == kBiasGeluRounded) {
        const float m = drop_mult(dc, kSiteFfMid, static_cast<uint64_t>(row0 + r) * N + c);
        *o = round_to<C>(gelu(acc[i] + bias[c]) * m);
      } else {  // kBiasResidual
        const float m = drop_mult(dc, kSiteFfOut, static_cast<uint64_t>(row0 + r) * N + c);
        *o = *o + (acc[i] + bias[c]) * m;
      }
    }
  }
}

// Shared-memory plan of the FMA form, in floats; must match the carve-up in
// the kernel. A geometry above the card's 227 KB makes cudaFuncSetAttribute
// fail, and the launch returns that error.
__host__ __device__ inline size_t smem_floats(int seqs, int S, int D, int dh, int F) {
  const int rcap = round_up(seqs * S, kRowTile);
  return static_cast<size_t>(rcap) * (3 * D + 3 * (dh + 1) + S + F);
}

template <typename T, typename C>
__global__ void __launch_bounds__(kThreads)
fused_layer_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                       const C* __restrict__ wqkv, const C* __restrict__ wout,
                       const float* __restrict__ bout,
                       const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                       const C* __restrict__ w1, const float* __restrict__ b1,
                       const C* __restrict__ w2, const float* __restrict__ b2,
                       int B, int S, int D, int H, int dh, int F, DropCfg dc) {
  extern __shared__ float smem[];
  const int seqs = seqs_per_block(S);
  const int rcap = round_up(seqs * S, kRowTile);
  const int ldh = dh + 1;  // odd stride: the k/v column walks are free of bank conflicts
  float* xs = smem;                 // [rcap, D]   residual stream
  float* hs = xs + rcap * D;        // [rcap, D]   LN1 / LN2 output
  float* proj = hs + rcap * D;      // [rcap, D]   out-projection accumulator
  float* q = proj + rcap * D;       // [rcap, ldh] q, then the head's attention output
  float* k = q + rcap * ldh;        // [rcap, ldh]
  float* v = k + rcap * ldh;        // [rcap, ldh]
  float* sc = v + rcap * ldh;       // [seqs, S, S] scores, then probabilities
  float* hid = sc + rcap * S;       // [rcap, F]   MLP hidden layer

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % 32, nwarps = nthr / 32;
  const int seq0 = blockIdx.x * seqs;
  const int nseq = min(seqs, B - seq0);
  const int rows = nseq * S;
  const int I = H * dh;
  const size_t base = static_cast<size_t>(seq0) * S * D;

  for (int i = tid; i < rows * D; i += nthr) {
    xs[i] = to_f(x[base + i]);
    proj[i] = 0.f;
  }
  __syncthreads();
  layer_norm_rows<C, float>(xs, hs, D, rows, D, ln1s, ln1b);
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    block_mm<C, kStoreRounded>(hs, D, rows, D, wqkv + h * dh, 3 * I, dh, nullptr, q, ldh);
    block_mm<C, kStoreRounded>(hs, D, rows, D, wqkv + I + h * dh, 3 * I, dh, nullptr, k, ldh);
    block_mm<C, kStoreRounded>(hs, D, rows, D, wqkv + 2 * I + h * dh, 3 * I, dh, nullptr, v, ldh);
    __syncthreads();

    // scores within each sequence (q carries the 1/sqrt(dh) scale)
    for (int t = tid; t < nseq * S * S; t += nthr) {
      const int j = t % S, i = (t / S) % S, g = t / (S * S);
      const float* qi = q + (g * S + i) * ldh;
      const float* kj = k + (g * S + j) * ldh;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc += qi[d] * kj[d];
      sc[t] = acc;
    }
    __syncthreads();

    // fp32 softmax with row-max subtraction, one warp per row; the
    // probabilities, after dropout site 1, are rounded to C as the AV
    // product's operand
    for (int r = tid / 32; r < rows; r += nwarps) {
      float* s = sc + r * S;
      float m = __int_as_float(0xff800000);  // -inf
      for (int j = lane; j < S; j += 32) m = fmaxf(m, s[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < S; j += 32) {
        const float e = expf(s[j] - m);
        s[j] = e;
        sum += e;
      }
      const float inv = 1.f / warp_sum(sum);
      const uint64_t idx0 = ((static_cast<uint64_t>(seq0 + r / S) * H + h) * S + r % S) * S;
      for (int j = lane; j < S; j += 32)
        s[j] = round_to<C>(s[j] * inv * drop_mult(dc, kSiteAttn, idx0 + j));
    }
    __syncthreads();

    // o = a . v, written over q (dead after the scores), rounded to C as the
    // out-projection's operand
    for (int t = tid; t < rows * dh; t += nthr) {
      const int d = t % dh, r = t / dh, g = r / S;
      const float* a = sc + r * S;
      const float* vg = v + g * S * ldh + d;
      float acc = 0.f;
      for (int j = 0; j < S; ++j) acc += a[j] * vg[j * ldh];
      q[r * ldh + d] = round_to<C>(acc);
    }
    __syncthreads();

    // this head's slice of the out-projection: o_h [rows, dh] x wout[h*dh:(h+1)*dh, :]
    block_mm<C, kAccumulate>(q, ldh, rows, dh, wout + static_cast<size_t>(h) * dh * D, D, D,
                             nullptr, proj, D);
    __syncthreads();
  }

  const long long row0 = static_cast<long long>(seq0) * S;
  for (int i = tid; i < rows * D; i += nthr) {
    const float m = dc.proj ? drop_mult(dc, kSiteProj, row0 * D + i) : 1.f;
    xs[i] = xs[i] + (proj[i] + bout[i % D]) * m;
  }
  __syncthreads();
  layer_norm_rows<C, float>(xs, hs, D, rows, D, ln2s, ln2b);
  __syncthreads();
  block_mm<C, kBiasGeluRounded>(hs, D, rows, D, w1, F, F, b1, hid, F, dc, row0);
  __syncthreads();
  block_mm<C, kBiasResidual>(hid, F, rows, F, w2, D, D, b2, xs, D, dc, row0);
  __syncthreads();

  for (int i = tid; i < rows * D; i += nthr) y[base + i] = from_f<T>(xs[i]);
}

// ---------------------------------------------------------------------------
// Tensor-core form (bf16 compute)

constexpr int kTcThreads = 512;
constexpr int kPad = 8;  // bf16 row padding: keeps WMMA strides a multiple of 8 and staggers banks

enum TcEpilogue { kTcStoreBf16, kTcStoreF32, kTcAccumulateF32, kTcBiasGeluBf16, kTcBiasResidual };

__host__ __device__ inline size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }
__host__ __device__ inline size_t larger(size_t a, size_t b) { return a > b ? a : b; }

// Byte offsets of the tensor-core form's shared memory; every buffer starts
// on a 128-byte boundary (WMMA wants 32). R is the block's row count
// rounded up to 16; the rows past the block's real rows stay zero.
struct TcPlan {
  int R, ld_h, ld_q, ld_sc, ld_p, ld_hid;
  size_t xs, proj, hs, q, k, v, sc, p, hid, wst, stage, bytes;

  __host__ __device__ TcPlan(int S, int D, int dh, int F, int nwarps) {
    R = round_up(seqs_per_block(S) * S, 16);
    ld_h = D + kPad;
    ld_q = dh + kPad;
    ld_sc = R + 4;
    ld_p = R + kPad;
    ld_hid = F + kPad;
    // the widest weight slice staged at once: [D, 3dh] (q/k/v of one head),
    // [dh, D] (its out-projection rows), [D, F] (fc1) or [F, D] (fc2)
    size_t wst_elems = static_cast<size_t>(D) * (3 * dh + kPad);
    wst_elems = larger(wst_elems, static_cast<size_t>(dh) * (D + kPad));
    wst_elems = larger(wst_elems, static_cast<size_t>(D) * (F + kPad));
    wst_elems = larger(wst_elems, static_cast<size_t>(F) * (D + kPad));
    size_t off = 0;
    xs = off;    off += align128(sizeof(float) * R * D);      // residual stream
    proj = off;  off += align128(sizeof(float) * R * D);      // out-projection accumulator
    hs = off;    off += align128(sizeof(bf16) * R * ld_h);    // LN1 / LN2 output
    q = off;     off += align128(sizeof(bf16) * R * ld_q);    // q, then the head's output
    k = off;     off += align128(sizeof(bf16) * R * ld_q);
    v = off;     off += align128(sizeof(bf16) * R * ld_q);
    sc = off;    off += align128(sizeof(float) * R * ld_sc);  // scores [R, R]
    p = off;     off += align128(sizeof(bf16) * R * ld_p);    // probabilities [R, R]
    hid = off;   off += align128(sizeof(bf16) * R * ld_hid);  // MLP hidden layer
    wst = off;   off += align128(sizeof(bf16) * wst_elems);   // staged weight slice
    stage = off; off += align128(sizeof(float) * 256 * nwarps);  // one 16x16 tile per warp
    bytes = off;
  }
};

// dst [K, N] (row stride ldd) = src [K, N] (row stride lds), both bf16 with
// 16-byte aligned rows and N a multiple of 8: 16-byte loads, all in flight.
__device__ void stage_weights(const bf16* __restrict__ src, int lds, int K, int N,
                              bf16* dst, int ldd) {
  const int vec = N / 8;
  for (int i = threadIdx.x; i < K * vec; i += blockDim.x) {
    const int r = i / vec, c = (i % vec) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * lds + c));
  }
}

// out [R, N] <op>= A [R, K] x B [K, N] on the tensor cores, one 16x16
// output tile per warp at a time. A: shared bf16, row-major. B: shared
// bf16, row-major (BL = wmma::row_major) or, for the scores, the [N, K]
// key matrix read as column-major. Tiles the epilogue must touch element by
// element go through the warp's fp32 stage; rows past `rows` are left
// alone by the residual epilogue.
template <int EPI, typename BL>
__device__ void tc_mm(const bf16* A, int lda, int R, int K, const bf16* B, int ldb, int N,
                      void* out, int ldo, const float* __restrict__ bias, float* stage,
                      int rows, const DropCfg& dc = DropCfg{}, long long row0 = 0) {
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32, lane = threadIdx.x % 32;
  const int tn = N / 16, tiles = (R / 16) * tn;
  float* st = stage + warp * 256;
  for (int t = warp; t < tiles; t += nwarps) {
    const int r0 = (t / tn) * 16, c0 = (t % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (EPI == kTcAccumulateF32)
      wmma::load_matrix_sync(acc, static_cast<float*>(out) + r0 * ldo + c0, ldo,
                             wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BL> b;
      wmma::load_matrix_sync(a, A + r0 * lda + kk, lda);
      if constexpr (std::is_same<BL, wmma::row_major>::value)
        wmma::load_matrix_sync(b, B + kk * ldb + c0, ldb);
      else
        wmma::load_matrix_sync(b, B + c0 * ldb + kk, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    if (EPI == kTcStoreF32 || EPI == kTcAccumulateF32) {
      wmma::store_matrix_sync(static_cast<float*>(out) + r0 * ldo + c0, acc, ldo,
                              wmma::mem_row_major);
      continue;
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = r0 + e / 16, c = c0 + e % 16;
      if (EPI == kTcStoreBf16) {
        static_cast<bf16*>(out)[r * ldo + c] = __float2bfloat16(st[e]);
      } else if (EPI == kTcBiasGeluBf16) {
        const float m = drop_mult(dc, kSiteFfMid, static_cast<uint64_t>(row0 + r) * N + c);
        static_cast<bf16*>(out)[r * ldo + c] = __float2bfloat16(gelu(st[e] + bias[c]) * m);
      } else if (r < rows) {  // kTcBiasResidual
        const float m = drop_mult(dc, kSiteFfOut, static_cast<uint64_t>(row0 + r) * N + c);
        float* o = static_cast<float*>(out) + r * ldo + c;
        *o = *o + (st[e] + bias[c]) * m;
      }
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kTcThreads)
fused_layer_fwd_tc_kernel(const T* __restrict__ x, T* __restrict__ y,
                          const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                          const bf16* __restrict__ wqkv, const bf16* __restrict__ wout,
                          const float* __restrict__ bout,
                          const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                          const bf16* __restrict__ w1, const float* __restrict__ b1,
                          const bf16* __restrict__ w2, const float* __restrict__ b2,
                          int B, int S, int D, int H, int dh, int F, DropCfg dc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % 32, nwarps = nthr / 32;
  const TcPlan plan(S, D, dh, F, nwarps);
  const int R = plan.R;
  float* xs = reinterpret_cast<float*>(smem_raw + plan.xs);
  float* proj = reinterpret_cast<float*>(smem_raw + plan.proj);
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + plan.hs);
  bf16* q = reinterpret_cast<bf16*>(smem_raw + plan.q);
  bf16* k = reinterpret_cast<bf16*>(smem_raw + plan.k);
  bf16* v = reinterpret_cast<bf16*>(smem_raw + plan.v);
  float* sc = reinterpret_cast<float*>(smem_raw + plan.sc);
  bf16* p = reinterpret_cast<bf16*>(smem_raw + plan.p);
  bf16* hid = reinterpret_cast<bf16*>(smem_raw + plan.hid);
  bf16* wst = reinterpret_cast<bf16*>(smem_raw + plan.wst);
  float* stage = reinterpret_cast<float*>(smem_raw + plan.stage);

  const int seqs = seqs_per_block(S);
  const int seq0 = blockIdx.x * seqs;
  const int rows = min(seqs, B - seq0) * S;
  const int I = H * dh;
  const size_t base = static_cast<size_t>(seq0) * S * D;

  // zero everything: the padding rows (rows..R) of every operand must be
  // finite, since their products are computed and then dropped
  for (size_t i = tid; i < plan.bytes / sizeof(uint4); i += nthr)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int i = tid; i < rows * D; i += nthr) xs[i] = to_f(x[base + i]);
  __syncthreads();
  layer_norm_rows<bf16, bf16>(xs, hs, plan.ld_h, rows, D, ln1s, ln1b);

  const int ld_w3 = 3 * dh + kPad, ld_wd = D + kPad;
  for (int h = 0; h < H; ++h) {
    for (int j = 0; j < 3; ++j)  // this head's q, k and v columns, side by side
      stage_weights(wqkv + j * I + h * dh, 3 * I, D, dh, wst + j * dh, ld_w3);
    __syncthreads();
    tc_mm<kTcStoreBf16, wmma::row_major>(hs, plan.ld_h, R, D, wst, ld_w3, dh, q, plan.ld_q,
                                         nullptr, stage, rows);
    tc_mm<kTcStoreBf16, wmma::row_major>(hs, plan.ld_h, R, D, wst + dh, ld_w3, dh, k,
                                         plan.ld_q, nullptr, stage, rows);
    tc_mm<kTcStoreBf16, wmma::row_major>(hs, plan.ld_h, R, D, wst + 2 * dh, ld_w3, dh, v,
                                         plan.ld_q, nullptr, stage, rows);
    __syncthreads();

    // scores of every row against every row of the block (q carries the
    // 1/sqrt(dh) scale); the softmax keeps only a row's own sequence
    tc_mm<kTcStoreF32, wmma::col_major>(q, plan.ld_q, R, dh, k, plan.ld_q, R, sc, plan.ld_sc,
                                        nullptr, stage, rows);
    __syncthreads();

    // fp32 softmax with row-max subtraction over the row's own sequence,
    // one warp per row; probabilities rounded to bf16 as the AV operand,
    // exact zeros elsewhere. Meanwhile the head's out-projection rows are
    // staged (the q/k/v weights are no longer read).
    stage_weights(wout + static_cast<size_t>(h) * dh * D, D, dh, D, wst, ld_wd);
    for (int r = tid / 32; r < R; r += nwarps) {
      bf16* pr = p + r * plan.ld_p;
      if (r >= rows) {
        for (int c = lane; c < R; c += 32) pr[c] = __float2bfloat16(0.f);
        continue;
      }
      const float* s = sc + r * plan.ld_sc;
      const int lo = r / S * S, hi = lo + S;
      float m = __int_as_float(0xff800000);  // -inf
      for (int c = lo + lane; c < hi; c += 32) m = fmaxf(m, s[c]);
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lo + lane; c < hi; c += 32) sum += expf(s[c] - m);
      const float inv = 1.f / warp_sum(sum);
      // dropout site 1 on [B', H, S, S]: (sequence, head, query, key)
      const uint64_t idx0 = ((static_cast<uint64_t>(seq0 + r / S) * H + h) * S + r % S) * S;
      for (int c = lane; c < R; c += 32)
        pr[c] = __float2bfloat16(
            c >= lo && c < hi ? expf(s[c] - m) * inv * drop_mult(dc, kSiteAttn, idx0 + c - lo)
                              : 0.f);
    }
    __syncthreads();

    // o = a . v, written over q (dead after the scores), rounded to bf16
    tc_mm<kTcStoreBf16, wmma::row_major>(p, plan.ld_p, R, R, v, plan.ld_q, dh, q, plan.ld_q,
                                         nullptr, stage, rows);
    __syncthreads();
    // this head's slice of the out-projection: o_h [R, dh] x wout[h*dh:(h+1)*dh, :]
    tc_mm<kTcAccumulateF32, wmma::row_major>(q, plan.ld_q, R, dh, wst, ld_wd, D, proj, D,
                                             nullptr, stage, rows);
    __syncthreads();
  }

  stage_weights(w1, F, D, F, wst, F + kPad);
  const long long row0 = static_cast<long long>(seq0) * S;
  for (int i = tid; i < rows * D; i += nthr) {
    const float m = dc.proj ? drop_mult(dc, kSiteProj, row0 * D + i) : 1.f;
    xs[i] = xs[i] + (proj[i] + bout[i % D]) * m;
  }
  __syncthreads();
  layer_norm_rows<bf16, bf16>(xs, hs, plan.ld_h, rows, D, ln2s, ln2b);
  __syncthreads();
  tc_mm<kTcBiasGeluBf16, wmma::row_major>(hs, plan.ld_h, R, D, wst, F + kPad, F, hid,
                                          plan.ld_hid, b1, stage, rows, dc, row0);
  __syncthreads();
  stage_weights(w2, D, F, D, wst, ld_wd);
  __syncthreads();
  tc_mm<kTcBiasResidual, wmma::row_major>(hid, plan.ld_hid, R, F, wst, ld_wd, D, xs, D, b2,
                                          stage, rows, dc, row0);
  __syncthreads();

  for (int i = tid; i < rows * D; i += nthr) y[base + i] = from_f<T>(xs[i]);
}

// ---------------------------------------------------------------------------
// launches

template <typename T, typename C>
cudaError_t launch_fma(const void* x, void* y, const void* ln1s, const void* ln1b,
                       const void* wqkv, const void* wout, const void* bout,
                       const void* ln2s, const void* ln2b, const void* w1, const void* b1,
                       const void* w2, const void* b2,
                       int B, int S, int D, int H, int dh, int F, DropCfg dc,
                       cudaStream_t stream) {
  const int seqs = seqs_per_block(S);
  const size_t bytes = smem_floats(seqs, S, D, dh, F) * sizeof(float);
  auto kernel = fused_layer_fwd_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(B + seqs - 1) / seqs, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const float*>(ln1s), static_cast<const float*>(ln1b),
      static_cast<const C*>(wqkv), static_cast<const C*>(wout),
      static_cast<const float*>(bout),
      static_cast<const float*>(ln2s), static_cast<const float*>(ln2b),
      static_cast<const C*>(w1), static_cast<const float*>(b1),
      static_cast<const C*>(w2), static_cast<const float*>(b2),
      B, S, D, H, dh, F, dc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc(const void* x, void* y, const void* ln1s, const void* ln1b,
                      const void* wqkv, const void* wout, const void* bout,
                      const void* ln2s, const void* ln2b, const void* w1, const void* b1,
                      const void* w2, const void* b2,
                      int B, int S, int D, int H, int dh, int F, DropCfg dc,
                      cudaStream_t stream) {
  const int seqs = seqs_per_block(S);
  const size_t bytes = TcPlan(S, D, dh, F, kTcThreads / 32).bytes;
  auto kernel = fused_layer_fwd_tc_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(B + seqs - 1) / seqs, kTcThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const float*>(ln1s), static_cast<const float*>(ln1b),
      static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wout),
      static_cast<const float*>(bout),
      static_cast<const float*>(ln2s), static_cast<const float*>(ln2b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      B, S, D, H, dh, F, dc);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, y: [B, S, D] in T (fp32, or bf16 when io_bf16). wqkv [D, 3*H*dh] (q
// block pre-scaled), wout [H*dh, D], w1 [D, F], w2 [F, D] in the compute type
// (bf16 when compute_bf16, else fp32). LN scales/biases and the three
// biases in fp32. Dropout: drop_on (train and rate > 0), drop_proj (the
// projection site is active), the layer seed, the keep threshold
// uint32(rate * 2^32) and the scale 1 / (1 - rate); seed and threshold
// arrive as the int bit patterns of their uint32 values. Launches on
// `stream`; returns cudaGetLastError(). bf16 compute takes the tensor-core
// form when D, dh and F are multiples of 16 and the weights are 16-byte
// aligned, else the FMA form.
extern "C" int fused_layer_fwd(const void* x, void* y, const void* ln1s, const void* ln1b,
                               const void* wqkv, const void* wout, const void* bout,
                               const void* ln2s, const void* ln2b, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               int B, int S, int D, int H, int dh, int F,
                               int io_bf16, int compute_bf16, int drop_on, int drop_proj,
                               int drop_seed, int drop_thr, float drop_scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const DropCfg dc{drop_on, drop_proj, static_cast<uint32_t>(drop_seed),
                   static_cast<uint32_t>(drop_thr), drop_scale};
  const bool tc = compute_bf16 && D % 16 == 0 && dh % 16 == 0 && F % 16 == 0 &&
                  aligned16(wqkv) && aligned16(wout) && aligned16(w1) && aligned16(w2);
  cudaError_t err;
  if (tc && io_bf16)
    err = launch_tc<__nv_bfloat16>(x, y, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b,
                                   w1, b1, w2, b2, B, S, D, H, dh, F, dc, st);
  else if (tc)
    err = launch_tc<float>(x, y, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b,
                           w1, b1, w2, b2, B, S, D, H, dh, F, dc, st);
  else if (io_bf16 && compute_bf16)
    err = launch_fma<__nv_bfloat16, __nv_bfloat16>(x, y, ln1s, ln1b, wqkv, wout, bout, ln2s,
                                                   ln2b, w1, b1, w2, b2, B, S, D, H, dh, F, dc, st);
  else if (io_bf16)
    err = launch_fma<__nv_bfloat16, float>(x, y, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b,
                                           w1, b1, w2, b2, B, S, D, H, dh, F, dc, st);
  else if (compute_bf16)
    err = launch_fma<float, __nv_bfloat16>(x, y, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b,
                                           w1, b1, w2, b2, B, S, D, H, dh, F, dc, st);
  else
    err = launch_fma<float, float>(x, y, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b,
                                   w1, b1, w2, b2, B, S, D, H, dh, F, dc, st);
  return static_cast<int>(err);
}
