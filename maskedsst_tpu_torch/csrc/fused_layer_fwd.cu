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
// Given an x1 buffer (the training call of the tensor-core form), it also
// writes the residual stream after attention, so that the backward's row
// kernel starts from it instead of recomputing the attention forward.
//
// What bounds it on the H100: operations, and in the tensor-core form the
// latency between them. At dim 96, inner width 512 and seq 64 a token costs
// ~5.5e5 flop against 2 x 96 values of slab traffic, i.e. thousands of flop
// per byte; the QKV projection is over half of it. The WMMA kernel this form
// replaces ran at ~3 % of the bf16 peak: ~50 block-wide barriers per 64-row
// block between products of one 16x16 tile per warp, every epilogue and the
// [rows, dim] projection sum round-tripping through shared memory, the
// weight slices copied with nothing running under the copy, and 181 KB of
// shared memory, so one 512-thread block per SM.
//
// What this design does about it. One block owns up to 64 rows (one
// sequence at seq 64, three at seq 20, twelve at seq 5), one warp per 16
// rows, and loops over heads. Two forms, chosen at launch from what the call
// gives:
//  - tensor cores (bf16 compute; D, dh and F multiples of 16, tc_widths):
//    every product is mma.sync.m16n8k16 (bf16, fp32 sums), B operands by
//    ldmatrix from shared memory, A operands from registers. A warp keeps
//    its rows in registers from the x load to the y store: LN1's output
//    as A fragments for all heads, q, the scores, the softmax (quad
//    shuffles), the dropped probabilities as the A.V product's A
//    fragments, each head's output o, the [16, dim] out-projection sum
//    across heads, x1, LN2 and the GELU output. Every epilogue (bf16
//    rounding, bias + GELU + site 5, bias + site 7 + residual) works on the
//    accumulator fragments. Only k and v of the head and the weight slices
//    live in shared memory (70 KB at the EnMAP widths), two barriers a
//    head. The slices are staged with cp.async into each buffer as soon as
//    its last reader is done, under the other half of the head's products
//    (head h + 1's q/k/v columns under head h's attention and
//    out-projection, its out-projection rows under its q/k/v product; w1
//    and w2 under the last head and LN2). Attention keeps a
//    row's own sequence: the score and A.V products skip the 16-key steps
//    outside the warp's sequences, the softmax masks the rest;
//  - FMA loops (fp32 compute, or widths the tensor-core form does not
//    take): an 8-row register tile per thread, weights read from L2, the
//    whole layer in dynamic shared memory (the residual stream, the LN
//    output, the projection accumulator, q/k/v of one head, the scores and
//    the MLP hidden layer), each head multiplied straight into the
//    projection accumulator. It is far below even the FMA peak. Past
//    ~85 rows at the model's widths that layout exceeds the card's
//    shared memory: a plan of a higher level (fused_layer_fwd_plan) moves
//    the [rows, D] buffers, then the scores and the hidden layer, to a
//    per-block scratch in device memory until it fits.

#include <cstdint>

#include "common.cuh"
#include "warp_mma.cuh"

using namespace msst;

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

// The FMA form's plan, in floats. Level 0 keeps every buffer in shared
// memory (`floats`); each level above moves one more buffer, in the order
// of `order`, to the block's slice of a scratch area in device memory
// (`gfloats` a block), reached through L1 and L2. The launch takes the
// lowest level that fits the card's opt-in limit on shared memory.
enum FwdSpill : unsigned { kFProj = 1, kFXs = 2, kFHs = 4, kFSc = 8, kFHid = 16 };
constexpr int kFwdLevels = 6;

struct FwdPlan {
  int rcap, ldh;
  unsigned spill;
  size_t xs, hs, proj, q, k, v, sc, hid, floats, gfloats;

  __host__ __device__ FwdPlan(int S, int D, int dh, int F, int level = 0) {
    const unsigned order[] = {kFProj, kFXs, kFHs, kFSc, kFHid};
    spill = spill_bits(order, level);
    rcap = round_up(seqs_per_block(S) * S, kRowTile);
    ldh = dh + 1;  // odd stride: the k/v column walks are free of bank conflicts
    Placer pl(spill, 1);
    const size_t r = static_cast<size_t>(rcap);
    xs = pl.put(r * D, kFXs);      // [rcap, D]   residual stream
    hs = pl.put(r * D, kFHs);      // [rcap, D]   LN1 / LN2 output
    proj = pl.put(r * D, kFProj);  // [rcap, D]   out-projection accumulator
    q = pl.put(r * ldh, 0);        // [rcap, ldh] q, then the head's attention output
    k = pl.put(r * ldh, 0);        // [rcap, ldh]
    v = pl.put(r * ldh, 0);        // [rcap, ldh]
    sc = pl.put(r * S, kFSc);      // [seqs, S, S] scores, then probabilities
    hid = pl.put(r * F, kFHid);    // [rcap, F]   MLP hidden layer
    floats = pl.shared;
    gfloats = pl.device;
  }
};

// FLEX: a plan of level > 0 (some buffers in the block's slice of
// `scratch`); without it every buffer is in shared memory
template <typename T, typename C, bool FLEX>
__global__ void __launch_bounds__(kThreads)
fused_layer_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                       const C* __restrict__ wqkv, const C* __restrict__ wout,
                       const float* __restrict__ bout,
                       const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                       const C* __restrict__ w1, const float* __restrict__ b1,
                       const C* __restrict__ w2, const float* __restrict__ b2,
                       float* __restrict__ scratch, int B, int S, int D, int H, int dh, int F,
                       int level, DropCfg dc) {
  extern __shared__ float smem[];
  const int seqs = seqs_per_block(S);
  const int rcap = round_up(seqs * S, kRowTile);
  const int ldh = dh + 1;  // odd stride: the k/v column walks are free of bank conflicts
  // level 0, FwdPlan's layout written out (the arithmetic of the form
  // before the plans, whose code it keeps)
  float* xs = smem;                 // [rcap, D]   residual stream
  float* hs = xs + rcap * D;        // [rcap, D]   LN1 / LN2 output
  float* proj = hs + rcap * D;      // [rcap, D]   out-projection accumulator
  float* q = proj + rcap * D;       // [rcap, ldh] q, then the head's attention output
  float* k = q + rcap * ldh;        // [rcap, ldh]
  float* v = k + rcap * ldh;        // [rcap, ldh]
  float* sc = v + rcap * ldh;       // [seqs, S, S] scores, then probabilities
  float* hid = sc + rcap * S;       // [rcap, F]   MLP hidden layer
  if constexpr (FLEX) {
    const FwdPlan plan(S, D, dh, F, level);
    float* gblk = scratch + static_cast<size_t>(blockIdx.x) * plan.gfloats;
    auto at = [&](size_t off, unsigned bit) { return plan.spill & bit ? gblk + off : smem + off; };
    xs = at(plan.xs, kFXs);
    hs = at(plan.hs, kFHs);
    proj = at(plan.proj, kFProj);
    q = smem + plan.q;
    k = smem + plan.k;
    v = smem + plan.v;
    sc = at(plan.sc, kFSc);
    hid = at(plan.hid, kFHid);
  }

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

// bf16 row padding of the staged tiles: 16-byte rows, ldmatrix free of bank conflicts
constexpr int kPad = 8;

__host__ __device__ inline size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }
__host__ __device__ inline size_t larger(size_t a, size_t b) { return a > b ? a : b; }

// Byte offsets of the tensor-core form's shared memory. R is the block's row
// count rounded up to 16 (one warp per 16 rows). Two weight buffers: `wa`
// holds one head's q, k and v columns side by side [D, 3dh] and then w1
// [D, F]; `wb` one head's out-projection rows [dh, D] and then w2 [F, D].
// k and v of the head, [R, dh] each, are the only activations shared
// between warps; everything else a warp computes stays in its registers.
struct TcPlan {
  int R, ld_w3, ld_w1, ld_wd, ld_kv;
  size_t wa, wb, k, v, bytes;

  __host__ __device__ TcPlan(int S, int D, int dh, int F) {
    R = round_up(seqs_per_block(S) * S, 16);
    ld_w3 = 3 * dh + kPad;
    ld_w1 = F + kPad;
    ld_wd = D + kPad;
    ld_kv = dh + kPad;
    const size_t a = larger(static_cast<size_t>(D) * ld_w3, static_cast<size_t>(D) * ld_w1);
    const size_t b = static_cast<size_t>(dh > F ? dh : F) * ld_wd;
    size_t off = 0;
    wa = off; off += align128(sizeof(bf16) * a);
    wb = off; off += align128(sizeof(bf16) * b);
    k = off;  off += align128(sizeof(bf16) * R * ld_kv);
    v = off;  off += align128(sizeof(bf16) * R * ld_kv);
    bytes = off;
  }
};

// The keys the warp owning rows [r0, r0 + 16) of a block of R rows can see,
// the sequences of those rows, [lo, hi); base is lo rounded down to 16, from
// where the warp counts its score tiles (at most R - base keys: the score
// tile of KT >= R / 8 tiles holds them).
struct KeyWindow {
  int lo, hi, base;

  __host__ __device__ KeyWindow(int S, int R, int r0)
      : lo(r0 / S * S), hi(min(R, ((r0 + 15) / S + 1) * S)), base(r0 / S * S / 16 * 16) {}
};

// The widths the tensor-core form takes (the same test as ops/fused_layer.py
// ::_tc_form): bf16 compute, D, dh and F multiples of 16, D and F at most
// 128, dh at most 64, at most 128 rows a block. The kernel below is
// instantiated twice: at exactly the model's widths (D 96, dh 64, F 64, up
// to 64 rows a block), and with these maxima and the widths read at run time.
__host__ __device__ inline bool tc_widths(int S, int D, int dh, int F) {
  return D % 16 == 0 && dh % 16 == 0 && F % 16 == 0 && D <= 128 && dh <= 64 && F <= 128 &&
         TcPlan(S, D, dh, F).R <= 128;
}

// dst [K, N] (row stride ldd, shared) = src [K, N] (row stride lds, device
// memory), bf16 with 16-byte aligned rows and N a multiple of 8, issued with
// cp.async: the copy lands while the block computes. cp_async_wait_all() and
// a barrier come before the first read.
__device__ void stage_async(const bf16* __restrict__ src, size_t lds, int K, int N, bf16* dst,
                            int ldd) {
  const int vec = N / 8;
  for (int i = threadIdx.x; i < K * vec; i += blockDim.x) {
    const int r = i / vec, c = (i % vec) * 8;
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ldd + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + r * lds + c));
  }
}

// acc[j] (the 8-column tile at column n0 + 8j of the product, j in [j_lo,
// j_hi), j_lo even) += A x B over the k-steps [k_lo, k_hi): A as register
// fragments, B from shared memory (TRANS: stored transposed, ldsm_nk). NT
// and KS are the maxima; the run-time bounds skip the rest. k-steps
// outside, tiles inside: each k-step issues its products back to back,
// independent of each other.
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
// thread's elements of 2 kd accumulator tiles; rows that do not exist read 0
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

// LayerNorm over the D = 8 nt columns of the thread's two rows held as
// accumulator tiles, rounded to bf16 as the A fragments of the next
// product. Two-pass fp32 statistics as the plain version takes them (a
// mean is the sum times fl(1/D); separate roundings where it rounds
// twice, no fused multiply-add); the quad reduces with shuffles.
template <int KS>
__device__ __forceinline__ void ln_frag(uint32_t (&a)[KS][4], const float (&v)[2 * KS][4],
                                        int nt, int D, const float* __restrict__ scale,
                                        const float* __restrict__ bias, int c) {
  const float inv_d = 1.f / D;
  float o[2 * KS][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float t[4 * KS];
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) t[2 * j + e] = v[j][2 * half + e];  // 0 past nt
    const float mu = __fmul_rn(quad_sum(t), inv_d);
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = v[j][2 * half + e] - mu;
        t[2 * j + e] = j < nt ? __fmul_rn(d, d) : 0.f;
      }
    const float rsig = rsqrtf(__fadd_rn(__fmul_rn(quad_sum(t), inv_d), kLnEps));
#pragma unroll
    for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * c + e;
        o[j][2 * half + e] =
            j < nt ? __fadd_rn(__fmul_rn(__fmul_rn(v[j][2 * half + e] - mu, rsig), scale[col]),
                               bias[col])
                   : 0.f;
      }
  }
  to_afrag<KS>(a, o);
}

// KD, KH, KF: 16-column k-steps of D, dh and F (EXACT: the widths; else
// their maxima, the widths read at run time); KT: 8-key tiles of the
// scores, at least R / 8. One warp per 16 rows of the block, at most MAXR
// rows; MINB blocks per SM bound the registers.
template <typename T, int KD, int KH, int KF, int KT, bool EXACT, int MAXR, int MINB>
__global__ void __launch_bounds__(2 * MAXR, MINB)
fused_layer_fwd_tc_kernel(const T* __restrict__ x, T* __restrict__ y, float* __restrict__ x1,
                          const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                          const bf16* __restrict__ wqkv, const bf16* __restrict__ wout,
                          const float* __restrict__ bout,
                          const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                          const bf16* __restrict__ w1, const float* __restrict__ b1,
                          const bf16* __restrict__ w2, const float* __restrict__ b2,
                          int B, int S, int D, int H, int dh, int F, DropCfg dc) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TcPlan plan(S, D, dh, F);
  bf16* wa = reinterpret_cast<bf16*>(smem_raw + plan.wa);
  bf16* wb = reinterpret_cast<bf16*>(smem_raw + plan.wb);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + plan.k);
  bf16* vs = reinterpret_cast<bf16*>(smem_raw + plan.v);
  const int kd = EXACT ? KD : D / 16, kh = EXACT ? KH : dh / 16, kf = EXACT ? KF : F / 16;
  const int lane = threadIdx.x % 32, c = lane % 4;
  const int R = plan.R, r0 = threadIdx.x / 32 * 16;
  const int ra = r0 + lane / 4;  // the thread's rows: ra and ra + 8
  const int seqs = seqs_per_block(S);
  const int seq0 = blockIdx.x * seqs;
  const int rows = min(seqs, B - seq0) * S;
  const bool ok_a = ra < rows, ok_b = ra + 8 < rows;
  const int I = H * dh;
  const long long tok0 = static_cast<long long>(seq0) * S;  // token row of block row 0
  const size_t at = static_cast<size_t>(tok0 + ra) * D;     // row ra in x, y and x1
  // the logical rows of the thread's two rows, for the dropout indices
  const uint64_t row_a = static_cast<uint64_t>(tok0 + ra), row_b = row_a + 8;

  // The weight slices are staged with cp.async into their buffer as soon as
  // its last reader is done, so each copy runs under half a head's
  // products: head h + 1's q/k/v columns (then w1) once every warp has
  // taken head h's q/k/v, its out-projection rows (then w2) once every warp
  // has taken head h's out-projection. Head 0's come in under LN1.
  auto stage_qkv = [&](int h) {
    for (int j = 0; j < 3; ++j)  // the head's q, k and v columns, side by side
      stage_async(wqkv + j * I + h * dh, 3 * I, D, dh, wa + j * dh, plan.ld_w3);
  };
  auto stage_out = [&](int h) {
    stage_async(wout + static_cast<size_t>(h) * dh * D, D, dh, D, wb, plan.ld_wd);
  };
  stage_qkv(0);
  stage_out(0);

  // LN1 of the warp's rows, straight from device memory into the A
  // fragments of the q/k/v products, kept for every head
  uint32_t hf[KD][4];
  {
    float v[2 * KD][4];
    load_rows<2 * KD>(v, x + at, D, 2 * kd, ok_a, ok_b, c);
    ln_frag<KD>(hf, v, 2 * kd, D, ln1s, ln1b, c);
  }
  // the out-projection sum over heads, then x1
  float proj[2 * KD][4];
  zero(proj);
  // the keys the warp's rows can see; score tile j holds keys kw.base + 8j
  const KeyWindow kw(S, R, r0);
  const int steps = (kw.hi - kw.base + 15) / 16;  // 16-key k-steps of the A.V product
  const bf16* kw_k = ks + kw.base * plan.ld_kv;
  const bf16* kw_v = vs + kw.base * plan.ld_kv;

  cp_async_wait_all();
  __syncthreads();  // head 0's slices
  for (int h = 0; h < H; ++h) {

    // q stays in registers as the scores' A fragments; k and v go to
    // shared memory, where every warp of the block reads them
    uint32_t qf[KH][4];
    {
      float acc[2 * KH][4];
      zero(acc);
      warp_mm<KD, 2 * KH>(acc, hf, 0, kd, wa, plan.ld_w3, 0, 0, 2 * kh, lane);
      to_afrag<KH>(qf, acc);
    }
#pragma unroll
    for (int part = 1; part < 3; ++part) {
      float acc[2 * KH][4];
      zero(acc);
      warp_mm<KD, 2 * KH>(acc, hf, 0, kd, wa, plan.ld_w3, part * dh, 0, 2 * kh, lane);
      store_bf16<2 * KH>(acc, part == 1 ? ks : vs, plan.ld_kv, ra, 2 * kh, c);
    }
    cp_async_wait_all();  // this head's out-projection rows
    __syncthreads();      // k and v are whole; the q/k/v buffer is free
    if (h + 1 < H)
      stage_qkv(h + 1);
    else
      stage_async(w1, F, D, F, wa, plan.ld_w1);

    // scores q k^T of the warp's rows against the keys they can see (q
    // carries the 1/sqrt(dh) scale)
    float sc[KT][4];
    zero(sc);
    warp_mm<KH, KT, true>(sc, qf, 0, kh, kw_k, plan.ld_kv, 0, 0, 2 * steps, lane);
    // fp32 softmax over the row's own sequence as the plain version takes
    // it: row-max subtraction, exp, a pairwise sum, each term divided by
    // it; dropout site 1 on [B', H, S, S] at (sequence, head, query, key);
    // the probabilities rounded to bf16 as the A.V product's A fragments
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = ra + 8 * half;
      const int lo = r / S * S - kw.base, hi = min(r / S * S + S, R) - kw.base;
      float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c + e;
          if (col >= lo && col < hi) m = fmaxf(m, sc[j][2 * half + e]);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float ex[2 * KT];
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c + e;
          ex[2 * j + e] = col >= lo && col < hi ? expf(sc[j][2 * half + e] - m) : 0.f;
        }
      const float sum = quad_sum(ex);
      // site 1 index of the key in column col: idx0 + col
      const uint64_t idx0 =
          ((static_cast<uint64_t>(seq0 + r / S) * H + h) * S + r % S) * S - lo;
      const DropRun drop(dc, kSiteAttn, idx0 + lo);
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c + e;
          sc[j][2 * half + e] =
              col >= lo && col < hi ? __fdiv_rn(ex[2 * j + e], sum) * drop(dc, idx0 + col) : 0.f;
        }
    }
    uint32_t pf[KT / 2][4];
    to_afrag<KT / 2>(pf, sc);

    // o = a . v over the visible keys, rounded to bf16, then this head's
    // slice of the out-projection: proj += o_h [16, dh] x wout[h dh:(h+1) dh, :]
    uint32_t of[KH][4];
    {
      float acc[2 * KH][4];
      zero(acc);
      warp_mm<KT / 2, 2 * KH>(acc, pf, 0, steps, kw_v, plan.ld_kv, 0, 0, 2 * kh, lane);
      to_afrag<KH>(of, acc);
    }
    warp_mm<KH, 2 * KD>(proj, of, 0, kh, wb, plan.ld_wd, 0, 0, 2 * kd, lane);
    cp_async_wait_all();  // the next head's q/k/v columns (or w1)
    __syncthreads();      // every warp is done with k, v and the out-projection rows
    if (h + 1 < H)
      stage_out(h + 1);
    else
      stage_async(w2, D, F, D, wb, plan.ld_wd);
  }

  // x1 = x + the dropped projection (site 3), in place of the sum
  {
    float xv[2 * KD][4];
    load_rows<2 * KD>(xv, x + at, D, 2 * kd, ok_a, ok_b, c);
    const DropRun drop[2] = {DropRun(dc, kSiteProj, row_a * D),
                             DropRun(dc, kSiteProj, row_b * D)};
#pragma unroll
    for (int j = 0; j < 2 * KD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * c + e % 2;
        if (j >= 2 * kd) continue;
        const float m = dc.proj ? drop[e / 2](dc, (e < 2 ? row_a : row_b) * D + col) : 1.f;
        proj[j][e] = __fadd_rn(xv[j][e], __fmul_rn(__fadd_rn(proj[j][e], bout[col]), m));
      }
  }
  if (x1) store_rows<2 * KD>(proj, x1 + at, D, 2 * kd, ok_a, ok_b, c);
  ln_frag<KD>(hf, proj, 2 * kd, D, ln2s, ln2b, c);

  // fc1 + b1 -> GELU -> dropout site 5, rounded to bf16 as fc2's A fragments
  uint32_t gf[KF][4];
  {
    float u[2 * KF][4];
    zero(u);
    warp_mm<KD, 2 * KF>(u, hf, 0, kd, wa, plan.ld_w1, 0, 0, 2 * kf, lane);
    const DropRun drop[2] = {DropRun(dc, kSiteFfMid, row_a * F),
                             DropRun(dc, kSiteFfMid, row_b * F)};
#pragma unroll
    for (int j = 0; j < 2 * KF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * c + e % 2;
        if (j >= 2 * kf) continue;
        const float m = drop[e / 2](dc, (e < 2 ? row_a : row_b) * F + col);
        u[j][e] = gelu(u[j][e] + b1[col]) * m;
      }
    to_afrag<KF>(gf, u);
  }
  cp_async_wait_all();
  __syncthreads();  // w2
  // fc2 + b2 -> dropout site 7 -> residual
  float ff[2 * KD][4];
  zero(ff);
  warp_mm<KF, 2 * KD>(ff, gf, 0, kf, wb, plan.ld_wd, 0, 0, 2 * kd, lane);
  const DropRun drop[2] = {DropRun(dc, kSiteFfOut, row_a * D),
                           DropRun(dc, kSiteFfOut, row_b * D)};
#pragma unroll
  for (int j = 0; j < 2 * KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * c + e % 2;
      if (j >= 2 * kd) continue;
      const float m = drop[e / 2](dc, (e < 2 ? row_a : row_b) * D + col);
      ff[j][e] = __fadd_rn(proj[j][e], __fmul_rn(__fadd_rn(ff[j][e], b2[col]), m));
    }
  store_rows<2 * KD>(ff, y + at, D, 2 * kd, ok_a, ok_b, c);
}

// ---------------------------------------------------------------------------
// launches

template <typename T, typename C, bool FLEX>
cudaError_t launch_fma_as(const void* x, void* y, const void* ln1s, const void* ln1b,
                          const void* wqkv, const void* wout, const void* bout,
                          const void* ln2s, const void* ln2b, const void* w1, const void* b1,
                          const void* w2, const void* b2, void* scratch,
                          int B, int S, int D, int H, int dh, int F, int level, DropCfg dc,
                          cudaStream_t stream) {
  const int seqs = seqs_per_block(S);
  const size_t bytes = FwdPlan(S, D, dh, F, level).floats * sizeof(float);
  auto kernel = fused_layer_fwd_kernel<T, C, FLEX>;
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
      static_cast<const C*>(w2), static_cast<const float*>(b2), static_cast<float*>(scratch),
      B, S, D, H, dh, F, level, dc);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_fma(const void* x, void* y, const void* ln1s, const void* ln1b,
                       const void* wqkv, const void* wout, const void* bout,
                       const void* ln2s, const void* ln2b, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* scratch,
                       int B, int S, int D, int H, int dh, int F, int level, DropCfg dc,
                       cudaStream_t stream) {
  return (level ? launch_fma_as<T, C, true> : launch_fma_as<T, C, false>)(
      x, y, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1, w2, b2, scratch, B, S, D, H, dh,
      F, level, dc, stream);
}

template <typename T, int KD, int KH, int KF, int KT, bool EXACT, int MAXR, int MINB>
cudaError_t launch_tc_as(const void* x, void* y, void* x1, const void* ln1s, const void* ln1b,
                         const void* wqkv, const void* wout, const void* bout,
                         const void* ln2s, const void* ln2b, const void* w1, const void* b1,
                         const void* w2, const void* b2,
                         int B, int S, int D, int H, int dh, int F, DropCfg dc,
                         cudaStream_t stream) {
  const int seqs = seqs_per_block(S);
  const TcPlan plan(S, D, dh, F);
  auto kernel = fused_layer_fwd_tc_kernel<T, KD, KH, KF, KT, EXACT, MAXR, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return err;
  kernel<<<(B + seqs - 1) / seqs, 2 * plan.R, plan.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<float*>(x1),
      static_cast<const float*>(ln1s), static_cast<const float*>(ln1b),
      static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wout),
      static_cast<const float*>(bout),
      static_cast<const float*>(ln2s), static_cast<const float*>(ln2b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      B, S, D, H, dh, F, dc);
  return cudaGetLastError();
}

// the model's widths (D 96, dh 64, F 64, at most 64 rows a block) take the
// instantiation with every width fixed, three blocks per SM; the rest of
// tc_widths the one with the maxima
template <typename T>
cudaError_t launch_tc(const void* x, void* y, void* x1, const void* ln1s, const void* ln1b,
                      const void* wqkv, const void* wout, const void* bout,
                      const void* ln2s, const void* ln2b, const void* w1, const void* b1,
                      const void* w2, const void* b2,
                      int B, int S, int D, int H, int dh, int F, DropCfg dc,
                      cudaStream_t stream) {
  if (D == 96 && dh == 64 && F == 64 && TcPlan(S, D, dh, F).R <= 64)
    return launch_tc_as<T, 6, 4, 4, 8, true, 64, 3>(
        x, y, x1, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1, w2, b2, B, S, D, H, dh, F,
        dc, stream);
  return launch_tc_as<T, 8, 4, 8, 16, false, 128, 1>(
      x, y, x1, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1, w2, b2, B, S, D, H, dh, F, dc,
      stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The FMA form's plan at this geometry: out[0] the lowest level whose
// shared memory fits the card's opt-in limit, or -1 when none does; out[1]
// that level's shared bytes (when none fits, the last level's); out[2] its
// device scratch bytes per block; out[3] the card's limit. Returns a CUDA
// error code.
extern "C" int fused_layer_fwd_plan(int S, int D, int dh, int F, long long* out) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = -1;
  out[3] = limit;
  for (int level = 0; level < kFwdLevels; ++level) {
    const FwdPlan plan(S, D, dh, F, level);
    out[1] = static_cast<long long>(plan.floats * sizeof(float));
    out[2] = static_cast<long long>(plan.gfloats * sizeof(float));
    if (plan.floats * sizeof(float) <= static_cast<size_t>(limit)) {
      out[0] = level;
      break;
    }
  }
  return 0;
}

// x, y: [B, S, D] in T (fp32, or bf16 when io_bf16). wqkv [D, 3*H*dh] (q
// block pre-scaled), wout [H*dh, D], w1 [D, F], w2 [F, D] in the compute type
// (bf16 when compute_bf16, else fp32). LN scales/biases and the three
// biases in fp32. Dropout: drop_on (train and rate > 0), drop_proj (the
// projection site is active), the layer seed, the keep threshold
// uint32(rate * 2^32) and the scale 1 / (1 - rate); seed and threshold
// arrive as the int bit patterns of their uint32 values. Launches on
// `stream`; returns cudaGetLastError(). bf16 compute takes the tensor-core
// form at the widths tc_widths takes with 16-byte aligned weights, else the
// FMA form, whose plan `level` (fused_layer_fwd_plan) places some buffers
// in `scratch`: one slice of the plan's scratch bytes per block of the grid
// (null when those are 0). x1: null, or (tensor-core form only) an fp32
// [B, S, D] that receives the residual stream after attention, x + the
// dropped projection, for fused_layer_bwd.cu's row kernel.
extern "C" int fused_layer_fwd(const void* x, void* y, void* x1, const void* ln1s,
                               const void* ln1b,
                               const void* wqkv, const void* wout, const void* bout,
                               const void* ln2s, const void* ln2b, const void* w1,
                               const void* b1, const void* w2, const void* b2, void* scratch,
                               int B, int S, int D, int H, int dh, int F,
                               int io_bf16, int compute_bf16, int level, int drop_on,
                               int drop_proj, int drop_seed, int drop_thr, float drop_scale,
                               void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const DropCfg dc{drop_on, drop_proj, static_cast<uint32_t>(drop_seed),
                   static_cast<uint32_t>(drop_thr), drop_scale};
  const bool tc = compute_bf16 && tc_widths(S, D, dh, F) && aligned16(wqkv) &&
                  aligned16(wout) && aligned16(w1) && aligned16(w2);
  if ((x1 && !tc) || level < 0 || level >= kFwdLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (tc && io_bf16)
    err = launch_tc<__nv_bfloat16>(x, y, x1, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b,
                                   w1, b1, w2, b2, B, S, D, H, dh, F, dc, st);
  else if (tc)
    err = launch_tc<float>(x, y, x1, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b,
                           w1, b1, w2, b2, B, S, D, H, dh, F, dc, st);
  else if (io_bf16 && compute_bf16)
    err = launch_fma<__nv_bfloat16, __nv_bfloat16>(x, y, ln1s, ln1b, wqkv, wout, bout, ln2s,
                                                   ln2b, w1, b1, w2, b2, scratch, B, S, D, H, dh,
                                                   F, level, dc, st);
  else if (io_bf16)
    err = launch_fma<__nv_bfloat16, float>(x, y, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b,
                                           w1, b1, w2, b2, scratch, B, S, D, H, dh, F, level, dc,
                                           st);
  else if (compute_bf16)
    err = launch_fma<float, __nv_bfloat16>(x, y, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b,
                                           w1, b1, w2, b2, scratch, B, S, D, H, dh, F, level, dc,
                                           st);
  else
    err = launch_fma<float, float>(x, y, ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b,
                                   w1, b1, w2, b2, scratch, B, S, D, H, dh, F, level, dc, st);
  return static_cast<int>(err);
}
