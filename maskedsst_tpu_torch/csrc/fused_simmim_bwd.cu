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
// Two forms, chosen at launch from what the call gives:
//  - tensor cores (bf16 compute, P <= 16, D a multiple of 16 up to 128, any
//    N; decode_tc_widths). The first form (below) ran at 8 % of the bound:
//    three block barriers per batch row, dpred recomputed by scalar FMA dots
//    over shared memory, d enc one thread per (n, d) re-rounding dpred on
//    every read, d kern and d bias one thread per (d, q) walking all n (970
//    entries over 256 threads). This form: the forward's tiling (one warp
//    per 16 tokens of one (b, g), four-warp blocks over one g walking a
//    chunk of b, each warp's [16, D] bf16 slab staged by cp.async, the next
//    b's under this one's work) and its decode on mma.sync.m16n8k16, then
//    on the fragments dpred = sign(diff) * w * gout in fp32 (sign(0) = 0,
//    NaN kept; the columns q >= P and the rows past N zero). d bias sums
//    the unrounded dpred in each lane's running sums (its four q's over its
//    two rows), reduced over the lanes of a column at the end. dpred is
//    rounded to bf16 once: its two n8 C fragments are the m16k16 A fragment
//    of d enc [16, D] = dpred [16, 16 q] kern^T [16 q, D], whose B fragments
//    come from the shared kernel slice by ldmatrix; and, each 8 x 8 block
//    transposed in registers by movmatrix.trans, the B fragments of d kern
//    [D, 16 q] += enc^T [D, 16 tokens] dpred [16 tokens, 16 q], whose A
//    fragments come from the staged slab by ldmatrix.trans. d kern is kept
//    in registers over the warp's b's (48 a lane at D 96, every index a
//    compile-time constant). d enc is rounded to encoded's type once; in
//    bf16 it goes through the slab just used (after d kern's last read of
//    it) and out in 16-byte pieces, the tile's rows being contiguous in
//    device memory; in fp32 straight from the fragments. Every token is
//    computed, weight 0 too: a NaN in encoded reaches d kern, and d enc of
//    a zero-weight token is still written (0). At the end the warps' sums
//    go to the block's partial in warp order (through the slabs), in the
//    FMA form's layout, and reduce_partials sums the partials of each g in
//    block order: deterministic, no float atomics. ops/fused_simmim.py
//    sizes the grid (fused_embed.chunk_plan);
//  - FMA loops (fp32 compute, or widths the tensor-core form does not
//    take), the first form: the forward's grid (block g, a contiguous
//    range of batch rows per block). Per row the block stages the [N, D]
//    slab in shared memory, recomputes dpred [P, N] there, writes d enc with
//    one thread per (n, d) (coalesced along d), and adds its d kern and d
//    bias contributions into per-thread running sums that live in shared
//    memory, each entry owned by one thread. At the end every block writes
//    its fp32 partials to a workspace, and reduce_partials sums them over
//    the batch ranges of each g in a fixed order.

#include <cstdint>

#include "common.cuh"
#include "decode_tiles.cuh"
#include "warp_mma.cuh"

using namespace msst;

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline size_t smem_floats(int N, int D, int P) {
  return static_cast<size_t>(N) * (D + 1) + static_cast<size_t>(D) * P + P +
         static_cast<size_t>(P) * (N + 1) + static_cast<size_t>(D) * P + P;
}

__device__ __forceinline__ float sign_of(float v) {  // jnp.sign: NaN stays NaN
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

// ---------------------------------------------------------------------------
// Tensor-core form (bf16 compute)

using bf16 = __nv_bfloat16;

// d enc of the tile's rows as E from the fragments o[j] (columns d0 + 8 j +
// 2c, + 1; rows r, r + 8): fp32 straight to device memory; bf16 into the
// warp's slab (copied out by the caller).
__device__ __forceinline__ void put_denc(float* __restrict__ dst, bf16*, int,
                                         const float (&o)[2][4], int d0, int r, int c, int vrows,
                                         int D) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < vrows)
        *reinterpret_cast<float2*>(dst + (r + 8 * h) * D + d0 + 8 * j + 2 * c) =
            make_float2(o[j][2 * h], o[j][2 * h + 1]);
}

__device__ __forceinline__ void put_denc(bf16*, bf16* slab, int ld, const float (&o)[2][4],
                                         int d0, int r, int c, int vrows, int) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < vrows)
        *reinterpret_cast<uint32_t*>(slab + (r + 8 * h) * ld + d0 + 8 * j + 2 * c) =
            pack_bf16(o[j][2 * h], o[j][2 * h + 1]);
}

// KS: 16-column k-steps of D (EXACT: D == 16 KS; else their maximum, D read
// at run time).
template <typename E, int KS, bool EXACT>
__global__ void __launch_bounds__(kTcThreads, kDecodeBlocksPerSm)
fused_simmim_bwd_tc_kernel(const float* __restrict__ gout, const E* __restrict__ enc,
                           const float* __restrict__ patches, const bf16* __restrict__ kern,
                           const float* __restrict__ bias, const float* __restrict__ w,
                           E* __restrict__ denc, float* __restrict__ ws, int B, int G, int N,
                           int D, int P, int per, int chunks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const DecodePlan plan(D);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + plan.kern);
  const int kn = EXACT ? KS : D / 16;
  const Walk wk(B, G, N, per, chunks);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, c = lane % 4, r = lane / 4;
  bf16* slabs = reinterpret_cast<bf16*>(smem_raw + plan.slab) + warp * 2 * 16 * plan.ld;
  const int vrows = min(16, N - wk.row0 - wk.tile * 16);  // the tile's rows that exist
  const float gs = *gout;

  stage_kern(ks, plan.ld_k, kern, wk.g, D, P);
  if (wk.active) zero_tail(slabs, plan.ld, vrows, lane);
  __syncthreads();

  // running sums over the warp's b's: d kern [D, 16 q] as C fragments
  // (m-tile mi, q-tile j) and d bias at the lane's q's over its two rows
  float dk[KS][2][4];
#pragma unroll
  for (int mi = 0; mi < KS; ++mi) zero(dk[mi]);
  float db[4] = {0.f, 0.f, 0.f, 0.f};
  if (wk.active) {
    float bq[4];
    lane_p(bq, bias + wk.g * P, P, c);
    const int na = wk.row0 + wk.tile * 16 + r;  // the lane's tokens: na, na + 8
    const size_t tile0 = static_cast<size_t>(wk.row0 + wk.tile * 16) * D;  // in a (b, g)
    const int cpr = D / 8;  // 16-byte pieces of a bf16 token row

    int b = wk.b_lo + wk.boff;
    float px[8], wv[2];  // the pixels and weights of the lane's tokens
    if (b < wk.b_hi) {
      const size_t bg = static_cast<size_t>(b) * G + wk.g;
      stage_slab(slabs, plan.ld, enc + bg * N * D + tile0, vrows, D, lane);
      load_targets(px, wv, patches + bg * P * N, w + bg * N, P, N, na, c);
    }
    cp_async_commit();
    for (int it = 0; b < wk.b_hi; b += wk.wpt, ++it) {
      const size_t bg = static_cast<size_t>(b) * G + wk.g;
      bf16* cur = slabs + (it & 1) * 16 * plan.ld;
      const bool more = b + wk.wpt < wk.b_hi;
      const size_t next = bg + static_cast<size_t>(wk.wpt) * G;
      if (more)  // the next b's slab, under this one's work
        stage_slab(slabs + ((it + 1) & 1) * 16 * plan.ld, plan.ld,
                   enc + next * N * D + tile0, vrows, D, lane);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();  // this b's slab

      // the decode, then dpred on its fragments: acc[j][e] is token
      // na + 8 (e >> 1), q index k = 2 j + (e & 1)
      float acc[2][4];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk >= kn) continue;
        uint32_t a[4], bw[4];
        ldsm_a(a, cur, plan.ld, 16 * kk, lane);
        ldsm_kn(bw, ks, plan.ld_k, 16 * kk, 0, lane);
        mma16816(acc[0], a, bw[0], bw[1]);
        mma16816(acc[1], a, bw[2], bw[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 2 * j + (e & 1), h = e >> 1;
          const int q = 2 * c + (k & 1) + 8 * (k >> 1);
          const float diff = __fsub_rn(__fadd_rn(acc[j][e], bq[k]), px[2 * k + h]);
          acc[j][e] = q < P && na + 8 * h < N ? __fmul_rn(__fmul_rn(sign_of(diff), wv[h]), gs)
                                              : 0.f;
          db[k] += acc[j][e];
        }
      if (more)  // the next b's targets, under this one's products
        load_targets(px, wv, patches + next * P * N, w + next * N, P, N, na, c);

      // dpred rounded to bf16 once: the A fragment of d enc, and its blocks
      // transposed, the B fragments of d kern's two q tiles
      uint32_t da[1][4];
      to_afrag<1>(da, acc);
      const uint32_t bt[4] = {movtrans(da[0][0]), movtrans(da[0][1]), movtrans(da[0][2]),
                              movtrans(da[0][3])};
#pragma unroll
      for (int mi = 0; mi < KS; ++mi) {
        if (mi >= kn) continue;
        uint32_t ea[4];
        ldsm_at(ea, cur, plan.ld, 16 * mi, lane);
        mma16816(dk[mi][0], ea, bt[0], bt[1]);
        mma16816(dk[mi][1], ea, bt[2], bt[3]);
      }
      __syncwarp();  // d kern's reads of the slab are done: it takes d enc now

      E* de = denc + bg * N * D + tile0;
#pragma unroll
      for (int jj = 0; jj < KS; ++jj) {
        if (jj >= kn) continue;
        uint32_t bk[4];
        ldsm_nk(bk, ks, plan.ld_k, 0, 16 * jj, lane);
        float o[2][4];
        zero(o);
        mma16816(o[0], da[0], bk[0], bk[1]);
        mma16816(o[1], da[0], bk[2], bk[3]);
        put_denc(de, cur, plan.ld, o, 16 * jj, r, c, vrows, D);
      }
      if constexpr (sizeof(E) == 2) {
        __syncwarp();
        for (int k = lane; k < vrows * cpr; k += 32) {
          const int row = k / cpr, piece = k - row * cpr;
          *reinterpret_cast<uint4*>(de + 8 * k) =
              *reinterpret_cast<const uint4*>(cur + row * plan.ld + 8 * piece);
        }
      }
      __syncwarp();  // every lane is done with this slab before it is refilled
    }
  }

  // the block's partial (d kern [D, P] then d bias [P], the FMA form's
  // layout): each warp's sums through its slabs, [D, 16] then [16], then
  // summed over the warps in order
  __syncthreads();
  float* sw = reinterpret_cast<float*>(slabs);
  if (wk.active) {
#pragma unroll
    for (int mi = 0; mi < KS; ++mi) {
      if (mi >= kn) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sw[(16 * mi + r + 8 * (e >> 1)) * 16 + 8 * j + 2 * c + (e & 1)] = dk[mi][j][e];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v = db[k];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (r == 0) sw[16 * D + 2 * c + (k & 1) + 8 * (k >> 1)] = v;
    }
  }
  __syncthreads();
  const int nw = wk.nt * wk.wpt;  // the active warps, 0 .. nw - 1
  const size_t stride = 2 * 16 * static_cast<size_t>(plan.ld) / 2;  // floats between warps' sums
  const float* sw0 = reinterpret_cast<const float*>(smem_raw + plan.slab);
  float* part = ws + static_cast<size_t>(blockIdx.x) * (D * P + P);
  for (int i = tid; i < D * P + P; i += kTcThreads) {
    const int at = i < D * P ? (i / P) * 16 + i % P : 16 * D + (i - D * P);
    float s = 0.f;
    for (int v = 0; v < nw; ++v) s += sw0[v * stride + at];
    part[i] = s;
  }
}

template <typename E, int KS, bool EXACT>
cudaError_t launch_tc_as(const void* gout, const void* enc, const void* patches, const void* kern,
                         const void* bias, const void* w, void* denc, void* ws, void* grads,
                         int B, int G, int N, int D, int P, int chunks, int per,
                         cudaStream_t stream) {
  const DecodePlan plan(D);
  auto kernel = fused_simmim_bwd_tc_kernel<E, KS, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return err;
  const int groups = ((N + 15) / 16 + kWarps - 1) / kWarps;
  kernel<<<G * groups * chunks, kTcThreads, plan.bytes, stream>>>(
      static_cast<const float*>(gout), static_cast<const E*>(enc),
      static_cast<const float*>(patches), static_cast<const bf16*>(kern),
      static_cast<const float*>(bias), static_cast<const float*>(w), static_cast<E*>(denc),
      static_cast<float*>(ws), B, G, N, D, P, per, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the blocks of one g are contiguous: (g groups + group) chunks + chunk
  const size_t total = static_cast<size_t>(G) * D * P + static_cast<size_t>(G) * P;
  const int threads = 256;
  reduce_partials<<<static_cast<int>((total + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(grads), G, D, P, groups * chunks);
  return cudaGetLastError();
}

// the model's width (D 96) takes the instantiation with D fixed; the rest of
// decode_tc_widths the one with D's maximum
template <typename E>
cudaError_t launch_tc(const void* gout, const void* enc, const void* patches, const void* kern,
                      const void* bias, const void* w, void* denc, void* ws, void* grads, int B,
                      int G, int N, int D, int P, int chunks, int per, cudaStream_t stream) {
  if (D == 96)
    return launch_tc_as<E, 6, true>(gout, enc, patches, kern, bias, w, denc, ws, grads, B, G, N,
                                    D, P, chunks, per, stream);
  return launch_tc_as<E, 8, false>(gout, enc, patches, kern, bias, w, denc, ws, grads, B, G, N,
                                   D, P, chunks, per, stream);
}

}  // namespace

// gout: the fp32 scalar cotangent; enc and denc [B, G, N, D] in bf16 when
// enc_bf16, else fp32; patches [B, G, P, N], bias [G, P] and w [B, G * N]
// in fp32; kern [G, D, P] in the compute type (bf16 when compute_bf16, else
// fp32). grads: d kern [G, D, P] then d bias [G, P], fp32. bf16 compute at
// the widths decode_tc_widths takes launches the tensor-core form over
// G x groups x chunks blocks (groups: 64-token groups of N), block
// (g, group, chunk) walking the b's [chunk * per, min(B, chunk * per + per));
// enc and denc 16-byte aligned, else cudaErrorMisalignedAddress. The rest
// launches the FMA form over G x chunks blocks, block i owning
// g = i / chunks and the batch rows [(i % chunks) * per,
// min(B, ... + per)). ws: fp32 workspace of one partial of D * P + P floats
// a block. Launches the block kernel and reduce_partials on `stream`;
// returns cudaGetLastError().
extern "C" int fused_simmim_bwd(const void* gout, const void* enc, const void* patches,
                                const void* kern, const void* bias, const void* w, void* denc,
                                void* ws, void* grads, int B, int G, int N, int D, int P,
                                int chunks, int per, int enc_bf16, int compute_bf16,
                                void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (compute_bf16 && decode_tc_widths(P, D)) {
    if (!aligned16(enc) || !aligned16(denc))
      return static_cast<int>(cudaErrorMisalignedAddress);
    if (enc_bf16)
      err = launch_tc<bf16>(gout, enc, patches, kern, bias, w, denc, ws, grads, B, G, N, D, P,
                            chunks, per, st);
    else
      err = launch_tc<float>(gout, enc, patches, kern, bias, w, denc, ws, grads, B, G, N, D, P,
                             chunks, per, st);
  } else if (enc_bf16 && compute_bf16)
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
