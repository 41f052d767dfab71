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
// Two forms, chosen at launch from what the call gives:
//  - tensor cores (bf16 compute, P <= 16, D a multiple of 16 up to 128, any
//    N; decode_tc_widths). The first form (below) ran at 14 % of the bound:
//    per batch row it staged the [N, D] slab as fp32 behind two block
//    barriers, and one thread per (q, n) ran a D-long scalar FMA dot over
//    shared memory, so it was bound by latency and shared-memory loads while
//    the tensor cores did nothing. This form: one warp owns 16 tokens of
//    one (b, g); a block of four warps covers one g and up to 64 tokens and
//    walks a chunk of b (embed_tiles.cuh Walk). The kernel slice [D, 16]
//    (q >= P zero) goes to shared memory once per block and stays in
//    registers as ldmatrix B fragments (24 at D 96). Each warp copies its
//    [16, D] bf16 slab into its own shared rows by cp.async in 16-byte
//    pieces (fp32 encoded: 16-byte loads rounded to bf16), the next b's into
//    the second buffer while this one's is used: no block barrier, only
//    cp.async.wait_group and __syncwarp. The decode is D / 16 k-steps of
//    mma.sync.m16n8k16 on two n8 tiles (q 0-7, 8-15) from ldmatrix A
//    fragments; the epilogue runs on the fragments: + bias (fp32), -
//    patches, |.| * w, the columns q >= P and the rows past N selected out.
//    Each lane keeps a running fp32 sum; warps (shuffles, then in warp
//    order) and blocks (sum_partials, in block order) are summed in a fixed
//    order: the loss is bit-identical from call to call (no float atomics).
//    Every token is computed, weight 0 too, so a NaN in encoded reaches the
//    loss. ops/fused_simmim.py sizes the grid (fused_embed.chunk_plan);
//  - FMA loops (fp32 compute, or widths the tensor-core form does not
//    take), the first form: each block owns one spectral block g and a
//    contiguous range of batch rows; per row it stages the [N, D] slab of
//    block g (contiguous in memory, so the loads coalesce) in shared memory,
//    rounded to C, with an odd row stride so that threads walking n read
//    distinct banks; one thread per (q, n) output computes the D-long dot
//    against the staged decoder slice and adds its weighted |diff| to a
//    running sum. Each block writes one fp32 partial, and sum_partials sums
//    the partials in a fixed order.

#include <cstdint>

#include "common.cuh"
#include "decode_tiles.cuh"
#include "warp_mma.cuh"

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

// ---------------------------------------------------------------------------
// Tensor-core form (bf16 compute)

using bf16 = __nv_bfloat16;

// KS: 16-column k-steps of D (EXACT: D == 16 KS; else their maximum, D read
// at run time).
template <typename E, int KS, bool EXACT>
__global__ void __launch_bounds__(kTcThreads, kDecodeBlocksPerSm)
fused_simmim_fwd_tc_kernel(const E* __restrict__ enc, const float* __restrict__ patches,
                           const bf16* __restrict__ kern, const float* __restrict__ bias,
                           const float* __restrict__ w, float* __restrict__ ws, int B, int G,
                           int N, int D, int P, int per, int chunks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float red[kWarps];
  const DecodePlan plan(D);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + plan.kern);
  const int kn = EXACT ? KS : D / 16;
  const Walk wk(B, G, N, per, chunks);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, c = lane % 4;
  bf16* slabs = reinterpret_cast<bf16*>(smem_raw + plan.slab) + warp * 2 * 16 * plan.ld;
  const int vrows = min(16, N - wk.row0 - wk.tile * 16);  // the tile's rows that exist

  stage_kern(ks, plan.ld_k, kern, wk.g, D, P);
  if (wk.active) zero_tail(slabs, plan.ld, vrows, lane);
  __syncthreads();

  float sum = 0.f;
  if (wk.active) {
    // the kernel slice as the decode's B fragments, kept for every b
    uint32_t bw[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      if (kk < kn) ldsm_kn(bw[kk], ks, plan.ld_k, 16 * kk, 0, lane);
    float bq[4];
    lane_p(bq, bias + wk.g * P, P, c);
    const int na = wk.row0 + wk.tile * 16 + lane / 4;  // the lane's tokens: na, na + 8
    const size_t tile0 = static_cast<size_t>(wk.row0 + wk.tile * 16) * D;  // in a (b, g)

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
      const bf16* cur = slabs + (it & 1) * 16 * plan.ld;
      const bool more = b + wk.wpt < wk.b_hi;
      const size_t next = bg + static_cast<size_t>(wk.wpt) * G;
      if (more)  // the next b's slab, under this one's work
        stage_slab(slabs + ((it + 1) & 1) * 16 * plan.ld, plan.ld,
                   enc + next * N * D + tile0, vrows, D, lane);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();  // this b's slab

      float acc[2][4];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if (kk >= kn) continue;
        uint32_t a[4];
        ldsm_a(a, cur, plan.ld, 16 * kk, lane);
        mma16816(acc[0], a, bw[kk][0], bw[kk][1]);
        mma16816(acc[1], a, bw[kk][2], bw[kk][3]);
      }
      // acc[j][e]: token na + 8 (e >> 1), q index k = 2 j + (e & 1)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 2 * j + (e & 1), h = e >> 1;
          const int q = 2 * c + (k & 1) + 8 * (k >> 1);
          if (q < P && na + 8 * h < N)
            sum += wv[h] * fabsf(__fsub_rn(__fadd_rn(acc[j][e], bq[k]), px[2 * k + h]));
        }
      if (more)  // the next b's targets, under the next slab's wait
        load_targets(px, wv, patches + next * P * N, w + next * N, P, N, na, c);
      __syncwarp();  // every lane has read this slab before it is refilled
    }
  }

  // block sum in a fixed order: lanes by shuffle, then the warps in order
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += red[i];
    ws[blockIdx.x] = s;
  }
}

template <typename E, int KS, bool EXACT>
cudaError_t launch_tc_as(const void* enc, const void* patches, const void* kern, const void* bias,
                         const void* w, void* ws, void* out, int B, int G, int N, int D, int P,
                         int chunks, int per, cudaStream_t stream) {
  const DecodePlan plan(D);
  auto kernel = fused_simmim_fwd_tc_kernel<E, KS, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return err;
  const int groups = ((N + 15) / 16 + kWarps - 1) / kWarps;
  const int blocks = G * groups * chunks;
  kernel<<<blocks, kTcThreads, plan.bytes, stream>>>(
      static_cast<const E*>(enc), static_cast<const float*>(patches),
      static_cast<const bf16*>(kern), static_cast<const float*>(bias),
      static_cast<const float*>(w), static_cast<float*>(ws), B, G, N, D, P, per, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials<<<1, kThreads, 0, stream>>>(static_cast<const float*>(ws),
                                           static_cast<float*>(out), blocks);
  return cudaGetLastError();
}

// the model's width (D 96) takes the instantiation with D fixed; the rest of
// decode_tc_widths the one with D's maximum
template <typename E>
cudaError_t launch_tc(const void* enc, const void* patches, const void* kern, const void* bias,
                      const void* w, void* ws, void* out, int B, int G, int N, int D, int P,
                      int chunks, int per, cudaStream_t stream) {
  if (D == 96)
    return launch_tc_as<E, 6, true>(enc, patches, kern, bias, w, ws, out, B, G, N, D, P, chunks,
                                    per, stream);
  return launch_tc_as<E, 8, false>(enc, patches, kern, bias, w, ws, out, B, G, N, D, P, chunks,
                                   per, stream);
}

}  // namespace

// enc [B, G, N, D] in bf16 when enc_bf16, else fp32; patches [B, G, P, N],
// bias [G, P] and w [B, G * N] in fp32; kern [G, D, P] in the compute type
// (bf16 when compute_bf16, else fp32); out: the fp32 scalar. bf16 compute at
// the widths decode_tc_widths takes launches the tensor-core form over
// G x groups x chunks blocks (groups: 64-token groups of N), block
// (g, group, chunk) walking the b's [chunk * per, min(B, chunk * per + per));
// enc 16-byte aligned, else cudaErrorMisalignedAddress. The rest launches
// the FMA form over G x chunks blocks, block i owning g = i / chunks and the
// batch rows [(i % chunks) * per, min(B, (i % chunks + 1) * per)). ws: fp32
// workspace of one partial a block. Launches the block kernel and
// sum_partials on `stream`; returns cudaGetLastError().
extern "C" int fused_simmim_fwd(const void* enc, const void* patches, const void* kern,
                                const void* bias, const void* w, void* ws, void* out, int B,
                                int G, int N, int D, int P, int chunks, int per, int enc_bf16,
                                int compute_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (compute_bf16 && decode_tc_widths(P, D)) {
    if (!aligned16(enc)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (enc_bf16)
      err = launch_tc<bf16>(enc, patches, kern, bias, w, ws, out, B, G, N, D, P, chunks, per, st);
    else
      err = launch_tc<float>(enc, patches, kern, bias, w, ws, out, B, G, N, D, P, chunks, per, st);
  } else if (enc_bf16 && compute_bf16)
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
