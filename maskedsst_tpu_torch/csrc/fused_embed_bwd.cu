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
//   d pos [G, N, D]          = sum_b dkept + sum_b dtok * m  (kept branch + masked table;
//                              the tensor-core form sums dkept + dtok * m per element)
//   d mask_token [D]         = sum_{b, g, n} dtok * m
// into one flat vector in that order. dt is the post-LN input's gradient.
// Numeric contract: fp32 LN statistics (eps 1e-5); xln, the embed kernel
// and dt rounded to the compute type C before each product (fp32
// accumulation), as _bwd_kernel's _bdot casts them.
//
// What bounds it on the H100: bytes. Each (b, g) reads 2.5 KB of pixels and
// 12 KB of bf16 (24 KB fp32) token gradients for ~6 x P x N x D flop, ~2
// flop per byte; at EnMAP batch 64 the bound is 0.006 ms.
//
// Two forms, chosen at launch from what the call gives:
//  - tensor cores (bf16 compute, P <= 16, D a multiple of 8 and at most
//    128, any N; tc_widths). The first form (below) ran at 1.5 % of the
//    bound: ~113 KB of shared memory for the running sums, so one
//    256-thread block per SM; six barriers per b; three scalar products
//    with two shared loads per FMA; and ~40 % of its time in neither part
//    (PERF.md §6). This form: one warp owns 16 tokens (n rows) of one
//    g; a block of four warps covers one g, up to 64 tokens and a chunk of
//    b, the warps walking it in order. For each b the warp recomputes the
//    pre-LN (quad shuffles, xln straight into the A fragment, p padded to
//    16) and t with the same mma.sync product as the forward, the post-LN
//    statistics, dkept and dt on the accumulator fragments, and rounds dt
//    to bf16 once: dt's C fragments are the A fragments of dxln = dt kern^T
//    (M 16, K = D, N = P padded to 16), and, each 8 x 8 block transposed in
//    registers by movmatrix.trans, the B fragments of d kernel += xln^T dt
//    (M = P padded to 16, K = the warp's 16 tokens, N = D), whose A
//    fragments are xln's four blocks transposed the same way. movmatrix
//    keeps the transposes in registers: no shared tile, no barrier. The
//    warp keeps d preln scale / bias (at its lanes' p) in registers over
//    its b's, and d pos of its own rows and d kernel (each b's product
//    added) in its own shared rows; the small vectors (d postln scale /
//    bias, d bias, d mask_token) are reduced over each column's eight lanes
//    by a shuffle reduce-scatter, each lane keeping D / 32 of the column
//    sums per vector, every index a compile-time constant (a loop the
//    compiler does not unroll puts its arrays in local memory). The dtok
//    tile of the next b comes in by cp.async (16-byte pieces, the tile's
//    rows being contiguous) under this b's products, the next pixels by
//    plain loads. At the end the warps' sums go to the block's partial in
//    warp order, and reduce_tc_partials sums the partials in block order:
//    deterministic, no atomics. The fp32 sums that feed a bf16 rounding
//    (the post-LN statistics, dt's two row means) take the plain version's
//    order: pairwise sums, a mean as the sum times fl(1/D), separate
//    roundings where it rounds twice.
//    Register and shared-memory plan: the working t / z2 / dt tile 48
//    registers at D 96, the small sums 12 + 8, the kernel's B fragments
//    read by ldmatrix per product; three 128-thread blocks per SM
//    (__launch_bounds__: 168 registers, 248 bytes of spills at D 96).
//    BwdPlan: the kernel slice [16, 104] bf16, bias and postln scale, and
//    four warps' dtok tiles [16, 104] bf16, d pos rows and d kernel
//    [16, 104] fp32 each: 70,656 bytes at D 96. The partials: 7,508 floats
//    a block at P 10, D 96 (30 KB, d pos 24.6 KB of it).
//    ops/fused_embed.py::chunk_plan gives a block as few b's as keep the
//    grid within one wave of resident blocks (a second wave's tail cost
//    more than the partials saved): 320 blocks of 4 b's, 9.6 MB of
//    partials written and read at EnMAP batch 64 (G 20), 320 of 1 b at
//    Houston (G 5), against 15.7 / 3.9 MB of dtok read;
//  - FMA loops (fp32 compute, or widths the tensor-core form does not
//    take), the first form: one block of 256 threads per (g, chunk of b);
//    it keeps its running sums of every gradient of block g in shared
//    memory while it walks its b's in order, then writes its partial sums
//    to a workspace, and reduce_partials adds them in a fixed order.
#include <cstdint>

#include "common.cuh"
#include "embed_tiles.cuh"
#include "warp_mma.cuh"

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
cudaError_t launch_fma(const void* patches, const void* mask, const void* prs, const void* prb,
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

// ---------------------------------------------------------------------------
// Tensor-core form (bf16 compute)

using bf16 = __nv_bfloat16;

constexpr int kBlocksPerSm = 3;  // ops/fused_embed.py BWD_BLOCKS_PER_SM

// One block's partial sums in the tensor-core form, in floats: kern [P, D],
// bias [D], postln scale and bias [D], mask_token [D], preln scale and bias
// [P], pos [64, D] (the block's group of tokens; rows past N unwritten)
struct TcPart {
  size_t kern, bias, pls, plb, mtok, prs, prb, pos, total;

  __host__ __device__ TcPart(int P, int D) {
    size_t o = 0;
    kern = o; o += static_cast<size_t>(P) * D;
    bias = o; o += D;
    pls = o;  o += D;
    plb = o;  o += D;
    mtok = o; o += D;
    prs = o;  o += P;
    prb = o;  o += P;
    pos = o;  o += static_cast<size_t>(16) * kWarps * D;
    total = o;
  }
};

// Byte offsets of the form's shared memory: the kernel slice [16, dp + kPad]
// bf16 (rows p >= P and columns d >= D zero, dp = D rounded up to 16),
// bias[g] and the postln scale [2, D] fp32, and each warp's dtok tile
// [16, D + kPad] bf16, d pos rows [16, D + 8] fp32 and d kernel [16, D + 8]
// fp32. At the block's end each warp's dtok tile takes its small vectors'
// sums (4 D + 32 floats).
struct BwdPlan {
  int dp, ld_k, ld_t, ld_p;
  size_t kern, vec, dtok, pos, dker, bytes;

  __host__ __device__ explicit BwdPlan(int D) {
    dp = round_up(D, 16);
    ld_k = dp + kPad;
    ld_t = D + kPad;
    ld_p = D + 8;
    size_t off = 0;
    kern = off; off += align128(sizeof(bf16) * 16 * ld_k);
    vec = off;  off += align128(sizeof(float) * 2 * D);
    dtok = off; off += align128(sizeof(bf16) * kWarps * 16 * ld_t);
    pos = off;  off += align128(sizeof(float) * kWarps * 16 * ld_p);
    dker = off; off += align128(sizeof(float) * kWarps * 16 * ld_p);
    bytes = off;
  }
};

// One halving step of reduce_scatter: the lane keeps v[0, H) or v[H, 2H)
// (by its bit `dist`), adds its partner's half and stores the sums in
// v[0, H).
template <int H, int V>
__device__ __forceinline__ void rs_halve(float (&v)[V], int lane, int dist) {
  const bool up = lane & dist;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, dist);
  }
}

// The sums over the eight lanes of a column (the lanes of one lane % 4) of
// V values each, scattered: halving at shuffle distances 16, 8 and 4, the
// lane keeps V / 8 sums in v[0, V / 8), those of the values with indices
// rs_first(lane, V) + t. A fixed order: deterministic.
template <int V>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane) {
  rs_halve<V / 2>(v, lane, 16);
  rs_halve<V / 4>(v, lane, 8);
  rs_halve<V / 8>(v, lane, 4);
}

// The warp's [rows, D] bf16 tile (rows contiguous in device memory) into
// its shared tile (row stride ld), in 16-byte cp.async pieces: the copy
// lands under the work before its first read (cp_async_wait_all, then
// __syncwarp).
__device__ __forceinline__ void fetch_tile(bf16* dst, int ld, const bf16* __restrict__ src,
                                           int rows, int cpr, int lane) {
  for (int k = lane; k < rows * cpr; k += 32) {
    const int r = k / cpr, piece = k - r * cpr;
    cp_async16(dst + r * ld + 8 * piece, src + 8 * k);
  }
}

// the lane's pair of dtok values at columns 8 j (+ its 2c, + 1) of its row
// of the shared tile, 0 on a row past N
__device__ __forceinline__ float2 dtok_pair(const bf16* row, bool ok, int j) {
  return ok ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + 8 * j))
            : make_float2(0.f, 0.f);
}

// One small vector's sums over the lane's two rows at its columns (K 0:
// dkept, 1: dtok m, 2: dkept z2, z2 in acc), reduce-scattered over the
// column's lanes and added to the lane's running sums.
template <int K, int NT>
__device__ __forceinline__ void vec_sum(float (&sums)[NT / 4], const float (&acc)[NT][4],
                                        const bf16* const (&drow)[2], const bool (&ok)[2],
                                        const float (&m)[2], int nt, int lane) {
  float w[2 * NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    w[2 * j] = w[2 * j + 1] = 0.f;
    if (j >= nt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 gv = dtok_pair(drow[h], ok[h], j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float g1 = e ? gv.y : gv.x;
        const float dk = __fmul_rn(g1, 1.f - m[h]);
        const float v = K == 0 ? dk : K == 1 ? __fmul_rn(g1, m[h])
                                             : __fmul_rn(dk, acc[j][2 * h + e]);
        w[2 * j + e] = h ? __fadd_rn(w[2 * j + e], v) : v;
      }
    }
  }
  reduce_scatter<2 * NT>(w, lane);
#pragma unroll
  for (int t = 0; t < NT / 4; ++t) sums[t] += w[t];
}

__device__ __forceinline__ int rs_first(int lane, int V) {
  return (lane & 16 ? V / 2 : 0) + (lane & 8 ? V / 4 : 0) + (lane & 4 ? V / 8 : 0);
}

// NT: 8-column tiles of D (EXACT: D == 8 NT; else their maximum, D read at
// run time).
template <typename Tin, int NT, bool EXACT>
__global__ void __launch_bounds__(kTcThreads, kBlocksPerSm)
fused_embed_bwd_tc_kernel(const Tin* __restrict__ patches, const float* __restrict__ mask,
                          const float* __restrict__ prs, const float* __restrict__ prb,
                          const bf16* __restrict__ kern, const float* __restrict__ bias,
                          const float* __restrict__ pls, const bf16* __restrict__ dtok,
                          float* __restrict__ ws, int B, int G, int P, int N, int D, int per,
                          int chunks) {
  constexpr int V = 2 * NT, RS = V / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const BwdPlan plan(D);
  const TcPart pt(P, D);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + plan.kern);
  float* vs = reinterpret_cast<float*>(smem_raw + plan.vec);
  bf16* dtile0 = reinterpret_cast<bf16*>(smem_raw + plan.dtok);
  float* prow0 = reinterpret_cast<float*>(smem_raw + plan.pos);
  float* krow0 = reinterpret_cast<float*>(smem_raw + plan.dker);
  const int nt = EXACT ? NT : D / 8;
  const Walk wk(B, G, N, per, chunks);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, c = lane % 4, q = lane / 4;
  bf16* dts = dtile0 + warp * 16 * plan.ld_t;   // the warp's dtok tile
  float* pws = prow0 + warp * 16 * plan.ld_p;   // the warp's d pos rows
  float* kws = krow0 + warp * 16 * plan.ld_p;   // the warp's d kernel

  for (int i = tid; i < 16 * plan.dp; i += kTcThreads) {
    const int p = i / plan.dp, d = i % plan.dp;
    ks[p * plan.ld_k + d] =
        p < P && d < D ? kern[(static_cast<size_t>(wk.g) * P + p) * D + d] : __float2bfloat16(0.f);
  }
  for (int d = tid; d < D; d += kTcThreads) {
    vs[d] = bias[wk.g * D + d];
    vs[D + d] = pls[d];
  }
  for (int i = lane; i < 16 * D; i += 32) {
    pws[(i / D) * plan.ld_p + i % D] = 0.f;
    kws[(i / D) * plan.ld_p + i % D] = 0.f;
  }
  __syncthreads();

  const int ra = wk.tile * 16 + q;  // the lane's rows in the group: ra, ra + 8
  const int na = wk.row0 + ra;
  const bool ok[2] = {na < N, na + 8 < N};
  const int vrows = min(16, N - wk.row0 - wk.tile * 16);  // the tile's rows that exist
  const int cpr = D / 8;  // 16-byte pieces of a token row
  const float inv_d = 1.f / D;
  const size_t tile0 = static_cast<size_t>(wk.row0 + wk.tile * 16) * D;  // in a (b, g)
  const int ld_t = plan.ld_t;
  // the lane's two rows of the dtok tile, at its column pair
  const bf16* drow[2] = {dts + q * ld_t + 2 * c, dts + (q + 8) * ld_t + 2 * c};

  // sums kept in registers over the warp's b's: d preln scale and bias at
  // the lane's p, and the small vectors (d postln bias, d mask_token, d
  // postln scale, d bias) at the lane's scattered columns
  float gs[2][4] = {};
  float vacc[4][RS] = {};
  float sc[4], bi[4];
  lane_p(sc, prs, P, c);
  lane_p(bi, prb, P, c);

  float px[8];
  int b = wk.b_lo + wk.boff;
  if (wk.active && b < wk.b_hi) {
    load_pixels(px, patches + (static_cast<size_t>(b) * G + wk.g) * P * N, P, N, na, c);
    fetch_tile(dts, ld_t, dtok + (static_cast<size_t>(b) * G + wk.g) * N * D + tile0, vrows, cpr,
               lane);
  }
  for (; wk.active && b < wk.b_hi; b += wk.wpt) {
    const size_t bg = static_cast<size_t>(b) * G + wk.g;
    const bool more = b + wk.wpt < wk.b_hi;
    const float m[2] = {ok[0] ? mask[bg * N + na] : 0.f, ok[1] ? mask[bg * N + na + 8] : 0.f};
    uint32_t xa[4];
    float z1[8];
    pre_ln(xa, z1, px, sc, bi, P, c);
    if (more)  // the next b's pixels, under this one's work
      load_pixels(px, patches + (bg + static_cast<size_t>(wk.wpt) * G) * P * N, P, N, na, c);

    // the forward again: t = xln . kern + bias, then z2 in place, and rsig2
    float acc[NT][4];
    zero(acc);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      if (2 * jj >= nt) continue;
      uint32_t bw[4];
      ldsm_kn(bw, ks, plan.ld_k, 0, 16 * jj, lane);
      mma16816(acc[2 * jj], xa, bw[0], bw[1]);
      mma16816(acc[2 * jj + 1], xa, bw[2], bw[3]);
    }
    float rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t[V];
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
      rs[h] = rsqrtf(__fadd_rn(__fmul_rn(quad_sum(t), inv_d), kLnEps));
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[j][2 * h + e] = j < nt ? __fmul_rn(__fsub_rn(acc[j][2 * h + e], mu), rs[h]) : 0.f;
    }
    cp_async_wait_all();
    __syncwarp();  // this b's dtok tile

    // d pos of the warp's rows (kept branch + masked table: dkept + dtok m),
    // and the post-LN backward's row means of dz = dkept * pls and dz * z2
    float m1[2], m2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float keep = 1.f - m[h];
      float* prow = pws + (q + 8 * h) * plan.ld_p;
      float t[V];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        t[2 * j] = t[2 * j + 1] = 0.f;
        if (j >= nt) continue;
        const float2 gv = dtok_pair(drow[h], ok[h], j);
        float2* pp = reinterpret_cast<float2*>(prow + 8 * j + 2 * c);
        float2 pa = *pp;
        pa.x = __fadd_rn(pa.x, __fadd_rn(__fmul_rn(gv.x, keep), __fmul_rn(gv.x, m[h])));
        pa.y = __fadd_rn(pa.y, __fadd_rn(__fmul_rn(gv.y, keep), __fmul_rn(gv.y, m[h])));
        *pp = pa;
        t[2 * j] = __fmul_rn(__fmul_rn(gv.x, keep), vs[D + 8 * j + 2 * c]);
        t[2 * j + 1] = __fmul_rn(__fmul_rn(gv.y, keep), vs[D + 8 * j + 2 * c + 1]);
      }
      m1[h] = __fmul_rn(quad_sum(t), inv_d);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        t[2 * j] = t[2 * j + 1] = 0.f;
        if (j >= nt) continue;
        const float2 gv = dtok_pair(drow[h], ok[h], j);
        t[2 * j] = __fmul_rn(__fmul_rn(__fmul_rn(gv.x, keep), vs[D + 8 * j + 2 * c]),
                             acc[j][2 * h]);
        t[2 * j + 1] = __fmul_rn(__fmul_rn(__fmul_rn(gv.y, keep), vs[D + 8 * j + 2 * c + 1]),
                                 acc[j][2 * h + 1]);
      }
      m2[h] = __fmul_rn(quad_sum(t), inv_d);
    }
    // d postln bias (sum dkept), d mask_token (sum dtok m), d postln scale
    // (sum dkept z2) over the two rows, scattered over the column's lanes
    vec_sum<0>(vacc[0], acc, drow, ok, m, nt, lane);
    vec_sum<1>(vacc[1], acc, drow, ok, m, nt, lane);
    vec_sum<2>(vacc[2], acc, drow, ok, m, nt, lane);
    // dt = rsig2 (dz - mean(dz) - z2 mean(dz z2)) in fp32, in place of z2
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt) continue;
        const float2 gv = dtok_pair(drow[h], ok[h], j);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dz = __fmul_rn(__fmul_rn(e ? gv.y : gv.x, 1.f - m[h]),
                                     vs[D + 8 * j + 2 * c + e]);
          acc[j][2 * h + e] = __fmul_rn(
              rs[h], __fsub_rn(__fsub_rn(dz, m1[h]), __fmul_rn(acc[j][2 * h + e], m2[h])));
        }
      }
    __syncwarp();  // every lane is done with this b's dtok tile
    if (more)
      fetch_tile(dts, ld_t, dtok + (bg + static_cast<size_t>(wk.wpt) * G) * N * D + tile0, vrows,
                 cpr, lane);
    {  // d bias: sum dt (fp32) over the two rows, scattered
      float w[V];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) w[2 * j + e] = __fadd_rn(acc[j][e], acc[j][2 + e]);
      reduce_scatter<V>(w, lane);
#pragma unroll
      for (int t = 0; t < RS; ++t) vacc[3][t] += w[t];
    }
    // dt rounded to bf16 once: the A fragments of dxln = dt kern^T, and,
    // transposed by movmatrix, the B fragments of d kernel += xln^T dt
    uint32_t da[NT / 2][4];
    to_afrag<NT / 2>(da, acc);
    float dx[2][4];
    zero(dx);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (2 * kk >= nt) continue;
      uint32_t bk[4];
      ldsm_nk(bk, ks, plan.ld_k, 16 * kk, 0, lane);
      mma16816(dx[0], da[kk], bk[0], bk[1]);
      mma16816(dx[1], da[kk], bk[2], bk[3]);
    }
    // d preln scale / bias: sum dxln z1, sum dxln at the lane's p (tile
    // u holds p 8u + 2c + (e & 1) of row e >> 1)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 2 * u + (e & 1);
        gs[0][k] = __fadd_rn(gs[0][k], __fmul_rn(dx[u][e], z1[2 * k + (e >> 1)]));
        gs[1][k] = __fadd_rn(gs[1][k], dx[u][e]);
      }
    // xln^T as A fragments: the transposes of the four 8 x 8 blocks of xln,
    // the off-diagonal two swapped; this b's d kernel [16 p, D] is added to
    // the warp's sum in shared memory (rows p < P)
    const uint32_t xt[4] = {movtrans(xa[0]), movtrans(xa[2]), movtrans(xa[1]), movtrans(xa[3])};
    float dkn[NT][4];
    zero(dkn);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (2 * kk >= nt) continue;
      mma16816(dkn[2 * kk], xt, movtrans(da[kk][0]), movtrans(da[kk][1]));
      mma16816(dkn[2 * kk + 1], xt, movtrans(da[kk][2]), movtrans(da[kk][3]));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (q + 8 * h >= P) continue;
      float* krow = kws + (q + 8 * h) * plan.ld_p + 2 * c;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt) continue;
        float2* kp = reinterpret_cast<float2*>(krow + 8 * j);
        float2 v = *kp;
        v.x += dkn[j][2 * h];
        v.y += dkn[j][2 * h + 1];
        *kp = v;
      }
    }
  }

  // the block's partials: d pos of each tile from its warps in order; then
  // each warp's d kernel and small sums, summed over the warps in order
  __syncthreads();
  float* part = ws + static_cast<size_t>(blockIdx.x) * pt.total;
  for (int i = tid; i < wk.rows * D; i += kTcThreads) {
    const int r = i / D, d = i - r * D;
    float s = 0.f;
    for (int k = 0; k < wk.wpt; ++k)
      s += prow0[((r / 16 + k * wk.nt) * 16 + r % 16) * plan.ld_p + d];
    part[pt.pos + i] = s;
  }
  float* vw = reinterpret_cast<float*>(dts);  // [4, D] small vectors, then preln [2, 16]
  if (wk.active) {
    const int first = rs_first(lane, V);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int t = 0; t < RS; ++t) {
        const int i = first + t, j = i / 2;
        if (j < nt) vw[k * D + 8 * j + 2 * c + i % 2] = vacc[k][t];
      }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v = gs[s][k];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        const int p = 2 * c + (k & 1) + 8 * (k >> 1);
        if (q == 0 && p < P) vw[4 * D + 16 * s + p] = v;
      }
  }
  __syncthreads();
  const int nw = wk.nt * wk.wpt;  // the active warps, 0 .. nw - 1
  for (int i = tid; i < P * D + 4 * D + 2 * P; i += kTcThreads) {
    float s = 0.f;
    if (i < P * D) {
      const int p = i / D, d = i - p * D;
      for (int w = 0; w < nw; ++w) s += krow0[(w * 16 + p) * plan.ld_p + d];
      part[pt.kern + i] = s;
    } else if (i < P * D + 4 * D) {
      const int k = (i - P * D) / D, d = (i - P * D) % D;
      for (int w = 0; w < nw; ++w)
        s += reinterpret_cast<const float*>(dtile0 + w * 16 * plan.ld_t)[k * D + d];
      part[(k == 0 ? pt.plb : k == 1 ? pt.mtok : k == 2 ? pt.pls : pt.bias) + d] = s;
    } else {
      const int s2 = (i - P * D - 4 * D) / P, p = (i - P * D - 4 * D) % P;
      for (int w = 0; w < nw; ++w)
        s += reinterpret_cast<const float*>(dtile0 + w * 16 * plan.ld_t)[4 * D + 16 * s2 + p];
      part[(s2 ? pt.prb : pt.prs) + p] = s;
    }
  }
}

// The final gradients (layout Out) from the tensor-core form's partials,
// block (g, group, chunk) at (g groups + group) chunks + chunk, each entry
// summed over its blocks in that order. The first `head` blocks take one
// entry of d kernel, d bias or d pos a thread; the rest one entry of the
// five small vectors a warp (lanes over the blocks, then a fixed shuffle
// tree).
__global__ void reduce_tc_partials(const float* __restrict__ ws, float* __restrict__ out, int G,
                                   int P, int N, int D, int groups, int chunks, int head) {
  const TcPart pt(P, D);
  const Out ot(G, P, N, D);
  const size_t pd = static_cast<size_t>(P) * D;
  if (static_cast<int>(blockIdx.x) < head) {
    const size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
    size_t first, off, at;
    int count = groups * chunks;
    if (i < G * pd) {
      first = i / pd * count;
      off = pt.kern + i % pd;
      at = ot.kern + i;
    } else if (i < G * pd + static_cast<size_t>(G) * D) {
      const size_t k = i - G * pd;
      first = k / D * count;
      off = pt.bias + k % D;
      at = ot.bias + k;
    } else if (i < G * pd + static_cast<size_t>(G) * D + static_cast<size_t>(G) * N * D) {
      const size_t k = i - G * pd - static_cast<size_t>(G) * D;
      const size_t g = k / (static_cast<size_t>(N) * D), r = k % (static_cast<size_t>(N) * D);
      const int n = static_cast<int>(r / D), group = n / (16 * kWarps);
      first = (g * groups + group) * chunks;
      count = chunks;
      off = pt.pos + static_cast<size_t>(n - 16 * kWarps * group) * D + r % D;
      at = ot.pos + k;
    } else {
      return;
    }
    float s = 0.f;
    for (int k = 0; k < count; ++k) s += ws[(first + k) * pt.total + off];
    out[at] = s;
    return;
  }
  const int w = (blockIdx.x - head) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= 2 * P + 3 * D) return;
  size_t off, at;
  if (w < P) {
    off = pt.prs + w;
    at = ot.prs + w;
  } else if (w < 2 * P) {
    off = pt.prb + (w - P);
    at = ot.prb + (w - P);
  } else if (w < 2 * P + D) {
    off = pt.pls + (w - 2 * P);
    at = ot.pls + (w - 2 * P);
  } else if (w < 2 * P + 2 * D) {
    off = pt.plb + (w - 2 * P - D);
    at = ot.plb + (w - 2 * P - D);
  } else {
    off = pt.mtok + (w - 2 * P - 2 * D);
    at = ot.mtok + (w - 2 * P - 2 * D);
  }
  const size_t blocks = static_cast<size_t>(G) * groups * chunks;
  float s = 0.f;
  for (size_t k = lane; k < blocks; k += 32) s += ws[k * pt.total + off];
  s = warp_sum(s);
  if (lane == 0) out[at] = s;
}

template <typename Tin, int NT, bool EXACT>
cudaError_t launch_tc_as(const void* patches, const void* mask, const void* prs,
                         const void* prb, const void* kern, const void* bias, const void* pls,
                         const void* dtok, void* ws, void* grads, int B, int G, int P, int N,
                         int D, int per, int chunks, cudaStream_t stream) {
  const BwdPlan plan(D);
  auto kernel = fused_embed_bwd_tc_kernel<Tin, NT, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return err;
  const int groups = ((N + 15) / 16 + kWarps - 1) / kWarps;
  kernel<<<G * groups * chunks, kTcThreads, plan.bytes, stream>>>(
      static_cast<const Tin*>(patches), static_cast<const float*>(mask),
      static_cast<const float*>(prs), static_cast<const float*>(prb),
      static_cast<const bf16*>(kern), static_cast<const float*>(bias),
      static_cast<const float*>(pls), static_cast<const bf16*>(dtok), static_cast<float*>(ws),
      B, G, P, N, D, per, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const size_t each = static_cast<size_t>(G) * P * D + static_cast<size_t>(G) * D +
                      static_cast<size_t>(G) * N * D;
  const int head = static_cast<int>((each + threads - 1) / threads);
  const int tail = (2 * P + 3 * D + threads / 32 - 1) / (threads / 32);
  reduce_tc_partials<<<head + tail, threads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(grads), G, P, N, D, groups, chunks,
      head);
  return cudaGetLastError();
}

// the model's width (D 96) takes the instantiation with D fixed; the rest of
// tc_widths the one with D's maximum
template <typename Tin>
cudaError_t launch_tc(const void* patches, const void* mask, const void* prs, const void* prb,
                      const void* kern, const void* bias, const void* pls, const void* dtok,
                      void* ws, void* grads, int B, int G, int P, int N, int D, int per,
                      int chunks, cudaStream_t stream) {
  if (D == 96)
    return launch_tc_as<Tin, 12, true>(patches, mask, prs, prb, kern, bias, pls, dtok, ws, grads,
                                       B, G, P, N, D, per, chunks, stream);
  return launch_tc_as<Tin, 16, false>(patches, mask, prs, prb, kern, bias, pls, dtok, ws, grads,
                                      B, G, P, N, D, per, chunks, stream);
}

}  // namespace

// The fp32 workspace (floats) a call with these shapes needs: G x chunks
// blocks' partials in the FMA form, G x groups x chunks in the tensor-core
// form (bf16 compute at the widths tc_widths takes).
extern "C" long long fused_embed_bwd_workspace(int G, int P, int N, int D, int chunks,
                                               int compute_bf16) {
  if (compute_bf16 && tc_widths(P, D)) {
    const long long groups = ((N + 15) / 16 + kWarps - 1) / kWarps;
    return G * groups * chunks * static_cast<long long>(TcPart(P, D).total);
  }
  return static_cast<long long>(G) * chunks * static_cast<long long>(Part(P, N, D).total);
}

// patches [B, G, P, N] in fp32 (bf16 when in_bf16); mask [B, G, N], LN
// scales/biases and bias [G, D] in fp32; kern [G, P, D] and dtok
// [B, G, N, D] in the compute type (bf16 when compute_bf16, else fp32).
// ws: the fp32 workspace of fused_embed_bwd_workspace floats; grads: the
// fp32 gradients (prs, prb, kern, bias, pls, plb, pos, mask_token). bf16
// compute at the widths tc_widths takes launches the tensor-core form (G x
// groups x chunks blocks, each walking per b's; dtok 16-byte aligned, else
// cudaErrorMisalignedAddress) and reduce_tc_partials; the rest the FMA form
// (G x chunks blocks, each over a contiguous range of b; per unused) and
// reduce_partials. Launches on `stream`; returns cudaGetLastError().
extern "C" int fused_embed_bwd(const void* patches, const void* mask, const void* prs,
                               const void* prb, const void* kern, const void* bias,
                               const void* pls, const void* plb, const void* dtok, void* ws,
                               void* grads, int B, int G, int P, int N, int D, int per,
                               int chunks, int in_bf16, int compute_bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (compute_bf16 && tc_widths(P, D)) {
    if (!aligned16(dtok)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (in_bf16)
      err = launch_tc<bf16>(patches, mask, prs, prb, kern, bias, pls, dtok, ws, grads,
                            B, G, P, N, D, per, chunks, st);
    else
      err = launch_tc<float>(patches, mask, prs, prb, kern, bias, pls, dtok, ws, grads,
                             B, G, P, N, D, per, chunks, st);
  } else if (in_bf16 && compute_bf16) {
    err = launch_fma<bf16, bf16>(patches, mask, prs, prb, kern, bias, pls, plb, dtok, ws, grads,
                                 B, G, P, N, D, chunks, st);
  } else if (in_bf16) {
    err = launch_fma<bf16, float>(patches, mask, prs, prb, kern, bias, pls, plb, dtok, ws, grads,
                                  B, G, P, N, D, chunks, st);
  } else if (compute_bf16) {
    err = launch_fma<float, bf16>(patches, mask, prs, prb, kern, bias, pls, plb, dtok, ws, grads,
                                  B, G, P, N, D, chunks, st);
  } else {
    err = launch_fma<float, float>(patches, mask, prs, prb, kern, bias, pls, plb, dtok, ws,
                                   grads, B, G, P, N, D, chunks, st);
  }
  return static_cast<int>(err);
}
