// Layouts shared by the layer backward's row kernel (fused_layer_bwd.cu) and
// its weight-gradient kernel (layer_wgrad.cu): the flat fp32 gradient
// vector, the row kernel's per-block partials of the small vectors, and the
// bf16 operands of the weight gradients that the row kernel writes for the
// weight-gradient kernel. ops/layer_wgrad.py mirrors the last two.
#pragma once

#include <cstddef>

namespace msst {

// offsets of the 11 gradients in the flat fp32 vector
struct GradLayout {
  size_t ln1s, ln1b, wqkv, wout, bout, ln2s, ln2b, w1, b1, w2, b2, total;

  __host__ __device__ GradLayout(int D, int I, int F) {
    size_t o = 0;
    ln1s = o; o += D;
    ln1b = o; o += D;
    wqkv = o; o += static_cast<size_t>(D) * 3 * I;
    wout = o; o += static_cast<size_t>(I) * D;
    bout = o; o += D;
    ln2s = o; o += D;
    ln2b = o; o += D;
    w1 = o;   o += static_cast<size_t>(D) * F;
    b1 = o;   o += F;
    w2 = o;   o += static_cast<size_t>(F) * D;
    b2 = o;   o += D;
    total = o;
  }
};

// one row-kernel block's partial sums of the seven small vectors:
// ln1 scale/bias, bout, ln2 scale/bias, b1, b2 (6D + F floats)
struct SmallLayout {
  int ln1s, ln1b, bout, ln2s, ln2b, b1, b2, total;

  __host__ __device__ SmallLayout(int D, int F)
      : ln1s(0), ln1b(D), bout(2 * D), ln2s(3 * D), ln2b(4 * D), b1(5 * D), b2(5 * D + F),
        total(6 * D + F) {}
};

// the weight gradients' operands over the N real rows, each a row-major
// [N, C] bf16 block of one buffer, in this order: h1 [N, D] (LN1 output),
// dqkv [N, 3I] (dq, dk, dv; head h's columns j*I + h*dh), o [N, I] (the
// heads' outputs), dp1 [N, D] (dx1 * mask3), h2 [N, D] (LN2 output), du
// [N, F], gd [N, F] (the dropped GELU output), dp2 [N, D] (dy * mask7):
// dwqkv = h1^T dqkv, dwout = o^T dp1, dw1 = h2^T du, dw2 = gd^T dp2
struct OperandLayout {
  size_t h1, dqkv, o, dp1, h2, du, gd, dp2, total;

  __host__ __device__ OperandLayout(long long N, int D, int I, int F) {
    size_t off = 0;
    h1 = off;   off += static_cast<size_t>(N) * D;
    dqkv = off; off += static_cast<size_t>(N) * 3 * I;
    o = off;    off += static_cast<size_t>(N) * I;
    dp1 = off;  off += static_cast<size_t>(N) * D;
    h2 = off;   off += static_cast<size_t>(N) * D;
    du = off;   off += static_cast<size_t>(N) * F;
    gd = off;   off += static_cast<size_t>(N) * F;
    dp2 = off;  off += static_cast<size_t>(N) * D;
    total = off;
  }
};

}  // namespace msst
