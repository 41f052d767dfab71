"""The fused layer backward's four weight gradients: a CUDA kernel and its
plain version, with the layouts they share with the row kernel.

The tensor-core form of the layer backward is split in two. The row kernel
(``csrc/fused_layer_bwd.cu``, wrapped by
:func:`~maskedsst_tpu_torch.ops.fused_layer.layer_bwd_rows`) writes dx, the
small vectors' gradients and the bf16 operands of the weight gradients,
each a row-major ``[N, C]`` block of one flat buffer (:data:`OPERANDS`).
:func:`layer_wgrad` then takes ``dW = left^T right`` summed over the N rows
for the four products of :data:`PRODUCTS`: a CUDA tensor launches
``csrc/layer_wgrad.cu`` (or raises), a CPU tensor takes
:func:`layer_wgrad_reference`. Both sum the rows chunk by chunk in fp32 with
the chunking of :func:`chunking`, then the chunks in order, so the result
does not depend on the card.

Together they replace the Pallas kernel
``maskedsst_tpu/ops/fused_layer.py::_layer_bwd_kernel``, which accumulates
the same products in its body over its sequential grid.
"""

from __future__ import annotations

import functools
import math

import torch

_KERNEL = "layer_wgrad"

# kernel launches since the count was last set to 0 (plain-version calls
# are not counted)
launches = 0

TILE = 64  # the kernel's output tile (columns of `left`) and rows per stage
BLOCK_SLOTS = 264  # blocks the chunking aims at: two on each of an H100's 132 SMs

# the operands in buffer order, and the four products dW = left^T right
OPERANDS = ("h1", "dqkv", "o", "dp1", "h2", "du", "gd", "dp2")
PRODUCTS = (("wqkv", "h1", "dqkv"), ("wout", "o", "dp1"), ("w1", "h2", "du"),
            ("w2", "gd", "dp2"))


def operand_widths(d: int, inner: int, f: int) -> dict:
    """Columns of each operand: h1 the LN1 output, dqkv = (dq, dk, dv) with
    head h's columns at j*inner + h*dim_head, o the heads' outputs, dp1 =
    dx1 * mask3, h2 the LN2 output, du the fc1 pre-activation's gradient, gd
    the dropped GELU output, dp2 = dy * mask7."""
    return dict(h1=d, dqkv=3 * inner, o=inner, dp1=d, h2=d, du=f, gd=f, dp2=d)


def split_operands(buf: torch.Tensor, n: int, d: int, inner: int, f: int) -> dict:
    """The [n, C] views of each operand in the flat buffer."""
    widths = operand_widths(d, inner, f)
    parts = buf.split([n * widths[k] for k in OPERANDS])
    return {k: p.view(n, widths[k]) for k, p in zip(OPERANDS, parts)}


def grad_shapes(d: int, inner: int, f: int) -> dict:
    """The layer's 11 parameter gradients in the order of the flat gradient
    vector (LayerParams order) with their shapes."""
    return dict(ln1_scale=(d,), ln1_bias=(d,), wqkv=(d, 3 * inner), wout=(inner, d), bout=(d,),
                ln2_scale=(d,), ln2_bias=(d,), w1=(d, f), b1=(f,), w2=(f, d), b2=(d,))


def split_grads(grads: torch.Tensor, d: int, inner: int, f: int) -> dict:
    """The views of each gradient in the flat fp32 gradient vector."""
    shapes = grad_shapes(d, inner, f)
    parts = grads.split([math.prod(s) for s in shapes.values()])
    return {k: p.view(s) for (k, s), p in zip(shapes.items(), parts)}


def grad_count(d: int, inner: int, f: int) -> int:
    """The length of the flat gradient vector."""
    return sum(math.prod(s) for s in grad_shapes(d, inner, f).values())


def chunking(n: int, inner: int, f: int) -> tuple:
    """(chunk_rows, nchunks): the row chunks each output tile (TILE columns
    of a product's `left`) is summed over, as many as keep about
    BLOCK_SLOTS blocks in flight (at least one, at most one per TILE rows);
    chunk_rows is a multiple of TILE."""
    tiles = sum(-(-m // TILE) for m in (3 * inner, inner, f, f))
    want = max(1, min(BLOCK_SLOTS // tiles, -(-n // TILE)))
    per_chunk = -(-n // want)
    rows = -(-per_chunk // TILE) * TILE
    return rows, -(-n // rows)


def layer_wgrad_reference(ops: dict, chunk_rows: int) -> dict:
    """Plain version of the kernel: {wqkv, wout, w1, w2} in fp32, each
    ``left^T right`` over the rows summed per chunk of ``chunk_rows`` rows
    in fp32, then over the chunks in order."""
    out = {}
    for name, left, right in PRODUCTS:
        a, b = ops[left], ops[right]
        acc = None
        for r0 in range(0, a.shape[0], chunk_rows):
            part = a[r0:r0 + chunk_rows].float().t() @ b[r0:r0 + chunk_rows].float()
            acc = part if acc is None else acc + part
        out[name] = acc
    return out


@functools.lru_cache(maxsize=None)
def _bind():
    from maskedsst_tpu_torch.ops import _build

    lib = _build.load(_KERNEL)
    return lib, _build.bind(lib, _KERNEL, n_pointers=3, n_ints=6)


def layer_wgrad(ops: torch.Tensor, n: int, d: int, inner: int, f: int,
                grads: torch.Tensor) -> None:
    """Write the four weight gradients into the flat fp32 gradient vector
    ``grads`` (the layout of :func:`grad_shapes`) from the flat operand
    buffer ``ops`` (:data:`OPERANDS`, n rows). The q block of wqkv is left
    as the pre-scaled weights give it."""
    global launches
    chunk_rows, nchunks = chunking(n, inner, f)
    if ops.device.type == "cpu":
        views = split_grads(grads, d, inner, f)
        for name, g in layer_wgrad_reference(split_operands(ops, n, d, inner, f),
                                             chunk_rows).items():
            views[name].copy_(g)
        return
    from maskedsst_tpu_torch.ops import _build

    if ops.dtype != torch.bfloat16 or not ops.is_contiguous() or ops.numel() != n * sum(
            operand_widths(d, inner, f).values()):
        raise ValueError(f"{_KERNEL}: ops must be the contiguous bf16 operand buffer of {n} rows")
    if (grads.dtype != torch.float32 or grads.device != ops.device or not grads.is_contiguous()
            or grads.numel() != grad_count(d, inner, f)):
        raise ValueError(f"{_KERNEL}: grads must be the contiguous fp32 gradient vector on "
                         f"{ops.device}")
    ws = torch.empty((nchunks, d * (4 * inner + 2 * f)), dtype=torch.float32, device=ops.device)
    lib, fn = _bind()
    with torch.cuda.device(ops.device):
        stream = torch.cuda.current_stream(ops.device).cuda_stream
        code = fn(ops.data_ptr(), ws.data_ptr(), grads.data_ptr(), n, d, inner, f, chunk_rows,
                  nchunks, stream)
    _build.check(lib, _KERNEL, code)
    launches += 1
