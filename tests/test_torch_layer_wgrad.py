"""The tensor-core layer backward's split on the CPU: the plain row kernel
(dx, the weight gradients' operands, the small vectors' per-block
partials) composed with the plain weight-gradient kernel (the row chunking
the wrapper computes, summed chunk by chunk) against the written-out
``reference_layer_bwd``, and the layouts and chunking the two CUDA kernels
share.

Tolerance: every gradient within 1e-6 * max|ref| per tensor in fp32; the
two routes differ only in the order of their fp32 sums (per block and per
chunk, then over blocks and chunks). The JAX gradients are held by
test_torch_fused_layer_bwd.py::test_split_backward_matches_jax."""

import numpy as np
import pytest
import torch

from maskedsst_tpu_torch.ops import fused_layer, layer_wgrad
from maskedsst_tpu_torch.ops.fused_layer import LayerParams

TOL = 1e-6
NAMES = ("dx",) + LayerParams._fields


def _inputs(b, s, d, heads, dh, f, identity_proj=False, seed=0):
    rng = np.random.default_rng(seed)
    i = heads * dh

    def w(*shape):
        w = rng.standard_normal(shape) / np.sqrt(shape[0])
        return torch.from_numpy(w.astype(np.float32))

    def v(n, base=0.0):
        return torch.from_numpy((base + 0.1 * rng.standard_normal(n)).astype(np.float32))

    wout, bout = (torch.eye(i, d), torch.zeros(d)) if identity_proj else (w(i, d), v(d))
    params = LayerParams(v(d, 1.0), v(d), w(d, 3 * i), wout, bout, v(d, 1.0), v(d), w(d, f), v(f),
                         w(f, d), v(d))
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    return x, dy, params


@pytest.mark.parametrize(
    "b,s,d,heads,dh,f,identity_proj",
    [
        (4, 8, 16, 2, 8, 12, False),  # narrow
        (13, 5, 16, 2, 8, 12, False),  # S = 5, twelve sequences a row block
        (13, 20, 32, 2, 16, 16, False),  # N = 260: five chunks of 64 rows, the last of 4
        (4, 8, 16, 1, 16, 12, True),  # identity projection (heads 1, dim_head = dim)
    ],
)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_split_backward_matches_reference(b, s, d, heads, dh, f, identity_proj, rate):
    x, dy, params = _inputs(b, s, d, heads, dh, f, identity_proj)
    cfg = (heads, dh, torch.float32, rate, rate > 0, 9, not identity_proj)
    got_dx, got = fused_layer.layer_bwd_split(x, dy, params, *cfg)
    want_dx, want = fused_layer.reference_layer_bwd(x, dy, params, *cfg)
    for name, g, w in zip(NAMES, (got_dx, *got), (want_dx, *want)):
        assert g.shape == w.shape, name
        err = float((g - w).abs().max()) / float(w.abs().max())
        assert err <= TOL, f"{name}: max|d|/max|ref| = {err:.3e} > {TOL}"


def test_chunking_covers_the_rows_in_whole_tiles():
    for n in (1, 63, 64, 260, 20_480, 81_920, 81_983):
        rows, chunks = layer_wgrad.chunking(n, 512, 64)
        assert rows % layer_wgrad.TILE == 0 and (chunks - 1) * rows < n <= chunks * rows
        assert 34 * chunks <= layer_wgrad.BLOCK_SLOTS  # 34 output tiles at these widths
    assert layer_wgrad.chunking(81_920, 512, 64) == (11_712, 7)
    assert layer_wgrad.chunking(260, 32, 16)[1] == 5


@pytest.mark.parametrize("b,s,nparts", [
    (13, 5, 2),  # row blocks of 12, then 1 sequence of 5 rows
    (37, 5, 2),  # row blocks of 12, 12, 12 and 1 sequences: blocks 0 and 1 own two each
    (13, 20, 2),  # row blocks of 3 sequences of 20 (60 rows), the last of 1
    (5, 64, 3),  # one sequence a row block
    (4, 65, 3),  # past 64 rows (the WMMA row kernel): one sequence a row block
])
def test_row_partials_follow_the_kernel_blocks(b, s, nparts):
    """Kernel block p owns row blocks p, p + nparts, ... of
    seqs_per_block(S) whole sequences: its partial of the small vectors is
    their sum, taken here row by row, and the partials add up to the full
    sums."""
    d, heads, dh, f = 16, 2, 8, 12
    x, dy, params = _inputs(b, s, d, heads, dh, f, seed=1)
    cfg = (heads, dh, torch.float32, 0.1, True, 3, True)
    _, ops, rows = fused_layer._bwd_terms(x, dy, params, fused_layer.LayerConfig(*cfg))
    _, buf, partials = fused_layer.layer_bwd_rows_reference(x, dy, params, *cfg, nparts=nparts)
    terms = torch.cat([rows[k] for k in fused_layer.SMALL], dim=1)
    block = fused_layer.seqs_per_block(s) * s  # rows of a row block
    want = torch.zeros(nparts, terms.shape[1])
    for n in range(b * s):
        want[n // block % nparts] += terms[n]
    assert partials.shape == want.shape
    atol = 1e-6 * float(partials.abs().max())  # fp32 sums in another order
    torch.testing.assert_close(partials, want, rtol=0, atol=atol)
    torch.testing.assert_close(partials.sum(0), terms.sum(0), rtol=0, atol=atol * b * s)
    split = layer_wgrad.split_operands(buf, b * s, d, heads * dh, f)
    assert [t.shape[1] for t in split.values()] == [d, 3 * heads * dh, heads * dh, d, d, f, f, d]
    for k in layer_wgrad.OPERANDS:
        torch.testing.assert_close(split[k], ops[k], rtol=0, atol=0)


def test_wgrad_wrapper_writes_the_weight_entries_only():
    """On a CPU tensor layer_wgrad takes its plain version and writes the
    four weight gradients into their places in the flat vector."""
    n, d, inner, f = 130, 16, 16, 12
    gen = torch.Generator().manual_seed(2)
    buf = torch.randn(n * sum(layer_wgrad.operand_widths(d, inner, f).values()), generator=gen)
    grads = torch.full((layer_wgrad.grad_count(d, inner, f),), float("nan"))
    layer_wgrad.layer_wgrad(buf, n, d, inner, f, grads)
    views = layer_wgrad.split_grads(grads, d, inner, f)
    ops = layer_wgrad.split_operands(buf, n, d, inner, f)
    for name, left, right in layer_wgrad.PRODUCTS:
        torch.testing.assert_close(views[name], ops[left].t() @ ops[right], rtol=1e-5, atol=1e-5)
    for name in fused_layer.SMALL:
        assert torch.isnan(views[name]).all(), name
