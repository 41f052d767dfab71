"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip. Run them on
the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``--noconftest``: the suite's conftest.py imports JAX, which a GPU host
need not have.)

They cover what the shapes in chip_smoke.py do not: batches that leave a
kernel block part-empty, narrow widths, the identity projection, mixed
input and compute types, both forms of the layer forward (tensor cores for
bf16 compute at the widths of fused_layer._tc_form, FMA loops otherwise),
dropout, the x1 that the tensor-core forward's training call writes and
its repeats bit for bit, the backward kernels (the tensor-core form's row kernel and
weight-gradient kernel each against its plain version too, ragged row
chunks included), the masks each kernel applies read bit for bit
(ops/dropout_probe.py), the gradients' run-to-run determinism, and the
wrappers' refusals; for the SimMIM decode + weighted-L1 kernels
(test_simmim_fwd_kernel_matches_plain, test_simmim_bwd_kernel_matches_plain
at SIMMIM_SHAPES), both forms (tensor cores for bf16 compute at the widths
of fused_simmim._tc_form, encoded in bf16 or fp32; FMA loops otherwise) at
the tensor-core edges (d 16, 32, 48, 128; p 1 and 16; ragged token tiles n
9, 20, 70; a batch of 255, whose last chunk of b's is short), all-zero and all-one
weight rows, a diff of exactly 0 in both forms, a NaN in a zero-weight
token reaching the loss and d kernel in the tensor-core form, and both
kernels' repeats bit for bit at the EnMAP and Houston2018 shapes;
for the dropout-sample kernel, its bits against the plain hash from first
indices below and above 2^32 (held exactly), its determinism and launch
count, and its refusals. The embed kernels (test_embed_kernel_matches_plain,
test_embed_bwd_kernel_matches_plain, all eight gradients) at EMBED_SHAPES:
both forms (tensor cores for bf16 compute at the widths of
fused_embed._tc_form, FMA loops otherwise), ragged token tiles (n 9, 20),
p 16, B 1 and a batch whose last chunk of b's is short; the backward's
repeats bit for bit in both forms at the EnMAP and Houston2018 shapes
(test_embed_bwd_gradients_are_deterministic). The layer forward and
backward past 64 rows a block (S 65, 80, 112, 128 at the model's widths,
test_layer_long_sequences_match_plain), where their plans move buffers to
a device scratch; the main paths' plans staying at level 0; a geometry no
plan fits refused with a ValueError before any launch.

Tolerances on max |kernel - plain| / max(1, |plain|): fp32 1e-4 (summation
order and fast intrinsics only), bf16 3e-2 (both round every product
operand to bf16 at the same points, but a one-ulp difference before a
rounding flips a bf16 value, 2^-8 relative, and the output itself may be
bf16). Forward outputs are held elementwise, gradients per tensor
(relative to max(1, max|plain|)). The SimMIM loss is one large sum: it is
held relative to |plain| (1e-5 fp32, 1e-3 bf16), and its gradients, far
below 1, relative to their own max|plain|.
"""

import numpy as np
import pytest
import torch

from maskedsst_tpu_torch.ops import (
    dropout_probe,
    dropout_sample,
    fused_embed,
    fused_layer,
    fused_simmim,
    layer_wgrad,
)
from maskedsst_tpu_torch.ops.fused_layer import LayerParams

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def _layer_params(rng, d, heads, dh, f, device, identity_proj=False):
    i = heads * dh

    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32))

    def v(n, base=0.0):
        return torch.from_numpy((base + 0.1 * rng.standard_normal(n)).astype(np.float32))

    wout, bout = (torch.eye(i, d), torch.zeros(d)) if identity_proj else (w(i, d), v(d))
    p = LayerParams(ln1_scale=v(d, 1.0), ln1_bias=v(d), wqkv=w(d, 3 * i), wout=wout, bout=bout,
                    ln2_scale=v(d, 1.0), ln2_bias=v(d), w1=w(d, f), b1=v(f), w2=w(f, d), b2=v(d))
    return LayerParams(*(t.to(device) for t in p))


@pytest.mark.parametrize(
    "b,s,d,heads,dh,f,identity_proj",
    [
        (3, 64, 96, 8, 64, 64, False),  # spatial, one sequence per block
        (7, 20, 96, 8, 64, 64, False),  # spectral, last block part-empty
        (13, 5, 96, 8, 64, 64, False),  # Houston spectral, odd seq
        (5, 8, 16, 2, 8, 12, False),  # narrow, FMA form only
        (4, 8, 16, 1, 16, 12, True),  # identity projection
        (5, 8, 32, 2, 16, 16, False),  # narrow, tensor-core form in bf16
        (2, 80, 32, 2, 16, 16, False),  # a sequence longer than a block's 64 rows
        (4, 8, 32, 1, 32, 32, True),  # identity projection, tensor-core form in bf16
        (4, 8, 32, 1, 32, 16, True),  # identity projection, F = 16
        (1, 64, 96, 8, 64, 64, False),  # S = 64: one block, one sequence
        (11, 20, 96, 8, 64, 64, False),  # S = 20: last block 2 of 3 sequences
        (25, 5, 96, 8, 64, 64, False),  # S = 5: last block 1 of 12 sequences
        (3, 80, 96, 8, 64, 64, False),  # S = 80 at the model's widths
    ],
)
@pytest.mark.parametrize(
    "io_dtype,compute_dtype",
    [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
     (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)],
)
def test_layer_kernel_matches_plain(cuda, b, s, d, heads, dh, f, identity_proj, io_dtype,
                                    compute_dtype):
    rng = np.random.default_rng(0)
    params = _layer_params(rng, d, heads, dh, f, cuda, identity_proj)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(cuda, io_dtype)
    before = fused_layer.launches
    got = fused_layer.fused_transformer_layer(x, params, heads, dh, compute_dtype)
    torch.cuda.synchronize()
    assert fused_layer.launches == before + 1
    want = fused_layer.reference_layer(x, params, heads, dh, compute_dtype)
    assert got.dtype == io_dtype and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    tol = max(TOL[io_dtype], TOL[compute_dtype])
    assert _rel_err(got, want) <= tol


TC_FWD_SHAPES = [
    (3, 64, 96, 8, 64, 64, False),  # spatial
    (1, 64, 96, 8, 64, 64, False),  # S = 64, one block
    (7, 20, 96, 8, 64, 64, False),  # spectral, last block 1 of 3 sequences
    (11, 20, 96, 8, 64, 64, False),  # last block 2 of 3 sequences
    (13, 5, 96, 8, 64, 64, False),  # Houston spectral, last block 1 of 12
    (25, 5, 96, 8, 64, 64, False),  # last block 1 of 12, two blocks before it
    (3, 80, 96, 8, 64, 64, False),  # a sequence longer than a block's 64 rows
    (2, 80, 32, 2, 16, 16, False),  # the same, narrow
    (5, 8, 32, 2, 16, 16, False),  # narrow
    (4, 8, 32, 1, 32, 16, True),  # identity projection
]


@pytest.mark.parametrize("b,s,d,heads,dh,f,identity_proj", TC_FWD_SHAPES)
@pytest.mark.parametrize("io_dtype", [torch.float32, torch.bfloat16])
def test_layer_fwd_tc_repeats_and_writes_x1(cuda, b, s, d, heads, dh, f, identity_proj,
                                            io_dtype):
    """The tensor-core forward's training call with dropout 0.1: y against
    the plain version, the x1 it writes against the plain x1, and two calls
    bit-identical in both."""
    rng = np.random.default_rng(12)
    params = _layer_params(rng, d, heads, dh, f, cuda, identity_proj)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(cuda, io_dtype)
    cfg = (heads, dh, torch.bfloat16, 0.1, True, 2024, not identity_proj)
    x1, x1_again = (torch.empty(x.shape, dtype=torch.float32, device=cuda) for _ in range(2))
    before = fused_layer.launches
    y = fused_layer._launch(x, params, *cfg, x1=x1)
    y_again = fused_layer._launch(x, params, *cfg, x1=x1_again)
    torch.cuda.synchronize()
    assert fused_layer.launches == before + 2
    assert torch.equal(y, y_again) and torch.equal(x1, x1_again)
    assert _rel_err(y, fused_layer.reference_layer(x, params, *cfg)) <= TOL[torch.bfloat16]
    assert _rel_err(x1, fused_layer.reference_x1(x, params, *cfg)) <= TOL[torch.bfloat16]


def _embed_args(rng, b, g, p, n, d, device, in_dtype=torch.float32):
    def r(*shape, base=0.0, scale=0.1):
        return torch.from_numpy((base + scale * rng.standard_normal(shape)).astype(np.float32))

    patches = r(b, g, p, n, scale=1.0).to(in_dtype)
    mask = torch.from_numpy((rng.random((b, g, n)) < 0.7).astype(np.float32))
    args = (patches, mask, r(p, base=1.0), r(p), r(g, p, d, scale=p**-0.5), r(g, d),
            r(d, base=1.0), r(d), r(g, n, d, scale=1.0), r(d, scale=1.0))
    return tuple(a.to(device) for a in args)


# the embed's shapes: EnMAP and Houston2018 blocks, narrow widths, and for the
# tensor-core forms ragged token tiles (n 9, 20), p 16, d 40 (an odd number
# of 8-column tiles), B 1 and a batch whose last chunk of b's is short
EMBED_SHAPES = [(3, 20, 10, 64, 96), (2, 5, 10, 64, 96), (2, 3, 4, 9, 16), (1, 20, 10, 64, 96),
                (5, 3, 16, 20, 96), (7, 2, 16, 9, 40), (255, 20, 10, 64, 96)]


@pytest.mark.parametrize("b,g,p,n,d", EMBED_SHAPES)
@pytest.mark.parametrize(
    "in_dtype,compute_dtype",
    [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
     (torch.bfloat16, torch.bfloat16)],
)
def test_embed_kernel_matches_plain(cuda, b, g, p, n, d, in_dtype, compute_dtype):
    args = _embed_args(np.random.default_rng(1), b, g, p, n, d, cuda, in_dtype)
    before = fused_embed.launches
    got = fused_embed.fused_embed_mask(*args, compute_dtype)
    torch.cuda.synchronize()
    assert fused_embed.launches == before + 1
    want = fused_embed.fused_embed_mask_reference(*args, compute_dtype)
    assert got.dtype == want.dtype and got.shape == want.shape == (b, g, n, d)
    assert _rel_err(got, want) <= TOL[compute_dtype]


def test_layer_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(2)
    params = _layer_params(rng, 16, 2, 8, 12, cuda)
    x = torch.randn(4, 8, 16, device=cuda)
    with pytest.raises(TypeError, match="fp32/bf16"):
        fused_layer.fused_transformer_layer(x.half(), params, 2, 8, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fused_layer.fused_transformer_layer(x.transpose(0, 1), params, 2, 8, torch.float32)
    with pytest.raises(ValueError, match="w1 must be"):
        fused_layer.fused_transformer_layer(x, params._replace(w1=params.w1.cpu()), 2, 8,
                                            torch.float32)
    # training with dropout launches the kernel (and agrees with the plain version)
    before = fused_layer.launches
    got = fused_layer.fused_transformer_layer(x, params, 2, 8, torch.float32, 0.1, True, 5)
    assert fused_layer.launches == before + 1
    want = fused_layer.reference_layer(x, params, 2, 8, torch.float32, 0.1, True, 5)
    assert _rel_err(got, want) <= TOL[torch.float32]


def test_embed_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    args = list(_embed_args(np.random.default_rng(3), 2, 3, 4, 9, 16, cuda))
    with pytest.raises(TypeError, match="fp32/bf16"):
        fused_embed.fused_embed_mask(*args, torch.float16)
    args[8] = args[8][:1]
    with pytest.raises(ValueError, match="pos must be"):
        fused_embed.fused_embed_mask(*args, torch.float32)


def _grad_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(1.0, float(want.float().abs().max()))


LAYER_BWD_SHAPES = [
    (3, 64, 96, 8, 64, 64, False),  # spatial
    (7, 20, 96, 8, 64, 64, False),  # spectral, last block part-empty
    (13, 5, 96, 8, 64, 64, False),  # Houston spectral, odd seq
    (5, 8, 16, 2, 8, 12, False),  # narrow
    (4, 8, 16, 1, 16, 12, True),  # identity projection
    (2, 80, 32, 2, 16, 16, False),  # a sequence longer than 64 rows
]


@pytest.mark.parametrize("b,s,d,heads,dh,f,identity_proj", LAYER_BWD_SHAPES)
@pytest.mark.parametrize(
    "io_dtype,compute_dtype",
    [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
     (torch.float32, torch.bfloat16)],
)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_layer_bwd_kernel_matches_plain(cuda, b, s, d, heads, dh, f, identity_proj, io_dtype,
                                        compute_dtype, rate):
    rng = np.random.default_rng(6)
    params = _layer_params(rng, d, heads, dh, f, cuda, identity_proj)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(cuda, io_dtype)
    dy = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(cuda, io_dtype)
    cfg = (heads, dh, compute_dtype, rate, rate > 0, 1234, not identity_proj)
    before = fused_layer.bwd_launches
    dx, grads = fused_layer._launch_bwd(x, dy, params, *cfg)
    torch.cuda.synchronize()
    assert fused_layer.bwd_launches == before + 1
    want_dx, want = fused_layer.reference_layer_bwd(x, dy, params, *cfg)
    assert dx.dtype == io_dtype and dx.shape == x.shape
    tol = max(TOL[io_dtype], TOL[compute_dtype])
    for name, g, w in zip(("dx",) + LayerParams._fields, (dx, *grads), (want_dx, *want)):
        assert torch.isfinite(g.float()).all(), name
        assert _grad_err(g, w) <= tol, f"{name}: {_grad_err(g, w):.3e}"


@pytest.mark.parametrize("b,s,d,heads,dh,f,identity_proj", LAYER_BWD_SHAPES[:3])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_layer_fwd_kernel_with_dropout_matches_plain(cuda, b, s, d, heads, dh, f, identity_proj,
                                                     compute_dtype):
    """Both forms of the forward kernel agree with the plain version with
    dropout on, and dropout changes the output (the masks themselves are
    read bit for bit by test_dropout_masks_bitwise)."""
    rng = np.random.default_rng(7)
    params = _layer_params(rng, d, heads, dh, f, cuda, identity_proj)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(cuda)
    got = fused_layer.fused_transformer_layer(x, params, heads, dh, compute_dtype, 0.1, True, 99)
    want = fused_layer.reference_layer(x, params, heads, dh, compute_dtype, 0.1, True, 99)
    assert _rel_err(got, want) <= TOL[compute_dtype]
    undropped = fused_layer.reference_layer(x, params, heads, dh, compute_dtype)
    assert _rel_err(got, undropped) > 10 * TOL[compute_dtype]


@pytest.mark.parametrize("b,s,d,heads,dh,f", [
    (3, 64, 96, 8, 64, 64),  # spatial
    (7, 20, 96, 8, 64, 64),  # spectral, last block part-empty
    (13, 5, 96, 8, 64, 64),  # Houston spectral, odd seq
    (5, 8, 16, 2, 8, 12),  # narrow, FMA form only
    (5, 8, 32, 2, 16, 16),  # narrow, tensor-core form in bf16
])
@pytest.mark.parametrize(
    "io_dtype,compute_dtype",
    [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
     (torch.float32, torch.bfloat16)],
)
def test_dropout_masks_bitwise(cuda, b, s, d, heads, dh, f, io_dtype, compute_dtype):
    """The masks the forward and backward kernels apply, read out of their
    outputs by the probes of ops/dropout_probe.py, equal dropout_mask bit
    for bit."""
    for seed in (0, 2**31 + 5):
        readings = dropout_probe.read_layer_masks(
            fused_layer._launch, fused_layer._launch_bwd, b, s, d, heads, dh, f, io_dtype,
            compute_dtype, seed, cuda, torch.Generator().manual_seed(seed))
        assert len(readings) == 4
        for r in readings:
            assert r.equal and r.margin < 0.5, r


def test_layer_bwd_gradients_are_deterministic(cuda):
    rng = np.random.default_rng(8)
    params = _layer_params(rng, 96, 8, 64, 64, cuda)
    x = torch.from_numpy(rng.standard_normal((300, 20, 96)).astype(np.float32)).to(cuda)
    dy = torch.randn_like(x)
    cfg = (8, 64, torch.bfloat16, 0.1, True, 3, True)
    first = fused_layer._launch_bwd(x, dy, params, *cfg)
    second = fused_layer._launch_bwd(x, dy, params, *cfg)
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))


SPLIT_SHAPES = [
    (3, 64, 96, 8, 64, 64),  # spatial
    (7, 20, 96, 8, 64, 64),  # spectral, last block part-empty, one chunk of 140 rows
    (13, 5, 96, 8, 64, 64),  # Houston spectral, odd seq
    (101, 20, 96, 8, 64, 64),  # N = 2,020: seven chunks of 320 rows, the last of 100
    (5, 8, 32, 2, 16, 16),  # narrow
    (2, 80, 32, 2, 16, 16),  # a sequence longer than 64 rows
]


@pytest.mark.parametrize("b,s,d,heads,dh,f", SPLIT_SHAPES)
@pytest.mark.parametrize("io_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_layer_split_kernels_match_plain(cuda, b, s, d, heads, dh, f, io_dtype, rate):
    """The tensor-core backward's row kernel (from the x1 its forward
    writes) against its plain version: dx, the weight gradients' operands
    and the small vectors; layer_wgrad against its plain version on the row
    kernel's operands (fp32 sums of the same bf16 values: the fp32 limit);
    each launch counted once."""
    rng = np.random.default_rng(10)
    params = _layer_params(rng, d, heads, dh, f, cuda)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(cuda, io_dtype)
    dy = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(cuda, io_dtype)
    cfg = (heads, dh, torch.bfloat16, rate, rate > 0, 4321, True)
    n, i = b * s, heads * dh
    x1 = torch.empty(x.shape, dtype=torch.float32, device=cuda)
    fused_layer._launch(x, params, *cfg, x1=x1)
    before = (fused_layer.bwd_launches, layer_wgrad.launches)
    dx, ops, grads = fused_layer.layer_bwd_rows(x, dy, params, *cfg, x1=x1)
    layer_wgrad.layer_wgrad(ops, n, d, i, f, grads)
    torch.cuda.synchronize()
    assert (fused_layer.bwd_launches, layer_wgrad.launches) == (before[0] + 1, before[1] + 1)
    want_dx, want_ops, partials = fused_layer.layer_bwd_rows_reference(
        x, dy, params, *cfg, nparts=fused_layer._nparts(b, s, x.device))
    assert _grad_err(dx, want_dx) <= TOL[torch.bfloat16]
    got, want = (layer_wgrad.split_operands(t, n, d, i, f) for t in (ops, want_ops))
    for k in layer_wgrad.OPERANDS:
        assert _grad_err(got[k], want[k]) <= TOL[torch.bfloat16], k
    views = layer_wgrad.split_grads(grads, d, i, f)
    small = partials.sum(dim=0).split([views[k].numel() for k in fused_layer.SMALL])
    for k, w in zip(fused_layer.SMALL, small):
        assert _grad_err(views[k], w) <= TOL[torch.bfloat16], k
    ref = layer_wgrad.layer_wgrad_reference(got, layer_wgrad.chunking(n, i, f)[0])
    for k, w in ref.items():
        assert _grad_err(views[k], w) <= TOL[torch.float32], k


# sequences longer than the 64 rows a block of the main paths holds: the
# cls-token sequence of ViTRGB (65 at 8x8 patches of 1) and the edges of
# _tc_form's 128 rows, at the model's widths
LONG_SEQS = [65, 80, 112, 128]


@pytest.mark.parametrize("s", LONG_SEQS)
@pytest.mark.parametrize(
    "io_dtype,compute_dtype",
    [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
     (torch.float32, torch.bfloat16)],
)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_layer_long_sequences_match_plain(cuda, s, io_dtype, compute_dtype, rate):
    """The layer forward and the whole backward (bf16: the row kernel from
    the training forward's x1, then layer_wgrad; fp32: the FMA form) past
    64 rows a block, where the plans move buffers to a device scratch,
    against the plain versions; two calls give the same bits."""
    rng = np.random.default_rng(12)
    b, d, heads, dh, f = 3, 96, 8, 64, 64
    params = tuple(t.requires_grad_() for t in _layer_params(rng, d, heads, dh, f, cuda))
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(cuda, io_dtype)
    dy = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(cuda, io_dtype)
    x.requires_grad_()
    cfg = (heads, dh, compute_dtype, rate, rate > 0, 77, True)
    tc = fused_layer._tc_form(fused_layer.LayerConfig(*cfg), s, d, f)
    assert tc == (compute_dtype == torch.bfloat16)
    plan = fused_layer.launch_plan("rows" if tc else "bwd", s, d, dh, f, cuda)
    assert plan.level >= 1 and plan.shared_bytes <= plan.limit, plan

    def run():
        before = (fused_layer.launches, fused_layer.bwd_launches, layer_wgrad.launches)
        y = fused_layer.fused_transformer_layer(x, LayerParams(*params), *cfg)
        grads = torch.autograd.grad(y, (x, *params), dy)
        torch.cuda.synchronize()
        after = (fused_layer.launches, fused_layer.bwd_launches, layer_wgrad.launches)
        assert after == (before[0] + 1, before[1] + 1, before[2] + int(tc)), (before, after)
        return y, grads

    y, grads = run()
    y2, grads2 = run()
    assert torch.equal(y, y2) and all(torch.equal(g, h) for g, h in zip(grads, grads2))
    want_y = fused_layer.reference_layer(x.detach(), LayerParams(*params), *cfg)
    assert _rel_err(y.detach(), want_y.detach()) <= TOL[compute_dtype]
    want_dx, want = fused_layer.reference_layer_bwd(x.detach(), dy, LayerParams(*params), *cfg)
    tol = max(TOL[io_dtype], TOL[compute_dtype])
    for name, g, w in zip(("dx",) + LayerParams._fields, grads, (want_dx, *want)):
        assert torch.isfinite(g.float()).all(), name
        assert _grad_err(g, w) <= tol, f"{name}: {_grad_err(g, w):.3e}"


@pytest.mark.parametrize("s,form", [(5, "rows"), (20, "rows"), (64, "rows"), (5, "bwd"),
                                    (20, "bwd"), (64, "bwd"), (64, "fwd"), (80, "fwd")])
def test_layer_plans_keep_the_main_paths_in_shared_memory(cuda, s, form):
    """At the main paths' sequences (and the forward's FMA form up to 80
    rows) every buffer stays in shared memory, the weights staged: the
    plans of the launches before longer sequences were taken."""
    plan = fused_layer.launch_plan(form, s, 96, 64, 64, cuda)
    assert plan.level == 0 and plan.scratch_bytes == 0, plan


@pytest.mark.parametrize("form", ["fwd", "bwd"])
def test_layer_geometry_above_the_limit_raises(cuda, form):
    """A geometry whose FMA form does not fit even with every movable buffer
    in the device scratch raises a ValueError naming S, D, dh, F and the
    bytes, before any launch."""
    rng = np.random.default_rng(13)
    b, s, d, heads, dh, f = 2, 200, 96, 2, 256, 64
    params = _layer_params(rng, d, heads, dh, f, cuda)
    x = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(cuda)
    before = (fused_layer.launches, fused_layer.bwd_launches)
    with pytest.raises(ValueError, match=r"S 200, D 96, dh 256, F 64: .* bytes a block"):
        if form == "fwd":
            fused_layer.fused_transformer_layer(x, params, heads, dh, torch.float32)
        else:
            fused_layer._launch_bwd(x, torch.randn_like(x), params, heads, dh, torch.float32)
    assert (fused_layer.launches, fused_layer.bwd_launches) == before


def test_layer_autograd_tc_route_saves_x1(cuda):
    """A training call of the bf16 layer launches the forward once (writing
    x1), the row kernel once and layer_wgrad once; a call under no_grad
    launches the forward only; the gradients match the plain route's."""
    rng = np.random.default_rng(11)
    params = LayerParams(*(t.requires_grad_() for t in _layer_params(rng, 96, 8, 64, 64, cuda)))
    x = torch.randn(7, 20, 96, device=cuda, requires_grad=True)
    counts = (fused_layer.launches, fused_layer.bwd_launches, layer_wgrad.launches)
    y = fused_layer.fused_transformer_layer(x, params, 8, 64, torch.bfloat16, 0.1, True, 5)
    (y.float() * y.float()).sum().backward()
    torch.cuda.synchronize()
    assert (fused_layer.launches, fused_layer.bwd_launches, layer_wgrad.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)
    got = [x.grad] + [t.grad for t in params]
    for t in (x, *params):
        t.grad = None
    y = fused_layer.plain_transformer_layer(x, params, 8, 64, torch.bfloat16, 0.1, True, 5)
    (y.float() * y.float()).sum().backward()
    for g, t in zip(got, (x, *params)):
        assert _grad_err(g, t.grad) <= TOL[torch.bfloat16]
    with torch.no_grad():
        before = (fused_layer.launches, fused_layer.bwd_launches)
        fused_layer.fused_transformer_layer(x, params, 8, 64, torch.bfloat16)
    assert (fused_layer.launches, fused_layer.bwd_launches) == (before[0] + 1, before[1])


def test_layer_wgrad_wrapper_refusals(cuda):
    n, d, i, f = 64, 32, 32, 16
    size = n * sum(layer_wgrad.operand_widths(d, i, f).values())
    grads = torch.empty(d * (4 * i + 2 * f) + 6 * d + f, device=cuda)
    with pytest.raises(ValueError, match="bf16 operand buffer"):
        layer_wgrad.layer_wgrad(torch.zeros(size, device=cuda), n, d, i, f, grads)
    with pytest.raises(ValueError, match="bf16 operand buffer"):
        layer_wgrad.layer_wgrad(torch.zeros(size - 8, device=cuda, dtype=torch.bfloat16), n, d,
                                i, f, grads)
    with pytest.raises(ValueError, match="fp32"):
        layer_wgrad.layer_wgrad(torch.zeros(size, device=cuda, dtype=torch.bfloat16), n, d, i, f,
                                grads.bfloat16())


def test_layer_autograd_routes_to_the_kernels(cuda):
    rng = np.random.default_rng(9)
    params = LayerParams(*(t.requires_grad_() for t in _layer_params(rng, 16, 2, 8, 12, cuda)))
    x = torch.randn(4, 8, 16, device=cuda, requires_grad=True)
    fwd, bwd = fused_layer.launches, fused_layer.bwd_launches
    fused_layer.fused_transformer_layer(x, params, 2, 8, torch.float32, 0.1, True, 1).sum().backward()
    assert (fused_layer.launches, fused_layer.bwd_launches) == (fwd + 1, bwd + 1)
    assert x.grad is not None and all(t.grad is not None for t in params)


@pytest.mark.parametrize("b,g,p,n,d", EMBED_SHAPES + [(300, 2, 4, 9, 16), (81, 20, 10, 64, 96)])
@pytest.mark.parametrize(
    "in_dtype,compute_dtype",
    [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
     (torch.bfloat16, torch.bfloat16)],
)
def test_embed_bwd_kernel_matches_plain(cuda, b, g, p, n, d, in_dtype, compute_dtype):
    args = _embed_args(np.random.default_rng(10), b, g, p, n, d, cuda, in_dtype)
    dtok = torch.randn(b, g, n, d, device=cuda).to(fused_embed._out_dtype(compute_dtype))
    before = fused_embed.bwd_launches
    got = fused_embed._launch_bwd(*args, dtok, compute_dtype)
    torch.cuda.synchronize()
    assert fused_embed.bwd_launches == before + 1
    want = fused_embed.fused_embed_mask_reference_bwd(*args, dtok, compute_dtype)
    for i, (gv, wv) in enumerate(zip(got, want)):
        assert gv.shape == wv.shape and torch.isfinite(gv).all(), i
        assert _grad_err(gv, wv) <= TOL[compute_dtype], f"grad {i}: {_grad_err(gv, wv):.3e}"


@pytest.mark.parametrize("g", [20, 5])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_embed_bwd_gradients_are_deterministic(cuda, g, compute_dtype):
    """Two calls give the same bits: the FMA form (fp32) and the
    tensor-core form (bf16), at the EnMAP and Houston2018 shapes."""
    args = _embed_args(np.random.default_rng(11), 64, g, 10, 64, 96, cuda)
    dtok = torch.randn(64, g, 64, 96, device=cuda).to(fused_embed._out_dtype(compute_dtype))
    first = fused_embed._launch_bwd(*args, dtok, compute_dtype)
    second = fused_embed._launch_bwd(*args, dtok, compute_dtype)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_embed_autograd_routes_to_the_kernels(cuda):
    args = list(_embed_args(np.random.default_rng(12), 2, 3, 4, 9, 16, cuda))
    for i in range(2, 10):
        args[i].requires_grad_()
    fwd, bwd = fused_embed.launches, fused_embed.bwd_launches
    fused_embed.fused_embed_mask(*args, torch.float32).sum().backward()
    assert (fused_embed.launches, fused_embed.bwd_launches) == (fwd + 1, bwd + 1)
    assert all(a.grad is not None for a in args[2:])


def _simmim_args(rng, b, g, p, n, d, device, enc_dtype=torch.float32):
    def r(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    weights = torch.from_numpy((rng.random((b, g * n)) < 0.6).astype(np.float32))
    weights[0] = 0.0  # an all-zero row
    weights[-1] = 1.0  # an all-one row (the same row when b == 1)
    args = (r(b, g, n, d).to(enc_dtype), r(b, g, p, n), r(g, d, p, scale=d**-0.5),
            r(g, p, scale=0.1), weights)
    return tuple(a.to(device) for a in args)


SIMMIM_SHAPES = [
    (3, 20, 10, 64, 96),  # the recipe's blocks, a short batch
    (64, 20, 10, 64, 96),  # the recipe, the last block's batch range part-empty
    (2, 5, 10, 64, 96),  # Houston, 5 blocks
    (2, 3, 4, 9, 16),  # narrow
    (300, 2, 4, 9, 16),  # many rows per block
    (5, 3, 16, 20, 32),  # p 16, a ragged token tile, d 32
    (4, 2, 1, 70, 128),  # p 1, two 64-token groups with a ragged tile, d 128
    (6, 3, 12, 33, 48),  # d 48: an odd number of 16-column steps
    # a short last chunk of b's; 3 blocks, so that it holds no more signs
    # (490k) than the recipe's 819k: at 255 x 20 blocks one of 3.3M diffs sat
    # an fp32 ulp from 0 (-2.4e-7), the kernel's and cuBLAS's sums gave it
    # opposite signs, and that token's d encoded moved by a third of its max
    (255, 3, 10, 64, 96),
]
SIMMIM_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                 (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]
SIMMIM_LOSS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


@pytest.mark.parametrize("b,g,p,n,d", SIMMIM_SHAPES)
@pytest.mark.parametrize("enc_dtype,compute_dtype", SIMMIM_DTYPES)
def test_simmim_fwd_kernel_matches_plain(cuda, b, g, p, n, d, enc_dtype, compute_dtype):
    args = _simmim_args(np.random.default_rng(13), b, g, p, n, d, cuda, enc_dtype)
    before = fused_simmim.launches
    got = fused_simmim._launch(*args, compute_dtype)
    torch.cuda.synchronize()
    assert fused_simmim.launches == before + 1
    want = fused_simmim.fused_decode_l1_reference(*args, compute_dtype)
    assert got.dtype == torch.float32 and got.shape == ()
    tol = max(SIMMIM_LOSS_TOL[enc_dtype], SIMMIM_LOSS_TOL[compute_dtype])
    assert abs(float(got) - float(want)) <= tol * abs(float(want))


def _rel_to_max(got, want):
    return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())


@pytest.mark.parametrize("b,g,p,n,d", SIMMIM_SHAPES)
@pytest.mark.parametrize("enc_dtype,compute_dtype", SIMMIM_DTYPES)
def test_simmim_bwd_kernel_matches_plain(cuda, b, g, p, n, d, enc_dtype, compute_dtype):
    args = _simmim_args(np.random.default_rng(14), b, g, p, n, d, cuda, enc_dtype)
    gout = torch.tensor(1.9e-9, device=cuda)  # the recipe's 1/(64*896*10)/896
    before = fused_simmim.bwd_launches
    got = fused_simmim._launch_bwd(*args, gout, compute_dtype)
    torch.cuda.synchronize()
    assert fused_simmim.bwd_launches == before + 1
    want = fused_simmim.fused_decode_l1_reference_bwd(*args, gout, compute_dtype)
    assert got[0].dtype == enc_dtype and got[0].shape == args[0].shape
    tol = max(TOL[enc_dtype], TOL[compute_dtype])
    for name, gv, wv in zip(("encoded", "kernel", "bias"), got, want):
        assert gv.shape == wv.shape and torch.isfinite(gv.float()).all(), name
        assert _rel_to_max(gv, wv) <= tol, f"{name}: {_rel_to_max(gv, wv):.3e}"
    # the all-zero weight row gets no encoded gradient
    assert float(got[0][0].float().abs().max()) == 0.0


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_simmim_zero_diff_has_zero_sign(cuda, compute_dtype):
    """Predictions equal to their pixels: loss 0 and every gradient 0, in
    the FMA form (fp32) and the tensor-core form (bf16; the zero encoded
    makes the decode exactly 0 there too)."""
    b, g, p, n, d = 2, 3, 4, 9, 16
    assert fused_simmim._tc_form(compute_dtype, p, d) == (compute_dtype == torch.bfloat16)
    enc = torch.zeros(b, g, n, d, device=cuda)
    kernel = torch.randn(g, d, p, device=cuda)
    bias = torch.randn(g, p, device=cuda)
    patches = bias[None, :, :, None].expand(b, g, p, n).contiguous()
    weights = torch.ones(b, g * n, device=cuda)
    assert float(fused_simmim._launch(enc, patches, kernel, bias, weights, compute_dtype)) == 0.0
    grads = fused_simmim._launch_bwd(enc, patches, kernel, bias, weights,
                                     torch.tensor(1.0, device=cuda), compute_dtype)
    assert all(float(t.abs().max()) == 0.0 for t in grads)


def test_simmim_tc_nan_in_a_zero_weight_token_reaches_loss_and_dkernel(cuda):
    """The tensor-core forms compute every token: a NaN in a token of
    weight 0 makes the loss NaN and every entry of its block's d kernel,
    as in the plain version; the other blocks' gradients stay finite and
    agree with it."""
    b, g, p, n, d = 4, 3, 10, 64, 96
    args = list(_simmim_args(np.random.default_rng(17), b, g, p, n, d, cuda, torch.bfloat16))
    assert fused_simmim._tc_form(torch.bfloat16, p, d) and float(args[4][0].abs().max()) == 0.0
    args[0][0, 1, 5, 7] = float("nan")  # row 0 has weight 0 everywhere
    assert torch.isnan(fused_simmim._launch(*args, torch.bfloat16))
    gout = torch.tensor(1e-3, device=cuda)
    denc, dkern, dbias = fused_simmim._launch_bwd(*args, gout, torch.bfloat16)
    _, want_kern, _ = fused_simmim.fused_decode_l1_reference_bwd(*args, gout, torch.bfloat16)
    assert torch.isnan(dkern[1]).all() and torch.isnan(want_kern[1]).all()
    assert torch.isnan(dbias[1]).all() and torch.isnan(denc[0, 1, 5]).all()
    for i in (0, 2):
        assert torch.isfinite(dkern[i]).all()
        assert _rel_to_max(dkern[i], want_kern[i]) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("g", [20, 5])
@pytest.mark.parametrize("enc_dtype,compute_dtype", SIMMIM_DTYPES[:2])
def test_simmim_kernels_are_deterministic(cuda, enc_dtype, compute_dtype, g):
    """Two calls give the same bits in both forms, at the EnMAP and
    Houston2018 shapes."""
    args = _simmim_args(np.random.default_rng(15), 64, g, 10, 64, 96, cuda, enc_dtype)
    gout = torch.tensor(3e-4, device=cuda)
    assert torch.equal(fused_simmim._launch(*args, compute_dtype),
                       fused_simmim._launch(*args, compute_dtype))
    first = fused_simmim._launch_bwd(*args, gout, compute_dtype)
    second = fused_simmim._launch_bwd(*args, gout, compute_dtype)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def test_simmim_wrapper_refusals_and_autograd(cuda):
    args = list(_simmim_args(np.random.default_rng(16), 2, 3, 4, 9, 16, cuda))
    with pytest.raises(ValueError, match="B == 0"):
        fused_simmim.fused_decode_l1(args[0][:0], args[1][:0], args[2], args[3], args[4][:0],
                                     torch.float32)
    with pytest.raises(TypeError, match="fp32/bf16"):
        fused_simmim.fused_decode_l1(args[0].half(), *args[1:], torch.float32)
    with pytest.raises(ValueError, match="weights must be"):
        fused_simmim.fused_decode_l1(*args[:4], args[4][:, :5], torch.float32)
    for i in (0, 2, 3):
        args[i].requires_grad_()
    fwd, bwd = fused_simmim.launches, fused_simmim.bwd_launches
    fused_simmim.fused_decode_l1(*args, torch.float32).backward()
    assert (fused_simmim.launches, fused_simmim.bwd_launches) == (fwd + 1, bwd + 1)
    assert all(args[i].grad is not None for i in (0, 2, 3))


@pytest.mark.parametrize("shape,seed,site,rate,base", [
    ((512, 128), 7, 1, 0.1, 0),  # the TPU check's sample
    ((1280, 8, 64, 64), 1064, fused_layer.SITE_ATTN, 0.1, 0),  # attention site, batch 64
    ((512, 128), 7, 1, 0.1, 2**32 + 12345),  # the hash's high-word branch
    ((3, 1000, 7), 2**31 + 5, 7, 0.5, 2**40 - 3000),  # a range across 2^40, ragged size
    ((129,), 3, 5, 0.0, 0),  # rate 0: every element kept at scale 1
])
def test_dropout_sample_kernel_matches_plain_bitwise(cuda, shape, seed, site, rate, base):
    got = dropout_sample.dropout_sample(torch.empty(shape, device=cuda), seed, site, rate, base)
    torch.cuda.synchronize()
    want = dropout_sample.dropout_sample_reference(got.numel(), seed, site, rate, base, cuda)
    assert torch.equal(got.reshape(-1), want)
    if base == 0:
        assert torch.equal(got, fused_layer.dropout_mask(shape, seed, site, rate, cuda))


def test_dropout_sample_kernel_is_deterministic_and_counted(cuda):
    before = dropout_sample.launches
    a = dropout_sample.dropout_sample(torch.empty(4096, device=cuda), 9, 3, 0.25, 2**33)
    b = dropout_sample.dropout_sample(torch.empty(4096, device=cuda), 9, 3, 0.25, 2**33)
    assert torch.equal(a, b) and dropout_sample.launches == before + 2


def test_dropout_sample_wrapper_refusals(cuda):
    with pytest.raises(TypeError, match="fp32"):
        dropout_sample.dropout_sample(torch.empty(8, device=cuda, dtype=torch.bfloat16), 1, 1, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        dropout_sample.dropout_sample(torch.empty(8, 8, device=cuda).t(), 1, 1, 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dropout_sample._launch(torch.empty(8), 1, 1, 0.1)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        dropout_sample.dropout_sample(torch.empty(8, device=cuda), 1, 1, 1.0)
