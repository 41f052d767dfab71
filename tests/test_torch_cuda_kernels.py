"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip. Run them on
the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``--noconftest``: the suite's conftest.py imports JAX, which a GPU host
need not have.)

They cover what the shapes in chip_smoke.py do not: batches that leave a
kernel block part-empty, narrow widths, the identity projection, mixed
input and compute types, both forms of the layer forward (tensor cores for
bf16 compute at widths that are multiples of 16, FMA loops otherwise),
dropout, the backward kernels, the masks each kernel applies read bit for
bit (ops/dropout_probe.py), the gradients' run-to-run determinism, and the
wrappers' refusals.

Tolerances on max |kernel - plain| / max(1, |plain|): fp32 1e-4 (summation
order and fast intrinsics only), bf16 3e-2 (both round every product
operand to bf16 at the same points, but a one-ulp difference before a
rounding flips a bf16 value, 2^-8 relative, and the output itself may be
bf16). Forward outputs are held elementwise, gradients per tensor
(relative to max(1, max|plain|)).
"""

import numpy as np
import pytest
import torch

from maskedsst_tpu_torch.ops import dropout_probe, fused_embed, fused_layer
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


def _embed_args(rng, b, g, p, n, d, device, in_dtype=torch.float32):
    def r(*shape, base=0.0, scale=0.1):
        return torch.from_numpy((base + scale * rng.standard_normal(shape)).astype(np.float32))

    patches = r(b, g, p, n, scale=1.0).to(in_dtype)
    mask = torch.from_numpy((rng.random((b, g, n)) < 0.7).astype(np.float32))
    args = (patches, mask, r(p, base=1.0), r(p), r(g, p, d, scale=p**-0.5), r(g, d),
            r(d, base=1.0), r(d), r(g, n, d, scale=1.0), r(d, scale=1.0))
    return tuple(a.to(device) for a in args)


@pytest.mark.parametrize("b,g,p,n,d", [(3, 20, 10, 64, 96), (2, 5, 10, 64, 96), (2, 3, 4, 9, 16)])
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


def test_layer_autograd_routes_to_the_kernels(cuda):
    rng = np.random.default_rng(9)
    params = LayerParams(*(t.requires_grad_() for t in _layer_params(rng, 16, 2, 8, 12, cuda)))
    x = torch.randn(4, 8, 16, device=cuda, requires_grad=True)
    fwd, bwd = fused_layer.launches, fused_layer.bwd_launches
    fused_layer.fused_transformer_layer(x, params, 2, 8, torch.float32, 0.1, True, 1).sum().backward()
    assert (fused_layer.launches, fused_layer.bwd_launches) == (fwd + 1, bwd + 1)
    assert x.grad is not None and all(t.grad is not None for t in params)


@pytest.mark.parametrize("b,g,p,n,d", [(3, 20, 10, 64, 96), (2, 5, 10, 64, 96), (2, 3, 4, 9, 16),
                                       (300, 2, 4, 9, 16)])
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


def test_embed_bwd_gradients_are_deterministic(cuda):
    args = _embed_args(np.random.default_rng(11), 64, 20, 10, 64, 96, cuda)
    dtok = torch.randn(64, 20, 64, 96, device=cuda)
    first = fused_embed._launch_bwd(*args, dtok, torch.float32)
    second = fused_embed._launch_bwd(*args, dtok, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_embed_autograd_routes_to_the_kernels(cuda):
    args = list(_embed_args(np.random.default_rng(12), 2, 3, 4, 9, 16, cuda))
    for i in range(2, 10):
        args[i].requires_grad_()
    fwd, bwd = fused_embed.launches, fused_embed.bwd_launches
    fused_embed.fused_embed_mask(*args, torch.float32).sum().backward()
    assert (fused_embed.launches, fused_embed.bwd_launches) == (fwd + 1, bwd + 1)
    assert all(a.grad is not None for a in args[2:])
