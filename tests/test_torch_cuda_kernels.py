"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip. Run them on
the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``--noconftest``: the suite's conftest.py imports JAX, which a GPU host
need not have.)

They cover what the serving shapes in chip_smoke.py do not: batches that
leave a kernel block part-empty, narrow widths, the identity projection,
mixed input and compute types, both forms of the layer kernel (tensor cores
for bf16 compute at widths that are multiples of 16, FMA loops otherwise),
and the wrappers' refusals.

Tolerances on max |kernel - plain| / max(1, |plain|): fp32 1e-4 (summation
order and fast intrinsics only), bf16 3e-2 (both round every product
operand to bf16 at the same points, but a one-ulp difference before a
rounding flips a bf16 value, 2^-8 relative, and the output itself may be
bf16).
"""

import numpy as np
import pytest
import torch

from maskedsst_tpu_torch.ops import fused_embed, fused_layer
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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fused_layer.fused_transformer_layer(x, params, 2, 8, torch.float32, 0.1, True)


def test_embed_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    args = list(_embed_args(np.random.default_rng(3), 2, 3, 4, 9, 16, cuda))
    with pytest.raises(TypeError, match="fp32/bf16"):
        fused_embed.fused_embed_mask(*args, torch.float16)
    args[8] = args[8][:1]
    with pytest.raises(ValueError, match="pos must be"):
        fused_embed.fused_embed_mask(*args, torch.float32)
