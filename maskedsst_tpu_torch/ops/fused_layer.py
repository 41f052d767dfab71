"""Fused pre-norm transformer layer, forward and backward: CUDA kernels and
plain versions.

One layer per call, x [B, S, D] → [B, S, D] in x's dtype: LN1 → QKV (no
bias) → softmax attention per head (+ dropout) → out-projection + bias
(+ dropout) → residual → LN2 → fc1 + b1 → exact GELU (+ dropout) → fc2 + b2
(+ dropout) → residual.

``fused_transformer_layer`` is a ``torch.autograd.Function`` that picks the
implementation by the tensor's device: a CPU tensor goes to
:func:`reference_layer` forward and :func:`reference_layer_bwd` backward,
the plain PyTorch versions; a CUDA tensor launches ``csrc/fused_layer_fwd.cu``
and ``csrc/fused_layer_bwd.cu`` or raises. The kernels replace the TPU
kernels ``maskedsst_tpu/ops/fused_layer.py::_layer_fwd_kernel`` and
``_layer_bwd_kernel`` and keep their numeric contract: LN eps 1e-5 with fp32
statistics, every matmul operand rounded to ``compute_dtype`` with fp32
accumulation, fp32 softmax, erf GELU, an fp32 residual stream, parameter
gradients accumulated in fp32. The attention scale ``dim_head**-0.5`` is
folded into the Q weights before the cast, as on the TPU, and undone on
the Q block of the QKV gradient.

Dropout (``train`` and ``dropout_rate > 0``) at the TPU kernel's four sites,
with the keep rule ``bits >= rate * 2**32`` and kept values scaled by
``1 / (1 - rate)``. The TPU drew its bits from the hardware PRNG per grid
block, which cannot be reproduced; here the bits come from a counter-based
hash keyed by the layer seed and the site and counted by the element's
logical index in the site's tensor (:func:`dropout_mask`), so both kernels
and the plain versions give the same bits whatever block size each uses.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
_FWD = "fused_layer_fwd"
_BWD = "fused_layer_bwd"
_SUPPORTED = (torch.float32, torch.bfloat16)

# dropout site ids, as in the TPU kernel
SITE_ATTN = 1  # attention probabilities [B, H, S, S]
SITE_PROJ = 3  # projection output [B, S, D]
SITE_FF_MID = 5  # GELU output [B, S, F]
SITE_FF_OUT = 7  # MLP output [B, S, D]

# kernel launches since the count was last set to 0 (plain-version calls
# are not counted): forward, backward
launches = 0
bwd_launches = 0


class LayerParams(NamedTuple):
    """One layer's weights; [D]=dim, [I]=heads*dim_head, [F]=mlp dim."""

    ln1_scale: torch.Tensor  # [D]
    ln1_bias: torch.Tensor  # [D]
    wqkv: torch.Tensor  # [D, 3*I]
    wout: torch.Tensor  # [I, D]
    bout: torch.Tensor  # [D]
    ln2_scale: torch.Tensor  # [D]
    ln2_bias: torch.Tensor  # [D]
    w1: torch.Tensor  # [D, F]
    b1: torch.Tensor  # [F]
    w2: torch.Tensor  # [F, D]
    b2: torch.Tensor  # [D]


class LayerConfig(NamedTuple):
    """Everything of a layer call but its tensors."""

    heads: int
    dim_head: int
    compute_dtype: torch.dtype = torch.bfloat16
    dropout_rate: float = 0.0
    train: bool = False
    seed: int = 0
    proj_dropout: bool = True

    @property
    def dropout_on(self) -> bool:
        return self.train and self.dropout_rate > 0.0


def fused_transformer_layer(
    x: torch.Tensor,
    params: LayerParams,
    heads: int,
    dim_head: int,
    compute_dtype: torch.dtype = torch.bfloat16,
    dropout_rate: float = 0.0,
    train: bool = False,
    seed: int = 0,
    proj_dropout: bool = True,
) -> torch.Tensor:
    """x [B, S, D] → layer output [B, S, D] (dtype of x), differentiable in x
    and every parameter.

    ``seed``: the layer's dropout seed (used only when ``train`` and
    ``dropout_rate > 0``; the model passes base + layer index, as the JAX
    package does). ``proj_dropout=False`` skips the post-projection site
    (no projection when heads == 1 and dim_head == dim)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_transformer_layer: unsupported device {x.device}")
    cfg = _config(x, heads, dim_head, compute_dtype, dropout_rate, train, seed, proj_dropout)
    return _LayerFn.apply(x.device.type == "cpu", cfg, x, *params)


def plain_transformer_layer(x, params, heads, dim_head, compute_dtype=torch.bfloat16,
                            dropout_rate=0.0, train=False, seed=0, proj_dropout=True):
    """The same differentiable layer through the plain versions on any
    device (the reference the card's kernels are held to)."""
    cfg = _config(x, heads, dim_head, compute_dtype, dropout_rate, train, seed, proj_dropout)
    return _LayerFn.apply(True, cfg, x, *params)


def _config(x, heads, dim_head, compute_dtype, dropout_rate, train, seed, proj_dropout):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if x.shape[0] == 0:
        raise ValueError("fused_transformer_layer: empty batch (B == 0)")
    return LayerConfig(heads, dim_head, compute_dtype, float(dropout_rate), bool(train),
                       int(seed), bool(proj_dropout))


class _LayerFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plain: bool, cfg: LayerConfig, x: torch.Tensor, *tensors):
        params = LayerParams(*tensors)
        y = reference_layer(x, params, *cfg) if plain else _launch(x, params, *cfg)
        ctx.save_for_backward(x, *tensors)
        ctx.plain, ctx.cfg = plain, cfg
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *tensors = ctx.saved_tensors
        params = LayerParams(*tensors)
        if ctx.plain:
            dx, grads = reference_layer_bwd(x, dy, params, *ctx.cfg)
        else:
            dx, grads = _launch_bwd(x, dy.contiguous(), params, *ctx.cfg)
        return (None, None, dx, *(g.to(t.dtype) for g, t in zip(grads, tensors)))


# ---------------------------------------------------------------------------
# dropout masks

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_bits(numel: int, seed: int, site: int, device=None) -> torch.Tensor:
    """uint32 bits (as int64) of elements 0..numel-1 of a site's tensor:
    ``fmix32(fmix32(lo ^ key) + key)`` with ``key = fmix32(seed ^
    fmix32(site * 0x9E3779B9 + hi * 0x632BE5AB + 0x7F4A7C15))``, lo/hi the
    index's 32-bit halves — the arithmetic of ``drop_mult`` in
    ``csrc/common.cuh``."""
    return hash_bits(torch.arange(numel, dtype=torch.int64, device=device), seed, site)


def hash_bits(idx: torch.Tensor, seed: int, site: int) -> torch.Tensor:
    """The bits of :func:`dropout_bits` at the int64 logical indices idx."""
    lo, hi = idx & _M32, idx >> 32
    inner = (_mul32(torch.full_like(idx, site & _M32), 0x9E3779B9)
             + _mul32(hi, 0x632BE5AB) + 0x7F4A7C15) & _M32
    key = _fmix32((seed & _M32) ^ _fmix32(inner))
    return _fmix32((_fmix32(lo ^ key) + key) & _M32)


def dropout_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to fp32, the multiplier of a kept value."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def dropout_threshold(rate: float) -> int:
    return int(rate * 2**32)


def dropout_mask(shape, seed: int, site: int, rate: float, device=None) -> torch.Tensor:
    """fp32 multiplier (0 or 1/(1-rate)) for a site's tensor of ``shape``."""
    numel = 1
    for n in shape:
        numel *= n
    keep = dropout_bits(numel, seed, site, device) >= dropout_threshold(rate)
    return (keep.to(torch.float32) * dropout_scale(rate)).reshape(shape)


# ---------------------------------------------------------------------------
# plain versions


def _rc(t: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype and widen back to fp32: a matmul operand
    as the kernel sees it (the product then accumulates in fp32)."""
    return t.to(compute_dtype).float()


def _ln_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """(LN output, z, rsig) over the last axis in fp32, two-pass variance."""
    mu = x.mean(dim=-1, keepdim=True)
    rsig = torch.rsqrt(((x - mu) ** 2).mean(dim=-1, keepdim=True) + LN_EPS)
    z = (x - mu) * rsig
    return z * scale.float() + bias.float(), z, rsig


def _ln_bwd(dout, z, rsig, scale):
    dz = dout * scale.float()
    dx = rsig * (dz - dz.mean(dim=-1, keepdim=True) - z * (dz * z).mean(dim=-1, keepdim=True))
    return dx, (dout * z).sum(dim=0), dout.sum(dim=0)


def _gelu_grad(u: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(u * 2.0**-0.5)) + u * torch.exp(-0.5 * u * u) * (2 * torch.pi) ** -0.5


def scaled_wqkv(wqkv: torch.Tensor, dim_head: int) -> torch.Tensor:
    """[D, 3I] QKV weights in fp32 with the attention scale folded into the
    Q block (the cast to the compute dtype comes after)."""
    i = wqkv.shape[1] // 3
    w = wqkv.float().clone()
    w[:, :i] *= dim_head**-0.5
    return w


def _masks(cfg: LayerConfig, b: int, s: int, d: int, f: int, device):
    """The four sites' multipliers (None where the site is off)."""
    if not cfg.dropout_on:
        return None, None, None, None

    def mk(shape, site):
        return dropout_mask(shape, cfg.seed, site, cfg.dropout_rate, device)

    return (
        mk((b, cfg.heads, s, s), SITE_ATTN),
        mk((b * s, d), SITE_PROJ) if cfg.proj_dropout else None,
        mk((b * s, f), SITE_FF_MID),
        mk((b * s, d), SITE_FF_OUT),
    )


def _mul(t, m):
    return t if m is None else t * m


def _forward(x, params: LayerParams, cfg: LayerConfig):
    """The plain forward with every intermediate the backward needs."""
    b, s, d = x.shape
    heads, dh, cd = cfg.heads, cfg.dim_head, cfg.compute_dtype
    inner, f = heads * dh, params.w1.shape[1]
    m1, m3, m5, m7 = _masks(cfg, b, s, d, f, x.device)
    x0 = x.float().reshape(b * s, d)
    h1, z1, rsig1 = _ln_stats(x0, params.ln1_scale, params.ln1_bias)
    wq = scaled_wqkv(params.wqkv, dh)
    qkv = _rc(h1, cd) @ _rc(wq, cd)
    q, k, v = (_rc(t, cd).reshape(b, s, heads, dh).transpose(1, 2)
               for t in qkv.split(inner, dim=-1))  # [B, H, S, dh]
    a = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    a_d = _mul(a, m1)
    o = (_rc(a_d, cd) @ v).transpose(1, 2).reshape(b * s, inner)
    p1 = _mul(_rc(o, cd) @ _rc(params.wout, cd) + params.bout.float(), m3)
    x1 = x0 + p1
    h2, z2, rsig2 = _ln_stats(x1, params.ln2_scale, params.ln2_bias)
    u = _rc(h2, cd) @ _rc(params.w1, cd) + params.b1.float()
    gd = _mul(F.gelu(u), m5)
    ff = _mul(_rc(gd, cd) @ _rc(params.w2, cd) + params.b2.float(), m7)
    y = (x1 + ff).reshape(b, s, d).to(x.dtype)
    saved = dict(h1=h1, z1=z1, rsig1=rsig1, wq=wq, q=q, k=k, v=v, a=a, a_d=a_d, o=o,
                 z2=z2, rsig2=rsig2, h2=h2, u=u, gd=gd, masks=(m1, m3, m5, m7))
    return y, saved


def reference_layer(
    x: torch.Tensor,
    params: LayerParams,
    heads: int,
    dim_head: int,
    compute_dtype: torch.dtype = torch.bfloat16,
    dropout_rate: float = 0.0,
    train: bool = False,
    seed: int = 0,
    proj_dropout: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the layer forward: the kernel's math with
    the same roundings and the same dropout bits, in fp32 products. Output
    in x's dtype; differentiable by torch autograd."""
    cfg = LayerConfig(heads, dim_head, compute_dtype, dropout_rate, train, seed, proj_dropout)
    return _forward(x, params, cfg)[0]


def reference_layer_bwd(
    x: torch.Tensor,
    dy: torch.Tensor,
    params: LayerParams,
    heads: int,
    dim_head: int,
    compute_dtype: torch.dtype = torch.bfloat16,
    dropout_rate: float = 0.0,
    train: bool = False,
    seed: int = 0,
    proj_dropout: bool = True,
):
    """Plain PyTorch version of the layer backward, written out as the TPU
    kernel computes it (``_layer_bwd_kernel``): every product operand
    rounded to the compute dtype where that kernel casts it, the attention
    gradient ``ds = (da - sum(da a)) a`` on the undropped ``a`` with ``da =
    da_d * mask``. Returns (dx in x's dtype, LayerParams of fp32 grads)."""
    cfg = LayerConfig(heads, dim_head, compute_dtype, dropout_rate, train, seed, proj_dropout)
    b, s, d = x.shape
    cd, inner = compute_dtype, heads * dim_head
    _, sv = _forward(x, params, cfg)
    m1, m3, m5, m7 = sv["masks"]
    dyf = dy.float().reshape(b * s, d)

    dp2 = _mul(dyf, m7)
    db2 = dp2.sum(dim=0)
    dw2 = _rc(sv["gd"], cd).t() @ _rc(dp2, cd)
    dg = _mul(_rc(dp2, cd) @ _rc(params.w2, cd).t(), m5)
    du = dg * _gelu_grad(sv["u"])
    db1 = du.sum(dim=0)
    dw1 = _rc(sv["h2"], cd).t() @ _rc(du, cd)
    dh2 = _rc(du, cd) @ _rc(params.w1, cd).t()
    dx1_ln, dln2s, dln2b = _ln_bwd(dh2, sv["z2"], sv["rsig2"], params.ln2_scale)
    dx1 = dyf + dx1_ln

    dp1 = _mul(dx1, m3)
    dbout = dp1.sum(dim=0)
    dwout = _rc(sv["o"], cd).t() @ _rc(dp1, cd)
    dO = (_rc(dp1, cd) @ _rc(params.wout, cd).t()).reshape(b, s, heads, dim_head).transpose(1, 2)
    q, k, v, a, a_d = sv["q"], sv["k"], sv["v"], sv["a"], sv["a_d"]
    da = _mul(_rc(dO, cd) @ v.transpose(-1, -2), m1)
    dv = _rc(a_d, cd).transpose(-1, -2) @ _rc(dO, cd)
    ds = (da - (da * a).sum(dim=-1, keepdim=True)) * a
    dq = _rc(ds, cd) @ k
    dk = _rc(ds, cd).transpose(-1, -2) @ q

    def flat(t):  # [B, H, S, dh] → [B*S, I]
        return t.transpose(1, 2).reshape(b * s, inner)

    dqkv = torch.cat([flat(dq), flat(dk), flat(dv)], dim=-1)
    dwqkv = _rc(sv["h1"], cd).t() @ _rc(dqkv, cd)
    dwqkv[:, :inner] *= dim_head**-0.5
    dh1 = _rc(dqkv, cd) @ _rc(sv["wq"], cd).t()
    dx0_ln, dln1s, dln1b = _ln_bwd(dh1, sv["z1"], sv["rsig1"], params.ln1_scale)
    dx = (dx1 + dx0_ln).reshape(b, s, d).to(x.dtype)
    return dx, LayerParams(dln1s, dln1b, dwqkv, dwout, dbout, dln2s, dln2b, dw1, db1, dw2, db2)


# ---------------------------------------------------------------------------
# kernel launches


@functools.lru_cache(maxsize=None)
def _bind(name: str):
    from maskedsst_tpu_torch.ops import _build

    lib = _build.load(name)
    if name == _FWD:
        return lib, _build.bind(lib, name, n_pointers=13, n_ints=12, n_floats=1)
    fn = _build.bind(lib, name, n_pointers=16, n_ints=13, n_floats=1)
    lib.fused_layer_bwd_grad_count.argtypes = [ctypes.c_int] * 3
    lib.fused_layer_bwd_grad_count.restype = ctypes.c_longlong
    return lib, fn


def _i32(v: int) -> int:
    """A uint32 value as the int with the same bits (the C side reads it back)."""
    v &= _M32
    return v - 2**32 if v >= 2**31 else v


def _drop_args(cfg: LayerConfig):
    on = cfg.dropout_on
    return (int(on), int(cfg.proj_dropout), _i32(cfg.seed) if on else 0,
            _i32(dropout_threshold(cfg.dropout_rate)) if on else 0,
            dropout_scale(cfg.dropout_rate) if on else 1.0)


def _check(x, params, cfg: LayerConfig, name: str):
    if x.dtype not in _SUPPORTED or cfg.compute_dtype not in _SUPPORTED:
        raise TypeError(f"{name} takes fp32/bf16, got x {x.dtype}, compute {cfg.compute_dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [B, S, D], got {tuple(x.shape)}")
    b, s, d = x.shape
    inner = cfg.heads * cfg.dim_head
    f = params.w1.shape[1]
    expect = {
        "ln1_scale": (d,), "ln1_bias": (d,), "wqkv": (d, 3 * inner), "wout": (inner, d),
        "bout": (d,), "ln2_scale": (d,), "ln2_bias": (d,), "w1": (d, f), "b1": (f,),
        "w2": (f, d), "b2": (d,),
    }
    for pname, shape in expect.items():
        t = getattr(params, pname)
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(
                f"{name}: {pname} must be {shape} on {x.device}, got {tuple(t.shape)} on {t.device}"
            )
    return b, s, d, inner, f


def _kernel_weights(params: LayerParams, cfg: LayerConfig):
    """The weights as the kernels take them: matrices in the compute dtype
    (the q block pre-scaled), vectors in fp32, all contiguous."""

    def vec(t):
        return t.float().contiguous()

    def mat(t):
        return t.to(cfg.compute_dtype).contiguous()

    return (
        vec(params.ln1_scale), vec(params.ln1_bias),
        mat(scaled_wqkv(params.wqkv, cfg.dim_head)), mat(params.wout), vec(params.bout),
        vec(params.ln2_scale), vec(params.ln2_bias),
        mat(params.w1), vec(params.b1), mat(params.w2), vec(params.b2),
    )


def _flags(x, cfg):
    return int(x.dtype == torch.bfloat16), int(cfg.compute_dtype == torch.bfloat16)


def _launch(x, params, *config):
    """Forward kernel; ``config`` as the fields of LayerConfig."""
    global launches
    from maskedsst_tpu_torch.ops import _build

    cfg = LayerConfig(*config)
    b, s, d, _, f = _check(x, params, cfg, _FWD)
    args = _kernel_weights(params, cfg)  # kept referenced until the launch is enqueued
    y = torch.empty_like(x)
    lib, fn = _bind(_FWD)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), y.data_ptr(), *(a.data_ptr() for a in args),
            b, s, d, cfg.heads, cfg.dim_head, f, *_flags(x, cfg), *_drop_args(cfg),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, _FWD, code)
    launches += 1
    return y


def seqs_per_block(s: int) -> int:
    """Whole sequences a kernel block owns (up to 64 rows), as in the kernels."""
    return 1 if s >= 64 else 64 // s


def _launch_bwd(x, dy, params, *config):
    """Backward kernel → (dx in x's dtype, LayerParams of fp32 grads);
    ``config`` as the fields of LayerConfig."""
    global bwd_launches
    from maskedsst_tpu_torch.ops import _build

    cfg = LayerConfig(*config)
    b, s, d, inner, f = _check(x, params, cfg, _BWD)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"{_BWD}: dy must match x {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    args = _kernel_weights(params, cfg)
    lib, fn = _bind(_BWD)
    count = int(lib.fused_layer_bwd_grad_count(d, inner, f))
    nblocks = -(-b // seqs_per_block(s))
    nparts = min(nblocks, torch.cuda.get_device_properties(x.device).multi_processor_count)
    ws = torch.empty((nparts, count), dtype=torch.float32, device=x.device)
    grads = torch.empty(count, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *(a.data_ptr() for a in args),
            ws.data_ptr(), grads.data_ptr(),
            b, s, d, cfg.heads, cfg.dim_head, f, *_flags(x, cfg), nparts, *_drop_args(cfg),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, _BWD, code)
    bwd_launches += 1
    sizes = [d, d, d * 3 * inner, inner * d, d, d, d, d * f, f, f * d, d]
    parts = list(grads.split(sizes))
    shapes = [t.shape for t in params]
    out = LayerParams(*(p.view(sh) for p, sh in zip(parts, shapes)))
    out.wqkv[:, :inner] *= cfg.dim_head**-0.5  # the folded q scale
    return dx, out
