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
and ``csrc/fused_layer_bwd.cu`` or raises (a geometry whose buffers do not
fit the card's shared memory, even with some moved to a device scratch,
raises a ValueError that names it: :func:`launch_plan`). In bf16 at widths that are
multiples of 16 the backward is split: the row kernel of
``fused_layer_bwd.cu`` (:func:`layer_bwd_rows`), started from the residual
stream x1 that the training forward saved, then the weight-gradient kernel
``csrc/layer_wgrad.cu`` (:mod:`~maskedsst_tpu_torch.ops.layer_wgrad`).
The kernels replace the TPU kernels
``maskedsst_tpu/ops/fused_layer.py::_layer_fwd_kernel`` and
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
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from maskedsst_tpu_torch.ops import layer_wgrad

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
    plain = x.device.type == "cpu"
    # the tensor-core backward starts from the forward's x1; a call that no
    # gradient will reach (serving, validation) writes none
    save_x1 = (not plain and torch.is_grad_enabled()
               and any(t.requires_grad for t in (x, *params))
               and _tc_form(cfg, *x.shape[1:], params.w1.shape[1]))
    return _LayerFn.apply(plain, save_x1, cfg, x, *params)


def plain_transformer_layer(x, params, heads, dim_head, compute_dtype=torch.bfloat16,
                            dropout_rate=0.0, train=False, seed=0, proj_dropout=True):
    """The same differentiable layer through the plain versions on any
    device (the reference the card's kernels are held to)."""
    cfg = _config(x, heads, dim_head, compute_dtype, dropout_rate, train, seed, proj_dropout)
    return _LayerFn.apply(True, False, cfg, x, *params)


def _config(x, heads, dim_head, compute_dtype, dropout_rate, train, seed, proj_dropout):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if x.shape[0] == 0:
        raise ValueError("fused_transformer_layer: empty batch (B == 0)")
    return LayerConfig(heads, dim_head, compute_dtype, float(dropout_rate), bool(train),
                       int(seed), bool(proj_dropout))


class _LayerFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plain: bool, save_x1: bool, cfg: LayerConfig, x: torch.Tensor, *tensors):
        params = LayerParams(*tensors)
        x1 = torch.empty(x.shape, dtype=torch.float32, device=x.device) if save_x1 else None
        y = reference_layer(x, params, *cfg) if plain else _launch(x, params, *cfg, x1=x1)
        ctx.save_for_backward(x, x1, *tensors)
        ctx.plain, ctx.cfg = plain, cfg
        return y

    @staticmethod
    def backward(ctx, dy):
        x, x1, *tensors = ctx.saved_tensors
        params = LayerParams(*tensors)
        if ctx.plain:
            dx, grads = reference_layer_bwd(x, dy, params, *ctx.cfg)
        else:
            dx, grads = _launch_bwd(x, dy.contiguous(), params, *ctx.cfg, x1=x1)
        return (None, None, None, dx, *(g.to(t.dtype) for g, t in zip(grads, tensors)))


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
    """(the LN input's gradient, the per-row terms of the scale's gradient)."""
    dz = dout * scale.float()
    dx = rsig * (dz - dz.mean(dim=-1, keepdim=True) - z * (dz * z).mean(dim=-1, keepdim=True))
    return dx, dout * z


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
    saved = dict(h1=h1, z1=z1, rsig1=rsig1, wq=wq, q=q, k=k, v=v, a=a, a_d=a_d, o=o, x1=x1,
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


def reference_x1(x: torch.Tensor, params: LayerParams, *config) -> torch.Tensor:
    """The plain residual stream after attention, x + the dropped
    projection, fp32 [B, S, D]: what the tensor-core forward's training call
    writes to x1. ``config`` as the fields of LayerConfig."""
    return _forward(x, params, LayerConfig(*config))[1]["x1"].reshape(x.shape)


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
    dx, ops, rows = _bwd_terms(x, dy, params, cfg)
    grads = {k: t.sum(dim=0) for k, t in rows.items()}
    for name, left, right in layer_wgrad.PRODUCTS:
        grads[name] = _rc(ops[left], compute_dtype).t() @ _rc(ops[right], compute_dtype)
    grads["wqkv"][:, :heads * dim_head] *= dim_head**-0.5
    return dx, LayerParams(**grads)


def _bwd_terms(x, dy, params: LayerParams, cfg: LayerConfig):
    """The plain backward short of its sums over rows: (dx in x's dtype, the
    weight gradients' operands by layer_wgrad.OPERANDS name, [B*S, C] fp32
    before their rounding to the compute dtype, the small vectors' per-row
    terms by LayerParams name, [B*S, C] fp32)."""
    b, s, d = x.shape
    cd, heads, dim_head = cfg.compute_dtype, cfg.heads, cfg.dim_head
    inner = heads * dim_head
    _, sv = _forward(x, params, cfg)
    m1, m3, m5, m7 = sv["masks"]
    dyf = dy.float().reshape(b * s, d)

    dp2 = _mul(dyf, m7)
    dg = _mul(_rc(dp2, cd) @ _rc(params.w2, cd).t(), m5)
    du = dg * _gelu_grad(sv["u"])
    dh2 = _rc(du, cd) @ _rc(params.w1, cd).t()
    dx1_ln, gz2 = _ln_bwd(dh2, sv["z2"], sv["rsig2"], params.ln2_scale)
    dx1 = dyf + dx1_ln

    dp1 = _mul(dx1, m3)
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
    dh1 = _rc(dqkv, cd) @ _rc(sv["wq"], cd).t()
    dx0_ln, gz1 = _ln_bwd(dh1, sv["z1"], sv["rsig1"], params.ln1_scale)
    dx = (dx1 + dx0_ln).reshape(b, s, d).to(x.dtype)
    ops = dict(h1=sv["h1"], dqkv=dqkv, o=sv["o"], dp1=dp1, h2=sv["h2"], du=du, gd=sv["gd"],
               dp2=dp2)
    rows = dict(ln1_scale=gz1, ln1_bias=dh1, bout=dp1, ln2_scale=gz2, ln2_bias=dh2, b1=du,
                b2=dp2)
    return dx, ops, rows


# the small vectors, in the order of the row kernel's per-block partials
SMALL = ("ln1_scale", "ln1_bias", "bout", "ln2_scale", "ln2_bias", "b1", "b2")


def layer_bwd_rows_reference(x, dy, params: LayerParams, *config, nparts: int):
    """Plain version of the tensor-core form's row kernel: (dx in x's dtype,
    the flat operand buffer of layer_wgrad.OPERANDS in the compute dtype,
    the small vectors' partials [nparts, 6D + F] in SMALL order). Kernel
    block p owns row blocks p, p + nparts, ... of seqs_per_block(S) whole
    sequences; its partial is their sum."""
    cfg = LayerConfig(*config)
    b, s, _ = x.shape
    dx, ops, rows = _bwd_terms(x, dy, params, cfg)
    buf = torch.cat([ops[k].to(cfg.compute_dtype).reshape(-1) for k in layer_wgrad.OPERANDS])
    terms = torch.cat([rows[k] for k in SMALL], dim=1)  # [B*S, 6D + F]
    seqs = seqs_per_block(s)
    nblocks = -(-b // seqs)
    per_seq = terms.view(b, s, -1).sum(dim=1)
    per_seq = torch.cat([per_seq, per_seq.new_zeros(nblocks * seqs - b, per_seq.shape[1])])
    per_block = per_seq.view(nblocks, seqs, -1).sum(dim=1)
    rounds = -(-nblocks // nparts)
    per_block = torch.cat([per_block,
                           per_block.new_zeros(rounds * nparts - nblocks, per_block.shape[1])])
    return dx, buf, per_block.view(rounds, nparts, -1).sum(dim=0)


# ---------------------------------------------------------------------------
# kernel launches


@functools.lru_cache(maxsize=None)
def _bind(name: str):
    from maskedsst_tpu_torch.ops import _build

    lib = _build.load(name)
    if name == _FWD:
        fn = _build.bind(lib, name, n_pointers=15, n_ints=13, n_floats=1)
        plan = lib.fused_layer_fwd_plan
        plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    else:
        fn = (_build.bind(lib, name, n_pointers=17, n_ints=14, n_floats=1),
              _build.bind(lib, name + "_tc", n_pointers=19, n_ints=13, n_floats=1))
        plan = lib.fused_layer_bwd_plan
        plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
    plan.restype = ctypes.c_int
    return lib, fn, plan


class Plan(NamedTuple):
    """Where a kernel launch keeps its buffers (``fused_layer_fwd_plan``,
    ``fused_layer_bwd_plan``): the plan's level (0: every buffer in shared
    memory, the row kernel's weights staged there; each level above moves
    one more buffer to a per-block scratch in device memory), its shared
    bytes, its scratch bytes per block, and the card's limit on a block's
    shared memory."""

    level: int
    shared_bytes: int
    scratch_bytes: int
    limit: int


# the forms a plan is asked for: the forward's FMA form, the backward's FMA
# form, the backward's row kernel
FORMS = {"fwd": "forward's FMA form", "bwd": "backward's FMA form", "rows": "row kernel"}


@functools.lru_cache(maxsize=None)
def _plan(form: str, s: int, d: int, dh: int, f: int, device: torch.device) -> Plan:
    from maskedsst_tpu_torch.ops import _build

    name = _FWD if form == "fwd" else _BWD
    lib, _, query = _bind(name)
    out = (ctypes.c_longlong * 4)()
    extra = () if form == "fwd" else (int(form == "rows"),)
    with torch.cuda.device(device):
        _build.check(lib, name + "_plan", query(s, d, dh, f, *extra, out))
    return Plan(*out)


def launch_plan(form: str, s: int, d: int, dh: int, f: int, device: torch.device) -> Plan:
    """The plan a launch of ``form`` (a key of FORMS) takes at this geometry
    on ``device``; a ValueError naming the geometry and the bytes when even
    its last level does not fit the card's shared memory."""
    plan = _plan(form, s, d, dh, f, torch.device(device))
    if plan.level < 0:
        raise ValueError(
            f"fused_layer: the {FORMS[form]} does not fit the card's shared memory at S {s}, "
            f"D {d}, dh {dh}, F {f}: its smallest plan takes {plan.shared_bytes} bytes a "
            f"block, the card allows {plan.limit}")
    return plan


def _scratch(plan: Plan, blocks: int, device) -> Optional[torch.Tensor]:
    """The plan's per-block device scratch for a grid of ``blocks`` blocks
    (None for a plan without one: no allocation on the main paths)."""
    if not plan.scratch_bytes:
        return None
    return torch.empty(blocks * plan.scratch_bytes, dtype=torch.uint8, device=device)


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's address for a C entry; null for None."""
    return None if t is None else t.data_ptr()


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
    for pname, shape in layer_wgrad.grad_shapes(d, inner, f).items():
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


def _launch(x, params, *config, x1=None):
    """Forward kernel; ``config`` as the fields of LayerConfig. ``x1``: an
    fp32 tensor shaped as x that receives the residual stream after
    attention (the tensor-core form only), or None."""
    global launches
    from maskedsst_tpu_torch.ops import _build

    cfg = LayerConfig(*config)
    b, s, d, _, f = _check(x, params, cfg, _FWD)
    level, scratch = 0, None
    if not _tc_form(cfg, s, d, f):
        plan = launch_plan("fwd", s, d, cfg.dim_head, f, x.device)
        level, scratch = plan.level, _scratch(plan, -(-b // seqs_per_block(s)), x.device)
    args = _kernel_weights(params, cfg)  # kept referenced until the launch is enqueued
    y = torch.empty_like(x)
    lib, fn, _ = _bind(_FWD)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), y.data_ptr(), None if x1 is None else x1.data_ptr(),
            *(a.data_ptr() for a in args), _ptr(scratch),
            b, s, d, cfg.heads, cfg.dim_head, f, *_flags(x, cfg), level, *_drop_args(cfg),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, _FWD, code)
    launches += 1
    return y


def seqs_per_block(s: int) -> int:
    """Whole sequences a kernel block owns (up to 64 rows), as in the kernels."""
    return 1 if s >= 64 else 64 // s


def _tc_form(cfg: LayerConfig, s: int, d: int, f: int) -> bool:
    """Whether the layer takes the tensor-core forms (the forward's, then the
    backward's row kernel and layer_wgrad) rather than the FMA forms: bf16
    compute at widths that are multiples of 16, within the tensor-core
    forward's register tiles (``tc_widths`` in ``csrc/fused_layer_fwd.cu``):
    D and F at most 128, dim_head at most 64, at most 128 rows a block.
    Every such geometry launches: past 64 rows the row kernel reads its
    weights from device memory and moves buffers to a device scratch until
    its shared memory fits (:func:`launch_plan`)."""
    dh = cfg.dim_head
    rows = -(-seqs_per_block(s) * s // 16) * 16
    return (cfg.compute_dtype == torch.bfloat16 and d % 16 == 0 and dh % 16 == 0
            and f % 16 == 0 and d <= 128 and dh <= 64 and f <= 128 and rows <= 128)


def _nparts(b: int, s: int, device: torch.device) -> int:
    """The backward's grid: one block per SM (132, an H100's, for the plain
    versions on the CPU), at most one per row block."""
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 132)
    return min(-(-b // seqs_per_block(s)), sms)


def _check_dy(x, dy, name):
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"{name}: dy must match x {tuple(x.shape)} {x.dtype}, got "
                         f"{tuple(dy.shape)} {dy.dtype}")


def layer_bwd_rows(x, dy, params, *config, x1=None):
    """The tensor-core form's row kernel → (dx in x's dtype, the flat operand
    buffer of layer_wgrad.OPERANDS, the flat fp32 gradient vector with the
    small vectors' entries written). A CPU tensor takes
    :func:`layer_bwd_rows_reference` (and sums its partials in order); a
    CUDA tensor launches ``csrc/fused_layer_bwd.cu``'s row kernel or
    raises. ``config`` as the fields of LayerConfig; ``x1``, the residual
    stream after attention that the forward kernel wrote for this x (None:
    a forward launch writes it first)."""
    global bwd_launches
    cfg = LayerConfig(*config)
    b, s, d, inner, f = _check(x, params, cfg, _BWD)
    _check_dy(x, dy, _BWD)
    nparts = _nparts(b, s, x.device)
    grads = torch.empty(layer_wgrad.grad_count(d, inner, f), dtype=torch.float32,
                        device=x.device)
    if x.device.type == "cpu":
        dx, ops, partials = layer_bwd_rows_reference(x, dy, params, *cfg, nparts=nparts)
        views = layer_wgrad.split_grads(grads, d, inner, f)
        for name, total in zip(SMALL, partials.sum(dim=0).split([views[k].numel() for k in SMALL])):
            views[name].copy_(total)
        return dx, ops, grads
    from maskedsst_tpu_torch.ops import _build

    if not _tc_form(cfg, s, d, f):
        raise ValueError(f"{_BWD}: the row kernel takes bf16 compute at the tensor-core widths "
                         f"(_tc_form), got {cfg.compute_dtype}, S {s}, D {d}, dh {cfg.dim_head}, "
                         f"F {f}")
    if x1 is None:
        x1 = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        _launch(x, params, *cfg, x1=x1)
    if x1.shape != x.shape or x1.dtype != torch.float32 or not x1.is_contiguous():
        raise ValueError(f"{_BWD}: x1 must be a contiguous fp32 {tuple(x.shape)}")
    plan = launch_plan("rows", s, d, cfg.dim_head, f, x.device)
    args = _kernel_weights(params, cfg)
    n = b * s
    ops = torch.empty(n * sum(layer_wgrad.operand_widths(d, inner, f).values()),
                      dtype=torch.bfloat16, device=x.device)
    ws = torch.empty((nparts, 6 * d + f), dtype=torch.float32, device=x.device)
    scratch = _scratch(plan, nparts, x.device)
    dx = torch.empty_like(x)
    lib, (_, fn), _ = _bind(_BWD)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), x1.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            *(a.data_ptr() for a in args), ops.data_ptr(), ws.data_ptr(), _ptr(scratch),
            grads.data_ptr(), b, s, d, cfg.heads, cfg.dim_head, f, _flags(x, cfg)[0], nparts,
            plan.level, *_drop_args(cfg), ctypes.c_void_p(stream),
        )
    _build.check(lib, _BWD, code)
    bwd_launches += 1
    return dx, ops, grads


def layer_bwd_split(x, dy, params, *config, x1=None):
    """The tensor-core form's backward: :func:`layer_bwd_rows`, then
    :func:`~maskedsst_tpu_torch.ops.layer_wgrad.layer_wgrad` → (dx in x's
    dtype, LayerParams of fp32 grads). Kernels on a CUDA tensor, their plain
    versions on a CPU one."""
    cfg = LayerConfig(*config)
    b, s, d = x.shape
    inner, f = cfg.heads * cfg.dim_head, params.w1.shape[1]
    dx, ops, grads = layer_bwd_rows(x, dy, params, *cfg, x1=x1)
    layer_wgrad.layer_wgrad(ops, b * s, d, inner, f, grads)
    return dx, _unflatten(grads, d, inner, f, cfg.dim_head)


def _unflatten(grads, d, inner, f, dim_head) -> LayerParams:
    out = LayerParams(**layer_wgrad.split_grads(grads, d, inner, f))
    out.wqkv[:, :inner] *= dim_head**-0.5  # the folded q scale
    return out


def _launch_bwd(x, dy, params, *config, x1=None):
    """Backward kernels → (dx in x's dtype, LayerParams of fp32 grads): the
    split tensor-core form where it applies (``x1`` as for
    :func:`layer_bwd_rows`), else the FMA form; ``config`` as the fields of
    LayerConfig."""
    global bwd_launches
    from maskedsst_tpu_torch.ops import _build

    cfg = LayerConfig(*config)
    b, s, d, inner, f = _check(x, params, cfg, _BWD)
    _check_dy(x, dy, _BWD)
    if _tc_form(cfg, s, d, f):
        return layer_bwd_split(x, dy, params, *cfg, x1=x1)
    plan = launch_plan("bwd", s, d, cfg.dim_head, f, x.device)
    args = _kernel_weights(params, cfg)
    lib, (fn, _), _ = _bind(_BWD)
    count = layer_wgrad.grad_count(d, inner, f)
    nparts = _nparts(b, s, x.device)
    ws = torch.empty((nparts, count), dtype=torch.float32, device=x.device)
    scratch = _scratch(plan, nparts, x.device)
    grads = torch.empty(count, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *(a.data_ptr() for a in args),
            ws.data_ptr(), _ptr(scratch), grads.data_ptr(),
            b, s, d, cfg.heads, cfg.dim_head, f, *_flags(x, cfg), nparts, plan.level,
            *_drop_args(cfg), ctypes.c_void_p(stream),
        )
    _build.check(lib, _BWD, code)
    bwd_launches += 1
    return dx, _unflatten(grads, d, inner, f, cfg.dim_head)
