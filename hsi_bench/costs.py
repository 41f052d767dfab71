"""Operation and byte counts of the port's work, frozen for the benchmark.

Counted from shapes, as the math needs them whatever kernel does the
work: each input byte read once and each output byte written once;
matrix products at 2 operations a multiply-add. The layer backward is
counted as dX and dW: twice the forward's products, no recompute (the
kernels' own recompute is an implementation choice, not work the step
needs). ``item`` is the byte width of the compute dtype (activations,
matrix weights); LayerNorm parameters, biases and gradients are fp32.

A configuration section (``configs/<name>.json``) gives the widths:
``transformer_dim``, ``transformer_depth``, ``transformer_n_heads``,
``dim_head``, ``transformer_mlp_dim``, ``n_bands``, ``band_patch_size``,
``patch_size``, ``image_size`` and, for a classifier, ``n_classes``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from hsi_bench.trace import bound_s


class Geometry:
    """The factorized encoder's widths from a configuration section."""

    def __init__(self, cfg: Dict):
        self.d = int(cfg["transformer_dim"])
        self.depth = int(cfg["transformer_depth"])
        self.inner = int(cfg["transformer_n_heads"]) * int(cfg["dim_head"])
        self.mlp = int(cfg["transformer_mlp_dim"])
        self.g = int(cfg["n_bands"]) // int(cfg["band_patch_size"])
        side = int(cfg["image_size"]) // int(cfg["patch_size"])
        self.n = side * side
        self.p = int(cfg["band_patch_size"]) * int(cfg["patch_size"]) ** 2
        self.classes = int(cfg.get("n_classes", 0))

    @property
    def tokens(self) -> int:
        """Tokens of one cube: g spectral blocks of n spatial patches."""
        return self.g * self.n

    def layer_calls(self, batch: int) -> List[Tuple[int, int]]:
        """(rows, sequence length) of each layer call on ``batch`` cubes: the
        spatial stack over n with (B, g) folded, the spectral one over g."""
        return ([(batch * self.tokens, self.n)] * self.depth
                + [(batch * self.tokens, self.g)] * self.depth)


def layer_flops(rows: int, s: int, d: int, inner: int, mlp: int) -> int:
    """Forward operations of one pre-LN layer over ``rows`` tokens in
    sequences of ``s``: QKV, scores and the weighted sum, out-projection,
    the two MLP products."""
    return rows * (2 * d * 3 * inner + 2 * 2 * s * inner + 2 * inner * d + 2 * 2 * d * mlp)


def _layer_weight_bytes(d: int, inner: int, mlp: int, item: int) -> int:
    return (d * 3 * inner + inner * d + 2 * d * mlp) * item + 4 * (6 * d + mlp)


def layer_param_count(d: int, inner: int, mlp: int) -> int:
    """LN1 (2d), QKV (3 inner d), out-projection (inner d + d), LN2 (2d),
    fc1 (d mlp + mlp), fc2 (mlp d + d)."""
    return 2 * d + 3 * inner * d + inner * d + d + 2 * d + d * mlp + mlp + mlp * d + d


def layer_fwd(rows: int, s: int, d: int, inner: int, mlp: int, item: int) -> Tuple[int, int]:
    """(bytes, operations) of one layer forward: reads x and the weights,
    writes y."""
    nbytes = 2 * rows * d * item + _layer_weight_bytes(d, inner, mlp, item)
    return nbytes, layer_flops(rows, s, d, inner, mlp)


def layer_bwd(rows: int, s: int, d: int, inner: int, mlp: int, item: int) -> Tuple[int, int]:
    """(bytes, operations) of one layer backward: reads x, dy and the
    weights, writes dx and the fp32 parameter gradients; twice the
    forward's operations."""
    nbytes = (3 * rows * d * item + _layer_weight_bytes(d, inner, mlp, item)
              + 4 * layer_param_count(d, inner, mlp))
    return nbytes, 2 * layer_flops(rows, s, d, inner, mlp)


def wgrad_cost(rows: int, d: int, inner: int, mlp: int) -> Tuple[int, int]:
    """(bytes, operations) of the four weight gradients over ``rows``: bf16
    operands in (h1, dqkv, o, dp1, h2, du, gd, dp2), fp32 gradients out."""
    m = 4 * inner + 2 * mlp
    return 2 * rows * (m + 4 * d) + 4 * d * m, 2 * rows * d * m


def embed_cost(b: int, g: int, p: int, n: int, d: int, item: int) -> Dict[str, Tuple[int, int]]:
    """The tokenization of fp32 patches [b, g, p, n] and a mask [b, g, n]
    into tokens [b, g, n, d] (pre-LN, per-block product, post-LN, + pos,
    mask select): forward and backward (bytes, operations)."""
    tokens = b * g * n
    data = 4 * b * g * p * n + 4 * b * g * n + g * p * d * item + tokens * d * item
    fwd = data + 4 * (2 * p + g * d + 2 * d + g * n * d + d)
    bwd = data + 4 * (2 * p + g * d + 2 * d) + 4 * (2 * p + g * p * d + g * d + 2 * d
                                                    + g * n * d + d)
    return {"fwd": (fwd, tokens * 2 * p * d), "bwd": (bwd, tokens * 4 * p * d)}


def decode_cost(b: int, g: int, n: int, d: int, p: int, item: int) -> Dict[str, Tuple[int, int]]:
    """The per-block decode and weighted L1 of encoded [b, g, n, d] against
    fp32 patches: forward and backward (bytes, operations)."""
    tokens = b * g * n
    fwd = tokens * d * item + tokens * p * 4 + g * d * p * item + g * p * 4 + tokens * 4 + 4
    return {"fwd": (fwd, 2 * tokens * d * p + 5 * tokens * p),
            "bwd": (fwd + tokens * d * item + 4 * (g * d * p + g * p),
                    4 * tokens * d * p + 5 * tokens * p)}


def forward_matmul_flops(cfg: Dict, head: str) -> int:
    """Matrix-product operations of one cube's forward: the embedding, the
    layers, and the SimMIM per-block decode (``head`` "simmim") or the
    classifier head over the spatial positions (``head`` "classifier")."""
    geo = Geometry(cfg)
    total = geo.tokens * 2 * geo.p * geo.d
    total += sum(layer_flops(rows, s, geo.d, geo.inner, geo.mlp) for rows, s in geo.layer_calls(1))
    if head == "simmim":
        total += geo.tokens * 2 * geo.d * geo.p
    elif head == "classifier":
        px = int(cfg["patch_size"]) ** 2
        total += geo.n * 2 * geo.d * geo.classes * px
    else:
        raise ValueError(f"unknown head {head!r}")
    return total


def train_flops_per_cube(cfg: Dict) -> int:
    """A SimMIM training step's matrix-product operations a cube: the
    forward and twice it for the backward, no recompute."""
    return 3 * forward_matmul_flops(cfg, "simmim")


def serve_flops_per_cube(cfg: Dict) -> int:
    """A served cube's matrix-product operations: the classifier forward."""
    return forward_matmul_flops(cfg, "classifier")


def layers_bound_s(cfg: Dict, batch: int, direction: str, item: int = 2) -> float:
    """The least time of the eight layer calls of one step or batch of
    ``batch`` cubes, forward (``direction`` "fwd") or backward ("bwd"),
    each call bounded by the larger of its bytes and its operations."""
    geo = Geometry(cfg)
    fn = layer_fwd if direction == "fwd" else layer_bwd
    return sum(bound_s(*fn(rows, s, geo.d, geo.inner, geo.mlp, item))
               for rows, s in geo.layer_calls(batch))
