"""The frozen counts against hand counts at both configurations' widths."""

import pytest

from hsi_bench import costs, registry


def hand_forward(g: int) -> int:
    """One cube's forward products by hand: d 96, 8 heads x 64 (inner
    512), MLP 64, n = 64 positions, g blocks of p = 10 bands."""
    d, inner, mlp, n, p = 96, 512, 64, 64, 10
    per_token = 2 * d * 3 * inner + 2 * inner * d + 2 * 2 * d * mlp  # QKV, out, MLP
    spatial = 4 * g * n * (per_token + 2 * 2 * n * inner)  # scores and sum over 64
    spectral = 4 * g * n * (per_token + 2 * 2 * g * inner)  # over g
    return spatial + spectral + g * n * 2 * p * d


@pytest.mark.parametrize("name,g,gflop", [("enmap", 20, 5.16), ("houston2018", 5, 1.25)])
def test_forward_products_a_cube(name, g, gflop):
    cfg = registry.config(name)["pretrain"]
    simmim = costs.forward_matmul_flops(cfg, "simmim")
    assert simmim == hand_forward(g) + g * 64 * 2 * 96 * 10
    assert simmim / 1e9 == pytest.approx(gflop, abs=0.006)
    assert costs.train_flops_per_cube(cfg) == 3 * simmim


def test_serving_products_a_cube():
    cfg = registry.config("enmap")["serve"]
    assert costs.serve_flops_per_cube(cfg) == hand_forward(20) + 64 * 2 * 96 * 8


def test_layer_backward_is_twice_the_forward_without_recompute():
    fwd_bytes, fwd_ops = costs.layer_fwd(81920, 64, 96, 512, 64, 2)
    bwd_bytes, bwd_ops = costs.layer_bwd(81920, 64, 96, 512, 64, 2)
    assert bwd_ops == 2 * fwd_ops
    weights = (96 * 1536 + 512 * 96 + 2 * 96 * 64) * 2 + 4 * (6 * 96 + 64)
    assert fwd_bytes == 2 * 81920 * 96 * 2 + weights
    params = 2 * 96 + 1536 * 96 + 512 * 96 + 96 + 2 * 96 + 96 * 64 + 64 + 64 * 96 + 96
    assert bwd_bytes == 3 * 81920 * 96 * 2 + weights + 4 * params


def test_layer_bounds_are_the_calls_sum():
    cfg = registry.config("enmap")["pretrain"]
    geo = costs.Geometry(cfg)
    assert geo.layer_calls(64) == [(81920, 64)] * 4 + [(81920, 20)] * 4
    want = sum(max(b / 3.35e12, f / 989e12)
               for b, f in (costs.layer_bwd(r, s, 96, 512, 64, 2) for r, s in geo.layer_calls(64)))
    assert costs.layers_bound_s(cfg, 64, "bwd") == pytest.approx(want)
    # at these widths the layer is bound by its operations
    assert costs.layers_bound_s(cfg, 64, "fwd") == pytest.approx(
        sum(costs.layer_flops(r, s, 96, 512, 64) for r, s in geo.layer_calls(64)) / 989e12)
