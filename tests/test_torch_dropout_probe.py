"""The dropout-mask probes (ops/dropout_probe.py) on the plain versions: they
read back exactly the masks dropout_mask gives, at the kernels' shapes and
in both compute types, and a single flipped mask bit in the implementation
shows in the reading of its site."""

import pytest
import torch

from maskedsst_tpu_torch.ops import dropout_probe, fused_layer
from maskedsst_tpu_torch.ops.fused_layer import SITE_ATTN, SITE_FF_MID, SITE_FF_OUT, SITE_PROJ

SHAPES = [
    (3, 64, 96, 8, 64, 64),  # spatial
    (7, 20, 96, 8, 64, 64),  # spectral
    (13, 5, 96, 8, 64, 64),  # Houston spectral, odd seq
    (5, 8, 16, 2, 8, 12),  # narrow
]


def _read(b, s, d, heads, dh, f, dtype, seed=2**31 + 7):
    return dropout_probe.read_layer_masks(
        fused_layer.reference_layer, fused_layer.reference_layer_bwd, b, s, d, heads, dh, f,
        dtype, dtype, seed, "cpu", torch.Generator().manual_seed(0))


@pytest.mark.parametrize("b,s,d,heads,dh,f", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probes_read_the_plain_versions_masks(b, s, d, heads, dh, f, dtype):
    readings = _read(b, s, d, heads, dh, f, dtype)
    assert len(readings) == 4
    for r in readings:
        assert r.equal and r.margin < 0.5 and r.bits > 0, r


def test_probes_skip_the_site_1_readings_where_the_shape_hides_them():
    # S > dim_head: the site-1 probes cannot place every key on its own channel
    readings = _read(2, 20, 32, 2, 16, 16, torch.float32)
    assert [r.equal for r in readings] == [True, True]


# the readings that cover each site (by their leading words), and those of
# them that must catch one flipped bit: the forward reads site 5 only where
# site 7 keeps, so only the backward is sure to see a flip there
READS = {
    SITE_ATTN: ("forward site 1", "backward site 1"),
    SITE_PROJ: ("forward sites 3", "backward sites 3"),
    SITE_FF_MID: ("forward sites 3", "backward sites 3"),
    SITE_FF_OUT: ("forward sites 3", "backward sites 3"),
}
MUST_CATCH = {**READS, SITE_FF_MID: ("backward sites 3",)}


@pytest.mark.parametrize("site", sorted(READS))
def test_one_flipped_bit_fails_its_sites_reading(monkeypatch, site):
    plain_mask = fused_layer.dropout_mask

    def flipped(shape, seed, st, rate, device=None):
        m = plain_mask(shape, seed, st, rate, device)
        if st == site:
            m = m.clone()
            flat = m.view(-1)
            k = flat.numel() // 2 + 3
            flat[k] = 2.0 - flat[k]  # kept (2 at rate 0.5) <-> dropped (0)
        return m

    monkeypatch.setattr(fused_layer, "dropout_mask", flipped)
    readings = _read(7, 20, 96, 8, 64, 64, torch.bfloat16, seed=11)
    failed = [r.what for r in readings if not r.equal]
    assert all(w.startswith(READS[site]) for w in failed), failed
    assert all(any(w.startswith(p) for w in failed) for p in MUST_CATCH[site]), failed
