"""The JAX package's ``.msgpack`` checkpoints and multi-device serving with
the model on the card (the kernels of the port launched); a mirror of
``chip_smoke.py`` phase 12 at a narrow geometry. These tests need a CUDA
device and nvcc; elsewhere they skip. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_flax_checkpoint_cuda.py -q

(``--noconftest``: the suite's conftest.py imports JAX.)
"""

import numpy as np
import pytest
import torch

from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
from maskedsst_tpu_torch.io.flax_checkpoint import write_flax_checkpoint
from maskedsst_tpu_torch.ops import launch_counts, reset_launch_counts
from maskedsst_tpu_torch.serve import Predictor
from maskedsst_tpu_torch.train.factory import build_finetune_model
from maskedsst_tpu_torch.train.pretrainer import Pretrainer

pytestmark = pytest.mark.cuda

NARROW = dict(n_bands=40, transformer_dim=24, transformer_depth=1, transformer_n_heads=2,
              transformer_mlp_dim=32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pretrainer():
    cfg = get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml")
    for key, value in {**NARROW, "batch_size": 4}.items():
        setattr(cfg, key, value)
    return Pretrainer(cfg, tile_size=32, device="cuda")


def test_msgpack_round_trip_on_the_card(cuda, tmp_path):
    """Two pretraining steps on the card, written as the JAX pretrainer
    writes them and resumed in a new trainer: parameters, AdamW moments and
    steps bit for bit; from one generator state and the rate rounded to
    float32 as the file holds it, both take the same next step through the
    kernels."""
    data = SyntheticCubeDataset(num_tiles=4, n_bands=40, tile_size=32, labeled=False, seed=0)
    tiles = np.stack([data[i]["img"] for i in range(4)])
    trainer = _pretrainer()
    for _ in range(2):
        trainer.train_step(tiles)
    path = str(tmp_path / "pre.msgpack")
    write_flax_checkpoint(path, trainer.state, trainer.config)
    back = _pretrainer()
    assert back.resume(path) == 2
    opt_a, opt_b = trainer.state.optimizer, back.state.optimizer
    for p, q in zip(trainer.model.parameters(), back.model.parameters()):
        assert q.is_cuda and torch.equal(p, q)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt_a.state[p][key], opt_b.state[q][key]), key
    back.state.rng.set_state(trainer.state.rng.get_state())
    for group in trainer.state.optimizer.param_groups:  # optax keeps the rate in float32
        group["lr"] = float(np.float32(group["lr"]))
    reset_launch_counts()
    trainer.train_step(tiles)
    back.train_step(tiles)
    torch.cuda.synchronize()
    assert launch_counts()["fused_layer_bwd"] == 4 and launch_counts()["fused_simmim_fwd"] == 2
    for p, q in zip(trainer.model.parameters(), back.model.parameters()):
        assert torch.equal(p, q)


def test_two_replicas_on_one_card_equal_one_device(cuda):
    cfg = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml")
    for key, value in {**NARROW, "spectral_pos": cfg.spectral_pos[:4]}.items():
        setattr(cfg, key, value)
    model, _ = build_finetune_model(cfg, device="cuda")
    x = np.random.default_rng(0).standard_normal((13, 40, 8, 8)).astype(np.float32)
    reset_launch_counts()
    got = Predictor(model, batch_size=8, devices=["cuda:0", "cuda:0"])(x)
    torch.cuda.synchronize()
    assert launch_counts()["fused_embed_fwd"] == 4  # 2 padded batches x 2 slices
    want = Predictor(model, batch_size=4, devices=["cuda:0"])(x)
    assert got.shape == (13, 8, 8, 8)
    np.testing.assert_array_equal(got, want)
