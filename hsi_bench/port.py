"""What the benchmark takes from the program (``maskedsst_tpu_torch``): the
trainer, the classifier and the predictor, built from a configuration
section as the program's drivers build them. Imported only by the traffic
kinds, so that the reference and the harness's pure parts stand alone."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def _config(section: dict, seed: int):
    from maskedsst_tpu_torch.config import Config

    return Config(dict(section, seed=int(seed)))


def pretrainer(section: dict, seed: int, tile_size: int, device: str):
    """``train/pretrainer.py::Pretrainer`` of the section's recipe; its
    generator (crops, masks, dropout seeds) seeded with ``seed``."""
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    return Pretrainer(_config(section, seed), dtype=DTYPES[section["compute_dtype"]],
                      tile_size=tile_size, device=device)


def classifier(section: dict, seed: int, device: str):
    """The classifier of the section (``train/factory.py::build_finetune_model``)."""
    from maskedsst_tpu_torch.train.factory import build_finetune_model

    model, _ = build_finetune_model(_config(section, seed), DTYPES[section["compute_dtype"]],
                                    device)
    return model


def predictor(model, batch_size: int, device: str):
    """``serve.py::Predictor`` on the one device."""
    from maskedsst_tpu_torch.serve import Predictor

    return Predictor(model, batch_size=batch_size, devices=[device])
