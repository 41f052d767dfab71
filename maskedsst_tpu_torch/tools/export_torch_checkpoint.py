"""Export a checkpoint of this package, or of the JAX package, to a
reference-loadable ``.pth``.

    python -m maskedsst_tpu_torch.tools.export_torch_checkpoint --checkpoint RUN/X.pt
        --out exported.pth

``--checkpoint`` may be a JAX run's ``.msgpack`` (full state or bare
parameters, with the JAX trainers' ``.json`` sidecar), as
``scripts/export_torch_checkpoint.py`` exports it.

A pretraining checkpoint (``model_*.pt``: SimMIM, ``encoder.*`` keys) is
written with the reference's SimMIM keys, which its finetuning (and
``load_pretrained_params``) reads; a finetune checkpoint (``{method}_*.pt``)
with the reference's ViTSpatialSpectral or ViTRGB keys. The model is rebuilt from the
config in the checkpoint's ``.json`` sidecar; its ``load_state_dict``
checks every key and shape before the export. Saves
``torch.save({"model_state_dict": ..., "config": ...})``. A file
conversion: it runs on the CPU and needs no card.
"""

from __future__ import annotations

import argparse
import os

import torch

from maskedsst_tpu_torch.config import Config
from maskedsst_tpu_torch.io.torch_import import (
    export_simmim,
    export_vit_rgb,
    export_vit_spatial_spectral,
)
from maskedsst_tpu_torch.train.checkpoint import _jsonable, load_metadata, restore_params


def export_checkpoint(path: str, out: str) -> int:
    """Writes ``out`` from the checkpoint at ``path``; returns the number of
    tensors written."""
    from maskedsst_tpu_torch.train.factory import build_finetune_model
    from maskedsst_tpu_torch.train.pretrainer import build_pretrain_model

    saved = load_metadata(path).get("config")
    if not saved:
        raise ValueError(f"{path}.json holds no config: the model cannot be rebuilt")
    config = Config(saved)
    state_dict = restore_params(path)
    if "mask_token" in state_dict:  # a SimMIM pretraining checkpoint
        model = build_pretrain_model(config, device="cpu")
        model.load_state_dict(state_dict)
        sd = export_simmim(state_dict, model)
    else:
        model, _ = build_finetune_model(config, device="cpu")
        model.load_state_dict(state_dict)
        export = export_vit_rgb if config.method_name == "ViTRGB" else export_vit_spatial_spectral
        sd = export(state_dict, model)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    torch.save({"model_state_dict": sd, "config": _jsonable(saved)}, out)
    return len(sd)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True,
                    help="a .pt checkpoint of this package or a .msgpack of the JAX package")
    ap.add_argument("--out", required=True, help="the .pth to write")
    args = ap.parse_args(argv)
    print(f"wrote {args.out} ({export_checkpoint(args.checkpoint, args.out)} tensors)")


if __name__ == "__main__":
    main()
