"""Dataset resolution for the finetune entry point: the synthetic branch of the
JAX package's ``data/resolve.py::get_dataset``. The real EnMAP and
Houston2018 loaders and the packed tile store are not ported yet
(ROADMAP.md), so a non-synthetic request raises."""

from __future__ import annotations

from maskedsst_tpu_torch.config import Config
from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset


def get_dataset(config: Config, *, supervised: bool, synthetic: bool = False):
    """SyntheticCubeDataset with the config's band and class counts and
    ``synthetic_tiles`` tiles (512 by default), seeded by ``config.seed``.

    EnMAP-family datasets get 64x64 tiles (the trainer crops
    ``image_size`` windows); houston2018 gets tiles of the model's input
    size, as its real loader yields ``image_size`` patches (50 bands: the
    spectral stack runs at sequence length 5)."""
    if not synthetic:
        raise NotImplementedError(
            f"the real {config.dataset!r} loaders are not ported yet (ROADMAP.md); "
            "use --synthetic"
        )
    tile = 64
    if config.dataset == "houston2018":
        tile = config.image_size - config.get("patch_sub", 0)
    return SyntheticCubeDataset(
        num_tiles=int(config.get("synthetic_tiles", 512)),
        n_bands=config.n_bands,
        tile_size=tile,
        n_classes=config.n_classes,
        labeled=supervised,
        seed=config.get("seed", 5),
    )
