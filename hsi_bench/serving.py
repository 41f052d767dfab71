"""What the serving kinds share: the classifier built by the program from
the seed's weights, served by ``Predictor``; a pool of cubes made on the
device from the seed and held on the host, as a caller holds its cubes; a
forward pre-hook that counts the rows the model is called on; and the
comparison of answers with the reference.

The number compared, ``logit_gap``: the largest absolute gap between a
served logit and the reference's, over every logit of the compared cubes,
against the root mean square of the reference's logits there.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from hsi_bench import port, weights
from hsi_bench.reference import serve as ref_serve


def logit_gap(served: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(served - ref).max() / np.sqrt(np.mean(ref.astype(np.float64) ** 2)))


class ServeCell:
    """Set-up, release and comparison of a serving cell; a kind adds its
    window and which answers it compares (``compared()``: (cubes, served
    logits))."""

    pool_size = 0

    def __init__(self, config: dict, params: dict, seed: int, device: str):
        self.cfg = config[params["section"]]
        self.params, self.device = params, device
        self.w_seed, self.data_seed, self.model_seed, self.order_seed, self.sample_seed = (
            weights.sub_seeds(seed, 5))
        self.order = np.random.default_rng(self.order_seed)
        self.rows_called = 0

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        clock = weights.phases()
        model = port.classifier(cfg, self.model_seed, dev)
        clock("classifier")
        self.w = weights.make(cfg, "classifier", self.w_seed, dev)
        weights.load_into(model, self.w)
        model.register_forward_pre_hook(self._count)
        self.predictor = port.predictor(model, int(self.params["batch_size"]), dev)
        side = int(cfg["image_size"])
        self.pool = weights.cubes((self.pool_size, int(cfg["n_bands"]), side, side),
                                   self.data_seed, dev).cpu().numpy()
        clock("weights and pool")
        self.warm()
        if dev.startswith("cuda"):
            torch.cuda.synchronize()
        clock("warm-up")
        self.rows_called = 0

    def _count(self, module, args) -> None:
        self.rows_called += int(args[0].shape[0])

    def warm(self) -> None:
        raise NotImplementedError

    def release(self) -> None:
        del self.predictor
        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def reference(self, cubes: np.ndarray, rounding: str = "float32") -> np.ndarray:
        return ref_serve.logits(cubes, self.w, self.cfg, self.device, rounding)

    def compare(self) -> dict:
        cubes, served = self.compared()
        return {"logit_gap": logit_gap(served, self.reference(cubes))}

    def readings(self, control: bool, seconds: float) -> dict:
        """The program's number after a window of ``seconds`` at the cell's
        own load and, with ``control``, the control's (the reference in
        float8 in the program's place)."""
        self.window(seconds)
        self.release()
        cubes, served = self.compared()
        ref = self.reference(cubes)
        sides = {"program": {"logit_gap": logit_gap(served, ref)}}
        if control:
            sides["control"] = {"logit_gap": logit_gap(self.reference(cubes, "fp8"), ref)}
        return {"numbers": sides, "compared_cubes": int(cubes.shape[0])}
