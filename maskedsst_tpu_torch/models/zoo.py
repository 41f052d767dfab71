"""The DeepHyperX model zoo: 12 hyperspectral classification baselines,
the JAX package's ``models/zoo.py`` in NCDHW / NCHW.

Input layouts are the reference callers': the 3-D CNNs take [B, 1, C, H, W]
(a singleton feature channel), the spectral nets (nn, hu, boulch, mou)
take [B, C], LiuEtAl takes [B, C, p, p] or [B, 1, C, p, p]. Module
attribute names are DeepHyperX's (``conv1``, ``fc``, ``encoder.0``,
``gru``, ...), so a reference ``state_dict`` loads by name
(``io/torch_import.py::import_zoo``). Flattening is torch's view of the
channels-first layout, which is the order the JAX package reproduces with
``_flatten_torch_order``.

Every net has ``init_weights(seed)`` (the JAX initializers' distributions,
drawn on the CPU from one generator), ``logits_shape``, ``input_shape``
and ``compute_dtype`` (always fp32: the zoo keeps the paper recipes in
fp32 whatever compute dtype a driver is given). ``forward(x, rng=None,
shard=(0, 1))`` draws its dropout masks from ``rng`` (a CPU generator) in
training, the masks of the whole global batch with this process's rows
taken under data parallelism; with no dropout active the generator is not
drawn from. The semi-supervised nets (liu, boulch) return ``(logits,
reconstruction)`` and carry ``aux_loss_weight``.

BatchNorm follows flax's ``nn.BatchNorm`` (:class:`BatchNorm`): momentum
0.99 (torch's 0.01), eps 1e-5, the batch variance E[x²] − E[x]² and the
running variance updated from that biased variance (``nn.BatchNorm*d``
would take the unbiased one and drift by n/(n−1)).

The convolutions, pools, the GRU and the LRN are ``torch.nn`` / cuDNN
calls: the JAX zoo runs them as XLA operations, no Pallas kernel.

``get_model(name, **kwargs)`` returns ``(model, optimizer_spec,
criterion_spec, hyperparams)`` with the JAX factory's recipes and
defaults, including the reference's ``weights[ignored_labels] = 0`` (label
-1 zeroes the last class).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# --- shared pieces -----------------------------------------------------------

class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over dim 1 of [B, F, ...]: in training the
    batch's mean and biased variance (E[x²] − E[x]², clamped at 0)
    normalize, and the running statistics move as ``m·old + (1 − m)·new``
    with m = ``momentum``; in eval the running statistics normalize."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [d for d in range(x.dim()) if d != 1]
            mean = x.mean(dim=dims)
            var = ((x * x).mean(dim=dims) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


def _init_(t: torch.Tensor, kind: str, fan_in: int, fan_out: int,
           gen: torch.Generator) -> None:
    """Draw ``t`` on the CPU from ``gen`` as the JAX initializer ``kind``."""
    cpu = torch.empty(t.shape)
    if kind == "kaiming_normal":  # variance_scaling(2, fan_in, normal): untruncated
        cpu.normal_(0.0, math.sqrt(2.0 / fan_in), generator=gen)
    elif kind == "kaiming_uniform":
        bound = math.sqrt(6.0 / fan_in)
        cpu.uniform_(-bound, bound, generator=gen)
    elif kind == "lecun_normal":  # truncated at ±2σ, std corrected
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std, generator=gen)
    elif kind == "xavier_uniform":
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        cpu.uniform_(-bound, bound, generator=gen)
    elif kind.startswith("normal:"):
        cpu.normal_(0.0, float(kind.split(":")[1]), generator=gen)
    elif kind.startswith("uniform:"):
        bound = float(kind.split(":")[1])
        cpu.uniform_(-bound, bound, generator=gen)
    else:
        raise ValueError(f"unknown initializer {kind!r}")
    with torch.no_grad():
        t.copy_(cpu)


class ZooNet(nn.Module):
    """What the 12 nets share: the init from a seed, the fp32 compute
    dtype, the dropout generator of a training call, and the flattened
    size of a layer stack, found by a forward at construction."""

    #: JAX initializer of every conv / linear weight, and per-module overrides
    init_kind = "kaiming_normal"
    init_overrides: Dict[str, str] = {}
    n_classes: int

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def logits_shape(self) -> tuple:
        return (self.n_classes,)

    def init_weights(self, seed: int) -> "ZooNet":
        """Fresh weights from ``seed``: each conv and linear weight from its
        JAX initializer, zero biases, unit BatchNorm scales with reset
        statistics, the GRU's tensors U(-1/√H, 1/√H); in module order."""
        gen = torch.Generator().manual_seed(seed)
        for name, mod in self.named_modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.Linear)):
                w = mod.weight
                receptive = int(np.prod(w.shape[2:])) if w.dim() > 2 else 1
                kind = self.init_overrides.get(name, self.init_kind)
                _init_(w, kind, w.shape[1] * receptive, w.shape[0] * receptive, gen)
                if mod.bias is not None:
                    nn.init.zeros_(mod.bias)
            elif isinstance(mod, BatchNorm):
                mod.reset_parameters()
            elif isinstance(mod, nn.GRU):
                k = 1.0 / math.sqrt(mod.hidden_size)
                for p in mod.parameters():
                    _init_(p, f"uniform:{k}", 1, 1, gen)
        return self

    def dropout_generator(self, x: torch.Tensor, rng: Optional[torch.Generator],
                          p: float) -> Optional[torch.Generator]:
        """A generator on ``x``'s device seeded from ``rng`` for this call's
        dropout masks; None when no dropout is active."""
        if not (self.training and p > 0.0):
            return None
        if rng is None:
            raise ValueError("training with dropout needs an explicit torch.Generator (rng); "
                             "the model never draws from torch's global RNG")
        seed = int(torch.randint(0, 2**62, (1,), generator=rng))
        return torch.Generator(device=x.device).manual_seed(seed)

    @staticmethod
    def dropout(x: torch.Tensor, p: float, gen: Optional[torch.Generator],
                shard: Tuple[int, int]) -> torch.Tensor:
        """Inverted dropout at rate ``p``: the mask of the whole global batch
        (``shard`` = (rank, world size)) is drawn, this process's rows kept."""
        if gen is None:
            return x
        rank, world = shard
        b = x.shape[0]
        keep = torch.rand((b * world, *x.shape[1:]), generator=gen, device=x.device) >= p
        return x * keep[rank * b:(rank + 1) * b] / (1.0 - p)

    @staticmethod
    @torch.no_grad()
    def _flat_size(stack, shape) -> int:
        return int(stack(torch.zeros(shape)).reshape(1, -1).shape[1])


# --- the 12 networks ---------------------------------------------------------

class Baseline(ZooNet):
    """4-layer MLP (DeepHyperX/models.py:205-240) on [B, C]."""

    def __init__(self, input_channels: int, n_classes: int, dropout: bool = False):
        super().__init__()
        self.input_channels, self.n_classes, self.use_dropout = input_channels, n_classes, dropout
        self.fc1 = nn.Linear(input_channels, 2048)
        self.fc2 = nn.Linear(2048, 4096)
        self.fc3 = nn.Linear(4096, 2048)
        self.fc4 = nn.Linear(2048, n_classes)

    @property
    def input_shape(self) -> tuple:
        return (self.input_channels,)

    def forward(self, x, rng=None, shard=(0, 1)):
        p = 0.5 if self.use_dropout else 0.0
        gen = self.dropout_generator(x, rng, p)
        x = x.reshape(x.shape[0], -1)
        for fc in (self.fc1, self.fc2, self.fc3):
            x = self.dropout(F.relu(fc(x)), p, gen, shard)
        return self.fc4(x)


class HuEtAl(ZooNet):
    """1-D CNN over the spectrum (DeepHyperX/models.py:243-294) on [B, C]."""

    init_kind = "uniform:0.05"

    def __init__(self, input_channels: int, n_classes: int):
        super().__init__()
        self.input_channels, self.n_classes = input_channels, n_classes
        kernel = math.ceil(input_channels / 9)
        self.pool_size = math.ceil(kernel / 5)
        self.conv = nn.Conv1d(1, 20, kernel)
        self.fc1 = nn.Linear(self._flat_size(self._features, (1, 1, input_channels)), 100)
        self.fc2 = nn.Linear(100, n_classes)

    @property
    def input_shape(self) -> tuple:
        return (self.input_channels,)

    def _features(self, x):
        return torch.tanh(F.max_pool1d(self.conv(x), self.pool_size))

    def forward(self, x, rng=None, shard=(0, 1)):
        x = self._features(x.reshape(x.shape[0], 1, self.input_channels))
        x = torch.tanh(self.fc1(x.reshape(x.shape[0], -1)))
        return self.fc2(x)


class _Cube3d(ZooNet):
    """A 3-D CNN on [B, 1, C, p, p]."""

    @property
    def input_shape(self) -> tuple:
        return (1, self.input_channels, self.patch_size, self.patch_size)

    def _flat(self) -> int:
        return self._flat_size(self._features, (1,) + self.input_shape)


class HamidaEtAl(_Cube3d):
    """3-D CNN (DeepHyperX/models.py:297-383)."""

    def __init__(self, input_channels: int, n_classes: int, patch_size: int = 5,
                 dilation: int = 1):
        super().__init__()
        self.input_channels, self.n_classes, self.patch_size = input_channels, n_classes, patch_size
        d = (dilation, 1, 1)
        pad1 = (1, 1, 1) if patch_size == 3 else (0, 0, 0)
        self.conv1 = nn.Conv3d(1, 20, (3, 3, 3), (1, 1, 1), pad1, d)
        self.pool1 = nn.Conv3d(20, 20, (3, 1, 1), (2, 1, 1), (1, 0, 0), d)
        self.conv2 = nn.Conv3d(20, 35, (3, 3, 3), (1, 1, 1), (1, 0, 0), d)
        self.pool2 = nn.Conv3d(35, 35, (3, 1, 1), (2, 1, 1), (1, 0, 0), d)
        self.conv3 = nn.Conv3d(35, 35, (3, 1, 1), (1, 1, 1), (1, 0, 0), d)
        self.conv4 = nn.Conv3d(35, 35, (2, 1, 1), (2, 1, 1), (1, 0, 0), d)
        self.fc = nn.Linear(self._flat(), n_classes)

    def _features(self, x):
        x = self.pool1(F.relu(self.conv1(x)))
        x = self.pool2(F.relu(self.conv2(x)))
        return F.relu(self.conv4(F.relu(self.conv3(x))))

    def forward(self, x, rng=None, shard=(0, 1)):
        x = self._features(x)
        return self.fc(x.reshape(x.shape[0], -1))


class LeeEtAl(_Cube3d):
    """Contextual deep CNN, 3-D inception + 1x1 residual blocks
    (DeepHyperX/models.py:386-468); fully convolutional: [B, n_classes, H,
    W]. ``patch_size`` only sets ``logits_shape`` and ``input_shape``."""

    init_kind = "kaiming_uniform"

    def __init__(self, in_channels: int, n_classes: int, patch_size: int = 5):
        super().__init__()
        self.input_channels, self.n_classes, self.patch_size = in_channels, n_classes, patch_size
        self.conv_3x3 = nn.Conv3d(1, 128, (in_channels, 3, 3), padding=(0, 1, 1))
        self.conv_1x1 = nn.Conv3d(1, 128, (in_channels, 1, 1))
        self.conv1 = nn.Conv2d(256, 128, 1)
        for i in range(2, 8):
            setattr(self, f"conv{i}", nn.Conv2d(128, 128, 1))
        self.conv8 = nn.Conv2d(128, n_classes, 1)

    @property
    def logits_shape(self) -> tuple:
        return (self.n_classes, self.patch_size, self.patch_size)

    def forward(self, x, rng=None, shard=(0, 1)):
        gen = self.dropout_generator(x, rng, 0.5)
        x = torch.cat([self.conv_3x3(x), self.conv_1x1(x)], dim=1)[:, :, 0]  # [B, 256, H, W]
        # torch's LocalResponseNorm is the JAX zoo's local_response_norm
        x = F.relu(F.local_response_norm(x, 256))
        x = F.relu(F.local_response_norm(self.conv1(x), 128))
        x = F.relu(x + self.conv3(F.relu(self.conv2(x))))
        x = F.relu(x + self.conv5(F.relu(self.conv4(x))))
        x = self.dropout(F.relu(self.conv6(x)), 0.5, gen, shard)
        x = self.dropout(F.relu(self.conv7(x)), 0.5, gen, shard)
        return self.conv8(x)


class ChenEtAl(_Cube3d):
    """3-D CNN (DeepHyperX/models.py:471-529); needs >= 94 bands at 27x27."""

    init_kind = "normal:0.001"

    def __init__(self, input_channels: int, n_classes: int, patch_size: int = 27,
                 n_planes: int = 32):
        super().__init__()
        self.input_channels, self.n_classes, self.patch_size = input_channels, n_classes, patch_size
        self.conv1 = nn.Conv3d(1, n_planes, (32, 4, 4))
        self.conv2 = nn.Conv3d(n_planes, n_planes, (32, 4, 4))
        self.conv3 = nn.Conv3d(n_planes, n_planes, (32, 4, 4))
        self.fc = nn.Linear(self._flat(), n_classes)

    def _features(self, x, drop=lambda t: t):
        x = drop(F.max_pool3d(F.relu(self.conv1(x)), (1, 2, 2)))
        x = drop(F.max_pool3d(F.relu(self.conv2(x)), (1, 2, 2)))
        return drop(F.relu(self.conv3(x)))

    def forward(self, x, rng=None, shard=(0, 1)):
        gen = self.dropout_generator(x, rng, 0.5)
        x = self._features(x, lambda t: self.dropout(t, 0.5, gen, shard))
        return self.fc(x.reshape(x.shape[0], -1))


class LiEtAl(_Cube3d):
    """Two 3-D convolutions and a linear head (Li et al. 2017;
    DeepHyperX/models.py:532-586): the baseline the finetune driver runs
    with ``n_planes=16``."""

    init_kind = "xavier_uniform"

    def __init__(self, input_channels: int, n_classes: int, n_planes: int = 2,
                 patch_size: int = 5):
        super().__init__()
        self.input_channels, self.n_classes, self.patch_size = input_channels, n_classes, patch_size
        self.conv1 = nn.Conv3d(1, n_planes, (7, 3, 3), padding=(1, 0, 0))
        self.conv2 = nn.Conv3d(n_planes, 2 * n_planes, (3, 3, 3), padding=(1, 0, 0))
        self.fc = nn.Linear(self._flat(), n_classes)

    def _features(self, x):
        return F.relu(self.conv2(F.relu(self.conv1(x))))

    def forward(self, x, rng=None, shard=(0, 1)):
        x = self._features(x)
        return self.fc(x.reshape(x.shape[0], -1))


class HeEtAl(_Cube3d):
    """Multi-scale 3-D CNN (DeepHyperX/models.py:589-667)."""

    init_kind = "kaiming_uniform"

    def __init__(self, input_channels: int, n_classes: int, patch_size: int = 7):
        super().__init__()
        self.input_channels, self.n_classes, self.patch_size = input_channels, n_classes, patch_size
        self.conv1 = nn.Conv3d(1, 16, (11, 3, 3), stride=(3, 1, 1))
        for stage in (2, 3):
            for j, k in enumerate((1, 3, 5, 11)):
                setattr(self, f"conv{stage}_{j + 1}",
                        nn.Conv3d(16, 16, (k, 1, 1), padding=(k // 2, 0, 0)))
        self.conv4 = nn.Conv3d(16, 16, (3, 2, 2))
        self.fc = nn.Linear(self._flat(), n_classes)

    def _features(self, x):
        x = F.relu(self.conv1(x))
        for stage in (2, 3):
            x = F.relu(sum(getattr(self, f"conv{stage}_{j}")(x) for j in range(1, 5)))
        return F.relu(self.conv4(x))

    def forward(self, x, rng=None, shard=(0, 1)):
        gen = self.dropout_generator(x, rng, 0.6)
        x = self._features(x)
        return self.fc(self.dropout(x.reshape(x.shape[0], -1), 0.6, gen, shard))


class LuoEtAl(_Cube3d):
    """HSI-CNN (DeepHyperX/models.py:670-727)."""

    init_kind = "kaiming_uniform"

    def __init__(self, input_channels: int, n_classes: int, patch_size: int = 3,
                 n_planes: int = 90):
        super().__init__()
        self.input_channels, self.n_classes, self.patch_size = input_channels, n_classes, patch_size
        self.n_planes = n_planes
        self.conv1 = nn.Conv3d(1, n_planes, (24, 3, 3), stride=(9, 1, 1))
        self.conv2 = nn.Conv2d(1, 64, (3, 3))
        self.fc1 = nn.Linear(self._flat(), 1024)
        self.fc2 = nn.Linear(1024, n_classes)

    def _features(self, x):
        x = F.relu(self.conv1(x))  # [b, planes, D, 1, 1]
        x = x.reshape(x.shape[0], 1, -1, self.n_planes)  # the reference's plane-major view
        return F.relu(self.conv2(x))

    def forward(self, x, rng=None, shard=(0, 1)):
        x = self._features(x)
        return self.fc2(F.relu(self.fc1(x.reshape(x.shape[0], -1))))


def _merge_feature_into_depth(t: torch.Tensor) -> torch.Tensor:
    """[b, f, d, h, w] → [b, 1, f*d, h, w], feature-major (the reference's
    ``view(b, 1, t*c, w, h)``)."""
    b, f, d, h, w = t.shape
    return t.reshape(b, 1, f * d, h, w)


class SharmaEtAl(_Cube3d):
    """S-CNN with batch norm (DeepHyperX/models.py:730-807), 64x64 patches."""

    def __init__(self, input_channels: int, n_classes: int, patch_size: int = 64):
        super().__init__()
        self.input_channels, self.n_classes, self.patch_size = input_channels, n_classes, patch_size
        self.conv1 = nn.Conv3d(1, 96, (input_channels, 6, 6), stride=(1, 2, 2))
        self.conv1_bn = BatchNorm(96)
        self.conv2 = nn.Conv3d(1, 256, (96, 3, 3), stride=(1, 2, 2))
        self.conv2_bn = BatchNorm(256)
        self.conv3 = nn.Conv3d(1, 512, (256, 3, 3))
        flat = self._flat_size(lambda t: self.eval()._features(t), (1,) + self.input_shape)
        self.train()
        self.fc1 = nn.Linear(flat, 1024)
        self.fc2 = nn.Linear(1024, n_classes)

    def _features(self, x):
        x = F.max_pool3d(F.relu(self.conv1_bn(self.conv1(x))), (1, 2, 2))
        x = _merge_feature_into_depth(x)
        x = F.max_pool3d(F.relu(self.conv2_bn(self.conv2(x))), (1, 2, 2))
        x = _merge_feature_into_depth(x)
        return F.relu(self.conv3(x))

    def forward(self, x, rng=None, shard=(0, 1)):
        gen = self.dropout_generator(x, rng, 0.5)
        x = self._features(x)
        x = self.dropout(self.fc1(x.reshape(x.shape[0], -1)), 0.5, gen, shard)
        return self.fc2(x)


class LiuEtAl(ZooNet):
    """Semi-supervised conv encoder + FC decoder with skip connections
    (DeepHyperX/models.py:810-887) on [B, C, p, p] (or [B, 1, C, p, p]).
    Returns (logits, reconstruction of the center spectrum). The
    reference's unused ``fc1_dec_bn`` is not built."""

    def __init__(self, input_channels: int, n_classes: int, patch_size: int = 9,
                 aux_loss_weight: float = 1.0):
        super().__init__()
        self.input_channels, self.n_classes, self.patch_size = input_channels, n_classes, patch_size
        self.aux_loss_weight = aux_loss_weight
        self.conv1 = nn.Conv2d(input_channels, 80, (3, 3))
        self.conv1_bn = BatchNorm(80)
        side = patch_size - 2
        f_conv1, f_pool1 = 80 * side * side, 80 * (side // 2) ** 2
        self.fc_enc = nn.Linear(f_pool1, n_classes)
        self.fc1_dec = nn.Linear(f_pool1, f_pool1)
        self.fc2_dec = nn.Linear(f_pool1, f_pool1)
        self.fc2_dec_bn = BatchNorm(f_pool1)
        self.fc3_dec = nn.Linear(f_pool1, f_conv1)
        self.fc3_dec_bn = BatchNorm(f_conv1)
        self.fc4_dec = nn.Linear(f_conv1, input_channels)

    @property
    def input_shape(self) -> tuple:
        return (1, self.input_channels, self.patch_size, self.patch_size)

    def forward(self, x, rng=None, shard=(0, 1)):
        if x.dim() == 5:
            x = x[:, 0]
        conv1 = self.conv1_bn(self.conv1(x))
        pool1 = F.max_pool2d(conv1, 2)
        b = x.shape[0]
        f_conv1, f_pool1 = conv1.reshape(b, -1), pool1.reshape(b, -1)
        f_enc = F.relu(f_pool1)
        logits = self.fc_enc(f_enc)
        d = F.relu(self.fc1_dec(f_enc))
        d = F.relu(self.fc2_dec_bn(self.fc2_dec(d) + f_pool1))
        d = F.relu(self.fc3_dec_bn(self.fc3_dec(d) + f_conv1))
        return logits, self.fc4_dec(d)


class BoulchEtAl(ZooNet):
    """1-D convolutional autoencoder + linear classifier
    (DeepHyperX/models.py:890-957) on [B, C]. ``encoder`` is the
    reference's Sequential (conv, pool, relu, batch norm per block, then a
    conv to 3 planes and tanh). Returns (logits, reconstruction)."""

    def __init__(self, input_channels: int, n_classes: int, planes: int = 16,
                 aux_loss_weight: float = 0.1):
        super().__init__()
        self.input_channels, self.n_classes = input_channels, n_classes
        self.aux_loss_weight = aux_loss_weight
        modules, n, width = [], input_channels, 1
        while n > 1:
            out = 2 * planes if n == input_channels else planes
            modules += [nn.Conv1d(width, out, 3, padding=1), nn.MaxPool1d(2), nn.ReLU(),
                        BatchNorm(out)]
            width, n = out, n // 2
        modules += [nn.Conv1d(width, 3, 3, padding=1), nn.Tanh()]
        self.encoder = nn.Sequential(*modules)
        flat = self._flat_size(lambda t: self.eval().encoder(t), (1, 1, input_channels))
        self.train()
        self.classifier = nn.Linear(flat, n_classes)
        self.regressor = nn.Linear(flat, input_channels)

    @property
    def input_shape(self) -> tuple:
        return (self.input_channels,)

    def forward(self, x, rng=None, shard=(0, 1)):
        x = self.encoder(x.reshape(x.shape[0], 1, self.input_channels))
        x = x.reshape(x.shape[0], -1)
        return self.classifier(x), self.regressor(x)


class MouEtAl(ZooNet):
    """GRU over the spectral sequence (DeepHyperX/models.py:960-995) on
    [B, C]: ``nn.GRU(1, 64)``, whose gate form (r, z, n; both bias
    vectors) the JAX package's ``TorchGRUCell`` copies."""

    init_overrides = {"fc": "lecun_normal"}

    def __init__(self, input_channels: int, n_classes: int):
        super().__init__()
        self.input_channels, self.n_classes = input_channels, n_classes
        self.gru = nn.GRU(1, 64, 1, batch_first=True)
        self.gru_bn = BatchNorm(64 * input_channels)
        self.fc = nn.Linear(64 * input_channels, n_classes)

    @property
    def input_shape(self) -> tuple:
        return (self.input_channels,)

    def forward(self, x, rng=None, shard=(0, 1)):
        seq, _ = self.gru(x.reshape(x.shape[0], self.input_channels, 1))  # [B, C, 64]
        flat = seq.transpose(1, 2).reshape(x.shape[0], -1)  # the reference's [B, 64*C] order
        return self.fc(torch.tanh(self.gru_bn(flat)))


# --- factory -----------------------------------------------------------------

def get_model(name: str, **kwargs) -> Tuple[ZooNet, Dict, Dict, Dict]:
    """The JAX factory (DeepHyperX/models.py:20-202): ``(model,
    optimizer_spec, criterion_spec, hyperparams)``, the model's weights from
    ``init_weights(kwargs.get("seed", 0))``. ``optimizer_spec`` feeds
    ``train/optim.py::build_optimizer`` (``name``, ``learning_rate``,
    ``weight_decay``, ``momentum``); ``criterion_spec`` is the weighted
    cross-entropy, its weights with the reference's ``weights[ignored] =
    0`` quirk (label -1 zeroes the LAST class)."""
    n_classes = kwargs["n_classes"]
    n_bands = kwargs["n_bands"]
    weights = np.ones(n_classes, np.float32)
    for lab in kwargs.get("ignored_labels", []):
        weights[lab] = 0.0
    weights = kwargs.setdefault("weights", weights)

    if name == "nn":
        kwargs.setdefault("patch_size", 1)
        center_pixel = True
        model = Baseline(n_bands, n_classes, dropout=bool(kwargs.setdefault("dropout", False)))
        opt = {"name": "Adam", "learning_rate": kwargs.setdefault("learning_rate", 0.0001)}
        kwargs.setdefault("epoch", 100)
        kwargs.setdefault("batch_size", 100)
    elif name == "hamida":
        patch_size = kwargs.setdefault("patch_size", 5)
        center_pixel = True
        model = HamidaEtAl(n_bands, n_classes, patch_size=patch_size)
        opt = {"name": "SGD", "learning_rate": kwargs.setdefault("learning_rate", 0.01),
               "weight_decay": 0.0005}
        kwargs.setdefault("batch_size", 100)
    elif name == "lee":
        kwargs.setdefault("epoch", 200)
        patch_size = kwargs.setdefault("patch_size", 5)
        center_pixel = False
        model = LeeEtAl(n_bands, n_classes, patch_size=patch_size)
        opt = {"name": "Adam", "learning_rate": kwargs.setdefault("learning_rate", 0.001)}
    elif name == "chen":
        patch_size = kwargs.setdefault("patch_size", 27)
        center_pixel = True
        model = ChenEtAl(n_bands, n_classes, patch_size=patch_size)
        opt = {"name": "SGD", "learning_rate": kwargs.setdefault("learning_rate", 0.003)}
        kwargs.setdefault("epoch", 400)
        kwargs.setdefault("batch_size", 100)
    elif name == "li":
        patch_size = kwargs.setdefault("patch_size", 5)
        center_pixel = True
        model = LiEtAl(n_bands, n_classes, n_planes=16, patch_size=patch_size)
        opt = {"name": "SGD", "learning_rate": kwargs.setdefault("learning_rate", 0.01),
               "weight_decay": 0.0005, "momentum": 0.9}  # DeepHyperX/models.py:80-82 (li only)
        kwargs.setdefault("epoch", 200)
    elif name == "hu":
        kwargs.setdefault("patch_size", 1)
        center_pixel = True
        model = HuEtAl(n_bands, n_classes)
        opt = {"name": "SGD", "learning_rate": kwargs.setdefault("learning_rate", 0.01)}
        kwargs.setdefault("epoch", 100)
        kwargs.setdefault("batch_size", 100)
    elif name == "he":
        kwargs.setdefault("patch_size", 7)
        kwargs.setdefault("batch_size", 40)
        center_pixel = True
        model = HeEtAl(n_bands, n_classes, patch_size=kwargs["patch_size"])
        opt = {"name": "Adagrad", "learning_rate": kwargs.setdefault("learning_rate", 0.01),
               "weight_decay": 0.01}
    elif name == "luo":
        kwargs.setdefault("patch_size", 3)
        kwargs.setdefault("batch_size", 100)
        center_pixel = True
        model = LuoEtAl(n_bands, n_classes, patch_size=kwargs["patch_size"])
        opt = {"name": "SGD", "learning_rate": kwargs.setdefault("learning_rate", 0.1),
               "weight_decay": 0.09}
    elif name == "sharma":
        kwargs.setdefault("batch_size", 60)
        epoch = kwargs.setdefault("epoch", 30)
        # MultiStepLR decaying x0.1 at epoch//2 and 5*epoch//6 (DeepHyperX/models.py:137-143)
        kwargs.setdefault("scheduler", {"type": "MultiStepLR",
                                        "milestones": [epoch // 2, (5 * epoch) // 6],
                                        "gamma": 0.1})
        center_pixel = True
        kwargs.setdefault("patch_size", 64)
        model = SharmaEtAl(n_bands, n_classes, patch_size=kwargs["patch_size"])
        opt = {"name": "SGD", "learning_rate": kwargs.setdefault("lr", 0.05),
               "weight_decay": 0.0005}
    elif name == "liu":
        kwargs["supervision"] = "semi"
        kwargs.setdefault("epoch", 40)
        center_pixel = True
        patch_size = kwargs.setdefault("patch_size", 9)
        model = LiuEtAl(n_bands, n_classes, patch_size=patch_size)
        opt = {"name": "SGD", "learning_rate": kwargs.setdefault("lr", 0.001)}
    elif name == "boulch":
        kwargs["supervision"] = "semi"
        kwargs.setdefault("patch_size", 1)
        kwargs.setdefault("epoch", 100)
        center_pixel = True
        model = BoulchEtAl(n_bands, n_classes)
        opt = {"name": "SGD", "learning_rate": kwargs.setdefault("lr", 0.001)}
    elif name == "mou":
        kwargs.setdefault("patch_size", 1)
        center_pixel = True
        kwargs.setdefault("epoch", 100)
        model = MouEtAl(n_bands, n_classes)
        opt = {"name": "Adadelta", "learning_rate": kwargs.setdefault("lr", 1.0)}
    else:
        raise KeyError(f"{name} model is unknown.")

    kwargs.setdefault("epoch", 100)
    kwargs.setdefault("batch_size", 100)
    kwargs.setdefault("supervision", "full")
    kwargs.setdefault("flip_augmentation", False)
    kwargs.setdefault("radiation_augmentation", False)
    kwargs.setdefault("mixture_augmentation", False)
    kwargs["center_pixel"] = center_pixel
    opt.setdefault("weight_decay", 0.0)
    model.init_weights(int(kwargs.get("seed", 0)))
    return model, opt, {"type": "cross_entropy", "weight": weights}, kwargs


ZOO_NAMES = ("nn", "hu", "hamida", "lee", "chen", "li", "he", "luo", "sharma", "liu", "boulch",
             "mou")


__all__ = ["Baseline", "BatchNorm", "BoulchEtAl", "ChenEtAl", "HamidaEtAl", "HeEtAl", "HuEtAl",
           "LeeEtAl", "LiEtAl", "LiuEtAl", "LuoEtAl", "MouEtAl", "SharmaEtAl", "ZOO_NAMES",
           "ZooNet", "get_model"]
