"""The CIL model: backbone plus the static masked head.

Counterpart of the JAX package's ``models/cil_model.py``.  ``forward`` returns
``(masked logits [B, width], features [B, 64])``; ``grow`` and ``align`` are
the between-task head updates, done in place on the module.  The teacher is a
``copy.deepcopy`` of the student (``engine/loop.py``), never an alias.

On a model axis the module holds its rank's shard of the head
(``parallel/mesh.py`` ``param_sharding``) and the logits are still the full
width on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ..ops.precision import PRESETS, Policy
from ..parallel.mesh import DataAxis, ModelAxis, param_sharding
from .classifier import grow_head, masked_logits, weight_align
from .resnet import get_backbone


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


class CilModel(nn.Module):
    """Backbone plus the full-width masked head, in the dtypes of
    ``policy`` (``ops/precision.py``); the logits are f32 under every
    preset.  ``width`` is the full head's; with a ``model_axis`` whose size
    divides it, ``fc`` holds this rank's ``width / m`` rows and
    ``head_axis`` is that axis (None for a whole head)."""

    def __init__(self, backbone_name: str = "resnet32", width: int = 100,
                 generator: Optional[torch.Generator] = None,
                 bn_group_size: int = 0, axis: Optional[DataAxis] = None,
                 policy: Policy = PRESETS["f32"], model_axis: Optional[ModelAxis] = None):
        super().__init__()
        self.policy = policy
        self.width = width
        self.backbone = get_backbone(backbone_name, generator, bn_group_size, axis, policy)
        out_dim = self.backbone.out_dim
        model_axis = model_axis or ModelAxis()
        sharded = param_sharding(model_axis, "fc.weight", (width, out_dim)) is not None
        self.head_axis = model_axis if sharded else None
        # Allocated zero; `grow` fills each task's rows.
        self.fc = nn.Linear(out_dim, width // model_axis.size if sharded else width)
        with torch.no_grad():
            self.fc.weight.zero_()
            self.fc.bias.zero_()

    def forward(
        self, x: torch.Tensor, num_active: Union[int, torch.Tensor], train: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.backbone(x, train=train)
        logits = masked_logits(feats, self.fc.weight, self.fc.bias, num_active,
                               self.policy.head_dtype, self.head_axis)
        return logits, feats

    def extract_vector(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.backbone(x, train=train)


def create_model(backbone_name: str, nb_classes: int, seed: int = 0,
                 bn_group_size: int = 0, axis: Optional[DataAxis] = None,
                 policy: Policy = PRESETS["f32"], width_multiple: int = 1,
                 model_axis: Optional[ModelAxis] = None) -> CilModel:
    """Build the model with backbone weights drawn from ``seed`` and a zero
    (fully inactive) head, on the CPU; the caller moves it to its device.
    The head is ``nb_classes`` rounded up to a multiple of
    ``width_multiple`` wide (JAX ``create_model``: the model-axis size, so
    that the head shards), held as this rank's shard on ``model_axis``.
    ``bn_group_size`` > 0 selects ``GroupedBatchNorm``; ``axis`` is the data
    axis its BN layers reduce over; ``policy`` the precision preset.  The
    input channels come with the backbone's name (JAX's ``channels`` only
    shapes its init's dummy input)."""
    generator = torch.Generator().manual_seed(seed)
    width = round_up(nb_classes, max(width_multiple, 1))
    return CilModel(backbone_name, width, generator, bn_group_size, axis, policy, model_axis)


def grow(model: CilModel, generator: torch.Generator, known: int, nb_new: int) -> None:
    """Activate (initialize) the next task's head rows."""
    grow_head(model.fc, generator, known, nb_new, model.head_axis)


def align(model: CilModel, known: int, nb_new: int) -> float:
    """Post-task weight alignment; returns gamma."""
    return float(weight_align(model.fc, known, nb_new, model.head_axis))


_FREEZE_NAMES = ("fc", "backbone", "all")


def freeze_mask(model: CilModel, names: Sequence[str] = ("all",)) -> Dict[str, bool]:
    """``{parameter name: frozen}`` in ``named_parameters`` order (JAX
    ``freeze_mask``, the reference's ``freeze_parameters``): ``"fc"``
    freezes the head, ``"backbone"`` the feature extractor, ``"all"``
    everything.  ``engine.sgd_update(frozen=...)`` consumes it."""
    for name in names:
        if name not in _FREEZE_NAMES:
            raise NotImplementedError(f"Unknown module name to freeze {name}")
    return {n: "all" in names or n.split(".")[0] in names for n, _ in model.named_parameters()}
