"""The CIL model: backbone plus the static masked head.

Counterpart of the JAX package's ``models/cil_model.py``.  ``forward`` returns
``(masked logits [B, width], features [B, 64])``; ``grow`` and ``align`` are
the between-task head updates, done in place on the module.  The teacher is a
``copy.deepcopy`` of the student (``engine/loop.py``), never an alias.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from ..ops.precision import PRESETS, Policy
from ..parallel.mesh import DataAxis
from .classifier import grow_head, masked_logits, weight_align
from .resnet import get_backbone


class CilModel(nn.Module):
    """Backbone plus the full-width masked head, in the dtypes of
    ``policy`` (``ops/precision.py``); the logits are f32 under every
    preset."""

    def __init__(self, backbone_name: str = "resnet32", width: int = 100,
                 generator: Optional[torch.Generator] = None,
                 bn_group_size: int = 0, axis: Optional[DataAxis] = None,
                 policy: Policy = PRESETS["f32"]):
        super().__init__()
        self.policy = policy
        self.backbone = get_backbone(backbone_name, generator, bn_group_size, axis, policy)
        # Allocated zero; `grow` fills each task's rows.
        self.fc = nn.Linear(self.backbone.out_dim, width)
        with torch.no_grad():
            self.fc.weight.zero_()
            self.fc.bias.zero_()

    def forward(
        self, x: torch.Tensor, num_active: Union[int, torch.Tensor], train: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.backbone(x, train=train)
        logits = masked_logits(feats, self.fc.weight, self.fc.bias, num_active,
                               self.policy.head_dtype)
        return logits, feats

    def extract_vector(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.backbone(x, train=train)


def create_model(backbone_name: str, nb_classes: int, seed: int = 0,
                 bn_group_size: int = 0, axis: Optional[DataAxis] = None,
                 policy: Policy = PRESETS["f32"]) -> CilModel:
    """Build the model with backbone weights drawn from ``seed`` and a zero
    (fully inactive) ``nb_classes``-wide head, on the CPU; the caller moves
    it to its device.  ``bn_group_size`` > 0 selects ``GroupedBatchNorm``;
    ``axis`` is the data axis its BN layers reduce over; ``policy`` the
    precision preset."""
    generator = torch.Generator().manual_seed(seed)
    return CilModel(backbone_name, nb_classes, generator, bn_group_size, axis, policy)


def grow(model: CilModel, generator: torch.Generator, known: int, nb_new: int) -> None:
    """Activate (initialize) the next task's head rows."""
    grow_head(model.fc, generator, known, nb_new)


def align(model: CilModel, known: int, nb_new: int) -> float:
    """Post-task weight alignment; returns gamma."""
    return float(weight_align(model.fc, known, nb_new))
