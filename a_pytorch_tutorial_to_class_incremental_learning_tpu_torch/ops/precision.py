"""The precision presets and the registry of policy-compatible kernels.

Counterpart of the JAX package's ``ops/precision.py``.  A :class:`Policy`
names three dtypes:

* ``compute_dtype``: the operands of every convolution (the f32 master
  weight is cast at the call, never in the parameter store);
* ``act_dtype``: the activations between ops (each convolution's output is
  cast to it before BatchNorm; ReLU, the residual add and the pooling run
  in it; BatchNorm reduces its statistics in f32 whatever it is);
* ``head_dtype``: the operands of the classifier head, whose logits are f32
  all the same (the product of two bf16 values is exact in f32, so the head
  rounds its operands and multiplies in f32: JAX's
  ``preferred_element_type=float32``).

The casts sit at the JAX package's cast points, written out in the models:
``torch.autocast`` would hand BatchNorm bf16 conv outputs under every bf16
preset, so it cannot express ``bf16_selective``'s f32 activations.

Fixed for every preset (the policy's contract, not knobs): master
parameters and SGD momentum (``PARAM_DTYPE``), BatchNorm running statistics
(``STAT_DTYPE``), the logits the losses read (``LOGITS_DTYPE``) and the
loss accumulation (``LOSS_DTYPE``) are float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet

import torch

PARAM_DTYPE = torch.float32   # master params + optimizer momentum
STAT_DTYPE = torch.float32    # BatchNorm running statistics
LOGITS_DTYPE = torch.float32  # logits as seen by the losses
LOSS_DTYPE = torch.float32    # CE / KD accumulation


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (numpy's and JAX's names)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Policy:
    """A named precision configuration (see the module docstring)."""

    name: str
    compute_dtype: torch.dtype
    act_dtype: torch.dtype
    head_dtype: torch.dtype

    def describe(self) -> Dict[str, str]:
        """JSON-friendly summary for records."""
        return {
            "name": self.name,
            "compute_dtype": dtype_name(self.compute_dtype),
            "act_dtype": dtype_name(self.act_dtype),
            "head_dtype": dtype_name(self.head_dtype),
            "param_dtype": dtype_name(PARAM_DTYPE),
            "logits_dtype": dtype_name(LOGITS_DTYPE),
        }


PRESETS: Dict[str, Policy] = {
    "f32": Policy("f32", compute_dtype=torch.float32, act_dtype=torch.float32,
                  head_dtype=torch.float32),
    "bf16_all": Policy("bf16_all", compute_dtype=torch.bfloat16, act_dtype=torch.bfloat16,
                       head_dtype=torch.float32),
    "bf16_selective": Policy("bf16_selective", compute_dtype=torch.bfloat16,
                             act_dtype=torch.float32, head_dtype=torch.bfloat16),
}

# The two values of the --compute_dtype flag, mapped onto the presets.
_COMPUTE_DTYPE_ALIASES = {"float32": "f32", "bfloat16": "bf16_all"}


def get_policy(name: str) -> Policy:
    """Preset name (or ``--compute_dtype`` alias) -> :class:`Policy`."""
    key = _COMPUTE_DTYPE_ALIASES.get(name, name)
    try:
        return PRESETS[key]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {name!r}; choose from {sorted(PRESETS)}"
        ) from None


def policy_from_config(config) -> Policy:
    """The run's policy: ``--precision`` when set, else the
    ``--compute_dtype`` alias."""
    precision = getattr(config, "precision", "") or ""
    if precision:
        return get_policy(precision)
    return get_policy(getattr(config, "compute_dtype", "float32"))


# --------------------------------------------------------------------------- #
# Policy-compatible kernel registry
# --------------------------------------------------------------------------- #
# A kernel opts in per preset: it is compatible when its numerics keep the
# contract above (f32 accumulation over f32 logits) under that preset.  The
# train step consults the registry before it routes the loss through a
# kernel, and refuses a combination that is not registered.

_KERNEL_REGISTRY: Dict[str, FrozenSet[str]] = {}


def register_policy_kernel(kernel_name: str, *policy_names: str) -> None:
    """Declare ``kernel_name`` numerically valid under the named presets."""
    for p in policy_names:
        if p not in PRESETS:
            raise ValueError(f"unknown policy {p!r} for kernel {kernel_name!r}")
    _KERNEL_REGISTRY[kernel_name] = frozenset(policy_names)


def kernel_policies(kernel_name: str) -> FrozenSet[str]:
    """The presets a kernel is registered for (empty: unregistered)."""
    return _KERNEL_REGISTRY.get(kernel_name, frozenset())


def kernel_policy_compatible(kernel_name: str, policy: Policy) -> bool:
    return policy.name in _KERNEL_REGISTRY.get(kernel_name, frozenset())
