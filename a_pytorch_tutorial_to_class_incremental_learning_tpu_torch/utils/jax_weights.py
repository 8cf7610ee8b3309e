"""Carry JAX (flax) variables over to the port's ``state_dict``.

The port's submodules carry the flax names, so the mapping is per leaf:

- conv ``kernel`` HWIO -> ``weight`` OIHW;
- BN ``scale``/``bias`` -> ``weight``/``bias``, and ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var``;
- ``fc_kernel [64, W]`` -> ``fc.weight [W, 64]``; ``fc_bias`` -> ``fc.bias``.

Inputs are nested mappings of numpy arrays (``jax.device_get`` of the
variables); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def from_jax_variables(
    params: Mapping, batch_stats: Optional[Mapping] = None
) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) of a ``CilModel`` or a bare
    ``CifarResNet`` -> a ``state_dict`` for the port's matching module."""
    out: Dict[str, torch.Tensor] = {}

    def walk(p: Mapping, s: Mapping, prefix: str) -> None:
        for name, v in p.items():
            if name == "fc_kernel":
                out[f"{prefix}fc.weight"] = _tensor(np.asarray(v).T)
                continue
            if name == "fc_bias":
                out[f"{prefix}fc.bias"] = _tensor(v)
                continue
            if not isinstance(v, Mapping):
                raise ValueError(f"unexpected leaf {prefix}{name}")
            key = f"{prefix}{name}"
            if "kernel" in v:
                out[f"{key}.weight"] = _tensor(np.asarray(v["kernel"]).transpose(3, 2, 0, 1))
            elif "scale" in v:
                stats = s[name]
                out[f"{key}.weight"] = _tensor(v["scale"])
                out[f"{key}.bias"] = _tensor(v["bias"])
                out[f"{key}.running_mean"] = _tensor(stats["mean"])
                out[f"{key}.running_var"] = _tensor(stats["var"])
            else:
                walk(v, s.get(name, {}), f"{key}.")

    walk(params, batch_stats or {}, "")
    return out
