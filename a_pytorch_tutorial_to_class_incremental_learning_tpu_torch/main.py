"""CLI entry point.

Run as ``python -m a_pytorch_tutorial_to_class_incremental_learning_tpu_torch``
with the JAX package's flags; the race recipe on CUDA::

    python -m a_pytorch_tutorial_to_class_incremental_learning_tpu_torch \\
        --data_set synthetic_hard128 --backbone resnet32 --num_bases 50 \\
        --increment 10 --batch_size 128 --memory_size 256 --aa none \\
        --color_jitter 0 --num_epochs 20 --use_pallas_loss

``--platform cpu`` runs on the CPU; the default needs a CUDA device.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .config import config_from_args, get_args_parser
from .engine import CilTrainer


def build_trainer(argv: Optional[Sequence[str]] = None) -> CilTrainer:
    parser = argparse.ArgumentParser(
        "Class-Incremental Learning training and evaluation script (PyTorch)",
        parents=[get_args_parser()],
    )
    args = parser.parse_args(argv)
    if args.host_devices:
        raise NotImplementedError(
            "--host_devices is not ported yet: multi-device runs arrive with "
            "the data parallel slice of the PyTorch port"
        )
    return CilTrainer(config_from_args(args), device=args.platform)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    return build_trainer(argv).fit()


if __name__ == "__main__":
    main()
