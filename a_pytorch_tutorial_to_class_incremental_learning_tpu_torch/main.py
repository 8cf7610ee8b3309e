"""CLI entry point.

Run as ``python -m a_pytorch_tutorial_to_class_incremental_learning_tpu_torch``
with the JAX package's flags; its dynamics protocol (RandAugment, the
parser's default) on CUDA::

    python -m a_pytorch_tutorial_to_class_incremental_learning_tpu_torch \\
        --data_set synthetic_hard128 --backbone resnet32 --num_bases 50 \\
        --increment 10 --batch_size 128 --memory_size 256 --num_epochs 35 \\
        --use_pallas_loss [--precision f32|bf16_all|bf16_selective]

``--platform cpu`` runs on the CPU; the default needs a CUDA device.

Data parallel over N cards, one process each, with ``--batch_size`` per
process (the global batch is N times it)::

    torchrun --nproc_per_node N -m a_pytorch_tutorial_to_class_incremental_learning_tpu_torch \
        <flags> --mesh_data N

(``gloo`` with ``--platform cpu``, ``nccl`` on CUDA).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch.distributed as dist

from .config import config_from_args, get_args_parser
from .engine import CilTrainer
from .parallel import init_distributed_mode


def build_trainer(argv: Optional[Sequence[str]] = None) -> CilTrainer:
    parser = argparse.ArgumentParser(
        "Class-Incremental Learning training and evaluation script (PyTorch)",
        parents=[get_args_parser()],
    )
    args = parser.parse_args(argv)
    if args.host_devices:
        raise NotImplementedError(
            "--host_devices is not ported yet: multi-device runs arrive with "
            "a later slice of the PyTorch port (launch one process per "
            "device with torchrun instead)"
        )
    init_distributed_mode(args.dist_url, args.platform)
    return CilTrainer(config_from_args(args), device=args.platform)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the experiment; a process group this call made is destroyed on
    the way out (one the caller made stays)."""
    owned = not dist.is_initialized()
    try:
        return build_trainer(argv).fit()
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
