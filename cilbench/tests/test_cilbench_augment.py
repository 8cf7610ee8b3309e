"""The plain augmentation (``reference/augment.py``) on the port's draws
gives the port's batch, value for value, for every op of the policy."""

import pytest
import torch

from cilbench.reference import augment as plain

PORT = "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_augmentation_is_the_ports(seed):
    import importlib

    port = importlib.import_module(f"{PORT}.data.augment")
    cfg = port.AugmentConfig(input_size=32)
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (128, 32, 32, 3), dtype=torch.uint8, generator=g)
    x[:6] = 7  # flat images: autocontrast's and equalize's identity
    d = port.draw_params(128, cfg, g, (32, 32, 3))
    applied = d.ra_op[d.ra_apply]
    assert len(torch.unique(applied)) == port.NUM_RA_OPS  # every op is exercised
    got = plain.train_batch(x, {k: v for k, v in vars(d).items() if v is not None},
                            padding=4, mean=cfg.mean, std=cfg.std)
    assert torch.equal(got, port.augment(x, d, cfg))


def test_draws_it_has_no_plain_version_of_raise():
    x = torch.zeros(2, 32, 32, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="jitter"):
        plain.train_batch(x, {"jitter": torch.ones(2, 3)}, padding=4, mean=(0,) * 3,
                          std=(1,) * 3)
