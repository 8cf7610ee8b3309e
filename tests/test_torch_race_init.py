"""JAX's initial weights for a seed, in the port's layout, and a probe that
trains the port's first task from them on the CPU.

The two packages draw their initial weights from different random streams
(``jax.random`` keys against ``torch.Generator`` seeds), so one ``--seed``
names two different networks.  Under RandAugment the first task of the
``b50_inc10_synthetic_hard128_aa35_mem256`` protocol can sit at the uniform
prediction (train CE ln 50 = 3.912) for several epochs before it learns, and
how long depends on the initial weights: the probe trains the port's task 0
from JAX's seed-``s`` weights, or from the port's own, to show which.

    JAX_PLATFORMS=cpu python tests/test_torch_race_init.py 0 10          # JAX's seed-0 weights
    JAX_PLATFORMS=cpu python tests/test_torch_race_init.py 0 10 --port   # the port's own
    JAX_PLATFORMS=cpu python tests/test_torch_race_init.py save 0 build/jax_seed0_init.pt

The last writes JAX's seed-0 weights for ``chip_smoke.py race ... --init_state
build/jax_seed0_init.pt``, which runs the whole protocol on the card from
them.  The test holds the helper to the JAX trainer's own initial state.
"""

import os
import sys

import numpy as np
import jax
from flax.core import unfreeze

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from a_pytorch_tutorial_to_class_incremental_learning_tpu import models as jm  # noqa: E402
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (  # noqa: E402
    from_jax_variables,
)


def jax_initial_state(seed: int, backbone: str, nb_classes: int, first_task: int) -> dict:
    """The JAX ``CilTrainer``'s weights after growing the first task's head
    (``engine/loop.py``: ``init_backbone`` from ``fold_in(PRNGKey(seed),
    0xC11)``, ``grow`` from the split's second key folded with task 0), as a
    port state dict."""
    model, variables = jm.create_model(backbone, nb_classes)
    init_key, grow_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 0xC11))
    variables = jm.init_backbone(variables, init_key, model)
    variables = jm.grow(variables, jax.random.fold_in(grow_key, 0), 0, first_task)
    variables = jax.device_get(unfreeze(variables))
    return from_jax_variables(variables["params"], variables["batch_stats"])


def test_jax_initial_state_is_the_jax_trainers():
    from a_pytorch_tutorial_to_class_incremental_learning_tpu.config import CilConfig
    from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine.loop import CilTrainer

    cfg = CilConfig(data_set="synthetic10", num_bases=0, increment=5, backbone="resnet20",
                    batch_size=8, seed=3, aa=None, color_jitter=0.0)
    trainer = CilTrainer(cfg, init_dist=False)
    state = trainer._grow_state(trainer.state, 0, 0, 5)
    want = from_jax_variables(jax.device_get(unfreeze(state.params)),
                              jax.device_get(unfreeze(state.batch_stats)))
    got = jax_initial_state(3, "resnet20", 10, 5)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


def probe(seed: int, epochs: int, port_init: bool) -> list:
    """Mean train CE of each of the first ``epochs`` epochs of task 0 of the
    protocol (35-epoch schedule), the port on the CPU, from JAX's seed-``s``
    weights or (``port_init``) the port's own."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine.train import cosine_lr
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer

    trainer = build_trainer([
        "--platform", "cpu", "--data_set", "synthetic_hard128", "--backbone", "resnet32",
        "--num_bases", "50", "--increment", "10", "--batch_size", "128",
        "--memory_size", "256", "--num_epochs", "35", "--seed", str(seed)])
    task = next(iter(trainer.scenario_train))
    trainer._grow_state(0, 0, 50)
    if not port_init:
        trainer.state.model.load_state_dict(jax_initial_state(seed, "resnet32", 100, 50))
    ces = []
    for epoch in range(epochs):
        rows = trainer._run_epoch_steps(0, task, epoch, cosine_lr(0.1, epoch, 35), 0.5,
                                        {"host_s": 0.0, "device_s": 0.0})
        ces.append(float(np.mean([r["ce"] for r in rows])))
        print(f"seed {seed} {'port' if port_init else 'JAX'} initial weights: epoch "
              f"{epoch + 1} train CE {ces[-1]:.4f}", flush=True)
    return ces


if __name__ == "__main__":
    if sys.argv[1] == "save":
        import torch

        torch.save(jax_initial_state(int(sys.argv[2]), "resnet32", 100, 50), sys.argv[3])
    else:
        probe(int(sys.argv[1]), int(sys.argv[2]), "--port" in sys.argv[3:])
