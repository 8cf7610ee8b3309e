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
    JAX_PLATFORMS=cpu python tests/test_torch_race_init.py ks 20        # the laws' shapes

``save`` writes JAX's seed-0 weights for ``chip_smoke.py race ... --init_state
build/jax_seed0_init.pt``, which runs the whole protocol on the card from
them.  ``ks`` runs a two-sample Kolmogorov-Smirnov test a layer, the
port's draws against JAX's over ``K`` seeds a side (seeds 0..K-1), for
resnet32 and the task-0 head; it is a measurement, not a test of the
suite.  The tests hold the helper to the JAX trainer's own initial state, and
the port's initial weights to the same law as JAX's, layer by layer.
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


def port_initial_state(seed: int, backbone: str, nb_classes: int, first_task: int) -> dict:
    """The port trainer's weights after growing the first task's head
    (``CilTrainer.__init__`` and ``_grow_state``), without its data."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine.loop import (
        _INIT_STREAM,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import (
        create_model,
        grow,
    )
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.platform import (
        derive_seed,
        make_generator,
    )

    model = create_model(backbone, nb_classes, seed=derive_seed(seed, _INIT_STREAM))
    grow(model, make_generator(model.fc.weight.device, seed, _INIT_STREAM, 0), 0, first_task)
    return model.state_dict()


def test_initial_weights_follow_jax_law_layer_by_layer():
    """Over K seeds, each initialized tensor of resnet32 and the task-0 head
    has the same mean and standard deviation in the port as in the JAX
    package: He normal over fan-out, ``N(0, 2 / (3·3·out))``, for every conv
    (JAX ``models/resnet.py:50``), ``U(±1/8)`` for the head's 50 rows and
    biases (JAX ``models/classifier.py:39-54``), BN at 1 and 0.  Bounds: 5
    standard errors of the pooled estimate, ``σ·sqrt(2/N)`` for the mean
    difference and ``sqrt(1/N)`` relative for the std difference of two
    samples of N values each; each side is also held to the law itself."""
    seeds = range(6)
    port = [port_initial_state(s, "resnet32", 100, 50) for s in seeds]
    jaxs = [jax_initial_state(s, "resnet32", 100, 50) for s in seeds]
    assert port[0].keys() == jaxs[0].keys()
    checked = 0
    for name, ref in port[0].items():
        if name.endswith(("running_mean", "running_var")) or ".bn" in name:
            for p, j in zip(port, jaxs):
                np.testing.assert_array_equal(p[name].numpy(), j[name].numpy(), err_msg=name)
            continue
        rows = slice(0, 50) if name.startswith("fc.") else slice(None)
        a = np.concatenate([p[name][rows].numpy().ravel() for p in port]).astype(np.float64)
        b = np.concatenate([j[name][rows].numpy().ravel() for j in jaxs]).astype(np.float64)
        if ref.dim() == 4:
            sigma = np.sqrt(2.0 / (ref.shape[2] * ref.shape[3] * ref.shape[0]))
        else:
            sigma = 1.0 / 8.0 / np.sqrt(3.0)  # U(-1/sqrt(64), 1/sqrt(64))
        n = a.size
        for x in (a, b):
            assert abs(x.mean()) < 5 * sigma / np.sqrt(n), name
            assert abs(x.std() / sigma - 1) < 5 / np.sqrt(2 * n), name
        assert abs(a.mean() - b.mean()) < 5 * sigma * np.sqrt(2.0 / n), name
        assert abs(a.std() / b.std() - 1) < 5 / np.sqrt(n), name
        if name.startswith("fc."):
            bound = 1.0 / 8.0
            assert a.min() >= -bound and a.max() <= bound and b.min() >= -bound, name
        checked += 1
    assert checked == 31 + 2  # 31 convs, the head's weight and bias


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
    import torch

    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.telemetry import StallClock

    ces = []
    trainer._lam.fill_(0.5)
    for epoch in range(epochs):
        trainer._lr.fill_(cosine_lr(0.1, epoch, 35))
        gen = torch.Generator().manual_seed(epoch)
        rows = trainer._run_epoch_steps(0, task, epoch, gen, StallClock())
        ces.append(float(np.mean([r["ce"] for r in rows])))
        print(f"seed {seed} {'port' if port_init else 'JAX'} initial weights: epoch "
              f"{epoch + 1} train CE {ces[-1]:.4f}", flush=True)
    return ces


def ks_layers(nb_seeds: int) -> list:
    """Per initialized tensor of resnet32 and the task-0 head (its 50 rows):
    the two-sample KS statistic and p-value of the port's values against
    JAX's, each pooled over seeds ``0..nb_seeds-1``.  Prints one line a
    layer, then the smallest p-value and the count below 0.01 and below the
    Bonferroni bound 0.01 / layers."""
    from scipy.stats import ks_2samp

    port = [port_initial_state(s, "resnet32", 100, 50) for s in range(nb_seeds)]
    jaxs = [jax_initial_state(s, "resnet32", 100, 50) for s in range(nb_seeds)]
    rows = []
    for name, ref in port[0].items():
        if name.endswith(("running_mean", "running_var")) or ".bn" in name:
            continue  # constants on both sides (1 and 0), held equal by the test above
        cut = slice(0, 50) if name.startswith("fc.") else slice(None)
        a = np.concatenate([p[name][cut].numpy().ravel() for p in port])
        b = np.concatenate([j[name][cut].numpy().ravel() for j in jaxs])
        res = ks_2samp(a, b)
        rows.append((name, a.size, float(res.statistic), float(res.pvalue)))
        print(f"{name:45s} n={a.size:8d} D={res.statistic:.5f} p={res.pvalue:.4g}", flush=True)
    p = [r[3] for r in rows]
    print(f"layers {len(rows)}, seeds {nb_seeds} a side: min p {min(p):.4g}, "
          f"p < 0.01: {sum(x < 0.01 for x in p)}, p < 0.01/{len(rows)} (Bonferroni): "
          f"{sum(x < 0.01 / len(rows) for x in p)}")
    return rows


if __name__ == "__main__":
    if sys.argv[1] == "ks":
        ks_layers(int(sys.argv[2]))
    elif sys.argv[1] == "save":
        import torch

        torch.save(jax_initial_state(int(sys.argv[2]), "resnet32", 100, 50), sys.argv[3])
    else:
        probe(int(sys.argv[1]), int(sys.argv[2]), "--port" in sys.argv[3:])
