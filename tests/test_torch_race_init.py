"""The trainer's initial network against the JAX trainer's, and the tools
of the seed-0 plateau question.

Both packages draw the initial backbone and each task's head from JAX's
keys for ``--seed`` (the port through ``utils/jax_random.py``), so one
seed names one network.  The port used to draw them from
``torch.Generator`` streams instead, and under RandAugment the first task
of the ``b50_inc10_synthetic_hard128_aa35_mem256`` protocol sat at the
uniform prediction (train CE ln 50 = 3.912) for 15 epochs at seed 0 and
failed the race's gate.  Over seeds 0-15 the two draws' plateaus did not
differ in distribution (PERF.md; the sweep is
``experiments/plateau_sweep.jsonl``).

    JAX_PLATFORMS=cpu python tests/test_torch_race_init.py 0 10      # task 0's train CE, CPU
    JAX_PLATFORMS=cpu python tests/test_torch_race_init.py save 0 build/jax_seed0_init.pt
    python tests/test_torch_race_init.py plateau experiments/plateau_sweep.jsonl
    python tests/test_torch_race_init.py same <log_a.jsonl> <log_b.jsonl>

``save`` writes JAX's seed-``s`` weights after task 0's head grows, for
``chip_smoke.py race ... --init_state``.  ``plateau`` prints the two-sided
Mann-Whitney U test of the task-0 plateau epochs of a sweep's two sides
(one JSON object a line with ``side``, ``seed`` and
``task0_plateau_epochs``).  ``same`` compares two race logs record for
record, on what the training computed (epoch losses and accuracies, task
accuracies and γ, the final record).
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import (  # noqa: E402
    create_model,
    grow,
    trainer_keys,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import (  # noqa: E402
    jax_random,
)

def jax_initial_state(seed: int, backbone: str, nb_classes: int, first_task: int,
                      input_size: int = 32) -> dict:
    """The JAX ``CilTrainer``'s weights after growing the first task's head
    (``engine/loop.py``: ``init_backbone`` from ``fold_in(PRNGKey(seed),
    0xC11)``, ``grow`` from the split's second key folded with task 0), as a
    port state dict."""
    import jax
    from flax.core import unfreeze

    from a_pytorch_tutorial_to_class_incremental_learning_tpu import models as jm
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (
        from_jax_variables,
    )

    channels = 1 if "mnist" in backbone else 3
    model, variables = jm.create_model(backbone, nb_classes, input_size=input_size,
                                       channels=channels)
    init_key, grow_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 0xC11))
    variables = jm.init_backbone(variables, init_key, model, input_size, channels)
    variables = jm.grow(variables, jax.random.fold_in(grow_key, 0), 0, first_task)
    variables = jax.device_get(unfreeze(variables))
    return from_jax_variables(variables["params"], variables["batch_stats"])


def test_jax_initial_state_is_the_jax_trainers():
    import jax
    from flax.core import unfreeze

    from a_pytorch_tutorial_to_class_incremental_learning_tpu.config import CilConfig
    from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine.loop import CilTrainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (
        from_jax_variables,
    )

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
    model = create_model(backbone, nb_classes, seed=seed)
    grow(model, jax_random.fold_in(trainer_keys(seed)[1], 0), 0, first_task)
    return model.state_dict()


def test_initial_weights_follow_jax_law_layer_by_layer():
    """Over K seeds, each initialized tensor of resnet32 and the task-0 head
    has the same mean and standard deviation in the port as in the JAX
    package: He normal over fan-out, ``N(0, 2 / (3·3·out))``, for every conv
    (JAX ``models/resnet.py:50``), ``U(±1/8)`` for the head's 50 rows and
    biases (JAX ``models/classifier.py:39-54``), BN at 1 and 0.  Bounds: 5
    standard errors of the pooled estimate, ``σ·sqrt(2/N)`` for the mean
    difference and ``sqrt(1/N)`` relative for the std difference of two
    samples of N values each; each side is also held to the law itself.
    (The two sides are now one draw; ``tests/test_torch_jax_random.py``
    holds them bitwise.)"""
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


def plateau_test(path: str) -> dict:
    """The two-sided Mann-Whitney U test of the task-0 plateau epochs of the
    sweep's two sides (``side`` ``port`` against ``jax``)."""
    from scipy.stats import mannwhitneyu

    rows = [json.loads(ln) for ln in open(path) if ln.strip()]
    sides = {s: sorted((r["seed"], r["task0_plateau_epochs"]) for r in rows if r["side"] == s)
             for s in ("port", "jax")}
    a, b = ([n for _, n in sides[s]] for s in ("port", "jax"))
    res = mannwhitneyu(a, b, alternative="two-sided")
    out = {"n": [len(a), len(b)], "port": a, "jax": b, "median": [np.median(a), np.median(b)],
           "U": float(res.statistic), "p": float(res.pvalue)}
    print(json.dumps(out))
    return out


# The fields of a race log that the training computed (no clock readings).
_TRAINED = {"epoch": ("task_id", "epoch", "steps", "lr", "loss", "ce", "kd", "acc1", "acc5"),
            "task": ("task_id", "acc1", "acc1s", "acc_per_task", "gamma"),
            "final": ("acc1s", "avg_incremental_acc1")}


def same_run(log_a: str, log_b: str) -> dict:
    """Whether two race logs trained alike: their epoch, task and final
    records, field by field (``_TRAINED``); prints the count of equal
    records and the first that differs."""
    def trained(path):
        return [{k: r[k] for k in _TRAINED[r["type"]]} | {"type": r["type"]}
                for r in map(json.loads, open(path)) if r["type"] in _TRAINED]

    a, b = trained(log_a), trained(log_b)
    equal = 0
    for ra, rb in zip(a, b):
        if ra != rb:
            break
        equal += 1
    out = {"records": [len(a), len(b)], "equal": equal,
           "first_difference": None if equal == len(a) == len(b) else
           [a[equal] if equal < len(a) else None, b[equal] if equal < len(b) else None]}
    print(json.dumps(out))
    return out


def probe(seed: int, epochs: int) -> list:
    """Mean train CE of each of the first ``epochs`` epochs of task 0 of the
    protocol (35-epoch schedule), the port on the CPU from its initial
    weights for ``seed``."""
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine.train import cosine_lr
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.telemetry import StallClock

    trainer = build_trainer([
        "--platform", "cpu", "--data_set", "synthetic_hard128", "--backbone", "resnet32",
        "--num_bases", "50", "--increment", "10", "--batch_size", "128",
        "--memory_size", "256", "--num_epochs", "35", "--seed", str(seed)])
    task = next(iter(trainer.scenario_train))
    trainer._grow_state(0, 0, 50)
    ces = []
    trainer._lam.fill_(0.5)
    for epoch in range(epochs):
        trainer._lr.fill_(cosine_lr(0.1, epoch, 35))
        gen = torch.Generator().manual_seed(epoch)
        rows = trainer._run_epoch_steps(0, task, epoch, gen, StallClock())
        ces.append(float(np.mean([r["ce"] for r in rows])))
        print(f"seed {seed}: epoch {epoch + 1} train CE {ces[-1]:.4f}", flush=True)
    return ces


if __name__ == "__main__":
    if sys.argv[1] == "save":
        torch.save(jax_initial_state(int(sys.argv[2]), "resnet32", 100, 50), sys.argv[3])
    elif sys.argv[1] == "plateau":
        plateau_test(sys.argv[2])
    elif sys.argv[1] == "same":
        same_run(sys.argv[2], sys.argv[3])
    else:
        probe(int(sys.argv[1]), int(sys.argv[2]))
