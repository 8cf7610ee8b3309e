"""The fused epoch on the CPU, against the JAX package and the per-step path.

* The epoch's index table: the rows the per-step loader yields, and JAX's
  layout of a permutation (``jnp.resize(perm, (nb_steps, gb))``).
* The port's epoch function against JAX ``make_epoch_fn`` (resnet20, width
  10, n = 20, global batch 8: three steps, the last one wrapped, with a
  teacher), given JAX's permutation as its table and an augmentation with no
  randomness, so both see the same batches.  The JAX side runs in float64:
  XLA:CPU's float32 backward through the stride-2 convolutions lands ~1e-3
  (relative) off a float64 reference on this network
  (``tests/test_torch_train_step.py``).  Tolerances as there: loss rtol
  1e-4, parameters and momentum rtol 1e-4 / atol 1e-5; the whole epoch is
  held in float64 on both sides, the port's float32 epoch on its first
  step (see the test).
* A step clause on the fused path is settled after the epoch as the JAX
  trainer settles it.
"""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu import models as jm
from a_pytorch_tutorial_to_class_incremental_learning_tpu.data import augment as jaug
from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine import train as jt
from a_pytorch_tutorial_to_class_incremental_learning_tpu.parallel.mesh import make_mesh
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import (
    TaskSet,
    build_raw_dataset,
    epoch_index_table,
    train_batches,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment as taug
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.loader import index_table
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import CilTrainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import models as tm
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops.precision import PRESETS, Policy
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (
    from_jax_variables,
)
from faults import FaultInjected
from test_torch_checkpoint import _cfg, _records, deadline
from test_torch_train_step import HP, _as_param_list, _count, _setup
from test_torch_dist import two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

TEST_LIMIT_S = 120
N, GB = 20, 8  # dataset rows and global batch of the JAX comparison: 3 steps
NO_RANDOMNESS = dict(crop_padding=0, hflip=False, rand_augment=False, color_jitter=0.0,
                     reprob=0.0)


@pytest.fixture(autouse=True)
def _limit():
    with deadline(TEST_LIMIT_S):
        yield


@pytest.mark.parametrize("n", [13, 16, 20])
def test_index_table_is_the_loaders_and_jax_layout(n):
    task = TaskSet(np.zeros((n, 2, 2, 3), np.uint8), np.arange(n, dtype=np.int64),
                   np.zeros(n, np.int64))
    table = epoch_index_table(n, 8, seed=5)
    assert table.shape == (-(-n // 8), 8) and table.dtype == np.int64
    np.testing.assert_array_equal(table, np.stack([y for _, y in train_batches(task, 8, 5)]))
    # Two ranks read the columns of their stripe of the same table.
    stripes = [np.stack([y for _, y in train_batches(task, 8, 5, r, 2)]) for r in range(2)]
    np.testing.assert_array_equal(np.concatenate(stripes, axis=1), table)
    perm = jax.random.permutation(jax.random.fold_in(jax.random.PRNGKey(3), 0xC0FFEE), n)
    np.testing.assert_array_equal(index_table(np.asarray(perm), 8),
                                  np.asarray(jnp.resize(perm, (table.shape[0], 8))))


@pytest.fixture(scope="module")
def jax_epoch():
    """JAX ``make_epoch_fn`` over one epoch, in float64, and the inputs."""
    _, variables, teacher, momentum, _, _ = _setup(0.0)
    # Images, not noise: on noise the first conv's weight gradient is a sum
    # of terms of random sign, whose f32 rounding the comparison would see.
    (x, y), _ = build_raw_dataset("synthetic10", "", True)
    pick = np.random.RandomState(4).choice(len(y), N, replace=False)
    x, y = x[pick], y[pick].astype(np.int64)
    key = jax.random.PRNGKey(9)
    perm = jax.random.permutation(jax.random.fold_in(key, 0xC0FFEE), N)
    table = np.asarray(jnp.resize(perm, (-(-N // GB), GB)))
    with jax.enable_x64(True):
        model = jm.CilModel(backbone_name="resnet20", width=10, dtype=jnp.float64)
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        epoch = jt.make_epoch_fn(model, jaug.AugmentConfig(**NO_RANDOMNESS), 0.1,
                                 HP["temperature"], HP["momentum"], HP["weight_decay"],
                                 has_teacher=True, mesh=make_mesh((1, 1), jax.devices()[:1]))
        state = jt.TrainState(params=f64(variables["params"]),
                              batch_stats=f64(variables["batch_stats"]),
                              momentum=f64(momentum), num_active=jnp.int32(10),
                              known=jnp.int32(5))
        t = jt.Teacher(params=f64(teacher["params"]), batch_stats=f64(teacher["batch_stats"]),
                       known=jnp.int32(5))
        state, metrics = epoch(state, t, jnp.asarray(x), jnp.asarray(y), key, HP["lr"],
                               HP["lam"], GB)
        out = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                     jax.device_get((state.params, state.batch_stats,
                                                     state.momentum, metrics)))
    return variables, teacher, momentum, x, y, table, out


def _port_epoch(variables, teacher, momentum, x, y, table, dtype, use_pallas_loss):
    """The port's epoch function over JAX's table, in ``dtype`` (float64
    through a policy that computes in float64 throughout)."""
    policy = (PRESETS["f32"] if dtype == torch.float32
              else Policy("f64", torch.float64, torch.float64, torch.float64))

    def model(v):
        m = tm.CilModel("resnet20", 10, policy=policy)
        m.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]))
        return m.to(dtype)

    student = model(variables)
    state = tt.TrainState(student, [m.to(dtype) for m in _as_param_list(
        student, momentum, variables["batch_stats"])], _count(10), _count(5))
    t = tt.Teacher(model(teacher).requires_grad_(False), _count(5))
    epoch = tt.make_epoch_fn(taug.AugmentConfig(**NO_RANDOMNESS), policy, 0.1,
                             HP["temperature"], HP["momentum"], HP["weight_decay"],
                             use_pallas_loss=use_pallas_loss)
    assert not epoch.graphed
    rows = epoch(state, t, torch.from_numpy(x.copy()), torch.from_numpy(y),
                 torch.from_numpy(table), torch.Generator(), torch.tensor(HP["lr"], dtype=dtype),
                 torch.tensor(HP["lam"], dtype=dtype))
    assert rows.shape == (3, len(tt.METRICS))
    return student, state.momentum, dict(zip(tt.METRICS, rows.double().numpy().T))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_epoch_fn_matches_jax_make_epoch_fn(jax_epoch, dtype):
    """float64: the whole epoch (every step's loss, then the parameters,
    momentum and BN statistics).  float32, through the loss kernel's plain
    version: the first step's loss terms.  Over three steps at this size
    float32 rounding grows to ~3e-3 in the parameters: the port's own
    float32 epoch on 1 and on 8 threads differs by as much as from the
    float64 one, so the whole epoch is held in float64."""
    variables, teacher, momentum, x, y, table, (params, stats, buf, metrics) = jax_epoch
    f64 = dtype == "float64"
    student, mom, got = _port_epoch(variables, teacher, momentum, x, y, table,
                                    torch.float64 if f64 else torch.float32,
                                    use_pallas_loss=not f64)
    steps = slice(None) if f64 else slice(0, 1)
    for k in ("ce", "kd", "loss"):
        np.testing.assert_allclose(got[k][steps], metrics[k][steps], rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["acc1"][steps], metrics["acc1"][steps])
    if not f64:
        return
    ref_sd = from_jax_variables(params, stats)
    ref_mom = _as_param_list(student, buf, stats)
    sd = student.state_dict()
    for (name, _), m, want in zip(student.named_parameters(), mom, ref_mom):
        np.testing.assert_allclose(sd[name].float().numpy(), ref_sd[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(m.float().numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    for name in sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].float().numpy(), ref_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_step_clause_on_the_fused_path_reconciles_as_jax(tmp_path):
    """``raise@task0.epoch1.step2`` on the fused path: raised after the
    epoch with the clause's coordinates, one ledger line, ``reconciled``.
    The JAX trainer's own run of this scenario (the synthetic10 config of
    ``tests/test_faults.py``, 1 epoch, an (8, 1) mesh) gave exactly these
    values: ``FaultInjected`` at ``{task 0, epoch 1, step 2}`` and the one
    ledger line ``{"spec": "raise@task0.epoch1.step2", "site":
    "engine.step", "task": 0, "epoch": 1, "step": 2, "reconciled": true}``
    (20 s of wall on the CPU, so its values are pinned here instead of
    rerun)."""
    ckpt = str(tmp_path / "ckpts")
    t = CilTrainer(_cfg(ckpt_dir=ckpt, num_epochs=1, fault_spec="raise@task0.epoch1.step2",
                        log_file=str(tmp_path / "run.jsonl")), device="cpu")
    assert t.config.fused_epochs
    with pytest.raises(FaultInjected) as info:
        t.fit()
    assert info.value.site == "engine.step"
    assert info.value.coords == {"task": 0, "epoch": 1, "step": 2}
    assert t.global_step == 40  # the whole epoch ran: 320 rows at batch 8
    ledger = [json.loads(ln) for ln in open(os.path.join(ckpt, "fault_ledger.jsonl"))]
    assert len(ledger) == 1
    assert {k: ledger[0][k] for k in ("spec", "site", "task", "epoch", "step", "reconciled")} \
        == {"spec": "raise@task0.epoch1.step2", "site": "engine.step", "task": 0, "epoch": 1,
            "step": 2, "reconciled": True}
    fired = [r for r in _records(str(tmp_path / "run.jsonl")) if r["type"] == "fault_injected"]
    assert len(fired) == 1 and fired[0]["reconciled"] is True
