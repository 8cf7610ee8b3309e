"""The data-parallel train step at two ``gloo`` ranks on the CPU.

Two train steps (the first without a teacher, the second with one) at 2
ranks x 4 rows against a test-local float64 JAX composition of
``CilModel.apply`` + ``cross_entropy`` + λ·``soft_target_kd`` +
``sgd_update`` on the global batch of 8 (the one of
``tests/test_torch_train_step.py``), from identical weights on identical
pre-augmented batches, with and without ``use_pallas_loss`` (the sharded
fused loss) and with global BN and groups of 4; and once with RandAugment
on (the parser's default policy): each rank augments its stripe of the uint8
global batch inside the train step, drawing for the global batch, and the
JAX step runs on the port's one-process augmentation of the whole batch
with the same seed (``jax.random`` draws cannot be replayed in torch; the
augmentation itself is held to JAX in ``tests/test_torch_augment.py``).
Loss rtol 1e-4;
parameters, momentum and BN stats rtol 1e-4 / atol 1e-5 (the tolerances of
the single-process step test); the two ranks' states bitwise equal.  The
CLI at two ranks is ``tests/test_torch_dp_cli.py``.
"""

import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from flax.core import unfreeze

from a_pytorch_tutorial_to_class_incremental_learning_tpu import models as jm
from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine import losses as jl
from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine import train as jt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import models as tm
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (
    from_jax_variables,
)
from test_torch_dist import spawn_ranks, two_intra_op_threads  # noqa: F401
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment as taug

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")

HP = dict(lr=0.05, momentum=0.9, weight_decay=5e-4, lam=0.5, temperature=2.0, smooth=0.1)
# (use_pallas_loss, bn_group_size, RandAugment in the step)
CASES = [(pallas, g, False) for pallas in (False, True) for g in (0, 4)] + [(True, 0, True)]
AUG_SEED = 100  # step i augments with a generator seeded AUG_SEED + i


def _setup(g):
    """Teacher after task 0 (5 classes), student grown to 10 classes, a
    random momentum, and two normalized global batches of 8 with labels."""
    _, variables = jm.create_model("resnet20", nb_classes=10, bn_group_size=g)
    variables = jm.grow(variables, jax.random.PRNGKey(0), 0, 5)
    teacher = jax.device_get(unfreeze(variables))
    variables = jax.device_get(unfreeze(jm.grow(variables, jax.random.PRNGKey(1), 5, 5)))
    rng = np.random.RandomState(7)
    momentum = jax.tree_util.tree_map(
        lambda p: (0.01 * rng.randn(*p.shape)).astype(np.float32), variables["params"]
    )
    batches = [(rng.randn(8, 32, 32, 3).astype(np.float32),
                rng.randint(0, 10, 8).astype(np.int64)) for _ in range(2)]
    return variables, teacher, momentum, batches


def _u8_batches():
    rng = np.random.RandomState(9)
    return [rng.randint(0, 256, (8, 32, 32, 3)).astype(np.uint8) for _ in range(2)]


def _augmented(batches):
    """The two global batches as one process augments them (RandAugment,
    the parser's default), the labels unchanged."""
    cfg = taug.AugmentConfig()
    return [(taug.train_augment(torch.from_numpy(u8), cfg,
                                torch.Generator().manual_seed(AUG_SEED + i)).numpy(), y)
            for i, (u8, (_, y)) in enumerate(zip(_u8_batches(), batches))]


def _jax_two_steps(g, variables, teacher, momentum, batches):
    """Step 1 with λ = 0 (no teacher term), step 2 with λ and the teacher,
    in float64: see ``tests/test_torch_train_step.py::_jax_step``."""
    smooth = HP["smooth"]
    with jax.enable_x64(True):
        model = jm.CilModel(backbone_name="resnet20", width=10, dtype=jnp.float64,
                            bn_group_size=g)
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)

        @jax.jit
        def step(params, stats, buf, teacher, x, y, lam):
            def loss_fn(params):
                (logits, _), mutated = model.apply(
                    {"params": params, "batch_stats": stats}, x,
                    num_active=jnp.int32(10), train=True, mutable=["batch_stats"],
                )
                ce = jl.cross_entropy(logits, y, jnp.int32(10), smooth)
                t_logits, _ = model.apply(teacher, x, num_active=jnp.int32(5), train=False)
                kd = lam * jl.soft_target_kd(logits, t_logits, jnp.int32(5), HP["temperature"])
                return ce + kd, (mutated["batch_stats"], ce + kd)

            grads, (stats, loss) = jax.grad(loss_fn, has_aux=True)(params)
            params, buf = jt.sgd_update(params, grads, buf, HP["lr"], HP["momentum"],
                                        HP["weight_decay"])
            return params, stats, buf, loss

        params, stats, buf = f64(variables["params"]), f64(variables["batch_stats"]), f64(momentum)
        losses = []
        for (x, y), lam in zip(batches, (0.0, HP["lam"])):
            params, stats, buf, loss = step(params, stats, buf, f64(teacher), f64(x),
                                            jnp.asarray(y), jnp.float64(lam))
            losses.append(float(loss))
        out = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                     jax.device_get((params, unfreeze(stats), buf)))
    return out, losses


def _port_state_dict(params, stats):
    return {k: v.numpy() for k, v in from_jax_variables(params, stats).items()}


def _param_names():
    return [n for n, _ in tm.CilModel("resnet20", 10).named_parameters()]


_STEP_RANK = r"""
import os
import numpy as np
import torch
import torch.distributed as dist
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.augment import AugmentConfig
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import CilModel
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops.precision import PRESETS
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.parallel import (
    data_axis, init_distributed_mode,
)

HP = {hp}
init_distributed_mode(os.environ["DIST_URL"], "cpu")
axis = data_axis((2, 1))
count = lambda n: torch.tensor([n], dtype=torch.int32)
out = {{}}
for pallas, g, aug in {cases}:
    d = np.load(f"inputs_g{{g}}.npz")
    load = lambda prefix, model: model.load_state_dict(
        {{k[len(prefix):]: torch.from_numpy(d[k]) for k in d.files if k.startswith(prefix)}})
    student = CilModel("resnet20", 10, bn_group_size=g, axis=axis)
    load("student/", student)
    teacher = CilModel("resnet20", 10, bn_group_size=g, axis=axis).requires_grad_(False)
    load("teacher/", teacher)
    names = [n for n, _ in student.named_parameters()]
    state = tt.TrainState(student, [torch.from_numpy(d["momentum/" + n]).clone() for n in names],
                          count(10), count(5))
    rows = slice(axis.rank * 4, (axis.rank + 1) * 4)
    losses = []
    step = tt.make_train_step(AugmentConfig(), PRESETS["f32"], HP["smooth"], HP["temperature"],
                              HP["momentum"], HP["weight_decay"], use_pallas_loss=pallas,
                              axis=axis)
    for i, t in enumerate((None, tt.Teacher(teacher, count(5)))):
        y = torch.from_numpy(d[f"y{{i}}"][rows])
        if aug:  # the stripe of the uint8 batch, augmented inside the step
            m = step(state, t, torch.from_numpy(d[f"u{{i}}"][rows]), y,
                     torch.Generator().manual_seed({aug_seed} + i), HP["lr"], HP["lam"])
        else:
            m = tt.train_step_on_batch(
                state, t, torch.from_numpy(d[f"x{{i}}"][rows]), y, HP["lr"], HP["lam"],
                label_smoothing=HP["smooth"], kd_temperature=HP["temperature"],
                momentum=HP["momentum"], weight_decay=HP["weight_decay"],
                use_pallas_loss=pallas, group=axis.group)
        losses.append(float(m["loss"]))
        assert (float(m["kd"]) > 0) == (t is not None)
    case = f"p{{int(pallas)}}g{{g}}a{{int(aug)}}"
    out[case + "/loss"] = np.array(losses)
    for k, v in student.state_dict().items():
        out[f"{{case}}/sd/{{k}}"] = v.numpy()
    for n, buf in zip(names, state.momentum):
        out[f"{{case}}/mom/{{n}}"] = buf.numpy()
np.savez(f"out{{axis.rank}}.npz", **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def setups():
    return {g: _setup(g) for g in (0, 4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, setups):
    """The two ranks' steps and the JAX reference: the JAX steps are
    computed here while the rank processes run."""
    ranks = {}

    def run():
        try:
            ranks["out"] = _two_ranks(tmp_path_factory, setups)
        except BaseException as exc:  # re-raised in the test's thread
            ranks["error"] = exc

    worker = threading.Thread(target=run)
    worker.start()
    try:
        reference = _jax_reference(setups)
    finally:
        worker.join(timeout=300)
    assert not worker.is_alive(), "the rank processes outlived their deadline"
    if "error" in ranks:
        raise ranks["error"]
    return ranks["out"], reference


def _two_ranks(tmp_path_factory, setups):
    tmp = tmp_path_factory.mktemp("dp_step")
    names = _param_names()
    for g, (variables, teacher, momentum, batches) in setups.items():
        arrays = {}
        for prefix, v in (("student/", variables), ("teacher/", teacher)):
            for k, a in _port_state_dict(v["params"], v["batch_stats"]).items():
                arrays[prefix + k] = a
        mom = _port_state_dict(momentum, variables["batch_stats"])
        for n in names:
            arrays["momentum/" + n] = mom[n]
        for i, ((x, y), u8) in enumerate(zip(batches, _u8_batches())):
            arrays[f"x{i}"], arrays[f"y{i}"], arrays[f"u{i}"] = x, y, u8
        np.savez(tmp / f"inputs_g{g}.npz", **arrays)
    spawn_ranks(tmp, _STEP_RANK.format(hp=repr(HP), cases=repr(CASES), aug_seed=AUG_SEED))
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]


def _jax_reference(setups):
    out = {(g, False): _jax_two_steps(g, *setups[g]) for g in (0, 4)}
    variables, teacher, momentum, batches = setups[0]
    out[0, True] = _jax_two_steps(0, variables, teacher, momentum, _augmented(batches))
    return out


@pytest.mark.parametrize("pallas,g,aug", CASES,
                         ids=[f"{'pallas' if p else 'plain'}-bn{g}" + ("-randaugment" if a else "")
                              for p, g, a in CASES])
def test_two_rank_steps_match_the_jax_global_batch_step(runs, pallas, g, aug):
    two_ranks, jax_reference = runs
    (params, stats, buf), losses = jax_reference[g, aug]
    case = f"p{int(pallas)}g{g}a{int(aug)}"
    ref_sd = _port_state_dict(params, stats)
    ref_mom = _port_state_dict(buf, stats)
    for out in two_ranks:
        np.testing.assert_allclose(out[case + "/loss"], losses, rtol=1e-4)
        for k, want in ref_sd.items():
            np.testing.assert_allclose(out[f"{case}/sd/{k}"], want, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        for n in _param_names():
            np.testing.assert_allclose(out[f"{case}/mom/{n}"], ref_mom[n], rtol=1e-4,
                                       atol=1e-5, err_msg=n)
    # Replicated state: the ranks agree bit for bit.
    keys = [k for k in two_ranks[0] if k.startswith(case + "/")]
    assert len(keys) == 1 + len(ref_sd) + len(_param_names())
    for k in keys:
        np.testing.assert_array_equal(two_ranks[0][k], two_ranks[1][k], err_msg=k)
