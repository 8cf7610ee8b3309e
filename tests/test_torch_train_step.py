"""The slice as a whole: one train step with a teacher against a test-local
JAX composition of ``CilModel.apply`` + ``cross_entropy`` +
``soft_target_kd`` + ``sgd_update`` from identical weights on an identical
pre-augmented batch (the JAX step augments with ``jax.random``, which torch
cannot reproduce); then alignment and the eval totals; then the CLI end to
end on the CPU.

Tolerances: loss rtol 1e-4, parameters and momentum after the step rtol 1e-4 /
atol 1e-5 (gradients through 19 convolutions summed in another order).  The
JAX side of the step runs in float64: see ``_jax_step``.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax.core import unfreeze

from a_pytorch_tutorial_to_class_incremental_learning_tpu import models as jm
from a_pytorch_tutorial_to_class_incremental_learning_tpu.data import augment as jaug
from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine import losses as jl
from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine import train as jt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import models as tm
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import augment as taug
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (
    from_jax_variables,
)
from test_torch_dist import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch"
HP = dict(lr=0.05, momentum=0.9, weight_decay=5e-4, lam=0.5, temperature=2.0)


def _count(n):
    return torch.tensor([n], dtype=torch.int32)


def _port_model(variables, backbone="resnet20"):
    model = tm.CilModel(backbone, 10)
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]))
    return model


def _as_param_list(model, tree, stats):
    """A params-shaped JAX tree (e.g. momentum) in the port's parameter order."""
    sd = from_jax_variables(tree, stats)
    return [sd[name].clone() for name, _ in model.named_parameters()]


def _setup(smooth, backbone="resnet20", shape=(32, 32, 3)):
    """Teacher after task 0 (5 classes), student grown to 10 classes, a
    random momentum buffer, a normalized batch of ``shape`` images and
    labels."""
    model, variables = jm.create_model(backbone, nb_classes=10, input_size=shape[0],
                                       channels=shape[2])
    variables = jm.grow(variables, jax.random.PRNGKey(0), 0, 5)
    teacher = jax.device_get(unfreeze(variables))
    variables = jax.device_get(unfreeze(jm.grow(variables, jax.random.PRNGKey(1), 5, 5)))
    rng = np.random.RandomState(7)
    momentum = jax.tree_util.tree_map(
        lambda p: (0.01 * rng.randn(*p.shape)).astype(np.float32), variables["params"]
    )
    x = rng.randn(8, *shape).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int64)
    return model, variables, teacher, momentum, x, y


def _jax_step(variables, teacher, momentum, x, y, smooth, backbone="resnet20"):
    """The JAX composition, run in float64 (``CilModel(dtype=float64)`` under
    ``jax.enable_x64``).  XLA:CPU's float32 backward through the stride-2
    convolutions lands ~1e-3 (relative) away from a float64 reference on
    this network, jitted or not, which would swamp the comparison; in float64
    JAX and the port's float64 twin agree to ~5e-8, and the port's float32
    step is held to the stated tolerance against it."""
    with jax.enable_x64(True):
        model = jm.CilModel(backbone_name=backbone, width=10, dtype=jnp.float64)
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)

        @jax.jit
        def step(variables, teacher, momentum, x, y):
            def loss_fn(params):
                (logits, _), mutated = model.apply(
                    {"params": params, "batch_stats": variables["batch_stats"]}, x,
                    num_active=jnp.int32(10), train=True, mutable=["batch_stats"],
                )
                ce = jl.cross_entropy(logits, y, jnp.int32(10), smooth)
                t_logits, _ = model.apply(teacher, x, num_active=jnp.int32(5), train=False)
                kd = HP["lam"] * jl.soft_target_kd(logits, t_logits, jnp.int32(5),
                                                   HP["temperature"])
                return ce + kd, (mutated["batch_stats"], ce + kd)

            grads, (stats, loss) = jax.grad(loss_fn, has_aux=True)(variables["params"])
            params, buf = jt.sgd_update(variables["params"], grads, momentum, HP["lr"],
                                        HP["momentum"], HP["weight_decay"])
            return params, buf, stats, loss

        out = step(f64(variables), f64(teacher), f64(momentum), f64(x), jnp.asarray(y))
        out = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax.device_get(out))
    params, buf, stats, loss = out
    return model, params, buf, unfreeze(stats), loss


@pytest.fixture(scope="module")
def jax_step_reference():
    """The inputs, the JAX step, then JAX's alignment and eval totals of
    its stepped model: computed once for both loss paths."""
    smooth = 0.1
    _, variables, teacher, momentum, x, y = _setup(smooth)
    step = _jax_step(variables, teacher, momentum, x, y, smooth)
    _, ref_params, _, ref_stats, _ = step
    aligned, ref_gamma = jm.align(
        {"params": jax.tree_util.tree_map(jnp.asarray, ref_params)}, known=5, nb_new=5
    )
    jmodel, _ = jm.create_model("resnet20", nb_classes=10)
    u8 = np.random.RandomState(8).randint(0, 256, (8, 32, 32, 3)).astype(np.uint8)
    w = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    jeval = jt.make_eval_step(jmodel, jaug.AugmentConfig())
    ref_tot = np.asarray(jeval(aligned["params"], ref_stats, jnp.asarray(u8), jnp.asarray(y),
                               jnp.asarray(w), jnp.int32(10)))
    return (smooth, variables, teacher, momentum, x, y, step,
            (aligned, ref_gamma, u8, w, ref_tot))


@pytest.mark.parametrize("use_pallas_loss", [False, True])
def test_one_step_with_teacher_matches_jax(jax_step_reference, use_pallas_loss):
    smooth, variables, teacher, momentum, x, y, ref, ref_eval = jax_step_reference
    model, ref_params, ref_buf, ref_stats, ref_loss = ref
    aligned, ref_gamma, u8, w, ref_tot = ref_eval

    student = _port_model(variables)
    t_model = _port_model(teacher).requires_grad_(False)
    state = tt.TrainState(
        model=student,
        momentum=_as_param_list(student, momentum, variables["batch_stats"]),
        num_active=_count(10),
        known=_count(5),
    )
    metrics = tt.train_step_on_batch(
        state, tt.Teacher(t_model, _count(5)), torch.from_numpy(x), torch.from_numpy(y),
        HP["lr"], HP["lam"], label_smoothing=smooth, kd_temperature=HP["temperature"],
        momentum=HP["momentum"], weight_decay=HP["weight_decay"],
        use_pallas_loss=use_pallas_loss,
    )
    assert np.isclose(float(metrics["loss"]), float(ref_loss), rtol=1e-4)
    assert float(metrics["kd"]) > 0

    ref_sd = from_jax_variables(ref_params, ref_stats)
    ref_mom = _as_param_list(student, ref_buf, ref_stats)
    sd = student.state_dict()
    for (name, _), buf, want in zip(student.named_parameters(), state.momentum, ref_mom):
        np.testing.assert_allclose(sd[name].numpy(), ref_sd[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(buf.numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    for name in sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), ref_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)

    # Then weight alignment of the new head and the eval totals.
    gamma = tm.align(student, known=5, nb_new=5)
    assert np.isclose(gamma, ref_gamma, rtol=1e-4)
    np.testing.assert_allclose(student.fc.weight.detach().numpy().T,
                               np.asarray(aligned["params"]["fc_kernel"]), rtol=1e-4, atol=1e-5)

    got_tot = tt.make_eval_step(taug.AugmentConfig())(
        student, torch.from_numpy(u8), torch.from_numpy(y), torch.from_numpy(w), _count(10)
    ).numpy()
    np.testing.assert_allclose(got_tot, ref_tot, rtol=1e-4, atol=1e-5)


def test_sgd_update_is_torch_sgd():
    """The ported update equals torch.optim.SGD(momentum, weight_decay,
    dampening=0) over several steps."""
    rng = np.random.RandomState(0)
    p_ref = [torch.tensor(rng.randn(5, 3).astype(np.float32), requires_grad=True)]
    p_got = [p_ref[0].detach().clone()]
    opt = torch.optim.SGD(p_ref, lr=0.1, momentum=0.9, weight_decay=5e-4, dampening=0)
    buf = tt.sgd_init(p_got)
    for _ in range(3):
        g = torch.from_numpy(rng.randn(5, 3).astype(np.float32))
        p_ref[0].grad = g.clone()
        opt.step()
        tt.sgd_update(p_got, [g], buf, 0.1, 0.9, 5e-4)
    torch.testing.assert_close(p_got[0], p_ref[0].detach(), rtol=1e-6, atol=1e-7)


CLI_ARGV = [
    "--data_set", "synthetic10", "--num_bases", "0", "--increment", "5",
    "--backbone", "resnet20", "--batch_size", "16", "--num_epochs", "2",
    "--eval_every_epoch", "100", "--memory_size", "20", "--aa", "none",
    # Crop and flip only; the parser's default augmentation runs in
    # tests/test_torch_precision.py's CLI case.
    "--color_jitter", "0", "--seed", "6",
]


def test_cli_on_cpu_writes_the_record_sequence(tmp_path):
    log = tmp_path / "run.jsonl"
    # One intra-op thread: beside other test workers, torch's default
    # OpenMP pool oversubscribes the cores and the run slows many-fold.
    proc = subprocess.run(
        [sys.executable, "-m", PORT, "--platform", "cpu", *CLI_ARGV, "--log_file", str(log)],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    records = [json.loads(ln) for ln in log.read_text().splitlines()]
    types = [r["type"] for r in records]
    assert types == ["run", "compile_event", "epoch", "epoch", "task", "cil_metrics",
                     "compile_event", "epoch", "epoch", "task", "cil_metrics", "final"]
    assert records[0]["backbone"] == "resnet20"
    tasks = [r for r in records if r["type"] == "task"]
    assert tasks[0]["gamma"] is None and tasks[1]["gamma"] is not None
    for r in records:
        if r["type"] == "epoch":
            assert np.isfinite(r["loss"]) and {"acc1", "acc5", "ce", "kd"} <= r.keys()

    # The repository's race report reads the port's log unchanged.
    spec = importlib.util.spec_from_file_location(
        "compare_race", os.path.join(REPO, "scripts", "compare_race.py")
    )
    compare_race = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(compare_race)
    got_tasks, final, meta = compare_race.load(str(log))
    assert len(got_tasks) == 2 and final["acc1s"] == [t["acc1"] for t in got_tasks]
    assert meta["data_set"] == "synthetic10"


@pytest.mark.parametrize("flags, fields", [
    (["--fault_spec", "replica_die@task0"], {"fault_spec": "replica_die@task0"}),
    (["--fault_spec", "kill@task1,swap_ioerror@task1"],
     {"fault_spec": "kill@task1,swap_ioerror@task1"}),
    (["--export_dir", "exp"], {"export_dir": "exp", "serve_buckets": (1, 8, 32, 64)}),
    (["--serve_skew_check", "--serve_buckets", "4,1"],
     {"serve_skew_check": True, "serve_buckets": (1, 4)}),
])
def test_serving_flags_build_the_trainer(flags, fields):
    """The serving flags and the ``serve.*`` fault clauses, which an earlier
    slice refused, build the trainer and reach its config."""
    trainer = build_trainer(["--platform", "cpu", *CLI_ARGV, *flags])
    for name, value in fields.items():
        assert getattr(trainer.config, name) == value, name


@pytest.mark.parametrize("flags", [
    ["--check_threads"],
    ["--heartbeat_path", "hb"],
    ["--profile_dir", "prof"],
    ["--recompile_budget"],
    ["--check_contracts"],
    ["--telemetry_dir", "tel"],
    ["--check_lockstep"],
    ["--check_lockstep", "--lockstep_dir", "ls"],
])
def test_telemetry_and_lockstep_flags_are_in_the_slice(flags):
    from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.config import (
        config_from_args,
        get_args_parser,
    )

    args = get_args_parser().parse_args(["--data_set", "synthetic10", *flags])
    cfg = config_from_args(args)
    name = flags[-2 if len(flags) > 1 and not flags[-1].startswith("--") else -1]
    field = name.lstrip("-")
    assert getattr(cfg, field) == (flags[-1] if name != flags[-1] else True)
