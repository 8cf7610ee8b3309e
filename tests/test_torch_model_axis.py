"""The model axis and the sharded checkpoint backend against the JAX package.

The head's width rounding and shards against JAX ``create_model(
width_multiple=m)`` and ``param_sharding`` at m in {1, 2, 3, 4};
``freeze_mask`` and ``sgd_update(frozen=)`` against JAX's on the same
parameters; then one 4-rank ``gloo`` job at mesh ``(2, 2)`` on the CPU
(resnet20, synthetic10, 2 tasks of 1 epoch, 16 rows a data rank).  Two of
its steps are held to one process's float64 step at the global batch of 32
with the data-parallel parity bound of PERF.md §2 (loss rtol 1e-4,
parameters rtol 1e-3 / atol 1e-4: lr · the first conv's float32 weight
gradient, ill-conditioned on these images, lands ~5e-5 off float64 after a
teacher step); its fit must log the same
records and metrics on every rank; the sharded ``weight_align`` must give
the unsharded γ bitwise; an ``orbax`` task and epoch checkpoint must
restore bitwise at ``(2, 2)``; and a pickle payload saved at ``(2, 2)``
(the full-width head) must restore at ``(2, 2)`` bitwise, each rank taking
its rows, and at ``(1, 1)`` into the full-width state the ranks hold.
"""

import json

import numpy as np
import pytest
import jax
import torch
from flax.core import unfreeze

from a_pytorch_tutorial_to_class_incremental_learning_tpu import models as jm
from a_pytorch_tutorial_to_class_incremental_learning_tpu.engine import train as jt
from a_pytorch_tutorial_to_class_incremental_learning_tpu.parallel import mesh as jmesh
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch import models as tm
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.parallel import mesh as tmesh
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import jax_random
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.checkpoint import (
    load_task_checkpoint,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.jax_weights import (
    from_jax_variables,
)
from test_torch_dist import no_dist_env, spawn_ranks, two_intra_op_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("two_intra_op_threads")


class _Group:
    """Stands in for a process group where no collective runs."""


def _model_axis(m, k):
    return tmesh.ModelAxis(m, k, _Group() if m > 1 else None)


@pytest.mark.parametrize("nb_classes", [10, 100])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_head_width_and_shards_follow_jax(nb_classes, m):
    mesh = jmesh.make_mesh((1, m), jax.devices()[:m])
    # The shapes of JAX create_model's variables (traced, not computed).
    params = jax.eval_shape(
        lambda: jm.create_model("resnet20", nb_classes, width_multiple=m)[1])["params"]
    width = params["fc_kernel"].shape[1]
    for name, jname in (("fc.weight", "fc_kernel"), ("fc.bias", "fc_bias")):
        sharding = jmesh.param_sharding(mesh, (jname,), params[jname])
        want = sharding.shard_shape(params[jname].shape)[-1]
        for k in range(m):
            model = tm.create_model("resnet20", nb_classes, width_multiple=m,
                                    model_axis=_model_axis(m, k))
            assert model.width == width
            assert dict(model.named_parameters())[name].shape[0] == want
            sharded = tmesh.param_sharding(model.head_axis or tmesh.ModelAxis(), name,
                                           (width, 64))
            assert (sharded is not None) == (want < width)
    # Every other leaf is replicated, as in JAX.
    conv = params["backbone"]["conv_1_3x3"]["kernel"]
    assert jmesh.param_sharding(mesh, ("backbone", "conv_1_3x3", "kernel"), conv).spec == ()
    assert tmesh.param_sharding(_model_axis(m, 0), "backbone.conv_1_3x3.weight",
                                (16, 3, 3, 3)) is None


@pytest.fixture(scope="module")
def jax_variables():
    """A JAX resnet20 of 10 classes at ``width_multiple=4`` (a 12-wide
    head) with its 10 classes grown, on the host."""
    _, variables = jm.create_model("resnet20", 10, width_multiple=4)
    return jax.device_get(unfreeze(jm.grow(variables, jax.random.PRNGKey(0), 0, 10)))


def test_jax_head_carries_into_each_ranks_rows(jax_variables):
    variables = jax_variables
    full = from_jax_variables(variables["params"], variables["batch_stats"])
    parts = [from_jax_variables(variables["params"], variables["batch_stats"],
                                model_axis=_model_axis(4, k)) for k in range(4)]
    assert full["fc.weight"].shape == (12, 64)
    torch.testing.assert_close(torch.cat([p["fc.weight"] for p in parts]), full["fc.weight"],
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([p["fc.bias"] for p in parts]), full["fc.bias"],
                               rtol=0, atol=0)
    model = tm.create_model("resnet20", 10, width_multiple=4, model_axis=_model_axis(4, 2))
    model.load_state_dict(parts[2])


def test_growth_on_a_shard_keeps_the_unsharded_rows():
    whole = tm.create_model("resnet20", 10, width_multiple=4)
    shards = [tm.create_model("resnet20", 10, width_multiple=4, model_axis=_model_axis(4, k))
              for k in range(4)]
    for known, nb_new in ((0, 5), (5, 5)):
        for model in [whole, *shards]:
            tm.grow(model, jax_random.key(known), known, nb_new)
    torch.testing.assert_close(torch.cat([s.fc.weight for s in shards]), whole.fc.weight,
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([s.fc.bias for s in shards]), whole.fc.bias,
                               rtol=0, atol=0)




@pytest.mark.parametrize("names", [("fc",), ("backbone",), ("all",), ("fc", "backbone")])
def test_freeze_mask_and_frozen_sgd_match_jax(jax_variables, names):
    variables = jax_variables
    params = variables["params"]
    jmask = jm.freeze_mask(params, names)
    model = tm.CilModel("resnet20", 12)
    model.load_state_dict(from_jax_variables(params, variables["batch_stats"]))
    mask = tm.freeze_mask(model, names)
    # JAX's mask, one flag a leaf, under the port's parameter names.
    flags = jax.tree_util.tree_map(lambda f, p: np.full(p.shape, float(f), np.float32),
                                   jmask, params)
    want = from_jax_variables(flags, variables["batch_stats"])
    assert mask == {n: bool(want[n].flatten()[0]) for n in mask}
    assert any(mask.values())

    rng = np.random.RandomState(3)
    grads = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
    buf = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
    ref_p, ref_b = jt.sgd_update(params, grads, buf, 0.1, 0.9, 5e-4, frozen=jmask)
    names_ = [n for n, _ in model.named_parameters()]

    def listed(tree):
        sd = from_jax_variables(tree, variables["batch_stats"])
        return [sd[n].clone() for n in names_]

    p, g, b = list(model.parameters()), listed(grads), listed(buf)
    tt.sgd_update(p, g, b, 0.1, 0.9, 5e-4, frozen=list(mask.values()))
    for n, got_p, got_b, want_p, want_b in zip(names_, p, b, listed(ref_p), listed(ref_b)):
        torch.testing.assert_close(got_p.detach(), want_p, rtol=1e-6, atol=1e-7, msg=n)
        torch.testing.assert_close(got_b, want_b, rtol=1e-6, atol=1e-7, msg=n)
        if mask[n]:
            assert not got_b.any()


def test_unknown_freeze_name_raises_as_jax(jax_variables):
    with pytest.raises(NotImplementedError, match="Unknown module name to freeze head"):
        jm.freeze_mask(jax_variables["params"], ("head",))
    with pytest.raises(NotImplementedError, match="Unknown module name to freeze head"):
        tm.freeze_mask(tm.CilModel("resnet20", 10), ("head",))


# --------------------------------------------------------------------------- #
# Four ranks at mesh (2, 2)
# --------------------------------------------------------------------------- #

# lr 0.02, as tests/test_torch_dp_cli.py.  At a global batch of 8 a whole run
# is chaotic (one process on 1 and on 3 threads ends epoch 1 ~2% apart), so
# the job is held to the one-process step step by step, as
# tests/test_torch_dp_step.py holds the data-parallel step.
RUN_ARGV = [
    "--platform", "cpu", "--data_set", "synthetic10", "--num_bases", "0",
    "--increment", "5", "--backbone", "resnet20", "--num_epochs", "1",
    "--eval_every_epoch", "100", "--memory_size", "20", "--aa", "none",
    "--color_jitter", "0", "--seed", "6", "--lr", "0.02", "--use_pallas_loss",
]
RANK_BATCH = 16

_MESH_RANK = r"""
import copy, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.augment import train_augment
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.engine import train as tt
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import create_model, grow
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops.precision import Policy
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models.classifier import weight_align
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.parallel import gather_full, shard_params
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import checkpoint as ck
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import jax_random

out_dir = os.getcwd()
argv = sys.argv[1:] + ["--dist_url", os.environ["DIST_URL"]]
# Trainers other than the fit's log aside, past the fit's log.
again = argv + ["--log_file", os.path.join(out_dir, "again.jsonl")]
res = {}

def count(n):
    return torch.tensor([n], dtype=torch.int32)

# Step parity: 2 steps at (2, 2) x b rows
# (the second with a teacher, after growing to 10 classes) against one
# process's step on the 2b rows in float64 (the kernels take no float64, so
# that one runs the plain loss), from the same weights, each augmenting with
# the same seed.  The float64 step is the yardstick because one float32
# process is itself ~4e-5 off it in the first conv's weights after one step
# here, where the job is ~3e-8 off.
t = build_trainer(again)
r = dist.get_rank()
t._grow_state(0, 0, 5)
model = t.state.model
full = ck._model_state(model)
f64 = Policy("f64", torch.float64, torch.float64, torch.float64)
ref = create_model("resnet20", 10, policy=f64).double()
ref.load_state_dict({k: torch.from_numpy(v).double() for tree in full.values()
                     for k, v in tree.items()})
ref_state = tt.TrainState(ref, tt.sgd_init(ref.parameters()), count(5), count(0))
hp = dict(label_smoothing=t.config.smooth, kd_temperature=t.config.kd_temperature,
          momentum=t.config.momentum, weight_decay=t.config.weight_decay)
data = t.scenario_train[0]
b, i = t.config.batch_size, t.axis.rank
worst = {"loss_rel": 0.0, "param_abs": 0.0, "param_ok": True}
teacher = ref_teacher = None
for s in range(2):
    if s == 1:
        teacher = tt.Teacher(copy.deepcopy(model).requires_grad_(False), count(5))
        ref_teacher = tt.Teacher(copy.deepcopy(ref).requires_grad_(False), count(5))
        for m, st in ((model, t.state), (ref, ref_state)):
            grow(m, jax_random.key(9), 5, 5)
            st.momentum = tt.sgd_init(m.parameters())
            st.num_active, st.known = count(10), count(5)
    x = torch.from_numpy(data.x[s * 2 * b:(s + 1) * 2 * b])
    y = torch.from_numpy(data.y[s * 2 * b:(s + 1) * 2 * b])
    got = t.train_step(t.state, teacher, x[i * b:(i + 1) * b], y[i * b:(i + 1) * b],
                       torch.Generator().manual_seed(100 + s), 0.02, 0.5)
    xa = train_augment(x, t.aug_cfg, torch.Generator().manual_seed(100 + s)).double()
    want = tt.train_step_on_batch(ref_state, ref_teacher, xa, y, 0.02, 0.5, **hp)
    worst["loss_rel"] = max(worst["loss_rel"], abs(float(got["loss"]) / float(want["loss"]) - 1))
    mine = dict(model.named_parameters())
    for name, p in shard_params(t.mesh.model, dict(ref.named_parameters())).items():
        worst["param_abs"] = max(worst["param_abs"], (mine[name] - p).abs().max().item())
        worst["param_ok"] &= bool(torch.allclose(mine[name].double(), p, rtol=1e-3, atol=1e-4))
res["steps"] = worst

trainer = build_trainer(argv)
result = trainer.fit()
model = trainer.state.model
res.update(acc1s=result["acc1s"], mesh=[trainer.axis.rank, trainer.mesh.model.rank],
           fc_rows=model.fc.weight.shape[0],
           lockstep=[trainer.lockstep._seq, trainer.lockstep.violations])

def state(t):
    return {"model": {k: v.clone() for k, v in t.state.model.state_dict().items()},
            "momentum": [m.clone() for m in t.state.momentum],
            "teacher": {k: v.clone() for k, v in t.teacher.model.state_dict().items()}}

def equal(a, b):
    return (a["model"].keys() == b["model"].keys()
            and all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
            and all(torch.equal(x, y) for x, y in zip(a["momentum"], b["momentum"]))
            and all(torch.equal(a["teacher"][k], b["teacher"][k]) for k in a["teacher"]))

# gamma: the sharded weight_align against the unsharded one on the gathered head.
full_w = gather_full(model.head_axis, model.fc.weight.detach())
full_b = gather_full(model.head_axis, model.fc.bias.detach())
shard = torch.nn.Linear(64, model.fc.weight.shape[0])
whole = torch.nn.Linear(64, full_w.shape[0])
with torch.no_grad():
    shard.weight.copy_(model.fc.weight); shard.bias.copy_(model.fc.bias)
    whole.weight.copy_(full_w); whole.bias.copy_(full_b)
g_sharded = float(weight_align(shard, 5, 5, model.head_axis))
g_whole = float(weight_align(whole, 5, 5))
rows = slice(model.head_axis.rank * shard.weight.shape[0],
             (model.head_axis.rank + 1) * shard.weight.shape[0])
res["gamma"] = [g_sharded, g_whole]
res["gamma_rows_equal"] = bool(torch.equal(shard.weight, whole.weight[rows]))

# orbax: the task checkpoint the fit wrote, and an epoch checkpoint written now.
live = state(trainer)
epoch_path = ck.save_epoch_checkpoint(trainer, 1, 1, 5)
for kind, path in (("task", ck._task_path(trainer.config.ckpt_dir, 1, "orbax")),
                   ("epoch", epoch_path)):
    # Into the step-parity trainer: a restore overwrites every tensor compared.
    fresh = t
    ck.load_task_checkpoint(fresh, path)
    if kind == "task":
        got = {"model": fresh.state.model.state_dict(), "momentum": [],
               "teacher": fresh.teacher.model.state_dict()}
        want = {"model": live["model"], "momentum": [], "teacher": live["model"]}
    else:
        got, want = state(fresh), live
    res[f"orbax_{kind}_equal"] = equal(got, want)
    res[f"orbax_{kind}_files"] = sorted(os.listdir(path))

# pickle at (2, 2): a full-width payload, restored at (1, 1) by the test.
trainer.config = trainer.config.replace(ckpt_backend="pickle",
                                        ckpt_dir=os.path.join(out_dir, "pickle"))
res["pickle"] = ck.save_task_checkpoint(trainer, 1)
# The full-width payload back at (2, 2): each rank takes its rows.
ck.load_task_checkpoint(t, res["pickle"])
res["pickle_at_2x2_equal"] = equal(
    {"model": t.state.model.state_dict(), "momentum": [], "teacher": t.teacher.model.state_dict()},
    {"model": live["model"], "momentum": [], "teacher": live["model"]})
full = ck._model_state(model)  # every rank takes part in the head's gathers
if r == 0:
    np.savez(os.path.join(out_dir, "full_state.npz"),
             **{f"p.{k}": v for k, v in full["params"].items()},
             **{f"b.{k}": v for k, v in full["batch_stats"].items()})
torch.save({k: v.clone() for k, v in model.state_dict().items()},
           os.path.join(out_dir, f"local{r}.pt"))
json.dump(res, open(f"result{r}.json", "w"))
dist.destroy_process_group()
"""


def _records(path):
    return [json.loads(ln) for ln in open(path)]


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    """The 4-rank job at (2, 2)."""
    tmp = tmp_path_factory.mktemp("mesh22")
    spawn_ranks(tmp, _MESH_RANK, nprocs=4, timeout=400, argv=[
        *RUN_ARGV, "--batch_size", RANK_BATCH, "--mesh_data", 2, "--mesh_model", 2,
        "--log_file", tmp / "run.jsonl", "--ckpt_dir", tmp / "orbax",
        "--ckpt_backend", "orbax",
        "--check_lockstep", "--lockstep_dir", tmp / "lockstep",
    ])
    return tmp


def test_mesh_2x2_steps_match_one_process(mesh_2x2):
    """Each step at (2, 2) x 16 rows against one process's float64 step on
    the 32 rows: loss rtol 1e-4, every rank's parameters (its head rows)
    rtol 1e-3 / atol 1e-4, the data-parallel parity bound of PERF.md §2."""
    for r in range(4):
        steps = json.loads((mesh_2x2 / f"result{r}.json").read_text())["steps"]
        assert steps["loss_rel"] < 1e-4 and steps["param_ok"], steps


def test_mesh_2x2_run_is_the_ranks_alike(mesh_2x2):
    tmp = mesh_2x2
    names = ["run.jsonl"] + [f"run_p{r}.jsonl" for r in (1, 2, 3)]
    ranks = [_records(tmp / n) for n in names]
    results = [json.loads((tmp / f"result{r}.json").read_text()) for r in range(4)]
    want = ["run"] + ["compile_event", "epoch", "task", "cil_metrics"] * 2 + ["final"]
    for r, recs in enumerate(ranks):
        assert [x["type"] for x in recs if x["type"] != "lockstep_fingerprint"] == want
        assert {(x["process_index"], x["process_count"]) for x in recs} == {(r, 4)}
    run = ranks[0][0]
    assert run["mesh"] == {"data": 2, "model": 2} and run["processes"] == 4
    assert (run["batch_size"], run["global_batch"]) == (RANK_BATCH, 2 * RANK_BATCH)
    # Rank r sits at data index r // 2, model index r % 2, and holds 5 of 10 rows.
    assert [res["mesh"] for res in results] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert {res["fc_rows"] for res in results} == {5}
    # Every rank logs the same metrics (all-reduced in the step).
    epochs = [[x for x in recs if x["type"] == "epoch"] for recs in ranks]
    assert [e["steps"] for e in epochs[0]] == [10, 11]  # 320 and 320 + 20 rows at 32
    for mine in epochs[1:]:
        assert [(e["loss"], e["acc1"]) for e in mine] == [
            (e["loss"], e["acc1"]) for e in epochs[0]]
    assert all(np.isfinite(e["loss"]) for e in epochs[0])
    assert len({tuple(res["acc1s"]) for res in results}) == 1
    # The lockstep sentinel (global-batch digests): the four ranks, the two
    # copies of each model group among them, fingerprint alike.
    checks = {res["lockstep"][0] for res in results}
    assert len(checks) == 1 and checks.pop() > 0
    assert all(res["lockstep"][1] == [] for res in results)
    gammas = [[x["gamma"] for x in recs if x["type"] == "task"] for recs in ranks]
    assert gammas[0][0] is None and gammas[0][1] > 0 and all(g == gammas[0] for g in gammas)


def test_mesh_2x2_shards_gamma_and_orbax_round_trips(mesh_2x2):
    results = [json.loads((mesh_2x2 / f"result{r}.json").read_text()) for r in range(4)]
    for res in results:
        g_sharded, g_whole = res["gamma"]
        assert g_sharded == g_whole and res["gamma_rows_equal"]
        assert res["orbax_task_equal"] and res["orbax_epoch_equal"]
        assert res["pickle_at_2x2_equal"]
        # Each rank wrote its own shards, and rank 0 the metadata.
        assert res["orbax_task_files"] == [".metadata"] + [f"__{r}_0.distcp"
                                                           for r in range(4)]
    local = [torch.load(mesh_2x2 / f"local{r}.pt") for r in range(4)]
    for name in local[0]:
        if name.startswith("fc."):
            # A data row's two shards are the head; both rows hold the same.
            assert torch.equal(local[0][name], local[2][name])
            assert torch.equal(local[1][name], local[3][name])
        else:
            assert all(torch.equal(local[0][name], other[name]) for other in local[1:])


def test_pickle_saved_at_2x2_restores_at_1x1(mesh_2x2, no_dist_env):
    full = np.load(mesh_2x2 / "full_state.npz")
    trainer = build_trainer([*RUN_ARGV, "--batch_size", str(2 * RANK_BATCH)])
    path = json.loads((mesh_2x2 / "result0.json").read_text())["pickle"]
    assert load_task_checkpoint(trainer, path)
    assert trainer.start_task == 2 and trainer.known == 10
    local0 = torch.load(mesh_2x2 / "local0.pt")
    local1 = torch.load(mesh_2x2 / "local1.pt")
    for name, t in trainer.state.model.named_parameters():
        np.testing.assert_array_equal(t.detach().numpy(), full[f"p.{name}"])
    for name, t in trainer.state.model.named_buffers():
        np.testing.assert_array_equal(t.numpy(), full[f"b.{name}"])
    head = trainer.state.model.fc.weight.detach()
    assert torch.equal(head, torch.cat([local0["fc.weight"], local1["fc.weight"]]))
