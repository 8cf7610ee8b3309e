"""The port's process group and data axis (``parallel/``), on the CPU with
``gloo``: the cases of ``tests/test_dist.py`` that apply to
``torch.distributed``, the flags that pick the mesh, and the collectives of
a data-parallel step at two ranks.

``spawn_ranks`` is also the rank launcher of the other data-parallel test
files: one ``subprocess.Popen`` per rank running an inline script (which
imports no JAX), a ``file://`` rendezvous in the test's ``tmp_path``, and one
deadline for all ranks, after which every rank is killed.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.main import build_trainer
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.parallel import (
    data_axis,
    get_rank,
    get_world_size,
    init_distributed_mode,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import platform
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.logging import (
    JsonlLogger,
    process_suffixed,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "a_pytorch_tutorial_to_class_incremental_learning_tpu_torch"
SLICE_FLAGS = ["--platform", "cpu", "--data_set", "synthetic10", "--aa", "none",
               "--color_jitter", "0"]


def spawn_ranks(tmp_path, script, nprocs=2, timeout=120.0, argv=()):
    """Run ``script`` once per rank, each with ``WORLD_SIZE``/``RANK``/
    ``LOCAL_RANK`` and ``DIST_URL`` (a fresh ``file://`` rendezvous) set and
    ``argv`` as its arguments; returns each rank's combined output.  Fails
    (and kills every rank) if any rank fails or the deadline passes."""
    path = tmp_path / f"rank_script_{time.monotonic_ns()}.py"
    path.write_text(script)
    rdv = tmp_path / f"rdv_{time.monotonic_ns()}"
    base = dict(os.environ)
    base.update({
        "PYTHONPATH": REPO + os.pathsep + base.get("PYTHONPATH", ""),
        "WORLD_SIZE": str(nprocs),
        "DIST_URL": f"file://{rdv}",
        # One intra-op thread per rank: beside other test workers, torch's
        # OpenMP pool would oversubscribe the cores.
        "OMP_NUM_THREADS": "1",
        # gloo over the loopback interface, whatever the host name resolves to.
        "GLOO_SOCKET_IFNAME": "lo",
        "PYTHONWARNINGS": "ignore::FutureWarning",
    })
    procs = [
        subprocess.Popen(
            [sys.executable, str(path), *map(str, argv)],
            env={**base, "RANK": str(r), "LOCAL_RANK": str(r)},
            cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(nprocs)
    ]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate(timeout=60)
        pytest.fail(f"rank processes did not finish within {timeout} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def _intra_op_threads(n):
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def one_intra_op_thread():
    """torch on one intra-op thread for the test (``pytestmark =
    pytest.mark.usefixtures("one_intra_op_thread")`` in a file that imports
    it): beside the other test workers, torch's default pool of one thread
    a core oversubscribes the cores and its parallel regions stall."""
    yield from _intra_op_threads(1)


@pytest.fixture(scope="module")
def two_intra_op_threads():
    """torch on two intra-op threads for a whole file, its module fixtures
    included (``pytestmark = pytest.mark.usefixtures("two_intra_op_threads")``
    in a file that imports it), for the same reason as
    ``one_intra_op_thread``.  Two and not one: on one thread a bf16 step's
    reductions round past ``test_torch_precision``'s tolerance."""
    yield from _intra_op_threads(2)


@pytest.fixture
def no_dist_env(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


def test_no_environment_means_no_process_group(no_dist_env):
    assert init_distributed_mode("env://", "cpu") is False
    assert not dist.is_initialized()
    assert (get_rank(), get_world_size()) == (0, 1)
    axis = data_axis(None)
    assert (axis.size, axis.rank, axis.group, axis.sharded) == (1, 0, None, False)


def test_explicit_environment_with_failing_rendezvous_raises(no_dist_env):
    # A launcher said "2 ranks" but gave no rendezvous address: the run
    # must stop, not carry on as one of two independent single processes.
    no_dist_env.setenv("WORLD_SIZE", "2")
    no_dist_env.setenv("RANK", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed_mode("env://", "cpu")
    assert not dist.is_initialized()


def test_an_existing_group_is_used_as_it_is(no_dist_env, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    group = dist.group.WORLD
    # The environment would ask for a new group of two; the existing one wins.
    no_dist_env.setenv("WORLD_SIZE", "2")
    no_dist_env.setenv("RANK", "0")
    assert init_distributed_mode("env://", "cpu") is False
    assert dist.group.WORLD is group and get_world_size() == 1
    assert data_axis((1, 1)).size == 1


def test_mesh_data_must_equal_the_world_size(no_dist_env):
    with pytest.raises(ValueError, match="mesh_data 2"):
        build_trainer([*SLICE_FLAGS, "--mesh_data", "2"])


def test_bn_group_size_that_splits_a_group_raises(no_dist_env):
    with pytest.raises(ValueError, match="bn group size 3"):
        build_trainer([*SLICE_FLAGS, "--batch_size", "8", "--bn_group_size", "3"])
    # One process cannot hold a group larger than its batch.
    with pytest.raises(ValueError, match="bn group size 16"):
        build_trainer([*SLICE_FLAGS, "--batch_size", "8", "--bn_group_size", "16"])


def test_local_rank_picks_the_card_and_never_shares_one(monkeypatch):
    picked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert platform.resolve_device(None) == torch.device("cuda", 1)
    assert picked == [1]
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2 has no CUDA device"):
        platform.resolve_device("cuda")
    assert platform.resolve_device("cpu") == torch.device("cpu")


def test_each_process_writes_its_own_log(tmp_path):
    assert process_suffixed("logs/run.jsonl", 0) == "logs/run.jsonl"
    assert process_suffixed("logs/run.jsonl", 3) == "logs/run_p3.jsonl"
    assert process_suffixed(None, 1) is None
    log = JsonlLogger(str(tmp_path / "run.jsonl"), process_index=1, process_count=2)
    log.log("run", seed=0)
    rec = json.loads((tmp_path / "run_p1.jsonl").read_text())
    assert (rec["process_index"], rec["process_count"], rec["seed"]) == (1, 2, 0)
    assert not (tmp_path / "run.jsonl").exists()


_COLLECTIVES = r"""
import json, os, sys
import torch
import torch.distributed as dist
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import create_model
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.parallel import (
    barrier, broadcast_module, data_axis, init_distributed_mode, all_reduce_sum,
)

created = init_distributed_mode(os.environ["DIST_URL"], "cpu")
axis = data_axis((2, 1))
r = axis.rank
# Different seeds per rank; the broadcast makes rank 0's weights everyone's.
model = create_model("resnet20", 10, seed=100 + r, axis=axis)
broadcast_module(model, axis.group)
flat = torch.cat([t.reshape(-1) for t in model.state_dict().values()])
ref = create_model("resnet20", 10, seed=100)
same_as_rank0 = all(torch.equal(a, b) for a, b in
                    zip(model.state_dict().values(), ref.state_dict().values()))
summed = all_reduce_sum([torch.full((2, 3), r + 1.0), torch.full((4,), 10.0 * r)], axis.group)
span = axis.span_group(1)
t = torch.tensor([r + 1.0])
dist.all_reduce(t, group=span)   # a one-rank group: no other rank's value
barrier()
out = {"created": created, "rank": r, "size": axis.size, "same_as_rank0": same_as_rank0,
       "sum0": summed[0].tolist(), "sum1": summed[1].tolist(), "span": t.item(),
       "span_world_is_axis": axis.span_group(2) is axis.group}
open(f"out{r}.json", "w").write(json.dumps(out))
dist.destroy_process_group()
"""


def test_two_rank_collectives(tmp_path):
    spawn_ranks(tmp_path, _COLLECTIVES)
    outs = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in range(2)]
    for r, o in enumerate(outs):
        assert (o["created"], o["rank"], o["size"]) == (True, r, 2)
        assert o["same_as_rank0"]
        np.testing.assert_array_equal(o["sum0"], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(o["sum1"], np.full((4,), 10.0))
        assert o["span"] == r + 1.0 and o["span_world_is_axis"]
