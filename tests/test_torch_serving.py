"""The port's serving artifacts and hot-swapping server, on the CPU.

The cases of the JAX package's ``tests/test_serving.py``, held on the port:
the manifest registry, bit identity per bucket against the artifact's model
run eagerly (``direct_predict``), pad-to-bucket and chunking, corrupt
weights and programs refused, zero traces across a warm restart,
``swap_ioerror`` degrading gracefully under traffic, the golden probe, and
``swap_to`` rolling back.  ``tests/test_torch_serving_jax.py`` holds the
port against JAX's own artifacts (and has a ``bf16_selective`` artifact);
``tests/test_torch_serving_run.py`` the trainer's export hook, the
fresh-process reload and the normalization cache's repair.  The helpers
``_model`` and ``_export`` serve those files too.
"""

import hashlib
import io
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data.augment import (
    AugmentConfig,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.models import (
    create_model,
    grow,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops.precision import (
    get_policy,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.serving import (
    InferenceServer,
    direct_predict,
    export_artifact,
    latest_artifact,
    load_artifact,
    probe_artifact,
    read_manifest,
    register_artifact,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.telemetry import (
    RecompileMonitor,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.checkpoint import (
    _model_state,
)
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils.logging import (
    JsonlLogger,
)
from analysis.runtime import RecompileBudgetExceeded, RecompileSentinel
from faults.injector import FaultInjector, parse_fault_spec
from test_torch_dist import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_intra_op_thread")

BUCKETS = (1, 4)
NB = 10


def _model(known, seed, precision="f32"):
    """A resnet20 with a 10-wide head, ``known`` columns grown, and BN
    running statistics that are not the defaults (so a load that dropped
    them would show)."""
    model = create_model("resnet20", NB, seed=seed, policy=get_policy(precision))
    grow(model, torch.Generator().manual_seed(seed), 0, known)
    gen = torch.Generator().manual_seed(seed + 100)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return model.eval()


def _export(export_dir, task_id, model, known, precision="f32", buckets=BUCKETS):
    state = _model_state(model)
    return export_artifact(
        export_dir, task_id, AugmentConfig(), state["params"], state["batch_stats"],
        known=known, class_order=list(range(NB)), input_size=32, channels=3,
        buckets=buckets, device="cpu",
        model_meta={"backbone": "resnet20", "width": NB, "compute_dtype": "float32",
                    "precision": precision, "bn_group_size": 0},
    )


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    """Two task artifacts (known=5, then 10) over the full-width head."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        d = str(tmp_path_factory.mktemp("serve") / "export")
        os.makedirs(d)
        _export(d, 0, _model(5, 0), 5)
        _export(d, 1, _model(NB, 1), NB)
    finally:
        torch.set_num_threads(threads)
    return d


def _img(rng, n=None):
    shape = (32, 32, 3) if n is None else (n, 32, 32, 3)
    return rng.randint(0, 256, shape).astype(np.uint8)


def test_manifest_registry(export_dir):
    man = read_manifest(export_dir)
    assert sorted(man["artifacts"]) == ["0", "1"]
    assert man["latest"] == 1
    task_id, path = latest_artifact(export_dir)
    assert task_id == 1 and path.endswith("task_001")
    assert sorted(os.listdir(path)) == sorted(
        [f + s for f in ("weights.pkl", "exported_b001.pt2", "exported_b004.pt2", "probe.npz")
         for s in ("", ".sha256")] + ["meta.json"])
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["backend"] == "cpu" and meta["buckets"] == list(BUCKETS)
    # Registration is idempotent on re-export and monotone on `latest`.
    register_artifact(export_dir, 0, {"path": "task_000"})
    assert read_manifest(export_dir)["latest"] == 1


def test_bit_identity_per_bucket(export_dir):
    """Every bucket's loaded program equals the artifact's model run
    eagerly through ``eval_preprocess``, bitwise, for both tasks."""
    rng = np.random.RandomState(0)
    man = read_manifest(export_dir)
    for t in ("0", "1"):
        apath = os.path.join(export_dir, man["artifacts"][t]["path"])
        art = load_artifact(apath, "cpu")
        assert art.buckets == BUCKETS
        for bucket in art.buckets:
            x = _img(rng, bucket)
            np.testing.assert_array_equal(art.predict_padded(x, bucket),
                                          direct_predict(apath, x, "cpu"))
        # Full-width head, masked beyond `known`: a task-0 artifact never
        # argmaxes to a class it had not seen.
        out = art.predict_padded(_img(rng, art.buckets[-1]), art.buckets[-1])
        assert out.shape == (BUCKETS[-1], NB) and out.dtype == np.float32
        assert np.all(np.argmax(out, axis=-1) < art.known)
        assert np.all(out[:, art.known:] <= -1e9)


def test_pad_to_bucket_identity(export_dir):
    """predict() pads ragged batches to the covering bucket and chunks by
    the largest; the real rows equal the padded call's, bitwise."""
    rng = np.random.RandomState(1)
    _, apath = latest_artifact(export_dir)
    art = load_artifact(apath, "cpu")
    x3 = _img(rng, 3)  # 3 -> bucket 4
    padded = np.concatenate([x3, np.zeros((1, 32, 32, 3), np.uint8)])
    np.testing.assert_array_equal(art.predict(x3), art.predict_padded(padded, 4)[:3])
    assert art.bucket_for(3) == 4
    assert art.bucket_for(5) is None  # beyond the largest bucket
    x6 = _img(rng, 6)
    out = art.predict(x6)
    assert out.shape == (6, NB)
    np.testing.assert_array_equal(out[:4], art.predict_padded(x6[:4], 4))
    np.testing.assert_array_equal(out[4:], art.predict(x6[4:]))
    # A batch of another shape or dtype is refused, never traced anew.
    with pytest.raises(ValueError):
        art.predict_padded(x3, 4)
    with pytest.raises(ValueError):
        art.predict_padded(padded.astype(np.float32), 4)
    monitor = RecompileMonitor()
    art.register_recompiles(monitor)
    assert monitor.total("serve") == 0


def test_corrupt_weights_refused(export_dir, tmp_path):
    """A flipped byte in the weights payload fails the sha256 check at load,
    and so does one in a bucket's program; an artifact of another backend
    is refused."""
    _, apath = latest_artifact(export_dir)
    for name in ("weights.pkl", "exported_b004.pt2"):
        bad = str(tmp_path / f"bad_{name}")
        shutil.copytree(apath, bad)
        path = os.path.join(bad, name)
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(blob)
        with pytest.raises(OSError, match="checksum"):
            load_artifact(bad, "cpu")
    other = str(tmp_path / "other_backend")
    shutil.copytree(apath, other)
    meta_path = os.path.join(other, "meta.json")
    meta = json.load(open(meta_path))
    meta["backend"] = "cuda"
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(OSError, match="exported for 'cuda'"):
        load_artifact(other, "cpu")


class _Canary:
    def _cache_size(self):
        return 1


def test_warm_restart_zero_traces(export_dir):
    """Two servers in turn over the same artifacts: neither exports nor
    captures a program after load, pinned by a RecompileSentinel with budget
    0 (serving is granted no compile events)."""
    rng = np.random.RandomState(3)
    for restart in range(2):
        monitor = RecompileMonitor()
        sentinel = RecompileSentinel(monitor, group="serve", enforce=True)
        server = InferenceServer(export_dir, max_wait_ms=0.0, monitor=monitor,
                                 device="cpu").start()
        try:
            for f in [server.submit(_img(rng)) for _ in range(6)]:
                res = f.result(timeout=60)
                assert res["task_id"] == 1 and res["logits"].shape == (NB,)
                assert res["latency_ms"] >= 0.0
            stats = server.stats()
            assert stats["served"] == 6 and stats["failed"] == 0
            assert stats["p99_ms"] >= stats["p50_ms"] >= 0.0
            assert server.trace_count() == 0
            assert sentinel.check(f"warm-restart-{restart}") == 0
        finally:
            server.stop()
    # The sentinel is live, not vacuous: a tracked program that was made
    # after load busts the zero budget.
    monitor.track("canary", _Canary(), group="serve")
    with pytest.raises(RecompileBudgetExceeded):
        sentinel.check("canary")


def _stage(export_dir, tmp_path, *tasks):
    serve_dir = str(tmp_path / "serve")
    os.makedirs(serve_dir)
    for t in tasks:
        name = f"task_{t:03d}"
        shutil.copytree(os.path.join(export_dir, name), os.path.join(serve_dir, name))
        register_artifact(serve_dir, t, {"path": name})
    return serve_dir


def _publish(export_dir, serve_dir, t):
    name = f"task_{t:03d}"
    shutil.copytree(os.path.join(export_dir, name), os.path.join(serve_dir, name))
    register_artifact(serve_dir, t, {"path": name})


def test_hot_swap_failure_degrades_gracefully(export_dir, tmp_path):
    """swap_ioerror on the first attempt: the server keeps serving task 0,
    logs serve_swap_failed, drops nothing, and the next poll swaps cleanly
    to task 1 under continuing traffic."""
    rng = np.random.RandomState(4)
    serve_dir = _stage(export_dir, tmp_path, 0)
    log = str(tmp_path / "serve.jsonl")
    sink = JsonlLogger(log)
    inj = FaultInjector(parse_fault_spec("swap_ioerror@task1"),
                        ledger_path=str(tmp_path / "ledger.jsonl"), sink=sink)
    server = InferenceServer(serve_dir, max_wait_ms=1.0, poll_s=0.05, sink=sink,
                             faults=inj, device="cpu").start()
    results, errors = [], []
    stop = threading.Event()

    def traffic():
        img = _img(rng)
        while not stop.is_set():
            try:
                results.append(server.submit(img).result(timeout=60))
            except Exception as e:  # noqa: BLE001 — asserted empty below
                errors.append(repr(e))

    client = threading.Thread(target=traffic)
    client.start()
    try:
        time.sleep(0.2)
        _publish(export_dir, serve_dir, 1)
        deadline = time.time() + 60
        while time.time() < deadline and server.task_id != 1:
            time.sleep(0.05)
        time.sleep(0.2)
    finally:
        stop.set()
        client.join(timeout=60)
        server.stop()
    assert not client.is_alive()
    stats = server.stats()
    assert not errors and stats["failed"] == 0
    task_ids = [r["task_id"] for r in results]
    assert task_ids[0] == 0 and task_ids[-1] == 1
    assert sorted(set(task_ids)) == [0, 1]
    assert stats["swaps"] == 1 and stats["swap_failures"] == 1
    assert server.trace_count() == 0
    records = [json.loads(ln) for ln in open(log) if ln.strip()]
    kinds = [r["type"] for r in records]
    assert kinds.count("serve_swap_failed") == 1
    swaps = [r for r in records if r["type"] == "serve_swap"]
    assert [s["to_task"] for s in swaps] == [0, 1]
    assert swaps[0]["from_task"] is None and swaps[1]["from_task"] == 0
    assert kinds.index("serve_swap_failed") < kinds.index("serve_swap", 1)


class _ListSink:
    def __init__(self):
        self.records = []

    def log(self, rtype, **fields):
        self.records.append({"type": rtype, **fields})


def test_probe_artifact_replays_exactly(export_dir):
    art = load_artifact(os.path.join(export_dir, "task_000"), "cpu")
    assert probe_artifact(art) == {"ok": True, "checked": True, "max_abs": 0.0}


def test_probe_artifact_unchecked_for_pre_probe_artifacts(export_dir, tmp_path):
    serve_dir = _stage(export_dir, tmp_path, 0)
    apath = os.path.join(serve_dir, "task_000")
    os.unlink(os.path.join(apath, "probe.npz"))
    os.unlink(os.path.join(apath, "probe.npz.sha256"))
    meta_path = os.path.join(apath, "meta.json")
    meta = json.load(open(meta_path))
    meta["files"].pop("probe")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    verdict = probe_artifact(load_artifact(apath, "cpu"))
    assert verdict["ok"] and not verdict["checked"]


def test_probe_artifact_fails_on_a_corrupt_probe(export_dir, tmp_path):
    """A probe whose bytes no longer match their checksum cannot vouch for
    the artifact: the verdict is a failure, never a pass."""
    serve_dir = _stage(export_dir, tmp_path, 0)
    probe_path = os.path.join(serve_dir, "task_000", "probe.npz")
    blob = bytearray(open(probe_path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(probe_path, "wb") as f:
        f.write(blob)
    verdict = probe_artifact(load_artifact(os.path.join(serve_dir, "task_000"), "cpu"))
    assert not verdict["ok"] and verdict["checked"] and "checksum" in verdict["error"]


def _tamper_probe(apath):
    """Perturb the frozen logits and re-sign the sidecar: valid at the
    checksum layer, but the replay must catch the drift."""
    probe_path = os.path.join(apath, "probe.npz")
    blob = np.load(probe_path)
    buf = io.BytesIO()
    np.savez(buf, x=blob["x"], logits=blob["logits"] + 1e-3, bucket=blob["bucket"])
    with open(probe_path, "wb") as f:
        f.write(buf.getvalue())
    with open(probe_path + ".sha256", "w") as f:
        f.write(hashlib.sha256(buf.getvalue()).hexdigest())


def test_swap_to_rolls_back_on_probe_skew(export_dir, tmp_path):
    """An artifact whose outputs drifted from its frozen probe is not
    promoted: swap_to keeps serving the old task and logs serve_rollback
    with the measured drift."""
    serve_dir = _stage(export_dir, tmp_path, 0)
    sink = _ListSink()
    server = InferenceServer(serve_dir, max_wait_ms=1.0, sink=sink, auto_swap=False,
                             replica_id=2, device="cpu").start()
    try:
        _publish(export_dir, serve_dir, 1)
        _tamper_probe(os.path.join(serve_dir, "task_001"))
        out = server.swap_to(1)
        assert out["ok"] is False and server.task_id == 0
        rb = [r for r in sink.records if r["type"] == "serve_rollback"]
        assert len(rb) == 1
        assert rb[0]["replica"] == 2 and rb[0]["rolled_back_to"] == 0
        assert rb[0]["probe_checked"] and rb[0]["probe_max_abs"] > 0
        res = server.submit(_img(np.random.RandomState(0))).result(timeout=60)
        assert res["task_id"] == 0
    finally:
        server.stop()


def test_swap_to_fault_rolls_back_then_succeeds(export_dir, tmp_path):
    """The explicit swap honours the ``serve.swap`` fault site; the
    one-shot clause is spent on the refusal."""
    serve_dir = _stage(export_dir, tmp_path, 0)
    sink = _ListSink()
    inj = FaultInjector(parse_fault_spec("swap_ioerror@task1"),
                        ledger_path=str(tmp_path / "ledger.jsonl"), sink=sink)
    server = InferenceServer(serve_dir, max_wait_ms=1.0, sink=sink, faults=inj,
                             auto_swap=False, device="cpu").start()
    try:
        _publish(export_dir, serve_dir, 1)
        out = server.swap_to(1)
        assert out["ok"] is False and server.task_id == 0
        assert [r["type"] for r in sink.records].count("serve_rollback") == 1
        out = server.swap_to(1)
        assert out["ok"] is True and server.task_id == 1 and out["probe_checked"]
        assert server.swap_to(1).get("noop")
        assert server.stats()["rollbacks"] == 1
        assert server.trace_count() == 0
    finally:
        server.stop()
