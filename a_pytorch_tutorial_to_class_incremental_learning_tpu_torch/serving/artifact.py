"""Per-task serving artifacts: freeze, export, verify, reload, replay.

Counterpart of the JAX package's ``serving/artifact.py``, with its names,
its directory layout and its file contents.  One artifact is one directory
``<export_dir>/task_{t:03d}/`` holding

* ``weights.pkl`` (+ ``.sha256`` sidecar): the full-width model's host
  tensors, ``{"task_id", "known", "params", "batch_stats"}`` keyed by the
  model's ``state_dict`` names as in the port's checkpoints, written with
  the checkpoint layer's atomic rename and checksum
  (``utils/checkpoint.py``);
* ``exported_b{B:03d}.pt2`` (+ sidecars): the predict program of one batch
  bucket, ``torch.export``-ed at static shapes and ``torch.export.save``-d:
  uint8 NHWC ``[B, H, W, C]`` and an int32 scalar ``num_active`` in, f32
  ``[B, width]`` logits out (eval preprocessing, then the model in eval
  mode, the head masked beyond ``num_active``);
* ``probe.npz`` (+ sidecar): a seeded input and the logits the artifact's
  own load path gave for it, the gate of a swap (``skew.probe_artifact``);
* ``meta.json``: JAX's keys, ``backend`` being ``"cuda"`` or ``"cpu"``.

The directory is built under ``.tmp`` and renamed into place; then
``manifest.json`` is read, modified and replaced, and ``latest`` only moves
up, so a watcher never sees a half-written artifact.

The program is exported from a model built fresh on one device from the
gathered full-width state, never from the trainer's module (whose BN may
hold a process group, and whose head may gather over a model group inside
the forward), and on the device that will serve it: ``torch.export`` bakes
in the device of every tensor the forward creates.  The weights travel in
the program too, but ``weights.pkl`` is their one source of truth: a load
copies its tensors into every bucket's module, strictly, after its checksum
passed.

A load on the card then "compiles" each bucket, the counterpart of JAX's
``lower(...).compile()``: it warms the module up on a side stream and
captures one CUDA graph over static input buffers, under deterministic,
non-benchmark cuDNN with TF32 off (:func:`exact_cuda_numerics`): a
captured graph keeps the algorithms it was captured with, so a server in
another process replays the export's probe bitwise.  The capture is
thread-local, so a hot swap captures in one thread while the batcher
replays the old artifact in another.  Requests only ever replay; a batch of
another shape, dtype or device raises and is never captured.  On the CPU
there is no graph and the loaded module runs directly.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.augment import AugmentConfig
from ..models import create_model
from ..models.resnet import backbone_channels
from ..ops.precision import get_policy
from ..telemetry import CompileWatch
from ..utils.checkpoint import (
    _read_payload,
    _sha256_file,
    _write_pickle_atomic,
    _write_sidecar,
)
from ..utils.platform import resolve_device

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 8, 32, 64)

_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pkl"
_META = "meta.json"
_PROBE = "probe.npz"

# One capture at a time in a process: ``torch.cuda.graph`` synchronizes the
# device and empties the allocator's cache on entry, and two captures must
# not interleave their warm-ups.
_CAPTURE_LOCK = threading.Lock()


def _exported_name(bucket: int) -> str:
    return f"exported_b{bucket:03d}.pt2"


@contextlib.contextmanager
def exact_cuda_numerics():
    """Deterministic, non-benchmark cuDNN and no TF32 (convolutions and
    matmuls) inside; the caller's settings restored after.  Process-wide
    switches: the trainer's own cuDNN settings come back after an export."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _write_bytes_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    _write_sidecar(path, tmp)
    os.replace(tmp, path)


def _check_sidecar(path: str) -> None:
    sidecar = path + ".sha256"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            want = f.read().strip()
        got = _sha256_file(path)
        if got != want:
            raise OSError(f"checksum mismatch for {path} (want {want[:12]}, got {got[:12]})")


# --------------------------------------------------------------------- #
# Manifest
# --------------------------------------------------------------------- #


def read_manifest(export_dir: str) -> dict:
    path = os.path.join(export_dir, _MANIFEST)
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        # os.replace makes a torn manifest near-impossible; a transient read
        # failure reads as "nothing new" rather than killing the watcher.
        return {}


def register_artifact(export_dir: str, task_id: int, entry: dict) -> None:
    """Publish an artifact: read-modify-replace of ``manifest.json``, the
    linearization point (a watcher sees the old manifest or the new one)."""
    man = read_manifest(export_dir)
    man.setdefault("version", 1)
    artifacts = man.setdefault("artifacts", {})
    artifacts[str(task_id)] = entry
    man["latest"] = max(int(t) for t in artifacts)
    man["updated_ts"] = round(time.time(), 3)
    path = os.path.join(export_dir, _MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def latest_artifact(export_dir: str) -> Optional[Tuple[int, str]]:
    """``(task_id, artifact_dir)`` of the newest published artifact."""
    man = read_manifest(export_dir)
    latest = man.get("latest")
    if latest is None:
        return None
    entry = man.get("artifacts", {}).get(str(latest))
    if entry is None:
        return None
    return int(latest), os.path.join(export_dir, entry["path"])


# --------------------------------------------------------------------- #
# The predict program
# --------------------------------------------------------------------- #


class PredictModule(torch.nn.Module):
    """uint8 NHWC pixels and ``num_active`` in, f32 full-width logits out:
    the trainer's eval step (``engine/train.py`` ``make_eval_step``) without
    its loss.  ``255·mean`` and ``255·std`` are buffers made here, so the
    normalization is ``eval_preprocess``'s ``(x − m) / s`` bitwise and no
    tracing call reaches the augmentation's cache of constants."""

    def __init__(self, model: torch.nn.Module, aug_cfg: AugmentConfig):
        super().__init__()
        self.model = model
        self.register_buffer("mean255", torch.tensor(aug_cfg.mean, dtype=torch.float32) * 255.0,
                             persistent=False)
        self.register_buffer("std255", torch.tensor(aug_cfg.std, dtype=torch.float32) * 255.0,
                             persistent=False)

    def forward(self, x_u8: torch.Tensor, num_active: torch.Tensor) -> torch.Tensor:
        x = (x_u8.float() - self.mean255) / self.std255
        logits, _ = self.model(x, num_active, train=False)
        return logits


def _state_dict(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in {**params, **batch_stats}.items()}


def rebuild_model(meta: dict) -> Tuple[torch.nn.Module, AugmentConfig]:
    """A fresh one-device model of the artifact's width, backbone, BN and
    precision preset (zero weights), and its eval ``AugmentConfig``."""
    mm = meta["model"]
    policy = get_policy(mm.get("precision") or mm.get("compute_dtype", "float32"))
    model = create_model(mm["backbone"], int(mm["width"]),
                         bn_group_size=int(mm.get("bn_group_size", 0)), policy=policy)
    aug_cfg = AugmentConfig(input_size=meta["input_size"], mean=tuple(meta["mean"]),
                            std=tuple(meta["std"]))
    return model.eval(), aug_cfg


def _predict_module(meta: dict, state: Dict[str, torch.Tensor],
                    device: torch.device) -> PredictModule:
    model, aug_cfg = rebuild_model(meta)
    model.load_state_dict(state, strict=True)
    return PredictModule(model, aug_cfg).to(device).eval().requires_grad_(False)


def _meta_for(task_id, known, class_order, buckets, input_size, channels, aug_cfg,
              model_meta, device, acc_per_task) -> dict:
    return {
        "version": 1,
        "task_id": int(task_id),
        "known": int(known),
        "class_map": [int(c) for c in list(class_order)[: int(known)]],
        "buckets": list(buckets),
        "input_size": int(input_size),
        "channels": int(channels),
        "mean": [float(m) for m in aug_cfg.mean],
        "std": [float(s) for s in aug_cfg.std],
        "model": dict(model_meta),
        "backend": device.type,
        "acc_per_task": [float(a) for a in acc_per_task] if acc_per_task is not None else None,
        "files": {"weights": _WEIGHTS,
                  "exported": {str(b): _exported_name(b) for b in buckets},
                  "probe": _PROBE},
        "created_ts": round(time.time(), 3),
    }


# --------------------------------------------------------------------- #
# Export
# --------------------------------------------------------------------- #


def export_artifact(
    export_dir: str,
    task_id: int,
    aug_cfg: AugmentConfig,
    params: dict,
    batch_stats: dict,
    known: int,
    class_order: Sequence[int],
    input_size: int,
    channels: int,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    acc_per_task: Optional[Sequence[float]] = None,
    model_meta: Optional[dict] = None,
    device=None,
) -> str:
    """Freeze and export one task's inference state; returns the artifact dir.

    ``params`` and ``batch_stats`` are host arrays keyed by the full-width
    model's ``state_dict`` names (its parameters and its buffers);
    ``model_meta`` names the model (``backbone``, ``width``, ``precision``
    or ``compute_dtype``, ``bn_group_size``).  ``device`` is where the
    artifact will serve (CUDA unless ``"cpu"`` is asked for).  The probe's
    logits come from loading the artifact just written, through the
    server's own load path."""
    buckets = tuple(sorted({int(b) for b in buckets}))
    if not buckets or buckets[0] <= 0:
        raise ValueError(f"serve buckets must be positive ints, got {buckets!r}")
    if not model_meta or "backbone" not in model_meta or "width" not in model_meta:
        raise ValueError(f"model_meta must name the backbone and the width, got {model_meta!r}")
    device = resolve_device(device)
    final = os.path.join(export_dir, f"task_{task_id:03d}")
    tmp_dir = final + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    params = {k: np.asarray(v) for k, v in params.items()}
    batch_stats = {k: np.asarray(v) for k, v in batch_stats.items()}
    _write_pickle_atomic(os.path.join(tmp_dir, _WEIGHTS), {
        "task_id": int(task_id), "known": int(known),
        "params": params, "batch_stats": batch_stats,
    })
    meta = _meta_for(task_id, known, class_order, buckets, input_size, channels, aug_cfg,
                     model_meta, device, acc_per_task)
    module = _predict_module(meta, _state_dict(params, batch_stats), device)
    num_active = torch.tensor(int(known), dtype=torch.int32, device=device)
    for bucket in buckets:
        x = torch.zeros((bucket, input_size, input_size, channels), dtype=torch.uint8,
                        device=device)
        program = torch.export.export(module, (x, num_active))
        buf = io.BytesIO()
        torch.export.save(program, buf)
        _write_bytes_atomic(os.path.join(tmp_dir, _exported_name(bucket)), buf.getvalue())

    # The golden probe: a seeded input and the logits the server's own load
    # path gives for it.  A swapped-in server replays it and demands bit
    # equality (skew.probe_artifact), the promote-or-rollback gate.
    probe_bucket = buckets[0]
    probe_x = np.random.RandomState(0).randint(
        0, 256, (probe_bucket, input_size, input_size, channels)).astype(np.uint8)
    probe_logits = _load(tmp_dir, meta, device).predict_padded(probe_x, probe_bucket)
    buf = io.BytesIO()
    np.savez(buf, x=probe_x, logits=probe_logits, bucket=np.asarray(probe_bucket))
    _write_bytes_atomic(os.path.join(tmp_dir, _PROBE), buf.getvalue())

    meta_tmp = os.path.join(tmp_dir, _META + ".tmp")
    with open(meta_tmp, "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    os.replace(meta_tmp, os.path.join(tmp_dir, _META))
    if os.path.exists(final):
        shutil.rmtree(final)  # a re-export of the same task supersedes it
    os.rename(tmp_dir, final)
    register_artifact(export_dir, task_id, {
        "path": os.path.basename(final),
        "known": int(known),
        "buckets": list(buckets),
        "updated_ts": round(time.time(), 3),
    })
    return final


def export_from_trainer(trainer, task_id: int, known_after: int, acc_per_task=None) -> str:
    """Export the live trainer's just-aligned model.  The head is gathered
    to full width first (``utils/checkpoint.py`` ``_to_host``): on a model
    axis that is a collective of the model group, so every rank that holds
    a head shard calls this; rank 0 writes, and every rank then meets at a
    barrier.  Returns the artifact dir on rank 0, None elsewhere."""
    from ..parallel.dist import barrier, is_main_process
    from ..utils.checkpoint import _model_state, _writes_host_state

    cfg = trainer.config
    model = trainer.state.model
    state = _model_state(model) if _writes_host_state(trainer) else None
    path = None
    try:
        if is_main_process():
            model_meta = {
                "backbone": cfg.backbone,
                "width": int(state["params"]["fc.bias"].shape[0]),
                "compute_dtype": cfg.compute_dtype,
                "precision": trainer.policy.name,
                "bn_group_size": int(cfg.bn_group_size),
            }
            path = export_artifact(
                cfg.export_dir, task_id, trainer.aug_cfg, state["params"],
                state["batch_stats"], known=known_after,
                class_order=trainer.scenario_train.class_order,
                input_size=cfg.input_size, channels=backbone_channels(cfg.backbone),
                buckets=cfg.serve_buckets, acc_per_task=acc_per_task,
                model_meta=model_meta, device=trainer.device,
            )
    finally:
        barrier()
    return path


# --------------------------------------------------------------------- #
# Load
# --------------------------------------------------------------------- #


class _Programs:
    """What a :class:`~..telemetry.RecompileMonitor` tracks for one bucket:
    the exports and captures made after the artifact's load (0 while
    serving only replays).  Small on purpose, so that the monitor keeps no
    swapped-out artifact's graphs alive."""

    def __init__(self) -> None:
        self.after_load = 0

    def _cache_size(self) -> int:
        return self.after_load


class _BucketRunner:
    """One bucket's loaded program; on CUDA, its CUDA graph over static
    input and output buffers."""

    def __init__(self, module: torch.nn.Module, shape: Tuple[int, ...],
                 device: torch.device, num_active: torch.Tensor):
        self.module = module
        self.shape = shape
        self.device = device
        self.num_active = num_active
        self.programs = _Programs()
        self.graph = None
        self.capture_s = 0.0
        self._x = self._out = None

    def capture(self) -> float:
        """Warm up on a side stream, then capture one graph there; returns
        the seconds it took."""
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, exact_cuda_numerics(), torch.no_grad():
            x = torch.zeros(self.shape, dtype=torch.uint8, device=self.device)
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                for _ in range(2):
                    self.module(x, self.num_active)
            graph = torch.cuda.CUDAGraph()
            # Thread-local: another thread may replay, copy and sync while
            # this one captures (a hot swap under traffic).
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                out = self.module(x, self.num_active)
            stream.synchronize()
        if self.graph is not None:
            self.programs.after_load += 1
        self.graph, self._x, self._out = graph, x, out
        self.capture_s = time.perf_counter() - t0
        return self.capture_s

    def __call__(self, x_u8: np.ndarray, stream=None) -> np.ndarray:
        if not (isinstance(x_u8, np.ndarray) and x_u8.dtype == np.uint8
                and tuple(x_u8.shape) == self.shape):
            raise ValueError(
                f"bucket program takes uint8 {self.shape}, got "
                f"{getattr(x_u8, 'dtype', type(x_u8))} {tuple(getattr(x_u8, 'shape', ()))}")
        x = torch.from_numpy(np.ascontiguousarray(x_u8))
        if self.graph is None:
            with torch.no_grad():
                return self.module(x.to(self.device), self.num_active).cpu().numpy()
        with torch.cuda.stream(stream):
            self._x.copy_(x)
            self.graph.replay()
            return self._out.cpu().numpy()


class ServingArtifact:
    """One loaded task artifact: verified weights in every bucket's loaded
    program, and on the card one captured graph a bucket.

    ``predict``/``predict_padded`` only ever replay (on the CPU: run the
    loaded module).  A lock per artifact serializes them: the batcher, a
    swap's probe and a skew check may all reach one artifact."""

    def __init__(self, path: str, meta: dict, runners: Dict[int, _BucketRunner],
                 device: torch.device, load_ms: float, compile_ms: float):
        self.path = path
        self.meta = meta
        self.task_id = int(meta["task_id"])
        self.known = int(meta["known"])
        self.class_map = list(meta["class_map"])
        self.buckets = tuple(sorted(runners))
        self.device = device
        self.load_ms = load_ms
        self.compile_ms = compile_ms
        self.runners = runners
        self._lock = threading.Lock()
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def bucket_for(self, n: int) -> Optional[int]:
        for bucket in self.buckets:
            if bucket >= n:
                return bucket
        return None

    def predict_padded(self, x_u8: np.ndarray, bucket: int) -> np.ndarray:
        """Full-bucket logits for a batch already padded to ``bucket`` rows."""
        with self._lock:
            return self.runners[bucket](x_u8, self._stream)

    def predict(self, x_u8: np.ndarray) -> np.ndarray:
        """Logits for ``n`` images: padded to the smallest covering bucket
        (eval-mode rows are independent, so padding never changes a real
        row), chunked by the largest bucket when ``n`` exceeds it."""
        x = np.ascontiguousarray(x_u8, dtype=np.uint8)
        n = x.shape[0]
        max_bucket = self.buckets[-1]
        outs = []
        for lo in range(0, n, max_bucket):
            chunk = x[lo:lo + max_bucket]
            m = chunk.shape[0]
            bucket = self.bucket_for(m)
            if m < bucket:
                pad = np.zeros((bucket - m,) + chunk.shape[1:], np.uint8)
                chunk = np.concatenate([chunk, pad])
            outs.append(self.predict_padded(chunk, bucket)[:m])
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def register_recompiles(self, monitor, group: str = "serve") -> None:
        """Track each bucket's post-load exports and captures:
        ``monitor.total(group)`` staying 0 is the proof that serving never
        traced or captured."""
        for bucket, runner in sorted(self.runners.items()):
            monitor.track(f"serve_b{bucket}[task{self.task_id}]", runner.programs, group=group)


def _load(path: str, meta: dict, device: torch.device) -> ServingArtifact:
    t0 = time.perf_counter()
    if meta.get("backend") != device.type:
        raise OSError(f"artifact {path} was exported for {meta.get('backend')!r} and cannot "
                      f"serve on {device.type!r}: export it on the serving device")
    payload, why = _read_payload(os.path.join(path, meta["files"]["weights"]))
    if payload is None:
        raise OSError(f"invalid artifact weights in {path}: {why}")
    state = {"model." + k: v for k, v in
             _state_dict(payload["params"], payload["batch_stats"]).items()}
    num_active = torch.tensor(int(meta["known"]), dtype=torch.int32, device=device)
    shape = (meta["input_size"], meta["input_size"], meta["channels"])
    runners: Dict[int, _BucketRunner] = {}
    for bucket_s, name in sorted(meta["files"]["exported"].items(), key=lambda kv: int(kv[0])):
        bucket = int(bucket_s)
        blob_path = os.path.join(path, name)
        _check_sidecar(blob_path)
        try:
            module = torch.export.load(blob_path).module()
        except (OSError, RuntimeError, ValueError, KeyError) as e:
            raise OSError(f"unreadable exported program {blob_path}: {e!r}") from e
        # One source of truth for the weights: weights.pkl's, checked.
        module.load_state_dict(state, strict=True)
        runners[bucket] = _BucketRunner(module.requires_grad_(False), (bucket, *shape),
                                        device, num_active)
    compile_s = 0.0
    if device.type == "cuda":
        watch = CompileWatch.install()
        for runner in runners.values():
            seconds = runner.capture()
            watch.record_capture(seconds)
            compile_s += seconds
    return ServingArtifact(path, meta, runners, device,
                           load_ms=round((time.perf_counter() - t0) * 1000.0, 3),
                           compile_ms=round(compile_s * 1000.0, 3))


def load_artifact(path: str, device=None) -> ServingArtifact:
    """Verify and load one artifact directory onto ``device`` (CUDA unless
    ``"cpu"`` is asked for), capturing every bucket's graph on the card.

    Raises ``OSError`` on any integrity failure (an unreadable meta, a
    missing or corrupt weights payload or program, an artifact of another
    backend): the server treats that as a failed swap and keeps serving."""
    device = resolve_device(device)
    meta_path = os.path.join(path, _META)
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise OSError(f"unreadable artifact meta {meta_path}: {e!r}") from e
    return _load(path, meta, device)


# --------------------------------------------------------------------- #
# Parity: the artifact's model run eagerly (tests and the smoke only)
# --------------------------------------------------------------------- #


def direct_predict(path: str, x_u8: np.ndarray, device=None) -> np.ndarray:
    """Logits of a freshly rebuilt (not exported) model over the artifact's
    weights, through the trainer's ``eval_preprocess``, at exactly the given
    batch shape: the reference side of the parity checks, never part of
    the serving path."""
    from ..data.augment import eval_preprocess

    device = resolve_device(device)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    payload, why = _read_payload(os.path.join(path, meta["files"]["weights"]))
    if payload is None:
        raise OSError(f"invalid artifact weights in {path}: {why}")
    model, aug_cfg = rebuild_model(meta)
    model.load_state_dict(_state_dict(payload["params"], payload["batch_stats"]), strict=True)
    model.to(device)
    x = torch.from_numpy(np.ascontiguousarray(x_u8, np.uint8)).to(device)
    num_active = torch.tensor(int(meta["known"]), dtype=torch.int32, device=device)
    with torch.no_grad(), exact_cuda_numerics():
        logits, _ = model(eval_preprocess(x, aug_cfg), num_active, train=False)
    return logits.cpu().numpy()
