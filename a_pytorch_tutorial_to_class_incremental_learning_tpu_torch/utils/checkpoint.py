"""Task- and epoch-granular checkpoint/resume.

Counterpart of the JAX package's ``utils/checkpoint.py``, with the same
function names, file names and payload keys, so a payload either package
writes verifies under the other's reader:

* **Task boundary** (always on with ``--ckpt_dir``): after task t finishes
  (aligned, evaluated, herded) ``task_{t:03d}.ckpt`` holds what ``fit()``
  needs to go on at task t+1: the model, the rehearsal memory, the accuracy
  history and the class count.  No momentum: every task starts SGD afresh.
* **Epoch boundary** (``--epoch_ckpt_every E``): ``task_{t:03d}_epoch_{e:03d}.ckpt``
  also holds the SGD momentum and the teacher, so a kill mid-task resumes at
  the last epoch boundary.  Every generator stream is a pure function of
  ``(seed, stream, task[, epoch])`` and every shuffle a hash of the same
  triple (``engine/loop.py``), and the memory only changes at task
  boundaries, so an epoch boundary needs no generator state and a resumed
  run repeats its uninterrupted twin.  A task's epoch files are deleted once
  its task file lands.

The state goes in as numpy arrays keyed by the model's ``state_dict`` names:
``params`` (the parameters), ``batch_stats`` (every buffer: the BN running
statistics), ``momentum`` (keyed by parameter name) and ``teacher``
(``{"params", "batch_stats"}``).  A restore copies them into the live
tensors (``Tensor.copy_``) and never rebinds a tensor to a payload array:
``torch.from_numpy`` shares the array's buffer, so a rebound CPU tensor
would alias the unpickled payload.  ``--check_donation`` proves no trainer
tensor shares memory with the payload, then poisons the payload (NaN).

Integrity, as in JAX: the payload is written to ``.tmp``, its sha256 lands
in a ``.sha256`` sidecar, then the payload is renamed into place.  A restore
verifies the checksum and unpickles each candidate, newest first, and falls
back past each invalid one with a ``ckpt_fallback`` record; stale ``*.tmp``
files are deleted on scan.  Rank 0 writes, then every rank meets at a
barrier; at restore the ranks all-gather their resume points and refuse to
go on unless they agree.

Fault injection (``--fault_spec``): each save fires site ``ckpt.save``;
``save_ioerror`` raises before any byte is written, ``truncate_ckpt`` and
``corrupt_ckpt`` damage the finished payload (for ``orbax``, its ``.meta``
sidecar, as JAX does) without refreshing its checksum.

Two formats (``--ckpt_backend``), as in JAX:

* ``pickle`` (default): the payload above, written by rank 0.  On a model
  axis the head is gathered over rank 0's model group first, so a payload
  holds the full-width head whatever the mesh (JAX's ``_to_host`` makes it
  so), and a restore gives each rank its rows.
* ``orbax``: the device trees (``params`` and ``batch_stats``, plus
  ``momentum`` and the teacher's ``teacher_params``/``teacher_batch_stats``
  at epoch granularity) through ``torch.distributed.checkpoint``, every
  rank writing its own shards: a head shard is a ``DTensor`` sharded on the
  model dimension and replicated over data, so each shard is written once.
  The host half (memory, history, counters) is the ``.meta`` pickle beside
  the directory, with its ``.sha256``, written first; then, after a
  barrier, the directory is written under a temporary name and renamed by
  rank 0 after a second barrier, so a crash never leaves a directory that
  loads without its ``.meta``.  The restore reads into fresh tensors shaped
  like the live state (its template) and copies them into the live
  tensors.  The tensors stay on the card: ``torch.distributed.checkpoint``
  stages them through the host itself, under ``gloo`` as under ``nccl``.
"""

from __future__ import annotations

import copy
import hashlib
import os
import pickle
import re
import shutil
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.dist import barrier, is_main_process
from ..parallel.mesh import HEAD_PARAMS, gather_full, shard_rows

_TASK_RE = re.compile(r"task_(\d+)\.(ckpt|orbax)")
_EPOCH_RE = re.compile(r"task_(\d+)_epoch_(\d+)\.(ckpt|orbax)")


def _ext(backend: str) -> str:
    return "orbax" if backend == "orbax" else "ckpt"


def _task_path(ckpt_dir: str, task_id: int, backend: str = "pickle") -> str:
    return os.path.join(ckpt_dir, f"task_{task_id:03d}.{_ext(backend)}")


def _epoch_path(ckpt_dir: str, task_id: int, epoch: int, backend: str = "pickle") -> str:
    return os.path.join(ckpt_dir, f"task_{task_id:03d}_epoch_{epoch:03d}.{_ext(backend)}")


def _head_axis(model, name: str):
    """The model axis that shards tensor ``name`` of ``model``, or None."""
    return model.head_axis if name in HEAD_PARAMS else None


def _to_host(model, named: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """Host copies, a head shard gathered to the full head (a collective of
    the model group: every rank calls this on a sharded model)."""
    out = {}
    for name, t in named:
        axis = _head_axis(model, name)
        full = gather_full(axis, t) if axis is not None else t
        out[name] = full.detach().cpu().numpy()
    return out


def _model_state(model) -> dict:
    return {
        "params": _to_host(model, model.named_parameters()),
        "batch_stats": _to_host(model, model.named_buffers()),
    }


def _writes_host_state(trainer) -> bool:
    """Whether this rank makes a pickle payload's host copies: rank 0, and
    on a model axis every rank, which all take part in the head's gathers."""
    return is_main_process() or trainer.state.model.head_axis is not None


def _acc_matrix(trainer) -> List[Optional[List[float]]]:
    """Row ``t`` is the accuracy row after task ``t`` (None where missing)."""
    rows = trainer.matrix.rows
    return [list(rows[t]) if t in rows else None for t in range(len(trainer.acc1s))]


def _metadata(trainer, task_id: int) -> dict:
    return {
        "task_id": task_id,
        "known": trainer.known,  # already includes this task's classes
        "acc1s": list(trainer.acc1s),
        "acc_matrix": _acc_matrix(trainer),
        "memory_store": trainer.memory._store,
        "config_seed": trainer.config.seed,
    }


# --------------------------------------------------------------------- #
# Integrity: sha256 sidecars + validated reads
# --------------------------------------------------------------------- #


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_sidecar(payload_path: str, payload_tmp: str) -> None:
    """Checksum of the (still ``.tmp``) payload, landed atomically at
    ``<payload>.sha256`` before the payload's own rename: a crash between
    the two leaves an orphan sidecar, which readers ignore."""
    digest = _sha256_file(payload_tmp)
    tmp = payload_path + ".sha256.tmp"
    with open(tmp, "w") as f:
        f.write(digest + "\n")
    os.replace(tmp, payload_path + ".sha256")


def _payload_file(path: str) -> str:
    """The pickle the integrity checks cover (a JAX ``orbax`` checkpoint
    keeps it in a ``.meta`` sidecar beside its directory)."""
    return path + ".meta" if path.endswith(".orbax") else path


def _read_payload(path: str) -> Tuple[Optional[dict], Optional[str]]:
    """Checksum-verify and unpickle; ``(payload, None)`` or ``(None, why)``.

    A payload without a sidecar (written before checksums) is accepted iff
    it unpickles: truncation still fails the unpickle."""
    target = _payload_file(path)
    if not os.path.exists(target):
        return None, "missing payload"
    sidecar = target + ".sha256"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            want = f.read().strip()
        got = _sha256_file(target)
        if got != want:
            return None, f"checksum mismatch (want {want[:12]}, got {got[:12]})"
    try:
        with open(target, "rb") as f:
            return pickle.load(f), None  # noqa: S301 - trusted local checkpoint
    except Exception as e:  # a torn pickle raises many exception types
        return None, f"unreadable payload: {e!r}"


# --------------------------------------------------------------------- #
# Candidate scan
# --------------------------------------------------------------------- #


def checkpoint_candidates(ckpt_dir: str) -> List[Tuple[int, Optional[int], str]]:
    """Resume candidates, newest progress first, as ``(task, epoch, path)``.

    ``epoch is None`` marks a task-boundary checkpoint, which outranks every
    epoch checkpoint of its task and everything of earlier tasks.  Stale
    ``*.tmp`` files of a crashed save are deleted here, never ranked."""
    if not os.path.isdir(ckpt_dir):
        return []
    ranked = []
    for name in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(ckpt_dir, name)
        if name.endswith(".tmp"):
            try:
                if os.path.isdir(path):  # an orbax directory a crash cut short
                    shutil.rmtree(path)
                else:
                    os.remove(path)
                print(f"| removed stale checkpoint temp file {path}")
            except OSError:
                pass  # another rank's scan removed it first
            continue
        m = _TASK_RE.fullmatch(name)
        if m:
            if m.group(2) == "orbax" and not os.path.exists(path + ".meta"):
                continue  # incomplete: sidecar missing
            ranked.append((int(m.group(1)), float("inf"), path))
            continue
        m = _EPOCH_RE.fullmatch(name)
        if m:
            if m.group(3) == "orbax" and not os.path.exists(path + ".meta"):
                continue
            ranked.append((int(m.group(1)), float(m.group(2)), path))
    ranked.sort(key=lambda it: (it[0], it[1]), reverse=True)
    return [(t, None if e == float("inf") else int(e), p) for t, e, p in ranked]


def latest_task_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest checkpoint that verifies (checksum and unpickle)."""
    for _task, _epoch, path in checkpoint_candidates(ckpt_dir):
        payload, _why = _read_payload(path)
        if payload is not None:
            return path
    return None


# --------------------------------------------------------------------- #
# Saves
# --------------------------------------------------------------------- #


def _fire_save_faults(trainer, task_id: int, epoch: Optional[int] = None):
    faults = getattr(trainer, "faults", None)
    if faults is None:
        return ()
    coords = {"task": task_id}
    if epoch is not None:
        coords["epoch"] = epoch
    actions = faults.fire("ckpt.save", **coords)
    if "save_ioerror" in actions:
        raise OSError(
            f"fault-injected transient checkpoint save failure "
            f"(task {task_id}, epoch {epoch})"
        )
    return actions


def _apply_payload_faults(actions, path: str) -> None:
    """Damage the finished payload as storage does: after the rename,
    without touching its checksum sidecar."""
    if not actions or not is_main_process():
        return
    target = _payload_file(path)
    size = os.path.getsize(target)
    if "truncate_ckpt" in actions:
        with open(target, "r+b") as f:
            f.truncate(max(size // 2, 1))
        print(f"| fault: truncated {target} to {max(size // 2, 1)} bytes")
    if "corrupt_ckpt" in actions:
        with open(target, "r+b") as f:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([(byte[0] if byte else 0) ^ 0xFF]))
        print(f"| fault: flipped a byte at offset {size // 2} of {target}")


def _write_pickle_atomic(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    _write_sidecar(path, tmp)
    os.replace(tmp, path)


def _dcp_tensor(trainer, model, name: str, t: torch.Tensor):
    """``t`` as ``torch.distributed.checkpoint`` takes it: a head shard as a
    ``DTensor`` over the ``(data, model)`` mesh, sharded on the model
    dimension and replicated over data; anything else as it is."""
    if _head_axis(model, name) is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = trainer.mesh.device_mesh(t.device.type)
    return DTensor.from_local(t, mesh, [Replicate(), Shard(0)], run_check=False)


def _device_trees(trainer, epoch_granular: bool, teacher=None,
                  fresh: bool = False) -> Dict[str, dict]:
    """JAX's orbax trees of the live state: ``params`` and ``batch_stats``,
    plus ``momentum`` and, with a ``teacher`` model, ``teacher_params`` and
    ``teacher_batch_stats`` at epoch granularity.  ``fresh`` gives new
    tensors of the same shapes (a restore's template) instead of the live
    ones."""
    model = trainer.state.model
    names = [n for n, _ in model.named_parameters()]

    def tree(named):
        return {n: _dcp_tensor(trainer, model, n,
                               torch.empty_like(t) if fresh else t.detach())
                for n, t in named}

    trees = {"params": tree(model.named_parameters()),
             "batch_stats": tree(model.named_buffers())}
    if epoch_granular:
        trees["momentum"] = tree(zip(names, trainer.state.momentum))
        if teacher is not None:
            trees["teacher_params"] = tree(teacher.named_parameters())
            trees["teacher_batch_stats"] = tree(teacher.named_buffers())
    return trees


def _load_sharded(trainer, path: str, payload: dict, epoch_granular: bool) -> dict:
    """The ``orbax`` backend's restore: every rank reads its shards into a
    template of fresh tensors shaped like the live state, as JAX restores
    onto the live state's shardings; returns ``payload`` with the pickle
    backend's trees (``params``, ``batch_stats`` and, at epoch granularity,
    ``momentum`` and ``teacher``) holding those tensors, for the caller to
    copy into the live ones."""
    import torch.distributed.checkpoint as dcp

    has_teacher = epoch_granular and payload["has_teacher"]
    trees = _device_trees(trainer, epoch_granular,
                          teacher=trainer.state.model if has_teacher else None, fresh=True)
    dcp.load(trees, checkpoint_id=path, no_dist=not dist.is_initialized())
    local = {k: {n: t.to_local() if hasattr(t, "to_local") else t for n, t in tree.items()}
             for k, tree in trees.items()}
    out = dict(payload, params=local["params"], batch_stats=local["batch_stats"])
    if epoch_granular:
        out["momentum"] = local["momentum"]
        out["teacher"] = ({"params": local["teacher_params"],
                           "batch_stats": local["teacher_batch_stats"]}
                          if has_teacher else None)
    return out


def _save_sharded(trainer, path: str, meta: dict, trees: Dict[str, dict]) -> None:
    """The ``orbax`` backend's save: the ``.meta`` pickle (rank 0) first,
    then every rank's shards into ``path.tmp``, renamed to ``path`` by rank
    0 once every rank has written."""
    import torch.distributed.checkpoint as dcp

    if is_main_process():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _write_pickle_atomic(path + ".meta", meta)
    barrier()
    tmp = path + ".tmp"
    dcp.save(trees, checkpoint_id=tmp, no_dist=not dist.is_initialized())
    barrier()
    if is_main_process():
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)


def save_task_checkpoint(trainer, task_id: int) -> str:
    """Persist the post-task state (``CilTrainer.fit`` with ``ckpt_dir``)
    and drop the task's epoch files."""
    ckpt_dir = trainer.config.ckpt_dir
    backend = trainer.config.ckpt_backend
    path = _task_path(ckpt_dir, task_id, backend)
    actions = _fire_save_faults(trainer, task_id)
    if backend == "orbax":
        _save_sharded(trainer, path, _metadata(trainer, task_id),
                      _device_trees(trainer, epoch_granular=False))
    elif _writes_host_state(trainer):
        state = _model_state(trainer.state.model)
        if is_main_process():
            os.makedirs(ckpt_dir, exist_ok=True)
            payload = _metadata(trainer, task_id)
            payload.update(state)
            _write_pickle_atomic(path, payload)
    _apply_payload_faults(actions, path)
    if is_main_process():
        _drop_epoch_checkpoints(ckpt_dir, task_id)
    barrier()
    return path


def _epoch_metadata(trainer, task_id: int, epoch: int, nb_new: int) -> dict:
    return {
        "task_id": task_id,
        "epoch": epoch,               # completed epochs, 1-based
        "known": trainer.known,       # before the task (it is mid-flight)
        "nb_new": nb_new,
        "acc1s": list(trainer.acc1s),
        "acc_matrix": _acc_matrix(trainer),
        "memory_store": trainer.memory._store,
        "config_seed": trainer.config.seed,
        "global_step": trainer.global_step,
        # Provenance, not state: epoch e+1's generators are seeded from
        # (seed, stream, task, epoch) and its shuffle hashes the same
        # triple, so the batch cursor at an epoch boundary is always 0.
        "rng": {"root_seed": trainer.config.seed, "task_fold": task_id,
                "next_epoch": epoch},
        "perm_cursor": 0,
    }


def save_epoch_checkpoint(trainer, task_id: int, epoch: int, nb_new: int) -> str:
    """Persist the mid-task state after ``epoch`` completed epochs: the task
    payload's fields plus the momentum, the teacher, the pre-task
    ``known``/``nb_new`` split and the step count."""
    ckpt_dir = trainer.config.ckpt_dir
    backend = trainer.config.ckpt_backend
    path = _epoch_path(ckpt_dir, task_id, epoch, backend)
    actions = _fire_save_faults(trainer, task_id, epoch=epoch)
    if backend == "orbax":
        meta = _epoch_metadata(trainer, task_id, epoch, nb_new)
        meta["has_teacher"] = trainer.teacher is not None
        teacher = trainer.teacher.model if trainer.teacher is not None else None
        _save_sharded(trainer, path, meta,
                      _device_trees(trainer, epoch_granular=True, teacher=teacher))
    elif _writes_host_state(trainer):
        model = trainer.state.model
        names = [n for n, _ in model.named_parameters()]
        state = dict(
            _model_state(model),
            momentum=_to_host(model, zip(names, trainer.state.momentum)),
            teacher=(_model_state(trainer.teacher.model)
                     if trainer.teacher is not None else None),
        )
        if is_main_process():
            os.makedirs(ckpt_dir, exist_ok=True)
            payload = _epoch_metadata(trainer, task_id, epoch, nb_new)
            payload.update(state)
            _write_pickle_atomic(path, payload)
    _apply_payload_faults(actions, path)
    barrier()
    return path


def _drop_epoch_checkpoints(ckpt_dir: str, task_id: int) -> None:
    """The task-boundary checkpoint supersedes its task's epoch files: a
    pickle and its ``.sha256``, or an ``orbax`` directory, its ``.meta``
    and the ``.meta``'s ``.sha256``."""
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        m = _EPOCH_RE.fullmatch(name)
        if m and int(m.group(1)) == task_id:
            target = os.path.join(ckpt_dir, name)
            if os.path.isdir(target):
                shutil.rmtree(target, ignore_errors=True)
            for victim in (name, name + ".sha256", name + ".meta", name + ".meta.sha256"):
                try:
                    os.remove(os.path.join(ckpt_dir, victim))
                except OSError:
                    pass  # a sidecar may legitimately not exist


# --------------------------------------------------------------------- #
# Restore
# --------------------------------------------------------------------- #


class CheckpointAliasError(RuntimeError):
    """A trainer tensor shares memory with an unpickled payload array."""


def _trainer_tensors(trainer) -> Dict[str, torch.Tensor]:
    out = {f"model.{n}": t for n, t in trainer.state.model.state_dict(keep_vars=True).items()}
    out.update({f"momentum.{i}": m for i, m in enumerate(trainer.state.momentum)})
    out["num_active"] = trainer.state.num_active
    out["known"] = trainer.state.known
    if trainer.teacher is not None:
        out.update({f"teacher.{n}": t for n, t in
                    trainer.teacher.model.state_dict(keep_vars=True).items()})
    return out


def _host_arrays(payload: dict) -> List[np.ndarray]:
    """The restored state's host buffers: the unpickled arrays, or the
    ``orbax`` reader's tensors that live on the host (one on the card
    cannot alias a trainer tensor on the host)."""
    trees = [payload.get(k) for k in ("params", "batch_stats", "momentum")]
    if payload.get("teacher") is not None:
        trees += [payload["teacher"]["params"], payload["teacher"]["batch_stats"]]
    arrays = [a for tree in trees if tree for a in tree.values()]
    return [a.numpy() if isinstance(a, torch.Tensor) else a for a in arrays
            if not isinstance(a, torch.Tensor) or a.device.type == "cpu"]


def assert_unaliased(arrays: List[np.ndarray], tensors: Dict[str, torch.Tensor],
                     where: str) -> None:
    """Raise :class:`CheckpointAliasError` if any CPU tensor's storage
    overlaps the memory of any of ``arrays`` (a CUDA tensor cannot)."""
    spans = []
    for a in arrays:
        lo = a.__array_interface__["data"][0]
        spans.append((lo, lo + a.nbytes))
    offenders = []
    for name, t in tensors.items():
        if t.device.type != "cpu":
            continue
        s = t.untyped_storage()
        lo, hi = s.data_ptr(), s.data_ptr() + s.nbytes()
        if any(lo < a_hi and a_lo < hi for a_lo, a_hi in spans):
            offenders.append(name)
    if offenders:
        raise CheckpointAliasError(
            f"[{where}] {len(offenders)} trainer tensor(s) share memory with the "
            f"unpickled checkpoint ({', '.join(offenders[:5])}"
            + (", ..." if len(offenders) > 5 else "")
            + "); a restore must copy_ into the live tensors, never rebind them"
        )


def poison_host_arrays(arrays: List[np.ndarray]) -> int:
    """Fill the dead payload arrays (float NaN, int -2^30) so a surviving
    alias shows as NaN metrics at the restore point; returns the count."""
    count = 0
    for a in arrays:
        if not a.nbytes or not a.flags.writeable:
            continue
        if np.issubdtype(a.dtype, np.floating):
            a.fill(np.nan)
        elif np.issubdtype(a.dtype, np.integer):
            a.fill(-(2 ** 30))
        else:
            continue
        count += 1
    return count


@torch.no_grad()
def _copy_into(model, named: Iterable[Tuple[str, torch.Tensor]], arrays: Dict[str, object],
               what: str) -> None:
    """``Tensor.copy_`` every array (numpy, or a reader's tensor) into the
    live tensor of ``model`` of the same name; names, dtypes and shapes must
    match exactly, but for a head shard, which takes its rows of a
    full-width array."""
    named = dict(named)
    if set(named) != set(arrays):
        diff = sorted(set(named) ^ set(arrays))
        raise ValueError(f"checkpoint {what} names differ from the model's: {diff[:5]}")
    for name, t in named.items():
        src = arrays[name]
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.asarray(src))
        axis = _head_axis(model, name)
        if axis is not None and src.shape[0] == t.shape[0] * axis.size:
            src = shard_rows(axis, src)
        if src.shape != t.shape or src.dtype != t.dtype:
            raise ValueError(
                f"checkpoint {what} {name!r} is {src.dtype}{tuple(src.shape)}, "
                f"the model's {t.dtype}{tuple(t.shape)}"
            )
        t.copy_(src)


def _load_model(model, state: dict) -> None:
    _copy_into(model, model.named_parameters(), state["params"], "params")
    _copy_into(model, model.named_buffers(), state["batch_stats"], "batch_stats")


def _new_teacher(trainer, known: int, state: Optional[dict] = None):
    """The teacher: a deep copy of the student (frozen), optionally loaded
    from a saved teacher state."""
    from ..engine.train import Teacher

    model = copy.deepcopy(trainer.state.model).requires_grad_(False)
    if state is not None:
        _load_model(model, state)
    return Teacher(model=model, known=trainer._count(known))


def _parse_ckpt_name(path: str) -> Tuple[int, Optional[int]]:
    name = os.path.basename(path)
    m = _EPOCH_RE.fullmatch(name)
    if m:
        return int(m.group(1)), int(m.group(2))
    m = _TASK_RE.fullmatch(name)
    if m:
        return int(m.group(1)), None
    return -1, None


def _resume_code(task_id: int, epoch: Optional[int]) -> int:
    """Task major, epoch minor, a task boundary above any of its epochs:
    the order of :func:`checkpoint_candidates`."""
    return task_id * 1_000_000 + (999_999 if epoch is None else epoch)


def _agree_on_resume_point(trainer, found: int) -> None:
    """Every rank of the world must have found the same resume point."""
    world = trainer.mesh.size
    if world == 1:
        return
    mine = torch.tensor([found], dtype=torch.int64, device=trainer.device)
    seen = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(seen, mine)
    values = [int(s.item()) for s in seen]
    if len(set(values)) != 1:
        raise RuntimeError(
            f"ranks disagree on the latest checkpoint ({values}); is ckpt_dir on "
            "storage that every rank sees?"
        )


def _restore_history(trainer, payload: dict) -> None:
    trainer.known = int(payload["known"])
    trainer.acc1s = list(payload["acc1s"])
    # Rows padded to len(acc1s) with None, so row index stays == task id.
    matrix = [list(r) if r is not None else None for r in payload.get("acc_matrix", [])]
    matrix += [None] * (len(payload["acc1s"]) - len(matrix))
    trainer.matrix.rows.clear()
    for t, row in enumerate(matrix):
        if row:
            trainer.matrix.add_row(t, row)
    trainer.memory._store = payload["memory_store"]


def load_task_checkpoint(trainer, path: Optional[str] = None) -> bool:
    """Restore ``trainer`` from the newest valid checkpoint (or ``path``).

    A task payload restores to "right after task t" (``start_task = t+1``,
    fresh momentum, the teacher made from the restored model); an epoch
    payload to "task t with ``e`` epochs done" (``start_task = t``,
    ``start_epoch = e``, the saved momentum and teacher).  Invalid
    candidates are skipped with a ``ckpt_fallback`` record.  Returns True
    when something was loaded."""
    sink = getattr(trainer, "jsonl", None)
    if path is not None:
        task_id, epoch = _parse_ckpt_name(path)
        candidates = [(task_id, epoch, path)] if os.path.exists(_payload_file(path)) else []
    else:
        candidates = checkpoint_candidates(trainer.config.ckpt_dir or "")
    chosen = None
    for task_id, epoch, cand in candidates:
        payload, why = _read_payload(cand)
        if payload is None:
            print(f"| skipping invalid checkpoint {cand}: {why}")
            if sink is not None:
                sink.log("ckpt_fallback", skipped=cand, reason=why)
            continue
        chosen = (task_id, epoch, cand, payload)
        break
    _agree_on_resume_point(trainer, -1 if chosen is None else _resume_code(*chosen[:2]))
    if chosen is None:
        return False
    task_id, epoch, path, payload = chosen
    if payload["config_seed"] != trainer.config.seed:
        raise ValueError(
            f"checkpoint seed {payload['config_seed']} != config seed "
            f"{trainer.config.seed}; refusing silent mix of experiments"
        )
    if path.endswith(".orbax"):
        payload = _load_sharded(trainer, path, payload, epoch_granular=epoch is not None)
    if epoch is not None:
        return _restore_epoch(trainer, path, payload)
    _load_model(trainer.state.model, payload)
    known = int(payload["known"])
    trainer.state.momentum = [torch.zeros_like(p) for p in trainer.state.model.parameters()]
    trainer.state.num_active = trainer._count(known)
    trainer.state.known = trainer._count(known)
    # The post-task model is the next task's teacher.
    trainer.teacher = _new_teacher(trainer, known)
    _check_donation(trainer, payload, path)
    _restore_history(trainer, payload)
    trainer.start_task = payload["task_id"] + 1
    trainer.start_epoch = 0
    trainer.resumed_from = {"path": path, "kind": "task"}
    _note_restore(trainer, payload)
    print(f"| resumed from {path}: next task {trainer.start_task}, known={known}")
    return True


def _note_restore(trainer, payload: dict) -> None:
    """A restore grants ``--recompile_budget`` one more program: the
    resumed task captures its graph anew."""
    sentinel = getattr(trainer, "recompile_sentinel", None)
    if sentinel is not None:
        sentinel.note_event("restore", task_id=payload["task_id"])


def _restore_epoch(trainer, path: str, payload: dict) -> bool:
    """Drop the trainer mid-task: task ``task_id`` has grown its head and
    run ``epoch`` epochs; ``fit()`` goes on at ``start_epoch`` without
    growing the head again."""
    known = int(payload["known"])
    nb_new = int(payload["nb_new"])
    model = trainer.state.model
    _load_model(model, payload)
    names = [n for n, _ in model.named_parameters()]
    _copy_into(model, zip(names, trainer.state.momentum), payload["momentum"], "momentum")
    trainer.state.num_active = trainer._count(known + nb_new)
    trainer.state.known = trainer._count(known)
    trainer.teacher = (_new_teacher(trainer, known, payload["teacher"])
                       if payload["teacher"] is not None else None)
    _check_donation(trainer, payload, path)
    _restore_history(trainer, payload)
    trainer.start_task = payload["task_id"]
    trainer.start_epoch = int(payload["epoch"])
    trainer.global_step = int(payload.get("global_step", 0))
    trainer.resumed_from = {"path": path, "kind": "epoch"}
    _note_restore(trainer, payload)
    print(
        f"| resumed from {path}: task {trainer.start_task} at epoch "
        f"{trainer.start_epoch + 1}, known={known}+{nb_new}"
    )
    return True


def _check_donation(trainer, payload: dict, path: str) -> None:
    """``--check_donation``: no trainer tensor may share memory with the
    payload's arrays; then the payload is poisoned."""
    if not getattr(trainer.config, "check_donation", False):
        return
    arrays = _host_arrays(payload)
    assert_unaliased(arrays, _trainer_tensors(trainer), where=path)
    poison_host_arrays(arrays)
