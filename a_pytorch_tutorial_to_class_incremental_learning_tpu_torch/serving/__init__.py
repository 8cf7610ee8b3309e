"""Serving: per-task exported artifacts and a hot-swapping batched server.

Counterpart of the JAX package's ``serving/`` package, with its public
names.  The port keeps its own copies of the stdlib-only modules
(``health``, ``frontend``): importing the JAX package's ``serving`` would
load JAX.

* :mod:`.artifact` — after each task's weight alignment the trainer builds
  a fresh one-device model from the gathered full-width state,
  ``torch.export``-s its predict program per batch bucket and saves it
  beside a checksummed weights payload and a golden probe; a
  ``manifest.json`` names the newest task atomically.  A load on the card
  captures one CUDA graph a bucket; requests only replay.
* :mod:`.server` — a stdlib-threaded micro-batching server over those
  artifacts: pad-to-bucket dispatch with a max-wait deadline, and an atomic
  hot swap when a new task's artifact lands in the manifest.
* :mod:`.skew` — served accuracy re-measured through the artifact against
  the training row (``serve_skew``), and the golden-probe replay
  (``probe_artifact``) that gates swaps.
* :mod:`.replica` / :mod:`.frontend` / :mod:`.health` — the fleet: N
  supervised replica subprocesses behind a stdlib HTTP front end with
  admission control, priority shedding, circuit-breaker failover, hedged
  dispatch and probe-gated rolling swaps with per-replica rollback.
"""

from .artifact import (  # noqa: F401
    DEFAULT_BUCKETS,
    ServingArtifact,
    direct_predict,
    exact_cuda_numerics,
    export_artifact,
    export_from_trainer,
    latest_artifact,
    load_artifact,
    read_manifest,
    rebuild_model,
    register_artifact,
)
from .frontend import Frontend  # noqa: F401
from .health import FleetHealth  # noqa: F401
from .replica import (  # noqa: F401
    ReplicaServer,
    stop_supervised_replica,
    supervised_replica_cmd,
)
from .server import InferenceServer  # noqa: F401
from .skew import measure_skew, probe_artifact  # noqa: F401
