"""The port's own metric instruments, beyond the JAX package's vocabulary
(``analysis/contract_registry.json``): the trainer adds them to the
contract sentinel under ``--check_contracts`` (:func:`extend_contracts`).
The port logs no record type of its own.
"""

from __future__ import annotations

# name -> kind; none takes labels.  Herding's feature pass
# (engine/loop.py ``_resident_features``): the CUDA graphs it captured and
# the batches it replayed on them.
METRICS = {
    "herd_graph_captures_total": "counter",
    "herd_graph_replays_total": "counter",
}


def extend_contracts(check) -> None:
    """Add :data:`METRICS` to an installed contract sentinel
    (``analysis/contractcheck.py`` ``ContractCheck``), in its registry's
    form."""
    for name, kind in METRICS.items():
        check.metrics.setdefault(name, {
            "dynamic_labels": False, "kinds": [kind], "label_sets": [[]]})
