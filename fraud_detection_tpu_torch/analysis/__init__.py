"""flightcheck for the port — the twin of ``fraud_detection_tpu.analysis``,
checking the port's own tree (``fraud_detection_tpu_torch/``) against the
port's own registries (``entrypoints.py``).

Rule families, all pure-AST (nothing under analysis is imported or
executed):

* concurrency lint (FC101/FC102/FC103): lock-order cycles — per class AND
  whole-program across objects (callgraph.py) — unguarded writes to
  thread-shared attributes, and drift between the thread map, the
  entry-point registry, and utils/racecheck.py's instrumentation list;
* delivery-protocol rules (FC401-FC404, protocol.py): the
  produce->flush->check->commit ordering the at-least-once guarantee
  hangs on, plus bare ``acquire()`` exception-safety package-wide;
* hot-path sync lint (FC203/FC204, synclint.py): per-row device syncs and
  literal batch dims that bypass the prewarmed padding ladder. The
  reference's FC201/FC202 police JAX tracing; the port traces nothing, so
  they have no counterpart;
* health-schema lint (FC301): health()/snapshot() key sets cross-checked
  against the ``*_SCHEMA`` dicts of the port's contract tests
  (``tests/test_torch_*.py``);
* distributed-protocol rules (FC501-FC503, model.py): the fleet and
  decode-slot choreographies declared as per-role state machines and
  AST-verified against the tree.

CLI: ``python -m fraud_detection_tpu_torch.analysis`` (exit 0 = clean
tree) with ``--json``, ``--sarif``, ``--fix [--dry-run]``, ``--no-cache``
and ``--verbose``; ``model`` runs the explicit-state model checker
(checker.py: safety, ``--liveness``, ``--mutate``, ``--autoscale``) and
``conform`` replays a recorded control-lane run (conformance.py).
Suppressions: ``# flightcheck: ignore[RULE] — reason`` on (or right
above) the flagged line.
"""

from fraud_detection_tpu_torch.analysis.core import (Finding,  # noqa: F401
                                                     RULES, run_analysis)
