"""FC301 — health()/snapshot() key sets vs the contract-test schemas; twin
of ``fraud_detection_tpu/analysis/health.py``.

Every observability surface in the port pins its exact JSON key set in a
contract test (``*_SCHEMA`` dicts in the port's own ``tests/test_torch_*.py``
files, one per reference contract) so ``--health-file`` pollers
and dashboards can't silently break. Those tests only fire when they RUN;
this rule makes the same check a lint: it statically extracts the dict keys
each producer method returns and cross-checks them against the schema dict
literals in the test files, so schema drift fails ``flightcheck`` before it
fails a soak.

Extraction handles the shapes the tree actually uses: a returned dict
literal, a dict literal assigned to a local that later gains
``var["key"] = ...`` entries, and a base-method call (``SloTracker.snapshot``
starts from ``LatencySketch.snapshot()``'s dict — the mapping entry names
the base so its keys are unioned in). A method with several ``return {...}``
statements must return the SAME key set from each (the empty-vs-populated
sketch split) or that is itself a finding.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from fraud_detection_tpu_torch.analysis.core import Finding, SourceFile


@dataclass(frozen=True)
class Contract:
    """One producer-method <-> schema-test pairing."""

    module: str          # package-relative posix path of the producer
    qualname: str        # Class.method producing the dict
    test_file: str       # file name inside tests/
    schema_var: str      # *_SCHEMA dict literal in that test file
    # Keys the schema pins but a DIFFERENT layer injects (e.g. the engine
    # merges "shadow" into the hotswap lifecycle block).
    injected: FrozenSet[str] = frozenset()
    # Base method (same module) whose keys seed the dict before local
    # ``var["k"] = ...`` additions.
    base: Optional[str] = None


CONTRACTS: Tuple[Contract, ...] = (
    Contract("stream/engine.py", "StreamingClassifier.health",
             "test_torch_lifecycle.py", "ENGINE_HEALTH_SCHEMA"),
    Contract("stream/engine.py", "StreamingClassifier._device_block",
             "test_torch_lifecycle.py", "DEVICE_BLOCK_SCHEMA"),
    Contract("registry/hotswap.py", "HotSwapPipeline.lifecycle_snapshot",
             "test_torch_lifecycle.py", "MODEL_BLOCK_SCHEMA",
             injected=frozenset({"shadow"})),
    Contract("registry/shadow.py", "ShadowScorer.snapshot",
             "test_torch_lifecycle.py", "SHADOW_BLOCK_SCHEMA"),
    Contract("sched/scheduler.py", "AdaptiveScheduler.snapshot",
             "test_torch_sched.py", "SCHED_BLOCK_SCHEMA"),
    Contract("sched/sketch.py", "SloTracker.snapshot",
             "test_torch_sched.py", "SLO_BLOCK_SCHEMA",
             base="LatencySketch.snapshot"),
    Contract("sched/admission.py", "AdmissionController.snapshot",
             "test_torch_sched.py", "ADMISSION_BLOCK_SCHEMA"),
    Contract("sched/governor.py", "BackpressureGovernor.snapshot",
             "test_torch_sched.py", "GOVERNOR_BLOCK_SCHEMA"),
    Contract("stream/annotations.py", "AsyncAnnotationLane.stats",
             "test_torch_chaos.py", "ANNOTATION_STATS_SCHEMA"),
    # Row-tracing health block (docs/observability.md): the engine's
    # "trace" sub-object and the metrics exporter both serve it.
    Contract("obs/trace.py", "RowTracer.snapshot",
             "test_torch_obs.py", "TRACE_BLOCK_SCHEMA"),
    # Slotserve lane (docs/explain_serving.md): the engine's "explain"
    # sub-object — slots busy/free, admission accounting, expl/s, p50/p99.
    Contract("explain/slotserve/service.py", "SlotServeService.snapshot",
             "test_torch_slotserve.py", "SLOTSERVE_BLOCK_SCHEMA"),
    # Sentinel alerting (docs/observability.md): the engine's "alerts"
    # sub-object — rule states, firing lists, incident accounting.
    Contract("obs/sentinel/engine.py", "Sentinel.snapshot",
             "test_torch_sentinel.py", "ALERTS_BLOCK_SCHEMA"),
    # Closed learning loop (docs/online_learning.md): the engine's
    # "learn" sub-object — window/join accounting, retrain triggers,
    # published/promoted candidates.
    Contract("learn/loop.py", "LearnLoop.snapshot",
             "test_torch_learn.py", "LEARN_BLOCK_SCHEMA"),
    Contract("learn/store.py", "WindowStore.snapshot",
             "test_torch_learn.py", "LEARN_WINDOW_SCHEMA"),
    # Coordinator succession (docs/fleet.md "Coordinator succession"):
    # the fleet view's "coordinator" sub-object — term/leader/handoff
    # identity, the tick pulse the coordinator_absence rule watches, and
    # the control-lane delivery accounting.
    Contract("fleet/coordinator.py", "FleetCoordinator._coordinator_block",
             "test_torch_succession.py", "COORDINATOR_BLOCK_SCHEMA"),
    # Closed-loop autoscaling (docs/autoscaling.md): the fleet view's
    # "autoscale" sub-object — desired/live capacity, decision counters,
    # and the policy bounds/cooldown the ScalePolicy layer injects.
    Contract("fleet/autoscale/controller.py", "Autoscaler.stats",
             "test_torch_autoscale.py", "AUTOSCALE_BLOCK_SCHEMA",
             injected=frozenset({"min", "max", "denied",
                                 "cooldown_remaining_s"})),
)


# ---------------------------------------------------------------------------
# producer-side key extraction
# ---------------------------------------------------------------------------

def _find_method(tree: ast.Module, qualname: str) -> Optional[ast.AST]:
    clsname, _, method = qualname.partition(".")
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == clsname:
            if not method:
                return node
            for fn in node.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and fn.name == method:
                    return fn
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == qualname:
            return node
    return None


def _dict_literal_keys(node: ast.Dict) -> Optional[Set[str]]:
    keys: Set[str] = set()
    for k in node.keys:
        if k is None:
            return None                    # **splat: not statically known
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
            return None
        keys.add(k.value)
    return keys


def extract_keys(fn: ast.AST, *, base_keys: Optional[Set[str]] = None
                 ) -> Tuple[Optional[Set[str]], Optional[str]]:
    """(keys, error): the statically-derived key set of the dict ``fn``
    returns, or an error string when the shape defeats extraction."""
    # Locals assigned a dict literal (or a call seeded by base_keys), plus
    # later var["k"] = ... additions, in order.
    local_keys: Dict[str, Optional[Set[str]]] = {}
    returned: List[Set[str]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                if isinstance(node.value, ast.Dict):
                    local_keys[t.id] = _dict_literal_keys(node.value)
                elif isinstance(node.value, ast.Call) and base_keys is not None:
                    local_keys[t.id] = set(base_keys)
            elif (isinstance(t, ast.Subscript)
                  and isinstance(t.value, ast.Name)
                  and t.value.id in local_keys
                  and isinstance(t.slice, ast.Constant)
                  and isinstance(t.slice.value, str)):
                keys = local_keys[t.value.id]
                if keys is not None:
                    keys.add(t.slice.value)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        v = node.value
        if isinstance(v, ast.Dict):
            keys = _dict_literal_keys(v)
            if keys is None:
                return None, f"return dict at line {node.lineno} has " \
                             f"non-literal keys"
            returned.append(keys)
        elif isinstance(v, ast.Name) and v.id in local_keys:
            keys = local_keys[v.id]
            if keys is None:
                return None, f"dict {v.id!r} has non-literal keys"
            returned.append(set(keys))
    if not returned:
        return None, "no statically-extractable return dict"
    first = returned[0]
    for other in returned[1:]:
        if other != first:
            return None, (f"multiple returns with DIFFERENT key sets "
                          f"(e.g. {sorted(first ^ other)}) — pollers see "
                          f"an inconsistent schema")
    return first, None


# ---------------------------------------------------------------------------
# schema-side extraction
# ---------------------------------------------------------------------------

def schema_keys(tests_dir: str, test_file: str,
                schema_var: str) -> Optional[Set[str]]:
    path = os.path.join(tests_dir, test_file)
    try:
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError):
        return None
    for node in tree.body:
        if isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if schema_var in names and isinstance(node.value, ast.Dict):
                return _dict_literal_keys(node.value)
    return None


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

def analyze(files: Sequence[SourceFile], *, tests_dir: Optional[str],
            contracts: Optional[Tuple[Contract, ...]] = None
            ) -> List[Finding]:
    contracts = CONTRACTS if contracts is None else contracts
    if tests_dir is None:
        return [Finding(
            "FC301", "tests", 1,
            "contract tests directory not found next to the package — "
            "health-schema lint needs the tests/ tree (pass --tests)")]
    by_rel = {f.relpath: f for f in files}
    findings: List[Finding] = []
    for c in contracts:
        sf = by_rel.get(c.module)
        if sf is None:
            findings.append(Finding(
                "FC301", c.module, 1,
                f"contract names missing module (wanted {c.qualname})"))
            continue
        fn = _find_method(sf.tree, c.qualname)
        if fn is None:
            findings.append(Finding(
                "FC301", c.module, 1,
                f"{c.qualname} no longer exists but its schema contract "
                f"({c.test_file}:{c.schema_var}) does — update "
                f"analysis/health.py CONTRACTS"))
            continue
        base_keys: Optional[Set[str]] = None
        if c.base is not None:
            base_fn = _find_method(sf.tree, c.base)
            if base_fn is not None:
                base_keys, _ = extract_keys(base_fn)
        produced, err = extract_keys(fn, base_keys=base_keys)
        line = getattr(fn, "lineno", 1)
        if produced is None:
            findings.append(Finding(
                "FC301", c.module, line,
                f"{c.qualname}: {err}"))
            continue
        pinned = schema_keys(tests_dir, c.test_file, c.schema_var)
        if pinned is None:
            findings.append(Finding(
                "FC301", c.module, line,
                f"{c.qualname}: schema {c.schema_var} not found as a dict "
                f"literal in tests/{c.test_file} — the contract test is "
                f"gone or moved"))
            continue
        expected = produced | c.injected
        if expected != pinned:
            extra = sorted(expected - pinned)
            missing = sorted(pinned - expected)
            findings.append(Finding(
                "FC301", c.module, line,
                f"{c.qualname} keys drifted from tests/{c.test_file}:"
                f"{c.schema_var} (produced-not-pinned: {extra}, "
                f"pinned-not-produced: {missing}) — update BOTH the schema "
                f"test and the docs/pollers"))
    return findings
