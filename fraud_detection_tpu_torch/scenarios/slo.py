"""Game-day SLO gates: declarative pass/fail assertions over run evidence —
twin of ``fraud_detection_tpu/scenarios/slo.py`` (the same specs give the
same verdicts on the same evidence).

A scenario run (scenarios/gameday.py, serve ``--scenario``) collects one
**evidence** dict — broker key multisets, merged StreamStats, final
health/trace/breaker/sched blocks, fault reports — and the scenario's SLOs
are data evaluated against it, not asserts buried in a script. Two kinds:

* **Builtins** (``kind`` names a check with real logic):

  - ``zero_loss`` — every fed key appears among the accounted outputs
    (classified + DLQ'd) at least as often as it was fed. Multiset, not
    set: hot-key skew deliberately repeats keys.
  - ``zero_dup`` — no key appears MORE often than it was fed.
  - ``exact_accounting`` — both at once (the fleet's zero-loss/zero-dup
    contract); fails with the missing/duplicated counts in the detail.
  - ``spans_exact`` — every tracer finished with ``spans_open == 0`` and
    ``batches_traced == batches_closed`` (the tracer's accounting
    invariant, asserted from the evidence's trace blocks).
  - ``no_errors`` — no worker/feeder/action errors were recorded.

* **Metric gates** (``kind="metric"``): a dotted ``path`` into the
  evidence compared against ``limit`` with ``op`` — e.g.
  ``stats.p99_batch_latency_sec <= 5`` or ``breaker.opens >= 1``. A
  missing path FAILS (evidence that silently vanished must not read as a
  pass); paths that are only meaningful in one runner mode carry
  ``scope`` so the serve CLI's single-engine evaluation skips
  fleet-only gates instead of failing them.

``evaluate`` returns an :class:`SloReport`: machine-readable
(``as_dict``), human-readable (``table`` — the game-day verdict table),
and one ``ok`` bit that becomes the process exit code.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple, Union

Number = Union[int, float]

_OPS = {
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
}

BUILTIN_KINDS = ("zero_loss", "zero_dup", "exact_accounting",
                 "spans_exact", "no_errors")

#: Parameterized kinds beyond the bare builtins: ``detects_within`` judges
#: the sentinel's detection latency — ``path`` names the alert rule,
#: ``limit`` the allowed sentinel-clock seconds between the fault's
#: injection time (``evidence["fault_times"][rule]``) and the rule's first
#: FIRING incident.
PARAM_KINDS = ("detects_within",)


@dataclass(frozen=True)
class SloSpec:
    """One declared gate. For builtins, ``kind`` is the check and
    path/op/limit are ignored; for ``kind="metric"``, ``path`` walks the
    evidence dict. ``scope`` limits where the gate is evaluable:
    ``"any"`` everywhere, ``"gameday"`` only under the full game-day
    runner (serve --scenario marks these skipped instead of failed)."""

    name: str
    kind: str = "metric"
    path: str = ""
    op: str = "<="
    limit: Union[Number, str, bool, None] = 0
    scope: str = "any"

    def __post_init__(self):
        if self.kind not in BUILTIN_KINDS and self.kind not in PARAM_KINDS \
                and self.kind != "metric":
            raise ValueError(
                f"unknown SLO kind {self.kind!r} (builtins: "
                f"{BUILTIN_KINDS}, parameterized: {PARAM_KINDS})")
        if self.kind == "detects_within":
            if not self.path:
                raise ValueError(
                    f"detects_within SLO {self.name!r} needs the alert "
                    f"rule name in 'path'")
            if not isinstance(self.limit, (int, float)) \
                    or isinstance(self.limit, bool) or self.limit <= 0:
                raise ValueError(
                    f"detects_within SLO {self.name!r} needs a positive "
                    f"numeric limit (seconds), got {self.limit!r}")
        if self.kind == "metric":
            if not self.path:
                raise ValueError(f"metric SLO {self.name!r} needs a path")
            if self.op not in _OPS:
                raise ValueError(
                    f"SLO {self.name!r}: op must be one of "
                    f"{sorted(_OPS)}, got {self.op!r}")
        if self.scope not in ("any", "gameday"):
            raise ValueError(
                f"SLO {self.name!r}: scope must be 'any' or 'gameday', "
                f"got {self.scope!r}")


def parse_slo(expr: str, *, scope: str = "any") -> SloSpec:
    """Parse a CLI override like ``stats.p99_batch_latency_sec<=0.5`` or a
    bare builtin name like ``exact_accounting``."""
    text = expr.strip()
    if text in BUILTIN_KINDS:
        return SloSpec(text, kind=text, scope=scope)
    for op in ("<=", ">=", "==", "!=", "<", ">"):   # two-char ops first
        if op in text:
            path, raw = text.split(op, 1)
            raw = raw.strip()
            value: Union[Number, str, bool, None]
            if raw.lower() in ("true", "false"):
                value = raw.lower() == "true"
            elif raw.lower() in ("none", "null"):
                value = None
            else:
                try:
                    value = int(raw)
                except ValueError:
                    try:
                        value = float(raw)
                    except ValueError:
                        value = raw
            return SloSpec(text, path=path.strip(), op=op, limit=value,
                           scope=scope)
    raise ValueError(
        f"cannot parse SLO {expr!r}: expected a builtin name "
        f"({', '.join(BUILTIN_KINDS)}) or '<path><op><value>'")


@dataclass(frozen=True)
class SloVerdict:
    name: str
    ok: bool
    observed: object
    expected: str
    detail: str = ""
    skipped: bool = False

    def as_dict(self) -> dict:
        return {"name": self.name, "ok": self.ok,
                "observed": self.observed, "expected": self.expected,
                "detail": self.detail, "skipped": self.skipped}


@dataclass
class SloReport:
    verdicts: List[SloVerdict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(v.ok or v.skipped for v in self.verdicts)

    @property
    def failed(self) -> List[SloVerdict]:
        return [v for v in self.verdicts if not v.ok and not v.skipped]

    def as_dict(self) -> dict:
        return {"ok": self.ok,
                "verdicts": [v.as_dict() for v in self.verdicts]}

    def table(self) -> str:
        """The verdict table, one row per gate."""
        rows = [("SLO", "observed", "expected", "verdict")]
        for v in self.verdicts:
            verdict = ("SKIP" if v.skipped else "PASS" if v.ok else "FAIL")
            rows.append((v.name, str(v.observed), v.expected, verdict))
        widths = [max(len(r[i]) for r in rows) for i in range(4)]
        lines = []
        for i, r in enumerate(rows):
            lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
            if i == 0:
                lines.append("  ".join("-" * w for w in widths))
        for v in self.verdicts:
            if not v.ok and not v.skipped and v.detail:
                lines.append(f"  !! {v.name}: {v.detail}")
        return "\n".join(lines)


def _resolve(evidence: dict, path: str):
    """Walk a dotted path; returns (found, value)."""
    node = evidence
    for part in path.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, (list, tuple)) and part.isdigit() \
                and int(part) < len(node):
            node = node[int(part)]
        else:
            return False, None
    return True, node


def _accounting(evidence: dict) -> Tuple[Counter, Counter]:
    fed = Counter(evidence.get("fed_keys") or [])
    accounted = Counter(evidence.get("out_keys") or [])
    accounted.update(evidence.get("dlq_keys") or [])
    return fed, accounted


def _check_builtin(spec: SloSpec, evidence: dict) -> SloVerdict:
    if spec.kind in ("zero_loss", "zero_dup", "exact_accounting"):
        fed, accounted = _accounting(evidence)
        missing = sum((fed - accounted).values())
        dups = sum((accounted - fed).values())
        if spec.kind == "zero_loss":
            ok, observed = missing == 0, missing
            expected = "0 lost rows"
        elif spec.kind == "zero_dup":
            ok, observed = dups == 0, dups
            expected = "0 duplicated rows"
        else:
            ok = missing == 0 and dups == 0
            observed = f"lost={missing} dup={dups}"
            expected = "lost=0 dup=0"
        sample = list((fed - accounted).keys())[:5]
        detail = (f"fed={sum(fed.values())} accounted="
                  f"{sum(accounted.values())}"
                  + (f" first_missing={sample}" if sample else ""))
        return SloVerdict(spec.name, ok, observed, expected, detail)
    if spec.kind == "spans_exact":
        traces = evidence.get("traces") or []
        if not traces:
            # A run that DECLARED tracing off (serve --scenario without
            # --trace) skips the gate honestly; a game-day run, which
            # always traces, fails it — absent evidence must not pass.
            return SloVerdict(spec.name, False, "<no trace blocks>",
                              "spans_open==0 for every tracer",
                              "tracing was not enabled for this run",
                              skipped=evidence.get("tracing") is False)
        bad = [t for t in traces
               if t.get("spans_open") != 0
               or t.get("batches_traced") != t.get("batches_closed")]
        observed = (f"{len(traces)} tracers, "
                    f"open={[t.get('spans_open') for t in bad] or 0}")
        return SloVerdict(spec.name, not bad, observed,
                          "spans_open==0, traced==closed",
                          f"bad tracers: {[t.get('worker') for t in bad]}"
                          if bad else "")
    if spec.kind == "detects_within":
        # The sentinel gate: the named alert rule
        # must have FIRED, and its first firing must land within ``limit``
        # sentinel-clock seconds of the fault's injection time. Missing
        # alerts evidence FAILS — a game day that declared a sentinel but
        # produced no alert block lost its watchdog, which is itself the
        # incident.
        rule = spec.path
        alerts = evidence.get("alerts")
        expected = f"alert {rule!r} fires within {spec.limit}s of the fault"
        if not isinstance(alerts, dict):
            return SloVerdict(spec.name, False, "<no alerts evidence>",
                              expected, "the run produced no sentinel "
                              "snapshot — was the sentinel wired?")
        incidents = [i for i in alerts.get("incidents") or []
                     if i.get("rule") == rule
                     and isinstance(i.get("fired_at"), (int, float))]
        fault_at = (evidence.get("fault_times") or {}).get(rule, 0.0)
        if not incidents:
            return SloVerdict(spec.name, False, "<never fired>", expected,
                              f"sentinel evaluated "
                              f"{alerts.get('evaluations')}x, firing="
                              f"{alerts.get('firing')}")
        fired_at = min(i["fired_at"] for i in incidents)
        latency = fired_at - fault_at
        return SloVerdict(spec.name, latency <= spec.limit,
                          round(latency, 3), expected,
                          f"fault_at={fault_at} fired_at={fired_at}")
    if spec.kind == "no_errors":
        errors = list(evidence.get("errors") or [])
        feeder = evidence.get("feeder") or {}
        errors += [f"action:{n}:{e}"
                   for n, e in feeder.get("action_errors") or []]
        return SloVerdict(spec.name, not errors, len(errors),
                          "0 worker/feeder/action errors",
                          "; ".join(str(e) for e in errors[:3]))
    raise AssertionError(spec.kind)   # unreachable: __post_init__ validated


def evaluate(slos: Sequence[SloSpec], evidence: dict, *,
             scope: str = "gameday") -> SloReport:
    """Evaluate every spec against the evidence. ``scope`` is the
    RUNNER's capability: gates scoped beyond it are reported skipped."""
    report = SloReport()
    for spec in slos:
        if spec.scope == "gameday" and scope != "gameday":
            report.verdicts.append(SloVerdict(
                spec.name, True, "<not evaluated>",
                f"scope={spec.scope}", "only evaluated by the game-day "
                "runner", skipped=True))
            continue
        if spec.kind != "metric":
            report.verdicts.append(_check_builtin(spec, evidence))
            continue
        found, value = _resolve(evidence, spec.path)
        expected = f"{spec.path} {spec.op} {spec.limit}"
        if not found:
            report.verdicts.append(SloVerdict(
                spec.name, False, "<missing>", expected,
                f"evidence has no {spec.path!r}"))
            continue
        try:
            ok = _OPS[spec.op](value, spec.limit)
        except TypeError:
            report.verdicts.append(SloVerdict(
                spec.name, False, repr(value), expected,
                f"cannot compare {type(value).__name__} with "
                f"{type(spec.limit).__name__}"))
            continue
        report.verdicts.append(SloVerdict(spec.name, bool(ok), value,
                                          expected))
    return report
