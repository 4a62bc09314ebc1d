"""Declarative alert rules: what "this is an incident" means, as data — twin of
``fraud_detection_tpu/obs/sentinel/rules.py``.

An :class:`AlertRule` names a condition over the periodic metric snapshots
the sentinel records (obs/sentinel/engine.py) — dotted paths into the same
nested ``health()``-shaped dicts the exporter flattens, so anything a
dashboard can read, a rule can alert on. Five rule kinds cover the failure
vocabulary the codebase actually models:

* ``static`` — the value at ``path`` compared against ``limit`` (the p99
  SLO burn, the dispatch-stall age, the spans_open leak). ``while_path``
  optionally gates the condition on another truthy value (stall only
  matters while ``running``).
* ``burn_rate`` — multi-window budget burn over two CUMULATIVE counters:
  the ratio of ``num``/``den`` deltas must exceed ``limit`` over BOTH the
  fast window (catches the spike) and the slow window (confirms it is not
  a blip) — the classic two-window burn-rate alert, with the windows read
  from the sentinel's snapshot ring instead of a TSDB. Counter resets
  (supervised engine restarts) are handled the way Prometheus ``rate()``
  does: a negative delta reads as "restarted from zero".
* ``ratio`` — instantaneous ratio of two cumulative counters (the
  explain-coverage gauge: explained-or-accounted over submitted).
  ``num``/``den`` accept ``+``-joined path lists, summed; honors
  ``while_path`` (fleet idleness only matters once traffic has flowed).
* ``delta`` — the change of a counter over the fast window compared
  against ``limit`` (breaker opens, fence/zombie commit events, worker
  count drops — a NEGATIVE limit with ``op="<="`` alerts on decrease);
  honors ``while_path`` (a membership drop only alerts while committed
  work remains). A decrease-watching delta judges the drop from the
  window's HIGH-WATER mark, not the far-edge sample: the window can
  reach back to a sample taken before the watched gauge finished
  forming (a sentinel primed mid-group-formation records membership 1),
  and a far-edge comparison would read a later real 2 → 1 death as 0.
  Growth inside the window must never mask a drop.
* ``absence`` / ``stale`` — the path is missing/None (a subsystem stopped
  reporting), or a counter has not moved across the fast window while
  ``while_path`` is truthy (progress stalled while work remains).

Every rule carries hysteresis: the condition must hold ``for_s`` seconds
(sentinel-clock seconds — virtual seconds under the scenario harness)
before the incident FIRES, and must stay clear ``resolve_s`` seconds
before it RESOLVES, so a flapping metric produces one incident, not a
storm. ``severity`` ("warning" | "critical") decides whether a firing
rule flips the ``/healthz`` readiness endpoint to 503.

Rules parse from JSON (serve ``--alert-rules FILE``) and
:func:`default_rule_pack` declares the first-party pack covering the
failure modes the tree models end to end (docs/observability.md
"Alerting and incidents" documents each rule's rationale).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

Number = Union[int, float]

KINDS = ("static", "burn_rate", "ratio", "delta", "absence", "stale")
SEVERITIES = ("warning", "critical")

_OPS = {
    "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    ">": lambda a, b: a > b,
}


def resolve_path(snapshot, path: str) -> Tuple[bool, object]:
    """Walk a dotted path into a nested snapshot dict; ``+``-joined paths
    sum their (numeric) leaves — missing/None terms read as the whole
    path missing, so a half-reported sum can never alert on garbage.
    Returns (found, value)."""
    if "+" in path:
        total = 0.0
        for part in path.split("+"):
            found, v = resolve_path(snapshot, part.strip())
            if not found or not isinstance(v, (int, float)) \
                    or isinstance(v, bool):
                return False, None
            total += v
        return True, total
    node = snapshot
    for part in path.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, (list, tuple)) and part.isdigit() \
                and int(part) < len(node):
            node = node[int(part)]
        else:
            return False, None
    return (node is not None), node


@dataclass(frozen=True)
class AlertRule:
    """One declared alert (see module docstring for the kind semantics)."""

    name: str
    kind: str = "static"
    path: str = ""              # static/delta/absence/stale value path
    num: str = ""               # burn_rate/ratio numerator ('+'-joined sums)
    den: str = ""               # burn_rate/ratio denominator
    op: str = ">"               # comparison for static/ratio/delta
    limit: Number = 0.0
    severity: str = "critical"
    for_s: float = 0.0          # condition must hold this long to FIRE
    resolve_s: float = 0.0      # must stay clear this long to RESOLVE
    fast_s: float = 30.0        # fast window (burn_rate/delta/stale)
    slow_s: float = 120.0       # slow confirm window (burn_rate)
    min_den: float = 1.0        # burn_rate/ratio: denominator floor below
                                # which the rule abstains (no traffic, no
                                # ratio — an idle stream must not alert)
    while_path: str = ""        # truthy gate (static/delta/stale)
    description: str = ""

    def __post_init__(self):
        if not self.name:
            raise ValueError("alert rule needs a name")
        if self.kind not in KINDS:
            raise ValueError(
                f"rule {self.name!r}: unknown kind {self.kind!r} "
                f"(one of {KINDS})")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"rule {self.name!r}: severity must be one of "
                f"{SEVERITIES}, got {self.severity!r}")
        if self.op not in _OPS:
            raise ValueError(
                f"rule {self.name!r}: op must be one of {sorted(_OPS)}, "
                f"got {self.op!r}")
        if self.kind in ("burn_rate", "ratio"):
            if not self.num or not self.den:
                raise ValueError(
                    f"rule {self.name!r}: kind {self.kind!r} needs "
                    f"num and den counter paths")
        elif not self.path:
            raise ValueError(
                f"rule {self.name!r}: kind {self.kind!r} needs a path")
        if self.kind == "burn_rate" and self.slow_s < self.fast_s:
            raise ValueError(
                f"rule {self.name!r}: slow_s ({self.slow_s}) must be >= "
                f"fast_s ({self.fast_s})")
        for field_name in ("for_s", "resolve_s"):
            if getattr(self, field_name) < 0:
                raise ValueError(
                    f"rule {self.name!r}: {field_name} must be >= 0")
        if self.fast_s <= 0 or self.slow_s <= 0:
            raise ValueError(
                f"rule {self.name!r}: windows must be > 0 "
                f"(fast_s={self.fast_s}, slow_s={self.slow_s})")

    # -- evaluation ------------------------------------------------------

    def condition(self, ring: Sequence[Tuple[float, dict]],
                  now: float) -> Tuple[bool, object]:
        """Evaluate against the sentinel's snapshot ring (oldest → newest,
        ``(stamp, snapshot)`` pairs; the newest entry is the CURRENT
        snapshot at ``now``). Returns (condition_true, observed_value) —
        the observed value lands in the incident record as evidence."""
        if not ring:
            return False, None
        _, cur = ring[-1]
        if self.kind == "static":
            if not self._while_ok(cur):
                return False, None
            found, v = resolve_path(cur, self.path)
            if not found or not isinstance(v, (int, float)):
                return False, None
            return _OPS[self.op](v, self.limit), v
        if self.kind == "ratio":
            if not self._while_ok(cur):
                return False, None
            found_n, n = resolve_path(cur, self.num)
            found_d, d = resolve_path(cur, self.den)
            if not found_n or not found_d or not isinstance(n, (int, float)) \
                    or not isinstance(d, (int, float)) or d < self.min_den:
                return False, None
            ratio = n / d
            return _OPS[self.op](ratio, self.limit), round(ratio, 6)
        if self.kind == "absence":
            found, _ = resolve_path(cur, self.path)
            return not found, None
        if self.kind == "delta":
            if not self._while_ok(cur):
                return False, None
            d = self._window_delta(ring, now, self.path, self.fast_s,
                                   reset_guard=self.op in (">", ">="),
                                   from_peak=self.op in ("<", "<="))
            if d is None:
                return False, None
            return _OPS[self.op](d, self.limit), d
        if self.kind == "stale":
            if not self._while_ok(cur):
                return False, None
            # Stale means the counter did not move over the WHOLE window —
            # only judged once the ring actually spans it (the short-
            # history fallback would otherwise declare staleness from two
            # snapshots milliseconds apart).
            oldest = self._at_or_before(ring, now - self.fast_s)
            if oldest is None or ring[-1][0] - oldest[0] < self.fast_s:
                return False, None
            d = self._window_delta(ring, now, self.path, self.fast_s,
                                   reset_guard=False)
            if d is None:
                return False, None
            return d == 0, d
        # burn_rate: both windows' delta ratios must exceed the limit.
        fast = self._window_ratio(ring, now, self.fast_s)
        slow = self._window_ratio(ring, now, self.slow_s)
        if fast is None or slow is None:
            return False, None
        fired = (_OPS[self.op](fast, self.limit)
                 and _OPS[self.op](slow, self.limit))
        return fired, {"fast": round(fast, 6), "slow": round(slow, 6)}

    def _while_ok(self, cur: dict) -> bool:
        if not self.while_path:
            return True
        found, v = resolve_path(cur, self.while_path)
        return bool(found and v)

    @staticmethod
    def _at_or_before(ring: Sequence[Tuple[float, dict]],
                      stamp: float) -> Optional[Tuple[float, dict]]:
        """Newest ring entry at or older than ``stamp`` — the window's far
        edge. None when the ring's history doesn't reach back that far AND
        has no genuinely-older entry (then the oldest entry stands in, so
        short runs still evaluate over the span they actually have)."""
        best = None
        for entry in ring:
            if entry[0] <= stamp:
                best = entry
            else:
                break
        if best is None and len(ring) > 1:
            best = ring[0]      # window exceeds history: whole span
        return best

    def _window_delta(self, ring, now: float, path: str,
                      window_s: float, *,
                      reset_guard: bool = True,
                      from_peak: bool = False) -> Optional[float]:
        old = self._at_or_before(ring, now - window_s)
        if old is None:
            return None
        found_old, v_old = resolve_path(old[1], path)
        found_cur, v_cur = resolve_path(ring[-1][1], path)
        if not found_cur or not isinstance(v_cur, (int, float)):
            return None
        if not found_old or not isinstance(v_old, (int, float)):
            v_old = 0.0         # the counter appeared mid-window
        if from_peak:
            # Decrease-watching gauge (module docstring): the drop is
            # judged from the window's high-water mark, so a far edge
            # that predates the gauge's formation (membership sampled
            # mid-group-settlement) cannot mask a real drop. The current
            # sample participates: if it IS the peak, the delta is 0.
            peak = float(v_old)
            for stamp, snap in ring:
                if stamp < old[0]:
                    continue
                found, v = resolve_path(snap, path)
                if found and isinstance(v, (int, float)) and float(v) > peak:
                    peak = float(v)
            v_old = peak
        d = float(v_cur) - float(v_old)
        # Counter reset (supervised restart): rate() semantics — the
        # counter restarted from zero, so the post-reset value IS the
        # delta. Applied only when the rule watches for INCREASES: a
        # decrease-watching delta (worker_absence's membership drop) is
        # watching a gauge, where a negative delta is the signal itself.
        return float(v_cur) if (reset_guard and d < 0) else d

    def _window_ratio(self, ring, now: float,
                      window_s: float) -> Optional[float]:
        dn = self._window_delta(ring, now, self.num, window_s)
        dd = self._window_delta(ring, now, self.den, window_s)
        if dn is None or dd is None or dd < self.min_den:
            return None
        return dn / dd

    def as_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind, "path": self.path,
                "num": self.num, "den": self.den, "op": self.op,
                "limit": self.limit, "severity": self.severity,
                "for_s": self.for_s, "resolve_s": self.resolve_s,
                "fast_s": self.fast_s, "slow_s": self.slow_s,
                "while_path": self.while_path,
                "description": self.description}


def parse_rules(obj) -> Tuple[AlertRule, ...]:
    """Rules from parsed JSON: a list of rule dicts, or ``{"rules": [...]}``.
    Unknown fields are rejected (a typo'd threshold must not silently
    become the default)."""
    if isinstance(obj, dict):
        obj = obj.get("rules")
    if not isinstance(obj, list):
        raise ValueError("alert rules must be a JSON list of rule objects "
                         "(or {'rules': [...]})")
    valid = {f for f in AlertRule.__dataclass_fields__}  # noqa: C416
    out: List[AlertRule] = []
    for i, item in enumerate(obj):
        if not isinstance(item, dict):
            raise ValueError(f"rule #{i} is not an object: {item!r}")
        unknown = set(item) - valid
        if unknown:
            raise ValueError(
                f"rule #{i} ({item.get('name', '?')!r}): unknown fields "
                f"{sorted(unknown)}")
        out.append(AlertRule(**item))
    names = [r.name for r in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate rule names: {names}")
    return tuple(out)


def load_rules(path: str) -> Tuple[AlertRule, ...]:
    """Parse an ``--alert-rules`` JSON file."""
    with open(path, "r", encoding="utf-8") as f:
        return parse_rules(json.load(f))


def default_rule_pack(*, fast_s: float = 30.0, slow_s: float = 120.0,
                      for_s: float = 0.0, resolve_s: float = 10.0,
                      shed_limit: float = 0.05, dlq_limit: float = 0.02,
                      p99_ms: float = 2000.0, stall_s: float = 10.0,
                      shadow_disagreement_limit: float = 0.05
                      ) -> Tuple[AlertRule, ...]:
    """The first-party pack over the engine's ``health()`` block — one rule
    per failure mode the codebase models end to end. Paths are
    engine-health-relative; windows/limits parameterize so game days can
    scale them to a scenario's duration (docs/observability.md documents
    each rule's rationale and tuning)."""
    return (
        # Admission control diverting real traffic: shed rows / processed
        # rows burning the availability budget over both windows.
        AlertRule("shed_burn", "burn_rate", num="shed", den="processed",
                  op=">", limit=shed_limit, severity="critical",
                  fast_s=fast_s, slow_s=slow_s, for_s=for_s,
                  resolve_s=resolve_s,
                  description="admission shed rate burning the "
                              "availability budget (docs/scheduling.md)"),
        # The explain breaker opened: the LLM lane is fast-failing.
        AlertRule("breaker_open", "delta", path="breaker.opens", op=">=",
                  limit=1, severity="warning", fast_s=fast_s,
                  slow_s=slow_s, resolve_s=resolve_s,
                  description="explain circuit breaker opened "
                              "(explain/circuit.py)"),
        # Explained-or-accounted coverage of flagged rows dropped below
        # ~1.0: flagged rows are vanishing without even a drop record.
        AlertRule("explain_coverage_drop", "ratio",
                  num="annotations.annotated+annotations.drop_records",
                  den="annotations.submitted", op="<", limit=0.5,
                  severity="critical", for_s=max(for_s, fast_s / 2),
                  resolve_s=resolve_s, min_den=8,
                  fast_s=fast_s, slow_s=slow_s,
                  description="flagged rows neither explained nor "
                              "drop-recorded (docs/explain_serving.md)"),
        # Per-row p99 over the SLO for a sustained window.
        AlertRule("p99_slo_burn", "static", path="row_latency_ms.p99",
                  op=">", limit=p99_ms, severity="warning",
                  for_s=max(for_s, fast_s / 2), resolve_s=resolve_s,
                  fast_s=fast_s, slow_s=slow_s,
                  description="per-row enqueue->produce p99 over the SLO"),
        # Dead-letter rate: malformed/poison rows burning the DLQ budget.
        AlertRule("dlq_rate", "burn_rate", num="dead_lettered",
                  den="processed", op=">", limit=dlq_limit,
                  severity="critical", fast_s=fast_s, slow_s=slow_s,
                  for_s=for_s, resolve_s=resolve_s,
                  description="dead-letter rate over budget "
                              "(docs/robustness.md)"),
        # The engine claims to run but hasn't delivered a batch: a stalled
        # dispatch lane, a wedged device, a dead consumer.
        AlertRule("dispatch_stall", "static", path="last_batch_age_sec",
                  op=">", limit=stall_s, severity="critical",
                  while_path="running", resolve_s=resolve_s,
                  fast_s=fast_s, slow_s=slow_s,
                  description="no delivered batch while running — "
                              "stalled dispatch lane or dead consumer"),
        # Span accounting leak: begun-but-never-ended spans accumulating
        # means some engine path stopped closing its traces.
        AlertRule("spans_leak", "static", path="trace.spans_open", op=">",
                  limit=0, severity="warning",
                  for_s=max(for_s, fast_s / 2), resolve_s=resolve_s,
                  fast_s=fast_s, slow_s=slow_s,
                  description="trace spans_open > 0 sustained "
                              "(obs/trace.py accounting leak)"),
        # Fence/zombie events: commits fenced by rebalances (routine in a
        # rebalancing group, an incident signal for a single static owner).
        AlertRule("fence_events", "delta", path="rebalanced_commits",
                  op=">=", limit=1, severity="warning", fast_s=fast_s,
                  slow_s=slow_s, resolve_s=resolve_s,
                  description="commits fenced by rebalance/zombie fencing "
                              "(docs/fleet.md)"),
        # Shadow disagreement burning: the staged candidate (or, with the
        # learn loop, a drift-corrected retrain) diverges from the primary
        # on RECENT traffic — a two-window burn over the shadow scorer's
        # cumulative disagreement/row counters, so model drift is an
        # INCIDENT even when the learn loop is disabled
        # (docs/online_learning.md; abstains without a shadow block).
        AlertRule("shadow_disagreement_burn", "burn_rate",
                  num="model.shadow.disagreed", den="model.shadow.rows",
                  op=">", limit=shadow_disagreement_limit,
                  severity="warning", fast_s=fast_s, slow_s=slow_s,
                  for_s=for_s, resolve_s=resolve_s, min_den=16,
                  description="shadow candidate disagreement burning over "
                              "recent windows — model drift "
                              "(docs/online_learning.md)"),
        # Restart churn: the supervisor rebuilt the engine twice inside
        # the window — a crash loop, not a one-off blip. Only judgeable
        # through a chain-cumulative source (ChainedHealthSource adds the
        # ``supervisor`` block); inert on a bare engine health.
        AlertRule("restart_churn", "delta", path="supervisor.restarts",
                  op=">=", limit=2, severity="critical", fast_s=fast_s,
                  slow_s=slow_s, resolve_s=resolve_s,
                  description="supervised engine rebuilt repeatedly "
                              "inside the window — crash loop"),
    )


def fleet_rule_pack(*, backlog_limit: float = 5000.0,
                    for_s: float = 0.0, resolve_s: float = 10.0,
                    fast_s: float = 30.0, slow_s: float = 120.0,
                    stale_s: Optional[float] = None,
                    idle_limit: float = 100.0,
                    idle_for_s: Optional[float] = None,
                    flap_limit: float = 3.0
                    ) -> Tuple[AlertRule, ...]:
    """Coordinator-level rules over the aggregated fleet view
    (``FleetCoordinator.tick``'s block under ``"fleet"``) plus the
    per-worker alert states riding the bus.

    ``stale_s`` (default ``fast_s``) is the staleness window for
    ``coordinator_absence`` alone. The two window kinds pull in opposite
    directions: a DELTA rule's window is how long a one-off event (a
    membership drop) stays observable, so wider is safer under sparse
    sampling — but a STALE rule only fires once the counter sat frozen
    for the WHOLE window, so it must stay shorter than the outage it
    exists to catch (an interregnum lasts ~``role_ttl`` plus one
    election; docs/fleet.md "Coordinator succession").

    ``idle_limit``/``idle_for_s`` tune ``fleet_idle`` (the autoscaler's
    scale-IN trigger, docs/autoscaling.md) and ``flap_limit`` tunes
    ``autoscale_flap`` (the control-arm no-flap gate); ``idle_for_s``
    defaults to ``fast_s`` — idleness is only an actionable signal once
    it has been sustained, or every inter-burst lull would shrink the
    fleet."""
    if stale_s is None:
        stale_s = fast_s
    if idle_for_s is None:
        idle_for_s = fast_s
    return (
        # The GLOBAL backlog watermark burning past the shed threshold's
        # neighborhood: the whole fleet is drowning, not one worker.
        AlertRule("fleet_watermark_burn", "static",
                  path="fleet.backlog_per_worker", op=">",
                  limit=backlog_limit, severity="critical", for_s=for_s,
                  resolve_s=resolve_s, fast_s=fast_s, slow_s=slow_s,
                  description="global backlog watermark over the fleet "
                              "shedding threshold (docs/fleet.md)"),
        # Membership dropped inside the window WHILE committed work
        # remains: a worker died or its lease expired mid-stream. The
        # ``while_path`` gate on the fleet's committed lag is what
        # separates a death from a clean drain exit — drain-mode workers
        # leave exactly when the lag clears, and that departure must not
        # read as an incident.
        AlertRule("worker_absence", "delta", path="fleet.n_workers",
                  op="<=", limit=-1, severity="critical",
                  while_path="fleet.committed_lag",
                  fast_s=fast_s, slow_s=slow_s, resolve_s=resolve_s,
                  description="fleet membership shrank while work "
                              "remained — worker death or lease expiry"),
        # Any member's own sentinel is firing: surface it fleet-wide.
        AlertRule("worker_alerts", "static", path="fleet.alerts_firing",
                  op=">=", limit=1, severity="warning",
                  resolve_s=resolve_s, fast_s=fast_s, slow_s=slow_s,
                  description="a worker-level sentinel is firing "
                              "(aggregated from the fleet bus)"),
        # The coordinator's tick counter stopped WHILE committed work
        # remains: the fleet's brain is dead (or partitioned off the
        # control lane) mid-stream. Gated exactly like worker_absence —
        # an interregnum after a clean drain is not an incident. During
        # a real interregnum the succession proxy keeps republishing the
        # dead incumbent's LAST view (fleet/control.py), so the frozen
        # ``fleet.coordinator.ticks`` is precisely the absence signal;
        # the coordinator_kill game day gates detects_within on this.
        AlertRule("coordinator_absence", "stale",
                  path="fleet.coordinator.ticks",
                  while_path="fleet.committed_lag",
                  severity="critical", fast_s=stale_s, slow_s=slow_s,
                  resolve_s=resolve_s,
                  description="coordinator ticks stalled while work "
                              "remained — coordinator death or control-"
                              "lane partition (docs/fleet.md)"),
        # Sustained LOW backlog per live member: spare capacity the
        # autoscaler can return (fleet/autoscale/ scale-in trigger).
        # Double-guarded against the empty-topic trap: ``min_den=1``
        # abstains when the view shows no members (an interregnum's 0/0
        # must not read as idle), and ``while_path`` on the fleet's
        # cumulative processed counter abstains until traffic has
        # actually flowed — a fleet that never saw a row is WAITING,
        # not idle, and must not shrink→flap on startup.
        AlertRule("fleet_idle", "ratio", num="fleet.global_backlog",
                  den="fleet.n_workers", op="<", limit=idle_limit,
                  severity="warning", min_den=1,
                  while_path="fleet.processed_total",
                  for_s=idle_for_s, resolve_s=resolve_s,
                  fast_s=fast_s, slow_s=slow_s,
                  description="sustained low backlog per worker after "
                              "traffic flowed — spare capacity "
                              "(docs/autoscaling.md)"),
        # The fleet resized ``flap_limit`` times inside the window: the
        # policy is oscillating (hysteresis/cooldown mistuned), not
        # tracking load. Sums the CUMULATIVE scale counters, so the rule
        # abstains entirely while the autoscale block is absent (a
        # static fleet can never flap).
        AlertRule("autoscale_flap", "delta",
                  path="fleet.autoscale.scale_outs"
                       "+fleet.autoscale.scale_ins"
                       "+fleet.autoscale.replacements",
                  op=">=", limit=flap_limit, severity="warning",
                  fast_s=slow_s, slow_s=slow_s, resolve_s=resolve_s,
                  description="repeated scale events inside the window — "
                              "autoscale oscillation "
                              "(docs/autoscaling.md)"),
        # The role changed hands twice inside the window: an election
        # storm (flapping incumbents, a term war), not a one-off
        # failover — one clean succession must NOT fire this.
        AlertRule("failover_churn", "delta",
                  path="fleet.coordinator.handoffs", op=">=", limit=2,
                  severity="warning", fast_s=fast_s, slow_s=slow_s,
                  resolve_s=resolve_s,
                  description="repeated coordinator handoffs inside the "
                              "window — election churn (docs/fleet.md)"),
    )
