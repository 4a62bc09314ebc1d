"""Seeded traffic generation: realistic load shapes as reproducible data —
twin of ``fraud_detection_tpu/scenarios/traffic.py``; the same seed gives
the reference's timeline event for event.

The chaos layer (stream/faults.py) injects *faults* into whatever flat load
a test happens to produce; nothing in the tree injected realistic *traffic*
— diurnal tides, flash crowds, hot-key skew, correlated fraud campaigns —
so the admission controller, the explain breaker, and the fleet's shedding
watermark were only ever judged against uniform paced batches. This module
makes traffic a first-class seeded input:

* A **spec** (:class:`SteadyLoad`, :class:`DiurnalLoad`, :class:`FlashCrowd`,
  :class:`CampaignWave`) is pure data: a rate curve over a window plus the
  mix knobs (``scam_fraction``, hot-key skew). Specs compose — a scenario
  is a list of overlapping specs (baseline diurnal + a campaign wave on
  top).
* :func:`generate` expands a spec into a flat list of
  :class:`TrafficEvent` rows — **bit-reproducible**: the same spec + seed
  yields byte-identical payloads, keys, and virtual timestamps, across
  processes (seeds derive via sha256, payload JSON is key-ordered, and the
  rate curve integrates through a deterministic accumulator, so no float
  re-association changes a row count).
* :class:`TrafficFeeder` walks the merged timeline on ONE daemon thread,
  appending rows to the broker at their (scaled) virtual times and firing
  interleaved :class:`TimelineAction` callbacks (hot swaps, fault arming,
  drain-stop) at theirs — so traffic, faults, and operator actions compose
  on a single deterministic timeline (scenarios/clock.py owns the pacing
  and the per-component seed streams).

Texts come from the synthetic corpus families (data/synthetic.py) with
``hard_fraction=0``: campaign rows are *meant* to look flagged — the point
of a fraud-campaign wave is to stress every flagged-row lane (explain
breaker, annotation queue, shadow gates) at once.

Key skew: ``hot_fraction`` of rows reuse one of ``hot_keys`` literal keys.
The broker partitions by ``hash(key)``, so repeated hot keys concentrate on
few partitions — real regional/entity skew. Accounting across skewed keys
is MULTISET accounting (each input row classified exactly once), which the
SLO layer (scenarios/slo.py) implements; rows stay individually
identifiable via the ``id`` field in the payload.
"""

from __future__ import annotations

import json
import math
import threading
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

from fraud_detection_tpu_torch.scenarios.clock import ScenarioClock, derive_seed

# Rate-curve integration step (virtual seconds). Small enough that a 2 s
# flash-crowd ramp gets ~40 distinct rate samples; rows inside a tick
# spread evenly so arrival times stay smooth at any rate.
TICK_S = 0.05


class TrafficEvent(NamedTuple):
    """One generated input row: virtual arrival time + the exact bytes."""

    t: float            # virtual seconds from scenario start
    value: bytes        # JSON payload ({"text": ..., "id": ..., ...})
    key: bytes          # broker partition key (skewed keys repeat)
    kind: str           # "legit" | "scam" (ground-truth-ish family)


@dataclass(frozen=True)
class TrafficSpec:
    """Base spec: a rate curve over ``[at_s, at_s + duration_s)``.

    ``scam_fraction`` draws each row's text family; ``hot_fraction`` routes
    that fraction of rows to one of ``hot_keys`` repeated literal keys
    (partition skew); everything else gets a unique ``<name>-<seq>`` key.
    Subclasses implement :meth:`rate_at` (rows/sec at relative time)."""

    name: str = "traffic"
    at_s: float = 0.0
    duration_s: float = 1.0
    scam_fraction: float = 0.3
    hot_fraction: float = 0.0
    hot_keys: int = 4
    # Ground-truth oracle field: when set, each
    # payload carries ``"truth": 0|1`` — what the scenario label feeder
    # (scenarios/labels.py) turns into delayed feedback records. OFF by
    # default so every existing spec's payload bytes are unchanged.
    emit_truth: bool = False

    def __post_init__(self):
        if self.duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {self.duration_s}")
        if not 0.0 <= self.scam_fraction <= 1.0:
            raise ValueError(
                f"scam_fraction must be in [0, 1], got {self.scam_fraction}")
        if not 0.0 <= self.hot_fraction <= 1.0:
            raise ValueError(
                f"hot_fraction must be in [0, 1], got {self.hot_fraction}")
        if self.hot_keys < 1:
            raise ValueError(f"hot_keys must be >= 1, got {self.hot_keys}")

    def rate_at(self, rel_t: float) -> float:  # pragma: no cover - abstract
        raise NotImplementedError


@dataclass(frozen=True)
class SteadyLoad(TrafficSpec):
    """Flat offered load — the control arm every shaped curve compares to."""

    rate: float = 100.0

    def rate_at(self, rel_t: float) -> float:
        return self.rate


@dataclass(frozen=True)
class DiurnalLoad(TrafficSpec):
    """Day/night tide: a raised cosine between ``base_rate`` (trough) and
    ``peak_rate`` (crest) with period ``period_s`` — the million-user
    baseline shape (autoscaling is judged against the slope, not the
    mean)."""

    base_rate: float = 50.0
    peak_rate: float = 200.0
    period_s: float = 8.0

    def rate_at(self, rel_t: float) -> float:
        phase = (1.0 - math.cos(2.0 * math.pi * rel_t / self.period_s)) / 2.0
        return self.base_rate + (self.peak_rate - self.base_rate) * phase


@dataclass(frozen=True)
class FlashCrowd(TrafficSpec):
    """Base load that ramps to ``peak_rate`` over ``ramp_s``, holds for
    ``hold_s``, and decays back over ``decay_s`` — the admission
    controller's nemesis shape (the watermark + AIMD shed must bite on the
    ramp and RELEASE after the decay)."""

    base_rate: float = 50.0
    peak_rate: float = 2000.0
    ramp_at_s: float = 0.5
    ramp_s: float = 0.5
    hold_s: float = 1.0
    decay_s: float = 0.5

    def rate_at(self, rel_t: float) -> float:
        t = rel_t - self.ramp_at_s
        if t < 0:
            return self.base_rate
        if t < self.ramp_s:
            return self.base_rate + (self.peak_rate - self.base_rate) * (
                t / self.ramp_s)
        t -= self.ramp_s
        if t < self.hold_s:
            return self.peak_rate
        t -= self.hold_s
        if t < self.decay_s:
            return self.peak_rate + (self.base_rate - self.peak_rate) * (
                t / self.decay_s)
        return self.base_rate


@dataclass(frozen=True)
class CampaignWave(TrafficSpec):
    """Correlated fraud-campaign bursts: ``waves`` bursts of
    ``wave_rate`` rows/sec lasting ``wave_s`` each, ``gap_s`` apart,
    nearly all scam-shaped and key-skewed by default (one campaign hits
    from few origins) — the shape that stresses every flagged-row lane
    (explain breaker, annotation queue, shadow gates) at once. Overlay it
    on a baseline spec; between waves it contributes zero rows."""

    wave_rate: float = 800.0
    waves: int = 2
    wave_s: float = 0.6
    gap_s: float = 1.0
    scam_fraction: float = 0.95
    hot_fraction: float = 0.8
    hot_keys: int = 3

    def rate_at(self, rel_t: float) -> float:
        stride = self.wave_s + self.gap_s
        if rel_t >= self.waves * stride:
            return 0.0
        return self.wave_rate if (rel_t % stride) < self.wave_s else 0.0


@dataclass(frozen=True)
class DriftCampaign(TrafficSpec):
    """A NOVEL-vocabulary fraud campaign: burst shape like
    :class:`CampaignWave`, but scam rows draw from a drifted text family
    (:func:`drift_scam_pool` — crypto-wallet/airdrop templates sharing no
    scam marker with the classic phone-scam corpus the serving model
    trained on). The live model scores these benign; only the delayed
    ground-truth labels reveal them — exactly the campaign-drift shape the
    closed learning loop (learn/) exists to
    catch. ``emit_truth`` defaults ON: a drift scenario without its label
    oracle is undetectable by construction."""

    wave_rate: float = 400.0
    waves: int = 2
    wave_s: float = 0.8
    gap_s: float = 0.6
    scam_fraction: float = 0.9
    hot_fraction: float = 0.5
    hot_keys: int = 3
    emit_truth: bool = True

    def rate_at(self, rel_t: float) -> float:
        stride = self.wave_s + self.gap_s
        if rel_t >= self.waves * stride:
            return 0.0
        return self.wave_rate if (rel_t % stride) < self.wave_s else 0.0


# Drifted scam asks: a ROUTINE legitimate call transcript (the classic
# corpus's own legit family) with a crypto-wallet ask spliced mid-call —
# the appointment-pivot shape, drifted to a vocabulary ("wallet", "seed
# phrase", "airdrop", "staking", ...) that occurs in NEITHER classic
# family (data/synthetic.py). A model trained on the classic corpus reads
# the legit register and scores these benign; only the delayed
# ground-truth labels reveal the campaign. The loud classic markers
# (urgent/suspended/gift cards/fees/verify) are deliberately absent.
_DRIFT_ASKS = [
    "Agent: While I have you, the airdrop is ready for pickup — please "
    "connect your wallet and spell out the seed phrase so I can finish "
    "the setup.\nCustomer: Okay, let me open the wallet app now.",
    "Agent: One more thing, your staking rewards are scheduled — just "
    "share the recovery words and we will move them over for you.\n"
    "Customer: Sure, the twelve words are written on my card.",
    "Agent: Also, the nft drop closes tonight — simply approve the "
    "smart contract and tell me the passphrase while we are on the "
    "line.\nCustomer: Alright, reading the passphrase now.",
    "Agent: By the way, we migrated the exchange this week — kindly "
    "sync your hardware wallet and share the recovery words with me.\n"
    "Customer: Okay, syncing the hardware wallet now.",
    "Agent: And the validator rebate is waiting — please open the "
    "wallet app and tell me the twelve seed words so I can finish it "
    "for you.\nCustomer: One moment, opening the app.",
]


def drift_scam_pool(seed: int, n: int = 64) -> List[str]:
    """Seeded drifted-scam texts (deterministic: same seed, same pool):
    legit-family transcripts with one crypto ask spliced mid-call."""
    import random as _random

    from fraud_detection_tpu_torch.data import generate_corpus

    rng = _random.Random(derive_seed(seed, "drift-pool"))
    corpus = generate_corpus(n=2 * n + 32,
                             seed=derive_seed(seed, "drift-base"),
                             hard_fraction=0.0, label_noise=0.0)
    legit = [d.text for d in corpus if d.label == 0]
    out = []
    for i in range(n):
        base = legit[rng.randrange(len(legit))]
        lines = base.split("\n")
        mid = max(1, len(lines) // 2)
        ask = _DRIFT_ASKS[rng.randrange(len(_DRIFT_ASKS))]
        out.append("\n".join(lines[:mid] + [ask] + lines[mid:]))
    return out


def _text_pools(seed: int) -> Tuple[List[str], List[str]]:
    """(legit, scam) text pools from the synthetic corpus families —
    separable variants (hard_fraction=0) so campaign rows actually flag."""
    from fraud_detection_tpu_torch.data import generate_corpus

    corpus = generate_corpus(n=128, seed=seed, hard_fraction=0.0,
                             label_noise=0.0)
    legit = [d.text for d in corpus if d.label == 0]
    scam = [d.text for d in corpus if d.label == 1]
    return legit, scam


def generate(spec: TrafficSpec, seed: int) -> List[TrafficEvent]:
    """Expand one spec into its seeded event list (see module docstring
    for the determinism contract). ``seed`` should come from the scenario
    clock (``clock.derive_seed(f"traffic:{spec.name}")``) so specs never
    perturb each other's draws."""
    rng_seed = derive_seed(seed, f"spec:{spec.name}")
    import random as _random

    rng = _random.Random(rng_seed)
    legit_pool, scam_pool = _text_pools(derive_seed(rng_seed, "texts"))
    if isinstance(spec, DriftCampaign):
        # Drifted campaigns draw scam rows from the novel-vocabulary pool
        # the serving model never trained on (see DriftCampaign).
        scam_pool = drift_scam_pool(derive_seed(rng_seed, "texts"))
    events: List[TrafficEvent] = []
    acc = 0.0
    seq = 0
    n_ticks = int(math.ceil(spec.duration_s / TICK_S))
    for i in range(n_ticks):
        rel_t = i * TICK_S
        dt = min(TICK_S, spec.duration_s - rel_t)
        acc += spec.rate_at(rel_t) * dt
        n = int(acc)
        acc -= n
        for k in range(n):
            t = spec.at_s + rel_t + dt * (k + 1) / (n + 1)
            scam = rng.random() < spec.scam_fraction
            pool = scam_pool if scam else legit_pool
            text = pool[rng.randrange(len(pool))]
            if spec.hot_fraction > 0.0 and rng.random() < spec.hot_fraction:
                key = f"{spec.name}-hot{rng.randrange(spec.hot_keys)}"
            else:
                key = f"{spec.name}-{seq}"
            payload = {"text": text, "id": f"{spec.name}-{seq}",
                       "scenario": spec.name}
            if spec.emit_truth:
                payload["truth"] = 1 if scam else 0
            value = json.dumps(payload, sort_keys=True).encode()
            events.append(TrafficEvent(round(t, 6), value, key.encode(),
                                       "scam" if scam else "legit"))
            seq += 1
    return events


def compose(specs: Sequence[TrafficSpec],
            clock: ScenarioClock) -> List[TrafficEvent]:
    """Merge every spec's seeded events into one time-ordered timeline.
    Each spec draws from its own clock-derived stream, so adding or
    reordering specs never changes another spec's rows."""
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"traffic spec names must be unique, got {names}")
    events: List[TrafficEvent] = []
    for spec in specs:
        events.extend(generate(spec, clock.derive_seed("traffic")))
    events.sort(key=lambda e: (e.t, e.key))
    return events


class TimelineAction(NamedTuple):
    """A scripted operator/fault action at a virtual time (hot swap, drain
    trigger, ...). ``fn`` runs on the scenario-feeder thread."""

    t: float
    name: str
    fn: Callable[[], None]


class TrafficFeeder:
    """The scenario-feeder thread: walks the merged (events + actions)
    timeline in virtual-time order, producing rows to the input topic and
    firing actions at their times.

    One feeder per scenario run; ``start()`` spawns the single daemon
    thread ("scenario-feeder"), ``join()`` waits it out. Counters live under a small lock so
    ``stats()`` is safe from any thread; action exceptions are recorded in
    ``action_errors`` (a broken action fails the scenario's verdict, never
    the feeder). ``on_done`` runs last on the feeder thread — the game-day
    runner uses it to wait out the drain and stop the fleet."""

    def __init__(self, producer, topic: str,
                 events: Sequence[TrafficEvent], clock: ScenarioClock, *,
                 actions: Sequence[TimelineAction] = (),
                 on_done: Optional[Callable[[], None]] = None):
        self.producer = producer
        self.topic = topic
        self.events = list(events)
        self.actions = sorted(actions, key=lambda a: a.t)
        self.clock = clock
        self.on_done = on_done
        self._lock = threading.Lock()
        self._fed = 0
        self._actions_run: List[str] = []
        self.action_errors: List[tuple] = []    # (name, repr(exc))
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    # -- cross-thread surface -------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"fed": self._fed, "planned": len(self.events),
                    "actions_run": list(self._actions_run),
                    "action_errors": list(self.action_errors)}

    @property
    def fed(self) -> int:
        with self._lock:
            return self._fed

    def alive(self) -> bool:
        """True while the feeder thread is still walking the timeline."""
        t = self._thread
        return t is not None and t.is_alive()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "TrafficFeeder":
        t = threading.Thread(target=self._run, name="scenario-feeder",
                             daemon=True)
        with self._lock:
            self._thread = t
        t.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError(
                    f"scenario feeder did not finish within {timeout}s "
                    f"({self.stats()})")

    def run_inline(self) -> None:
        """Drive the whole timeline on the CALLER's thread (replay CLI,
        tests that want strict sequencing)."""
        self._run()

    # -- feeder thread --------------------------------------------------

    def _run(self) -> None:
        try:
            self.clock.start()
            ai = 0
            actions = self.actions
            for ev in self.events:
                while ai < len(actions) and actions[ai].t <= ev.t:
                    self._fire(actions[ai])
                    ai += 1
                self.clock.advance_to(ev.t)
                self.producer.produce(self.topic, ev.value, key=ev.key)
                with self._lock:
                    self._fed += 1
            for act in actions[ai:]:
                self.clock.advance_to(act.t)
                self._fire(act)
            flush = getattr(self.producer, "flush", None)
            if flush is not None:
                flush()
            if self.on_done is not None:
                self.on_done()
        except BaseException as e:  # noqa: BLE001 — surfaced via .error
            self.error = e

    def _fire(self, action: TimelineAction) -> None:
        self.clock.advance_to(action.t)
        try:
            action.fn()
        except Exception as e:  # noqa: BLE001 — verdict-level failure
            with self._lock:
                self.action_errors.append((action.name, repr(e)))
            return
        with self._lock:
            self._actions_run.append(action.name)
