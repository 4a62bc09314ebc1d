"""ScenarioClock: the one seeded timeline every scenario component shares —
twin of ``fraud_detection_tpu/scenarios/clock.py``.

A scenario composes three kinds of seeded machinery — traffic generation
(scenarios/traffic.py), broker fault injection (stream/faults.py
``FaultPlan``), and whole-worker deaths (``WorkerDeathPlan``) — and the
harness's reproducibility claim is only as strong as its weakest seed
discipline. The clock centralizes both halves of that discipline:

* **Seed derivation.** ``rng(name)`` / ``derive_seed(name)`` hand each
  component an independent deterministic stream derived from the ONE
  scenario seed via a stable hash (sha256 — NOT Python's ``hash()``, whose
  str/bytes randomization would change schedules across processes). Adding
  a component, or reordering construction, never perturbs any other
  component's draws — the failure mode a single shared ``random.Random``
  consumed in call order cannot avoid across refactors.
* **Virtual time.** Traffic events and timeline actions are scheduled at
  *virtual* seconds from scenario start. ``advance_to(t)`` maps virtual to
  wall time through ``time_scale``: 1.0 replays in real time, 0.5 at double
  speed, and **0.0 is warp mode** — no sleeping at all, the whole schedule
  is emitted as fast as the consumer drains it (what tests and the CI smoke
  run, paying zero wall-clock for a "two-minute" scenario). The EVENT
  timeline (what happens, in what order, with what payloads) is identical
  in every mode; only the pacing differs.

The clock is owned and driven by the single scenario-feeder thread
(scenarios/traffic.py); ``now()`` is a cross-thread-safe monotonic read.
"""

from __future__ import annotations

import hashlib
import random
import time
from typing import Callable


def derive_seed(seed: int, name: str) -> int:
    """A 63-bit child seed from (seed, name), stable across processes and
    Python versions (sha256, not the randomized builtin hash)."""
    digest = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 1


class ScenarioClock:
    """Virtual scenario time + deterministic per-component seed streams."""

    def __init__(self, seed: int = 0, *, time_scale: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep,
                 wall: Callable[[], float] = time.monotonic):
        if time_scale < 0:
            raise ValueError(f"time_scale must be >= 0, got {time_scale}")
        self.seed = seed
        self.time_scale = time_scale
        self._sleep = sleep
        self._wall = wall
        self._started_at: float = wall()
        self._now = 0.0     # virtual seconds since start (monotonic float)

    # -- seeds ----------------------------------------------------------

    def derive_seed(self, name: str) -> int:
        """Deterministic child seed for a named component (fault plan,
        death plan, a traffic spec's draw stream, ...)."""
        return derive_seed(self.seed, name)

    def rng(self, name: str) -> random.Random:
        """An independent seeded stream for a named component."""
        return random.Random(self.derive_seed(name))

    # -- virtual time ---------------------------------------------------

    def start(self) -> None:
        """(Re)anchor virtual t=0 at the current wall clock — call when
        the scenario actually begins consuming the timeline."""
        self._started_at = self._wall()
        self._now = 0.0

    def now(self) -> float:
        """Current virtual time (last advanced-to point)."""
        return self._now

    def advance_to(self, t_virtual: float) -> None:
        """Advance the timeline to ``t_virtual`` seconds after start: in
        warp mode (time_scale 0) this just moves the cursor; otherwise it
        sleeps out whatever scaled wall time remains. Never goes
        backwards."""
        if t_virtual <= self._now:
            return
        if self.time_scale > 0.0:
            target_wall = self._started_at + t_virtual * self.time_scale
            remaining = target_wall - self._wall()
            if remaining > 0:
                self._sleep(remaining)
        self._now = t_virtual
