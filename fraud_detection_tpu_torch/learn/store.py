"""Bounded keyed sliding-window store of recently scored rows — twin of
``fraud_detection_tpu/learn/store.py`` (host-side; no device state).

The learn loop's state between a row being scored and its ground-truth
label arriving (minutes to hours later in production; virtual seconds in a
game day). Each entry is keyed by the row's SOURCE COORDINATE
(topic, partition, offset — the same key DLQ records and feedback labels
carry) and retains the row's PACKED ENCODED FEATURES (the featurizer's
sparse (ids, counts) arrays, a few hundred bytes/row), the primary model's
prediction, and which model version scored it. Raw text is NEVER retained:
the window is a training buffer, not a transcript log, and the packed form
is both smaller and exactly what the tree trainer consumes.

Bounds are explicit and accounted:

* ``capacity`` — beyond it the OLDEST row is evicted (insertion order);
* ``max_age_s`` — rows older than this are swept on insert and on demand.

Eviction is never silent: the store remembers, per source partition, the
highest offset it has ever evicted, so a label arriving for a gone row is
classified ``expired`` (we HAD it, the window moved on) while a label for a
row this store never held goes to a BOUNDED pending buffer — the join is
symmetric stream-stream buffering, because a label can legitimately race
its row (at-least-once replays; warp-mode scenarios where virtual label
delay collapses below scoring latency). A pending label resolves to
``joined`` the moment its row inserts, or falls to ``missed`` when it
overflows the buffer or out-ages ``max_age_s``. The accounting invariant —
the hypothesis property tests/test_torch_learn.py pins —

    joined + expired + missed + pending == labels_seen

holds across any interleaving of inserts, joins, and evictions (at
quiescence pending drains to zero, recovering the three-term form);
malformed feedback records are counted separately (they carry no
coordinate to classify). All surfaces are thread-safe (one small lock):
the learn-lane worker inserts/joins, health pollers snapshot.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

Coordinate = Tuple[str, int, int]


@dataclass
class StoredRow:
    """One scored row awaiting (or holding) its ground-truth label."""

    key: Coordinate
    ids: np.ndarray          # (L,) int16/int32 hashed feature ids (packed)
    counts: np.ndarray       # (L,) uint16 term counts
    pred_label: int          # the primary model's prediction at scoring time
    prob: float              # the primary model's p(class=1)
    version: Optional[int]   # active model version that scored it
    inserted_at: float       # store-clock seconds
    label: Optional[int] = None   # ground truth once joined


class WindowStore:
    """See module docstring. ``clock`` is injectable (tests and the
    scenario harness drive virtual seconds)."""

    def __init__(self, capacity: int = 8192, *, max_age_s: float = 3600.0,
                 clock: Callable[[], float] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_age_s <= 0:
            raise ValueError(f"max_age_s must be > 0, got {max_age_s}")
        import time

        self.capacity = capacity
        self.max_age_s = max_age_s
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._rows: "OrderedDict[Coordinate, StoredRow]" = OrderedDict()
        # (topic, partition) -> highest offset ever EVICTED from this store:
        # the expired-vs-missed classifier for late labels.
        self._evicted_watermark: Dict[Tuple[str, int], int] = {}
        # Labels that arrived BEFORE their row (symmetric join buffer):
        # key -> (label, stamped_at). Bounded by the same capacity/age as
        # the row window; overflow/age-out counts as missed.
        self._pending_labels: "OrderedDict[Coordinate, Tuple[int, float]]" \
            = OrderedDict()
        self._labeled = 0
        self._evicted = 0
        self._evicted_labeled = 0
        self._inserted = 0
        # Label accounting (the invariant: joined+expired+missed==seen).
        self._labels_seen = 0
        self._joined = 0
        self._expired = 0
        self._missed = 0
        self._malformed = 0

    # ------------------------------------------------------------------
    # rows (learn-lane writer)
    # ------------------------------------------------------------------

    def insert(self, key: Coordinate, ids: np.ndarray, counts: np.ndarray,
               pred_label: int, prob: float,
               version: Optional[int] = None) -> None:
        """Insert one scored row (idempotent per coordinate: a replayed
        at-least-once duplicate overwrites in place, keeping its slot's
        age — the window never double-counts a source row)."""
        now = self._clock()
        row = StoredRow(key, ids, counts, int(pred_label), float(prob),
                        version, now)
        with self._lock:
            prior = self._rows.pop(key, None)
            if prior is not None:
                if prior.label is not None and row.label is None:
                    # A duplicate delivery must not un-join a labeled row.
                    row.label = prior.label
                    row.inserted_at = prior.inserted_at
                elif prior.label is None:
                    row.inserted_at = prior.inserted_at
                if prior.label is not None:
                    self._labeled -= 1
            early = self._pending_labels.pop(key, None)
            if early is not None:
                # The label raced its row (pending buffer): join NOW.
                # Every buffered label is accounted exactly once.
                row.label = early[0]
                self._joined += 1
            self._rows[key] = row
            if row.label is not None:
                self._labeled += 1
            self._inserted += 1
            self._sweep_locked(now)

    def _evict_locked(self, key: Coordinate, row: StoredRow) -> None:
        wm_key = (key[0], key[1])
        prior = self._evicted_watermark.get(wm_key, -1)
        self._evicted_watermark[wm_key] = max(prior, key[2])
        self._evicted += 1
        if row.label is not None:
            self._labeled -= 1
            self._evicted_labeled += 1

    def _sweep_locked(self, now: float) -> None:
        while len(self._rows) > self.capacity:
            key, row = self._rows.popitem(last=False)
            self._evict_locked(key, row)
        cutoff = now - self.max_age_s
        while self._rows:
            key = next(iter(self._rows))
            row = self._rows[key]
            if row.inserted_at >= cutoff:
                break
            del self._rows[key]
            self._evict_locked(key, row)
        # Pending (row-less) labels: overflow and age-out fall to missed —
        # bounded by the same capacity/age discipline as the row window.
        while len(self._pending_labels) > self.capacity:
            self._pending_labels.popitem(last=False)
            self._missed += 1
        while self._pending_labels:
            key = next(iter(self._pending_labels))
            if self._pending_labels[key][1] >= cutoff:
                break
            del self._pending_labels[key]
            self._missed += 1

    def sweep(self) -> None:
        """Age-based eviction on demand (the loop calls it per tick so an
        idle stream still expires its window)."""
        with self._lock:
            self._sweep_locked(self._clock())

    # ------------------------------------------------------------------
    # labels (learn-lane writer)
    # ------------------------------------------------------------------

    def join(self, key: Coordinate, label: int) -> str:
        """Join one ground-truth label; returns its fate —
        ``"joined"`` | ``"expired"`` | ``"pending"``. A second label for a
        still-held row overwrites (latest verdict wins) and counts as
        joined: the invariant counts LABELS, not rows. A label whose row
        is neither held nor known-evicted buffers as PENDING (it may have
        raced its row — see module docstring) and later resolves to
        joined (row arrives) or missed (overflow/age-out)."""
        with self._lock:
            self._labels_seen += 1
            row = self._rows.get(key)
            if row is not None:
                if row.label is None:
                    self._labeled += 1
                row.label = int(label)
                self._joined += 1
                return "joined"
            wm = self._evicted_watermark.get((key[0], key[1]), -1)
            if key[2] <= wm:
                self._expired += 1
                return "expired"
            if key in self._pending_labels:
                # Duplicate early label: the superseded one is accounted
                # as missed (exactly one pending slot per coordinate).
                self._missed += 1
            self._pending_labels[key] = (int(label), self._clock())
            self._pending_labels.move_to_end(key)
            self._sweep_locked(self._clock())
            return "pending"

    def count_malformed(self) -> None:
        """One undecodable feedback record (no coordinate to classify)."""
        with self._lock:
            self._malformed += 1

    # ------------------------------------------------------------------
    # training window (learn-lane reader)
    # ------------------------------------------------------------------

    def labeled_rows(self) -> List[StoredRow]:
        """Snapshot copy of every labeled row, oldest first (the retrain
        input; entries are not removed — the window keeps sliding)."""
        with self._lock:
            return [r for r in self._rows.values() if r.label is not None]

    def error_stats(self, last_n: Optional[int] = None,
                    version: Optional[int] = None) -> Tuple[int, int]:
        """(labeled, errors) over the labeled window — ``errors`` counts
        rows whose stored prediction disagrees with the joined ground
        truth. ``last_n`` restricts to the most recently INSERTED labeled
        rows; ``version`` restricts to rows SCORED BY that model version
        (the drift trigger judges the ACTIVE model, so a just-promoted
        fix isn't re-triggered by its predecessor's stale errors)."""
        with self._lock:
            rows = [r for r in self._rows.values() if r.label is not None]
        if version is not None:
            rows = [r for r in rows if r.version == version]
        if last_n is not None:
            rows = rows[-last_n:]
        errors = sum(1 for r in rows if r.pred_label != r.label)
        return len(rows), errors

    def error_by_version(self) -> Dict[str, dict]:
        """Labeled/error counts segmented by the model version that scored
        each row — the promotion-recovery evidence (a promoted candidate's
        rows should stop erring)."""
        with self._lock:
            rows = [r for r in self._rows.values() if r.label is not None]
        out: Dict[str, dict] = {}
        for r in rows:
            k = str(r.version)
            slot = out.setdefault(k, {"labeled": 0, "errors": 0})
            slot["labeled"] += 1
            slot["errors"] += int(r.pred_label != r.label)
        for slot in out.values():
            slot["error_rate"] = round(slot["errors"] / slot["labeled"], 6)
        return out

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rows": len(self._rows),
                "labeled": self._labeled,
                "capacity": self.capacity,
                "inserted": self._inserted,
                "evicted": self._evicted,
                "evicted_labeled": self._evicted_labeled,
                "labels_seen": self._labels_seen,
                "joined": self._joined,
                "expired": self._expired,
                "missed": self._missed,
                "pending_labels": len(self._pending_labels),
                "malformed_labels": self._malformed,
                "accounting_exact": (
                    self._joined + self._expired + self._missed
                    + len(self._pending_labels) == self._labels_seen),
            }
