"""Shadow scoring: run a candidate model beside the primary, off the hot path
— twin of ``fraud_detection_tpu/registry/shadow.py``.

While a candidate is staged, the engine hands each scored micro-batch's
inputs + primary results to a ``ShadowScorer``. A background worker rescales
the batch with the CANDIDATE and accumulates divergence statistics:

  * agreement rate — fraction of rows where the labels match
  * mean |Δp| — mean absolute probability difference
  * flag-rate delta — candidate flag rate minus primary flag rate
  * PSI — population stability index over the score distribution, from
    per-bin score histograms counted on the candidate's device
    (``torch.bincount``; the reference counts them with its jitted
    ``histogram_reference``, not a Pallas kernel)

The primary path NEVER blocks on the shadow: submission is a non-blocking
put into a bounded queue — under overload (a slow candidate, the steady
state for a bigger model) batches are dropped and counted, so the sampling
rate is a recorded fact, exactly like the async annotation lane
(stream/annotations.py). A raising candidate increments an error counter
and the stream never notices — unless the fault is the card's
(``utils/device.is_device_fault``): then the worker records it in
``fault`` and stops, and the serve CLI exits non-zero.

On a CUDA candidate the worker scores on a stream of its own
(``utils/device.lane_stream``), so its host reads never wait behind the
engine's batches on the default stream, nor they behind it.
"""

from __future__ import annotations

import json
import queue
import random
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from fraud_detection_tpu_torch.utils import get_logger
from fraud_detection_tpu_torch.utils.device import (is_device_fault,
                                                    lane_stream, on_lane)
from fraud_detection_tpu_torch.utils.racecheck import ExclusiveRegion

log = get_logger("registry.shadow")

N_BINS = 20
_PSI_EPS = 1e-4


def score_histogram(probs, n_bins: int = N_BINS,
                    device="cpu") -> np.ndarray:
    """(N,) scores in [0, 1] -> (n_bins,) counts as float64: bin =
    clip(int(p * n_bins), 0, n_bins - 1) of the f32 score, counted with
    ``torch.bincount`` on ``device`` (the candidate's)."""
    if np.size(probs) == 0:
        return np.zeros(n_bins, np.float64)
    p = torch.from_numpy(np.ascontiguousarray(probs, np.float32)).to(device)
    bins = torch.clamp((p * n_bins).to(torch.int32), 0, n_bins - 1)
    counts = torch.bincount(bins, minlength=n_bins)
    return counts.cpu().numpy().astype(np.float64)


def population_stability_index(expected: np.ndarray,
                               observed: np.ndarray) -> float:
    """PSI between two count histograms (smoothed; 0 = identical shape).
    Rule of thumb: < 0.1 stable, 0.1–0.25 drifting, > 0.25 shifted."""
    e = np.asarray(expected, np.float64)
    o = np.asarray(observed, np.float64)
    if e.sum() <= 0 or o.sum() <= 0:
        return 0.0
    p = e / e.sum() + _PSI_EPS
    q = o / o.sum() + _PSI_EPS
    p /= p.sum()
    q /= q.sum()
    return float(np.sum((q - p) * np.log(q / p)))


class ShadowScorer:
    """Bounded-queue async candidate scorer with divergence accounting.

    One instance lives for the whole serve run (shared across workers — all
    methods are thread-safe); candidates come and go via
    ``set_candidate``/``clear_candidate``, each reset starting a fresh
    stats window. The engine calls ``wants()`` (cheap gate: candidate
    present + sampling draw) then ``submit()`` per micro-batch.
    """

    def __init__(self, *, max_queue: int = 8, sample: float = 1.0,
                 n_bins: int = N_BINS, window_batches: int = 64,
                 clock=time.monotonic,
                 rng: Optional[random.Random] = None):
        if not 0.0 < sample <= 1.0:
            raise ValueError(f"sample must be in (0, 1], got {sample}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if window_batches < 1:
            raise ValueError(
                f"window_batches must be >= 1, got {window_batches}")
        self.sample = sample
        self.n_bins = n_bins
        # Windowed divergence: per-batch stat tuples for the most recent
        # ``window_batches`` scored batches, so a long-running shadow
        # exposes RECENT agreement/PSI beside the cumulative ones — early
        # agreement must not mask late drift.
        self.window_batches = window_batches
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._lock = threading.Lock()
        self._candidate = None          # (version, pipeline) — RCU-read
        self._stop = threading.Event()
        self._streams: dict = {}        # device -> this worker's stream
        self.fault: Optional[BaseException] = None   # a device fault, fatal
        self._reset_stats_locked()
        # Race tripwire (utils/racecheck.py): scoring is single-worker by
        # construction — ONE thread started here, never respawned. The
        # region turns a second concurrent scorer (a future refactor
        # spawning a pool, or an external caller driving _score_item) into
        # an immediate RaceError instead of silently double-counted stats.
        self._region = ExclusiveRegion("ShadowScorer.worker")
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="shadow-scorer")
        self._thread.start()

    def _reset_stats_locked(self) -> None:
        self._batches = 0
        self._rows = 0
        self._agree = 0
        self._abs_dp_sum = 0.0
        self._primary_flagged = 0
        self._candidate_flagged = 0
        self._dropped = 0
        self._errors = 0
        self._sampled_out = 0
        self._primary_hist = np.zeros(self.n_bins, np.float64)
        self._candidate_hist = np.zeros(self.n_bins, np.float64)
        # Recent-window ring: (rows, agree, |dp| sum, p_hist, c_hist) per
        # scored batch, newest last (deque.maxlen drops the oldest).
        from collections import deque

        self._window = deque(maxlen=self.window_batches)
        self._started_at = self._clock()

    # ------------------------------------------------------------------
    # candidate lifecycle
    # ------------------------------------------------------------------

    def set_candidate(self, pipeline, version: Optional[int] = None) -> None:
        with self._lock:
            self._candidate = (version, pipeline)
            self._reset_stats_locked()

    def clear_candidate(self) -> None:
        with self._lock:
            self._candidate = None

    @property
    def candidate_version(self) -> Optional[int]:
        cand = self._candidate
        return cand[0] if cand is not None else None

    @property
    def active(self) -> bool:
        return self._candidate is not None

    # ------------------------------------------------------------------
    # hot-path surface (engine side)
    # ------------------------------------------------------------------

    def wants(self) -> bool:
        """Cheap per-batch gate: candidate staged and sampling draw taken.
        Sampled-out batches are counted so the shadow coverage is known."""
        if self._candidate is None:
            return False
        if self.sample >= 1.0 or self._rng.random() < self.sample:
            return True
        with self._lock:
            self._sampled_out += 1
        return False

    def submit(self, payloads: Sequence, labels, probs, *, raw: bool,
               text_field: str = "text") -> bool:
        """Queue one scored micro-batch for candidate comparison.

        ``payloads`` are raw message bytes (``raw=True``; decoded by the
        worker, off the hot path) or already-decoded texts; ``labels`` /
        ``probs`` are the PRIMARY model's outputs, positionally aligned with
        ``payloads``. NEVER blocks: a full queue drops the batch and counts
        it. Returns whether the batch was enqueued."""
        cand = self._candidate
        if cand is None:
            return False
        try:
            self._queue.put_nowait(
                (cand, payloads, labels, probs, raw, text_field))
            return True
        except queue.Full:
            with self._lock:
                self._dropped += 1
            return False

    def submit_encoded(self, ids, counts, labels, probs) -> bool:
        """Queue a batch of ALREADY-ENCODED rows ((B, L) hashed ids + term
        counts — the learn window's retained form, learn/store.py) for
        candidate comparison. The worker scores them through the
        candidate's ``predict_encoded``, so a freshly staged candidate can
        be judged against the RECENT WINDOW immediately instead of waiting
        for future traffic to sample — what makes warp-speed game days
        (and fast drift response) possible. Same non-blocking bounded-
        queue contract as ``submit``."""
        cand = self._candidate
        if cand is None:
            return False
        try:
            self._queue.put_nowait(
                (cand, (np.asarray(ids), np.asarray(counts)),
                 np.asarray(labels), np.asarray(probs), "encoded", ""))
            return True
        except queue.Full:
            with self._lock:
                self._dropped += 1
            return False

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                with self._region, on_lane(lane_stream(
                        getattr(item[0][1], "device", None), self._streams)):
                    self._score_item(item)
            except Exception as e:  # noqa: BLE001 — shadow must never kill serving
                with self._lock:
                    self._errors += 1
                if is_device_fault(e):
                    # The card failed, not the candidate: stop and surface.
                    self.fault = e
                    self._stop.set()
                    log.error("shadow worker stopped on a device fault "
                              "(candidate v%s): %s", item[0][0], e)
                else:
                    log.warning("shadow scoring failed (candidate v%s): %s",
                                item[0][0], e)
            finally:
                self._queue.task_done()

    def _score_item(self, item) -> None:
        (version, pipeline), payloads, labels, probs, raw, text_field = item
        if self._candidate is None or self._candidate[0] != version:
            return  # candidate was cleared/replaced while queued: stale
        if raw == "encoded":
            # Window-replay batch (submit_encoded): score the candidate on
            # the stored packed rows directly — no text exists to decode.
            ids, counts = payloads
            if ids.shape[0] == 0:
                return
            cand = pipeline.predict_encoded(ids, counts)
            self._accumulate(version, np.asarray(labels), np.asarray(probs),
                             np.asarray(cand.labels),
                             np.asarray(cand.probabilities, np.float64),
                             getattr(pipeline, "device", "cpu"))
            return
        if raw:
            texts: List[str] = []
            keep: List[int] = []
            for i, value in enumerate(payloads):
                try:
                    obj = json.loads(value)
                except ValueError:
                    continue
                text = obj.get(text_field) if isinstance(obj, dict) else None
                if isinstance(text, str):
                    texts.append(text)
                    keep.append(i)
            labels = np.asarray(labels)[keep]
            probs = np.asarray(probs)[keep]
        else:
            texts = list(payloads)
            labels = np.asarray(labels)
            probs = np.asarray(probs)
        if not texts:
            return
        cand = pipeline.predict(texts)
        self._accumulate(version, np.asarray(labels), np.asarray(probs),
                         np.asarray(cand.labels),
                         np.asarray(cand.probabilities, np.float64),
                         getattr(pipeline, "device", "cpu"))

    def _accumulate(self, version, labels, probs, c_labels, c_probs,
                    device="cpu") -> None:
        """Fold one scored batch into the cumulative AND windowed stats
        (shared by the live-traffic and encoded-replay paths); the score
        histograms are counted on the candidate's ``device``."""
        p_probs = np.asarray(probs, np.float64)
        p_hist = score_histogram(p_probs, self.n_bins, device)
        c_hist = score_histogram(c_probs, self.n_bins, device)
        n = int(labels.shape[0])
        agree = int(np.sum(c_labels == labels))
        abs_dp = float(np.sum(np.abs(c_probs - p_probs)))
        with self._lock:
            if self._candidate is None or self._candidate[0] != version:
                return
            self._batches += 1
            self._rows += n
            self._agree += agree
            self._abs_dp_sum += abs_dp
            self._primary_flagged += int(np.sum(labels != 0))
            self._candidate_flagged += int(np.sum(c_labels != 0))
            self._primary_hist += p_hist
            self._candidate_hist += c_hist
            self._window.append((n, agree, abs_dp, p_hist, c_hist))

    # ------------------------------------------------------------------
    # observability / teardown
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """Point-in-time divergence stats (the health()/promotion input)."""
        with self._lock:
            rows = self._rows
            cand = self._candidate
            # Windowed (recent-batch) divergence beside the cumulative
            # stats: a month of early agreement must not mask an hour of
            # drift.
            w_rows = sum(t[0] for t in self._window)
            w_agree = sum(t[1] for t in self._window)
            w_dp = sum(t[2] for t in self._window)
            if self._window:
                w_p_hist = np.sum([t[3] for t in self._window], axis=0)
                w_c_hist = np.sum([t[4] for t in self._window], axis=0)
            else:
                w_p_hist = w_c_hist = np.zeros(self.n_bins, np.float64)
            window = {
                "batches": len(self._window),
                "max_batches": self.window_batches,
                "rows": w_rows,
                "agreement_rate": (w_agree / w_rows) if w_rows else None,
                "mean_abs_dp": (w_dp / w_rows) if w_rows else None,
                "psi": population_stability_index(w_p_hist, w_c_hist)
                       if w_rows else None,
            }
            snap = {
                "candidate_version": cand[0] if cand is not None else None,
                "batches": self._batches,
                "rows": rows,
                "disagreed": rows - self._agree,
                "window": window,
                "agreement_rate": (self._agree / rows) if rows else None,
                "mean_abs_dp": (self._abs_dp_sum / rows) if rows else None,
                "flag_rate_primary": (self._primary_flagged / rows) if rows else None,
                "flag_rate_candidate": (self._candidate_flagged / rows) if rows else None,
                "flag_rate_delta": ((self._candidate_flagged - self._primary_flagged)
                                    / rows) if rows else None,
                "psi": population_stability_index(self._primary_hist,
                                                  self._candidate_hist)
                       if rows else None,
                "dropped": self._dropped,
                "errors": self._errors,
                "sampled_out": self._sampled_out,
                "queue_depth": self._queue.qsize(),
                "sample": self.sample,
                "window_sec": self._clock() - self._started_at,
                "score_hist_primary": self._primary_hist.tolist(),
                "score_hist_candidate": self._candidate_hist.tolist(),
            }
        return snap

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until every queued batch is scored (tests/orderly teardown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.unfinished_tasks == 0:
                return True
            time.sleep(0.01)
        return self._queue.unfinished_tasks == 0

    def close(self, timeout: float = 10.0) -> bool:
        """Drain (bounded) then stop the worker thread."""
        drained = self.drain(timeout)
        self._stop.set()
        self._thread.join(timeout=5.0)
        return drained and not self._thread.is_alive()
