"""LearnLoop: the "learn-lane" thread closing the learning loop — twin of
``fraud_detection_tpu/learn/loop.py``.

One worker thread runs beside the serving engine and owns four jobs:

1. **Ingest scored rows.** The engine offers each scored micro-batch's
   source coordinates + payloads + primary results through a non-blocking
   bounded queue (``submit`` — the same drop-and-count contract as the
   shadow scorer, registry/shadow.py). The lane decodes and re-encodes the
   texts OFF the hot path and inserts the packed rows into the
   :class:`~fraud_detection_tpu_torch.learn.store.WindowStore`; raw text
   is dropped the moment the packed form exists.
2. **Join labels.** The lane polls the feedback topic (any ``Consumer``;
   stream/feedback.py is the record format), joining each label against
   the window — every label ends joined, expired, or missed, and the
   offsets commit after processing (at-least-once; duplicate labels
   re-join harmlessly).
3. **Retrain on signal.** Three triggers — drift (windowed label-error
   rate over threshold: the live model is WRONG about recent ground
   truth), row count (enough fresh labels), and time (optional cadence) —
   fire a warm-started boosted-tree refresh
   (models/train_trees.py ``refresh_gradient_boosting``: the active
   model's trees + a few new rounds on the window) on the active model's
   device: on the card every level of every round launches the histogram
   and ``best_splits`` kernels, on a CUDA stream of the lane's own
   (``utils/device.lane_stream``), so the refresh's per-level host reads
   wait for the refresh alone while the engine keeps scoring on the
   default stream. The candidate publishes to the registry with lineage +
   window metadata in the manifest.
4. **Ride the lifecycle.** Promotion is NOT this loop's decision: the
   ``LifecycleController`` (registry/promote.py) stages the published
   version, shadow-scores it, and judges it through its PSI/agreement/
   health gates — every transition audited. The loop only observes
   (``on_transition``) and, when its candidate is staged, REPLAYS the
   recent window to the shadow scorer (``submit_encoded``) so the
   candidate is judged against the rows that motivated it without waiting
   for future traffic. If a PROMOTED candidate then regresses against
   fresh ground truth, the loop rolls back through the controller's
   audited ``rollback`` path.

A retrain that fails is counted and serving goes on, as in the reference —
unless the fault is the card's (``utils/device.is_device_fault``: a CUDA
error, a kernel that did not build or launch): then the lane records it in
``fault`` and stops, and the serve CLI exits non-zero. The lane is guarded
by an ExclusiveRegion tripwire; every mutable counter lives under one lock
(``snapshot()`` is the engine's ``health()["learn"]`` block, with the
reference's keys).
"""

from __future__ import annotations

import json
import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fraud_detection_tpu_torch.learn.store import WindowStore
from fraud_detection_tpu_torch.stream.feedback import parse_label
from fraud_detection_tpu_torch.utils import get_logger
from fraud_detection_tpu_torch.utils.device import (is_device_fault,
                                                    lane_stream, on_lane)
from fraud_detection_tpu_torch.utils.racecheck import ExclusiveRegion

log = get_logger("learn.loop")


@dataclass(frozen=True)
class LearnConfig:
    """Knobs of the closed loop (the reference's, with its defaults).

    The DRIFT trigger is the headline: the windowed label-error rate of
    the live model over the most recent ``error_window`` labeled rows
    exceeding ``error_threshold`` means recent ground truth disagrees
    with what was served — fraud drifted. ``rows_trigger`` (fresh joins)
    and ``interval_s`` (cadence, off by default) are the supporting
    signals. ``cooldown_s`` bounds retrain churn."""

    window: int = 8192              # WindowStore capacity (rows)
    max_age_s: float = 3600.0       # WindowStore age bound
    min_labeled: int = 256          # evidence floor for ANY retrain
    min_new_labels: int = 64        # fresh joins required since last retrain
    error_threshold: float = 0.15   # drift trigger: recent label-error rate
    error_window: int = 512         # labeled rows the drift trigger judges
    rows_trigger: Optional[int] = None   # fresh-join count trigger (off=None)
    interval_s: Optional[float] = None   # time trigger (off=None)
    cooldown_s: float = 2.0         # min seconds between retrains
    refresh_rounds: int = 8         # new boosting rounds per retrain
    max_train_rows: int = 4096      # densified window cap (most recent)
    max_trees: int = 400            # past this, warm-start from the base
    queue: int = 64                 # scored-batch submit queue bound
    sample: float = 1.0             # fraction of batches ingested
    poll_timeout_s: float = 0.02    # feedback poll wait per tick
    replay_shadow: bool = True      # feed staged candidates the window
    replay_rows: int = 2048         # most recent rows replayed to shadow
    rollback_error_rate: Optional[float] = 0.5  # promoted-regression bound
    rollback_min_labeled: int = 64  # evidence floor for a rollback

    def __post_init__(self):
        if not 0.0 < self.sample <= 1.0:
            raise ValueError(f"sample must be in (0, 1], got {self.sample}")
        if self.min_labeled < 2:
            raise ValueError(
                f"min_labeled must be >= 2, got {self.min_labeled}")
        if self.error_threshold <= 0:
            raise ValueError(
                f"error_threshold must be > 0, got {self.error_threshold}")
        if self.refresh_rounds < 1:
            raise ValueError(
                f"refresh_rounds must be >= 1, got {self.refresh_rounds}")


class LearnLoop:
    """See module docstring. ``feedback_consumer`` is any Consumer on the
    feedback topic; ``registry``/``hotswap`` are the serving lifecycle the
    loop publishes into; ``shadow`` (optional) receives window replays for
    staged candidates; ``controller`` (optional) enables regression
    rollback. ``clock`` paces cooldowns (wall monotonic); ``now_fn``
    stamps events (virtual seconds under the scenario harness)."""

    def __init__(self, *, store: Optional[WindowStore] = None,
                 feedback_consumer=None, registry=None, hotswap=None,
                 shadow=None, controller=None,
                 config: Optional[LearnConfig] = None,
                 text_field: str = "text",
                 clock=time.monotonic, now_fn=None,
                 rng: Optional[random.Random] = None,
                 start: bool = True):
        self.config = cfg = config or LearnConfig()
        self.store = store if store is not None else WindowStore(
            cfg.window, max_age_s=cfg.max_age_s, clock=clock)
        self._consumer = feedback_consumer
        self._registry = registry
        self._hotswap = hotswap
        self._shadow = shadow
        self._controller = controller
        self._text_field = text_field
        self._clock = clock
        self._now = now_fn if now_fn is not None else clock
        self._rng = rng if rng is not None else random.Random()
        self._queue: "queue.Queue" = queue.Queue(maxsize=cfg.queue)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._featurizer = None
        # -- counters (all under _lock) --
        self._submitted = 0
        self._dropped = 0
        self._sampled_out = 0
        self._encode_errors = 0
        self._labels_polled = 0
        self._triggered = 0
        self._published = 0
        self._failed = 0
        self._in_flight = False
        self._promoted = 0
        self._rejected = 0
        self._rolled_back = 0
        self._published_versions: List[int] = []
        self._promoted_versions: List[int] = []
        self._last_trigger: Optional[str] = None
        self._first_trigger_at: Optional[float] = None
        self._promoted_at: Optional[float] = None
        self._last_retrain_clock: Optional[float] = None
        self._joined_at_last_retrain = 0
        self._last_retrain_wall: Optional[float] = None
        self._retrain_wall_total = 0.0
        self._candidate_error: Optional[float] = None
        self._primary_error: Optional[float] = None
        self._replay_pending: Optional[int] = None
        self._replayed: set = set()
        self._rollback_done: set = set()
        self._base_model = None   # first active ensemble (growth-cap base)
        self._streams: dict = {}  # device -> the lane's CUDA stream
        self.fault: Optional[BaseException] = None   # a device fault, fatal
        # Race tripwire (utils/racecheck.py): the lane is single-worker by
        # construction — one thread started here, never respawned; tick()
        # is also the test-mode inline driver (start=False), and the
        # region makes a second concurrent driver a loud RaceError.
        self._region = ExclusiveRegion("LearnLoop.lane")
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="learn-lane")
            self._thread.start()

    # ------------------------------------------------------------------
    # hot-path surface (engine driver)
    # ------------------------------------------------------------------

    def bind_controller(self, controller) -> None:
        """Late-bind the LifecycleController (construction order: the
        controller wants ``on_transition=loop.on_transition``, the loop
        wants the controller for regression rollback — bind whichever is
        built second through this)."""
        with self._lock:
            self._controller = controller

    def wants(self) -> bool:
        """Cheap per-batch gate (sampling draw; sampled-out counted)."""
        if self.config.sample >= 1.0 or self._rng.random() < self.config.sample:
            return True
        with self._lock:
            self._sampled_out += 1
        return False

    def submit(self, coords: Sequence[Tuple[str, int, int]],
               payloads: Sequence, labels, probs, *, raw: bool,
               version: Optional[int] = None) -> bool:
        """Queue one scored micro-batch for window ingestion. ``coords``
        are each row's (topic, partition, offset); ``payloads`` are raw
        message bytes (``raw=True``) or decoded texts, positionally
        aligned. NEVER blocks: a full queue drops the batch and counts it
        — the window is a sample under overload, and the accounting says
        so."""
        item = (list(coords), list(payloads), np.asarray(labels),
                np.asarray(probs, np.float64), bool(raw), version)
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            with self._lock:
                self._dropped += 1
            return False
        with self._lock:
            self._submitted += 1
        return True

    # ------------------------------------------------------------------
    # lane worker
    # ------------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                with self._region:
                    progressed = self._tick_locked()
            except Exception as e:  # noqa: BLE001 — the lane must survive
                if is_device_fault(e):
                    self.fault = e
                    log.error("learn lane stopped on a device fault: %s", e)
                    return
                log.warning("learn-lane tick failed: %s", e, exc_info=True)
                progressed = False
            if not progressed:
                self._stop.wait(0.01)

    def tick(self) -> bool:
        """One inline lane step (tests and the demo drive this with
        ``start=False``); returns whether any work was done."""
        with self._region:
            return self._tick_locked()

    def _tick_locked(self) -> bool:
        progressed = self._drain_scored()
        progressed |= self._poll_labels()
        self.store.sweep()
        progressed |= self._maybe_retrain()
        progressed |= self._maybe_replay()
        self._maybe_rollback()
        return progressed

    # -- ingestion ------------------------------------------------------

    def _drain_scored(self, max_batches: int = 16) -> bool:
        did = False
        for _ in range(max_batches):
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            did = True
            try:
                self._ingest(item)
            except Exception as e:  # noqa: BLE001 — poison batch, counted
                with self._lock:
                    self._encode_errors += 1
                log.warning("learn ingest failed: %s", e)
            finally:
                self._queue.task_done()
        return did

    def _featurizer_now(self):
        if self._featurizer is None:
            pipe = self._hotswap
            feat = getattr(pipe, "featurizer", None)
            if feat is None:
                raise RuntimeError("learn loop needs a pipeline featurizer")
            self._featurizer = feat
        return self._featurizer

    def _ingest(self, item) -> None:
        coords, payloads, labels, probs, raw, version = item
        texts: List[Optional[str]] = []
        if raw:
            for value in payloads:
                try:
                    obj = json.loads(value)
                except ValueError:
                    texts.append(None)
                    continue
                t = obj.get(self._text_field) if isinstance(obj, dict) else None
                texts.append(t if isinstance(t, str) else None)
        else:
            texts = [t if isinstance(t, str) else None for t in payloads]
        keep = [i for i, t in enumerate(texts) if t is not None]
        if not keep:
            return
        feat = self._featurizer_now()
        enc = feat.encode([texts[i] for i in keep],
                          batch_size=len(keep))
        ids = np.asarray(enc.ids)
        counts = np.asarray(enc.counts)
        labels_l = np.asarray(labels)[keep].tolist()
        probs_l = np.asarray(probs)[keep].tolist()
        for j, i in enumerate(keep):
            nz = np.flatnonzero(counts[j])
            self.store.insert(tuple(coords[i]), ids[j, nz].copy(),
                              counts[j, nz].copy(), labels_l[j],
                              probs_l[j], version)

    # -- labels ---------------------------------------------------------

    def _poll_labels(self) -> bool:
        if self._consumer is None:
            return False
        msgs = self._consumer.poll_batch(512, self.config.poll_timeout_s)
        if not msgs:
            return False
        offsets: dict = {}
        for m in msgs:
            offsets[(m.topic, m.partition)] = max(
                offsets.get((m.topic, m.partition), 0), m.offset + 1)
            rec = parse_label(m.value)
            if rec is None:
                self.store.count_malformed()
            else:
                self.store.join(rec.key, rec.label)
        with self._lock:
            self._labels_polled += len(msgs)
        try:
            self._consumer.commit_offsets(offsets)
        except Exception as e:  # noqa: BLE001 — at-least-once: re-polls rejoin
            log.info("feedback commit failed (labels will replay): %s", e)
        return True

    # -- retraining -----------------------------------------------------

    def _trigger(self) -> Optional[str]:
        cfg = self.config
        snap = self.store.snapshot()
        with self._lock:
            joined_before = self._joined_at_last_retrain
            last_at = self._last_retrain_clock
            in_flight = self._in_flight
            # One candidate in flight: a published version that has not
            # been judged yet (promote/reject) blocks further retrains —
            # stacking candidates would race the shadow evidence.
            outstanding = (self._published - self._promoted
                           - self._rejected)
        if in_flight or outstanding > 0:
            return None
        if last_at is not None and self._clock() - last_at < cfg.cooldown_s:
            return None
        if snap["labeled"] < cfg.min_labeled:
            return None
        new_labels = snap["joined"] - joined_before
        if new_labels < cfg.min_new_labels:
            return None
        # Drift is judged on rows the ACTIVE model scored: a just-promoted
        # fix must not re-trigger off its predecessor's stale errors.
        labeled, errors = self.store.error_stats(
            last_n=cfg.error_window,
            version=getattr(self._hotswap, "active_version", None))
        if labeled and errors / labeled > cfg.error_threshold:
            return "drift"
        if cfg.rows_trigger is not None and new_labels >= cfg.rows_trigger:
            return "rows"
        if cfg.interval_s is not None and (
                last_at is None or self._clock() - last_at >= cfg.interval_s):
            return "interval"
        return None

    def _maybe_retrain(self) -> bool:
        reason = self._trigger()
        if reason is None:
            return False
        now_v = self._now()
        with self._lock:
            self._triggered += 1
            self._in_flight = True
            self._last_trigger = reason
            if self._first_trigger_at is None:
                self._first_trigger_at = now_v
        try:
            self._retrain(reason)
        except Exception as e:  # noqa: BLE001 — a failed retrain is counted
            with self._lock:
                self._failed += 1
            if is_device_fault(e):
                self.fault = e
                raise
            log.warning("windowed retrain failed: %s", e, exc_info=True)
        finally:
            snap = self.store.snapshot()
            with self._lock:
                self._in_flight = False
                self._last_retrain_clock = self._clock()
                self._joined_at_last_retrain = snap["joined"]
        return True

    def _retrain(self, reason: str) -> None:
        import torch

        from fraud_detection_tpu_torch.models import trees as trees_mod
        from fraud_detection_tpu_torch.models.train_trees import (
            refresh_gradient_boosting)
        from fraud_detection_tpu_torch.models.trees import TreeEnsemble

        cfg = self.config
        rows = self.store.labeled_rows()[-cfg.max_train_rows:]
        feat = self._featurizer_now()
        active = getattr(self._hotswap, "active_pipeline", self._hotswap)
        model = getattr(active, "model", None)
        if not isinstance(model, TreeEnsemble) or model.kind != "xgboost":
            raise RuntimeError(
                f"learn loop refreshes xgboost ensembles; active model is "
                f"{type(model).__name__}"
                f"{'/' + model.kind if isinstance(model, TreeEnsemble) else ''}"
                " — serve an xgboost registry model to close the loop")
        if self._base_model is None:
            self._base_model = model   # the original, pre-growth ensemble
        base = model
        if model.num_trees + cfg.refresh_rounds > cfg.max_trees:
            # Bounded growth: past the cap, warm-start from the ORIGINAL
            # base — the window carries the recent signal either way.
            base = self._base_model
        X, y = self._densify(rows, feat)
        n = len(rows)
        device = getattr(active, "device", "cuda")
        with on_lane(lane_stream(device, self._streams)):
            t0 = time.perf_counter()
            refreshed, info = refresh_gradient_boosting(
                base, X, y, n_rounds=cfg.refresh_rounds, device=device)
            wall = time.perf_counter() - t0
            # Validation on the window itself: does the candidate actually
            # agree with the ground truth the primary got wrong?
            proba = trees_mod.predict_proba(
                refreshed, torch.from_numpy(X[:n]).to(device)).cpu().numpy()
        cand_err = float(np.mean((proba[:, 1] > 0.5) != (y[:n] > 0.5)))
        prim_err = float(np.mean(
            [r.pred_label != r.label for r in rows]))
        active_version = getattr(self._hotswap, "active_version", None)
        mv = self._registry.publish(
            feat, refreshed,
            parent=active_version,
            metrics={"window_error_rate_primary": round(prim_err, 6),
                     "window_error_rate_candidate": round(cand_err, 6),
                     "window_rows": n},
            extra={"learn": {**info, "trigger": reason,
                             "triggered_at_s": self._now(),
                             "warm_started_from": active_version,
                             "retrain_wall_s": round(wall, 3)}})
        with self._lock:
            self._published += 1
            self._published_versions.append(mv.version)
            self._last_retrain_wall = wall
            self._retrain_wall_total += wall
            self._candidate_error = cand_err
            self._primary_error = prim_err
        log.info("learn: published v%04d (%s trigger, %d rows, "
                 "primary err %.3f -> candidate err %.3f, %.2fs)",
                 mv.version, reason, n, prim_err, cand_err, wall)

    @staticmethod
    def _densify(rows, feat) -> Tuple[np.ndarray, np.ndarray]:
        """Labeled window -> dense (N, F) TF-IDF matrix + labels on the
        host, exactly the feature semantics the serving traversal reads
        (count * idf)."""
        f = int(feat.num_features)
        idf = (np.ones(f, np.float32) if feat.idf is None
               else np.asarray(feat.idf, np.float32))
        X = np.zeros((len(rows), f), np.float32)
        for i, r in enumerate(rows):
            ids = np.asarray(r.ids, np.int64)
            X[i, ids] = np.asarray(r.counts, np.float32) * idf[ids]
        y = np.asarray([r.label for r in rows], np.float32)
        return X, y

    # -- shadow replay --------------------------------------------------

    def on_transition(self, record: dict) -> None:
        """LifecycleController observer: track our candidates' fates.
        Runs on the watcher thread — cheap bookkeeping only; the heavy
        replay happens on the lane."""
        event = record.get("event")
        version = record.get("version")
        with self._lock:
            ours = version in self._published_versions
            if event == "stage" and ours and self.config.replay_shadow:
                self._replay_pending = version
            elif event == "promote" and ours:
                self._promoted += 1
                self._promoted_versions.append(version)
                if self._promoted_at is None:
                    self._promoted_at = self._now()
            elif event == "reject" and ours:
                self._rejected += 1
            elif event == "rollback":
                self._replay_pending = None

    def _maybe_replay(self) -> bool:
        with self._lock:
            version = self._replay_pending
            if version is None or version in self._replayed:
                self._replay_pending = None
                return False
        sh = self._shadow
        if sh is None or sh.candidate_version != version:
            return False
        rows = self.store.labeled_rows()
        if not rows:
            return False
        rows = rows[-self.config.replay_rows:]
        for start in range(0, len(rows), 256):
            chunk = rows[start : start + 256]
            width = max(1, max(len(r.ids) for r in chunk))
            ids = np.zeros((len(chunk), width), chunk[0].ids.dtype)
            counts = np.zeros((len(chunk), width), np.uint16)
            for i, r in enumerate(chunk):
                ids[i, : len(r.ids)] = r.ids
                counts[i, : len(r.counts)] = r.counts
            sh.submit_encoded(ids, counts,
                              np.asarray([r.pred_label for r in chunk],
                                         np.int32),
                              np.asarray([r.prob for r in chunk],
                                         np.float64))
        with self._lock:
            self._replayed.add(version)
            self._replay_pending = None
        return True

    # -- regression rollback -------------------------------------------

    def _maybe_rollback(self) -> None:
        cfg = self.config
        if cfg.rollback_error_rate is None or self._controller is None:
            return
        with self._lock:
            if not self._promoted_versions:
                return
            version = self._promoted_versions[-1]
            if version in self._rollback_done:
                return
        if getattr(self._hotswap, "active_version", None) != version:
            return
        stats = self.store.error_by_version().get(str(version))
        if stats is None or stats["labeled"] < cfg.rollback_min_labeled:
            return
        if stats["error_rate"] <= cfg.rollback_error_rate:
            return
        parent = None
        try:
            parent = self._registry.get(version).manifest.get("parent")
        except Exception:  # noqa: BLE001
            pass
        if parent is None:
            return
        from fraud_detection_tpu_torch.utils.racecheck import RaceError

        try:
            self._controller.rollback(parent)
        except RaceError:
            return  # watcher mid-tick: retry next lane tick
        except Exception as e:  # noqa: BLE001 — audited failure, counted
            log.warning("regression rollback to v%04d failed: %s", parent, e)
            return
        with self._lock:
            self._rolled_back += 1
            self._rollback_done.add(version)
        log.warning("learn: promoted v%04d regressed (label error %.3f "
                    "over %d rows) — rolled back to v%04d",
                    version, stats["error_rate"], stats["labeled"], parent)

    # ------------------------------------------------------------------
    # observability / teardown
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``learn`` block of engine ``health()`` (the reference's
        keys)."""
        window = self.store.snapshot()
        labeled, errors = self.store.error_stats(
            last_n=self.config.error_window)
        with self._lock:
            snap = {
                "window": window,
                "queue_depth": self._queue.qsize(),
                "submitted": self._submitted,
                "dropped": self._dropped,
                "sampled_out": self._sampled_out,
                "encode_errors": self._encode_errors,
                "labels_polled": self._labels_polled,
                "triggered": self._triggered,
                "published": self._published,
                "failed": self._failed,
                "in_flight": self._in_flight,
                "promoted": self._promoted,
                "rejected": self._rejected,
                "rolled_back": self._rolled_back,
                "published_versions": list(self._published_versions),
                "last_trigger": self._last_trigger,
                "first_trigger_at_s": self._first_trigger_at,
                "promoted_at_s": self._promoted_at,
                "last_retrain_wall_s": (
                    round(self._last_retrain_wall, 3)
                    if self._last_retrain_wall is not None else None),
                "retrain_wall_s_total": round(self._retrain_wall_total, 3),
                "recent_error_rate": (round(errors / labeled, 6)
                                      if labeled else None),
                "primary_window_error_rate": (
                    round(self._primary_error, 6)
                    if self._primary_error is not None else None),
                "candidate_window_error_rate": (
                    round(self._candidate_error, 6)
                    if self._candidate_error is not None else None),
                "error_by_version": self.store.error_by_version(),
            }
        return snap

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until the scored-batch queue is empty (tests/teardown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._queue.unfinished_tasks == 0:
                return True
            time.sleep(0.01)
        return self._queue.unfinished_tasks == 0

    def close(self, timeout: float = 30.0) -> bool:
        """Drain (bounded) then stop the lane thread."""
        drained = self.drain(timeout)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(timeout, 30.0))
            return drained and not self._thread.is_alive()
        return drained
