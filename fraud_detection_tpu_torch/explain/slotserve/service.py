"""Slotserve: slot-based continuous-batching LLM serving for explanations —
twin of ``fraud_detection_tpu/explain/slotserve/service.py``.

The fixed-batch explain path (``OnPodBackend.generate_batch`` →
``models/llm.py generate_tokens_batch``) decodes a flagged batch behind ONE
barrier: every row pays device steps until the SLOWEST row finishes, the
batch pads up to a power-of-two bucket, and a row flagged while a batch is
in flight waits for the whole batch to drain. This module is the
iteration-level alternative (Orca, OSDI '22; slot/KV management in the
spirit of vLLM, SOSP '23):

* a fixed pool of **decode slots** over ONE persistent KV cache
  (``SlotDecoder``) — or, with ``paged=True``, over a flat pool of
  fixed-size KV pages and per-slot page tables (``PagedSlotDecoder``): the
  shared explain preamble is prefilled ONCE into refcounted read-only pages
  (copy-on-write on the partial page), and pool exhaustion preempts the
  newest admit as an accounted ``kv_pages_exhausted`` drop;
* a bounded **admission queue**: newly flagged rows admit into free slots at
  iteration boundaries, and overload drops the OLDEST queued request with
  honest accounting (``admitted == completed + dropped`` always);
* per-slot retirement: a row that hits EOS frees its slot at the next
  boundary and the next queued row takes it;
* one host read per decode window, B tokens wide.

Surfaces: the ``LLMBackend`` protocol (``chat``/``generate``/
``generate_batch``), so the service drops in anywhere ``OnPodBackend`` does
(behind the circuit breaker too, which forwards ``explain_rows``), and
:meth:`SlotServeService.explain_rows`. :func:`make_slot_explain_hook`
adapts it to the engine's ``explain_batch_fn`` shape.

Degradation contract: a decoder failure fails every in-flight and queued
request with :class:`~fraud_detection_tpu_torch.explain.backends.BackendError`
(the breaker counts it; the hook turns it into an ``[explanation
unavailable: ...]`` marker so flagged rows stay accounted in the
annotations topic) and the lane goes on serving. A fault of the card
(``utils/device.is_device_fault``) fails them the same way, then stops the
lane and sets ``fault``: later requests fail at once, and nothing retries
on the CPU. ``snapshot()`` is the engine's ``health()["explain"]`` block.
With a ``rowtrace`` (``obs.RowTracer``), every explained row's chain gains
an "explain" span with its slot, token count and admission wait, and every
dropped or failed row an ok=False event.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from fraud_detection_tpu_torch.explain.backends import (BackendError,
                                                        ChatMessage,
                                                        frame_prompt)
from fraud_detection_tpu_torch.explain.onpod import flatten_chat
from fraud_detection_tpu_torch.explain.prompts import (ANALYSIS_PREAMBLE,
                                                       analysis_prompt)
from fraud_detection_tpu_torch.explain.slotserve.decode import (
    PagedSlotDecoder, SlotDecoder)
from fraud_detection_tpu_torch.sched.sketch import LatencySketch
from fraud_detection_tpu_torch.utils import get_logger
from fraud_detection_tpu_torch.utils.device import is_device_fault

log = get_logger("explain.slotserve")

DROPPED_MARKER = "[explanation dropped: {reason}]"
UNAVAILABLE_MARKER = "[explanation unavailable: {reason}]"
# Prefills per scheduler iteration (the reference's default): bounded so
# admission never starves decode.
PREFILL_PER_ITER = 2


def shared_explain_prefix() -> str:
    """The template preamble every slotserve analysis prompt opens with:
    chat framing + system prompt + the analysis template's static first
    line, derived through the same ``flatten_chat``/``frame_prompt``/
    ``ANALYSIS_PREAMBLE`` pieces the serving paths use."""
    framed = flatten_chat(frame_prompt(ANALYSIS_PREAMBLE))
    return framed[: framed.index(ANALYSIS_PREAMBLE) + len(ANALYSIS_PREAMBLE)]


class _SlotRequest:
    """One admitted prompt's lifecycle record. Queue/result fields mutate
    under the service's condition; the ``done`` event is the completion
    latch every waiter blocks on."""

    __slots__ = ("tokens", "max_new", "temperature", "cid", "submitted_at",
                 "first_token_at", "out", "text", "dropped", "error", "done",
                 "slot")

    def __init__(self, tokens, max_new: int, temperature: float,
                 cid: Optional[str], submitted_at: float):
        self.tokens = tokens
        self.max_new = max_new
        self.temperature = temperature
        self.cid = cid
        self.submitted_at = submitted_at
        self.first_token_at: Optional[float] = None
        self.out: List[int] = []
        self.text: Optional[str] = None
        self.dropped: Optional[str] = None      # drop reason when dropped
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.slot: Optional[int] = None

    def wait(self, timeout: Optional[float]) -> str:
        """Block until the request resolves; returns the explanation text
        (a ``DROPPED_MARKER`` string when the queue dropped it), raises
        BackendError on decoder failure or timeout."""
        if not self.done.wait(timeout):
            raise BackendError(
                f"slotserve request timed out after {timeout:.1f}s")
        if self.error is not None:
            raise BackendError(
                f"slotserve decoder failed: {self.error!r}") from self.error
        if self.dropped is not None:
            return DROPPED_MARKER.format(reason=self.dropped)
        return self.text or ""


class SlotServeService:
    """Continuous-batching explanation service over one slot pool.

    ``lm``: a ``models/llm.py`` ``LanguageModel``. One worker thread
    ("slotserve-lane") owns the decoder; every public surface is callable
    from any thread.
    """

    def __init__(self, lm, *, slots: int = 8, max_queue: int = 1024,
                 max_new_tokens: int = 128, prompt_width: int = 384,
                 prompt_bucket: int = 64, decode_window: int = 16,
                 seed: int = 0, rowtrace=None, wait_timeout: float = 600.0,
                 paged: bool = False, kv_pages: Optional[int] = None,
                 shared_prefix: bool = True):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if decode_window < 1:
            raise ValueError(
                f"decode_window must be >= 1, got {decode_window}")
        if not paged and kv_pages is not None:
            raise ValueError("kv_pages is a paged-pool budget; pass "
                             "paged=True to use it")
        if paged:
            self._decoder = PagedSlotDecoder(lm, slots,
                                             prompt_width=prompt_width,
                                             max_new_tokens=max_new_tokens,
                                             prompt_bucket=prompt_bucket,
                                             total_pages=kv_pages)
            if shared_prefix:
                prefix = shared_explain_prefix()
                lp = len(lm.tokenizer.encode(prefix))
                n_prefix = -(-lp // self._decoder.page_size)
                fits = (lp < self._decoder.prompt_width
                        and self._decoder.total_pages
                        >= self._decoder.n_view + n_prefix)
                if fits:
                    self._decoder.set_prefix(prefix)
                else:
                    log.warning(
                        "shared explain prefix (%d tokens, %d pages) does "
                        "not fit prompt_width %d / pool %d; serving paged "
                        "WITHOUT prefix sharing", lp, n_prefix,
                        self._decoder.prompt_width,
                        self._decoder.total_pages)
        else:
            self._decoder = SlotDecoder(lm, slots,
                                        prompt_width=prompt_width,
                                        max_new_tokens=max_new_tokens,
                                        prompt_bucket=prompt_bucket)
        self.slots = slots
        self.max_queue = max_queue
        self.max_new_tokens = max_new_tokens
        # Admission granularity: free slots refill every `decode_window`
        # steps (rows retiring mid-window cost at most window-1 idle steps)
        # — the knob trading scheduling granularity against per-window
        # host overhead.
        self.decode_window = decode_window
        self.wait_timeout = wait_timeout
        self._clock = time.perf_counter
        self._seed = seed
        self._rowtrace = rowtrace
        # A fault of the card stops the lane (set once, by the worker).
        self.fault: Optional[BaseException] = None
        # --- worker-only slot state (never read off the lane thread) ---
        self._slot_req: List[Optional[_SlotRequest]] = [None] * slots
        self._lens = np.zeros(slots, np.int32)
        self._last_tok = np.full(slots, lm.cfg.EOS, np.int32)
        self._active_arr = np.zeros(slots, bool)
        self._temps = np.zeros(slots, np.float32)
        self._admit_seq = np.zeros(slots, np.int64)  # preemption order key
        self._retired: List[int] = []       # slots finished this iteration
        self._seq = 0                       # device-call counter (seeds)
        self._admits = 0                    # monotone admission counter
        # --- shared state (everything below lives under _cv) ---
        self._cv = threading.Condition()
        self._q: List[_SlotRequest] = []
        self._free = list(range(slots))
        self._busy = 0
        self._closed = False
        self._admitted = 0
        self._completed = 0
        self._dropped = 0
        self._errors = 0
        self._truncated = 0
        self._iterations = 0
        self._prefills = 0
        self._decode_steps = 0
        self._tokens_out = 0
        self._occ_sum = 0
        self._started_at: Optional[float] = None
        self._lat = LatencySketch()         # submit -> complete (sec)
        self._first = LatencySketch()       # submit -> first token (sec)
        self._decoder.warm(decode_window)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slotserve-lane")
        self._thread.start()

    # ------------------------------------------------------------------
    # submission (any thread)
    # ------------------------------------------------------------------

    def submit(self, prompt: str, *, max_tokens: Optional[int] = None,
               temperature: float = 0.0,
               cid: Optional[str] = None) -> _SlotRequest:
        """Enqueue one (already framed) prompt; never blocks. Over capacity
        the OLDEST queued request drops (counted; its ticket resolves to a
        ``DROPPED_MARKER``). After a fault of the card the request fails at
        once."""
        toks, truncated = self._decoder.encode_prompt(prompt)
        max_new = min(max_tokens or self.max_new_tokens, self.max_new_tokens)
        req = _SlotRequest(toks, max(1, max_new), temperature, cid,
                           self._clock())
        evicted: List[_SlotRequest] = []
        with self._cv:
            self._admitted += 1
            if truncated:
                self._truncated += 1
            if self._started_at is None:
                self._started_at = self._clock()
            if self.fault is not None:
                req.error = self.fault
                self._errors += 1
                self._dropped += 1
                evicted.append(req)
            elif self._closed:
                self._dropped += 1
                evicted.append(req)
                req.dropped = "closed"
            else:
                while len(self._q) >= self.max_queue:
                    old = self._q.pop(0)
                    old.dropped = "queue_overflow"
                    self._dropped += 1
                    evicted.append(old)
                self._q.append(req)
                self._cv.notify()
        for old in evicted:
            if self._rowtrace is not None and old.cid is not None:
                self._rowtrace.record_event(
                    old.cid, "explain", ok=False,
                    detail=(f"dropped:{old.dropped}" if old.error is None
                            else type(old.error).__name__))
            old.done.set()
        return req

    # ------------------------------------------------------------------
    # LLMBackend surface (+ explain_rows) — any thread, blocking
    # ------------------------------------------------------------------

    def chat(self, messages: Sequence[ChatMessage], *,
             temperature: float = 1.0, max_tokens: int = 1000) -> str:
        return self.submit(flatten_chat(messages), max_tokens=max_tokens,
                           temperature=temperature).wait(self.wait_timeout)

    def generate(self, prompt: str, *, temperature: float = 1.0,
                 max_tokens: int = 1000, system: Optional[str] = None) -> str:
        return self.chat(frame_prompt(prompt, system),
                         temperature=temperature, max_tokens=max_tokens)

    def generate_batch(self, prompts: Sequence[str], *,
                       temperature: float = 0.0,
                       max_tokens: int = 256) -> List[str]:
        """Positional batch interface (framing parity with
        ``OnPodBackend.generate_batch``): all prompts enter the admission
        queue at once and stream through the slots — FIFO admission, but
        completion order is per-row."""
        reqs = [self.submit(flatten_chat(frame_prompt(p)),
                            max_tokens=max_tokens, temperature=temperature)
                for p in prompts]
        return [r.wait(self.wait_timeout) for r in reqs]

    def explain_rows(self, texts: Sequence[str], labels: Sequence[int],
                     confs: Sequence[float], *,
                     cids: Optional[Sequence[Optional[str]]] = None,
                     temperature: float = 0.0,
                     max_tokens: int = 128) -> List[str]:
        """Explain flagged rows WITH their trace identity: each row's
        analysis prompt is built here (the same ``analysis_prompt`` +
        chat-template framing as every other path) and its cid rides into
        the slot, so the completed row's ``chain(cid)`` carries an
        "explain" span with slot and latency detail."""
        reqs = [self.submit(flatten_chat(frame_prompt(
                    analysis_prompt(text, label, conf))),
                    max_tokens=max_tokens, temperature=temperature,
                    cid=cids[i] if cids else None)
                for i, (text, label, conf) in enumerate(zip(texts, labels,
                                                            confs))]
        return [r.wait(self.wait_timeout) for r in reqs]

    # ------------------------------------------------------------------
    # the slot lane (one worker thread)
    # ------------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and self._busy == 0 and not self._closed:
                    self._cv.wait(timeout=0.2)
                if self._closed and not self._q and self._busy == 0:
                    return
            try:
                self._iteration()
            except Exception as e:  # noqa: BLE001 — lane must fail honestly
                if is_device_fault(e):
                    log.error("slotserve lane stopped on a device fault: %r",
                              e)
                    with self._cv:
                        self.fault = e
                        self._closed = True
                    self._fail_all(e)
                    return
                log.exception("slotserve iteration failed; failing all "
                              "in-flight and queued requests")
                self._fail_all(e)

    def _iteration(self) -> None:
        """One scheduler iteration: admissions land at the boundary FIRST
        (free slots fill before the pool advances), then one decode window
        moves every busy slot, then finished rows retire and free their
        slots for the next boundary."""
        self._admit_pending()
        self._decode_step()
        self._retire_done()
        with self._cv:
            self._iterations += 1

    def _admit_pending(self) -> None:
        """free → prefill: pop up to ``PREFILL_PER_ITER`` queued requests
        into free slots, prefill each prompt
        into its slot and emit the first sampled token."""
        grabbed: List[tuple] = []
        pages_planned = 0
        with self._cv:
            while (self._free and self._q
                   and len(grabbed) < PREFILL_PER_ITER):
                # Page-pool gate (paged decoder; contiguous needs 0 of 0):
                # stop admitting this boundary once the free pages can't
                # cover every grabbed prompt's table — decode retirements
                # free pages for the next boundary, so nothing deadlocks.
                need = self._decoder.pages_needed(self._q[0].tokens)
                if self._decoder.pages_free < pages_planned + need:
                    break
                pages_planned += need
                req = self._q.pop(0)
                slot = self._free.pop()
                self._busy += 1
                # Claim the slot HERE, before any device call: if a prefill
                # below dies, the failure sweep (_fail_all) must find every
                # grabbed request on its slot.
                self._slot_req[slot] = req
                req.slot = slot
                self._admits += 1
                self._admit_seq[slot] = self._admits
                grabbed.append((slot, req))
        for slot, req in grabbed:
            self._seq += 1
            first = self._decoder.prefill(slot, req.tokens, req.temperature,
                                          self._seed + self._seq)
            now = self._clock()
            req.first_token_at = now
            self._first.add(max(0.0, now - req.submitted_at))
            self._lens[slot] = len(req.tokens)
            self._last_tok[slot] = first
            self._temps[slot] = req.temperature
            self._active_arr[slot] = True
            with self._cv:
                self._prefills += 1
            self._emit(slot, first)

    def _decode_step(self) -> None:
        """prefill/decode → decode: one decode window for the whole pool.
        The host replays the device's freeze rule column by column, so each
        row's emission stream is exactly the single-step one."""
        busy_rows = np.flatnonzero(self._active_arr).tolist()
        if not busy_rows:
            return
        # Host side of the iteration boundary: every busy row's page table
        # must cover this window's writes BEFORE the program runs (paged
        # decoder; the contiguous one grows trivially).
        self._ensure_window_pages(busy_rows)
        busy_rows = np.flatnonzero(self._active_arr).tolist()
        if not busy_rows:
            return
        remaining = np.zeros(self.slots, np.int32)
        for slot in busy_rows:
            req = self._slot_req[slot]
            remaining[slot] = max(0, req.max_new - len(req.out))
        self._seq += 1
        out, new_lens, steps_run, n_act = self._decoder.step(
            self._last_tok, self._lens, self._active_arr, remaining,
            self._temps, self._seed + self._seq, self.decode_window)
        self._lens = new_lens
        with self._cv:
            self._decode_steps += steps_run
            self._occ_sum += n_act
        eos = self._decoder.cfg.EOS
        for slot in busy_rows:
            req = self._slot_req[slot]
            for tok in out[slot].tolist():
                req.out.append(tok)
                self._last_tok[slot] = tok
                if tok == eos or len(req.out) >= req.max_new:
                    self._active_arr[slot] = False
                    self._retired.append(slot)
                    break

    def _ensure_window_pages(self, busy_rows: List[int]) -> None:
        """Grow each busy slot's page table to cover ``lens +
        decode_window``. On pool exhaustion, preempt the NEWEST-admitted
        active slot (its waiter resolves to an accounted
        ``kv_pages_exhausted`` drop — among admitted rows the most recent
        yields) and retry; a preempted row's pages free immediately, so the
        pass terminates (the pool holds at least one worst-case row)."""
        for slot in busy_rows:
            while self._active_arr[slot] and not self._decoder.grow_for_window(
                    slot, int(self._lens[slot]), self.decode_window):
                victims = [s for s in busy_rows if self._active_arr[s]]
                victim = max(victims, key=lambda s: self._admit_seq[s])
                self._preempt(victim)

    def _preempt(self, slot: int) -> None:
        """Evict one in-flight row to reclaim its pages: accounted drop
        (``admitted == completed + dropped`` holds), waiter resolved with
        the drop marker, slot + pages released."""
        req = self._slot_req[slot]
        req.dropped = "kv_pages_exhausted"
        with self._cv:
            self._dropped += 1
        if self._rowtrace is not None and req.cid is not None:
            self._rowtrace.record_event(req.cid, "explain", ok=False,
                                        detail="dropped:kv_pages_exhausted")
        log.warning("page pool exhausted: preempting slot %d "
                    "(%d tokens emitted) to free its pages",
                    slot, len(req.out))
        self._release(slot)
        req.done.set()

    def _emit(self, slot: int, tok: int) -> None:
        """Record one prefill-emitted token; a row whose FIRST token is
        already terminal (EOS, or a 1-token budget) never enters the decode
        set — its slot frees at this very boundary."""
        req = self._slot_req[slot]
        req.out.append(tok)
        if tok == self._decoder.cfg.EOS or len(req.out) >= req.max_new:
            self._active_arr[slot] = False
            self._retired.append(slot)

    def _retire_done(self) -> None:
        """decode → drain → free: finalize every finished row (decode the
        text, resolve its waiter) BEFORE its slot returns to the free pool —
        a reader can never observe a freed slot whose row is unresolved."""
        retired, self._retired = self._retired, []
        for slot in retired:
            req = self._slot_req[slot]
            req.text = self._decoder.decode_text(req.out)
            dt = max(0.0, self._clock() - req.submitted_at)
            with self._cv:
                self._completed += 1
                self._tokens_out += len(req.out)
            self._lat.add(dt)
            tr = self._rowtrace
            if tr is not None and req.cid is not None:
                wait_ms = round(1e3 * max(0.0, (req.first_token_at or dt)
                                          - req.submitted_at), 2)
                tr.record_span(req.cid, "explain", dt,
                               detail=f"slot={slot} tokens={len(req.out)} "
                                      f"admit_ms={wait_ms}")
            req.done.set()
            self._release(slot)

    def _release(self, slot: int) -> None:
        # Pages first, slot second: a slot on the free list ALWAYS has an
        # empty page table.
        self._decoder.release_slot(slot)
        self._slot_req[slot] = None
        self._lens[slot] = 0
        self._last_tok[slot] = self._decoder.cfg.EOS
        self._active_arr[slot] = False
        with self._cv:
            self._busy -= 1
            self._free.append(slot)

    def _fail_all(self, exc: BaseException) -> None:
        """Decoder failure: resolve EVERY in-flight and queued request with
        the error (waiters raise BackendError — the breaker's food) and
        reset the pool."""
        failed: List[_SlotRequest] = []
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is not None:
                req.error = exc
                failed.append(req)
            self._slot_req[slot] = None
            self._lens[slot] = 0
            self._last_tok[slot] = self._decoder.cfg.EOS
            self._active_arr[slot] = False
        self._retired = []
        # The failed rows' page tables go with them — the allocator
        # identity must hold across the reset, not leak into the retry.
        self._decoder.reset_slots()
        with self._cv:
            drained, self._q = self._q, []
            for req in drained:
                req.error = exc
                failed.append(req)
            self._errors += len(failed)
            self._dropped += len(failed)
            self._busy = 0
            self._free = list(range(self.slots))
        for req in failed:
            if self._rowtrace is not None and req.cid is not None:
                self._rowtrace.record_event(req.cid, "explain", ok=False,
                                            detail=type(exc).__name__)
            req.done.set()

    def set_rowtrace(self, rowtrace) -> None:
        """Attach (or replace) the tracer completed rows report into — the
        serve CLI builds tracers after the service exists. A plain reference
        swap: the lane reads the current value per completion."""
        with self._cv:
            self._rowtrace = rowtrace

    # ------------------------------------------------------------------
    # lifecycle + observability (any thread)
    # ------------------------------------------------------------------

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until queue empty and every slot free (or timeout)."""
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            with self._cv:
                if not self._q and self._busy == 0:
                    return True
            time.sleep(0.005)
        return False

    def close(self, timeout: float = 60.0) -> bool:
        """Drain best-effort, then stop the lane. Residual queued requests
        resolve as dropped ("closed", counted); True = clean shutdown."""
        drained = self.drain(timeout)
        with self._cv:
            residual, self._q = self._q, []
            for req in residual:
                req.dropped = "closed"
            self._dropped += len(residual)
            self._closed = True
            self._cv.notify()
        for req in residual:
            req.done.set()
        self._thread.join(timeout=min(10.0, max(0.2, timeout)))
        if not self._thread.is_alive():
            # Quiescence: the lane is down, every slot released — return
            # every page (prefix base refs included). Leaks are recorded by
            # the decoder, not raised here.
            self._decoder.close()
        return drained and not residual and not self._thread.is_alive()

    def snapshot(self) -> dict:
        """The ``health()["explain"]`` block (the JAX service's keys)."""
        with self._cv:
            busy = self._busy
            queue_depth = len(self._q)
            admitted, completed = self._admitted, self._completed
            dropped, errors = self._dropped, self._errors
            truncated = self._truncated
            iterations, prefills = self._iterations, self._prefills
            decode_steps, tokens_out = self._decode_steps, self._tokens_out
            occ_sum, started = self._occ_sum, self._started_at
        lat_p50, lat_p99 = self._lat.quantile(0.50), self._lat.quantile(0.99)
        adm_p50 = self._first.quantile(0.50)
        adm_p99 = self._first.quantile(0.99)
        elapsed = (None if started is None
                   else max(1e-9, self._clock() - started))

        def ms(sec):
            return None if sec is None else round(sec * 1e3, 2)

        return {
            "slots": self.slots,
            "busy": busy,
            "free": self.slots - busy,
            "queue_depth": queue_depth,
            "admitted": admitted,
            "completed": completed,
            "dropped": dropped,
            "errors": errors,
            "truncated": truncated,
            "expl_per_s": (None if elapsed is None
                           else round(completed / elapsed, 2)),
            "latency_ms": {"p50": ms(lat_p50), "p99": ms(lat_p99)},
            "admit_to_first_token_ms": {"p50": ms(adm_p50),
                                        "p99": ms(adm_p99)},
            "occupancy": (round(occ_sum / (decode_steps * self.slots), 4)
                          if decode_steps else None),
            "iterations": iterations,
            "prefills": prefills,
            "decode_steps": decode_steps,
            "tokens_out": tokens_out,
            "kv_bytes": self._decoder.kv_bytes,
            # {device: bytes}: a head-sharded pool's part on each device
            "kv_bytes_per_device": dict(self._decoder.kv_bytes_per_device),
            # Paged-pool block (all-zero when the contiguous decoder runs —
            # the schema is mode-independent so pollers never branch).
            "kv_pages": self._decoder.kv_pages,
            "page_bytes": self._decoder.page_bytes,
            "pages_free": self._decoder.pages_free,
            "prefix_pages": self._decoder.prefix_pages,
            "prefix_hits": self._decoder.prefix_hits,
            "cow_copies": self._decoder.cow_copies,
            "kv_bytes_saved_vs_contiguous":
                self._decoder.kv_bytes_saved_vs_contiguous,
        }


def make_slot_explain_hook(backend, *, temperature: float = 0.0,
                           max_tokens: int = 128, only_scams: bool = True):
    """Build a ``StreamingClassifier.explain_batch_fn`` over a slotserve
    backend (the service itself, or a ``CircuitBreakerBackend`` wrapping it —
    the breaker forwards ``explain_rows``).

    Differences from ``make_stream_explain_hook``: (1) the hook advertises
    ``accepts_cids`` so the async annotation lane passes each row's trace id
    through, and (2) a backend failure (decoder death, breaker fast-fail)
    yields an ``[explanation unavailable: ...]`` MARKER per row instead of
    dropping the batch's annotations — every flagged row lands in the
    annotations topic explained or accounted, even mid-outage."""
    rows_fn = backend.explain_rows     # AttributeError now beats one later

    def explain_batch(texts, labels, confs, cids=None):
        picked = [i for i, lab in enumerate(labels)
                  if (lab != 0 or not only_scams)]
        out = [None] * len(texts)
        if not picked:
            return out
        try:
            replies = rows_fn(
                [texts[i] for i in picked],
                [labels[i] for i in picked],
                [confs[i] for i in picked],
                cids=([cids[i] for i in picked]
                      if cids is not None else None),
                temperature=temperature, max_tokens=max_tokens)
        except Exception as e:  # noqa: BLE001 — annotation only; accounted
            log.warning("slotserve backend failed for a %d-row batch: %r "
                        "(rows annotated with an unavailable marker)",
                        len(picked), e)
            replies = [UNAVAILABLE_MARKER.format(reason=type(e).__name__)
                       ] * len(picked)
        if len(replies) != len(picked):
            log.warning("slotserve backend returned %d analyses for %d "
                        "prompts; dropping the batch's annotations",
                        len(replies), len(picked))
            return out
        for i, reply in zip(picked, replies):
            out[i] = reply
        return out

    explain_batch.accepts_cids = True
    return explain_batch
