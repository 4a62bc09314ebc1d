"""An analyst's batch of flagged calls through the slot lane: a closed loop of
``outstanding`` analysis requests through ``SlotServeService.submit`` on
the paged pool with the shared explain prefix. A finished request is
replaced at once by the next of the mix.

The lane emits tokens in chunks, one decode window (16 steps, about 1.7 s
at this cell's size) at a time, so the window the rate is taken over runs
from the first decode window's return after the window opens to the last
one's before it closes: every token emitted between them (by those decode
windows and the prefills among them) over that time. Records for the
readers: that rate's count and time, the service's counters at both ends
(the K/V pages in use among them, logged beside the pool's reserve), and
the model operations of the prefill and decode tokens computed
between the window's open and close, from the benchmark's own lengths.
"""

from __future__ import annotations

import gc
import time
from typing import List

import numpy as np
import torch

import arith
import framing
import harness
import program
import served
import traffic_gen
import weights
from harness import Context, Profiler, Spans

POLL_S = 0.005


def instrument(svc, spans: Spans, marks: List[tuple]) -> None:
    """Around the lane's calls into the paged decoder: the profiler's spans,
    and a mark at each return (time, tokens emitted, a decode window?)."""
    dec = svc._decoder
    prefill, step = dec.prefill, dec.step

    def traced_prefill(*a, **k):
        with spans("slot.prefill"):
            tok = prefill(*a, **k)
        marks.append((time.perf_counter(), 1, False))
        return tok

    def traced_step(*a, **k):
        with spans("slot.window"):
            out = step(*a, **k)
        marks.append((time.perf_counter(), out[3], True))
        return out

    dec.prefill, dec.step = traced_prefill, traced_step


def emitted(marks: List[tuple], t0: float, t1: float):
    """(tokens, seconds) between the first decode window's return at or
    after ``t0`` and the last one's at or before ``t1``; (0, 0) where fewer
    than two decode windows returned in between."""
    ends = [t for t, _, window in marks if window and t0 <= t <= t1]
    if len(ends) < 2:
        return 0, 0.0
    a, b = ends[0], ends[-1]
    return sum(n for t, n, _ in marks if a < t <= b), b - a


class Ticket:
    __slots__ = ("req", "handle", "n_prompt", "out_open", "done_at")

    def __init__(self, req, handle, n_prompt):
        self.req, self.handle, self.n_prompt = req, handle, n_prompt
        self.out_open = 0
        self.done_at = None


def _suffix_buckets(reqs, width, bucket, cached):
    seen = {}
    for r in reqs:
        n = len(framing.tokens(r.prompt, width))
        b = bucket * (-(-(n - cached) // bucket))
        seen.setdefault(b, r)
    return list(seen.values())


def warm(svc, reqs, mix, cached: int) -> None:
    """One request per prefill bucket the mix uses, sampled and greedy, each
    long enough for a decode window."""
    picks = _suffix_buckets(reqs, mix["prompt_width"], mix["prompt_bucket"],
                            cached)
    handles = []
    for i, r in enumerate(picks + picks[:2]):
        handles.append(svc.submit(r.prompt, max_tokens=mix["decode_window"] + 2,
                                  temperature=(mix["temperature"] if i % 2
                                               else 0.0)))
    for h in handles:
        h.wait(600.0)
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run(ctx: Context) -> None:
    from fraud_detection_tpu_torch.explain.slotserve import SlotServeService

    mix, cfg = ctx.mix, ctx.cfg
    width = mix["prompt_width"]
    reqs = traffic_gen.explain_requests(mix, ctx.seed)
    lm = program.language_model(cfg, weights.model_leaves(cfg, ctx.seed,
                                                          ctx.device))
    svc = SlotServeService(
        lm, slots=mix["slots"], max_queue=mix["max_queue"],
        max_new_tokens=mix["max_new_tokens"], prompt_width=width,
        prompt_bucket=mix["prompt_bucket"], decode_window=mix["decode_window"],
        seed=ctx.seed & 0x7FFFFFFF, paged=True)
    cached = (len(framing.tokens(framing.shared_prefix(), width))
              if svc.snapshot()["prefix_pages"] else 0)
    ctx.log(f"service up: {svc.snapshot()['kv_bytes']} KV bytes, "
            f"prefix {cached} tokens")
    spans, marks = Spans(), []
    instrument(svc, spans, marks)
    warm(svc, reqs, mix, cached)
    ctx.log("warm")

    tickets: List[Ticket] = []
    outstanding: List[Ticket] = []
    nxt = 0

    def submit():
        nonlocal nxt
        r = reqs[nxt % len(reqs)]
        nxt += 1
        t = Ticket(r, svc.submit(r.prompt, max_tokens=r.max_tokens,
                                 temperature=r.temperature),
                   len(framing.tokens(r.prompt, width)))
        tickets.append(t)
        outstanding.append(t)

    def pump(until) -> None:
        """Replace finished requests until ``until()`` holds. The lane's
        launches can hold the interpreter for a whole decode window, so
        this thread runs at the lane's iteration boundaries."""
        while not until():
            time.sleep(POLL_S)
            for t in [t for t in outstanding if t.handle.done.is_set()]:
                t.done_at = time.perf_counter()
                outstanding.remove(t)
                submit()

    # the loop reaches its steady occupancy before the window opens
    for _ in range(mix["outstanding"]):
        submit()
    ramp_to = svc.snapshot()["iterations"] + mix["ramp_iterations"]
    pump(lambda: svc.snapshot()["iterations"] >= ramp_to)
    t0 = ctx.window_opens()
    ctx.log(f"window opens: {svc.snapshot()}")
    in_window = list(outstanding)
    for t in in_window:
        t.out_open = len(t.handle.out)
    first = len(tickets)
    snap0 = svc.snapshot()
    t_end = t0 + ctx.seconds
    pump(lambda: time.perf_counter() >= t_end)
    t1 = time.perf_counter()
    in_window += tickets[first:]
    out_close = {id(t): len(t.handle.out) for t in in_window}
    snap1 = svc.snapshot()
    ctx.read_memory_peak()
    ctx.log(f"window closed: {snap1}")
    # what the pool holds, against what it reserves (kv_bytes)
    in_use = [sn["kv_pages"] - sn["pages_free"] for sn in (snap0, snap1)]
    ctx.log(f"K/V pages in use at open, close: {in_use} of "
            f"{snap1['kv_pages']}, {[n * snap1['page_bytes'] for n in in_use]}"
            f" of {snap1['kv_bytes']} bytes")
    if ctx.trace:
        # the device's busy share over the same load, just past the window
        prof = Profiler(ctx.device, spans)
        prof.start()
        p_end = time.perf_counter() + mix["profile_seconds"]
        pump(lambda: time.perf_counter() >= p_end)
        ctx.rec["profile"] = prof.stop()
        ctx.log(f"profiled: {ctx.rec['profile']['kinds']}")

    # the lane's tail: queued requests drop as "closed", in-flight ones end
    svc.close(timeout=0.0)
    svc.close(timeout=120.0)

    finished = [t for t in in_window
                if t.done_at is not None and t0 <= t.done_at <= t1]
    failed = [t for t in finished
              if t.handle.error is not None or t.handle.dropped is not None]
    ctx.attempted, ctx.failed = len(finished), len(failed)
    flops = 0
    for t in in_window:
        end = out_close[id(t)]
        if t.out_open == 0 and end >= 1:
            flops += arith.prefill_flops(cfg, cached, t.n_prompt)
        flops += arith.decode_flops(cfg, t.n_prompt, t.out_open, end)
    tokens, seconds = emitted(marks, t0, t_end)
    ctx.rec.update(window_s=seconds, tokens=tokens, snap0=snap0, snap1=snap1,
                   flops=flops, flops_s=t1 - t0)

    greedy = [t for t in finished if t.req.temperature == 0.0
              and t.handle.error is None and t.handle.dropped is None]
    mismatched = sum(
        not np.array_equal(framing.tokens(t.req.prompt, width),
                           np.asarray(t.handle.tokens)) for t in greedy)
    items = served.sample(
        [(framing.tokens(t.req.prompt, width),
          np.asarray(t.handle.out, np.int32)) for t in greedy],
        ctx.seed, mix["check_tokens"], mix["check_requests"])
    del svc, lm, tickets, outstanding, in_window, finished
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    ctx.log(f"{len(items)} greedy requests to check")
    lim = harness.limits(ctx.cell["name"])
    ctx.check("failed_requests", ctx.failed, 0)
    ctx.check("prompt_token_mismatch", mismatched, 0)
    ctx.check("unchecked", 0 if items else 1, 0)
    if items:
        res = served.gaps(cfg, ctx.seed, ctx.device, items,
                          control=ctx.control)
        ctx.rec["served"] = res
        ctx.log(f"checked: {res}")
        ctx.check("served_logit_gap", res["gap"], lim["served_logit_gap"])
