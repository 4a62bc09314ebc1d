"""The port's paged KV pool, on the CPU — the counterpart of
``tests/test_paged_kv.py``.

* **bit-equality** — greedy decode through the paged pool (page-table
  gather/scatter + shared-prefix reuse + copy-on-write) emits exactly the
  contiguous slot pool's tokens, including after slot reuse;
* **exact accounting** — ``free + pages_with_refs == total`` and ``refs ==
  pages_in_tables + prefix_base_refs`` at every boundary, under queue
  overflow, close residue, decoder death and pool exhaustion; zero pages
  leaked at quiescence;
* **prefix sharing** — the explain preamble prefills ONCE into refcounted
  read-only pages; sharing admits are counted and the partial page is
  copied on write;
* **property** — any interleaving of admit/grow/release/death preserves
  the identity (a seeded sweep and Hypothesis).

``test_campaign_explain_paged_gameday_passes`` and
``test_gameday_validation_rejects_bad_paged_configs`` (``scenarios/gameday``)
are mirrored in ``tests/test_torch_gameday_lanes.py``
(``test_slot_lane_game_days_cover_every_flagged_row``, campaign_explain_paged)
and ``tests/test_torch_scenarios.py`` (``test_gameday_refusals_equal_jax``).
"""

import json

import numpy as np
import pytest

from fraud_detection_tpu_torch.app import serve as tserve
from fraud_detection_tpu_torch.explain.backends import (BackendError,
                                                        frame_prompt)
from fraud_detection_tpu_torch.explain.onpod import flatten_chat
from fraud_detection_tpu_torch.explain.prompts import analysis_prompt
from fraud_detection_tpu_torch.explain.slotserve import (DROPPED_MARKER,
                                                         SlotServeService)
from fraud_detection_tpu_torch.explain.slotserve.decode import (
    PagedSlotDecoder, PageAllocator, PagePoolExhausted)
from fraud_detection_tpu_torch.explain.slotserve.service import \
    shared_explain_prefix
from fraud_detection_tpu_torch.models import llm


@pytest.fixture(scope="module")
def lm():
    cfg = llm.TransformerConfig(d_model=64, n_layers=2, n_heads=4, d_ff=128,
                                max_seq=1024)
    return llm.LanguageModel.init_random(cfg, seed=3, device="cpu")


def make_service(lm, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_new_tokens", 24)
    kw.setdefault("prompt_width", 448)
    kw.setdefault("decode_window", 8)
    kw.setdefault("wait_timeout", 120.0)
    return SlotServeService(lm, **kw)


def analysis_prompts(n):
    """Framed analysis prompts — every one opens with the shared preamble,
    so paged admits hit the prefix cache."""
    out = []
    for i in range(n):
        d = ("Caller: this is your bank security department, read me the "
             "one-time code now or the account is frozen. "
             + "Customer hesitates. " * (i % 4))
        out.append(flatten_chat(frame_prompt(
            analysis_prompt(d, i % 2, 0.5 + 0.03 * i))))
    return out


def assert_quiescent(svc):
    """Paged decoder at quiescence after close(): identity + zero leaks."""
    dec = svc._decoder
    assert dec.leaked_pages == 0
    assert dec.allocator.free == dec.total_pages
    dec.allocator.check()


# ---------------------------------------------------------------------------
# allocator unit + property
# ---------------------------------------------------------------------------

def test_allocator_alloc_retain_release_identity():
    a = PageAllocator(4)
    p0, p1 = a.alloc(), a.alloc()
    a.retain(p0)
    assert a.refcount(p0) == 2 and a.refcount(p1) == 1
    assert a.free == 2 and a.in_use == 2
    assert a.release(p0) == 1
    assert a.in_use == 2            # still referenced once
    assert a.release(p0) == 0
    assert a.free == 3
    a.check()
    assert a.alloc() == p0          # LIFO: warm reuse


def test_allocator_double_free_and_exhaustion_raise():
    a = PageAllocator(1)
    pid = a.alloc()
    with pytest.raises(PagePoolExhausted):
        a.alloc()
    a.release(pid)
    with pytest.raises(ValueError, match="double free"):
        a.release(pid)
    with pytest.raises(ValueError, match="unallocated"):
        a.retain(pid)
    a.check()
    with pytest.raises(ValueError, match=">= 1 page"):
        PageAllocator(0)


def _allocator_interleaving(total, ops):
    """Drive one random op sequence; the identity must hold after EVERY op
    and everything must free cleanly at the end."""
    a = PageAllocator(total)
    held = []                        # [pid, refs_held]
    for op in ops:
        if op == 0:                  # alloc
            try:
                held.append([a.alloc(), 1])
            except PagePoolExhausted:
                pass
        elif op == 1 and held:       # retain (share)
            held[len(held) // 2][1] += 1
            a.retain(held[len(held) // 2][0])
        elif op == 2 and held:       # release one ref
            pid, refs = held.pop(0)
            a.release(pid)
            if refs > 1:
                held.insert(0, [pid, refs - 1])
        elif op == 3:                # decoder death: drop everything
            for pid, refs in held:
                for _ in range(refs):
                    a.release(pid)
            held = []
        a.check()
    for pid, refs in held:
        for _ in range(refs):
            a.release(pid)
    snap = a.check()
    assert snap["free"] == total and snap["in_use"] == 0


def test_allocator_property_seeded_interleavings():
    rng = np.random.default_rng(19)
    for _ in range(60):
        total = int(rng.integers(1, 12))
        ops = rng.integers(0, 4, size=int(rng.integers(1, 80))).tolist()
        _allocator_interleaving(total, ops)


def test_allocator_property_hypothesis():
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=80, deadline=None)
    @given(total=st.integers(1, 12),
           ops=st.lists(st.integers(0, 3), min_size=1, max_size=80))
    def prop(total, ops):
        _allocator_interleaving(total, ops)

    prop()


def test_allocator_check_catches_a_broken_ledger():
    a = PageAllocator(3)
    a.alloc()
    a._refs[1] = 1                   # a free page with a reference
    with pytest.raises(AssertionError, match="identity|free list"):
        a.check()


# ---------------------------------------------------------------------------
# geometry + admission math
# ---------------------------------------------------------------------------

def test_paged_geometry_validation(lm):
    with pytest.raises(ValueError, match="power of two"):
        PagedSlotDecoder(lm, 2, page_size=48)
    with pytest.raises(ValueError, match="worst-case row"):
        PagedSlotDecoder(lm, 2, prompt_width=128, max_new_tokens=64,
                         page_size=32, total_pages=2)


def test_set_prefix_validation(lm):
    dec = PagedSlotDecoder(lm, 2, prompt_width=128, max_new_tokens=32,
                           page_size=32)
    with pytest.raises(ValueError, match="leave room"):
        dec.set_prefix("x" * 400)
    dec.set_prefix("shared preamble\n")
    with pytest.raises(ValueError, match="already set"):
        dec.set_prefix("another")
    small = PagedSlotDecoder(lm, 2, prompt_width=128, max_new_tokens=32,
                             page_size=32, total_pages=5)
    with pytest.raises(ValueError, match="cannot hold the prefix"):
        small.set_prefix("x" * 40)


def test_pages_needed_counts_only_fresh_pages(lm):
    dec = PagedSlotDecoder(lm, 2, prompt_width=256, max_new_tokens=32,
                           page_size=32, prompt_bucket=32)
    prefix = "p" * 70                          # 71 tokens with BOS
    dec.set_prefix(prefix)
    lp = dec._prefix_len
    shared = np.asarray(dec.lm.tokenizer.encode(prefix + "tail " * 10),
                        np.int32)
    plain = np.asarray(dec.lm.tokenizer.encode("unrelated " * 12), np.int32)
    need_shared = dec.pages_needed(shared)
    need_plain = dec.pages_needed(plain)
    ts = dec.prompt_bucket * (-(-(len(shared) - lp) // dec.prompt_bucket))
    cover = -(-(lp + ts) // dec.page_size)
    assert need_shared == cover - lp // dec.page_size
    tp = dec.prompt_bucket * (-(-len(plain) // dec.prompt_bucket))
    assert need_plain == -(-tp // dec.page_size)
    assert need_shared < cover          # retained pages are free-list-neutral
    assert dec.can_admit(shared) and dec.can_admit(plain)


# ---------------------------------------------------------------------------
# bit-equality: paged vs contiguous through the full service
# ---------------------------------------------------------------------------

def test_paged_outputs_bit_equal_with_reuse_and_cow(lm):
    """10 analysis prompts through 4 slots: slot reuse, shared-prefix admits,
    copy-on-write on the partial preamble page — the replies must match the
    contiguous pool byte for byte (the view is gathered at max_len 472, not
    page-aligned, so this also pins the overhang)."""
    prompts = analysis_prompts(10)

    def serve(svc):
        reqs = [svc.submit(p, temperature=0.0) for p in prompts]
        return [r.wait(120.0) for r in reqs]

    contig = make_service(lm)
    try:
        want = serve(contig)
    finally:
        contig.close()
    paged = make_service(lm, paged=True)
    try:
        got = serve(paged)
        snap = paged.snapshot()
    finally:
        paged.close()
    assert got == want
    assert snap["prefix_hits"] == 10
    assert snap["cow_copies"] == 10          # 293-token preamble: partial page
    assert snap["prefix_pages"] == 5
    assert snap["admitted"] == snap["completed"] + snap["dropped"]
    assert_quiescent(paged)


def test_paged_without_prefix_still_bit_equal(lm):
    prompts = analysis_prompts(6)
    contig = make_service(lm, slots=2)
    try:
        want = contig.generate_batch(prompts, temperature=0.0)
    finally:
        contig.close()
    paged = make_service(lm, slots=2, paged=True,
                         shared_prefix=False)
    try:
        got = paged.generate_batch(prompts, temperature=0.0)
        snap = paged.snapshot()
    finally:
        paged.close()
    assert got == want
    assert snap["prefix_hits"] == 0 and snap["prefix_pages"] == 0
    assert_quiescent(paged)


def test_paged_sampled_decode_deterministic_per_seed(lm):
    p = analysis_prompts(2)
    outs = []
    for _ in range(2):
        svc = make_service(lm, slots=2, paged=True, seed=5)
        try:
            outs.append(svc.generate_batch(p, temperature=0.8, max_tokens=12))
        finally:
            svc.close()
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# accounting under overflow / close residue / decoder death / exhaustion
# ---------------------------------------------------------------------------

def test_paged_queue_overflow_accounting_and_no_leaks(lm):
    svc = make_service(lm, slots=1, max_queue=2, max_new_tokens=8,
                       paged=True)
    try:
        reqs = [svc.submit(p, max_tokens=8) for p in analysis_prompts(8)]
        texts = [r.wait(120.0) for r in reqs]
        assert any(t == DROPPED_MARKER.format(reason="queue_overflow")
                   for t in texts)
        snap = svc.snapshot()
        assert snap["admitted"] == snap["completed"] + snap["dropped"]
        svc._decoder.allocator_snapshot()
    finally:
        svc.close()
    assert_quiescent(svc)


def test_paged_close_residue_accounting_and_no_leaks(lm):
    svc = make_service(lm, slots=1, max_queue=64, paged=True)
    reqs = [svc.submit(p, max_tokens=24) for p in analysis_prompts(6)]
    svc.close(timeout=0.05)
    texts = [r.wait(120.0) for r in reqs]
    assert any(t == DROPPED_MARKER.format(reason="closed") for t in texts)
    snap = svc.snapshot()
    assert snap["admitted"] == snap["completed"] + snap["dropped"]
    assert_quiescent(svc)


def test_paged_decoder_death_releases_pages_then_recovers(lm):
    svc = make_service(lm, slots=2, paged=True)
    try:
        real_step = svc._decoder.step

        def boom(*a, **k):
            raise RuntimeError("device lost")

        svc._decoder.step = boom
        with pytest.raises(BackendError, match="decoder failed"):
            svc.generate_batch(analysis_prompts(1), max_tokens=8)
        snap = svc.snapshot()
        assert snap["admitted"] == snap["completed"] + snap["dropped"]
        # death released every slot's pages (prefix base refs remain)
        assert svc._decoder.allocator_snapshot()["pages_in_tables"] == 0
        svc._decoder.step = real_step
        out = svc.generate_batch(analysis_prompts(1), temperature=0.0,
                                 max_tokens=8)
        assert len(out) == 1 and isinstance(out[0], str)
    finally:
        svc.close()
    assert_quiescent(svc)


def test_pool_exhaustion_preempts_newest_admit(lm):
    """Growth exhaustion mid-window: the service preempts the NEWEST admit
    as an accounted ``kv_pages_exhausted`` drop and the survivors finish.
    Forced deterministically by denying growth for the last admit."""
    svc = make_service(lm, slots=2, paged=True,
                       shared_prefix=False)
    try:
        real_grow = svc._decoder.grow_for_window
        denied = {"armed": True}

        def grow(slot, length, steps):
            if denied["armed"] and svc._admit_seq[slot] == 2:
                denied["armed"] = False
                return False
            return real_grow(slot, length, steps)

        svc._decoder.grow_for_window = grow
        reqs = [svc.submit(p, max_tokens=16) for p in analysis_prompts(2)]
        texts = [r.wait(120.0) for r in reqs]
        marker = DROPPED_MARKER.format(reason="kv_pages_exhausted")
        assert texts.count(marker) == 1
        assert texts[0] != marker      # oldest admit survives
        snap = svc.snapshot()
        assert snap["dropped"] == 1
        assert snap["admitted"] == snap["completed"] + snap["dropped"]
        svc._decoder.allocator_snapshot()
    finally:
        svc.close()
    assert_quiescent(svc)


def test_grow_for_window_reports_real_exhaustion(lm):
    dec = PagedSlotDecoder(lm, 2, prompt_width=64, max_new_tokens=64,
                           page_size=32, prompt_bucket=64, total_pages=4)
    toks = np.asarray(dec.lm.tokenizer.encode("a" * 40), np.int32)
    dec.prefill(0, toks, 0.0, 0)       # 2 pages (64-token bucket)
    dec.prefill(1, toks, 0.0, 0)       # 2 pages — pool now empty
    assert dec.pages_free == 0
    assert dec.grow_for_window(0, 64, 8) is False
    with pytest.raises(ValueError, match="without release"):
        dec.prefill(1, toks, 0.0, 0)
    dec.release_slot(1)
    assert dec.grow_for_window(0, 64, 8) is True
    dec.release_slot(0)
    dec.close()
    assert dec.leaked_pages == 0


def test_admit_exhaustion_is_all_or_nothing(lm):
    """A table build that runs out of pages mid-way releases every
    reference it took (the retained prefix pages included)."""
    dec = PagedSlotDecoder(lm, 1, prompt_width=128, max_new_tokens=32,
                           page_size=32, prompt_bucket=32, total_pages=7)
    dec.set_prefix("p" * 40)                   # 41 tokens: 2 pages
    toks = np.asarray(dec.lm.tokenizer.encode("p" * 40 + "q" * 80),
                      np.int32)
    hog = [dec.allocator.alloc() for _ in range(2)]
    before = dec.allocator.check()
    with pytest.raises(PagePoolExhausted):
        dec.prefill(0, toks, 0.0, 0)
    assert dec.allocator.check() == before and dec._cover == [0]
    for pid in hog:
        dec.allocator.release(pid)
    assert dec.allocator_snapshot()["pages_in_tables"] == 0


# ---------------------------------------------------------------------------
# snapshot surface
# ---------------------------------------------------------------------------

def test_snapshot_paged_block_values(lm):
    contig = make_service(lm, slots=2)
    try:
        snap = contig.snapshot()
        assert snap["kv_pages"] == 0 and snap["page_bytes"] == 0
        assert snap["pages_free"] == 0 and snap["prefix_pages"] == 0
        assert snap["kv_bytes_saved_vs_contiguous"] == 0
    finally:
        contig.close()
    paged = make_service(lm, slots=2, paged=True, kv_pages=13)
    try:
        snap = paged.snapshot()
        assert snap["kv_pages"] == 13
        assert snap["page_bytes"] > 0
        assert snap["prefix_pages"] == 5
        assert snap["kv_bytes_saved_vs_contiguous"] > 0
        reqs = [paged.submit(p, temperature=0.0, max_tokens=8)
                for p in analysis_prompts(3)]
        got = [r.wait(120.0) for r in reqs]
        assert all(isinstance(t, str) for t in got)
        assert paged.snapshot()["prefix_hits"] == 3
    finally:
        paged.close()
    assert_quiescent(paged)


def test_shared_prefix_matches_analysis_prompts(lm):
    pre = shared_explain_prefix()
    toks_pre = np.asarray(lm.tokenizer.encode(pre))
    for p in analysis_prompts(3):
        assert p.startswith(pre)
        toks = np.asarray(lm.tokenizer.encode(p))
        assert np.array_equal(toks[:len(toks_pre)], toks_pre)


def test_shared_prefix_equals_jax():
    from fraud_detection_tpu.explain.slotserve.service import (
        shared_explain_prefix as jax_prefix)

    assert shared_explain_prefix() == jax_prefix()


# ---------------------------------------------------------------------------
# serve CLI: --explain-paged / --explain-kv-pages
# ---------------------------------------------------------------------------

def test_serve_cli_explain_paged_e2e(capsys):
    # prompt_width 384 + 8 new tokens -> max_len 392 -> 7 view pages; the
    # ~293-token preamble is 5 pages: 12 pages hold prefix + both slots.
    rc = tserve.main(["--device", "cpu", "--model", "synthetic", "--demo",
                      "120", "--batch-size", "64", "--max-wait", "0.01",
                      "--explain", "onpod-demo", "--explain-slots", "2",
                      "--explain-tokens", "8", "--explain-paged",
                      "--explain-kv-pages", "12"])
    assert rc == 0
    out = capsys.readouterr().out
    stats = json.loads([l for l in out.splitlines()
                        if l.startswith("{")][0])
    snap = stats["explain"]
    assert snap["slots"] == 2
    assert snap["admitted"] == snap["completed"] + snap["dropped"]
    assert snap["completed"] > 0
    assert snap["kv_pages"] == 12 and snap["page_bytes"] > 0
    assert snap["prefix_hits"] == snap["admitted"]
    assert snap["kv_bytes_saved_vs_contiguous"] > 0
    assert stats["health"]["explain"]["kv_pages"] == 12


def test_serve_cli_explain_paged_validation():
    with pytest.raises(SystemExit, match="needs --explain-slots"):
        tserve.main(["--device", "cpu", "--model", "synthetic", "--demo",
                     "10", "--explain", "onpod-demo", "--explain-paged"])
    with pytest.raises(SystemExit, match="set --explain-paged"):
        tserve.main(["--device", "cpu", "--model", "synthetic", "--demo",
                     "10", "--explain", "onpod-demo", "--explain-slots", "2",
                     "--explain-kv-pages", "32"])
    with pytest.raises(SystemExit, match="explain-kv-pages must be"):
        tserve.main(["--device", "cpu", "--model", "synthetic", "--demo",
                     "10", "--explain", "onpod-demo", "--explain-slots", "2",
                     "--explain-paged", "--explain-kv-pages", "-1"])
