"""The host side of the pooled-slot decode programs (``models/llm.py``)
— twin of ``fraud_detection_tpu/explain/slotserve/decode.py``.

One :class:`SlotDecoder` owns ONE persistent KV pool — ``(slots, S, Hkv,
d)`` per layer, allocated once and updated in place; under tensor
parallelism with K/V heads the model axis divides, one ``(slots, S,
Hkv/n, d)`` part per model-axis device (``llm.init_cache(params=)``) — and
the two programs
that touch it: ``slot_prefill`` (admit one prompt into a free slot at an
iteration boundary) and ``slot_decode_window`` (advance every busy slot up
to a window of tokens, one host read). Prompt lengths round up to
``prompt_bucket`` multiples, the reference's compile ladder.

:class:`PagedSlotDecoder` is the PagedAttention-shaped alternative: the same
serving surface over a flat pool of fixed-size KV pages and a per-slot page
table, with an exact-accounting refcounted :class:`PageAllocator` and
shared-prefix caching — the explain template's preamble is prefilled ONCE
into refcounted read-only pages every slot's table points at, with
copy-on-write when an admit would append into a partially-filled shared
page. Both run the same window loop, so they are interchangeable behind
the service.

Device work runs on a CUDA stream of the decoder's own (``utils/device``
``lane_stream``/``on_lane``), beside the serving engine on the default
stream; the model's tensors are uploaded on the default stream and the
lane waits for them. A decoder is NOT thread-safe: the service's one worker
thread owns it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from fraud_detection_tpu_torch.models import llm
from fraud_detection_tpu_torch.utils.device import lane_stream, on_lane


class PagePoolExhausted(RuntimeError):
    """The page pool has no free page for a required alloc. Admission gates
    on :meth:`PagedSlotDecoder.can_admit`, so this surfaces mid-flight only
    on decode-window growth — the service preempts a slot and retries."""


class PageAllocator:
    """Exact-accounting refcounted page allocator (host-side, no locking —
    owned by the slot lane's single worker thread).

    Invariants (pinned by :meth:`check` and the property tests):
      * ``len(free) + pages_with_refs == total`` — every page is either on
        the free list or referenced, never both, never neither;
      * refcounts never go negative (double-free raises instead);
      * at quiescence (every slot released, prefix dropped) all pages are
        free — zero leaks.
    """

    def __init__(self, total: int):
        if total < 1:
            raise ValueError(f"page pool needs >= 1 page, got {total}")
        self.total = total
        # LIFO free list: recently-freed pages are re-used first (warm).
        self._free: List[int] = list(range(total - 1, -1, -1))
        self._refs = [0] * total

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.total - len(self._free)

    def refcount(self, pid: int) -> int:
        return self._refs[pid]

    def alloc(self) -> int:
        """Take a free page at refcount 1."""
        if not self._free:
            raise PagePoolExhausted(
                f"page pool exhausted ({self.total} pages, 0 free)")
        pid = self._free.pop()
        self._refs[pid] = 1
        return pid

    def retain(self, pid: int) -> None:
        """Add a reference to an allocated page (prefix sharing)."""
        if self._refs[pid] <= 0:
            raise ValueError(f"retain of unallocated page {pid}")
        self._refs[pid] += 1

    def release(self, pid: int) -> int:
        """Drop one reference; the page returns to the free list at zero.
        Releasing an unreferenced page is a hard error (double free)."""
        if self._refs[pid] <= 0:
            raise ValueError(f"double free of page {pid}")
        self._refs[pid] -= 1
        if self._refs[pid] == 0:
            self._free.append(pid)
        return self._refs[pid]

    def check(self) -> Dict[str, int]:
        """Verify the accounting identity; returns the counters for pinning.
        Raises AssertionError on any violation."""
        refd = sum(1 for r in self._refs if r > 0)
        if any(r < 0 for r in self._refs):
            raise AssertionError("negative refcount")
        if len(self._free) + refd != self.total:
            raise AssertionError(
                f"identity broken: free={len(self._free)} refd={refd} "
                f"total={self.total}")
        if len(set(self._free)) != len(self._free):
            raise AssertionError("free-list duplicate")
        if any(self._refs[p] for p in self._free):
            raise AssertionError("referenced page on the free list")
        return {"total": self.total, "free": len(self._free),
                "in_use": refd, "refs": sum(self._refs)}


def _geometry(lm, slots: int, prompt_width: int, max_new_tokens: int,
              prompt_bucket: int):
    """(bucketed prompt width, max_len) of a slot pool, validated against
    the model's ``max_seq``."""
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if prompt_bucket < 1:
        raise ValueError(f"prompt_bucket must be >= 1, got {prompt_bucket}")
    # Bucket the width itself so the widest prefill is a ladder rung.
    width = prompt_bucket * (-(-prompt_width // prompt_bucket))
    max_len = width + max_new_tokens
    if max_len > lm.cfg.max_seq:
        raise ValueError(
            f"slot cache needs {max_len} positions (prompt_width {width} + "
            f"max_new_tokens {max_new_tokens}) but cfg.max_seq is "
            f"{lm.cfg.max_seq}")
    return width, max_len


class _DecoderBase:
    """What both pools share: geometry, tokenizing, the lane stream."""

    def __init__(self, lm, slots: int, prompt_width: int, max_new_tokens: int,
                 prompt_bucket: int):
        self.prompt_width, self.max_len = _geometry(
            lm, slots, prompt_width, max_new_tokens, prompt_bucket)
        self.lm = lm
        self.cfg = lm.cfg
        self.slots = slots
        self.prompt_bucket = prompt_bucket
        self.max_new_tokens = max_new_tokens
        self.prefills = 0
        self.steps = 0
        self._stream = lane_stream(lm.device, {})

    def _bucket(self, n: int) -> int:
        return self.prompt_bucket * (-(-n // self.prompt_bucket))

    def encode_prompt(self, prompt: str):
        """Tokenize + truncate to the slot width (head kept: analysis
        prompts front-load the instruction). Returns ``(int32 tokens,
        truncated bool)`` — truncation is counted, never silent."""
        toks = self.lm.tokenizer.encode(prompt)
        truncated = len(toks) > self.prompt_width
        return np.asarray(toks[: self.prompt_width], np.int32), truncated

    def decode_text(self, tokens) -> str:
        return self.lm.tokenizer.decode(np.asarray(tokens, np.int32))

    def warm(self, steps: int, prompt: Optional[str] = None) -> None:
        """Run the decode window and the prefill bucket of ``prompt`` (the
        smallest bucket by default) once off the serving path (one
        throwaway row through slot 0), then return the slot (no residue)."""
        toks, _ = self.encode_prompt(prompt or "warm")
        self.prefill(0, toks, 0.0, 0)
        self.grow_for_window(0, len(toks), steps)
        lens = np.zeros(self.slots, np.int32)
        lens[0] = len(toks)
        active = np.zeros(self.slots, bool)
        active[0] = True
        self.step(np.full(self.slots, self.cfg.EOS, np.int32), lens, active,
                  np.ones(self.slots, np.int32),
                  np.zeros(self.slots, np.float32), 0, steps)
        self.release_slot(0)


class SlotDecoder(_DecoderBase):
    """One contiguous slot pool + its device programs."""

    def __init__(self, lm, slots: int, *, prompt_width: int = 384,
                 max_new_tokens: int = 128, prompt_bucket: int = 64):
        super().__init__(lm, slots, prompt_width, max_new_tokens,
                         prompt_bucket)
        self.cache = llm.init_cache(self.cfg, slots, self.max_len, lm.device,
                                    lm.params)
        self.kv_bytes_per_device = llm.kv_bytes_by_device(self.cache)
        self.kv_bytes = sum(self.kv_bytes_per_device.values())
        # Paged-pool stats surface (zero here: the whole region is a single
        # worst-case reservation). The service snapshot reads these
        # unconditionally so the health schema is mode-independent.
        self.kv_pages = 0
        self.page_bytes = 0
        self.prefix_pages = 0
        self.prefix_hits = 0
        self.cow_copies = 0
        self.kv_bytes_saved_vs_contiguous = 0

    @property
    def pages_free(self) -> int:
        return 0

    # -- paged-lifecycle surface (no-ops: the contiguous pool has nothing
    #    to allocate or free; a slot's region is overwritten on re-admit) --

    def pages_needed(self, prompt_tokens: np.ndarray) -> int:
        return 0

    def can_admit(self, prompt_tokens: np.ndarray) -> bool:
        return True

    def grow_for_window(self, slot: int, length: int, steps: int) -> bool:
        return True

    def release_slot(self, slot: int) -> None:
        pass

    def reset_slots(self) -> None:
        pass

    def close(self) -> None:
        pass

    def prefill(self, slot: int, prompt_tokens: np.ndarray,
                temperature: float, seed: int) -> int:
        """Admit one prompt into ``slot``; returns the FIRST sampled token
        (already part of the row's output)."""
        n = len(prompt_tokens)
        padded = np.zeros((1, self._bucket(n)), np.int32)
        padded[0, :n] = prompt_tokens
        with on_lane(self._stream):
            tok = llm.slot_prefill(self.lm.params, padded, n, self.cfg,
                                   self.cache, slot, temperature,
                                   seed & 0x7FFFFFFF)
        self.prefills += 1
        return tok

    def step(self, tokens: np.ndarray, lens: np.ndarray, active: np.ndarray,
             remaining: np.ndarray, temperatures: np.ndarray, seed: int,
             steps: int):
        """One decode window (up to ``steps`` iterations) over the whole
        pool; returns ``(out (B, steps) EOS-padded, new_lens, steps_run,
        active_row_steps)`` after ONE host read."""
        with on_lane(self._stream):
            out = llm.slot_decode_window(
                self.lm.params, tokens, lens, active, remaining, self.cfg,
                self.cache, temperatures, seed & 0x7FFFFFFF, int(steps))
        self.steps += 1
        return out


class PagedSlotDecoder(_DecoderBase):
    """The paged twin of :class:`SlotDecoder`: same serving surface, but the
    KV region is a flat pool of ``total_pages`` fixed-size pages indexed by
    a per-slot page table (PagedAttention applied to the slot pool).

    * **Admission** builds the slot's table — shared full prefix pages are
      retained, a partially-filled shared page is copied-on-write, the
      suffix gets fresh pages — then runs the suffix-only prefill program.
    * **Growth** happens at the host side of each iteration boundary:
      before a decode window every busy slot's table is extended to cover
      ``lens + window``; on pool exhaustion the SERVICE preempts a slot
      (accounted drop) and retries — the decoder only reports the failure.
    * **Release** returns every page reference the slot holds; the
      allocator identity (`PageAllocator.check`) holds at every boundary
      and all pages are free at quiescence.

    The decode window gathers the tables into the contiguous layout at the
    contiguous pool's width and runs the same loop as :class:`SlotDecoder`.
    """

    def __init__(self, lm, slots: int, *, prompt_width: int = 384,
                 max_new_tokens: int = 128, prompt_bucket: int = 64,
                 page_size: int = 64, total_pages: Optional[int] = None,
                 prefix_text: Optional[str] = None):
        if page_size < 1 or (page_size & (page_size - 1)):
            raise ValueError(
                f"page_size must be a power of two, got {page_size}")
        super().__init__(lm, slots, prompt_width, max_new_tokens,
                         prompt_bucket)
        self.page_size = page_size
        # Ceil: the last page may overhang max_len; the decode program
        # gathers exactly max_len positions (view_len).
        self.n_view = -(-self.max_len // page_size)
        total = slots * self.n_view if total_pages is None else total_pages
        if total < self.n_view:
            raise ValueError(
                f"total_pages {total} cannot hold even one worst-case row "
                f"({self.n_view} pages of {page_size})")
        self.total_pages = total
        self.pages = llm.init_kv_pages(self.cfg, total, page_size, lm.device,
                                       lm.params)
        self.allocator = PageAllocator(total)
        self._tables = np.zeros((slots, self.n_view), np.int32)
        self._cover = [0] * slots        # table entries resident per slot
        self._owned: List[List[int]] = [[] for _ in range(slots)]
        self._prefix_tokens: Optional[np.ndarray] = None
        self._prefix_len = 0
        self._prefix_pids: List[int] = []
        self.prefix_hits = 0
        self.cow_copies = 0
        self.leaked_pages = 0
        # One page's bytes across every layer/tensor array and part; the
        # pool's total (and per device); and the reservation the contiguous
        # layout would have made for the same slot count (the headline
        # saving).
        self.kv_bytes_per_device = llm.kv_bytes_by_device(self.pages)
        self.kv_bytes = sum(self.kv_bytes_per_device.values())
        per_pos = self.kv_bytes // (total * page_size)
        self.page_bytes = per_pos * page_size
        self.kv_bytes_saved_vs_contiguous = (
            per_pos * self.max_len * slots - self.kv_bytes)
        if prefix_text:
            self.set_prefix(prefix_text)

    # -- stats surface --------------------------------------------------

    @property
    def kv_pages(self) -> int:
        return self.total_pages

    @property
    def pages_free(self) -> int:
        return self.allocator.free

    @property
    def prefix_pages(self) -> int:
        return len(self._prefix_pids)

    def allocator_snapshot(self) -> Dict[str, int]:
        """Allocator counters after verifying the accounting identity,
        extended with the table-side view: every reference is held by
        exactly one table slot or the decoder's prefix base ref."""
        snap = self.allocator.check()
        snap["pages_in_tables"] = sum(self._cover)
        snap["prefix_base_refs"] = len(self._prefix_pids)
        if snap["refs"] != snap["pages_in_tables"] + snap["prefix_base_refs"]:
            raise AssertionError(f"ref ledger broken: {snap}")
        return snap

    # -- prefix caching --------------------------------------------------

    def set_prefix(self, prefix_text: str) -> None:
        """Prefill the shared preamble ONCE into read-only pages.

        The byte tokenizer is concatenation-safe (``encode(a + b)`` =
        ``[BOS] + bytes(a) + bytes(b)``), so a prompt shares the prefix iff
        its text starts with ``prefix_text`` — checked per admit at the
        token level. The prefix k/v come from the CONTIGUOUS prefill program
        at a bucket-aligned width, as the same positions of a full-prompt
        prefill would."""
        if self._prefix_pids:
            raise ValueError("prefix already set")
        toks = np.asarray(self.lm.tokenizer.encode(prefix_text), np.int32)
        lp = len(toks)
        if lp >= self.prompt_width:
            raise ValueError(
                f"shared prefix ({lp} tokens) must leave room for a "
                f"suffix inside prompt_width {self.prompt_width}")
        n_prefix = -(-lp // self.page_size)
        if self.total_pages < self.n_view + n_prefix:
            raise ValueError(
                f"total_pages {self.total_pages} cannot hold the prefix "
                f"({n_prefix} pages) plus one worst-case row "
                f"({self.n_view} pages) — raise the pool or drop sharing")
        padded = np.zeros((1, self._bucket(lp)), np.int32)
        padded[0, :lp] = toks
        pids = [self.allocator.alloc() for _ in range(n_prefix)]
        with on_lane(self._stream):
            tmp = llm.init_cache(self.cfg, 1, padded.shape[1], self.lm.device,
                                 self.lm.params)
            llm.slot_prefill(self.lm.params, padded, lp, self.cfg, tmp, 0,
                             0.0, 0)
            for j, pid in enumerate(pids):
                lo = j * self.page_size
                take = min(self.page_size, lp - lo)
                for name, arr in self.pages.items():
                    for part, src in zip(llm.kv_parts(arr),
                                         llm.kv_parts(tmp[name])):
                        part[pid, :take] = src[0, lo:lo + take]
        self._prefix_tokens = toks
        self._prefix_len = lp
        self._prefix_pids = pids

    def _split_prompt(self, prompt_tokens: np.ndarray):
        """(prefix_len, suffix) — prefix_len is 0 unless the prompt starts
        with the cached preamble AND extends past it."""
        lp = self._prefix_len
        if (lp and len(prompt_tokens) > lp
                and np.array_equal(prompt_tokens[:lp], self._prefix_tokens)):
            return lp, prompt_tokens[lp:]
        return 0, prompt_tokens

    # -- admission -------------------------------------------------------

    def pages_needed(self, prompt_tokens: np.ndarray) -> int:
        """Fresh pages an admit would ALLOCATE (retained shared pages are
        free-list-neutral; the COW copy is not)."""
        lp, suffix = self._split_prompt(prompt_tokens)
        cover = -(-(lp + self._bucket(len(suffix))) // self.page_size)
        return cover - lp // self.page_size

    def can_admit(self, prompt_tokens: np.ndarray) -> bool:
        return self.allocator.free >= self.pages_needed(prompt_tokens)

    def _cow_prefix_page(self, src: int) -> int:
        """Copy-on-write the partially-filled shared prefix page: the admit
        will append suffix k/v into it, and shared pages are never written
        — the slot gets a private device-side copy instead."""
        dst = self.allocator.alloc()
        with on_lane(self._stream):
            llm.copy_kv_page(self.pages, src, dst)
        self.cow_copies += 1
        return dst

    def _table_for_admit(self, slot: int, prefix_len: int,
                         cover: int) -> None:
        """Build the slot's page table for admission: retain the full
        shared prefix pages, COW the partial one, then allocate fresh
        suffix pages. All-or-nothing — a mid-build exhaustion releases
        every reference taken so far and re-raises."""
        row: List[int] = []
        n_full = prefix_len // self.page_size
        try:
            for pid in self._prefix_pids[:n_full]:
                self.allocator.retain(pid)
                row.append(pid)
            if prefix_len % self.page_size:
                row.append(self._cow_prefix_page(self._prefix_pids[n_full]))
            while len(row) < cover:
                row.append(self.allocator.alloc())
        except PagePoolExhausted:
            for pid in row:
                self.allocator.release(pid)
            raise
        self._tables[slot, :cover] = row
        self._cover[slot] = cover
        self._owned[slot] = row

    def prefill(self, slot: int, prompt_tokens: np.ndarray,
                temperature: float, seed: int) -> int:
        """Admit one prompt: build the slot's page table (alloc/retain/COW)
        FIRST, then run the suffix-only prefill program against it. Returns
        the first sampled token."""
        if self._cover[slot]:
            raise ValueError(f"slot {slot} admitted without release")
        n = len(prompt_tokens)
        lp, suffix = self._split_prompt(prompt_tokens)
        ts = self._bucket(len(suffix))
        cover = -(-(lp + ts) // self.page_size)
        self._table_for_admit(slot, lp, cover)
        padded = np.zeros((1, ts), np.int32)
        padded[0, :len(suffix)] = suffix
        with on_lane(self._stream):
            tok = llm.paged_slot_prefill(
                self.lm.params, padded, n, self.cfg, self.pages,
                self._tables[slot, :cover], temperature, seed & 0x7FFFFFFF,
                lp)
        self.prefills += 1
        if lp:
            self.prefix_hits += 1
        return tok

    # -- decode-window growth & release ----------------------------------

    def grow_for_window(self, slot: int, length: int, steps: int) -> bool:
        """Extend ``slot``'s table to cover ``length + steps`` positions
        (host side of the iteration boundary — the window program never
        sees a table that can't hold its writes). False on pool
        exhaustion: the caller preempts a slot and retries."""
        need = -(-min(length + steps, self.max_len) // self.page_size)
        while self._cover[slot] < need:
            try:
                pid = self.allocator.alloc()
            except PagePoolExhausted:
                return False
            self._tables[slot, self._cover[slot]] = pid
            self._cover[slot] += 1
            self._owned[slot].append(pid)
        return True

    def release_slot(self, slot: int) -> None:
        """Drop every page reference the slot holds (fresh, COW, and
        retained shared pages alike — the refcount keeps shared prefix
        pages alive for the other tables)."""
        for pid in self._owned[slot]:
            self.allocator.release(pid)
        self._owned[slot] = []
        self._cover[slot] = 0
        self._tables[slot, :] = 0

    def reset_slots(self) -> None:
        for slot in range(self.slots):
            if self._cover[slot]:
                self.release_slot(slot)

    def close(self) -> None:
        """Release everything (slots, then the prefix base refs) and record
        any leak — at quiescence every page must be back on the free
        list."""
        self.reset_slots()
        for pid in self._prefix_pids:
            self.allocator.release(pid)
        self._prefix_pids = []
        self._prefix_len = 0
        self._prefix_tokens = None
        self.leaked_pages = self.allocator.in_use

    # -- decode ----------------------------------------------------------

    def step(self, tokens: np.ndarray, lens: np.ndarray, active: np.ndarray,
             remaining: np.ndarray, temperatures: np.ndarray, seed: int,
             steps: int):
        """One decode window over the paged pool — the contract of
        :meth:`SlotDecoder.step`, and its output."""
        with on_lane(self._stream):
            out = llm.paged_decode_window(
                self.lm.params, tokens, lens, active, remaining, self.cfg,
                self.pages, self._tables, temperatures, seed & 0x7FFFFFFF,
                int(steps), self.max_len)
        self.steps += 1
        return out
