"""The port's slot and paged decode programs against the JAX package's, on the
CPU.

The same weights (``tests/torch_parity.port_llm``) go through the JAX
``slot_prefill`` / ``slot_decode_window`` / ``paged_slot_prefill`` /
``paged_decode_window`` and the port's, on the same prompts, slots, lens,
active rows, budgets, per-row temperatures and seeds, in two consecutive
windows (the second continues the first under the host's freeze rule):

* first tokens, ``out``, ``new_lens``, ``steps_run`` and
  ``active_row_steps`` are EQUAL, greedy and sampled (seeds 0-2, rows at
  temperatures 0, 0.7 and 1.0: the port draws JAX's threefry noise at the
  reference's keys; its Gumbel logs round as torch's do, within a float32
  epsilon of max(1, |g|) — Queue 3 item 2's residual — so a draw could
  flip only on a near-tie, which these seeds do not hit);
* the caches agree within ``CACHE_TOL`` on each row's valid region
  ``[0, new_lens)``;
* the paged programs (a shared prefix in read-only pages, a copy-on-write
  admit, a plain admit) give the contiguous programs' results bit for bit,
  and the scatter-back writes exactly the positions the window wrote.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fraud_detection_tpu.models import llm as jllm
from fraud_detection_tpu_torch.models import llm
from tests.test_torch_llm import CFG, GEMMA, _jinit
from tests.torch_parity import port_llm

SLOTS, S, BUCKET, STEPS, PAGE, NUM_PAGES = 4, 128, 16, 8, 16, 24
CACHE_TOL = 1e-5
PREFIX = "<|system|>\nYou are a fraud analyst.\n"
# (slot, prompt): slot 2 stays free; two prompts share PREFIX.
ROWS = ((0, PREFIX + "Caller: this is your bank, read me the code."),
        (1, "hi"),
        (3, PREFIX + "Agent: your parcel is held; pay the fee today in "
                     "gift cards."))
ACTIVE = np.asarray([True, True, False, True])
BUDGET = np.asarray([6, 12, 0, 3], np.int32)
GREEDY = np.zeros(SLOTS, np.float32)
MIXED = np.asarray([0.0, 1.0, 0.0, 0.7], np.float32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, cfg, seed in (("base", CFG, 0), ("gemma", GEMMA, 1)):
        jlm = jllm.LanguageModel(cfg, _jinit(jax.random.PRNGKey(seed), cfg))
        out[name] = (jlm, port_llm(jlm))
    return out


def _bucket(n):
    return BUCKET * -(-n // BUCKET)


def _padded(toks):
    pad = np.zeros((1, _bucket(len(toks))), np.int32)
    pad[0, :len(toks)] = toks
    return pad


def _next_window(res, tokens, lens, active, remaining):
    """The host's freeze rule between windows: each row's last emitted
    token, its new length, whether it is still active, its budget left."""
    out, new_lens = res[0], res[1]
    emitted = new_lens - lens
    tokens, active, remaining = tokens.copy(), active.copy(), remaining.copy()
    for b in np.flatnonzero(emitted > 0):
        tokens[b] = out[b, emitted[b] - 1]
        remaining[b] -= emitted[b]
        active[b] = active[b] and tokens[b] != CFG.EOS and remaining[b] > 0
    return tokens, new_lens, active, remaining


def _windows(step, firsts, lens, temps):
    """Two consecutive windows through ``step(tokens, lens, active,
    remaining, seed)``; returns both results as host arrays."""
    tokens = np.full(SLOTS, CFG.EOS, np.int32)
    for (slot, _), tok in zip(ROWS, firsts):
        tokens[slot] = tok
    state = (tokens, lens, ACTIVE.copy(), BUDGET.copy())
    results = []
    for w in range(2):
        res = tuple(np.asarray(r) for r in step(*state, w))
        results.append(res)
        state = _next_window(res, *state)
    return results


def _jax_contiguous(jlm, temps, seed):
    cfg, params = jlm.cfg, jlm.params
    cache = jllm.init_cache(cfg, SLOTS, S)
    firsts, lens = [], np.zeros(SLOTS, np.int32)
    for slot, text in ROWS:
        toks = jlm.tokenizer.encode(text)
        tok, cache = jllm.slot_prefill(
            params, jnp.asarray(_padded(toks)), jnp.int32(len(toks)), cfg,
            cache, jnp.int32(slot), jnp.float32(temps[slot]),
            jax.random.PRNGKey(seed + slot))
        firsts.append(int(tok))
        lens[slot] = len(toks)
    box = {"cache": cache}

    def step(tokens, lens_, active, remaining, w):
        *res, box["cache"] = jllm.slot_decode_window(
            params, jnp.asarray(tokens), jnp.asarray(lens_),
            jnp.asarray(active), jnp.asarray(remaining), cfg, box["cache"],
            jnp.asarray(temps), jax.random.PRNGKey(seed + 10 + w), STEPS)
        return res

    results = _windows(step, firsts, lens, temps)
    return firsts, results, {k: np.asarray(v) for k, v in box["cache"].items()}


def _port_contiguous(plm, temps, seed):
    cfg, params = plm.cfg, plm.params
    cache = llm.init_cache(cfg, SLOTS, S, "cpu")
    firsts, lens = [], np.zeros(SLOTS, np.int32)
    for slot, text in ROWS:
        toks = plm.tokenizer.encode(text)
        firsts.append(llm.slot_prefill(params, _padded(toks), len(toks), cfg,
                                       cache, slot, float(temps[slot]),
                                       seed + slot))
        lens[slot] = len(toks)

    def step(tokens, lens_, active, remaining, w):
        return llm.slot_decode_window(params, tokens, lens_, active,
                                      remaining, cfg, cache, temps,
                                      seed + 10 + w, STEPS)

    results = _windows(step, firsts, lens, temps)
    return firsts, results, {k: v.numpy() for k, v in cache.items()}


class _Paged:
    """One framework's paged pool driven the way ``PagedSlotDecoder`` does:
    PREFIX prefilled once by the contiguous program into read-only pages
    0-2, a copy-on-write of its partial page per sharing admit, fresh pages
    from 3 up, tables grown before each window. ``fw`` adapts the four
    programs."""

    def __init__(self, lm, fw, temps, seed):
        self.lm, self.fw, self.temps, self.seed = lm, fw, temps, seed
        self.prefix = np.asarray(lm.tokenizer.encode(PREFIX), np.int32)
        lp = len(self.prefix)
        self.pages = fw.init_pages(NUM_PAGES)
        fw.fill_prefix(self.pages, self.prefix, -(-lp // PAGE))
        self.next_free = -(-lp // PAGE)
        self.tables = np.zeros((SLOTS, S // PAGE), np.int32)
        self.cover = np.zeros(SLOTS, int)

    def alloc(self):
        self.next_free += 1
        return self.next_free - 1

    def prefill(self, slot, toks):
        lp = len(self.prefix)
        shared = len(toks) > lp and np.array_equal(toks[:lp], self.prefix)
        lp = lp if shared else 0
        suffix = toks[lp:]
        cover = -(-(lp + _bucket(len(suffix))) // PAGE)
        row = list(range(lp // PAGE))               # retained full pages
        if lp % PAGE:
            dst = self.alloc()
            self.fw.copy_page(self.pages, lp // PAGE, dst)
            row.append(dst)
        while len(row) < cover:
            row.append(self.alloc())
        self.tables[slot, :cover] = row
        self.cover[slot] = cover
        return self.fw.prefill(self.pages, _padded(suffix), len(toks),
                               self.tables[slot, :cover],
                               float(self.temps[slot]), self.seed + slot, lp)

    def run(self):
        firsts, lens = [], np.zeros(SLOTS, np.int32)
        for slot, text in ROWS:
            toks = np.asarray(self.lm.tokenizer.encode(text), np.int32)
            firsts.append(self.prefill(slot, toks))
            lens[slot] = len(toks)

        def step(tokens, lens_, active, remaining, w):
            for slot in np.flatnonzero(active):
                need = -(-min(lens_[slot] + STEPS, S) // PAGE)
                while self.cover[slot] < need:
                    self.tables[slot, self.cover[slot]] = self.alloc()
                    self.cover[slot] += 1
            return self.fw.window(self.pages, self.tables, tokens, lens_,
                                  active, remaining, self.temps,
                                  self.seed + 10 + w)

        return firsts, _windows(step, firsts, lens, self.temps)


class _JaxPaged:
    def __init__(self, jlm):
        self.jlm = jlm

    def init_pages(self, n):
        return {"p": jllm.init_kv_pages(self.jlm.cfg, n, PAGE)}

    def fill_prefix(self, box, prefix, n_pages):
        cfg = self.jlm.cfg
        tmp = jllm.init_cache(cfg, 1, _bucket(len(prefix)))
        _, tmp = jllm.slot_prefill(
            self.jlm.params, jnp.asarray(_padded(prefix)),
            jnp.int32(len(prefix)), cfg, tmp, jnp.int32(0), jnp.float32(0.0),
            jax.random.PRNGKey(0))
        for j in range(n_pages):
            take = min(PAGE, len(prefix) - j * PAGE)
            for name in box["p"]:
                rows = tmp[name][0, j * PAGE:j * PAGE + take]
                box["p"][name] = box["p"][name].at[j, :take].set(rows)

    def copy_page(self, box, src, dst):
        box["p"] = jllm.copy_kv_page(box["p"], jnp.int32(src), jnp.int32(dst))

    def prefill(self, box, padded, n, table_row, temp, seed, lp):
        tok, box["p"] = jllm.paged_slot_prefill(
            self.jlm.params, jnp.asarray(padded), jnp.int32(n), self.jlm.cfg,
            box["p"], jnp.asarray(table_row), jnp.float32(temp),
            jax.random.PRNGKey(seed), lp)
        return int(tok)

    def window(self, box, tables, tokens, lens, active, remaining, temps,
               seed):
        *res, box["p"] = jllm.paged_decode_window(
            self.jlm.params, jnp.asarray(tokens), jnp.asarray(lens),
            jnp.asarray(active), jnp.asarray(remaining), self.jlm.cfg,
            box["p"], jnp.asarray(tables), jnp.asarray(temps),
            jax.random.PRNGKey(seed), STEPS, S)
        return res


class _PortPaged:
    def __init__(self, plm):
        self.plm = plm

    def init_pages(self, n):
        return {"p": llm.init_kv_pages(self.plm.cfg, n, PAGE, "cpu")}

    def fill_prefix(self, box, prefix, n_pages):
        cfg = self.plm.cfg
        tmp = llm.init_cache(cfg, 1, _bucket(len(prefix)), "cpu")
        llm.slot_prefill(self.plm.params, _padded(prefix), len(prefix), cfg,
                         tmp, 0, 0.0, 0)
        for j in range(n_pages):
            take = min(PAGE, len(prefix) - j * PAGE)
            for name, arr in box["p"].items():
                arr[j, :take] = tmp[name][0, j * PAGE:j * PAGE + take]

    def copy_page(self, box, src, dst):
        llm.copy_kv_page(box["p"], src, dst)

    def prefill(self, box, padded, n, table_row, temp, seed, lp):
        return llm.paged_slot_prefill(self.plm.params, padded, n,
                                      self.plm.cfg, box["p"], table_row,
                                      temp, seed, lp)

    def window(self, box, tables, tokens, lens, active, remaining, temps,
               seed):
        return llm.paged_decode_window(self.plm.params, tokens, lens, active,
                                       remaining, self.plm.cfg, box["p"],
                                       tables, temps, seed, STEPS, S)


def _assert_windows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])     # out
        np.testing.assert_array_equal(g[1], w[1])     # new_lens
        assert int(g[2]) == int(w[2])                 # steps_run
        assert int(g[3]) == int(w[3])                 # active_row_steps


def _assert_caches_close(got, want, new_lens):
    for name in want:
        for b in range(SLOTS):
            n = int(new_lens[b])
            np.testing.assert_allclose(got[name][b, :n], want[name][b, :n],
                                       atol=CACHE_TOL, rtol=CACHE_TOL,
                                       err_msg=f"{name} row {b}")


@pytest.fixture(scope="module")
def contiguous(models):
    """Greedy JAX and port runs of both models, computed once."""
    return {name: (_jax_contiguous(jlm, GREEDY, 0),
                   _port_contiguous(plm, GREEDY, 0))
            for name, (jlm, plm) in models.items()}


@pytest.mark.parametrize("name", ["base", "gemma"])
def test_greedy_slot_programs_equal_jax(contiguous, name):
    (jf, jres, jcache), (pf, pres, pcache) = contiguous[name]
    assert pf == jf                                   # first tokens
    _assert_windows_equal(pres, jres)
    assert int(pres[0][2]) == STEPS and pres[0][3] > 0
    _assert_caches_close(pcache, jcache, pres[-1][1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sampled_slot_programs_equal_jax(models, seed):
    jlm, plm = models["base"]
    jf, jres, _ = _jax_contiguous(jlm, MIXED, seed)
    pf, pres, _ = _port_contiguous(plm, MIXED, seed)
    assert pf == jf
    _assert_windows_equal(pres, jres)


def test_freeze_rule_counts_on_the_device(contiguous):
    """Row 3's budget of 3 freezes it at column 3 of window 1 (EOS after);
    free slot 2 emits EOS throughout; steps_run counts only steps in which
    a row was active, active_row_steps every (row, step) pair."""
    _, (_, res, _) = contiguous["base"]
    out, new_lens, steps_run, row_steps = res[0]
    eos = CFG.EOS
    assert (out[2] == eos).all()
    assert (out[3, 3:] == eos).all()
    emitted = [int(new_lens[b]) - len(jllm.ByteTokenizer(CFG).encode(t))
               for b, t in ((s, t) for s, t in ROWS)]
    assert row_steps == sum(emitted)
    assert steps_run == max(emitted)


@pytest.fixture(scope="module")
def paged(models, contiguous):
    out = {}
    for name, (jlm, plm) in models.items():
        jp = _Paged(jlm, _JaxPaged(jlm), GREEDY, 0)
        pp = _Paged(plm, _PortPaged(plm), GREEDY, 0)
        out[name] = (jp.run(), jp, pp.run(), pp)
    return out


@pytest.mark.parametrize("name", ["base", "gemma"])
def test_paged_programs_equal_jax(paged, name):
    (jf, jres), jp, (pf, pres), pp = paged[name]
    assert pf == jf
    _assert_windows_equal(pres, jres)
    # every row's resident positions, gathered through its table
    new_lens = pres[-1][1]
    for b in range(SLOTS):
        n = int(new_lens[b])
        pids, offs = pp.tables[b, np.arange(n) // PAGE], np.arange(n) % PAGE
        for layer_name, arr in pp.pages["p"].items():
            np.testing.assert_allclose(
                arr.numpy()[pids, offs],
                np.asarray(jp.pages["p"][layer_name])[pids, offs],
                atol=CACHE_TOL, rtol=CACHE_TOL, err_msg=f"{layer_name} row {b}")


@pytest.mark.parametrize("name", ["base", "gemma"])
def test_paged_equals_contiguous_bit_for_bit(paged, contiguous, name):
    _, _, (pf, pres), pp = paged[name]
    _, (cf, cres, _) = contiguous[name]
    assert pf == cf
    _assert_windows_equal(pres, cres)
    assert pp.next_free > 3 + 2        # two copy-on-write admits happened


def test_paged_scatter_back_writes_only_the_window(models):
    """Every page byte outside the positions the window wrote
    ([lens, new_lens) of each row, through its table) is unchanged: free
    pages, frozen rows' in-window garbage and the read-only prefix pages."""
    _, plm = models["gemma"]
    fw = _PortPaged(plm)
    p = _Paged(plm, fw, GREEDY, 0)
    firsts, lens = [], np.zeros(SLOTS, np.int32)
    for slot, text in ROWS:
        toks = np.asarray(plm.tokenizer.encode(text), np.int32)
        firsts.append(p.prefill(slot, toks))
        lens[slot] = len(toks)
    tokens = np.full(SLOTS, CFG.EOS, np.int32)
    for (slot, _), tok in zip(ROWS, firsts):
        tokens[slot] = tok
    for slot in np.flatnonzero(ACTIVE):
        need = -(-min(lens[slot] + STEPS, S) // PAGE)
        while p.cover[slot] < need:
            p.tables[slot, p.cover[slot]] = p.alloc()
            p.cover[slot] += 1
    before = {k: v.clone() for k, v in p.pages["p"].items()}
    res = fw.window(p.pages, p.tables, tokens, lens, ACTIVE, BUDGET, GREEDY,
                    10)
    written = np.zeros((NUM_PAGES, PAGE), bool)
    for b in range(SLOTS):
        pos = np.arange(lens[b], res[1][b])
        written[p.tables[b, pos // PAGE], pos % PAGE] = True
    assert written.sum() == res[3]                    # one per active step
    keep = torch.from_numpy(~written)
    for name, arr in p.pages["p"].items():
        assert torch.equal(arr[keep], before[name][keep]), name
        assert not torch.equal(arr[~keep], before[name][~keep]), name


def test_paged_window_refuses_a_view_past_its_tables(models):
    _, plm = models["base"]
    pages = llm.init_kv_pages(plm.cfg, 4, PAGE, "cpu")
    args = (np.zeros(1, np.int32), np.zeros(1, np.int32), np.ones(1, bool),
            np.ones(1, np.int32), plm.cfg, pages, np.zeros((1, 2), np.int32),
            np.zeros(1, np.float32), 0, 2)
    with pytest.raises(ValueError, match="view_len"):
        llm.paged_decode_window(plm.params, *args, 2 * PAGE + 1)


def test_copy_kv_page_copies_every_layer_in_place(models):
    _, plm = models["base"]
    pages = llm.init_kv_pages(plm.cfg, 3, PAGE, "cpu")
    for arr in pages.values():
        arr[1].normal_()
    assert llm.copy_kv_page(pages, 1, 2) is pages
    for arr in pages.values():
        assert torch.equal(arr[2], arr[1]) and not arr[0].any()
