"""The traffic generator: a seed always gives the same inputs, and every
seed the same pool of sizes in another order."""

import random

import numpy as np

import framing
import harness
import traffic_gen

MIX = harness.traffic("explain_batch")


def test_explain_requests_repeat_for_a_seed():
    a = traffic_gen.explain_requests(dict(MIX, requests=256), 2**33 + 5)
    b = traffic_gen.explain_requests(dict(MIX, requests=256), 2**33 + 5)
    assert [(r.prompt, r.max_tokens, r.temperature) for r in a] == \
        [(r.prompt, r.max_tokens, r.temperature) for r in b]


def test_seeds_share_the_pool_of_sizes():
    mix = dict(MIX, requests=256)
    a = traffic_gen.explain_requests(mix, 1)
    b = traffic_gen.explain_requests(mix, 2)
    assert [r.prompt for r in a] != [r.prompt for r in b]
    assert [r.max_tokens for r in a] == [r.max_tokens for r in b]
    assert [r.temperature for r in a] == [r.temperature for r in b]
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    for reqs in (a, b):
        budgets = [r.max_tokens for r in reqs]
        assert min(budgets) >= MIX["max_tokens_min"]
        assert max(budgets) <= MIX["max_tokens_max"]
        every = round(1 / MIX["greedy_share"])
        for lo in range(0, len(reqs), every):
            block = reqs[lo:lo + every]
            assert sum(r.temperature == 0.0 for r in block) == 1
        assert all(r.temperature in (0.0, MIX["temperature"]) for r in reqs)
        assert all(r.prompt.startswith(framing.shared_prefix()) for r in reqs)


def test_stratified_blocks_hold_one_of_each_stratum():
    values = list(range(64))
    out = traffic_gen.stratified(values, 8, random.Random(3))
    assert sorted(out) == values
    for lo in range(0, 64, 8):
        assert sorted(v // 8 for v in out[lo:lo + 8]) == list(range(8))


def test_log_uniform_grid_spans_the_range():
    g = traffic_gen.log_uniform_grid(32, 255, 1000)
    assert 32 <= min(g) and max(g) <= 255
    assert abs(np.mean(g) - (255 - 32) / np.log(255 / 32)) < 1.0


def test_prompts_tokenize_as_bytes_behind_bos():
    toks = framing.tokens("abé", 10)
    assert toks.tolist() == [256, 97, 98, 0xC3, 0xA9]
    assert framing.tokens("x" * 50, 8).shape == (8,)
