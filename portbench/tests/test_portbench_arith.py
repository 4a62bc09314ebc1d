"""The benchmark's arithmetic: operations counted from shapes, spreads and
rates."""

import statistics

import pytest

import arith
import readings

PHI3 = dict(hidden_size=3072, num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=32, head_dim=96, intermediate_size=8192,
            vocab_size=32064)


def test_layer_params_match_the_published_count():
    per_layer = arith.layer_matrix_params(PHI3)
    total = (PHI3["num_hidden_layers"] * per_layer
             + 2 * PHI3["vocab_size"] * PHI3["hidden_size"])
    assert per_layer == 4 * 3072 * 3072 + 3 * 3072 * 8192
    assert total == pytest.approx(3.82e9, rel=0.01)


def test_prefill_counts_each_computed_position_once():
    cfg = dict(PHI3, num_hidden_layers=1, vocab_size=10)
    one = arith.prefill_flops(cfg, 0, 1)
    assert one == (arith.token_product_flops(cfg, False) + 2 * 10 * 3072
                   + arith.attention_flops(cfg, 1))
    # a cached prefix is neither multiplied again nor attended from
    full, cached = arith.prefill_flops(cfg, 0, 8), arith.prefill_flops(cfg, 3, 8)
    keys = sum(j + 1 for j in range(3, 8))
    assert cached == (5 * arith.token_product_flops(cfg, False)
                      + 2 * 10 * 3072 + arith.attention_flops(cfg, keys))
    assert full > cached
    assert arith.prefill_flops(cfg, 8, 8) == 0


def test_decode_counts_real_context_per_token():
    cfg = dict(PHI3, num_hidden_layers=2)
    got = arith.decode_flops(cfg, 100, 0, 4)       # outputs 1..3
    want = sum(arith.token_product_flops(cfg, True)
               + arith.attention_flops(cfg, 100 + i) for i in (1, 2, 3))
    assert got == want
    assert arith.decode_flops(cfg, 100, 2, 4) == sum(
        arith.token_product_flops(cfg, True)
        + arith.attention_flops(cfg, 100 + i) for i in (2, 3))
    assert arith.decode_flops(cfg, 100, 3, 3) == 0


def test_spread_is_the_interquartile_distance_over_the_median():
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(vals, n=4)
    assert arith.spread(vals) == pytest.approx((q3 - q1) / med)


def test_interval_union_merges_overlaps():
    assert arith.interval_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert arith.interval_union([]) == 0


def test_window_rates_and_shares():
    rec = {"window_s": 4.0, "tokens": 1000, "flops": 989e12, "flops_s": 4.0,
           "profile": {"busy_s": 0.75, "window_s": 1.0},
           "snap0": {"occupancy": 0.5, "decode_steps": 10},
           "snap1": {"occupancy": 0.6, "decode_steps": 20}}
    assert readings.per_second(rec, "tokens") == 250.0
    assert readings.mfu_pct(rec) == pytest.approx(25.0)
    assert readings.device_idle_pct(rec) == pytest.approx(25.0)
    assert readings.slot_occupancy_pct(rec) == pytest.approx(70.0)
    assert readings.per_second({}, "tokens") is None
    assert readings.device_idle_pct({"profile": {"busy_s": 0.0,
                                                 "window_s": 1.0}}) is None


def test_emitted_counts_between_decode_window_returns():
    from drivers.slot_batch import emitted
    marks = [(0.5, 30, True), (1.0, 1, False), (2.0, 40, True),
             (2.5, 1, False), (2.6, 1, False), (3.0, 50, True),
             (4.2, 60, True), (5.0, 70, True)]
    # windows returning inside [1, 4.5]: 2.0, 3.0 and 4.2
    assert emitted(marks, 1.0, 4.5) == (1 + 1 + 50 + 60, pytest.approx(2.2))
    assert emitted(marks, 2.1, 3.5) == (0, 0.0)
