"""Each cell's driver end to end on the CPU at a tiny model size (the
program's plain torch paths), and the same runs with the timed path broken
underneath, once for each fault the cell can have: ``correct`` must come
out false."""

import pytest

import calibrate
import harness

BATCH = dict(slots=4, outstanding=8, max_new_tokens=24, max_tokens_min=4,
             max_tokens_max=24, decode_window=4, ramp_iterations=2,
             profile_seconds=0.5, requests=64)


def _run(ctx):
    harness.driver(ctx.mix["driver"]).run(ctx)
    return harness.result(ctx, harness.load_benchmark())


@pytest.mark.parametrize("trace", [False, True])
def test_batch_cell_runs_and_is_correct(tiny_context, trace):
    ctx = tiny_context("explain_batch.phi3-mini", trace=trace, **BATCH)
    line = _run(ctx)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert ctx.rec["served"]["tokens"] > 0
    names = set(line["metrics"])
    if trace:
        assert {"slot_occupancy.batch", "explain_mfu.batch"} <= names
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert names == {"explain_tok_per_s", "setup_s"}
        assert line["metrics"]["explain_tok_per_s"]["value"] > 0


def test_batch_cell_catches_a_token_altered_where_it_is_produced(
        tiny_context, monkeypatch):
    calibrate.FAULTS["token_altered"](monkeypatch.setattr)
    line = _run(tiny_context("explain_batch.phi3-mini", **BATCH))
    assert line["correct"] is False
    assert line["checks"]["served_logit_gap"]["value"] > \
        line["checks"]["served_logit_gap"]["limit"]
