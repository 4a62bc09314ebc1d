"""Each cell's control, the reference one precision step below the
configuration's put in the program's place, must come out not correct.

On the CPU at a tiny size the control is held against the program there;
on the card (marked ``cuda``) ``calibrate.py`` reads it at the cell's own
size on three seeds and each reading must fail one of the cell's limits.

    python -m pytest portbench/tests -q -m cuda     # on the card
"""

import json
import subprocess
import sys

import pytest

import harness
from conftest import need_card

BATCH = dict(slots=4, outstanding=8, max_new_tokens=24, max_tokens_min=4,
             max_tokens_max=24, decode_window=4, ramp_iterations=2,
             profile_seconds=0.5, requests=64)


def test_batch_control_reads_wider_gaps_than_the_program(tiny_context):
    # the published vocabulary, so that near ties among the logits occur
    ctx = tiny_context("explain_batch.phi3-mini", model={"vocab_size": 32064},
                       check_tokens=200, check_requests=16, **BATCH)
    ctx.control = "fp8"
    harness.driver(ctx.mix["driver"]).run(ctx)
    served = ctx.rec["served"]
    assert served["control_gap"] > 10 * max(served["gap"], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["explain_batch.phi3-mini"])
def test_control_fails_a_limit_at_the_cells_size(cell, tmp_path):
    need_card()
    out = tmp_path / "control.jsonl"
    subprocess.run([sys.executable, str(harness.BENCH_DIR / "calibrate.py"),
                    "--workload", cell, "--seeds", "3", "--control-seeds", "3",
                    "--seconds", "10", "--out", str(out)], check=True)
    limits = json.loads((harness.BENCH_DIR / "limits" / f"{cell}.json")
                        .read_text())
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 3
    for row in rows:
        assert row["served"]["control_gap"] > limits["served_logit_gap"]
