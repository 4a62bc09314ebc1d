"""The benchmark's own tests: CPU runs of the harness at tiny sizes, and a
few marked ``cuda`` that need the card (they decide inside the test).

    python -m pytest portbench/tests -q
"""

import sys
import time
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(BENCH_DIR.parent))

TINY_MODEL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, intermediate_size=128,
                  vocab_size=300, dtype="float32")


@pytest.fixture
def tiny_context():
    """A run context for ``cell`` on the CPU at a tiny model size, with the
    mix's sizes overridden as given (the cell's limits stay as committed)."""
    import torch

    import harness

    torch.set_num_threads(4)

    def make(cell_name, seconds=2.0, trace=False, seed=2**31 + 11,
             model=None, **mix):
        bench = harness.load_benchmark()
        cell = harness.workload(bench, cell_name)
        cfg = dict(harness.config(bench, cell["config"]))
        cfg.update(TINY_MODEL, **(model or {}))
        m = harness.traffic(cell["traffic"])
        for k, v in mix.items():
            if isinstance(v, dict):
                m[k] = dict(m[k], **v)
            else:
                m[k] = v
        return harness.Context(cell=cell, cfg=cfg, mix=m, seed=seed,
                               seconds=seconds, trace=trace,
                               device=torch.device("cpu"),
                               started=time.perf_counter())
    return make


def need_card():
    """Skip unless a CUDA card is present (decided inside the test)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
