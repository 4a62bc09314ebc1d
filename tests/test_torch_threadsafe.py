"""The port's serving path under several threads, on the CPU.

The fleet (``fleet/``) and ``--workers N`` hand ONE ``ServingPipeline`` to N
worker threads, which on the card dispatch chunks and ``featurize_packed``
launches onto it at once. These tests pin what sharing it needs:

* ``ops/_build.py`` builds and loads each kernel library once when several
  threads ask for it first at the same moment (one nvcc run, one handle);
* every kernel wrapper's ``.launches`` count, which ``chip_smoke.py`` gates
  on, adds up exactly under threads (``count_launch``);
* ``DeviceStats`` counts exactly under threads, and its rung set can be read
  while workers add to it;
* ``pin_device`` counts one pin however many engines start at once;
* the native featurizer's handle is built once, and no thread meanwhile
  falls back to the slow path;
* N threads scoring on one pipeline get what one thread gets, row for row.
"""

import json
import sys
import threading
import types

import numpy as np
import pytest

from fraud_detection_tpu_torch.featurize import native as native_mod
from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
from fraud_detection_tpu_torch.models.pipeline import (DeviceStats,
                                                       synthetic_demo_pipeline)
from fraud_detection_tpu_torch.ops import _build
from fraud_detection_tpu_torch.ops import attention, featurize_kernel
from fraud_detection_tpu_torch.ops import histogram, int8_matmul

pytestmark = pytest.mark.fleet

THREADS = 8


def _hammer(fn, n_threads=THREADS, timeout=60.0):
    """Run ``fn(i)`` on ``n_threads`` threads released together, with a
    short switch interval so that interleavings are frequent; returns the
    results in thread order."""
    start = threading.Barrier(n_threads)
    out = [None] * n_threads
    errors = []

    def run(i):
        try:
            start.wait(timeout)
            out[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
        assert not any(t.is_alive() for t in threads), "a thread hung"
    finally:
        sys.setswitchinterval(old)
    if errors:
        raise errors[0]
    return out


@pytest.fixture(scope="module")
def pipe():
    return synthetic_demo_pipeline(batch_size=32, n=300, seed=3,
                                   num_features=1024, device="cpu")


# ---------------------------------------------------------------------------
# the kernel loader
# ---------------------------------------------------------------------------

def test_load_builds_once_under_concurrent_first_calls(monkeypatch, tmp_path):
    builds = []
    gate = threading.Event()

    def slow_build(name):
        builds.append(name)
        gate.wait(0.2)          # hold the build open while the others ask
        return tmp_path / f"lib{name}.so"

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build, "ctypes",
                        types.SimpleNamespace(CDLL=lambda path: object()))
    libs = _hammer(lambda i: _build.load("featurize_scan"))
    assert builds == ["featurize_scan"]
    assert all(lib is libs[0] for lib in libs)


def test_build_all_runs_one_nvcc_under_concurrent_first_calls(monkeypatch,
                                                             tmp_path):
    """Two threads that miss at once must not start two nvcc runs writing
    one library: one compiles, the other finds its result."""
    runs = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            runs.append(cmd)
            self._out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            with open(self._out, "wb") as f:
                f.write(b"\0")
            return "", ""

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    paths = _hammer(lambda i: _build.build_all(["featurize_scan"]))
    assert len(runs) == 1
    assert len({str(p[0]) for p in paths}) == 1 and paths[0][0].exists()
    assert not list(tmp_path.glob("*.tmp"))


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

def test_count_launch_exact_under_threads():
    def fn():
        pass

    fn.launches = 0
    _hammer(lambda i: [_build.count_launch(fn) for _ in range(1000)])
    assert fn.launches == THREADS * 1000


@pytest.mark.parametrize("fn,attr", [
    (featurize_kernel.featurize_bytes, "launches"),
    (featurize_kernel.tokenize_hash, "launches"),
    (attention.flash_attention, "launches"),
    (attention.flash_attention_sm90, "launches"),
    (attention.flash_attention_simt, "launches"),
    (histogram.node_feature_bin_histogram_multi, "launches"),
    (histogram.best_splits, "launches"),
    (int8_matmul.w8_matmul, "launches"),
    (int8_matmul.w8_matmul, "simt_launches"),
], ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_every_kernel_counter_exact_under_threads(fn, attr, monkeypatch):
    """Each wrapper's own counter, as chip_smoke.py reads and resets it."""
    monkeypatch.setattr(fn, attr, 0)
    _hammer(lambda i: [_build.count_launch(fn, attr) for _ in range(500)])
    assert getattr(fn, attr) == THREADS * 500


# ---------------------------------------------------------------------------
# the pipeline's shared state
# ---------------------------------------------------------------------------

def test_device_stats_exact_under_threads():
    ds = DeviceStats()
    stop = threading.Event()
    read_errors = []

    def poll():     # a health poller reading while the workers record
        while not stop.is_set():
            try:
                ds.snapshot()
            except RuntimeError as e:
                read_errors.append(e)

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        _hammer(lambda i: [(ds.record_chunk(10, rows=i * 1000 + k + 1),
                            ds.record_featurize(4, 2, 1))
                           for k in range(1000)])
    finally:
        stop.set()
        poller.join(10.0)
    assert not poller.is_alive() and not read_errors
    n = THREADS * 1000
    snap = ds.snapshot()
    assert (snap["chunks"], snap["uploads"], snap["upload_bytes"]) == \
        (n, n, 10 * n)
    assert (ds.feat_bytes_in, ds.feat_rows, ds.truncated_rows) == \
        (4 * n, 2 * n, n)
    assert len(snap["per_chip_rungs"]) == n


def test_pin_device_counts_one_pin_under_threads():
    pipe = synthetic_demo_pipeline(batch_size=16, n=120, seed=1,
                                   num_features=256, device="cpu")
    stats = _hammer(lambda i: pipe.pin_device())
    assert pipe.device_stats.pins == 1
    assert all(s == stats[0] for s in stats) and stats[0]["pinned_bytes"] > 0


def test_native_featurizer_built_once_and_never_none(monkeypatch):
    """A thread that found the handle's build begun but not finished used
    to get None, and its engine took the slow json.loads path for good."""
    made = []

    class SlowNative:
        def __init__(self, *a):
            made.append(a)
            threading.Event().wait(0.05)

    monkeypatch.setattr(native_mod, "available", lambda: True)
    monkeypatch.setattr(native_mod, "NativeFeaturizer", SlowNative)
    feat = HashingTfIdfFeaturizer(num_features=64)
    got = _hammer(lambda i: feat._native_featurizer())
    assert len(made) == 1
    assert all(g is got[0] for g in got) and isinstance(got[0], SlowNative)


@pytest.mark.parametrize("ladder", [None, (8, 16, 32)])
def test_threads_sharing_one_pipeline_score_as_one_thread(pipe, ladder):
    """N threads dispatching onto one pipeline (texts and raw JSON, ragged
    chunk sizes) get exactly what one thread gets."""
    from fraud_detection_tpu_torch.data import generate_corpus

    pipe.pad_ladder = ladder
    try:
        texts = [d.text for d in generate_corpus(n=200, seed=5)]
        jobs = [texts[i * 23: i * 23 + 5 + 7 * i] for i in range(THREADS)]
        values = [[json.dumps({"text": t}).encode() for t in job]
                  for job in jobs]

        def score(i):
            batch = pipe.predict(jobs[i])
            fast = pipe.predict_json_async(values[i])
            raw = None if fast is None else fast[0].resolve()
            return batch, raw

        want = [score(i) for i in range(THREADS)]
        for _ in range(3):
            got = _hammer(score)
            for (b, r), (wb, wr) in zip(got, want):
                assert np.array_equal(b.labels, wb.labels)
                assert np.array_equal(b.probabilities, wb.probabilities)
                assert (r is None) == (wr is None)
                if r is not None:
                    assert np.array_equal(r.probabilities, wr.probabilities)
    finally:
        pipe.pad_ladder = None
