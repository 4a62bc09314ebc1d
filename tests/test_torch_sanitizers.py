"""Sanitizer builds of the port's native featurizer
(``featurize/native.py`` ``build_variant``/``sanitizer_runtime`` and
``native/san_driver.py``), the twin of ``tests/test_sanitizers.py``.

The driver runs the serial-vs-sharded parity checks, the shard hammer over
one handle and the raw-JSON/frame round trips inside a subprocess that
loads the ASan+UBSan or TSan build with the matching runtime preloaded. A
sanitizer finding aborts the subprocess (halt_on_error /
-fno-sanitize-recover), so a clean exit with no report IS the assertion.
Both instrumented runs stay at the smoke size (4 threads, 2 rounds, 256
rows) and run here; each skips only where gcc has no runtime for it.
"""

import os
import subprocess
import sys

import pytest

from fraud_detection_tpu.featurize import native as jnative
from fraud_detection_tpu_torch.featurize import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(REPO, "fraud_detection_tpu_torch", "native",
                      "san_driver.py")

_SAN_ENV = {
    "asan": {"ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
             "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1"},
    "tsan": {"TSAN_OPTIONS": "halt_on_error=1"},
}
_REPORT_MARKERS = ("ERROR: AddressSanitizer", "runtime error:",
                   "WARNING: ThreadSanitizer", "ERROR: LeakSanitizer")


def _run_driver(variant: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["FRAUD_TPU_NATIVE_VARIANT"] = variant if variant != "plain" else ""
    if variant != "plain":
        runtime = native.sanitizer_runtime(variant)
        if runtime is None:
            pytest.skip(f"gcc has no {variant} runtime to preload")
        assert native.build_variant(variant) is not None, native.build_error
        env["LD_PRELOAD"] = runtime
        env.update(_SAN_ENV[variant])
    return subprocess.run(
        [sys.executable, DRIVER, "--variant", variant, "--threads", "4",
         "--rounds", "2", "--rows", "256"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


def _assert_clean(proc: subprocess.CompletedProcess, variant: str) -> None:
    out = proc.stdout + "\n" + proc.stderr
    assert proc.returncode == 0, (
        f"{variant} driver failed (rc={proc.returncode}):\n{out[-4000:]}")
    for marker in _REPORT_MARKERS:
        assert marker not in out, (
            f"{variant}: sanitizer report in output:\n{out[-4000:]}")
    assert "all checks passed" in proc.stdout
    assert f"variant={variant}" in proc.stdout


def test_driver_smoke_uninstrumented():
    """The workload itself stays green on the -O3 build: parity, hammer,
    JSON/frames."""
    if not native.available():
        pytest.skip(f"native library unavailable: {native.build_error}")
    _assert_clean(_run_driver("plain"), "plain")


@pytest.mark.parametrize("variant", ["asan", "tsan"])
def test_shard_abi_clean_under_sanitizer(variant):
    _assert_clean(_run_driver(variant), variant)


def test_variant_builds_are_distinct_artifacts():
    """Variants land beside the -O3 build without replacing it, under the
    reference's names and flags; an unknown variant raises."""
    plain = native.build_variant(None)
    asan = native.build_variant("asan")
    if plain is None or asan is None:
        pytest.skip(f"toolchain unavailable: {native.build_error}")
    assert plain == native.library_path() == native.build_variant("plain")
    assert plain.name == "libfastfeat.so"
    assert asan == native.variant_lib_path("asan")
    assert asan.name == "libfastfeat_asan.so"
    assert asan.parent == plain.parent
    assert native.variant_lib_path("tsan").name == "libfastfeat_tsan.so"
    assert plain.is_file() and asan.is_file()
    with pytest.raises(ValueError) as want:
        jnative.build_variant("msan")
    with pytest.raises(ValueError) as got:
        native.build_variant("msan")
    assert str(got.value) == str(want.value)
    assert "unknown sanitizer variant 'msan'" in str(got.value)
    for variant, flags in native.SAN_VARIANTS.items():
        assert list(flags) == jnative._SAN_VARIANTS[variant]
    assert native.SAN_RUNTIMES == jnative._SAN_RUNTIMES


def test_sanitizer_runtime_equals_jax():
    for variant in ("asan", "tsan", "msan"):
        assert native.sanitizer_runtime(variant) == \
            jnative.sanitizer_runtime(variant)
    assert native.sanitizer_runtime("msan") is None     # no such runtime
