"""The port's flightcheck (``fraud_detection_tpu_torch/analysis/``) against
the JAX package's (``fraud_detection_tpu/analysis/``).

The analyzers are deterministic, so every comparison is exact:

* on every fixture of ``tests/flightcheck_fixtures/`` (the protocol mutants
  included), each port pass gives the same ``(rule, path, line, message)``
  findings as its reference twin, under the fixture registries the
  reference's own tests use and under the default ones. The port has no
  FC201/FC202 (it traces nothing), so ``synclint`` is held against the
  FC203/FC204 findings of ``jaxlint`` alone;
* ``--fix`` edits are byte-equal, SARIF documents equal apart from the
  tool's name and version, and the incremental cache hits and misses alike;
* the port's registries equal the reference's as data;
* the port's own tree has zero findings within the reference's 30 s budget,
  and every pragma in it is pinned and justified.
"""

import dataclasses
import json
import os
import shutil
import time

import pytest

from fraud_detection_tpu.analysis import callgraph as Jcallgraph
from fraud_detection_tpu.analysis import concurrency as Jconcurrency
from fraud_detection_tpu.analysis import core as Jcore
from fraud_detection_tpu.analysis import entrypoints as Jentry
from fraud_detection_tpu.analysis import fixer as Jfixer
from fraud_detection_tpu.analysis import health as Jhealth
from fraud_detection_tpu.analysis import jaxlint as Jjaxlint
from fraud_detection_tpu.analysis import model as Jmodel
from fraud_detection_tpu.analysis import protocol as Jprotocol
from fraud_detection_tpu.analysis import sarif as Jsarif
from fraud_detection_tpu.analysis import threads as Jthreads
from fraud_detection_tpu.utils import racecheck as Jracecheck
from fraud_detection_tpu_torch.analysis import callgraph as Tcallgraph
from fraud_detection_tpu_torch.analysis import concurrency as Tconcurrency
from fraud_detection_tpu_torch.analysis import core as Tcore
from fraud_detection_tpu_torch.analysis import entrypoints as Tentry
from fraud_detection_tpu_torch.analysis import fixer as Tfixer
from fraud_detection_tpu_torch.analysis import health as Thealth
from fraud_detection_tpu_torch.analysis import model as Tmodel
from fraud_detection_tpu_torch.analysis import protocol as Tprotocol
from fraud_detection_tpu_torch.analysis import sarif as Tsarif
from fraud_detection_tpu_torch.analysis import synclint as Tsynclint
from fraud_detection_tpu_torch.analysis import threads as Tthreads
from fraud_detection_tpu_torch.utils import racecheck as Tracecheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPKG = os.path.join(REPO, "fraud_detection_tpu")
TPKG = os.path.join(REPO, "fraud_detection_tpu_torch")
FIXTURES = os.path.join(REPO, "tests", "flightcheck_fixtures")
MUTANTS = os.path.join(FIXTURES, "fx_protocol_mutants")

FIXTURE_FILES = sorted(
    [name for name in os.listdir(FIXTURES) if name.endswith(".py")]
    + [f"fx_protocol_mutants/{name}" for name in os.listdir(MUTANTS)
       if name.endswith(".py")])


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's analysis modules, so a pass runs the same on both."""

    core: object
    entry: object
    concurrency: object
    callgraph: object
    protocol: object
    sync: object          # (files, hot_paths=) -> findings, FC203/FC204
    threads: object
    health: object
    model: object
    pkg: str


def _jax_sync(files, hot_paths=None):
    return [f for f in Jjaxlint.analyze(files, hot_paths=hot_paths)
            if f.rule in ("FC203", "FC204")]


JAX = Side(Jcore, Jentry, Jconcurrency, Jcallgraph, Jprotocol, _jax_sync,
           Jthreads, Jhealth, Jmodel, JPKG)
PORT = Side(Tcore, Tentry, Tconcurrency, Tcallgraph, Tprotocol,
            Tsynclint.analyze, Tthreads, Thealth, Tmodel, TPKG)

#: The fixture registries tests/test_flightcheck.py and
#: tests/test_model_checker.py feed the passes, built from each side's
#: own dataclasses.
_MUTANT_OBLIGATIONS = {
    "fx_fence_dropped.py": (
        "fence-before-offsets-advance",
        "MutantAssignedConsumer._commit_locked", "call:fence",
        "store:_committed"),
    "fx_barrier_skipped.py": (
        "rebalance-populates-revoke-barrier",
        "MutantCoordinator._rebalance_locked", "store:_pending", ""),
    "fx_ack_before_drain.py": (
        "drain-before-ack", "MutantWorker._run", "call:engine.run",
        "call:coordinator.ack"),
    "fx_expire_before_renew.py": (
        "renew-before-expiry-scan", "MutantCoordinator.join",
        "store:_members", "call:_expire_locked"),
    "fx_succession.py": (
        "restore-inherits-holds", "MutantCoordinator.restore_state",
        "store:_pending", ""),
    "fx_autoscale.py": (
        "release-rides-revoke-barrier", "MutantCoordinator.request_release",
        "call:_released.add", "call:_rebalance_locked"),
    "fx_slot_page_leak.py": (
        "pages-freed-on-slot-release", "MutantSlotServeService._release",
        "call:_decoder.release_slot", "call:_free.append"),
}


def _fx_registry(side):
    spec = side.entry.ClassSpec
    return {
        "fx_unguarded_write.py::Box": spec(
            any_thread=frozenset(), workers={"w": frozenset({"_worker"})}),
        "fx_fleet.py::LeaseBoard": spec(
            any_thread=frozenset({"renew"}),
            workers={"monitor": frozenset({"_tick", "_tick_guarded"})}),
    }


def _fx_protocols(side):
    spec = side.entry.CommitProtocolSpec
    return tuple(spec(f"fx_commit_protocol.py::{cls}",
                      drain_names=frozenset({"_finish"}),
                      failure_flag="_flush_failed")
                 for cls in ("BadEngine", "GoodEngine"))


def _fx_contracts(side):
    c = side.health.Contract
    return (
        c("fx_health_drift.py", "Probe.health", "fx_schema_tests.py",
          "PROBE_HEALTH_SCHEMA"),
        c("fx_health_drift.py", "Probe.snapshot_ok", "fx_schema_tests.py",
          "SNAP_OK_SCHEMA"),
        c("fx_health_drift.py", "Probe.torn", "fx_schema_tests.py",
          "SNAP_OK_SCHEMA"),
    )


def _rows(findings):
    return sorted((f.rule, f.path, f.line, f.message) for f in findings)


def _passes(side, name):
    """Every pass of ``side`` over one fixture file: name -> findings."""
    base = os.path.basename(name)
    sf = side.core.SourceFile.load(os.path.join(FIXTURES, name), base)
    assert sf is not None, name
    files = [sf]
    out = {
        "concurrency": side.concurrency.analyze(
            files, registry=_fx_registry(side)),
        "concurrency-default": side.concurrency.analyze(files),
        "callgraph": side.callgraph.analyze(files, bindings={},
                                            implementations={}),
        "callgraph-default": side.callgraph.analyze(files),
        "protocol": side.protocol.analyze(files,
                                          protocols=_fx_protocols(side)),
        "protocol-fc404": side.protocol.analyze(files, protocols=()),
        "sync": side.sync(files, hot_paths={
            "fx_jax_violations.py::HotClass.hot_loop"}),
        "sync-default": side.sync(files),
        "threads": side.threads.analyze(files, package_root=side.pkg,
                                        sites_registry=frozenset(),
                                        entry_points=()),
        "health": side.health.analyze(files, tests_dir=FIXTURES,
                                      contracts=_fx_contracts(side)),
        "model-default": side.model.analyze(files),
    }
    if base in _MUTANT_OBLIGATIONS:
        ob_name, anchor, first, then = _MUTANT_OBLIGATIONS[base]
        ob = side.entry.BarrierObligation(ob_name, f"{base}::{anchor}",
                                          first=first, then=then, why="w")
        out["model-obligation"] = side.model.analyze(
            files, protocols=(), obligations=(ob,), vocabulary=(), scope=())
    return out


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_findings_equal_jax(name):
    want = _passes(JAX, name)
    got = _passes(PORT, name)
    assert set(got) == set(want)
    for pass_name in want:
        assert _rows(got[pass_name]) == _rows(want[pass_name]), pass_name


def test_fixtures_exercise_every_port_rule():
    """The equality above is not vacuous: over the fixtures, the port's
    passes raise every rule of its catalog that a pass can raise on one
    file (FC501 needs the tree: test_fc501_fc502_on_the_ports_tree)."""
    seen = set()
    for name in FIXTURE_FILES:
        for findings in _passes(PORT, name).values():
            seen |= {f.rule for f in findings}
    assert seen == set(Tcore.RULES) - {"FC501", "FC504", "FC505"}


def test_fc501_fc502_on_the_ports_tree():
    """The reference's spec-drift pins, on the port's tree: an emptied spec
    leaves every fleet protocol call site unclaimed (FC501), and a ghost
    anchor and a vanished required call both flag (FC502)."""
    files = Tcore.load_package(TPKG)
    fc501 = [f for f in Tmodel.analyze(files, protocols=(), obligations=())
             if f.rule == "FC501"]
    jfiles = Jcore.load_package(JPKG)
    jfc501 = [f for f in Jmodel.analyze(jfiles, protocols=(), obligations=())
              if f.rule == "FC501"]
    assert len(fc501) == len(jfc501) >= 8
    assert all(f.path.startswith(("fleet/", "explain/slotserve/"))
               for f in fc501)
    msgs = "\n".join(f.message for f in fc501)
    assert "coordinator.join" in msgs and "bus.publish" in msgs
    ghost = (Tentry.RoleSpec(
        "Coordinator", "fleet/coordinator.py::FleetCoordinator",
        ("steady",), "steady", (
            Tentry.ProtocolTransition(
                "join", "steady", "steady",
                ("fleet/coordinator.py::FleetCoordinator.join_v2",)),
            Tentry.ProtocolTransition(
                "tick", "steady", "steady",
                ("fleet/coordinator.py::FleetCoordinator.tick",),
                ("frobnicate",)),
        )),)
    findings = Tmodel.analyze(files, protocols=ghost, obligations=(),
                              vocabulary=(), scope=())
    assert [f.rule for f in findings] == ["FC502", "FC502"]
    msgs = "\n".join(f.message for f in findings)
    assert "join_v2" in msgs and "frobnicate" in msgs


def test_rule_catalog_is_the_reference_minus_fc201_fc202():
    assert set(Jcore.RULES) - set(Tcore.RULES) == {"FC201", "FC202"}
    for rule, entry in Tcore.RULES.items():
        assert entry == Jcore.RULES[rule], rule


def test_fc203_fc204_equal_on_the_jax_violations_fixture():
    """fx_jax_violations.py: the FC203/FC204 findings are the reference's
    (two host syncs, one ladder bypass); its FC201/FC202 findings have no
    counterpart in the port."""
    hot = {"fx_jax_violations.py::HotClass.hot_loop"}
    sf = Tcore.SourceFile.load(os.path.join(FIXTURES, "fx_jax_violations.py"),
                               "fx_jax_violations.py")
    got = Tsynclint.analyze([sf], hot_paths=hot)
    assert sorted(f.rule for f in got) == ["FC203", "FC203", "FC204"]
    jsf = Jcore.SourceFile.load(sf.path, sf.relpath)
    want = Jjaxlint.analyze([jsf], hot_paths=hot)
    assert {f.rule for f in want} - {f.rule for f in got} == {"FC201",
                                                              "FC202"}


# ---------------------------------------------------------------------------
# --fix, SARIF, cache
# ---------------------------------------------------------------------------

def _fix_root(tmp_path, side_name, names):
    root = tmp_path / side_name
    root.mkdir()
    for name in names:
        shutil.copy(os.path.join(FIXTURES, name), root / name)
    return root


def _raw(side, root, name):
    sf = side.core.SourceFile.load(str(root / name), name)
    raw = (side.protocol.analyze([sf], protocols=())
           + side.concurrency.analyze([sf], registry=_fx_registry(side)))
    return side.core.filter_suppressed({sf.relpath: sf}, raw)


@pytest.mark.parametrize("name", ["fx_lock_leak.py", "fx_unguarded_write.py",
                                  "fx_fleet.py"])
def test_fix_edits_byte_equal_and_idempotent(tmp_path, name):
    roots = {}
    for label, side, fixer in (("jax", JAX, Jfixer), ("port", PORT, Tfixer)):
        root = _fix_root(tmp_path, label, [name])
        kept, _ = _raw(side, root, name)
        planned = fixer.apply_fixes(kept, str(root), dry_run=True)
        before = (root / name).read_bytes()
        edits = fixer.apply_fixes(kept, str(root))
        assert planned == edits and edits
        assert (root / name).read_bytes() != before
        kept2, suppressed2 = _raw(side, root, name)
        assert kept2 == [] and suppressed2 >= len(edits)
        assert fixer.apply_fixes(kept2, str(root)) == []
        roots[label] = (root, [dataclasses.astuple(e) for e in edits])
    assert roots["port"][1] == roots["jax"][1]
    assert ((roots["port"][0] / name).read_bytes()
            == (roots["jax"][0] / name).read_bytes())


def _strip_tool(doc):
    """The document without the tool's name and version, and with each
    result's ruleIndex resolved to its rule: the port's catalog lacks
    FC201/FC202, so the same rule sits at another index there."""
    doc = json.loads(json.dumps(doc))
    driver = doc["runs"][0]["tool"]["driver"]
    ids = [r["id"] for r in driver["rules"]]
    driver["rules"] = [r for r in driver["rules"]
                       if r["id"] not in ("FC201", "FC202")]
    for res in doc["runs"][0]["results"]:
        assert ids[res.pop("ruleIndex")] == res["ruleId"]
    return doc, driver.pop("name"), driver.pop("version")


def test_sarif_documents_equal_apart_from_the_tool():
    for name in ("fx_lock_leak.py", "fx_commit_protocol.py"):
        sf = Tcore.SourceFile.load(os.path.join(FIXTURES, name), name)
        got = Tprotocol.analyze([sf], protocols=_fx_protocols(PORT))
        jsf = Jcore.SourceFile.load(sf.path, name)
        want = Jprotocol.analyze([jsf], protocols=_fx_protocols(JAX))
        assert _rows(got) == _rows(want)
        tdoc = Tsarif.build(got, suppressed=3, n_files=1,
                            uri_prefix="fraud_detection_tpu")
        jdoc = Jsarif.build(want, suppressed=3, n_files=1,
                            uri_prefix="fraud_detection_tpu")
        assert Tsarif.validate(tdoc) == [] and Jsarif.validate(tdoc) == []
        tdoc, tname, tversion = _strip_tool(tdoc)
        jdoc, jname, _ = _strip_tool(jdoc)
        assert tdoc == jdoc
        assert tname == Tsarif.TOOL_NAME != jname
        from fraud_detection_tpu_torch import __version__
        assert tversion == __version__
    # the port's own default roots artifact URIs at the port's package
    doc = Tsarif.build(got, suppressed=0, n_files=1)
    uri = doc["runs"][0]["results"][0]["locations"][0]["physicalLocation"]
    assert uri["artifactLocation"]["uri"].startswith(
        "fraud_detection_tpu_torch/")
    # and the validators reject the same broken documents alike
    for bad in ({"version": "2.0.0", "runs": []},
                {"version": "2.1.0", "runs": [{"tool": {"driver": {}},
                                               "results": []}]}):
        assert Tsarif.validate(bad) == Jsarif.validate(bad) != []


def test_cache_hits_and_misses_equal_jax(tmp_path):
    names = ["fx_lock_leak.py", "fx_commit_protocol.py"]
    log = {}
    for label, side in (("jax", JAX), ("port", PORT)):
        root = _fix_root(tmp_path, label, names)
        cache_dir = str(tmp_path / f"{label}-cache")
        steps = []

        def run():
            stats = {}
            out = side.core.run_analysis(package_root=str(root),
                                         tests_dir=None, cache_dir=cache_dir,
                                         stats=stats)
            steps.append((_rows(out[0]), out[1], out[2], stats))

        plain = side.core.run_analysis(package_root=str(root), tests_dir=None)
        run()
        run()
        (root / "fx_lock_leak.py").write_text(
            (root / "fx_lock_leak.py").read_text() + "\n# touched\n")
        run()
        assert steps[0][0] == steps[1][0] == _rows(plain[0])
        assert [s[3] for s in steps] == [{"hits": 0, "misses": 2},
                                         {"hits": 2, "misses": 0},
                                         {"hits": 1, "misses": 1}]
        log[label] = steps
    assert log["port"] == log["jax"]


def test_cache_salt_folds_in_the_ports_registries(monkeypatch):
    from fraud_detection_tpu_torch.analysis import cache

    before = cache._registry_salt()
    for attr, value in (("HOT_PATHS", frozenset({"nowhere.py::X.y"})),
                        ("FLEET_PROTOCOLS", ()),
                        ("COMMIT_PROTOCOLS", ()),
                        ("CONCURRENT_CLASSES", {})):
        monkeypatch.setattr(Tentry, attr, value)
        assert cache._registry_salt() != before, attr
        monkeypatch.undo()
    assert cache._registry_salt() == before
    assert cache.default_cache_dir(TPKG) == os.path.join(
        REPO, ".flightcheck_cache")


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

def _data(obj):
    """Registry value as plain data: dataclasses become (type name, fields)
    and mappings sorted item tuples, so the two packages' objects compare."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,) + tuple(
            (f.name, _data(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return tuple(sorted((k, _data(v)) for k, v in obj.items()))
    if isinstance(obj, (frozenset, set)):
        return tuple(sorted(_data(x) for x in obj))
    if isinstance(obj, (tuple, list)):
        return tuple(_data(x) for x in obj)
    return obj


_REGISTRIES = ("THREAD_SITES", "CONCURRENT_CLASSES", "OBJECT_BINDINGS",
               "IMPLEMENTATIONS", "COMMIT_PROTOCOLS", "FLEET_PROTOCOLS",
               "FLEET_BARRIER_OBLIGATIONS", "FLEET_PROTOCOL_VOCABULARY",
               "FLEET_PROTOCOL_SCOPE", "SLOT_PROTOCOLS",
               "SLOT_BARRIER_OBLIGATIONS", "SLOT_PROTOCOL_VOCABULARY",
               "SLOT_PROTOCOL_SCOPE", "HOT_PATHS")


@pytest.mark.parametrize("registry", _REGISTRIES)
def test_registries_equal_jax_as_data(registry):
    assert _data(getattr(Tentry, registry)) == _data(
        getattr(Jentry, registry))


def test_thread_entry_points_equal_jax_but_for_the_profiler():
    """One entry differs, in one word of its justification: the port's
    profile window drives torch.profiler, the reference's jax.profiler."""
    got, want = Tentry.THREAD_ENTRY_POINTS, Jentry.THREAD_ENTRY_POINTS
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.thread == "profile-window":
            assert g.why_uncovered == w.why_uncovered.replace("jax", "torch")
            g = dataclasses.replace(g, why_uncovered=w.why_uncovered)
        assert _data(g) == _data(w)


def test_health_contracts_name_the_ports_tests():
    """One contract per reference contract, on the same producer, pinned
    by a schema of the same name in the port's own test file."""
    assert len(Thealth.CONTRACTS) == len(Jhealth.CONTRACTS) == 16
    for got, want in zip(Thealth.CONTRACTS, Jhealth.CONTRACTS):
        assert got.test_file == "test_torch_" + want.test_file[len("test_"):]
        assert _data(dataclasses.replace(got, test_file=want.test_file)) \
            == _data(want)
        assert Thealth.schema_keys(os.path.join(REPO, "tests"),
                                   got.test_file, got.schema_var), got


def test_port_only_schema_keys():
    """The port's schemas pin the reference's keys, plus exactly two of its
    own: the engine device block's "device" and the slot service's
    "kv_bytes_per_device"."""
    tests_dir = os.path.join(REPO, "tests")
    extra = {}
    for got, want in zip(Thealth.CONTRACTS, Jhealth.CONTRACTS):
        mine = Thealth.schema_keys(tests_dir, got.test_file, got.schema_var)
        theirs = Jhealth.schema_keys(tests_dir, want.test_file,
                                     want.schema_var)
        assert mine >= theirs, got
        if mine != theirs:
            extra[got.qualname] = mine - theirs
    assert extra == {"StreamingClassifier._device_block": {"device"},
                     "SlotServeService.snapshot": {"kv_bytes_per_device"}}


def test_every_registered_site_exists_in_the_port():
    files = Tcore.load_package(TPKG)
    index = Tmodel._method_index(files)
    classes = {f"{sf.relpath}::{node.name}" for sf in files
               for node in sf.tree.body
               if node.__class__.__name__ == "ClassDef"}
    for key in list(Tentry.CONCURRENT_CLASSES) + [
            p.cls_key for p in Tentry.COMMIT_PROTOCOLS]:
        assert key in classes, key
    for key, spec in Tentry.CONCURRENT_CLASSES.items():
        for method in set(spec.any_thread).union(*spec.workers.values()):
            assert f"{key}.{method}" in index, (key, method)
    for hot in Tentry.HOT_PATHS:
        assert hot in index, hot
    for role in Tentry.FLEET_PROTOCOLS + Tentry.SLOT_PROTOCOLS:
        for t in role.transitions:
            for anchor in t.anchors:
                assert anchor in index, f"{role.role}.{t.name}: {anchor}"
    for ob in (Tentry.FLEET_BARRIER_OBLIGATIONS
               + Tentry.SLOT_BARRIER_OBLIGATIONS):
        assert ob.anchor in index and ob.why, ob.name


def test_instrumented_regions_match_the_ports_source():
    static = Tthreads.parse_instrumented_registry(TPKG)
    assert static == set(Tracecheck.INSTRUMENTED_REGIONS)
    assert static == set(Jracecheck.INSTRUMENTED_REGIONS)
    names = {n for _, n, _ in Tthreads.collect_region_names(
        Tcore.load_package(TPKG))}
    assert names == static
    claimed = {ep.racecheck for ep in Tentry.THREAD_ENTRY_POINTS
               if ep.racecheck is not None}
    assert claimed <= static
    for ep in Tentry.THREAD_ENTRY_POINTS:
        assert ep.racecheck or ep.why_uncovered, ep


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------

def test_port_tree_clean_within_budget():
    """The acceptance pin: zero findings on the port's tree, checked
    against the port's registries and tests, inside the reference's 30 s
    budget; the deliberate suppressions are recorded, not silent."""
    start = time.perf_counter()
    findings, suppressed, n_files = Tcore.run_analysis()
    elapsed = time.perf_counter() - start
    assert findings == [], "\n".join(f.render() for f in findings)
    assert suppressed == sum(_EXPECTED_PRAGMAS.values())
    assert n_files > 50
    assert elapsed < 30.0, f"flightcheck took {elapsed:.1f}s (budget 30s)"


def test_default_roots_are_the_ports():
    root, tests_dir = Tcore.resolve_roots()
    assert root == TPKG
    assert tests_dir == os.path.join(REPO, "tests")


#: Every suppression in the port's tree, pinned: the reference's FC102
#: pragmas at the same sites (its three FC201 ones police jax.jit, which
#: the port does not have).
_EXPECTED_PRAGMAS = {
    ("fleet/worker.py", "FC102"): 1,          # lock-free stop latch
    ("stream/engine.py", "FC102"): 2,         # lock-free stop latches
    ("stream/annotations.py", "FC102"): 5,    # worker-only counters
}


def _pragmas(pkg):
    out = []
    for sf in Tcore.load_package(pkg):
        lines = sf.text.splitlines()
        for lineno, rules in sorted(sf.ignores.items()):
            line = lines[lineno - 1]
            out.append((sf.relpath, tuple(sorted(rules)),
                        line.split("]", 1)[1].strip(" -—#")))
    return out


def test_pragma_audit_every_suppression_is_pinned_and_justified():
    found = {}
    for relpath, rules, why in _pragmas(TPKG):
        assert why, f"{relpath}: pragma without a justification string"
        for rule in rules:
            found[(relpath, rule)] = found.get((relpath, rule), 0) + 1
    assert found == _EXPECTED_PRAGMAS
    # each carries the reference's own justification for the same site
    want = sorted(p for p in _pragmas(JPKG) if p[1] == ("FC102",))
    assert sorted(_pragmas(TPKG)) == want


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_main_inprocess(capsys):
    from fraud_detection_tpu_torch.analysis.__main__ import main

    assert main(["--no-cache"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s), 8 suppressed by pragma" in out
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in Tcore.RULES:
        assert rule in out
    assert "FC201" not in out and "FC202" not in out
    assert main(["--rules", "FC999"]) == 2
    assert main(["--rules", "FC201"]) == 2     # no such rule in the port
    assert main(["--dry-run"]) == 2            # --dry-run requires --fix


def test_cli_json_sarif_and_fix_dry_run(tmp_path, capsys):
    from fraud_detection_tpu_torch.analysis.__main__ import main

    out_path = tmp_path / "flightcheck.sarif"
    assert main(["--json", "--no-cache", "--sarif", str(out_path), "--fix",
                 "--dry-run"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == [] and payload["fix_edits"] == []
    assert payload["suppressed"] == 8 and payload["files"] > 50
    doc = json.loads(out_path.read_text())
    assert Tsarif.validate(doc) == []
    assert doc["runs"][0]["tool"]["driver"]["name"] == Tsarif.TOOL_NAME
    assert doc["runs"][0]["properties"]["suppressedByPragma"] == 8


def test_cli_fix_scaffolds_fixture_tree_as_jax(tmp_path, capsys):
    from fraud_detection_tpu.analysis.__main__ import main as jmain
    from fraud_detection_tpu_torch.analysis.__main__ import main as tmain

    outs = {}
    for label, main in (("jax", jmain), ("port", tmain)):
        root = _fix_root(tmp_path, label, ["fx_lock_leak.py"])
        argv = ["--root", str(root), "--rules", "FC404", "--fix",
                "--no-cache"]
        assert main(argv) == 1
        first = capsys.readouterr().out
        assert "2 edit(s) applied" in first
        assert main(argv) == 0
        second = capsys.readouterr().out
        assert "0 finding(s), 2 suppressed" in second
        outs[label] = (first.replace(str(root), "<root>"),
                       second.replace(str(root), "<root>"),
                       (root / "fx_lock_leak.py").read_bytes())
    assert outs["port"] == outs["jax"]
