"""Incremental analysis cache — per-file summaries keyed on content hash;
twin of ``fraud_detection_tpu/analysis/cache.py``.

flightcheck's wall budget is pinned at 30s (tests/test_torch_flightcheck.py
``test_port_tree_clean_within_budget``) and the tree only grows. The passes
split cleanly in two: FILE-LOCAL rules (per-class concurrency FC101/FC102,
commit-protocol FC401-FC404, the hot-path lints FC203/FC204) whose findings depend
only on one file's source plus the registry configuration, and
WHOLE-PROGRAM passes (cross-object call graph, thread-map sync,
health-schema, the FC5xx protocol spec) that must always see every file.
This cache stores the file-local findings per file under
``.flightcheck_cache/`` (repo root, gitignored), keyed by:

* the file's content hash — any edit misses;
* a salt folding in (a) the source of every file-local analyzer module and
  (b) the repr of the registry objects the rules read
  (``CONCURRENT_CLASSES``, ``COMMIT_PROTOCOLS``, ``HOT_PATHS``) — so
  changing a rule or a registry entry invalidates EVERYTHING rather than
  serving stale verdicts.

Entries are plain JSON (one small file per source file), written
atomically; any read problem is a miss, never an error — a cache must not
be able to break the analyzer. Hit/miss counts surface in the CLI's
``--verbose`` output.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional

from fraud_detection_tpu_torch.analysis.core import Finding

#: bump to invalidate every cache entry on semantic changes the salt
#: cannot see (e.g. the meaning of a stored field).
CACHE_FORMAT = 1


def _registry_salt() -> str:
    """Hash of everything file-local findings depend on besides the file.

    The checker/spec sources (checker.py, conformance.py, entrypoints.py)
    are folded in too: their registries (FLEET_PROTOCOLS, the mutation
    and invariant catalogs) feed pragma justification and FC5xx context
    that file-local passes cite, so editing a spec must never serve a
    stale lint verdict (tests/test_torch_flightcheck.py pins the
    invalidation)."""
    import fraud_detection_tpu_torch.analysis.checker as _k
    import fraud_detection_tpu_torch.analysis.concurrency as _c
    import fraud_detection_tpu_torch.analysis.conformance as _f
    import fraud_detection_tpu_torch.analysis.synclint as _j
    import fraud_detection_tpu_torch.analysis.protocol as _p
    from fraud_detection_tpu_torch.analysis import entrypoints

    h = hashlib.sha256()
    h.update(str(CACHE_FORMAT).encode())
    for mod in (_c, _j, _p, _k, _f, entrypoints):
        try:
            with open(mod.__file__, "rb") as f:
                h.update(f.read())
        except OSError:
            h.update(repr(mod).encode())
    h.update(_stable(dict(entrypoints.CONCURRENT_CLASSES)).encode())
    h.update(_stable(entrypoints.COMMIT_PROTOCOLS).encode())
    h.update(_stable(entrypoints.HOT_PATHS).encode())
    h.update(_stable(entrypoints.FLEET_PROTOCOLS).encode())
    return h.hexdigest()[:16]


def _stable(obj) -> str:
    """Deterministic serialization: ``repr`` of a frozenset (and dict
    iteration of registry mappings) is hash-seed ordered, which made every
    fresh process miss the whole cache — sort containers recursively."""
    if isinstance(obj, (frozenset, set)):
        return "{" + ",".join(sorted(_stable(x) for x in obj)) + "}"
    if isinstance(obj, dict):
        return "{" + ",".join(
            f"{_stable(k)}:{_stable(v)}"
            for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))) + "}"
    if isinstance(obj, (tuple, list)):
        return "[" + ",".join(_stable(x) for x in obj) + "]"
    if hasattr(obj, "__dataclass_fields__"):
        return (type(obj).__name__ + "("
                + ",".join(f"{f}={_stable(getattr(obj, f))}"
                           for f in sorted(obj.__dataclass_fields__)) + ")")
    return repr(obj)


class AnalysisCache:
    """File-local findings, one JSON entry per (file content, salt)."""

    def __init__(self, cache_dir: str):
        self.dir = cache_dir
        self.hits = 0
        self.misses = 0
        self._salt = _registry_salt()
        try:
            os.makedirs(cache_dir, exist_ok=True)
            self._usable = True
        except OSError:
            self._usable = False

    def _key(self, text: str) -> str:
        h = hashlib.sha256()
        h.update(self._salt.encode())
        h.update(b"\x00")
        h.update(text.encode("utf-8", "surrogatepass"))
        return h.hexdigest()[:32]

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.json")

    def get(self, sf) -> Optional[List[Finding]]:
        """Cached file-local findings for this exact content, or None."""
        if not self._usable:
            self.misses += 1
            return None
        try:
            with open(self._path(self._key(sf.text)),
                      encoding="utf-8") as f:
                doc = json.load(f)
            findings = [Finding(d["rule"], d["path"], int(d["line"]),
                                d["message"])
                        for d in doc["findings"]]
        except (OSError, ValueError, KeyError, TypeError):
            self.misses += 1
            return None
        self.hits += 1
        return findings

    def put(self, sf, findings: List[Finding]) -> None:
        if not self._usable:
            return
        path = self._path(self._key(sf.text))
        tmp = f"{path}.tmp{os.getpid()}"
        doc = {"relpath": sf.relpath,
               "findings": [{"rule": f.rule, "path": f.path,
                             "line": f.line, "message": f.message}
                            for f in findings]}
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses}


def default_cache_dir(package_root: str) -> str:
    """``.flightcheck_cache/`` next to the package (the repo root)."""
    return os.path.join(os.path.dirname(os.path.abspath(package_root)),
                        ".flightcheck_cache")
