"""Filesystem model registry: versioned, atomic, verified, watchable — twin
of ``fraud_detection_tpu/registry/registry.py``, with the same layout and
manifest, so a version published by either package verifies and loads in
the other.

Layout (one directory per published version, never mutated after publish):

    <root>/v0001/manifest.json        registry manifest (below)
    <root>/v0001/checkpoint/          a native checkpoint (checkpoint/native.py)
    <root>/audit.jsonl                append-only lifecycle event log

The version manifest carries the registry schema version, creation time,
a SHA-256 content hash of every checkpoint file, the parent version this
model was trained to replace, and the training metrics the publisher chose
to attach. ``load()`` re-hashes every file against the manifest before a
single byte reaches the model loader — a corrupted or truncated checkpoint
fails loudly with the offending filename instead of scoring garbage.

Publish is ATOMIC: the whole version directory is assembled under a hidden
``.publish-*`` temp dir in the same filesystem and enters the namespace via
one ``os.replace`` to ``vNNNN``. A crash mid-publish leaves only a hidden
temp dir that every listing skips; readers can never observe a torn
version. Concurrent publishers race on the version number — the loser's
rename fails (the directory exists and is non-empty) and retries with the
next number, so both publishes land, ordered.

``watch()`` is poll-based (no inotify dependency): the root directory's
mtime changes whenever a rename lands a new version, so the cheap pre-check
is one ``stat``; only then is the directory re-listed and filtered to
versions whose manifest is present (i.e. fully published).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

SCHEMA_VERSION = 1
MANIFEST_NAME = "manifest.json"
CHECKPOINT_SUBDIR = "checkpoint"
AUDIT_LOG = "audit.jsonl"
_VERSION_RE = re.compile(r"^v(\d{4,})$")
_HASH_CHUNK = 1 << 20


class RegistryError(RuntimeError):
    """Registry misuse or unreadable state (empty registry, unknown version)."""


class RegistryIntegrityError(RegistryError):
    """A version's on-disk bytes do not match its manifest hashes — the
    checkpoint is corrupted/truncated and must not be loaded."""


@dataclass(frozen=True)
class ModelVersion:
    """One published version: its number, directory, and parsed manifest."""

    version: int
    path: str
    manifest: dict

    @property
    def checkpoint_path(self) -> str:
        return os.path.join(self.path, CHECKPOINT_SUBDIR)

    @property
    def name(self) -> str:
        return f"v{self.version:04d}"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(_HASH_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    """Durably record directory entries (best-effort on non-POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class ModelRegistry:
    """Versioned model store rooted at one directory (see module docstring)."""

    def __init__(self, root: str, clock=time.time):
        self.root = root
        self._clock = clock
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------
    # listing / reading
    # ------------------------------------------------------------------

    def list_versions(self) -> List[int]:
        """Published version numbers, ascending. A directory counts only if
        its manifest exists — publish is atomic, so this also filters any
        hand-made partial dirs (they are torn publishes by definition)."""
        out = []
        try:
            entries = os.listdir(self.root)
        except FileNotFoundError:
            return out
        for name in entries:
            m = _VERSION_RE.match(name)
            if m and os.path.isfile(os.path.join(self.root, name, MANIFEST_NAME)):
                out.append(int(m.group(1)))
        out.sort()
        return out

    def get(self, version: int) -> ModelVersion:
        path = os.path.join(self.root, f"v{version:04d}")
        manifest_path = os.path.join(path, MANIFEST_NAME)
        try:
            with open(manifest_path) as fh:
                manifest = json.load(fh)
        except FileNotFoundError:
            raise RegistryError(
                f"registry {self.root}: version v{version:04d} does not exist "
                f"(published: {self.list_versions() or 'none'})")
        except ValueError as e:
            raise RegistryIntegrityError(
                f"registry {self.root}: v{version:04d}/{MANIFEST_NAME} is not "
                f"valid JSON ({e}) — torn or corrupted manifest")
        return ModelVersion(version, path, manifest)

    def latest(self) -> Optional[ModelVersion]:
        versions = self.list_versions()
        return self.get(versions[-1]) if versions else None

    # ------------------------------------------------------------------
    # publishing
    # ------------------------------------------------------------------

    def publish(self, featurizer, model, *, metrics: Optional[dict] = None,
                parent: Optional[int] = None,
                extra: Optional[dict] = None) -> ModelVersion:
        """Save ``featurizer`` + ``model`` as the next version (atomic).

        ``parent`` defaults to the current latest version — the lineage
        field promotion/rollback audits refer to. ``metrics`` is the
        publisher's training/eval summary, carried verbatim in the manifest
        (and shown in audit events / eval reports)."""
        from fraud_detection_tpu_torch.checkpoint.native import save_checkpoint

        def write(ckpt_dir: str) -> None:
            save_checkpoint(ckpt_dir, featurizer, model)

        return self._publish_with(write, metrics=metrics, parent=parent,
                                  extra=extra)

    def publish_dir(self, checkpoint_dir: str, *,
                    metrics: Optional[dict] = None,
                    parent: Optional[int] = None,
                    extra: Optional[dict] = None) -> ModelVersion:
        """Publish an existing native checkpoint directory (copied in)."""
        if not os.path.isfile(os.path.join(checkpoint_dir, "manifest.json")):
            raise RegistryError(
                f"{checkpoint_dir} is not a native checkpoint directory "
                "(no manifest.json)")

        def write(ckpt_dir: str) -> None:
            shutil.copytree(checkpoint_dir, ckpt_dir, dirs_exist_ok=True)

        return self._publish_with(write, metrics=metrics, parent=parent,
                                  extra=extra)

    def _publish_with(self, write_checkpoint, *, metrics, parent,
                      extra) -> ModelVersion:
        if parent is None:
            prior = self.latest()
            parent = prior.version if prior is not None else None
        tmp = tempfile.mkdtemp(prefix=".publish-", dir=self.root)
        try:
            ckpt_dir = os.path.join(tmp, CHECKPOINT_SUBDIR)
            os.makedirs(ckpt_dir, exist_ok=True)
            write_checkpoint(ckpt_dir)
            files = {}
            for dirpath, _, names in os.walk(ckpt_dir):
                for name in sorted(names):
                    full = os.path.join(dirpath, name)
                    rel = os.path.relpath(full, tmp)
                    files[rel] = {"sha256": _sha256_file(full),
                                  "bytes": os.path.getsize(full)}
            ckpt_meta_path = os.path.join(ckpt_dir, "manifest.json")
            with open(ckpt_meta_path) as fh:
                model_kind = json.load(fh).get("model_kind")
            manifest = {
                "schema_version": SCHEMA_VERSION,
                "created_at": self._clock(),
                "model_kind": model_kind,
                "files": files,
                "metrics": metrics,
                "parent": parent,
            }
            if extra:
                manifest.update(extra)
            manifest_tmp = os.path.join(tmp, MANIFEST_NAME)
            with open(manifest_tmp, "w") as fh:
                json.dump(manifest, fh, indent=2)
                fh.flush()
                os.fsync(fh.fileno())
            # Allocate the version number LAST and enter the namespace with
            # one rename. A concurrent publisher that wins the same number
            # makes this replace fail (existing non-empty dir) — retry with
            # the next number; both publishes land.
            versions = self.list_versions()
            n = (versions[-1] if versions else 0) + 1
            while True:
                target = os.path.join(self.root, f"v{n:04d}")
                try:
                    os.replace(tmp, target)
                    break
                except OSError:
                    if not os.path.exists(target):
                        raise      # not a version-number race: surface it
                    n += 1
            _fsync_dir(self.root)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        mv = ModelVersion(n, target, manifest)
        self.audit("publish", version=n, parent=parent,
                   model_kind=model_kind, metrics=metrics)
        return mv

    # ------------------------------------------------------------------
    # verification / loading
    # ------------------------------------------------------------------

    def verify(self, version: int) -> ModelVersion:
        """Re-hash every checkpoint file against the manifest; raises
        ``RegistryIntegrityError`` naming the first offending file."""
        mv = self.get(version)
        files = mv.manifest.get("files")
        if not isinstance(files, dict) or not files:
            raise RegistryIntegrityError(
                f"{mv.name}: manifest carries no file hashes "
                "(schema_version "
                f"{mv.manifest.get('schema_version')!r}) — cannot verify")
        for rel, meta in files.items():
            full = os.path.join(mv.path, rel)
            if not os.path.isfile(full):
                raise RegistryIntegrityError(
                    f"{mv.name}: checkpoint file {rel!r} is missing — "
                    "torn or tampered version directory")
            size = os.path.getsize(full)
            if size != meta["bytes"]:
                raise RegistryIntegrityError(
                    f"{mv.name}: {rel!r} is {size} bytes, manifest says "
                    f"{meta['bytes']} — truncated or corrupted checkpoint")
            digest = _sha256_file(full)
            if digest != meta["sha256"]:
                raise RegistryIntegrityError(
                    f"{mv.name}: {rel!r} content hash mismatch "
                    f"(sha256 {digest[:12]}… != manifest "
                    f"{meta['sha256'][:12]}…) — corrupted checkpoint; "
                    "refusing to load")
        return mv

    def load(self, version: Optional[int] = None, *, batch_size: int = 256,
             device="cuda", **kwargs) -> Tuple[ModelVersion, "object"]:
        """Verify + load a version (default: latest) as a ServingPipeline on
        ``device``; ``kwargs`` go to the pipeline's constructor."""
        from fraud_detection_tpu_torch.models.pipeline import ServingPipeline

        if version is None:
            latest = self.latest()
            if latest is None:
                raise RegistryError(
                    f"registry {self.root} has no published versions")
            version = latest.version
        mv = self.verify(version)
        pipe = ServingPipeline.from_checkpoint(
            mv.checkpoint_path, device=device, batch_size=batch_size, **kwargs)
        return mv, pipe

    # ------------------------------------------------------------------
    # watching
    # ------------------------------------------------------------------

    def poll_new(self, after: int) -> List[ModelVersion]:
        """All fully-published versions > ``after``, ascending."""
        return [self.get(v) for v in self.list_versions() if v > after]

    def _root_mtime(self) -> int:
        try:
            return os.stat(self.root).st_mtime_ns
        except OSError:
            return -1

    def watch(self, interval: float = 2.0, *, after: Optional[int] = None,
              stop=None, sleep=time.sleep) -> Iterator[ModelVersion]:
        """Yield new versions as they are published (poll-based).

        One ``stat`` of the root per tick; the directory is re-listed only
        when its mtime moved (a publish's rename always moves it). Versions
        are yielded in order and exactly once; ``after`` seeds the cursor
        (default: current latest). ``stop`` is an optional
        ``threading.Event``-like object ending the generator."""
        if after is None:
            latest = self.latest()
            after = latest.version if latest is not None else 0
        last_mtime = -2  # != any real value: always scan once on entry
        while stop is None or not stop.is_set():
            mtime = self._root_mtime()
            if mtime != last_mtime:
                last_mtime = mtime
                for mv in self.poll_new(after):
                    after = mv.version
                    yield mv
            if stop is not None and stop.wait(interval):
                return
            if stop is None:
                sleep(interval)

    # ------------------------------------------------------------------
    # audit log
    # ------------------------------------------------------------------

    def audit(self, event: str, **fields) -> dict:
        """Append one lifecycle event to ``audit.jsonl`` (single line write,
        flushed + fsynced — the log is the promotion/rollback evidence)."""
        record = {"ts": self._clock(), "event": event, **fields}
        line = json.dumps(record, sort_keys=True)
        with open(os.path.join(self.root, AUDIT_LOG), "a") as fh:
            fh.write(line + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        return record

    def read_audit(self) -> List[dict]:
        path = os.path.join(self.root, AUDIT_LOG)
        if not os.path.isfile(path):
            return []
        out = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out
