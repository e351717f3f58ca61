"""Durable content-addressed snapshots: the crash-safe persistence layer.

A :class:`SnapshotStore` is a directory of versioned, checksummed,
content-keyed files. The plan cache and the pinned tier write through to
it, and a restarted ``launch/train.py`` or ``launch/spconv_serve.py``
reads through it, so a redeploy pays no map search for a geometry it has
seen. The serving engine also journals every admitted request in one until
its result is final (``ServeEngine.recover``).

Durability, for every write and every entry, as in the reference
(``src/repro/runtime/persist.py``):

  * **atomic commit**: serialize to a temporary file in the same
    directory, flush and ``fsync``, ``os.replace`` it onto the entry's
    name and fsync the directory. A kill at any instant leaves the old
    bytes or the new, never a torn file under the entry's name.
  * **per-entry verification**: each entry carries a magic string, a
    format version, a salt (:func:`default_salt`: the format version, the
    codec revision and the torch version), the encoded key and a sha256
    over spec and payload. A load checks all of it.
  * **never crash on bad state**: a truncated, bit-flipped, foreign,
    stale-salted or wrong-versioned file is deleted, counted in
    ``persist.dropped`` and read as a cold entry.

Keys are array-free trees (tuples, ints, strings: the plan cache's content
fingerprints and build statics). Values are trees of tensors, numpy arrays
and the port's NamedTuples (``ConvPlan``, ``TapTiles``, ``StridedMaps``,
``QueryTable``), round-tripped bit for bit by :func:`encode` /
:func:`decode`: a tensor is saved as numpy through ``.cpu()`` and decoded
onto a given device.

The fault sites ``persist.save`` and ``persist.load`` (runtime/fault.py)
are checked in :meth:`SnapshotStore.put` / :meth:`SnapshotStore.get` and
absorbed: a skipped write or a cold read, counted in ``persist.fault``.
The ``kill`` site sits in :meth:`put` between the temporary write and the
rename.

Flags (``runtime/flags.py`` lists all of the port's):
``REPRO_PERSIST_DIR`` (the default store of the launch entry
points), ``REPRO_PERSIST_MAX_BYTES`` (the on-disk budget, oldest evicted
first), ``REPRO_PERSIST_VERIFY`` (``0`` skips the checksum on load;
version, salt and key are always checked), ``REPRO_PERSIST_SALT`` (salt
override, to model a code-version bump).
"""
from __future__ import annotations

import hashlib
import importlib
import io
import json
import logging
import os
import time

import numpy as np
import torch

from repro_torch.runtime import fault

log = logging.getLogger("repro_torch.persist")

#: bump when the entry format or the codec changes incompatibly: old
#: entries then read as stale and cold-start instead of mis-decoding
SNAPSHOT_VERSION = 1

#: codec revision, part of the salt: bumped when the meaning of persisted
#: values changes (a field reorder) while the file format still parses
CODEC_REVISION = "2026-10-torch-plan-without-tiles"

#: persisted NamedTuples must come from this package
_OWN_PREFIX = "repro_torch."

_MAGIC = b"SPOCTA-TORCH-SNAP\n"
_SUFFIX = ".snap"


def default_salt() -> str:
    """The invalidation salt of every entry: the format version, the codec
    revision and the running torch version (a plan built under one torch
    may carry its layout decisions). ``REPRO_PERSIST_SALT`` overrides."""
    env = os.environ.get("REPRO_PERSIST_SALT")
    if env:
        return env
    return f"v{SNAPSHOT_VERSION}/{CODEC_REVISION}/torch-{torch.__version__}"


def _verify_enabled() -> bool:
    return os.environ.get("REPRO_PERSIST_VERIFY", "1") != "0"


def default_max_bytes() -> int:
    """``REPRO_PERSIST_MAX_BYTES``: the on-disk budget (default 256 MiB)."""
    return int(os.environ.get("REPRO_PERSIST_MAX_BYTES",
                              str(256 * 2 ** 20)))


def default_dir() -> str | None:
    """``REPRO_PERSIST_DIR``, or None when persistence is off."""
    return os.environ.get("REPRO_PERSIST_DIR") or None


# ---------------------------------------------------------------------------
# Structural codec: restricted trees <-> (JSON spec, array list)
# ---------------------------------------------------------------------------

def encode(obj, arrays: list | None = None):
    """``(spec, arrays)``: a JSON-able spec of ``obj`` and its array leaves.

    Handles None, bool/int/float/str, tensors (saved through ``.cpu()``),
    numpy arrays, tuples, lists, string-keyed dicts and NamedTuples of
    ``repro_torch.*`` modules (stored by import path, so that they decode
    as themselves). Anything else raises TypeError: the store keeps its
    format closed.
    """
    if arrays is None:
        arrays = []
    if obj is None:
        return {"t": "none"}, arrays
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}, arrays
    if isinstance(obj, torch.Tensor):
        arrays.append(obj.detach().cpu().numpy())
        return {"t": "tensor", "i": len(arrays) - 1}, arrays
    if isinstance(obj, (np.ndarray, np.generic)):
        arrays.append(np.asarray(obj))
        return {"t": "arr", "i": len(arrays) - 1}, arrays
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = type(obj)
        if not cls.__module__.startswith(_OWN_PREFIX):
            raise TypeError(f"refusing to persist foreign NamedTuple {cls}")
        specs = [encode(v, arrays)[0] for v in obj]
        return {"t": "nt", "cls": f"{cls.__module__}:{cls.__qualname__}",
                "v": specs}, arrays
    if isinstance(obj, (tuple, list)):
        specs = [encode(v, arrays)[0] for v in obj]
        return {"t": "tuple" if isinstance(obj, tuple) else "list",
                "v": specs}, arrays
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("persisted dicts must be string-keyed")
        return {"t": "dict",
                "v": {k: encode(v, arrays)[0] for k, v in obj.items()}}, \
            arrays
    raise TypeError(f"cannot persist value of type {type(obj)!r}")


def decode(spec, arrays, *, device: str | torch.device | None = None):
    """Inverse of :func:`encode`. Tensor leaves come back on ``device``
    (None: the CPU), numpy leaves as numpy. Classes resolve only inside
    ``repro_torch.*``, so a tampered spec cannot import other code."""
    t = spec["t"]
    if t == "none":
        return None
    if t == "py":
        return spec["v"]
    if t == "tensor":
        a = arrays[spec["i"]]
        out = torch.from_numpy(a if a.flags.writeable else a.copy())
        return out if device is None else out.to(device)
    if t == "arr":
        return arrays[spec["i"]]
    if t == "tuple":
        return tuple(decode(s, arrays, device=device) for s in spec["v"])
    if t == "list":
        return [decode(s, arrays, device=device) for s in spec["v"]]
    if t == "dict":
        return {k: decode(s, arrays, device=device)
                for k, s in spec["v"].items()}
    if t == "nt":
        mod, _, qual = spec["cls"].partition(":")
        if not mod.startswith(_OWN_PREFIX):
            raise ValueError(f"refusing foreign class {spec['cls']!r}")
        cls = importlib.import_module(mod)
        for part in qual.split("."):
            cls = getattr(cls, part)
        return cls(*(decode(s, arrays, device=device) for s in spec["v"]))
    raise ValueError(f"unknown spec tag {t!r}")


def _dumps(spec) -> str:
    return json.dumps(spec, sort_keys=True, separators=(",", ":"))


def _key_json(key) -> str:
    spec, arrays = encode(key)
    if arrays:
        raise TypeError("snapshot keys must be array-free")
    return _dumps(spec)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _note(name: str, n: int = 1) -> None:
    from repro_torch.runtime import guard
    guard.health().note(name, n)


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

class SnapshotStore:
    """Durable, content-keyed, checksummed on-disk store.

    One file per entry, named by the sha256 of the encoded key. Writes are
    atomic, reads verified (magic, version, salt, key, sha256 over spec and
    payload); an entry that fails is deleted, counted in
    ``persist.dropped`` and served as a miss: loading never raises on bad
    state.

    Args:
      directory: the store directory (made on the first write).
      max_bytes: on-disk budget (None: :func:`default_max_bytes`). Oldest
        entries (by mtime) are evicted to admit a new one; an entry larger
        than the whole budget is skipped, not written.
      verify: checksum on load (None: ``REPRO_PERSIST_VERIFY``).
      salt: invalidation salt (None: :func:`default_salt`).
      device: where decoded tensors go unless a read names another (None:
        the CPU).

    Counters (:meth:`stats`): ``saves``, ``save_skips``, ``hits``,
    ``misses``, ``dropped``, ``evictions``, ``faults``, ``bytes_written``
    and ``write_ms`` (host time of the committed writes); mirrored in the
    health bag as ``persist.*``.
    """

    def __init__(self, directory: str, *, max_bytes: int | None = None,
                 verify: bool | None = None, salt: str | None = None,
                 device: str | torch.device | None = None):
        self.directory = directory
        self.max_bytes = default_max_bytes() if max_bytes is None \
            else max_bytes
        self.verify = _verify_enabled() if verify is None else verify
        self.salt = default_salt() if salt is None else salt
        self.device = device
        self.saves = 0
        self.save_skips = 0
        self.hits = 0
        self.misses = 0
        self.dropped = 0
        self.evictions = 0
        self.faults = 0
        self.bytes_written = 0
        self.write_ms = 0.0

    # -- paths ----------------------------------------------------------------

    def _path_for(self, key_json: str) -> str:
        name = hashlib.sha256(key_json.encode()).hexdigest()[:40]
        return os.path.join(self.directory, name + _SUFFIX)

    def _entry_paths(self) -> list[str]:
        if not os.path.isdir(self.directory):
            return []
        return [os.path.join(self.directory, n)
                for n in sorted(os.listdir(self.directory))
                if n.endswith(_SUFFIX) and not n.startswith(".")]

    def resident_bytes(self) -> int:
        total = 0
        for p in self._entry_paths():
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return total

    def __len__(self) -> int:
        return len(self._entry_paths())

    # -- write ----------------------------------------------------------------

    def put(self, key, value) -> bool:
        """Persist ``value`` under ``key`` atomically; True on commit.

        False (counted) on an unencodable value, an injected
        ``persist.save`` fault, an entry over the byte budget or an I/O
        error: a failed save is a cold entry later, never a raise. The
        ``kill`` site fires between the temporary write and the rename.
        """
        t0 = time.perf_counter()
        try:
            fault.check("persist.save")
        except fault.InjectedFault:
            self.faults += 1
            _note("persist.fault")
            return False
        try:
            key_json = _key_json(key)
            spec, arrays = encode(value)
        except TypeError as e:
            self.save_skips += 1
            log.debug("snapshot save skipped: %s", e)
            return False
        spec_json = _dumps(spec)
        buf = io.BytesIO()
        np.savez(buf, **{f"a{i}": a for i, a in enumerate(arrays)})
        payload = buf.getvalue()
        digest = hashlib.sha256(spec_json.encode() + payload).hexdigest()
        header = _dumps(
            {"version": SNAPSHOT_VERSION, "salt": self.salt,
             "sha256": digest, "nbytes": len(payload),
             "key": json.loads(key_json), "spec": spec}).encode()
        blob = _MAGIC + header + b"\n" + payload
        if len(blob) > self.max_bytes:
            self.save_skips += 1
            return False
        final = self._path_for(key_json)
        tmp = os.path.join(self.directory,
                           f".tmp-{os.path.basename(final)}-{os.getpid()}")
        try:
            os.makedirs(self.directory, exist_ok=True)
            self._evict_for(len(blob), keep=final)
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            fault.check(fault.KILL_SITE)     # mid-snapshot SIGKILL point
            os.replace(tmp, final)           # atomic commit
            _fsync_dir(self.directory)
        except OSError as e:
            self.save_skips += 1
            _note("persist.save_error")
            log.warning("snapshot save failed for %s: %s", final, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self.saves += 1
        self.bytes_written += len(blob)
        self.write_ms += (time.perf_counter() - t0) * 1e3
        _note("persist.saved")
        return True

    def _evict_for(self, incoming: int, keep: str) -> None:
        """Oldest-first eviction to fit ``incoming`` bytes in the budget."""
        paths = [p for p in self._entry_paths() if p != keep]
        try:
            paths.sort(key=os.path.getmtime)
        except OSError:
            pass
        total = self.resident_bytes()
        for p in paths:
            if total + incoming <= self.max_bytes:
                return
            try:
                total -= os.path.getsize(p)
                os.unlink(p)
                self.evictions += 1
                _note("persist.evicted")
            except OSError:
                pass

    # -- read -----------------------------------------------------------------

    def _read_verified(self, path: str, expect_key_json: str | None,
                       device):
        """``(key, value)`` of one entry file, or None (the file dropped)
        on any defect."""
        try:
            with open(path, "rb") as f:
                blob = f.read()
            if not blob.startswith(_MAGIC):
                raise ValueError("bad magic")
            rest = blob[len(_MAGIC):]
            nl = rest.index(b"\n")
            header = json.loads(rest[:nl])
            payload = rest[nl + 1:]
            if header.get("version") != SNAPSHOT_VERSION:
                raise ValueError(f"version {header.get('version')!r}")
            if header.get("salt") != self.salt:
                raise ValueError("stale salt")
            if len(payload) != header.get("nbytes"):
                raise ValueError("truncated payload")
            spec = header["spec"]
            key_json = _dumps(header["key"])
            if expect_key_json is not None and key_json != expect_key_json:
                raise ValueError("key mismatch")
            if self.verify:
                digest = hashlib.sha256(
                    _dumps(spec).encode() + payload).hexdigest()
                if digest != header.get("sha256"):
                    raise ValueError("checksum mismatch")
            with np.load(io.BytesIO(payload)) as data:
                arrays = [data[f"a{i}"] for i in range(len(data.files))]
            return decode(header["key"], []), decode(spec, arrays,
                                                     device=device)
        except Exception as e:                       # noqa: BLE001
            # torn, bit-flipped, foreign or stale: a cold entry, not a crash
            self.dropped += 1
            _note("persist.dropped")
            log.warning("dropping corrupt/stale snapshot %s: %s", path, e)
            try:
                os.unlink(path)
            except OSError:
                pass
            return None

    def get(self, key, *, device: str | torch.device | None = None):
        """The verified value of ``key`` with its tensors on ``device``
        (None: the store's), or None (cold). Never raises: corrupt or
        stale entries are dropped and counted, an injected
        ``persist.load`` fault reads as a miss."""
        try:
            fault.check("persist.load")
        except fault.InjectedFault:
            self.faults += 1
            _note("persist.fault")
            return None
        try:
            key_json = _key_json(key)
        except TypeError:
            self.misses += 1
            return None
        path = self._path_for(key_json)
        if not os.path.isfile(path):
            self.misses += 1
            return None
        out = self._read_verified(path, key_json,
                                  self.device if device is None else device)
        if out is None:
            self.misses += 1
            return None
        self.hits += 1
        _note("persist.loaded")
        return out[1]

    def delete(self, key) -> None:
        try:
            os.unlink(self._path_for(_key_json(key)))
        except (OSError, TypeError):
            pass

    def items(self):
        """Verified ``(key, value)`` pairs, tensors on the store's device;
        corrupt, stale or foreign entries are dropped and counted, never
        raised."""
        for path in self._entry_paths():
            out = self._read_verified(path, None, self.device)
            if out is not None:
                yield out

    def entries(self):
        """``(key, path)`` of every entry file whose header parses. Nothing
        is verified or dropped: for tools that inspect or damage a store
        on purpose."""
        for path in self._entry_paths():
            try:
                with open(path, "rb") as f:
                    if f.read(len(_MAGIC)) != _MAGIC:
                        continue
                    key = decode(json.loads(f.readline())["key"], [])
            except (OSError, ValueError, KeyError, TypeError):
                continue
            yield key, path

    def stats(self) -> dict:
        return {"entries": len(self), "resident_bytes": self.resident_bytes(),
                "saves": self.saves, "save_skips": self.save_skips,
                "hits": self.hits, "misses": self.misses,
                "dropped": self.dropped, "evictions": self.evictions,
                "faults": self.faults, "bytes_written": self.bytes_written,
                "write_ms": self.write_ms}


def open_default(directory: str | None = None) -> SnapshotStore | None:
    """A store at ``directory`` (or ``REPRO_PERSIST_DIR``); None when
    neither is set, and callers run memory-only."""
    directory = directory or default_dir()
    if not directory:
        return None
    return SnapshotStore(directory)
