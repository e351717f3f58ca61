"""Checkpoints: atomic, digest-verified snapshots of a tree of tensors.

The reference's format (``src/repro/checkpoint/checkpoint.py``), so a
checkpoint the reference wrote restores here:

* ``save`` flattens the tree (tuples and lists in order, dicts by sorted
  key, a dotted ``state_dict`` key sorting as the nested path it names)
  into one ``leaves.npz`` plus a ``manifest.json`` carrying the blob's
  sha256, written to a temporary directory (every file fsynced) and then
  renamed into place, so a crash mid-save never corrupts the newest
  checkpoint. ``blocking=False`` copies to the host, then writes on a
  thread. The newest ``keep`` steps are retained. The fault plan's
  ``checkpoint`` site fires before any file I/O and its ``kill`` site
  between the temporary write and the rename (``runtime/fault.py``).
* A bfloat16 leaf is stored as the reference's numpy stores one: its two
  bytes a value as a ``|V2`` array, read back by bit view.
* :func:`verify` recomputes the digest; :func:`latest_step` returns the
  newest step that passes, skipping a truncated or bit-flipped one, and
  :func:`restore` refuses corrupt input.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from collections.abc import Mapping

import numpy as np
import torch


def _sort_key(k) -> tuple:
    return tuple(str(k).split("."))


def tree_leaves(tree) -> list:
    """Leaves of ``tree`` in the reference's (``jax.tree_util``) order."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree, key=_sort_key)
                for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for node in tree for x in tree_leaves(node)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure filled from the iterator ``leaves``."""
    if isinstance(like, Mapping):
        filled = {k: _unflatten(like[k], leaves)
                  for k in sorted(like, key=_sort_key)}
        return {k: filled[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(node, leaves) for node in like)
    return next(leaves)


def _describe(tree) -> str:
    if isinstance(tree, Mapping):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree, key=_sort_key)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_describe(x) for x in tree) + ")"
    return "*"


def host_array(x) -> np.ndarray:
    """``x`` as the numpy array a checkpoint stores."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:        # numpy has no bfloat16: raw bytes
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def _from_host(h: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if h.dtype.kind == "V" and h.dtype.itemsize == 2:
        t = torch.from_numpy(h.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(h)
    return t.to(device=like.device, dtype=like.dtype)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step-{step:010d}")


def save(directory: str, step: int, tree, *, keep: int = 3,
         blocking: bool = True) -> threading.Thread | None:
    """Write checkpoint ``step``; returns the writer thread if not
    ``blocking`` (the copy to the host happens before this returns).

    Raises before any file I/O when a fault plan targets the
    ``checkpoint`` site; the atomic rename keeps the previous checkpoint
    intact either way."""
    from repro_torch.runtime import fault    # deferred: fault imports this
    fault.check("checkpoint")
    host = [host_array(x) for x in tree_leaves(tree)]
    treedef = _describe(tree)

    def _write():
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory, f".tmp-{step}")
        final = _step_dir(directory, step)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        blob = os.path.join(tmp, "leaves.npz")
        with open(blob, "wb") as f:
            np.savez(f, **{f"leaf_{i}": a for i, a in enumerate(host)})
            f.flush()
            os.fsync(f.fileno())
        with open(blob, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest = {"step": step, "treedef": treedef, "n_leaves": len(host),
                    "time": time.time(), "sha256": digest}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_file(tmp)
        fault.check("kill")          # mid-checkpoint SIGKILL point: the
        shutil.rmtree(final, ignore_errors=True)     # tmp dir is complete
        os.rename(tmp, final)                        # atomic commit
        _fsync_file(directory)
        _gc(directory, keep)

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(directory: str, keep: int) -> None:
    for s in all_steps(directory)[:-keep]:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def verify(directory: str, step: int) -> bool:
    """True iff checkpoint ``step`` is complete and its blob matches the
    manifest's digest. A manifest without a digest passes (nothing to
    check against); any read or parse error fails."""
    path = _step_dir(directory, step)
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(path, "leaves.npz"), "rb") as f:
            blob = f.read()
        want = manifest.get("sha256")
        if want is not None and hashlib.sha256(blob).hexdigest() != want:
            return False
        with np.load(os.path.join(path, "leaves.npz")) as data:
            return len(data.files) == manifest["n_leaves"]
    except Exception:                                # noqa: BLE001
        return False


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name.split("-")[1]) for name in os.listdir(directory)
                  if name.startswith("step-") and os.path.isfile(
                      os.path.join(directory, name, "manifest.json")))


def latest_step(directory: str) -> int | None:
    """Newest step that passes :func:`verify`: a corrupt newest step is
    skipped and the one before it served."""
    for s in reversed(all_steps(directory)):
        if verify(directory, s):
            return s
    return None


def _sharding_leaves(tree) -> list:
    """The leaves of a tree of ``launch.shardings.Sharding`` (a
    NamedTuple, so a leaf here) in :func:`tree_leaves` order."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree, key=_sort_key)
                for x in _sharding_leaves(tree[k])]
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not hasattr(tree, "placements")):
        return [x for node in tree for x in _sharding_leaves(node)]
    return [tree]


def restore(directory: str, step: int, like, *, shardings=None):
    """Rebuild a tree shaped like ``like``, each leaf a tensor of that
    leaf's dtype and device. Verifies the digest first and refuses corrupt
    input (``ValueError``), or a checkpoint of another structure.

    ``shardings`` (a tree of ``launch.shardings.Sharding`` shaped like
    ``like``, or one for every leaf) places each leaf onto the current
    mesh, the reference's elastic placement: each rank keeps its own shard
    of the full leaf as a DTensor, whatever mesh wrote the checkpoint."""
    if not verify(directory, step):
        raise ValueError(
            f"checkpoint step {step} in {directory!r} is corrupt or "
            f"incomplete (digest/manifest mismatch)")
    leaves_like = tree_leaves(like)
    with np.load(os.path.join(_step_dir(directory, step),
                              "leaves.npz")) as data:
        if len(data.files) != len(leaves_like):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                             f"the tree wants {len(leaves_like)}")
        host = [data[f"leaf_{i}"] for i in range(len(leaves_like))]
    if shardings is None:
        placed = [None] * len(host)
    elif hasattr(shardings, "placements"):
        placed = [shardings] * len(host)
    else:
        placed = _sharding_leaves(shardings)
        if len(placed) != len(host):
            raise ValueError(f"{len(placed)} shardings for {len(host)} "
                             f"leaves")
    out = []
    for h, like_leaf, sh in zip(host, leaves_like, placed):
        if tuple(h.shape) != tuple(like_leaf.shape):
            raise ValueError(f"leaf shape {h.shape} != {like_leaf.shape}")
        t = _from_host(h, like_leaf)
        if sh is not None:
            from repro_torch.launch.shardings import place
            t = place(t, sh)
        out.append(t)
    return _unflatten(like, iter(out))
