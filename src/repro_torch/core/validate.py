"""Input validation: the cloud sanitizer and its failure taxonomy.

A malformed frame from a perception pipeline must be repaired or refused
at ingestion, never reach a kernel. Each failure class a raw cloud can
show has a name, a per-class policy and a health counter
(``validate.<class>`` in :func:`repro_torch.runtime.guard.health`).

Failure classes (the :class:`CloudPolicy` fields), in the order the
passes run:

  ``shape``       coords not (N, 3), batch/valid/feats rows disagreeing
                  with N. Always rejected: the padded static shape is
                  structural.
  ``dtype``       non-integer coordinates or batch. ``repair`` casts
                  exact values and invalidates fractional rows.
  ``nonfinite``   NaN/Inf in float coords or feats. ``repair`` clears the
                  row's valid bit (and zeroes the bad feature entries).
  ``out_of_grid`` coords outside ``[0, 16 << grid_bits)`` or batch
                  outside ``[0, 1 << batch_bits)``. ``repair`` drops the
                  row, ``clip`` clamps it into the grid.
  ``duplicate``   two valid rows with one (batch, x, y, z). ``repair``
                  keeps the first.
  ``oversize``    more valid rows than ``max_valid``. ``repair`` keeps the
                  first ``max_valid``. Checked only with a budget.
  ``empty``       no valid row left. ``allow`` passes it through.

``reject`` raises a :class:`CloudValidationError` for the class.
Repairs never change shapes: a bad row is
invalidated, and a clean cloud comes back as the **original objects**.

The sanitizer runs on the host, in numpy, before a frame moves to the
device. It takes numpy arrays or CPU tensors and returns the same kind.
A capacity overflow is not a cloud fault: it is :class:`CapacityOverflow`
(also ``repro_torch.core.plan.CapacityOverflow``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import morton

#: failure class names, in the order the passes run
CLOUD_FAILURE_CLASSES = ("shape", "dtype", "nonfinite", "out_of_grid",
                         "duplicate", "oversize", "empty")


class CloudValidationError(ValueError):
    """A cloud broke its contract under a ``reject`` policy; ``kind`` is
    one of :data:`CLOUD_FAILURE_CLASSES`."""

    def __init__(self, kind: str, msg: str):
        super().__init__(f"[{kind}] {msg}")
        self.kind = kind


class CapacityOverflow(RuntimeError):
    """A static capacity is smaller than the scene needs: the octree
    directory (``what="block_table"``) or the Gconv3 output budget
    (``"candidates"``). The search would silently drop voxels or output
    sites, so it raises instead; ``needed`` and ``capacity`` drive the
    escalation of ``runtime.guard.with_replan``."""

    def __init__(self, what: str, msg: str, *, needed: int, capacity: int):
        super().__init__(msg)
        self.what = what
        self.needed = needed
        self.capacity = capacity


@dataclasses.dataclass(frozen=True)
class CloudPolicy:
    """Per-class policy: ``shape`` reject only; ``dtype``, ``nonfinite``,
    ``duplicate``, ``oversize``: ``repair`` | ``reject``; ``out_of_grid``:
    ``repair`` | ``clip`` | ``reject``; ``empty``: ``allow`` | ``reject``."""

    shape: str = "reject"
    dtype: str = "repair"
    nonfinite: str = "repair"
    out_of_grid: str = "repair"
    duplicate: str = "repair"
    oversize: str = "repair"
    empty: str = "allow"


#: repair everything repairable, allow empty clouds
REPAIR = CloudPolicy()
#: any violation raises
STRICT = CloudPolicy(dtype="reject", nonfinite="reject",
                     out_of_grid="reject", duplicate="reject",
                     oversize="reject", empty="reject")


class CloudReport(NamedTuple):
    """Outcome of one pass: ``counts`` maps each class to its affected row
    count (``empty`` is 0 or 1); ``changed`` is False iff the inputs came
    back unmodified."""

    counts: dict
    n_rows: int
    n_valid_in: int
    n_valid_out: int
    changed: bool

    @property
    def ok(self) -> bool:
        return not self.changed and all(v == 0 for v in self.counts.values())


def _note(kind: str, n: int) -> None:
    if n:
        from repro_torch.runtime import guard   # guard imports this module
        guard.health().note(f"validate.{kind}", n)


def _pack_keys(coords: np.ndarray, batch: np.ndarray) -> np.ndarray:
    """Collision-free int64 voxel key: batch | x | y | z at 16 bits each
    (in-grid coordinates are below 2^16)."""
    c = coords.astype(np.int64)
    return ((batch.astype(np.int64) << 48)
            | (c[:, 0] << 32) | (c[:, 1] << 16) | c[:, 2])


def _host(a):
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError("sanitize_cloud runs on the host: pass numpy "
                             f"arrays or CPU tensors, not {a.device}")
        return a.numpy()
    return np.asarray(a)


def sanitize_cloud(coords, batch, valid, feats=None, *, grid_bits: int = 7,
                   batch_bits: int = 4, policy: CloudPolicy | None = None,
                   max_valid: int | None = None):
    """Validate and repair one padded cloud against the taxonomy above.

    Args:
      coords, batch, valid: (N, 3), (N,), (N,) numpy arrays or CPU
        tensors.
      feats: optional (N, C) features, checked for non-finite values.
      grid_bits, batch_bits: the block-key budget the cloud is searched
        under, which defines the valid ranges.
      policy: a :class:`CloudPolicy` (default :data:`REPAIR`).
      max_valid: optional voxel budget (the ``oversize`` class).

    Returns ``(coords, batch, valid, feats, report)``: the original objects
    for a clean cloud, else fresh arrays of the same shapes, as tensors
    when ``coords`` was a tensor. Raises :class:`CloudValidationError` on
    a class whose policy rejects.
    """
    policy = policy or REPAIR
    as_torch = isinstance(coords, torch.Tensor)
    c, b, v = _host(coords), _host(batch), _host(valid)
    f = None if feats is None else _host(feats)

    counts = {k: 0 for k in CLOUD_FAILURE_CLASSES}

    # -- shape (always reject) ---------------------------------------------
    if c.ndim != 2 or c.shape[1] != 3:
        raise CloudValidationError(
            "shape", f"coords must be (N, 3), got {c.shape}")
    n = c.shape[0]
    if b.shape != (n,) or v.shape != (n,):
        raise CloudValidationError(
            "shape", f"batch/valid must be ({n},), got {b.shape}/{v.shape}")
    if f is not None and (f.ndim != 2 or f.shape[0] != n):
        raise CloudValidationError(
            "shape", f"feats must be ({n}, C), got {f.shape}")

    v_in = v.astype(bool)
    v_out = v_in.copy()
    c_out, b_out, f_out = c, b, f

    # -- dtype + non-finite coords -----------------------------------------
    if not np.issubdtype(c.dtype, np.integer):
        if policy.dtype == "reject":
            counts["dtype"] = int(v_out.sum())
            _note("dtype", counts["dtype"])
            raise CloudValidationError(
                "dtype", f"coords dtype {c.dtype} is not integral")
        fin = np.isfinite(c).all(axis=1)
        bad_nf = v_out & ~fin
        if bad_nf.any():
            counts["nonfinite"] += int(bad_nf.sum())
            if policy.nonfinite == "reject":
                _note("nonfinite", counts["nonfinite"])
                raise CloudValidationError(
                    "nonfinite", f"{counts['nonfinite']} rows with "
                    f"NaN/Inf coordinates")
            v_out = v_out & ~bad_nf
        safe = np.nan_to_num(np.asarray(c, np.float64),
                             posinf=0.0, neginf=0.0)
        frac = v_out & (safe != np.floor(safe)).any(axis=1)
        if frac.any():
            counts["dtype"] += int(frac.sum())
            v_out = v_out & ~frac
        c_out = np.where(v_out[:, None], np.floor(safe), 0).astype(np.int32)
    if not np.issubdtype(b.dtype, np.integer):
        if policy.dtype == "reject":
            raise CloudValidationError(
                "dtype", f"batch dtype {b.dtype} is not integral")
        b_out = np.nan_to_num(np.asarray(b, np.float64)).astype(np.int32)
        counts["dtype"] += 0 if np.array_equal(b_out, b) else int(v_out.sum())

    # -- non-finite feats ---------------------------------------------------
    if f is not None and np.issubdtype(f.dtype, np.floating):
        fin_rows = np.isfinite(f).all(axis=1)
        bad = v_out & ~fin_rows
        if bad.any():
            counts["nonfinite"] += int(bad.sum())
            if policy.nonfinite == "reject":
                _note("nonfinite", counts["nonfinite"])
                raise CloudValidationError(
                    "nonfinite", f"{int(bad.sum())} rows with NaN/Inf "
                    f"features")
            # the geometry is fine: keep the rows, scrub the values
            f_out = np.where(np.isfinite(f), f, 0).astype(f.dtype)

    # -- out-of-grid --------------------------------------------------------
    limit = morton.BLOCK_SIZE << grid_bits
    b_max = 1 << batch_bits
    inb = (np.all((c_out >= 0) & (c_out < limit), axis=1)
           & (b_out >= 0) & (b_out < b_max))
    oob = v_out & ~inb
    if oob.any():
        counts["out_of_grid"] = int(oob.sum())
        if policy.out_of_grid == "reject":
            _note("out_of_grid", counts["out_of_grid"])
            raise CloudValidationError(
                "out_of_grid", f"{counts['out_of_grid']} rows outside the "
                f"grid [0, {limit})^3 x batch [0, {b_max})")
        if policy.out_of_grid == "clip":
            c_out = np.where(oob[:, None],
                             np.clip(c_out, 0, limit - 1), c_out)
            b_out = np.where(oob, np.clip(b_out, 0, b_max - 1), b_out)
        else:                                    # repair: drop the rows
            v_out = v_out & ~oob

    # -- duplicates (keep-first among valid rows) ---------------------------
    idx = np.flatnonzero(v_out)
    if idx.size:
        keys = _pack_keys(np.clip(c_out[idx], 0, limit - 1), b_out[idx])
        _, first = np.unique(keys, return_index=True)
        dup = np.ones(idx.size, bool)
        dup[first] = False
        if dup.any():
            counts["duplicate"] = int(dup.sum())
            if policy.duplicate == "reject":
                _note("duplicate", counts["duplicate"])
                raise CloudValidationError(
                    "duplicate", f"{counts['duplicate']} duplicate "
                    f"(batch, coord) rows")
            v_out[idx[dup]] = False

    # -- oversize (keep-first truncation to the caller's budget) ------------
    if max_valid is not None:
        live = np.flatnonzero(v_out)
        if live.size > max_valid:
            counts["oversize"] = int(live.size - max_valid)
            if policy.oversize == "reject":
                _note("oversize", counts["oversize"])
                raise CloudValidationError(
                    "oversize", f"{live.size} valid voxels exceed the "
                    f"budget of {max_valid}")
            v_out[live[max_valid:]] = False

    # -- empty --------------------------------------------------------------
    if not v_out.any():
        counts["empty"] = 1
        if policy.empty == "reject":
            _note("empty", 1)
            raise CloudValidationError("empty", "no valid voxels remain")

    changed = (not np.array_equal(v_out, v_in) or c_out is not c
               or b_out is not b or f_out is not f)
    for kind, cnt in counts.items():
        _note(kind, cnt)
    report = CloudReport(counts, n, int(v_in.sum()), int(v_out.sum()),
                         changed)
    if not changed:
        return coords, batch, valid, feats, report
    out = (c_out, b_out, v_out, f_out)
    if as_torch:
        out = tuple(None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)) for a in out)
    return (*out, report)
