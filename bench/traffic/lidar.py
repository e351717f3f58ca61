"""LiDAR sweeps as served requests: the benchmark's one traffic generator.

A cell's ``params`` (its workload file) and its configuration's
``relabel`` block steer it:

* ``sensor``: the scanner (``rings`` over [-25, +3] degrees, ``az_steps``
  azimuth steps, ``max_range`` m) and the voxel grid (``voxel`` m a side,
  ``origin`` m).
* ``bases``, ``scene_seed``: how many base sweeps set-up makes, and the
  seed they come from, the same for every run; each a scene of random
  boxes on a ground plane seen from a sensor at a random yaw, voxelized (:func:`lidar_scene` and :func:`voxelize` are a copy of
  ``repro_torch.data.pointcloud``'s, so the program and the yardstick do
  not share the generator).
* ``sweeps_per_request``: sweeps in one request, batch items 0, 1, ...
* ``hot_set``: None for fresh traffic, where every request's geometry is
  new to the run; else the number of geometries that every request
  re-submits, each a relabelling of bases of its own (the first
  ``hot_set`` requests are those geometries, in order).
* ``feature_rows``: rows of the seeded feature pool that each request
  draws its features from, afresh, at a seeded offset.

A fresh request is a base sweep under a relabelling that keeps every
layer's kernel-map pair counts: one of the grid's ``symmetries`` (``d4``:
the 8 rotations by 90 degrees and mirrors about the grid's centre, which
keep stride-2 groupings, since the grid is ``2^k`` a side) and a shift
along z by a multiple of ``z_step`` voxels. The variants are dealt in a seeded order,
each once, so no two requests of a run share coordinates. The work that a
request asks of the model is therefore its bases' work
(``bench/workcount.py``).
"""
from __future__ import annotations

import numpy as np


def lidar_scene(rng: np.random.Generator, n_rings: int = 64,
                az_steps: int = 1024, max_range: float = 60.0) -> np.ndarray:
    """Returns (P, 5) points: x, y, z, intensity, label."""
    elev = np.deg2rad(np.linspace(-25.0, 3.0, n_rings))
    az = np.linspace(-np.pi, np.pi, az_steps, endpoint=False)
    elev_g, az_g = np.meshgrid(elev, az, indexing="ij")
    with np.errstate(divide="ignore"):
        r_ground = np.where(np.sin(elev_g) < -1e-3,
                            1.7 / -np.sin(elev_g), max_range)
    r = np.minimum(r_ground, max_range)
    label = np.where(r_ground < max_range, 1, 0)
    n_boxes = int(rng.integers(8, 24))
    for _ in range(n_boxes):
        cx, cy = rng.uniform(-40, 40, 2)
        w, l, h = rng.uniform(0.5, 4.0, 3)
        az_c = np.arctan2(cy, cx)
        dist = np.hypot(cx, cy)
        half_ang = np.arctan2(max(w, l) / 2, dist)
        hit = (np.abs(((az_g - az_c + np.pi) % (2 * np.pi)) - np.pi)
               < half_ang)
        z_at = dist * np.sin(elev_g)
        hit &= (z_at > -1.7) & (z_at < -1.7 + h)
        r = np.where(hit & (dist < r), dist, r)
        label = np.where(hit & (dist <= r), 2, label)
    keep = r < max_range
    x = (r * np.cos(elev_g) * np.cos(az_g))[keep]
    y = (r * np.cos(elev_g) * np.sin(az_g))[keep]
    z = (r * np.sin(elev_g))[keep]
    inten = rng.uniform(0, 1, x.shape[0])
    return np.stack([x, y, z, inten, label[keep]], axis=1)


def voxelize(points: np.ndarray, voxel_size, origin, max_voxels: int,
             grid_max: int) -> np.ndarray:
    """The sorted (V, 3) int32 coordinates of the occupied voxels; past
    ``max_voxels``, an even subsample."""
    ijk = np.floor((points[:, :3] - np.asarray(origin, np.float32))
                   / np.asarray(voxel_size, np.float32)).astype(np.int64)
    ijk = ijk[np.all((ijk >= 0) & (ijk <= grid_max), axis=1)]
    key = (ijk[:, 0] << 22) | (ijk[:, 1] << 11) | ijk[:, 2]
    _, first = np.unique(key, return_index=True)
    coords = ijk[first].astype(np.int32)
    if coords.shape[0] > max_voxels:
        sel = np.linspace(0, coords.shape[0] - 1, max_voxels).astype(np.int64)
        coords = coords[sel]
    return coords


def symmetries(kind: str) -> int:
    return {"d4": 8}[kind]


def relabel(coords: np.ndarray, kind: str, sym: int, shift: int,
            grid: int) -> np.ndarray:
    """``coords`` under symmetry ``sym`` of ``kind`` and a z shift."""
    if kind != "d4":
        raise ValueError(f"no symmetries {kind!r}")
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2] + shift
    if sym & 1:
        x = grid - 1 - x
    for _ in range(sym >> 1):
        x, y = grid - 1 - y, x
    return np.stack([x, y, z], axis=1).astype(np.int32)


def base_sweep(seed: int, i: int, sensor: dict, max_voxels: int,
               grid: int) -> np.ndarray:
    """Base sweep ``i`` of ``seed``: its voxel coordinates."""
    rng = np.random.default_rng([seed % (1 << 63), 1, i])
    pts = lidar_scene(rng, sensor["rings"], sensor["az_steps"],
                      sensor["max_range"])
    yaw = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(yaw), np.sin(yaw)
    pts[:, 0], pts[:, 1] = c * pts[:, 0] - s * pts[:, 1], \
        s * pts[:, 0] + c * pts[:, 1]
    return voxelize(pts, sensor["voxel"], sensor["origin"], max_voxels,
                    grid - 1)


class Stream:
    """The seeded requests of one run: ``request(i)`` is the same for a
    seed whatever came before it.

    The bases come from ``scene_seed``, the same in every run, so that
    each seed asks the same work of the model: the seed deals them in its
    own order, round by round, each base once a round, under its own
    relabellings, with its own features."""

    def __init__(self, params: dict, config: dict, seed: int):
        self.seed = seed % (1 << 63)
        rel = config["relabel"]
        self.kind, self.z_step = rel["symmetries"], rel["z_step"]
        self.grid = 16 << config["model"]["grid_bits"]
        self.per = params["sweeps_per_request"]
        self.hot = params.get("hot_set")
        max_voxels = config["bucket"] // self.per
        self.bases = [base_sweep(params["scene_seed"], i, params["sensor"],
                                 max_voxels, self.grid)
                      for i in range(params["bases"])]
        self.variants = []
        for b, c in enumerate(self.bases):
            shifts = (self.grid - 1 - int(c[:, 2].max())) // self.z_step + 1
            v = [(b, s, k * self.z_step)
                 for s in range(symmetries(self.kind)) for k in range(shifts)]
            order = np.random.default_rng([self.seed, 2, b]).permutation(
                len(v))
            self.variants.append([v[j] for j in order])
        self.rounds = min(len(v) for v in self.variants)
        self._orders: dict = {}
        self.pool = np.random.default_rng([self.seed, 4]).random(
            (params["feature_rows"], config["model"]["in_ch"]), np.float32)

    def capacity(self) -> int:
        """Requests the run can make (unbounded for a hot set)."""
        if self.hot:
            return 1 << 62
        return self.rounds * len(self.bases) // self.per

    def _sweep(self, k: int) -> tuple:
        """The ``k``-th sweep dealt: round ``k // B``, a base each."""
        n = len(self.bases)
        r = k // n
        order = self._orders.get(r)
        if order is None:
            order = self._orders[r] = np.random.default_rng(
                [self.seed, 3, r]).permutation(n)
        return self.variants[int(order[k % n])][r]

    def _parts(self, i: int) -> tuple:
        if self.hot:
            slot = i if i < self.hot else int(
                np.random.default_rng([self.seed, 5, i]).integers(self.hot))
            return tuple(self.variants[slot * self.per + j][0]
                         for j in range(self.per))
        if i >= self.capacity():
            raise RuntimeError(
                f"request {i} exceeds the {self.capacity()} distinct "
                f"geometries of this run's bases: raise 'bases'")
        return tuple(self._sweep(i * self.per + j) for j in range(self.per))

    def request(self, i: int) -> dict:
        parts = self._parts(i)
        coords = [relabel(self.bases[b], self.kind, s, k, self.grid)
                  for b, s, k in parts]
        batch = [np.full(c.shape[0], j, np.int32)
                 for j, c in enumerate(coords)]
        coords = np.concatenate(coords)
        n = coords.shape[0]
        off = int(np.random.default_rng([self.seed, 6, i]).integers(
            self.pool.shape[0] - n + 1))
        return {"rid": f"r{i}", "coords": coords,
                "batch": np.concatenate(batch),
                "feats": self.pool[off:off + n].copy(), "scans": self.per,
                "parts": parts}
