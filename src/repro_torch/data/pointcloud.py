"""Synthetic point-cloud generator (numpy), geometry-matched to the paper's
datasets, which are licence-gated:

  * :func:`lidar_scene` — outdoor: 64 elevation rings over [-25, +3] deg,
    dense azimuth, a ground plane and random boxes. The ring geometry gives
    the coarse-vertical / fine-horizontal voxel distribution of
    SemanticKITTI-style scans.
  * :func:`indoor_scene` — RGB-D style: uniformly sampled room surfaces.
  * :func:`moving_sensor_sequence` — a temporal frame sequence: a sensor
    window translating over a static world (the streaming workload).

Voxelization is the paper's COO sparse-tensor form (eq. 1) with per-voxel
mean features, padded to a static budget. Same generators and the same
numbers from the same seed as the reference's ``data/pointcloud.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

#: non-finite points dropped by :func:`voxelize` since the last reset
NONFINITE_POINTS = [0]


class VoxelBatch(NamedTuple):
    coords: np.ndarray    # (N, 3) int32
    batch: np.ndarray     # (N,) int32
    valid: np.ndarray     # (N,) bool
    feats: np.ndarray     # (N, C) float32
    labels: np.ndarray    # (N,) int32 (synthetic semantic labels)


def lidar_scene(rng: np.random.Generator, n_rings: int = 64,
                az_steps: int = 1024, max_range: float = 60.0) -> np.ndarray:
    """Returns (P, 5) points: x, y, z, intensity, label."""
    elev = np.deg2rad(np.linspace(-25.0, 3.0, n_rings))
    az = np.linspace(-np.pi, np.pi, az_steps, endpoint=False)
    elev_g, az_g = np.meshgrid(elev, az, indexing="ij")
    # ground plane at z = -1.7 (sensor height)
    with np.errstate(divide="ignore"):
        r_ground = np.where(np.sin(elev_g) < -1e-3,
                            1.7 / -np.sin(elev_g), max_range)
    r = np.minimum(r_ground, max_range)
    label = np.where(r_ground < max_range, 1, 0)        # ground vs sky
    # random boxes (cars/poles) intercepting rays
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


def indoor_scene(rng: np.random.Generator, n_points: int = 50_000,
                 room: float = 8.0, height: float = 3.0) -> np.ndarray:
    """Returns (P, 5) points sampled from room surfaces (ScanNet-like)."""
    pts = []
    labels = []
    n_floor = n_points // 3
    pts.append(np.column_stack([rng.uniform(0, room, (n_floor, 2)),
                                np.zeros(n_floor)]))
    labels.append(np.zeros(n_floor))
    n_wall = n_points // 3
    side = rng.integers(0, 4, n_wall)
    u = rng.uniform(0, room, n_wall)
    v = rng.uniform(0, height, n_wall)
    wx = np.where(side == 0, u, np.where(side == 1, u,
                                         np.where(side == 2, 0.0, room)))
    wy = np.where(side == 0, 0.0, np.where(side == 1, room, u))
    pts.append(np.column_stack([wx, wy, v]))
    labels.append(np.ones(n_wall))
    n_obj = n_points - n_floor - n_wall
    n_boxes = int(rng.integers(4, 10))
    per = n_obj // n_boxes
    for b in range(n_boxes):
        c = rng.uniform(1, room - 1, 2)
        s = rng.uniform(0.3, 1.5, 3)
        p = rng.uniform(-0.5, 0.5, (per, 3)) * s + [c[0], c[1], s[2] / 2]
        pts.append(p)
        labels.append(np.full(per, 2 + b % 5))
    pts = np.concatenate(pts)
    labels = np.concatenate(labels)
    inten = rng.uniform(0, 1, pts.shape[0])
    return np.column_stack([pts, inten, labels])


def voxelize(points: np.ndarray, voxel_size, origin, max_voxels: int,
             grid_max: int = 2047) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """COO voxelization: returns (coords (V,3) int32, feats (V,4), labels).

    Non-finite points are dropped and counted in :data:`NONFINITE_POINTS`.
    """
    voxel_size = np.asarray(voxel_size, np.float32)
    origin = np.asarray(origin, np.float32)
    finite = np.isfinite(points[:, :3]).all(axis=1)
    if not finite.all():
        NONFINITE_POINTS[0] += int((~finite).sum())
        points = points[finite]
    ijk = np.floor((points[:, :3] - origin) / voxel_size).astype(np.int64)
    ok = np.all((ijk >= 0) & (ijk <= grid_max), axis=1)
    ijk, pts = ijk[ok], points[ok]
    key = (ijk[:, 0] << 22) | (ijk[:, 1] << 11) | ijk[:, 2]
    order = np.argsort(key, kind="stable")
    key_s, ijk_s, pts_s = key[order], ijk[order], pts[order]
    new = np.concatenate([[True], key_s[1:] != key_s[:-1]])
    vid = np.cumsum(new) - 1
    n_vox = int(vid[-1]) + 1 if len(vid) else 0
    coords = ijk_s[new].astype(np.int32)
    feats = np.zeros((n_vox, 4), np.float32)
    cnt = np.bincount(vid, minlength=n_vox)[:, None]
    for c in range(4):
        feats[:, c] = np.bincount(vid, weights=pts_s[:, c], minlength=n_vox)
    feats /= np.maximum(cnt, 1)
    feats[:, :3] = feats[:, :3] - (coords * voxel_size + origin)  # local offset
    labels = pts_s[new][:, 4].astype(np.int32)
    if n_vox > max_voxels:
        sel = np.linspace(0, n_vox - 1, max_voxels).astype(np.int64)
        coords, feats, labels = coords[sel], feats[sel], labels[sel]
    return coords, feats, labels


def moving_sensor_sequence(rng: np.random.Generator, n_frames: int,
                           max_voxels: int, *, window: int = 128,
                           step: int = 8, depth: int = 32,
                           density: float = 0.35,
                           feat_ch: int = 4) -> list[VoxelBatch]:
    """Frames of a sensor window translating over a static world.

    A world occupancy (a ground sheet at ``density`` plus boxes, ``depth``
    voxels deep in y, long enough in x for the whole drive) is sampled
    once; frame t holds the world voxels with ``t * step <= x < t * step +
    window``, in world coordinates, so voxels enter and leave only at the
    window's edges: a turnover of about ``step / window`` a frame.
    Features are a per-voxel hash, so a repeated frame is bit-equal.

    Returns ``n_frames`` :class:`VoxelBatch` es padded to ``max_voxels``
    (batch 0); a frame over the budget keeps its lowest-key voxels.
    """
    extent = step * (n_frames - 1) + window if n_frames > 0 else window
    occ = np.zeros((extent, depth, 8), bool)
    occ[:, :, 0] = rng.random((extent, depth)) < density
    for _ in range(int(rng.integers(12, 24))):
        x0 = int(rng.integers(0, max(extent - 8, 1)))
        y0 = int(rng.integers(0, max(depth - 8, 1)))
        w, l, h = rng.integers(2, 8, 3)
        occ[x0:x0 + w, y0:y0 + l, 1:1 + min(int(h), 7)] = True
    wx, wy, wz = np.nonzero(occ)
    world = np.stack([wx, wy, wz], axis=1).astype(np.int32)
    world = world[np.lexsort((world[:, 2], world[:, 1], world[:, 0]))]
    frames = []
    for t in range(n_frames):
        lo = t * step
        vis = world[(world[:, 0] >= lo) & (world[:, 0] < lo + window)]
        vis = vis[:max_voxels]
        n = vis.shape[0]
        coords = np.zeros((max_voxels, 3), np.int32)
        bidx = np.zeros((max_voxels,), np.int32)
        valid = np.zeros((max_voxels,), bool)
        feats = np.zeros((max_voxels, feat_ch), np.float32)
        labels = np.zeros((max_voxels,), np.int32)
        coords[:n] = vis
        valid[:n] = True
        # int32 products wrap, as the reference's do
        h = (vis[:, 0] * 73856093 ^ vis[:, 1] * 19349663
             ^ vis[:, 2] * 83492791).astype(np.int64)
        for c in range(feat_ch):
            feats[:n, c] = (((h >> c) & 0xFF).astype(np.float32) / 255.0
                            - 0.5)
        labels[:n] = (vis[:, 2] > 0).astype(np.int32)
        frames.append(VoxelBatch(coords, bidx, valid, feats, labels))
    return frames


def make_batch(rng: np.random.Generator, kind: str, batch_size: int,
               max_voxels: int, voxel_size: float = 0.05) -> VoxelBatch:
    """Padded multi-scene batch in the paper's sparse-tensor format. A lidar
    scene's voxel is ``4 * voxel_size`` horizontally, ``8 * voxel_size``
    vertically; an indoor scene's is ``voxel_size`` on every axis."""
    coords = np.zeros((max_voxels, 3), np.int32)
    bidx = np.zeros((max_voxels,), np.int32)
    valid = np.zeros((max_voxels,), bool)
    feats = np.zeros((max_voxels, 4), np.float32)
    labels = np.zeros((max_voxels,), np.int32)
    per = max_voxels // batch_size
    for b in range(batch_size):
        if kind == "lidar":
            pts = lidar_scene(rng)
            vs, org = (voxel_size * 4, voxel_size * 4, voxel_size * 8), \
                (-64.0, -64.0, -4.0)
        else:
            pts = indoor_scene(rng)
            vs, org = (voxel_size, voxel_size, voxel_size), (0.0, 0.0, 0.0)
        c, f, l = voxelize(pts, vs, org, per)
        n = c.shape[0]
        s = b * per
        coords[s:s + n] = c
        bidx[s:s + n] = b
        valid[s:s + n] = True
        feats[s:s + n] = f
        labels[s:s + n] = l
    return VoxelBatch(coords, bidx, valid, feats, labels)
