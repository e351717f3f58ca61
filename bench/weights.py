"""Seeded weights from a spec, made on the device in a few large calls.

A spec is ``{key: (shape, init)}``, ``init`` one of ``("normal", std)``
and ``("uniform", lo, hi)``. Every normal leaf comes from one ``randn``
and every uniform leaf from one ``rand`` of a ``torch.Generator`` on the
device seeded with ``seed``, in sorted key order, so a seed gives the
same weights on every run on one kind of device.
"""
from __future__ import annotations

import math

import torch


def make(spec: dict, seed: int, device) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 64))
    keys = sorted(spec)
    out = {}
    for kind in ("normal", "uniform"):
        ks = [k for k in keys if spec[k][1][0] == kind]
        sizes = [math.prod(spec[k][0]) for k in ks]
        if not ks:
            continue
        draw = torch.randn if kind == "normal" else torch.rand
        flat = draw(sum(sizes), generator=gen, device=dev)
        for k, part in zip(ks, torch.split(flat, sizes)):
            shape, init = spec[k]
            if kind == "normal":
                part = part * init[1]
            else:
                part = init[1] + (init[2] - init[1]) * part
            out[k] = part.reshape(shape)
    return out
