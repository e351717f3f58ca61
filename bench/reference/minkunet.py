"""Plain MinkUNet (the sparse UNet of Choy et al., 2019, at the widths of
SPVNAS's SemanticKITTI MinkUNet, SpOctA's Seg(o)): the benchmark's
reference, with the program's structure (the configuration's ``assumed``
lists where that departs from the published network).

A stem Subm3, then per encoder stage a Gconv2 and ``blocks`` Subm3, then
per decoder stage a Tconv2 back onto the encoder's coordinate set, the
skip features concatenated after the upsampled ones, and ``blocks`` Subm3;
each convolution followed by inference BatchNorm and ReLU; a linear head.
Weights are the ``state_dict`` keys of the served model, which the
benchmark makes from its seed (:func:`weight_spec`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench.reference import sparse


class Geometry(NamedTuple):
    levels: tuple    # per resolution: (coords, batch)
    subm: tuple      # per resolution: the Subm3 kmap
    down: tuple      # per encoder stage: sparse.Down of its Gconv2


def weight_spec(m: dict) -> dict:
    """``{key: (shape, init)}`` of every weight, ``m`` the configuration's
    ``model`` block."""
    spec = sparse.spconv_spec(27, m["in_ch"], m["stem"], "stem")
    c_prev, skips = m["stem"], [m["stem"]]
    for i, c in enumerate(m["enc"]):
        spec.update(sparse.spconv_spec(8, c_prev, c, f"enc{i}.down"))
        for b in range(m["blocks"]):
            spec.update(sparse.spconv_spec(27, c, c, f"enc{i}.block{b}"))
        c_prev = c
        skips.append(c)
    for i, c in enumerate(m["dec"]):
        spec.update(sparse.spconv_spec(8, c_prev, c, f"dec{i}.up"))
        for b in range(m["blocks"]):
            cin = c + skips[-(i + 2)] if b == 0 else c
            spec.update(sparse.spconv_spec(27, cin, c, f"dec{i}.block{b}"))
        c_prev = c
    spec["head.w"] = ((1, c_prev, m["classes"]),
                      ("normal", (2.0 / c_prev) ** 0.5))
    spec["head.b"] = ((m["classes"],), ("uniform", -0.1, 0.1))
    return spec


def geometry(m: dict, coords: torch.Tensor, batch: torch.Tensor) -> Geometry:
    """Every kernel map of one cloud (compact rows)."""
    levels = [(coords.long(), batch.long())]
    downs = []
    for _ in m["enc"]:
        d = sparse.gconv2_geometry(*levels[-1])
        downs.append(d)
        levels.append((d.coords, d.batch))
    subm = [sparse.subm3_kmap(*lv) for lv in levels]
    return Geometry(tuple(levels), tuple(subm), tuple(downs))


def forward(p: dict, m: dict, g: Geometry, feats: torch.Tensor, *,
            precision: str = "float32") -> torch.Tensor:
    """(N, classes) logits of the cloud's rows."""
    n_enc = len(m["enc"])
    x = sparse.conv_bn_relu(feats.float(), g.subm[0], p, "stem", precision)
    skips = [x]
    for i in range(n_enc):
        x = sparse.conv_bn_relu(x, g.down[i].kmap, p, f"enc{i}.down",
                                precision)
        for b in range(m["blocks"]):
            x = sparse.conv_bn_relu(x, g.subm[i + 1], p, f"enc{i}.block{b}",
                                    precision)
        skips.append(x)
    for i in range(len(m["dec"])):
        level = n_enc - 1 - i
        up_map = sparse.transpose_kmap(g.down[level],
                                       g.levels[level][0].shape[0])
        up = sparse.conv_bn_relu(x, up_map, p, f"dec{i}.up", precision)
        x = torch.cat([up, skips[level]], dim=-1)
        for b in range(m["blocks"]):
            x = sparse.conv_bn_relu(x, g.subm[level], p, f"dec{i}.block{b}",
                                    precision)
    return sparse.matmul(x, p["head.w"][0], precision) + p["head.b"]


def layers(m: dict, g: Geometry) -> list:
    """Every layer's geometry, in forward order, for the work counts."""
    n_enc = len(m["enc"])
    rows = [lv[0].shape[0] for lv in g.levels]
    out = [sparse.Layer("stem", "subm3", 27, m["in_ch"], m["stem"],
                        sparse.pairs(g.subm[0]), rows[0], rows[0])]
    c_prev, skips = m["stem"], [m["stem"]]
    for i, c in enumerate(m["enc"]):
        out.append(sparse.Layer(f"enc{i}.down", "gconv2", 8, c_prev, c,
                                sparse.pairs(g.down[i].kmap), rows[i],
                                rows[i + 1]))
        for b in range(m["blocks"]):
            out.append(sparse.Layer(f"enc{i}.block{b}", "subm3", 27, c, c,
                                    sparse.pairs(g.subm[i + 1]), rows[i + 1],
                                    rows[i + 1]))
        c_prev = c
        skips.append(c)
    for i, c in enumerate(m["dec"]):
        level = n_enc - 1 - i
        out.append(sparse.Layer(f"dec{i}.up", "tconv2", 8, c_prev, c,
                                sparse.pairs(g.down[level].kmap),
                                rows[level + 1], rows[level]))
        for b in range(m["blocks"]):
            cin = c + skips[-(i + 2)] if b == 0 else c
            out.append(sparse.Layer(f"dec{i}.block{b}", "subm3", 27, cin, c,
                                    sparse.pairs(g.subm[level]), rows[level],
                                    rows[level]))
        c_prev = c
    out.append(sparse.Layer("head", "dense", 1, c_prev, m["classes"],
                            rows[0], rows[0], rows[0]))
    return out


def searches(m: dict, g: Geometry) -> list:
    """The Subm3 map searches a forward needs: one a resolution."""
    return [sparse.Search(f"subm3.level{r}", lv[0].shape[0])
            for r, lv in enumerate(g.levels)]


def gaps(out: dict, ref: dict) -> dict:
    """The comparison's numbers: the largest logit difference over the
    largest reference logit. The program's rows past the cloud's (its
    padding) have to be zero."""
    return {"logit_gap": sparse.gap(out["logits"], ref["logits"])}


def reference(p: dict, m: dict, req: dict, *, precision: str = "float32",
              device=None) -> dict:
    """The outputs the program has to give for request ``req`` (compact
    rows, as the traffic made them)."""
    coords = torch.as_tensor(req["coords"], device=device)
    batch = torch.as_tensor(req["batch"], device=device)
    feats = torch.as_tensor(req["feats"], device=device)
    with sparse.float32_mode(), torch.no_grad():
        g = geometry(m, coords, batch)
        return {"logits": forward(p, m, g, feats, precision=precision)}
