"""Serving entry point for the LMs of every family with a decode step
(the decoders, Mamba2, RecurrentGemma and the LLaVA VLM): batched
prefill, then greedy (or sampled) decoding against the cache.

The prefill runs every attention layer through the CUDA flash-attention
kernel on the card; decode is plain PyTorch over the cache. On the card
:func:`generate` runs the first decode step eagerly, captures the step
into a CUDA graph (``runtime/graph.py``, the counterpart of the
reference's ``jax.jit`` of ``decode_step``) and replays it for the rest:
the cache, its ``step`` an int32 scalar on the device, is updated in place
by each replay. The capture covers the step alone; the alive mask, the
argmax and the sampling stay outside it. Under a ``torch.distributed``
mesh (a DTensor cache) the step runs eagerly: gloo's host-staged
collectives cannot be captured.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --full-config                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --device cpu                       # reduced config, on the CPU
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.runtime import graph, guard
from repro_torch.runtime.sharding import is_dtensor


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def generate(model: api.Model, params, batch: dict, *, max_context: int,
             n_steps: int, greedy: bool = True,
             generator: torch.Generator | None = None,
             device: str | torch.device | None = None):
    """Prefill then decode ``n_steps`` tokens. Returns (tokens (B, n),
    stats).

    ``batch`` holds ``tokens`` (B, S) and the family's other inputs (the
    VLM's ``patches``), arrays or tensors; each is moved to ``device``
    (None: the card; raises without one), where ``params`` must lie. A
    sequence whose logits go NaN/Inf stops decoding: its last good token
    is frozen for the remaining steps. Stops are counted in
    ``stats["nonfinite_stops"]`` and noted as ``serve.nonfinite_stops`` in
    the guard's health counters. The alive mask stays on the device, and
    the loop syncs with the host once, at the end. ``generator`` draws the
    samples when ``greedy=False`` (None: a fresh one seeded 0).

    On the card the decode step after the first is a replay of a CUDA
    graph captured after that first step (``stats["graphed"]``); the
    capture's time (``stats["capture_s"]``) is left out of
    ``decode_s_per_tok``. A capture that fails raises.
    """
    dev = resolve_device(device)
    if not greedy and generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_context)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    alive = torch.isfinite(logits).all(-1)                  # (B,)
    tok = torch.argmax(torch.nan_to_num(logits), -1)[:, None].int()
    out = [tok]
    graphed = dev.type == "cuda" and not any(
        is_dtensor(t) for t in cache.values())
    step = None
    t_capture = 0.0
    t0 = time.perf_counter()
    for _ in range(n_steps - 1):
        if not graphed:
            logits, cache = model.decode_step(params, cache, tok)
        elif step is None:
            # the cache is updated in place: the graph closes over it
            step = graph.Graph(
                lambda t: model.decode_step(params, cache, t)[0], dev)
            logits = step.warm_up(tok)
            t1 = time.perf_counter()
            step.capture(tok)
            t_capture = time.perf_counter() - t1
        else:
            logits = step(tok)
        last = logits[:, -1]
        alive = alive & torch.isfinite(last).all(-1)
        if greedy:
            nxt = torch.argmax(torch.nan_to_num(last), -1)[:, None].int()
        else:
            probs = torch.softmax(torch.nan_to_num(last).float(), -1)
            nxt = torch.multinomial(probs, 1, generator=generator).int()
        tok = torch.where(alive[:, None], nxt, tok)         # freeze dead seqs
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0 - t_capture
    stops = int((~alive).sum())
    if stops:
        guard.health().note("serve.nonfinite_stops", stops)
    return torch.cat(out, dim=1), {
        "prefill_s": t_prefill,
        "decode_s_per_tok": t_decode / max(n_steps - 1, 1),
        "nonfinite_stops": stops, "graphed": step is not None,
        "capture_s": t_capture}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    dev = resolve_device(args.device)
    model = api.build_model(cfg, device=dev)
    params = model.init(torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (args.batch,
                                                   args.prompt_len))}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (args.batch, cfg.n_patches, cfg.vision_dim)).astype(np.float32)
    max_ctx = args.prompt_len + args.gen + (cfg.n_patches or 0)
    toks, stats = generate(model, params, batch, max_context=max_ctx,
                           n_steps=args.gen, device=dev)
    print(f"arch={cfg.name} device={dev} generated {tuple(toks.shape)} "
          f"tokens; prefill={stats['prefill_s']:.3f}s "
          f"decode={stats['decode_s_per_tok'] * 1e3:.1f}ms/tok "
          f"nonfinite_stops={stats['nonfinite_stops']}")
    print("first sequence:", toks[0, :16].tolist())


if __name__ == "__main__":
    main()
