"""Serve a small LM with batched requests through the PyTorch/CUDA port:
prefill, then decode with the rolling cache (the counterpart of
``examples/serve_lm.py``).

Exercises the decode path of the decode_32k / long_500k dry-run cells
(SWA rolling cache for the mixtral family, SSM state for mamba2). On the
card ``generate`` replays every decode step after the first from a CUDA
graph (``runtime/graph.py``); on the CPU it decodes eagerly.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch mixtral-8x7b
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import api


def main(argv=None, params=None) -> dict:
    """Parse ``argv``, serve, print, and return the tokens and
    ``generate``'s stats. ``params`` are the nested parameters to serve
    (None: drawn from a generator on the device seeded 0)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    model = api.build_model(cfg, device=dev)
    if params is None:
        params = model.init(torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (args.batch, 24))}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (args.batch, cfg.n_patches, cfg.vision_dim)).astype(np.float32)
    toks, stats = generate(model, params, batch, max_context=128,
                           n_steps=args.gen, device=dev)
    print(f"{cfg.name}: generated {toks.shape[1]} tokens x {toks.shape[0]} "
          f"requests; prefill {stats['prefill_s'] * 1e3:.0f}ms, "
          f"{stats['decode_s_per_tok'] * 1e3:.1f}ms/tok, "
          f"decode graphed: {stats['graphed']}")
    print("sample:", toks[0].tolist())
    return {"tokens": toks.cpu(), **stats}


if __name__ == "__main__":
    main()
