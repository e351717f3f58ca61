"""Train MinkUNet on synthetic indoor segmentation through the PyTorch/CUDA
port, with checkpoint/restart fault tolerance (the counterpart of
``examples/train_minkunet.py``).

    PYTHONPATH=src python examples/train_minkunet_torch.py --steps 30
    PYTHONPATH=src python examples/train_minkunet_torch.py --device cpu

Runs on the card unless ``--device cpu`` is given. Checkpoints go to
``--ckpt-dir`` (resumed from if it holds one) or to a temporary directory.
"""
import argparse
import contextlib
import tempfile

import numpy as np
import torch

from repro_torch.core import plan as planlib
from repro_torch.data import pointcloud
from repro_torch.device import resolve_device
from repro_torch.launch import train
from repro_torch.models import minkunet
from repro_torch.optim import adamw
from repro_torch.runtime.fault import RunnerConfig, TrainRunner


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--voxels", type=int, default=1024)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = minkunet.MinkUNetConfig(stem=16, enc=(16, 32, 32, 64),
                                  dec=(32, 24, 24, 24), classes=8)
    model = minkunet.MinkUNet(cfg, device=dev,
                              generator=torch.Generator().manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=args.steps,
                                warmup_steps=3)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    # the 8 replayed scenes' plans stay resident: from step 8 on every
    # step hits by content and searches nothing
    cache = planlib.PlanCache(
        capacity=8 * (2 * (len(cfg.enc) + len(cfg.dec)) + 2))

    def train_step(state, batch):
        plans = minkunet.build_plans(batch["coords"], batch["batch"],
                                     batch["valid"], cfg, cache=cache,
                                     device=dev)
        return train.make_spconv_step(model, opt_cfg, plans)(state, batch)

    def batch_at(step):
        rng = np.random.default_rng(1000 + step % 8)
        vb = pointcloud.make_batch(rng, "indoor", batch_size=1,
                                   max_voxels=args.voxels, voxel_size=0.15)
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in vb._asdict().items()}
        b["labels"] = b["labels"].clamp(0, cfg.classes - 1)
        return b

    with (contextlib.nullcontext(args.ckpt_dir) if args.ckpt_dir
          else tempfile.TemporaryDirectory()) as ckpt_dir:
        runner = TrainRunner(RunnerConfig(ckpt_dir=ckpt_dir, ckpt_every=10),
                             train_step, batch_at,
                             (params, adamw.init(params)))
        if runner.restore_latest():
            print(f"resumed from step {runner.step}")
        losses = runner.run(args.steps)
    print(f"steps={len(losses)} loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"map_searches={planlib.mapsearch_call_count()}")
    assert losses[-1] < losses[0], "loss must decrease"


if __name__ == "__main__":
    main()
