"""MinkUNet served through the port's ``ServeEngine``.

The engine gets the configuration's padding bucket as its one admission
bucket, ``max_batch`` explicitly, and its own long-lived content-keyed
``PlanCache`` (no persistence). A request is handed over by
``ServeEngine.submit`` (admission, the strict sanitizer and bucket
quantization included) and comes back from ``ServeEngine.step`` as its
``ServeResult.logits``, a host array with a row for each of the bucket's
rows, the request's own first.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core import plan as planlib
from repro_torch.kernels.octent import kernel as octent_kernel
from repro_torch.kernels.spconv_gemm import kernel as gemm_kernel
from repro_torch.launch import spconv_serve
from repro_torch.models import minkunet
from repro_torch.runtime import admission


class Driver:
    def __init__(self, config: dict, weights: dict, device):
        m = config["model"]
        cfg = minkunet.MinkUNetConfig(
            name=config["name"], in_ch=m["in_ch"], classes=m["classes"],
            stem=m["stem"], enc=tuple(m["enc"]), dec=tuple(m["dec"]),
            blocks=m["blocks"], grid_bits=m["grid_bits"],
            batch_bits=m["batch_bits"])
        model = minkunet.MinkUNet(cfg, device=device)
        model.load_state_dict(weights, strict=True)
        queue = admission.AdmissionQueue(buckets=(config["bucket"],),
                                         grid_bits=cfg.grid_bits,
                                         batch_bits=cfg.batch_bits)
        self.engine = spconv_serve.ServeEngine(
            model, device=device, queue=queue,
            max_batch=config["max_batch"])

    def submit(self, req: dict) -> bool:
        n = req["coords"].shape[0]
        out = self.engine.submit(req["rid"], req["coords"], req["batch"],
                                 np.ones(n, bool), req["feats"])
        return not isinstance(out, admission.Rejection)

    def step(self) -> list:
        done = [(r.rid, {"logits": r.logits} if r.status == "completed"
                 else None) for r in self.engine.step()]
        # the engine keeps every result for its stats; a client that has
        # taken them holds the logits itself
        self.engine.results.clear()
        return done

    @staticmethod
    def counters() -> dict:
        return {"map_searches": planlib.MAPSEARCH_CALLS[0],
                "kernel1_launches": octent_kernel.launches,
                "kernel2_launches": gemm_kernel.launches}

    @contextlib.contextmanager
    def spans(self, rec):
        """Spans around the plan build, as the engine looks it up, and
        around each request's forward."""
        build, fwd = minkunet.build_plans, self.engine._forward_fn

        def traced_build(*args, **kw):
            with rec.span("plan_build"):
                return build(*args, **kw)

        def traced_forward(*args, **kw):
            with rec.span("forward"):
                return fwd(*args, **kw)

        minkunet.build_plans = traced_build
        self.engine._forward_fn = traced_forward
        try:
            yield
        finally:
            minkunet.build_plans = build
            del self.engine._forward_fn

    def close(self) -> None:
        del self.engine
        torch.cuda.empty_cache()
