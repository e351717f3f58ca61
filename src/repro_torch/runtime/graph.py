"""CUDA graph capture and replay: the port's counterpart of ``jax.jit`` at
the reference's two serving sites, the serving engine's per-bucket
executable (``src/repro/launch/spconv_serve.py:266``) and the decode step
(``src/repro/launch/serve.py:43``).

A :class:`Graph` holds ``fn(*args)``, a function of CUDA tensors on one
device whose result is one tensor (the logits at both sites):

* :meth:`Graph.warm_up` runs ``fn`` eagerly on the graph's side stream.
  Run it once before :meth:`Graph.capture`: a kernel builds and sets its
  shared-memory attributes at its first launch, and cuBLAS makes its
  handle at its first call, which a capture may not do.
* :meth:`Graph.capture` copies the arguments into static buffers and
  captures ``fn`` over them into a ``torch.cuda.CUDAGraph`` with a private
  memory pool. A capture that fails raises: a host read inside ``fn``
  (``.item()``, ``int(t)``, ``torch.nonzero``) is the usual cause, and the
  read is what to remove. Nothing runs the call eagerly instead.
* Calling the graph copies its arguments into the static buffers (a
  shape or dtype other than the captured one raises), replays, and
  returns a clone of the output, which the next replay cannot overwrite.
  ``fn``'s in-place updates of tensors it closes over (a decode cache)
  happen again at each replay.

The kernels' launch counters (``COUNTERS`` of each kernel module) count
what the card ran: a capture launches nothing, so what its Python added to
them is taken back and kept as :attr:`Graph.launches`, which each replay
adds again.
"""
from __future__ import annotations

import importlib

import torch

#: the modules whose ``COUNTERS`` a graph keeps true
KERNEL_MODULES = ("repro_torch.kernels.octent.kernel",
                  "repro_torch.kernels.spconv_gemm.kernel",
                  "repro_torch.kernels.masked_matmul.kernel",
                  "repro_torch.kernels.flash_attention.kernel")


def launch_counts() -> dict:
    """``{(module, counter): value}`` of every kernel launch counter."""
    out = {}
    for name in KERNEL_MODULES:
        mod = importlib.import_module(name)
        for c in mod.COUNTERS:
            out[(mod, c)] = getattr(mod, c)
    return out


def _add_counts(delta: dict, sign: int) -> None:
    for (mod, c), n in delta.items():
        setattr(mod, c, getattr(mod, c) + sign * n)


class Graph:
    """``fn`` captured once over static buffers and replayed; see the
    module docstring. ``device`` is the CUDA device of every argument."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph runs on a CUDA device, not "
                             f"{self.device}")
        self.stream = torch.cuda.Stream(self.device)
        self.graph = None
        self.static_in: list = []
        self.static_out = None
        #: ``{(module, counter): n}``: the launches one replay makes
        self.launches: dict = {}

    def warm_up(self, *args):
        """``fn(*args)`` run eagerly on the side stream; its result."""
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            out = self.fn(*args)
        here.wait_stream(self.stream)
        return out

    def capture(self, *args) -> None:
        """Capture ``fn`` over copies of ``args``; raises if it fails."""
        static = [a.clone() for a in args]
        g = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.graph(g, stream=self.stream):
                out = self.fn(*static)
        finally:
            after = launch_counts()
            delta = {k: after[k] - n for k, n in before.items()
                     if after[k] != n}
            _add_counts(delta, -1)       # the capture launched nothing
        self.graph, self.static_in, self.static_out = g, static, out
        self.launches = delta

    def __call__(self, *args):
        if self.graph is None:
            raise RuntimeError("the graph was never captured")
        if len(args) != len(self.static_in):
            raise ValueError(f"{len(args)} arguments, captured "
                             f"{len(self.static_in)}")
        for i, (buf, a) in enumerate(zip(self.static_in, args)):
            if a.shape != buf.shape or a.dtype != buf.dtype:
                raise ValueError(
                    f"argument {i}: {tuple(a.shape)} {a.dtype}, captured "
                    f"{tuple(buf.shape)} {buf.dtype}")
            buf.copy_(a)
        self.graph.replay()
        _add_counts(self.launches, 1)
        return self.static_out.clone()
