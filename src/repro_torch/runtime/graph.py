"""CUDA graph capture and replay: the port's counterpart of ``jax.jit`` at
the reference's four compiled sites: the serving engine's per-bucket
executable (``src/repro/launch/spconv_serve.py:266``), the decode step
(``src/repro/launch/serve.py:43``), and the two training steps, MinkUNet's
``jax.jit(step, donate_argnums=0)`` (``src/repro/launch/train.py:99``)
and the LM's (``src/repro/launch/train.py:328``).

A :class:`Graph` holds ``fn(*args)``, a function of CUDA tensors on one
device. Its arguments and its result are nests (tuples, lists, dicts) of
tensors: a tensor of logits at the serving sites, ``(state, batch) ->
(state, metrics)`` at the training sites.

* :meth:`Graph.warm_up` runs ``fn`` eagerly on the device's side stream.
  Run it once before :meth:`Graph.capture`: a kernel builds and sets its
  shared-memory attributes at its first launch, cuBLAS makes its handle
  at its first call, and autograd sets its streams up at its first
  backward, none of which a capture may do. Every graph of a device
  warms up and captures on one side stream, as ``torch.cuda.graph``'s
  default capture stream is shared: the caching allocator reuses a freed
  block only on the stream that freed it, so a stream of its own would
  keep each graph's freed blocks from all the others.
* :meth:`Graph.capture` copies the arguments into static buffers and
  captures ``fn`` over them into a ``torch.cuda.CUDAGraph`` with a private
  memory pool (:attr:`Graph.pool_bytes` what the card reserved for it),
  with Python's cyclic garbage collector paused. A capture that fails
  raises: a host read inside ``fn`` (``.item()``,
  ``int(t)``, ``torch.nonzero``, a pageable copy from the host) is the
  usual cause, and the read is what to remove. Nothing runs the call
  eagerly instead.
* Calling the graph copies its arguments into the static buffers (a
  structure, shape or dtype other than the captured one raises),
  replays, and returns clones of the result's tensors, which the next
  replay cannot overwrite. ``fn``'s in-place updates of tensors it closes
  over (a decode cache) happen again at each replay.
* ``donate=True`` is ``donate_argnums=0``: the tensors of the first
  argument (a training state) are themselves the static buffers, not
  copies, and ``fn`` must write its new state into them in place and
  return them as the first element of its result (the capture checks
  this). Each call must pass those same tensors as its first argument (a
  call with other tensors raises), so steps chain replay to replay with
  nothing copied in or out, and a call returns its first argument as the
  first element of the result. The caller keeps holding its state: a
  restore writes into those tensors (``TrainRunner.restore_latest``).
* ``pool`` (a ``torch.cuda.graph_pool_handle()``) lets graphs that never
  replay at the same time share one memory pool: each replay writes its
  temporaries before it reads them, and a call clones what it returns,
  so one graph's replay may overwrite another's pool. The first graph's
  :attr:`Graph.pool_bytes` then holds what the card reserved, the others'
  what they added to it.

The kernels' launch counters (``COUNTERS`` of each kernel module) count
what the card ran: a capture launches nothing, so what its Python added to
them is taken back and kept as :attr:`Graph.launches`, which each replay
adds again.
"""
from __future__ import annotations

import gc
import importlib

import torch
from torch.utils import _pytree as pytree

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


_SIDE_STREAMS: dict = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream on which every graph of ``device`` warms up and
    is captured."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _add_counts(delta: dict, sign: int) -> None:
    for (mod, c), n in delta.items():
        setattr(mod, c, getattr(mod, c) + sign * n)


class Graph:
    """``fn`` captured once over static buffers and replayed; see the
    module docstring. ``device`` is the CUDA device of every argument."""

    def __init__(self, fn, device, *, donate: bool = False, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph runs on a CUDA device, not "
                             f"{self.device}")
        self.donate = donate
        self.pool = pool
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.stream = side_stream(self.device)
        self.graph = None
        self.static_in: list = []
        self.static_out: list = []
        self._in_spec = self._out_spec = None
        self._n_donated = 0
        self._fresh: list = []
        #: ``{(module, counter): n}``: the launches one replay makes
        self.launches: dict = {}
        #: bytes the card reserved for the graph's private pool
        self.pool_bytes = 0

    def warm_up(self, *args):
        """``fn(*args)`` run eagerly on the side stream; its result."""
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            out = self.fn(*args)
        here.wait_stream(self.stream)
        return out

    def capture(self, *args) -> None:
        """Capture ``fn`` over copies of ``args`` (the first one itself
        when donated); raises if it fails."""
        flat, spec = pytree.tree_flatten(args)
        n_don = len(pytree.tree_leaves(args[0])) if self.donate else 0
        static = [a if i < n_don else a.clone() for i, a in enumerate(flat)]
        g = torch.cuda.CUDAGraph()
        # the warm-up's freed blocks go back to the card, where the
        # graph's private pool can take them
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts()
        # ``torch.cuda.graph`` collects garbage before it begins; a
        # collection during the capture could free another graph, whose
        # reset a capture does not permit
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(g, pool=self.pool, stream=self.stream):
                out = self.fn(*pytree.tree_unflatten(static, spec))
        finally:
            if collecting:
                gc.enable()
            after = launch_counts()
            delta = {k: after[k] - n for k, n in before.items()
                     if after[k] != n}
            _add_counts(delta, -1)       # the capture launched nothing
        out_flat, out_spec = pytree.tree_flatten(out)
        if self.donate:
            back = pytree.tree_leaves(out[0])
            if len(back) != n_don or any(
                    a is not b for a, b in zip(back, static)):
                raise ValueError("a donated graph's function must write "
                                 "its new state into the state it was "
                                 "given and return those tensors first")
        self.graph, self.static_in, self.static_out = g, static, out_flat
        self._in_spec, self._out_spec, self._n_donated = spec, out_spec, n_don
        donated = {id(a) for a in static[:n_don]}
        self._fresh = [isinstance(o, torch.Tensor) and id(o) not in donated
                       for o in out_flat]
        self.launches = delta
        self.pool_bytes = max(
            torch.cuda.memory_reserved(self.device) - reserved, 0)

    def __call__(self, *args):
        if self.graph is None:
            raise RuntimeError("the graph was never captured")
        flat, spec = pytree.tree_flatten(args)
        if spec != self._in_spec:
            raise ValueError(f"arguments {spec}, captured {self._in_spec}")
        for i, (buf, a) in enumerate(zip(self.static_in, flat)):
            if a is buf:
                continue
            if i < self._n_donated:
                raise ValueError(f"argument {i}: a donated graph replays "
                                 f"into the state it captured; pass those "
                                 f"tensors")
            if a.shape != buf.shape or a.dtype != buf.dtype:
                raise ValueError(
                    f"argument {i}: {tuple(a.shape)} {a.dtype}, captured "
                    f"{tuple(buf.shape)} {buf.dtype}")
            buf.copy_(a)
        self.graph.replay()
        _add_counts(self.launches, 1)
        out = pytree.tree_unflatten(
            [o.clone() if fresh else o
             for o, fresh in zip(self.static_out, self._fresh)],
            self._out_spec)
        return (args[0], *out[1:]) if self.donate else out

    def release(self) -> None:
        """Drop the graph, its static buffers and its pool (a donated
        state stays with its caller)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.static_in, self.static_out = [], []
