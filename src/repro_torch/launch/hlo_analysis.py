"""Cost counts and roofline terms of a step, the port's counterpart of the
reference's ``src/repro/launch/hlo_analysis.py``. The name is kept so
that a reader finds the counterpart; the port reads no HLO.

The reference mines XLA's compiled program: ``cost_analysis()`` for FLOPs
and bytes accessed, the post-partitioning HLO text for collective bytes.
The port runs the step eagerly on ``meta`` DTensors (``launch/dryrun.py``)
under :class:`CostMode`, a ``TorchDispatchMode`` that lets DTensor turn
each op into its local ops and collectives first (it answers
``NotImplemented`` to DTensor arguments, as ``CommDebugMode`` does) and
then counts, per device:

* FLOPs, from ``torch.utils.flop_counter.FlopCounterMode``'s own formula
  table (matmuls, convolutions, attention);
* bytes accessed: the operand and result bytes of every aten op that is
  not a view, unfused, as XLA's count of an unfused HLO module is;
* collectives: each ``c10d_functional`` collective DTensor issues (and
  DTensor's own ``shard_dim_alltoall``), by the reference's kind names,
  with its result bytes: the payload a device materializes, as the
  reference sizes its collectives' results (:class:`CollectiveStats`);
* live bytes, the counterpart of XLA's ``temp_size_in_bytes``: each op
  that is not a view adds the bytes of the storages it makes (its
  outputs' storages that none of its inputs holds; a collective's
  wrapper and ``wait_tensor``, which hand their input on, make none),
  and a storage's bytes
  leave when it is freed (a ``weakref.finalize`` on the storage, whose
  Python object torch keeps unique). :attr:`CostMode.peak_bytes` is the
  most that were live at once: the step's peak above its arguments, its
  outputs included. Tensors made before the mode (the arguments) are not
  counted. A caching allocator rounds each block up, so a card's
  ``max_memory_allocated`` grows by somewhat more.

``param_count`` and ``model_flops`` are the reference's arithmetic, copied.
``roofline_terms`` keeps the reference's form with the constants of the
card this port runs on (NVIDIA H100 SXM5 80GB datasheet figures).
``parse_collectives`` and ``top_collectives`` read HLO text and have no
counterpart.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ---------------------------------------------------------------------------
# Roofline constants: NVIDIA H100 SXM5 80GB datasheet, per card
# ---------------------------------------------------------------------------

#: dense BF16 tensor-core peak (the datasheet's 1,979 TFLOP/s is with
#: 2:4 sparsity), FLOP/s
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: NVLink 4: 900 GB/s bidirectional, 450 GB/s a direction, bytes/s
NVLINK_BW = 450e9

#: the reference's collective kinds, by the op-name fragment that marks
#: them in ``c10d_functional`` (and DTensor's own all-to-all op)
_KINDS = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("alltoall", "all-to-all"),
          ("all_to_all", "all-to-all"), ("permute", "collective-permute"))


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


def _collective_kind(func) -> str | None:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional", "_dtensor"):
        return None
    name = func._opname
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


def _tensor_bytes(tree) -> int:
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


def _is_fake(args) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._pytree import tree_leaves
    return any(isinstance(a, FakeTensor) for a in tree_leaves(args))


_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh"}
#: ``c10d_functional`` ops that hand their input on (a wrapper or the
#: waited tensor) where their ``meta`` kernel makes a new tensor: no
#: allocation in the walk of live bytes
_ALIAS_OPS = {"_wrap_tensor_autograd", "wait_tensor"}


def _storages(tree) -> dict:
    """``{key: storage}`` of the tensors in ``tree`` (key: the storage's
    address in torch, stable across its Python wrappers)."""
    from torch.utils._pytree import tree_leaves
    out = {}
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            try:
                st = x.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            out[st._cdata] = st
    return out


class CostMode(TorchDispatchMode):
    """Per-device counts of the ops run under it: :attr:`flops`,
    :attr:`bytes` and :attr:`collectives`; :attr:`n_ops` the local ops
    counted; :attr:`live_bytes` now and :attr:`peak_bytes` at most, with
    :attr:`peak_storages` the storages live at that peak. See the module
    docstring."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_fns = FlopCounterMode().flop_registry
        self.flops = 0
        self.bytes = 0
        self.n_ops = 0
        self.collectives = CollectiveStats()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_storages = 0
        self._live: dict[int, int] = {}      # storage key -> bytes

    def _made(self, args, kwargs, out) -> None:
        inputs = _storages((args, kwargs))
        for key, st in _storages(out).items():
            if key in inputs or key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._freed, key)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_storages = len(self._live)

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # let DTensor desugar first
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload) \
                or _is_fake((args, kwargs, out)):
            # DTensor's shape propagation runs ops on fake tensors: not
            # the program's
            return out
        if not func.is_view and func._opname not in _ALIAS_OPS:
            self._made(args, kwargs, out)
        kind = _collective_kind(func)
        if kind is not None:
            b = _tensor_bytes(out)
            st = self.collectives
            st.bytes_by_kind[kind] = st.bytes_by_kind.get(kind, 0) + b
            st.count_by_kind[kind] = st.count_by_kind.get(kind, 0) + 1
            return out
        if func.namespace == "_c10d_functional":     # wait_tensor etc.
            return out
        self.n_ops += 1
        packet = func._overloadpacket
        fn = self._flop_fns.get(packet)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        if not func.is_view and func._opname not in _NO_TRAFFIC:
            self.bytes += _tensor_bytes(args) + _tensor_bytes(kwargs) \
                + _tensor_bytes(out)
        return out


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   n_chips: int) -> dict:
    """All inputs are whole-program totals; terms are seconds."""
    compute_t = flops / (n_chips * PEAK_FLOPS_BF16)
    memory_t = hbm_bytes / (n_chips * HBM_BW)
    collective_t = collective_bytes / (n_chips * NVLINK_BW)
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": collective_t}
    dom = max(terms, key=terms.get)
    bound = max(compute_t, memory_t, collective_t)
    terms["dominant"] = dom
    terms["roofline_fraction"] = compute_t / bound if bound > 0 else 0.0
    return terms


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode D = batch."""
    n_params = param_count(cfg, active_only=True)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_params * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_params * tokens
    return 2.0 * n_params * cell.global_batch          # one decode token


def param_count(cfg, active_only: bool = False) -> float:
    """Analytic parameter count per architecture family."""
    d, v = cfg.d_model, cfg.vocab
    if cfg.family == "mamba2":
        d_inner = cfg.ssm_expand * d
        h = d_inner // cfg.ssm_headdim
        conv_dim = d_inner + 2 * cfg.ssm_state
        per_layer = (d * (2 * d_inner + 2 * cfg.ssm_state + h)
                     + cfg.conv_width * conv_dim + conv_dim
                     + 3 * h + d_inner + d_inner * d + d)
        return cfg.n_layers * per_layer + 2 * v * d
    if cfg.family == "rglru":
        w = cfg.lru_width or d
        bh = w // cfg.n_heads
        rec = (2 * d * w + cfg.conv_width * w + w
               + 2 * cfg.n_heads * bh * bh + w + w * d
               + 3 * d * cfg.d_ff)
        hd = cfg.head_dim_
        attn = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
        n_groups = cfg.n_layers // 3
        tail = cfg.n_layers - 3 * n_groups
        return n_groups * (2 * rec + attn) + tail * rec + v * d
    hd = cfg.head_dim_
    attn = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * d)
    if cfg.n_experts:
        ffn_total = cfg.n_experts * 3 * d * cfg.d_ff + d * cfg.n_experts
        ffn_active = cfg.top_k * 3 * d * cfg.d_ff + d * cfg.n_experts
    else:
        gated = 3 if cfg.act == "silu" else 2
        ffn_total = ffn_active = gated * d * cfg.d_ff
    ffn = ffn_active if active_only else ffn_total
    emb = v * d if cfg.tie_embeddings else 2 * v * d
    if cfg.family == "encoder":
        emb = cfg.frontend_dim * d + d * v
    if cfg.family == "vlm":
        emb += cfg.vision_dim * d + d * d
    return cfg.n_layers * (attn + ffn) + emb
