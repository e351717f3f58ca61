"""Pipeline parallelism over the ``pod`` axis: the GPipe schedule, the
counterpart of the reference's ``src/repro/runtime/pipeline.py``.

The layers split into S stages, S the extent of a mesh dimension (``pod``
by default) of a ``torch.distributed`` ``DeviceMesh``
(``runtime/sharding``, ``launch/mesh.py``): stage i is the rank at index i
of that dimension and holds only its own stage's parameters. M
microbatches flow stage to stage in M + S - 1 ticks, the classic GPipe
bubble of (S - 1) / (M + S - 1) of the ticks a stage.

The reference computes on every tick and masks the dead ones' results
away; a live stage's input is always its upstream stage's live output, so
the port computes only on the live ticks (stage i holds microbatch t - i
on tick t), which gives the same function. On every tick every rank joins
one hand-off downstream, a ``permute_tensor`` (an ``all_to_all_single``)
over the dimension's group, so all ranks issue the same collectives in
the same order. The last stage's outputs reach every rank by a masked
all-reduce SUM, as the reference's masked ``psum``.

The gradient: :func:`pipeline_apply` is one ``torch.autograd.Function``,
so autograd never drives a collective on one rank alone. Its forward runs
the schedule without a graph and keeps each live tick's input; its
backward runs the ticks in reverse, every rank joining the inverse
permute on each, and takes the VJP of ``stage_fn`` for that tick's input
and the stage's parameters with ``torch.autograd.grad``. The final
hand-back's cotangent enters the last stage once, as it is: every rank
holds the same loss of the replicated output, and all-reducing the
cotangent would scale each gradient by S. The input's gradient is summed
over the dimension, so every rank holds the whole gradient of the
replicated input (only stage 0's share is nonzero), as the transpose of a
replicated input in the reference. With the reference's test shapes the
gradients equal ``jax.grad`` through the reference's pipeline
(``tests/test_torch_pipeline.py``).

:func:`lm_pipeline_logits` and :func:`lm_pipeline_loss` run a dense
decoder LM of ``models/transformer.py`` this way: each rank embeds the
tokens and applies the final norm, head and loss itself (those parameters
are on every rank); the layers run pipelined. Kernel 5 launches M x L / S
times on each rank in a forward.
"""
from __future__ import annotations

import functools

import torch


def stack_stages(layer_params, n_stages: int):
    """Regroup the layers into ``n_stages`` stages of L / S each.

    A tensor (or a dict/tuple of tensors) stacked on a leading layer axis,
    (L, ...), becomes (S, L / S, ...), the reference's contract; the
    port's own layer list (``params["layers"]``, one dict a layer) becomes
    a list of S contiguous lists of L / S layers. L must divide by S."""
    if isinstance(layer_params, list):
        n = len(layer_params)
        assert n % n_stages == 0, (n, n_stages)
        k = n // n_stages
        return [layer_params[i * k:(i + 1) * k] for i in range(n_stages)]
    from torch.utils._pytree import tree_map

    def regroup(a):
        n = a.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return a.reshape(n_stages, n // n_stages, *a.shape[1:])

    return tree_map(regroup, layer_params)


def stage_index(mesh, axis: str = "pod") -> int:
    """This rank's stage: its index along mesh dimension ``axis``."""
    return int(mesh.get_local_rank(axis))


def local_stage(stacked, mesh, axis: str = "pod"):
    """This rank's stage of :func:`stack_stages`' result: entry
    :func:`stage_index` of the stage list, or of each stacked leaf."""
    i = stage_index(mesh, axis)
    if isinstance(stacked, list):
        return stacked[i]
    from torch.utils._pytree import tree_map
    return tree_map(lambda a: a[i], stacked)


def bubble_share(n_micro: int, n_stages: int) -> float:
    """The share of a stage's ticks that are dead: (S - 1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _permute(x, group, size: int, shift: int):
    """``x`` sent to the rank ``shift`` further along the ring of
    ``group``; returns what this rank receives."""
    import torch.distributed._functional_collectives as funcol
    dst = [(i + shift) % size for i in range(size)]
    flat = x.reshape(-1)
    out = funcol.wait_tensor(funcol.permute_tensor(flat, dst, group))
    return out.reshape(x.shape)


class _Pipeline(torch.autograd.Function):
    """The schedule (forward) and its transpose (backward); see the
    module docstring. Arguments after ``ctx``: the stage function, the
    parameters' tree spec, the group, its size, this rank's stage, the
    microbatched input, then the stage's parameter leaves."""

    @staticmethod
    def forward(ctx, stage_fn, spec, group, s, stage, x_mb, *leaves):
        import torch.distributed._functional_collectives as funcol
        from torch.utils._pytree import tree_unflatten
        params = tree_unflatten(list(leaves), spec)
        m = x_mb.shape[0]
        buf = torch.zeros_like(x_mb)
        carry = torch.zeros_like(x_mb[0])
        inputs = [None] * m
        for t in range(m + s - 1):
            j = t - stage
            if 0 <= j < m:
                x_in = x_mb[j] if stage == 0 else carry
                inputs[j] = x_in
                y = stage_fn(params, x_in)
                buf[j] = y
            else:
                y = torch.zeros_like(x_mb[0])
            carry = _permute(y, group, s, 1)
        out = funcol.wait_tensor(funcol.all_reduce(
            buf if stage == s - 1 else torch.zeros_like(buf), "sum", group))
        ctx.stage_fn, ctx.spec, ctx.group = stage_fn, spec, group
        ctx.s, ctx.stage = s, stage
        # every stage is live on M ticks, one a microbatch
        ctx.save_for_backward(*inputs, *leaves)
        return out

    @staticmethod
    def backward(ctx, g_out):
        import torch.distributed._functional_collectives as funcol
        from torch.utils._pytree import tree_unflatten
        s, stage = ctx.s, ctx.stage
        m = g_out.shape[0]
        saved = ctx.saved_tensors
        inputs, leaves = saved[:m], saved[m:]
        g_leaves = [torch.zeros_like(a) if a.requires_grad else None
                    for a in leaves]
        g_x = torch.zeros_like(g_out)
        recv = torch.zeros_like(g_out[0])
        for t in reversed(range(m + s - 1)):
            j = t - stage
            if 0 <= j < m:
                # the last stage's output is the hand-back: its cotangent
                # enters once, as it is; the others' came from downstream
                g = g_out[j] if stage == s - 1 else recv
                x = inputs[j].detach().requires_grad_()
                ps = [a.detach().requires_grad_(a.requires_grad)
                      for a in leaves]
                with torch.enable_grad():
                    y = ctx.stage_fn(tree_unflatten(ps, ctx.spec), x)
                wrt = [x] + [p for p in ps if p.requires_grad]
                grads = torch.autograd.grad(y, wrt, g, allow_unused=True)
                gx, gp = grads[0], iter(grads[1:])
                for i, p in enumerate(ps):
                    if p.requires_grad:
                        gi = next(gp)
                        if gi is not None:
                            g_leaves[i] += gi
                if stage == 0:
                    g_x[j] = gx
                send = gx
            else:
                send = torch.zeros_like(g_out[0])
            recv = _permute(send, ctx.group, s, -1)
        # the replicated input's gradient, summed over the dimension
        g_x = funcol.wait_tensor(funcol.all_reduce(g_x, "sum", ctx.group))
        return (None, None, None, None, None, g_x, *g_leaves)


def pipeline_apply(stage_params, x_mb: torch.Tensor, stage_fn, *, mesh,
                   axis: str = "pod") -> torch.Tensor:
    """Run a GPipe pipeline over mesh dimension ``axis``.

    stage_params: this rank's stage (:func:`local_stage`): a tensor, or a
      dict, list or tuple of tensors, nested.
    x_mb: (M, mb, ...) microbatched input, the same on every rank of
      ``axis``.
    stage_fn(stage_params, x) -> y of x's shape and dtype, the stage's
      layers; applied S times in sequence overall.
    Returns the last stage's (M, mb, ...) outputs on every rank of
    ``axis``; differentiable in ``x_mb`` and the stage's parameters.
    """
    from torch.utils._pytree import tree_flatten
    leaves, spec = tree_flatten(stage_params)
    return _Pipeline.apply(stage_fn, spec, mesh.get_group(axis),
                           int(mesh.size(mesh.mesh_dim_names.index(axis))),
                           stage_index(mesh, axis), x_mb, *leaves)


# ---------------------------------------------------------------------------
# the dense decoder LM, pipelined
# ---------------------------------------------------------------------------

def lm_stage_params(flat: dict, n_layers: int, mesh,
                    axis: str = "pod") -> tuple[dict, dict]:
    """``(params, keys)``: the nested parameters this rank runs, ``embed``,
    ``final_norm`` and, untied, ``lm_head`` of the ``state_dict`` ``flat``
    with ``params["layers"]`` only this rank's stage's L / S layers, and
    for each of their leaves its key in ``flat``. ``flat`` must hold those
    layers (``layers.<i>.*`` at their global index); others are ignored.
    The tensors are ``flat``'s."""
    from repro_torch.models import common
    s = int(mesh.size(mesh.mesh_dim_names.index(axis)))
    assert n_layers % s == 0, (n_layers, s)
    per = n_layers // s
    lo = stage_index(mesh, axis) * per
    local, keys = {}, {}
    for k in flat:
        name = k
        if k.startswith("layers."):
            _, i, rest = k.split(".", 2)
            if not lo <= int(i) < lo + per:
                continue
            name = f"layers.{int(i) - lo}.{rest}"
        local[name] = flat[k]
        keys[name] = k
    return common.nest_params(local), keys


def _lm_stage(layers, h, cfg, impl):
    from repro_torch.models import transformer
    for lp in layers:
        h = transformer._layer_full(lp, h, cfg, impl)[0]
    return h


def _lm_hidden(params, inputs, cfg, *, mesh, n_micro, axis, impl):
    from repro_torch.models import common
    if cfg.n_experts:
        raise ValueError("the pipeline carries hidden states only: an MoE "
                         "layer's aux loss has no path through it")
    b = inputs.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    h = common.embed(params["embed"], inputs)
    x_mb = h.reshape(n_micro, b // n_micro, *h.shape[1:])
    fn = functools.partial(_lm_stage, cfg=cfg, impl=impl)
    y = pipeline_apply(params["layers"], x_mb, fn, mesh=mesh, axis=axis)
    return common.norm(y.reshape(h.shape), params["final_norm"], cfg.norm)


def lm_pipeline_logits(params, tokens, cfg, *, mesh, n_micro: int,
                       axis: str = "pod",
                       impl: str = "kernel") -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) of a dense decoder LM, its layers
    pipelined over ``axis`` in ``n_micro`` microbatches of B / n_micro
    rows; ``params`` from :func:`lm_stage_params` (``params["layers"]``
    this rank's stage). Every rank embeds the tokens and applies the final
    norm and head itself."""
    from repro_torch.models import transformer
    h = _lm_hidden(params, tokens, cfg, mesh=mesh, n_micro=n_micro,
                   axis=axis, impl=impl)
    return transformer.logits_fn(params, h, cfg)


def lm_pipeline_loss(params, batch: dict, cfg, *, mesh, n_micro: int,
                     axis: str = "pod", impl: str = "kernel") -> torch.Tensor:
    """``transformer.lm_loss``'s next-token cross entropy of a dense model,
    the layers pipelined as in :func:`lm_pipeline_logits`; the same value
    on every rank of ``axis``."""
    from repro_torch.models import common, transformer
    inputs, targets = common.shift_labels(batch["tokens"])
    h = _lm_hidden(params, inputs, cfg, mesh=mesh, n_micro=n_micro,
                   axis=axis, impl=impl)
    logits = transformer.logits_fn(params, h, cfg)
    mask = batch.get("loss_mask")
    return common.cross_entropy(logits, targets,
                                mask[:, 1:] if mask is not None else None)


def lm_pipeline_loss_and_grads(flat: dict, batch: dict, cfg, *, mesh,
                               n_micro: int, axis: str = "pod",
                               impl: str = "kernel"):
    """``(loss, grads)`` of :func:`lm_pipeline_loss` at the ``state_dict``
    ``flat`` (not modified; see :func:`lm_stage_params`): ``grads`` keyed
    as ``flat``, for the shared entries and this rank's layers. The shared
    entries' gradients are whole on every rank (each rank computes the
    same loss from the same replicated input gradient); a layer's is on
    its stage's ranks."""
    leaves = {k: v.detach().requires_grad_() for k, v in flat.items()}
    params, keys = lm_stage_params(leaves, cfg.n_layers, mesh, axis)
    loss = lm_pipeline_loss(params, batch, cfg, mesh=mesh, n_micro=n_micro,
                            axis=axis, impl=impl)
    used = list(keys.values())
    grads = torch.autograd.grad(loss, [leaves[k] for k in used])
    return loss.detach(), dict(zip(used, grads))
