"""The port's runtime flags: the one registry, the counterpart of the
reference's ``src/repro/runtime/flags.py``.

Every environment flag the port reads (``src/repro_torch/`` and
``chip_smoke.py``) is listed here with its default and when its value is
read: per call, per construction of the object that reads it, or per
launch. Each module that reads a flag names it in its own docstring and
points here. ``tests/test_torch_flags.py`` holds this list to the code:
every ``REPRO_*`` name read in the port appears below, and every name
below is read somewhere or listed under "not read by the port".

Environment flags read by the port:

``REPRO_SPAC_BLOCK``
    ``0`` turns off Cin-block-grain SPAC skipping inside live tiles: the
    fused kernel (kernel 2) then skips at tile grain only, its
    ``tile_bk_nz`` the tile liveness widened over the Cin blocks. The
    output is bit-identical either way; only the skipped loads and MACs
    change. Default on. Re-read per call by
    :func:`repro_torch.kernels.spconv_gemm.ops.spac_block_enabled`,
    consumed by ``kernel_inputs`` (every ``apply_tiles``).

``REPRO_PLANCACHE_CONTENT``
    ``0`` turns content-addressed :class:`~repro_torch.core.plan.PlanCache`
    keys off process-wide (identity keys only, no pinned tables). Default
    on. Read when a cache is built with ``content=None`` (the default;
    an explicit ``content=`` wins). Content-hit verification is per
    instance only: ``PlanCache(verify=True)``.

``REPRO_GUARD_VALIDATE``
    The ingress sanitizer's policy: ``repair`` (default) | ``strict`` |
    ``off``. Re-read per call by
    :func:`repro_torch.runtime.guard.validate_policy`; consumed by
    ``core.spconv.make_sparse_tensor`` and the training demo's ingress.

``REPRO_GUARD_REPLAN``
    Most overflow-adaptive replan escalations of one build (default
    ``6``; ``0``: an overflow raises). Re-read per call by
    :func:`repro_torch.runtime.guard.replan_retries`; consumed by
    ``guard.with_replan``, ``models.minkunet.build_plans``,
    ``core.spconv`` and ``core.stream``.

``REPRO_GUARD_FALLBACK``
    ``1`` turns the backend fallback chain on (retry, quarantine, serve
    the next impl). **The port defaults it to ``0``**, where the
    reference's default is on: a failing kernel raises to its caller. Even
    with ``1`` the chain of a CUDA tensor is empty
    (``guard.fallback_chain``): on the card the kernel is retried and
    quarantined as in the reference, and every call it cannot serve
    raises; the plain versions never stand in for a kernel there (ROADMAP
    §3 item 7). Re-read per call by
    :func:`repro_torch.runtime.guard.fallback_enabled`.

``REPRO_GUARD_COOLDOWN``
    Calls a quarantined (site, impl, shape class) sits out before it is
    tried again (default ``32``). Re-read per call by
    :func:`repro_torch.runtime.guard.fallback_cooldown`.

``REPRO_SERVE_BUCKETS``
    The admission queue's padding buckets, comma-separated ascending voxel
    budgets (default ``512,1024,2048,4096,8192,16384``). Read per queue
    construction by :func:`repro_torch.runtime.admission.bucket_classes`.

``REPRO_SERVE_QUEUE_CAP``
    Admission-queue depth (default ``64``); a submit beyond it is shed as
    ``queue_full``. Read per queue construction by
    :func:`repro_torch.runtime.admission.queue_capacity`.

``REPRO_SERVE_DEADLINE_MS``
    A request's deadline when ``submit(deadline_s=None)`` (default
    ``60000``). Read per queue construction by
    :func:`repro_torch.runtime.admission.default_deadline_s`.

``REPRO_SERVE_MAX_BATCH``
    Requests the serve engine drains a tick (default ``8``; ladder level 1
    halves it). Read when a
    :class:`~repro_torch.launch.spconv_serve.ServeEngine` is built with
    ``max_batch=None`` (the default, and the CLI's ``--max-batch``
    default), by :func:`repro_torch.launch.spconv_serve.serve_max_batch`.

``REPRO_SERVE_VALIDATE``
    The admission sanitizer's policy: ``strict`` (default) | ``repair`` |
    ``off``. Read per queue construction by
    :func:`repro_torch.runtime.admission.serve_policy`.

``REPRO_PERSIST_DIR``
    The durability root of warm restarts; when set (and no
    ``--persist-dir`` is given) the serving and training CLIs open their
    snapshot stores under it. Unset (the default): no persistence. Read
    per launch by :func:`repro_torch.runtime.persist.default_dir`.

``REPRO_PERSIST_MAX_BYTES``
    On-disk byte budget of a snapshot store (default ``268435456``,
    256 MiB), oldest entries evicted first. Read per store construction
    by :func:`repro_torch.runtime.persist.default_max_bytes`; phase
    ``restart`` of ``chip_smoke.py`` sets it for its workers.

``REPRO_PERSIST_VERIFY``
    ``0`` skips the sha256 check when a snapshot entry loads (version,
    salt and key are always checked). Default on. Read per store
    construction.

``REPRO_PERSIST_SALT``
    Overrides the snapshot invalidation salt (default: format version,
    codec revision and torch version, ``persist.default_salt``); entries
    under another salt read as stale. Read per store construction.

``REPRO_STREAM``
    ``0`` turns the streaming delta path off: every frame of a
    :class:`~repro_torch.core.stream.StreamSession` is rebuilt from
    scratch. Output is bit-identical either way. Read per session
    construction by :func:`repro_torch.core.stream.stream_enabled`
    (``StreamSession(enabled=...)`` overrides).

``REPRO_STREAM_MAX_DIRTY``
    Dirty-row share above which a streamed level is rebuilt instead of
    patched (default ``0.5``). Read per session construction by
    :func:`repro_torch.core.stream.max_dirty_frac`.

``REPRO_TORCH_BUILD_DIR``
    Where ``kernels/build.py`` writes the CUDA kernels' shared libraries
    (default ``build/repro_torch`` at the repository root). Read per
    build (a kernel's first launch in a process).

Flags of the reference that the port does not read, each with its reason:

``REPRO_SEARCH_IMPL``, ``REPRO_KERNEL_IMPL``
    The reference picks its map-search and rulebook backends from these.
    In the port the tensor's device picks: a CUDA tensor launches the
    kernel or raises, a CPU tensor runs the plain version, and a plain
    version never stands in for a kernel on the card. A caller asks for
    another execution per call (``impl="ref"`` / ``"scan"``).

``REPRO_BENCH_FAST``
    The reduced sweep of the reference's ``benchmarks/run.py``: the
    benchmarks are not ported.

``REPRO_PROPTEST_CASES``
    Cases per ``@forall`` property test: it belongs to the tests
    (``tests/proptest.py``), not to a package.

The reference's in-process flag ``UNROLL_FOR_COST``, with ``cost_unroll``
and the ``unroll_for_cost`` context manager, has no counterpart either:
XLA's cost analysis counts a loop body once, so the reference unrolls its
scans to count them; the port has no scans to unroll (depth is a Python
loop) and its dry run counts every op eagerly, checked against the
depth-1/2 extrapolation of ``launch/dryrun.py`` (``_depth_variants``).
"""
from __future__ import annotations

#: the reference's flags the port does not read (reasons above)
NOT_READ = ("REPRO_SEARCH_IMPL", "REPRO_KERNEL_IMPL", "REPRO_BENCH_FAST",
            "REPRO_PROPTEST_CASES")
