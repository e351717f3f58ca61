"""SpOctA on PyTorch and CUDA: the port of the ``repro`` package.

The sub-packages mirror ``repro`` module for module (``configs``,
``core``, ``kernels``, ``models``, ``data``, ``runtime``, ``launch``) so
every function has a findable counterpart. Every kernel is written by hand in CUDA C++ for
Hopper (``csrc/``) and built with ``nvcc`` at first use:

  * ``kernels/octent``        — the OCTENT map-search query;
  * ``kernels/spconv_gemm``   — the output-stationary gather-GEMM that runs
    every Subm3 / Gconv2 / Tconv2 layer, with its fused BN/ReLU epilogue
    (the serving path), and the materialized tiled GEMM behind the
    ``apply_kmap`` baseline;
  * ``kernels/masked_matmul`` — the block-masked dense matmul (SPAC tile
    skipping on one GEMM);
  * ``kernels/flash_attention`` — causal / sliding-window / non-causal,
    GQA / MQA attention: every attention layer of a prefill or a training
    forward of the decoder LMs (``models/transformer``), RecurrentGemma
    (``models/rglru``), the HuBERT encoder (``models/encoder``) and the
    LLaVA VLM (``models/vlm``), served by ``launch/serve`` and trained by
    ``launch/train``; Mamba2 (``models/mamba2``) runs none.

``plan.execute(impl="scan")`` runs a layer by the plain tap scan instead,
the oracle the reference calls ``impl="xla"``.

Importing this package never builds a kernel and never needs ``nvcc``.
Entry points (``ServeEngine``, ``MinkUNet``, ``build_plans``, ``DecoderLM``
and the other families' modules, ``build_model``, ``generate``) run on the card unless the caller passes
``device="cpu"``; with no card they raise.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
