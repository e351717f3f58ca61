"""SpOctA on PyTorch and CUDA: the port of the ``repro`` package.

The sub-packages mirror ``repro`` module for module (``core``, ``kernels``,
``models``, ``data``, ``runtime``, ``launch``) so every function has a
findable counterpart. Two kernels carry the serving path, each written by
hand in CUDA C++ for Hopper (``csrc/``) and built with ``nvcc`` at first use:

  * ``kernels/octent``      — the OCTENT map-search query;
  * ``kernels/spconv_gemm`` — the output-stationary gather-GEMM that runs
    every Subm3 / Gconv2 / Tconv2 layer, with its fused BN/ReLU epilogue.

Importing this package never builds a kernel and never needs ``nvcc``.
Entry points (``ServeEngine``, ``MinkUNet``, ``build_plans``) run on the
card unless the caller passes ``device="cpu"``; with no card they raise.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
