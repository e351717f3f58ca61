"""Build the hand-written CUDA kernels and load them with ctypes.

Each source under ``src/repro_torch/csrc/`` exposes a plain C launch
function; it is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library at first use, under ``build/repro_torch/`` of the checkout, and
loaded with :mod:`ctypes`. A library is named by the hash of its source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header always rebuilds and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per missing source and waits for all
of them, so the sources compile in parallel.

Nothing here runs at import time: importing ``repro_torch`` needs neither
``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
#: one shared library per kernel source
SOURCES = {
    "octent_query": "octent_query.cu",
    "spconv_gemm_fused": "spconv_gemm_fused.cu",
    "spconv_gemm": "spconv_gemm.cu",
    "masked_matmul": "masked_matmul.cu",
    "flash_attention": "flash_attention.cu",
    "segment_sum": "segment_sum.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``REPRO_TORCH_BUILD_DIR`` (``runtime/flags.py``) or
    ``build/repro_torch`` at the repo root."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> None:
    """Compile every missing library in ``names`` (default: all), one
    ``nvcc`` process per source, all started together, each with its
    ptxas report beside it (:func:`ptxas_log`)."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        lib = library_path(n)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, lib)
    errors = []
    for n, (p, tmp, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]} "
                          f"(exit {p.returncode}):\n{log}")
            continue
        # the log first, so that a built library always has its log
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))


def ptxas_log(name: str) -> str:
    """The ``nvcc -Xptxas -v`` output of kernel ``name``'s built library:
    each kernel's registers, static shared memory and spills."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def launch_fn(name: str, argtypes: list, entry: str | None = None):
    """The C function ``entry`` (default ``<name>_launch``) of kernel
    ``name`` (built and loaded at first use), with its argument types
    declared and an ``int`` result: the CUDA error code of the launch."""
    fn = getattr(load(name), entry or f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check_tensor(name: str, t, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    (None matches any extent): what a kernel wrapper checks before it
    hands a pointer to CUDA."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
