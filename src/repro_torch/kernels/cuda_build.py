"""Build the port's CUDA C++ kernels with nvcc and load them with ctypes.

Each source under ``repro_torch/csrc`` compiles, at first use, into a shared
library with a plain C interface under ``build/kernels/`` at the root of the
checkout. The library's name carries a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. nvcc's
report (``-Xptxas=-v``: registers, shared memory, spills per kernel) is kept
beside each library as ``<name>.log``.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run resets
it to see which kernels its path went through.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# sm_90a: Hopper with its architecture-specific instructions. No
# --use_fast_math: kernels are held to their plain PyTorch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES: collections.Counter = collections.Counter()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH)")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_command(nvcc: str, source: Path, output: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def build(sources: Iterable[Path]) -> List[Path]:
    """Compile every source whose library is missing, all nvcc runs at once.

    Returns the library paths in the order of ``sources``; raises with
    nvcc's output if any compilation fails.
    """
    sources = [Path(s) for s in sources]
    libs = [library_path(s) for s in sources]
    todo = [(s, lib) for s, lib in zip(sources, libs) if not lib.exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    running = []
    for source, lib in todo:
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            build_command(nvcc, source, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((source, lib, tmp, proc))
    failed = []
    for source, lib, tmp, proc in running:
        report, _ = proc.communicate()
        lib.with_suffix(".log").write_text(report)
        if proc.returncode != 0:
            failed.append(f"{source.name}:\n{report}")
            continue
        os.replace(tmp, lib)     # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def aligned_rows(x):
    """``x`` if a kernel can read its rows in place by 16-byte copies: unit
    stride on the last axis, 16-byte aligned, every other stride a whole
    number of 16-byte vectors. Otherwise a contiguous copy (a fresh,
    aligned allocation)."""
    vec = 16 // x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in x.stride()[:-1])):
        return x
    return x.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def load_library(source_name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<source_name>``, built on first use."""
    (lib,) = build([CSRC / source_name])
    return ctypes.CDLL(str(lib))
