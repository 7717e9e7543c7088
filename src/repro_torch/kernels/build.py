"""Build and load the port's CUDA kernels (plain C entry points, ctypes).

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library under ``<checkout>/build/kernels/``, named by a hash of
the source, every header under ``csrc/`` and the flags, so an edited
source or header rebuilds and an unchanged one is reused.  The kernels
use no CUTLASS or CuTe headers (wgmma, cp.async and the descriptors are
written as inline PTX), so no include path beyond ``csrc/`` is needed.
The build happens at first use, inside the process that launches the
kernel; nothing is built when a module is imported.
`build_all` starts one ``nvcc`` per source at once and waits for all;
`call` launches one entry point on the caller's stream; `ptxas_report`
reads a build's registers and spills.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    process each, all started together.  Returns {name: library path}.
    Raises RuntimeError with the compiler's output if a build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, so)
    failed = []
    for n, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, so)              # atomic: readers never see a torn .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/shared-memory report) of the
    library `load` uses for ``name``, or "" if it was built elsewhere."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed (once per process)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _loaded[name] = lib
        return lib


def call(name: str, symbol: str, args: Sequence, device) -> None:
    """Call ``symbol`` of ``csrc/<name>.cu`` on the current stream of
    ``device``.  Tensors pass as pointers, None as a null pointer, Python
    floats as C floats and ints as C ints; the stream goes last.  Raises
    RuntimeError on a non-zero cudaError (a refused launch never runs)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [ctypes.c_float if isinstance(a, float)
                   else ctypes.c_int if isinstance(a, int)
                   else ctypes.c_void_p for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(device):
        err = fn(*ptrs, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")


def kernel_name(mangled: str) -> str:
    """'_ZN..20flash_bwd_dkv_kernelILi128ELi128EEEv..' ->
    'flash_bwd_dkv_kernel<128,128>' (the last name of a mangled symbol and
    its integer template arguments)."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if mangled[i:i + 1] != "I":
        return name
    args = re.findall(r"L[ib](\d+)E", mangled[i:].split("EE")[0] + "E")
    return f"{name}<{','.join(args)}>"


def ptxas_report(text: str):
    """[(kernel<template args>, registers, spill stores, spill loads)] from
    nvcc's -Xptxas -v output."""
    rows, name, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name = None
    return rows
