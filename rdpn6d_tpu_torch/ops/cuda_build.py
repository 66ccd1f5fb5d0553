"""Build and load the port's CUDA kernels, and count their launches.

Each kernel source under ``rdpn6d_tpu_torch/csrc/`` is compiled at first use
with ``nvcc`` for ``sm_90a`` (Hopper) into a shared library with a plain C
interface, loaded with ctypes. Nothing is built when a module is imported.
The library lands in ``rdpn6d_tpu_torch/_build/`` (git-ignored) under a
name keyed by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads at once. ``nvcc`` comes from
``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``. ``build_host``
does the same for a host C++ source (``csrc/<name>.cpp``, the VSD
rasterizer) with ``c++`` or ``g++`` at fixed flags: no ``-march=native``
and no contraction to FMAs, so its output does not depend on the machine.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run that
must show a path went through a kernel zeroes it with ``reset_launches``
before and reads it after. For tests and ``chip_smoke.py`` only, a
process started with ``RDPN6D_LAUNCH_LOG`` set appends its argv and counts
to that file as a JSON line when it exits, so that a chain of
subprocesses (``tools.rehearse_protocol``) reports its launches too; no
entry point of the port reads it.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")

LAUNCHES: dict[str, int] = {}


@dataclass
class Built:
    path: str           # the shared library
    log: str            # nvcc's output, incl. -Xptxas -v register counts


_LOADED: dict[str, tuple[ctypes.CDLL, Built]] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def _log_launches(path: str) -> None:
    with open(path, "a") as f:
        f.write(json.dumps({"argv": sys.argv, "launches": LAUNCHES}) + "\n")


if os.environ.get("RDPN6D_LAUNCH_LOG"):
    atexit.register(_log_launches, os.environ["RDPN6D_LAUNCH_LOG"])


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the CUDA kernels "
                       "cannot be built")


def _cxx() -> str:
    for c in ("c++", "g++"):
        path = shutil.which(c)
        if path:
            return path
    raise RuntimeError("no host C++ compiler (c++ or g++ on PATH): the "
                       "host libraries cannot be built")


def _compile(name: str, src: str, compiler, flags: tuple[str, ...]) -> Built:
    """Compile ``src`` with ``flags`` into ``_build/`` unless the library
    for this exact source and these flags is already there."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    stem = f"{name}-{digest.hexdigest()[:16]}"
    lib = os.path.join(BUILD_DIR, stem + ".so")
    log_path = os.path.join(BUILD_DIR, stem + ".log")
    if os.path.exists(lib):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return Built(lib, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cc = compiler()
    proc = subprocess.run([cc, *flags, "-o", tmp, src],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(cc)} failed on {src} "
                           f"(rc={proc.returncode}):\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return Built(lib, log)


def build(name: str) -> Built:
    """Compile the kernel source ``csrc/<name>.cu`` with nvcc for sm_90a."""
    return _compile(name, os.path.join(CSRC_DIR, f"{name}.cu"), _nvcc,
                    NVCC_FLAGS)


def build_host(name: str) -> Built:
    """Compile the host source ``csrc/<name>.cpp`` with the host compiler
    at ``HOST_FLAGS``; a failed build raises."""
    return _compile(name, os.path.join(CSRC_DIR, f"{name}.cpp"), _cxx,
                    HOST_FLAGS)


@functools.lru_cache(maxsize=None)
def sm_count(index: int | None) -> int:
    """The SMs of CUDA device ``index``, for a kernel's launch plan."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def ptxas_usage(log: str) -> dict[str, dict[str, int]]:
    """Each kernel's resources from a build log of ``-Xptxas -v``: mangled
    name -> registers, spill_stores and spill_loads (bytes) and smem (bytes
    of static shared memory; dynamic shared memory is not in the log)."""
    usage: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            usage[name] = {"registers": 0, "spill_stores": 0,
                           "spill_loads": 0, "smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[name]["spill_stores"] = int(m.group(1))
            usage[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            usage[name]["smem"] = int(m.group(1)) if m else 0
            name = None
    return usage


def load(name: str) -> tuple[ctypes.CDLL, Built]:
    """The loaded library for kernel ``name``, built first if needed."""
    if name not in _LOADED:
        built = build(name)
        _LOADED[name] = (ctypes.CDLL(built.path), built)
        LAUNCHES.setdefault(name, 0)
    return _LOADED[name]


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library ``name``, built first if needed."""
    key = "host:" + name
    if key not in _LOADED:
        built = build_host(name)
        _LOADED[key] = (ctypes.CDLL(built.path), built)
    return _LOADED[key][0]
