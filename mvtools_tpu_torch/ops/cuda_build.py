"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use every source
is compiled with its own ``nvcc`` process (all started together) into
``mvtools_tpu_torch/build/lib<name>-<hash>.so`` and loaded with ``ctypes``;
the hash covers the source text, the text of every header the source
includes from ``csrc/`` (and of the headers those include) and the flags, so
an edited source or header is rebuilt and a finished build is reused.  Nothing here runs at import time:
a machine without ``nvcc`` can import every module and use the plain PyTorch
versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = ("sadmap", "probe", "probe_block", "fetch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
build_seconds = 0.0    # wall time spent compiling in this process


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use and "
        "need the CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _with_headers(path: Path, seen: set) -> bytes:
    """The text of a source followed by that of every csrc/ header it
    includes with quotes, each header once, in order of first mention."""
    text = path.read_bytes()
    for inc in _INCLUDE.findall(text):
        header = CSRC / inc.decode()
        if header not in seen and header.exists():
            seen.add(header)
            text += _with_headers(header, seen)
    return text


def _target(name: str) -> Path:
    text = (_with_headers(CSRC / f"{name}.cu", set())
            + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{hashlib.sha1(text).hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> float:
    """Compile every kernel source that has no up-to-date library, one
    nvcc per source in parallel.  Returns the seconds it took."""
    global build_seconds
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD.mkdir(exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    dt = time.perf_counter() - t0
    build_seconds += dt
    return dt


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
