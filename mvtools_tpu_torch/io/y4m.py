"""ctypes bindings for the repository's native y4m runtime (native/y4m.cc).

The C++ side owns the stream parsing and a threaded prefetch ring (the
framework's equivalent of the reference host's frame prefetching); this
module shapes the raw planar bytes into per-plane numpy arrays.  The
library is compiled with the host C++ compiler at first use into
mvtools_tpu_torch/build/ (named by a hash of the source and the flags, so
an edited source is rebuilt and a finished build reused); nothing is built
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "y4m.cc"
BUILD = _PKG / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")


def _target() -> Path:
    text = SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    return BUILD / f"libmvtools_io-{hashlib.sha1(text).hexdigest()[:12]}.so"


def build() -> Path:
    """Compile native/y4m.cc unless an up-to-date library exists; returns
    its path."""
    out = _target()
    if not out.exists():
        BUILD.mkdir(exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cxx = os.environ.get("CXX", "g++")
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load_lib():
    lib = ctypes.CDLL(str(build()))
    lib.y4m_open_read.restype = ctypes.c_void_p
    lib.y4m_open_read.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.y4m_info.restype = None
    lib.y4m_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.y4m_frame_bytes.restype = ctypes.c_longlong
    lib.y4m_frame_bytes.argtypes = [ctypes.c_void_p]
    lib.y4m_read_frame.restype = ctypes.c_int
    lib.y4m_read_frame.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint8)]
    lib.y4m_close_read.restype = None
    lib.y4m_close_read.argtypes = [ctypes.c_void_p]
    lib.y4m_open_write.restype = ctypes.c_void_p
    lib.y4m_open_write.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 8
    lib.y4m_write_frame.restype = ctypes.c_int
    lib.y4m_write_frame.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint8)]
    lib.y4m_close_write.restype = None
    lib.y4m_close_write.argtypes = [ctypes.c_void_p]
    return lib


_lib = None


def lib():
    global _lib
    if _lib is None:
        _lib = _load_lib()
    return _lib


class Y4MReader:
    """Streaming y4m reader with native prefetch."""

    def __init__(self, path: str, prefetch: int = 8):
        self._h = lib().y4m_open_read(path.encode(), prefetch)
        if not self._h:
            raise IOError(f"cannot open y4m stream {path!r}")
        info = (ctypes.c_int * 8)()
        lib().y4m_info(self._h, info)
        (self.width, self.height, self.fps_num, self.fps_den,
         self.sub_w, self.sub_h, self.bits, self.planes) = list(info)
        self._fbytes = lib().y4m_frame_bytes(self._h)
        self._dtype = np.uint8 if self.bits <= 8 else np.uint16

    def plane_shapes(self) -> List[Tuple[int, int]]:
        shapes = [(self.height, self.width)]
        for _ in range(self.planes - 1):
            shapes.append((self.height // self.sub_h,
                           self.width // self.sub_w))
        return shapes

    def read(self) -> Optional[List[np.ndarray]]:
        buf = np.empty(self._fbytes, np.uint8)
        ok = lib().y4m_read_frame(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if not ok:
            return None
        data = buf.view(self._dtype)
        planes = []
        off = 0
        for (h, w) in self.plane_shapes():
            planes.append(data[off:off + h * w].reshape(h, w).copy())
            off += h * w
        return planes

    def __iter__(self):
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def close(self):
        if self._h:
            lib().y4m_close_read(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Y4MWriter:
    def __init__(self, path: str, width: int, height: int,
                 fps: Tuple[int, int] = (25, 1), sub_w: int = 2,
                 sub_h: int = 2, bits: int = 8, planes: int = 3):
        self._h = lib().y4m_open_write(
            path.encode(), width, height, fps[0], fps[1], sub_w, sub_h,
            bits, planes)
        if not self._h:
            raise IOError(f"cannot open y4m output {path!r}")
        self._dtype = np.uint8 if bits <= 8 else np.uint16
        # frame_bytes of native/y4m.cc
        self._fbytes = (width * height + (planes - 1) * (width // sub_w)
                        * (height // sub_h)) * (2 if bits > 8 else 1)

    def write(self, planes) -> None:
        """Write one frame: numpy arrays or tensors (on any device), one
        per plane.  The frame is the first frame-size bytes of the planes
        laid end to end (as in the JAX package's writer); fewer raise."""
        data = np.concatenate(
            [np.ascontiguousarray(np.asarray(_host(p), self._dtype))
             .reshape(-1) for p in planes])
        raw = data.view(np.uint8)
        if raw.size < self._fbytes:
            raise ValueError(f"y4m write: {raw.size} bytes for a frame of "
                             f"{self._fbytes}")
        ok = lib().y4m_write_frame(
            self._h, raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if not ok:
            raise IOError("y4m write failed")

    def close(self):
        if self._h:
            lib().y4m_close_write(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _host(p):
    """A plane as a numpy array (a tensor is copied to the host)."""
    return p.cpu().numpy() if hasattr(p, "cpu") else p


def read_clip(path: str, max_frames: Optional[int] = None):
    """Read a whole clip: returns (list of per-plane [T,H,W] arrays,
    reader-info)."""
    with Y4MReader(path) as r:
        frames = []
        for i, f in enumerate(r):
            if max_frames is not None and i >= max_frames:
                break
            frames.append(f)
        if not frames:
            raise IOError("empty clip")
        planes = [np.stack([f[p] for f in frames])
                  for p in range(len(frames[0]))]
        return planes, r


def write_clip(path: str, planes, fps=(25, 1), bits=8, sub_w=2, sub_h=2):
    t = planes[0].shape[0]
    h, w = planes[0].shape[1:]
    with Y4MWriter(path, w, h, fps, sub_w if len(planes) > 1 else 1,
                   sub_h if len(planes) > 1 else 1, bits,
                   len(planes)) as wr:
        for i in range(t):
            wr.write([p[i] for p in planes])
