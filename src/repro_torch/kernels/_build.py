"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together) and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
build lands in ``build/kernels/<hash>/`` at the repository root, keyed
by a hash of the sources and flags, so a fresh build is reused and an
edited source rebuilds. Nothing is built at import time: the first
kernel launch builds.

Each C entry point launches its kernel(s) on the stream it is given and
returns ``cudaGetLastError()``; ``Kernel.__call__`` raises on a nonzero
code and counts the launch.

The lazy build and the merge-counter table are guarded by one lock: the
gateway runs the engine on its own thread, and a kernel may first launch
from any thread.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
_build_log: List[str] = []
_kernels: Dict[str, "Kernel"] = {}
_sms: Dict[int, int] = {}
_counters: Dict[tuple, torch.Tensor] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(pathlib.Path(on_path))
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels of repro_torch build on first use")


def _sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile every source in parallel and link the shared library;
    returns its path (reused when the hash matches). Each process builds
    in a private directory and renames the library into place, so
    concurrent first launches cannot interleave their outputs."""
    out_dir = BUILD / _digest()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    work = out_dir / f"work-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    objs, failed = [], []
    for src, obj, proc in procs:
        log, _ = proc.communicate()
        _build_log.append(f"== {src.name}\n{log}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
        objs.append(str(obj))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = work / lib.name
    link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                           "-shared", "-o", str(tmp), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v`` register/smem report) of the
    build made by this process, empty when a cached build was reused."""
    return "\n".join(_build_log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rt_error_string.restype = ctypes.c_char_p
            lib.rt_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


class Kernel:
    """One C entry point of the library plus its launch count.

    ``launches`` is bumped once per successful call — the wrappers call
    it exactly where they launch their kernel, and nowhere else, so a
    run can show that its main path went through the kernel. A call
    with a ``mode`` also bumps ``mode_launches[mode]``."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.mode_launches: Dict[str, int] = {}
        self._fn = None
        _kernels[symbol] = self

    def __call__(self, *args, mode: Optional[str] = None) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = library().rt_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1
        if mode is not None:
            self.mode_launches[mode] = self.mode_launches.get(mode, 0) + 1


def kernels() -> Dict[str, Kernel]:
    """Every kernel entry point declared so far, by C symbol."""
    return dict(_kernels)


def reset_launches() -> None:
    for k in _kernels.values():
        k.launches = 0
        k.mode_launches = {}


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the kernels size their
    grids by it)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def merge_counters(symbol: str, t: torch.Tensor, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for the in-kernel merge of the
    kernel ``symbol`` (``last_block`` in ``csrc/common.cuh``) on ``t``'s
    device and current stream. Allocated once per (kernel, device,
    stream), and again when a launch needs more: every launch leaves the
    counters it used at 0, so the launches that follow one another on the
    stream share them."""
    key = (symbol, t.device.index, stream_ptr(t))
    with _lock:
        buf = _counters.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 1024), dtype=torch.int32,
                              device=t.device)
            _counters[key] = buf
    return buf
