"""Builds the CUDA kernels of `tpu_audio_torch/csrc/` and binds them with ctypes.

Every `csrc/*.cu` is compiled for Hopper (`sm_90a`) by its own `nvcc`
process, all started together, and the objects are linked into one shared
library with a plain C interface, under `build/tpu_audio_torch/` at the
root of the checkout. The file name
carries a hash of the sources and flags, so a changed source builds anew
and an unchanged one is loaded as it is. Nothing is built when a module is
imported: the first kernel launch builds.

Each C entry point takes device pointers, sizes and the stream, launches on
that stream, and returns `cudaGetLastError()`; `Kernel.__call__` raises if
it is not 0. The library is built from the sources in the repository only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "tpu_audio_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtpu_audio_torch_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    nvcc's output (with `-Xptxas -v`: registers, shared memory, spills
    per kernel) goes to a `.log` beside the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    link = [_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(cmd, log) for cmd, log, proc in zip(cmds, logs, procs) if proc.returncode]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode:
            failed.append((link, logs[-1]))
    out.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        cmd, log = failed[0]
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{log[-8000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tpa_error_string.argtypes = [ctypes.c_int]
            lib.tpa_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


class Kernel:
    """One C entry point of the library. `argtypes` lists the arguments
    before the stream, which is always last: `ctypes.c_void_p` for each
    tensor (passed as the tensor itself), `ctypes.c_int`/`c_float` for
    scalars."""

    def __init__(self, name: str, *argtypes):
        self.name = name
        self.argtypes = argtypes
        self._fn = None

    def _bind(self):
        fn = getattr(library(), self.name)
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def __call__(self, device: torch.device, *args) -> None:
        if len(args) != len(self.argtypes):
            raise TypeError(f"{self.name} takes {len(self.argtypes)} arguments,"
                            f" got {len(args)}")
        fn = self._fn or self._bind()
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*conv, stream)
        if rc != 0:
            msg = library().tpa_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The wrappers' device rule: a kernel takes CUDA tensors on one device;
    anything else raises. So does a tensor that requires a gradient while
    grad mode is on: a kernel's output has no `grad_fn`, so autograd would
    stop at it without a word. Gradients take the training route
    (`models/whisper/model.encode_xla`, `training.loss_fn`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward, and an input requires a "
                           "gradient; train through the training route (encode_xla, "
                           "training.loss_fn), or call it under torch.no_grad()")
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {[str(x.device) for x in tensors]}")
    return device


def check(name: str, t: torch.Tensor, dtype: torch.dtype,
          shape: tuple) -> None:
    """Raise unless `t` has this dtype and shape and is contiguous."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
