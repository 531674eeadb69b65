"""Device choice and the hand-written CUDA kernels' build, load and launch.

Every kernel of the port is CUDA C++ for ``sm_90a`` under ``csrc/``,
compiled at first use by ``nvcc`` into a shared library: a plain C launch
entry plus, from ``csrc/py_launch.cuh``, a one-function Python extension
module that calls it (the interpreter's C API only, no PyTorch headers).
The library lands in ``build/kernels/`` at the repository root, named by
a hash of its source, the shared headers and the flags, so a checkout
builds what it needs and a rebuilt source never loads a stale library.
Nothing here runs at import: the CPU tests import every module on a
machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU: ``None`` means ``cuda``, and asking for ``cuda`` without a
    card raises instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions")
    return dev


# cudaError_t values that report a fault of the context (a kernel that
# trapped or read out of bounds, an ECC error), which later calls see as
# well: a launch that returns one of these met a device fault; any other
# code is the launch itself at fault (its arguments, its configuration,
# a missing kernel image)
DEVICE_FAULT_CODES = frozenset((214, 700, 702, 710, 714, 715, 716, 717,
                                718, 719))


class KernelLaunchError(RuntimeError):
    """A kernel's C entry refused or failed to launch it. A fault of the
    program, not of the card: the serving path raises it to its caller
    and never serves around it."""


class DeviceFaultError(RuntimeError):
    """A launch met a fault of the CUDA context that an earlier
    asynchronous operation left behind."""


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _nvcc_flags() -> List[str]:
    return [*NVCC_FLAGS, "-I", sysconfig.get_paths()["include"]]


class CudaKernel:
    """One ``csrc/*.cu`` source with one C entry point.

    The entry takes device pointers, ints and the CUDA stream, launches on
    that stream and returns ``cudaGetLastError()``; :meth:`launch` raises
    when it is not 0: :class:`DeviceFaultError` for a code of
    ``DEVICE_FAULT_CODES``, else :class:`KernelLaunchError`. Python
    reaches it through the source's extension module, named after the
    source's stem. ``launches`` counts successful launches and nothing
    else, so a run can show that its main path went through the kernel.
    The host path of a launch is kept short, since at the serving path's
    widths it is all a launch costs: the bound function is resolved once,
    the stream handle is read raw, and pointers and ints pass straight to
    the extension's METH_FASTCALL entry.
    """

    def __init__(self, source: str, symbol: str) -> None:
        self.source = CSRC / source
        self.symbol = symbol
        self.launches = 0
        self._fn = None
        KERNELS[symbol] = self

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(_nvcc_flags()).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source unless its library exists;
        returns the process (the caller waits) or None."""
        lib = self.library
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_nvcc_flags(), "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        proc.tmp_path = tmp
        return proc

    @staticmethod
    def finish_build(proc: Optional[subprocess.Popen], lib: Path) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{out}")
        os.replace(proc.tmp_path, lib)

    def load(self):
        """Build (if needed) and import the extension module; returns its
        launch function, kept for every later launch."""
        if self._fn is not None:
            return self._fn
        lib = self.library
        self.finish_build(self.start_build(), lib)
        spec = importlib.util.spec_from_file_location(self.source.stem, lib)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        self._fn = getattr(module, self.symbol)
        return self._fn

    def launch(self, stream: int, *args) -> None:
        """Launch on ``stream`` (the raw handle :func:`stream_of` gives);
        no synchronization. Pointers (from :func:`ptr`) and ints pass as
        Python ints, in the C entry's order, the stream last."""
        rc = (self._fn or self.load())(*args, stream)
        if rc:
            err = (DeviceFaultError if rc in DEVICE_FAULT_CODES
                   else KernelLaunchError)
            raise err(f"{self.symbol}: CUDA error {rc} at launch")
        self.launches += 1


# every kernel the port defines, by C symbol (filled as modules import)
KERNELS: Dict[str, CudaKernel] = {}


def build_all(kernels: Iterable[CudaKernel] = ()) -> None:
    """Build the given kernels (default: all registered) with one ``nvcc``
    per source, all started together, then load them."""
    ks: List[CudaKernel] = list(kernels) or list(KERNELS.values())
    procs = [(k, k.start_build()) for k in ks]
    for k, proc in procs:
        CudaKernel.finish_build(proc, k.library)
    for k in ks:
        k.load()


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def upload(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """One batch's host arrays on ``device``, in one copy that does not
    block the host. On the card the arrays are staged back to back, each
    at a 16-byte offset, in one pinned buffer, copied ``non_blocking``,
    and returned as views of the one device buffer: a copy from pageable
    memory would wait for every kernel already queued on the stream, so
    the next batch's prepare could not run while the card still walks
    the one before it. PyTorch's pinned allocator keeps the staging
    buffer until the copy is done. On the CPU, copies."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    dev = torch.device(device)
    if dev.type != "cuda":
        return [torch.from_numpy(a.copy()) for a in arrays]
    offs, n = [], 0
    for a in arrays:
        offs.append(n)
        n += -(-a.nbytes // 16) * 16
    host = torch.empty(max(n, 16), dtype=torch.uint8, pin_memory=True)
    staged = host.numpy()
    for a, o in zip(arrays, offs):
        staged[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(dev, non_blocking=True)
    return [buf[o:o + a.nbytes]
            .view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
            .view(a.shape) for a, o in zip(arrays, offs)]


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s card, read
    without building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: Optional[Sequence[int]] = None) -> None:
    """Validate one kernel argument before its pointer reaches a kernel:
    a CUDA tensor of ``dtype`` (and ``shape``, where given), contiguous
    and 16-byte aligned. One pass of cheap tests; the message is built
    only when one fails."""
    if (t.is_cuda and t.dtype is dtype and t.is_contiguous()
            and not t.data_ptr() & 15
            and (shape is None or t.shape == tuple(shape))):
        return
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    raise ValueError(f"{name}: expected 16-byte alignment")
