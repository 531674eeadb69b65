"""Device choice and the hand-written CUDA kernels' build, load and launch.

Every kernel of the port is CUDA C++ for ``sm_90a`` under ``csrc/``,
compiled at first use by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``. The library lands in
``build/kernels/`` at the repository root, named by a hash of its source
and flags, so a checkout builds what it needs and a rebuilt source never
loads a stale library. Nothing here runs at import: the CPU tests import
every module on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

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


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


class CudaKernel:
    """One ``csrc/*.cu`` source with one C entry point.

    The entry takes device pointers, ints and the CUDA stream, launches on
    that stream and returns ``cudaGetLastError()``; :meth:`launch` raises
    when it is not 0. ``launches`` counts successful launches and nothing
    else, so a run can show that its main path went through the kernel.
    """

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence) -> None:
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS[symbol] = self

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
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
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
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

    def load(self) -> None:
        if self._fn is not None:
            return
        lib = self.library
        self.finish_build(self.start_build(), lib)
        fn = getattr(ctypes.CDLL(str(lib)), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def launch(self, *args) -> None:
        """Launch on the current stream; no synchronization."""
        self.load()
        stream = torch.cuda.current_stream().cuda_stream
        rc = self._fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} at launch")
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


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: Optional[Sequence[int]] = None) -> None:
    """Validate one kernel argument before its pointer crosses ctypes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte alignment")
