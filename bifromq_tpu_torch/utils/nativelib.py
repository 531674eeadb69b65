"""Build and load the port's native host helpers (copy of
``bifromq_tpu/utils/nativelib.py`` ``compile_and_load``).

The C++ sources under ``csrc/host/`` compile at first use with ``g++``
into ``build/host/`` at the repository root, beside the CUDA kernels'
``build/kernels/``. A library is named by a hash of its source, the
compiler and its flags, so a checkout builds what it needs and an edited
source never loads a stale library. A build lands under a name with the
process id and is published by an atomic rename, so a concurrent
process never loads a half-written library. Failure is cached as well as
success: after a build or load fails once, every later call raises
:class:`NativeLibError` without running the compiler again.

The reference's callers catch that error and carry on in Python or numpy;
the port's do not. A helper that cannot build raises out of the serving
call, as a kernel that refuses to launch does. Nothing here runs at
import, and nothing is ever written under ``native/`` or the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

CSRC_HOST = Path(__file__).resolve().parents[1] / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# (source, extra flags) -> the loaded library, or the message of the
# failure that every later call raises again
_cache: Dict[Tuple[str, Tuple[str, ...]], object] = {}
_lock = threading.Lock()

# calls of each helper's entry point, counted by its binding, so a run can
# show that its serving path went through the helper
CALLS: Counter = Counter()


class NativeLibError(RuntimeError):
    """A native host helper failed to build or to load. A fault of the
    program or its installation: the serving path raises it to its
    caller and never serves around it."""


def library_path(src: Path, extra_flags: Sequence[str] = ()) -> Path:
    """Where ``src`` built with ``extra_flags`` lands under ``BUILD_DIR``."""
    h = hashlib.sha256(Path(src).read_bytes())
    h.update(" ".join([CXX, *CXX_FLAGS, *extra_flags]).encode())
    return BUILD_DIR / f"lib{Path(src).stem}-{h.hexdigest()[:16]}.so"


def compile_and_load(src: Path, extra_flags: Sequence[str] = (),
                     configure: Optional[Callable[[ctypes.CDLL], None]]
                     = None) -> ctypes.CDLL:
    """Return the CDLL for ``src``, compiling it when its library is
    missing; ``configure(lib)`` sets the entry points' prototypes once,
    before any caller sees the library.

    Raises :class:`NativeLibError` on any failure; the failure is cached
    per source and flags, so later calls fail fast without re-running
    the toolchain.
    """
    key = (str(src), tuple(extra_flags))
    cached = _cache.get(key)
    if isinstance(cached, ctypes.CDLL):     # loaded: no lock to take
        return cached
    with _lock:
        cached = _cache.get(key)
        if isinstance(cached, ctypes.CDLL):
            return cached
        if cached is not None:
            raise NativeLibError(f"native lib unavailable: {cached}")
        try:
            so = library_path(src, extra_flags)
            if not so.exists():
                so.parent.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                out = subprocess.run(
                    [CXX, *CXX_FLAGS, *extra_flags, str(src), "-o",
                     str(tmp)], capture_output=True, text=True)
                if out.returncode != 0:
                    raise RuntimeError(f"{CXX} exited {out.returncode}: "
                                       f"{out.stderr.strip()}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            if configure is not None:
                configure(lib)
        except Exception as e:  # noqa: BLE001 — cache + normalize
            msg = f"{src}: {type(e).__name__}: {e}"
            _cache[key] = msg
            raise NativeLibError(
                f"native lib failed to build/load: {msg}") from e
        _cache[key] = lib
        return lib
