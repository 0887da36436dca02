"""Build native sources of the package into shared libraries.

Every library lands in ``build/ahocorasick_tpu_torch/`` beside the package
(git-ignored), named ``<stem>-<hash>.so`` where the hash covers the source,
the headers it includes and the compiler command, so an edited source or
flag set builds anew and a stale library is never loaded. Builds happen at
first use, never at import. The compiler's output is kept next to the
library as ``<stem>-<hash>.log`` (``nvcc -Xptxas -v`` register and spill
reports).

`CudaLibrary` is the one route by which the CUDA kernels under ``csrc/``
reach Python: ``nvcc`` into a shared library with a plain C interface,
loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "ahocorasick_tpu_torch",
)
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_TIMEOUT_S = 600  # nvcc takes about 20 s for csrc/bitap.cu on an H100 host

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _stem_path(src: str, stem: str, cmd: List[str],
               deps: Sequence[str] = ()) -> str:
    h = hashlib.sha256()
    for path in (src, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join(cmd).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}")


def build_shared(src: str, stem: str, cmd: List[str],
                 deps: Sequence[str] = ()) -> str:
    """Compile ``src`` with ``cmd + [src, "-o", out]``; returns the path of
    the shared library. ``deps`` are headers the source includes (hashed
    with it). Concurrent builders (test workers) each write a private
    temporary file and rename it into place atomically.

    Raises ``subprocess.CalledProcessError`` (with the compiler's output)
    when the build fails and ``OSError`` when the compiler is missing."""
    base = _stem_path(src, stem, cmd, deps)
    so = base + ".so"
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    proc = subprocess.run(
        cmd + [src, "-o", tmp], capture_output=True, text=True,
        timeout=_TIMEOUT_S,
    )
    with open(f"{base}.log.tmp{os.getpid()}", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(f"{base}.log.tmp{os.getpid()}", base + ".log")
    if proc.returncode != 0:
        raise subprocess.CalledProcessError(
            proc.returncode, cmd, proc.stdout, proc.stderr
        )
    os.replace(tmp, so)
    return so


def build_log(so: str) -> str:
    """The compiler output saved beside a library built by `build_shared`."""
    path = so[: -len(".so")] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def nvcc() -> str:
    """Path of the CUDA compiler (CUDA_HOME, CUDA_PATH, /usr/local/cuda,
    then PATH)."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


# ctypes argument codes of the kernels' C entry points: pointers and the
# stream are c_void_p (a plain int would be cut to 32 bits), sizes c_int,
# byte positions c_longlong.
P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong


class CudaLibrary:
    """One ``csrc/`` source, built by nvcc for sm_90a at first use and
    loaded with ctypes. ``signatures`` maps each C entry point to its
    argument types; every entry point returns a CUDA error code (int)."""

    def __init__(self, source: str, signatures: Dict[str, Tuple],
                 headers: Sequence[str] = ("shift_and.cuh",)):
        self.src = os.path.join(CSRC, source)
        self.stem = os.path.splitext(source)[0]
        self.deps = [os.path.join(CSRC, h) for h in headers]
        self.signatures = signatures
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.path: Optional[str] = None

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                so = build_shared(self.src, self.stem,
                                  [nvcc()] + NVCC_FLAGS + ["-I", CSRC],
                                  self.deps)
                lib = ctypes.CDLL(so)
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.restype = I
                    fn.argtypes = list(argtypes)
                self._lib, self.path = lib, so
            return self._lib

    def report(self) -> str:
        """The compiler's output for the loaded library (ptxas -v lines)."""
        self.load()
        return build_log(self.path)
