"""Build native sources of the package into shared libraries.

Every library lands in ``build/ahocorasick_tpu_torch/`` beside the package
(git-ignored), named ``<stem>-<hash>.so`` where the hash covers the source
and the compiler command, so an edited source or flag set builds anew and
a stale library is never loaded. Builds happen at first use, never at
import. The compiler's output is kept next to the library as
``<stem>-<hash>.log`` (``nvcc -Xptxas -v`` register and spill reports).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import List

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "ahocorasick_tpu_torch",
)
_TIMEOUT_S = 600  # nvcc takes about 20 s for csrc/bitap.cu on an H100 host


def _stem_path(src: str, stem: str, cmd: List[str]) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update("\0".join(cmd).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}")


def build_shared(src: str, stem: str, cmd: List[str]) -> str:
    """Compile ``src`` with ``cmd + [src, "-o", out]``; returns the path of
    the shared library. Concurrent builders (test workers) each write a
    private temporary file and rename it into place atomically.

    Raises ``subprocess.CalledProcessError`` (with the compiler's output)
    when the build fails and ``OSError`` when the compiler is missing."""
    base = _stem_path(src, stem, cmd)
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
