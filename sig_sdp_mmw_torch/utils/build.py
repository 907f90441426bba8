"""Build-on-first-use for the port's native sources.

A source is compiled into a shared library under ``build/`` at the root of
the checkout (listed in ``.gitignore``), never next to the source.  The
library's file name carries a hash of the source and of the compiler
command, so an edited source or flag builds a new library and a stale one is
never loaded.  The compiler writes to a temporary file that is renamed into
place, so concurrent first uses (test workers) cannot load a half-written
library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import List, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUILD_DIR = os.path.join(REPO_ROOT, "build")
BUILD_TIMEOUT_S = 900


def build_shared_library(src: str, subdir: str, cmd: List[str],
                         key: str = "") -> Tuple[str, str]:
    """Compile ``src`` with ``cmd + ["-o", out, src]`` unless already built.

    ``key`` joins the source and command in the library's name (e.g. the
    host, for code built with ``-march=native``).  Returns ``(path,
    compiler_output)``; the output is empty when the library already
    existed.  Raises RuntimeError with the compiler's messages when the
    build fails.
    """
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + "\0".join([*cmd, key]).encode()).hexdigest()
    out_dir = os.path.join(BUILD_DIR, subdir)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(src))[0]
    path = os.path.join(out_dir, f"lib{stem}-{digest[:16]}.so")
    if os.path.exists(path):
        return path, ""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp, src], capture_output=True,
                              text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src} failed "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, proc.stdout + proc.stderr
