"""Build native sources of the package into shared libraries at first use.

A library lands in `evo_tpu_torch/_build/` (listed in `.gitignore`) under a
name that carries a hash of its sources and of the command that compiles
them, so an edited source is never served by a stale library and no binary
lands beside the sources. `kernels.nvcc` (CUDA, `nvcc`) and `native` (the
C++ event parser, `g++`) both build through `shared_library`.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")


class CompileError(RuntimeError):
    """The compiler is missing, timed out or refused the sources."""


def shared_library(name: str, sources: list[str], command: list[str],
                   timeout: float = 600.0, headers: tuple[str, ...] = ()) -> tuple[str, str | None]:
    """Path of `lib<name>_<hash>.so`, compiled from `sources` (absolute
    paths) by `command + ["-o", out, *sources]` unless it already exists.
    `headers` (absolute paths) are what the sources include: hashed, not
    compiled. Returns (path, compiler stderr of a build made now, else None)."""
    digest = hashlib.sha256(" ".join(command).encode())
    for p in (*sources, *headers):
        with open(p, "rb") as f:
            digest.update(f.read())
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([*command, "-o", tmp, *sources],
                             capture_output=True, text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise CompileError(f"{command[0]} did not run for {name}: {e}") from e
    if res.returncode != 0:
        os.unlink(tmp)
        raise CompileError(f"{command[0]} failed for {name} ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
    return so, res.stderr
