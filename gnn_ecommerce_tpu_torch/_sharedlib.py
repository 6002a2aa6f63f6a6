"""Build a shared library from one source file at first use.

The library lands in ``_build/`` beside this module (gitignored), named by a
hash of the source and of the compile command, so an edited source or flag
rebuilds and an unchanged one is reused.
"""
from __future__ import annotations

import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def build_shared_library(src: str, stem: str, command: list[str]) -> tuple[str, str]:
    """Compile ``src`` with ``command + [src, "-o", out]`` unless already
    built. Returns (library path, the compiler's output; empty when reused).
    Raises ``subprocess.CalledProcessError`` (with the output) on failure."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(command).encode()).hexdigest()
    path = os.path.join(BUILD_DIR, f"lib{stem}-{digest[:16]}.so")
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    done = subprocess.run(
        command + [src, "-o", tmp], check=True, capture_output=True, text=True
    )
    os.replace(tmp, path)
    return path, done.stdout + done.stderr
