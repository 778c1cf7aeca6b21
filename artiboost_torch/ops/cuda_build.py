"""Build a hand-written CUDA source into a shared library with a plain C
interface (``nvcc`` straight to ``-shared``, bound with ``ctypes``).

Libraries land in ``build/kernels/`` at the repository root, are rebuilt
when the source is newer, and are built at first use, never at import."""
from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build_library(source: str) -> tuple:
    """csrc/<source> -> (path of lib<stem>.so, compiler log). Reuses a
    library that is newer than its source."""
    src = CSRC / source
    out = BUILD_DIR / f"lib{src.stem}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit {res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr
