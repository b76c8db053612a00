"""Build the package's CUDA sources with nvcc at first use and load them.

Each ``csrc/<stem>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``) into ``csrc/build/lib<stem>-<hash>.so``, the hash being
that of the source, then loaded with :mod:`ctypes`. A missing ``nvcc`` or a
failed build raises; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: stem -> {"seconds": build wall time (0.0 if reused), "log": nvcc stderr}
build_info: Dict[str, Dict] = {}


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def load_library(stem: str) -> ctypes.CDLL:
    """Compile ``csrc/<stem>.cu`` unless a build of this exact source exists,
    then load it. Thread-safe; the library is loaded once per process."""
    with _lock:
        if stem in _libs:
            return _libs[stem]
        src = CSRC / f"{stem}.cu"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"lib{stem}-{digest}.so"
        if so.exists():
            build_info[stem] = {"seconds": 0.0, "log": "reused " + so.name}
        else:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed for {src.name} (rc={proc.returncode}):\n"
                    f"{proc.stderr}{proc.stdout}")
            os.replace(tmp, so)
            build_info[stem] = {"seconds": seconds, "log": proc.stderr}
        lib = ctypes.CDLL(str(so))
        _libs[stem] = lib
        return lib


__all__ = ["load_library", "find_nvcc", "build_info", "BUILD_DIR"]
