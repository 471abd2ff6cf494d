"""Build the port's native libraries from the sources in ``csrc/``.

Four libraries, each with a plain C interface loaded through ``ctypes``:

- ``librans``: the host rANS coder, ``g++ -O3 -std=c++17 -shared -fPIC
  -pthread`` over ``csrc/rans.cpp``;
- ``libwindow_attention``: the window-attention kernel, ``nvcc`` for
  ``sm_90a`` over ``csrc/window_attention.cu``;
- ``libgdn``: the fused GDN forward and backward kernels, ``nvcc`` for
  ``sm_90a`` over ``csrc/gdn.cu``;
- ``librans_lanes``: the device wire's lane-parallel rANS encode and
  decode kernels, ``nvcc`` for ``sm_90a`` over ``csrc/rans_lanes.cu``.

Each builds at first use into ``_build/`` beside this file (listed in
``.gitignore``), under a name that carries a hash of its source and flags,
so an edited source is rebuilt and a stale library is never loaded. The
compiler writes to a temporary name that is renamed into place, so
processes that build at once (test workers) never load a half-written
file. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")

RANS_SRC = os.path.join(CSRC, "rans.cpp")
KERNEL_SRC = os.path.join(CSRC, "window_attention.cu")
GDN_SRC = os.path.join(CSRC, "gdn.cu")
RANS_LANES_SRC = os.path.join(CSRC, "rans_lanes.cu")

RANS_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_loaded: dict = {}
# compiler output of the builds made in this process (ptxas register and
# shared-memory report for the kernels), by library name
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels "
        "build only where the CUDA toolkit is installed"
    )


def _build(name: str, src: str, compiler: list, flags: list) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [*compiler, *flags, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed ({' '.join(cmd)}):\n{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_LOG[name] = proc.stdout + proc.stderr
    return out


def build_rans() -> str:
    """Compile ``csrc/rans.cpp`` with g++ (once per source); -> path."""
    return _build("librans", RANS_SRC, ["g++"], RANS_FLAGS)


def build_kernels() -> str:
    """Compile ``csrc/window_attention.cu`` with nvcc (once per source)."""
    return _build("libwindow_attention", KERNEL_SRC, [_nvcc()], NVCC_FLAGS)


def build_gdn() -> str:
    """Compile ``csrc/gdn.cu`` with nvcc (once per source)."""
    return _build("libgdn", GDN_SRC, [_nvcc()], NVCC_FLAGS)


def build_rans_lanes() -> str:
    """Compile ``csrc/rans_lanes.cu`` with nvcc (once per source)."""
    return _build("librans_lanes", RANS_LANES_SRC, [_nvcc()], NVCC_FLAGS)


BUILDERS = {"rans": build_rans, "kernels": build_kernels, "gdn": build_gdn,
            "rans_lanes": build_rans_lanes}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``"rans"``, ``"kernels"`` (window
    attention), ``"gdn"`` or ``"rans_lanes"``, once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = BUILDERS[name]()
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
        return lib
