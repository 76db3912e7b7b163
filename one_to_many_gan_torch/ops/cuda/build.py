"""Build the port's native sources and load them with ``ctypes``.

Each source has a plain C interface and becomes one shared library,
``build/kernels/lib<name>-<hash>.so`` at the repository root (the hash
covers the source and the flags, so an edited source is rebuilt): the
CUDA kernels ``csrc/<name>.cu`` with ``nvcc``, the host image loader
``csrc/loader.cpp`` with ``g++`` (``data/native.py``; it links libjpeg
and libpng, whose headers the host must have). Libraries are built at
first use, never at import, from the sources in the checkout only, into
a temporary file renamed into place, so that processes building at once
never load a partial library; a failed build raises with the compiler's
output.
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

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# -ffp-contract=off: no fused multiply-adds, on any host, so the loader's
# normalisation rounds each product and sum as numpy does.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-ffp-contract=off", "-shared")
CXX_LIBS = ("-ljpeg", "-lpng", "-lpthread")

# The CUDA sources of the training and serving paths (csrc/<name>.cu).
KERNELS = ("instance_norm", "warp")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        msg = "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built"
        raise RuntimeError(msg)
    return found


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        msg = "no C++ compiler found (g++, or set CXX); the native loader cannot be built"
        raise RuntimeError(msg)
    return found


def _source(name: str) -> Path:
    """``csrc/<name>.cpp`` if there is one, else ``csrc/<name>.cu``."""
    cpp = CSRC / f"{name}.cpp"
    return cpp if cpp.is_file() else CSRC / f"{name}.cu"


def _flags(source: Path) -> tuple[str, ...]:
    return CXX_FLAGS + CXX_LIBS if source.suffix == ".cpp" else NVCC_FLAGS


def library_path(name: str) -> Path:
    source = _source(name)
    digest = hashlib.sha256(source.read_bytes() + " ".join(_flags(source)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> dict:
    """Compile ``name``'s source unless it is built already.
    -> {"seconds": s, "log": the compiler's output} (0 and "" when it was
    built). Raises with the compiler's output when the build fails."""
    out = library_path(name)
    if out.is_file():
        return {"seconds": 0.0, "log": ""}
    source = _source(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if source.suffix == ".cpp":
        cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(source), *CXX_LIBS]
    else:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        msg = f"{Path(cmd[0]).name} failed for {source.name}:\n{proc.stdout}{proc.stderr}"
        raise RuntimeError(msg)
    os.replace(tmp, out)
    return {"seconds": time.perf_counter() - t0, "log": proc.stdout + proc.stderr}


def build_kernels() -> dict[str, dict]:
    """Build every CUDA source of ``KERNELS``, one ``nvcc`` each, all
    started together; -> ``build``'s result per name. Data-parallel
    launchers call it once before they start the ranks."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(build, KERNELS), strict=True))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``'s source, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
