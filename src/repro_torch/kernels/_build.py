"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, which :func:`load` opens with ``ctypes``.  The library is built at
first use, from this package's sources only, into
``<repo>/build/repro_torch_kernels/<hash>/``, where ``<hash>`` covers the
sources and the compiler flags: an edited kernel gets a new directory and a
stale library is never loaded.  Nothing is built or imported from CUDA when
this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every entry returns the launch's cudaError_t as an int
SIGNATURES = {
    "crossbar_mxv_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    "crossbar_mxv_bf16": (_P, _P, _P, _P, _I, _I, _I, _P),
    "crossbar_mxv_int8": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "build only where the CUDA toolkit is installed")
    return found


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives (built or not)."""
    return BUILD_ROOT / source_hash() / "librepro_torch_kernels.so"


def build() -> pathlib.Path:
    """Compile the sources unless the library for them exists already."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built at first use, with every entry's types set
    (without ``argtypes`` ctypes would cut pointers to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_torch_error_string.argtypes = [ctypes.c_int]
    lib.repro_torch_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = lib.repro_torch_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({msg})")
