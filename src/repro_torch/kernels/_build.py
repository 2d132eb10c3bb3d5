"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` (one process per source, all started
together) and links the objects into one shared library with a plain C
interface, which :func:`load` opens with ``ctypes``.  The library is built at
first use, from this package's sources only, into
``<repo>/build/repro_torch_kernels/<hash>/``, where ``<hash>`` covers the
sources, the headers (``csrc/*.cuh``) and the compiler flags: an edited
kernel gets a new directory and a stale library is never loaded.  ptxas's
report of each kernel's registers and spills is kept beside the library
(:func:`resource_usage`), and :func:`sass_counts` reads the library's
tensor-core instructions.  Nothing is built or imported from CUDA when this
module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PTXAS_LOG = "ptxas.log"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)      # an array of element strides
_PLAN = ctypes.POINTER(ctypes.c_int)        # a launch plan's fields
# q, k, v, out, lse; B, Hq, Hkv, Sq, Sk, D, causal; scale
_ATTN = (_P,) * 5 + (_I,) * 7 + (_F, _S, _P)
# q, k, v, o, dO, lse, delta, dq, dk, dv; as _ATTN
_ATTN_BWD = (_P,) * 10 + (_I,) * 7 + (_F, _S, _P)
# q, k, v, out, length, workspace; B, Hq, Hkv, S, D; scale
_DECODE = (_P,) * 6 + (_I,) * 5 + (_F, _S, _P)
# q, k8, k scale, v8, v scale, out, length, workspace; as _DECODE
_DECODE_INT8 = (_P,) * 8 + (_I,) * 5 + (_F, _S, _P)
# u, dt, a, B, C, D, y, hT; B, L, Din, N; S, G, tile, vec (the plan)
_SCAN = (_P,) * 8 + (_I,) * 8 + (_S, _P)
# u, dt, a, B, C, D, dy; du, ddt, dA, dB, dC, dD; bounds, acc, pbc, pa, pd
# (the workspaces); B, L, Din, N
_SCAN_BWD = (_P,) * 18 + (_I,) * 4 + (_S, _P)
_CONV = (_P, _P, _P, _P) + (_I,) * 12 + (_P,)
# entries (n rows of g, p, m, v, numel, flags), n, workspace, stats, hyper;
# b1, 1 - b1, b2, 1 - b2, eps, weight decay, clip
_ADAMW = (_P, _I, _P, _P, _P) + (_F,) * 7 + (_P,)
# name -> argtypes; every entry returns the launch's cudaError_t as an int
SIGNATURES = {
    "crossbar_mxv_f32": (_P, _P, _P, _P, _I, _I, _I, _PLAN, _P),
    "crossbar_mxv_bf16": (_P, _P, _P, _P, _I, _I, _I, _PLAN, _P),
    "crossbar_mxv_int8": (_P, _P, _P, _P, _P, _I, _I, _I, _PLAN, _P),
    "crossbar_conv2d_i8": _CONV,
    "crossbar_conv2d_f32": _CONV,
    "flash_attention_f32": _ATTN,
    "flash_attention_bf16": _ATTN,
    "flash_attention_bwd_f32": _ATTN_BWD,
    "flash_attention_bwd_bf16": _ATTN_BWD,
    "flash_decode_f32": _DECODE,
    "flash_decode_bf16": _DECODE,
    "flash_decode_int8_f32": _DECODE_INT8,
    "flash_decode_int8_bf16": _DECODE_INT8,
    "selective_scan_f32": _SCAN,
    "selective_scan_bf16": _SCAN,
    "selective_scan_bwd_f32": _SCAN_BWD,
    "selective_scan_bwd_bf16": _SCAN_BWD,
    # bf16 or not; out: blocks an SM, warps an SM, shared bytes a block
    "selective_scan_bwd_occupancy": (_I, _PLAN),
    "adamw_step": _ADAMW,
    # n tensors -> workspace bytes (not an error code)
    "adamw_workspace_bytes": (_I,),
}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def cuda_tool(name: str) -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / name
    if cand.is_file():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (looked in $CUDA_HOME/bin, "
                           f"/usr/local/cuda/bin and PATH): the CUDA kernels "
                           f"build only where the CUDA toolkit is installed")
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
    nvcc = cuda_tool("nvcc")
    # compile to temporary names, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed, reports = [], []
        for cmd, proc in procs:
            _, err = proc.communicate()
            reports.append(err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        pathlib.Path(tmp, PTXAS_LOG).write_text("".join(reports))
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(os.path.join(tmp, PTXAS_LOG), out.parent / PTXAS_LOG)
        os.replace(lib, out)
    return out


def resource_usage() -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} of every kernel in the built library, from ptxas's report."""
    text = (library_path().parent / PTXAS_LOG).read_text()
    out, name, spills = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)), *spills)
            name = None
    return out


def sass_counts(opcodes) -> dict:
    """{mangled kernel name: {opcode: number of its instructions}} in the
    built library's SASS (``cuobjdump -sass``), for each of ``opcodes``."""
    res = subprocess.run([cuda_tool("cuobjdump"), "-sass",
                          str(library_path())], capture_output=True,
                         text=True, check=True, timeout=300)
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = dict.fromkeys(opcodes, 0)
        elif fn is not None:
            ops = re.findall(r"\b[A-Z0-9]+(?=[. ])", line)
            for op in opcodes:
                counts[fn][op] += op in ops
    return counts


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
