"""Build and load the port's CUDA kernels; count their launches.

The sources under ``csrc/`` have a plain C interface.  At first use each is
compiled by its own ``nvcc`` process (all started together) for ``sm_90a``,
the objects are linked into one shared library under ``build/`` beside this
file, and the library is loaded with ``ctypes``.  The library's name carries
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing is built at import time.

``LAUNCHES`` counts launches per kernel: each wrapper adds one where it
launches its kernel and nowhere else (the CPU path runs the plain versions
and counts nothing).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = ["LAUNCHES", "reset_launches", "library", "build", "launch",
           "query"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: C signature of every exported function (argtypes; restype is int, the
#: cudaError_t of the call): the launchers and one size query.
SIGNATURES = {
    "repro_ec_matmul": [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _I,
                        _P],
    "repro_ec_rmatmul_workspace": [_I, _I, _I, _I, ctypes.POINTER(_LL)],
    "repro_ec_rmatmul": [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _I, _I, _I,
                         _I, _I, _I, _I, _P],
    "repro_encode_matmul_scales": [_I, _I, _I, _I, ctypes.POINTER(_LL)],
    "repro_encode_matmul": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _F,
                            _I, ctypes.c_ulonglong, _I, _P],
    "repro_stencil_denoise": [_P, _P, _LL, _I, _F, _F, _P],
    "repro_thomas_solve": [_P, _P, _P, _P, _I, _I, _F, _P],
    "repro_cg_update": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _P],
    "repro_richardson_update": [_P, _P, _P, _P, _P, _P, _LL, _I, _P],
}

#: One count per kernel.  A count is one call of the C launcher, which may
#: run more than one CUDA kernel: ``ec_rmatmul``'s slab pass plus, with
#: several slabs, the pass that sums them; ``encode_matmul``'s scale pre-pass
#: plus its product.  The grouped EC kernels are the solo ones with a member
#: axis in the grid, counted under their own names.
LAUNCHES: Dict[str, int] = {"ec_matmul": 0, "ec_rmatmul": 0,
                            "ec_group_matmul": 0, "ec_group_rmatmul": 0,
                            "encode_matmul": 0, "encode_matmul_rng": 0,
                            "stencil_denoise": 0, "thomas_solve": 0,
                            "cg_update": 0, "richardson_update": 0}

_lib: Optional[ctypes.CDLL] = None
#: ``ptxas -v`` report and wall seconds of the build this process loaded.
build_log = ""
build_seconds = 0.0


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the shared library; returns
    its path.  Raises with the compiler's output if any step fails.

    One ``nvcc`` per source, all started together, keeps the build at the
    time of the slowest source as kernels are added (a single ``nvcc`` over
    several sources compiles them one after another)."""
    global build_log, build_seconds
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {target.name} failed:\n{link.stdout}")
        os.replace(tmp_lib, target)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source tree's build is
    not there yet."""
    global _lib
    if _lib is None:
        path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
        if not path.exists():
            path = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _call(what: str, symbol: str, device, *args) -> None:
    lib = library()
    with torch.cuda.device(device):
        rc = getattr(lib, symbol)(*args)
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.repro_error_string(rc).decode()})")


def launch(kernel: str, symbol: str, device, *args) -> None:
    """Call the C launcher ``symbol`` on ``device``'s current stream (passed as
    its last argument), count one launch of ``kernel`` and raise if the launch
    failed (``cudaGetLastError`` after the launch)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _call(f"{kernel} launch", symbol, device, *args, stream)
    LAUNCHES[kernel] += 1


def query(symbol: str, device, *args) -> None:
    """Call the C function ``symbol`` with ``device`` current; it launches
    nothing and counts nothing.  Raises if it returns a CUDA error."""
    _call(symbol, symbol, device, *args)
