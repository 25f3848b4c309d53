"""Build and load the port's CUDA kernels; count their launches.

The sources under ``csrc/`` have a plain C interface.  At first use each is
compiled by its own ``nvcc`` process (all started together) for ``sm_90a``,
the objects are linked into one shared library under ``build/`` beside this
file, and the library is loaded with ``ctypes``.  The library's name carries
a hash of the sources, their shared headers (``*.cuh``) and the flags, so
an edited source or header is rebuilt and an unchanged one is loaded as it
is.  Nothing is built at import time.

``LAUNCHES`` counts launches per kernel: each wrapper adds one where it
launches its kernel and nowhere else (the CPU path runs the plain versions
and counts nothing).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = ["LAUNCHES", "reset_launches", "library", "build", "launch",
           "launch_uncounted", "query", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: C signature of every exported function (argtypes; restype is int, the
#: cudaError_t of the call): the launchers and their size queries.
SIGNATURES = {
    "repro_ec_matmul_workspace": [_P, _P, _I, _LL, _I, _I, _I, _I,
                                  ctypes.POINTER(_LL)],
    "repro_ec_matmul": [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _I, _I, _I, _I,
                        _I, _I, _P],
    "repro_ec_rmatmul_workspace": [_P, _P, _I, _LL, _I, _I, _I, _I,
                                   ctypes.POINTER(_LL)],
    "repro_ec_rmatmul": [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _I, _I, _I,
                         _I, _I, _I, _I, _P],
    "repro_encode_matmul_scales": [_I, _I, _I, _I, ctypes.POINTER(_LL)],
    "repro_encode_matmul_workspace": [_I, _I, ctypes.POINTER(_LL)],
    "repro_encode_matmul": [_P, _P, _P, _P, _P, _LL, _P, _LL, _I, _I, _I, _I,
                            _I, _F, _I, ctypes.c_ulonglong, _I, _P],
    "repro_stencil_denoise": [_P, _P, _LL, _I, _F, _F, _P],
    "repro_thomas_solve": [_P, _P, _P, _P, _I, _I, _F, _I, _F, _F, _P,
                           _P],
    "repro_cg_update": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _P],
    "repro_richardson_update": [_P, _P, _P, _P, _P, _P, _LL, _I, _P],
    "repro_launch_floor": [_P, _P],
}

#: One count per kernel.  A count is one call of the C launcher, which may
#: run more than one CUDA kernel: ``ec_matmul``'s product plus, when K is
#: more than one piece, the pass that adds the pieces; ``ec_rmatmul``'s
#: product plus the pass that sums its blocks' partials; ``encode_matmul``'s
#: pre-passes plus its product.  The grouped EC kernels are the solo ones
#: with a member axis in their units, counted under their own names.
LAUNCHES: Dict[str, int] = {"ec_matmul": 0, "ec_rmatmul": 0,
                            "ec_group_matmul": 0, "ec_group_rmatmul": 0,
                            "encode_matmul": 0, "encode_matmul_rng": 0,
                            "stencil_denoise": 0, "thomas_solve": 0,
                            "cg_update": 0, "richardson_update": 0}

_lib: Optional[ctypes.CDLL] = None
#: ``ptxas -v`` report of the library this process loaded (kept beside it,
#: ``.log``, for a later process) and wall seconds of a build it ran.
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
    """A hash of the flags and of every source and header under ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
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
        log = "\n".join(logs)
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {target.name} failed:\n{link.stdout}")
        target.with_suffix(".log").write_text(log)
        os.replace(tmp_lib, target)
    build_seconds = time.perf_counter() - t0
    build_log = log
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source tree's build is
    not there yet."""
    global _lib, build_log
    if _lib is None:
        path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
        if not path.exists():
            path = build()
        elif path.with_suffix(".log").exists():
            build_log = path.with_suffix(".log").read_text()
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
    launch_uncounted(f"{kernel} launch", symbol, device, *args)
    LAUNCHES[kernel] += 1


def launch_uncounted(what: str, symbol: str, device, *args) -> None:
    """``launch`` without a count: for a measurement probe, which ports no
    kernel and has no entry in ``LAUNCHES``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    _call(what, symbol, device, *args, stream)


def query(symbol: str, device, *args) -> None:
    """Call the C function ``symbol`` with ``device`` current; it launches
    nothing and counts nothing.  Raises if it returns a CUDA error."""
    _call(symbol, symbol, device, *args)


def _kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel symbol: the identifier without
    its namespaces, and its literal template arguments
    (``_ZN49_GLOBAL__N__9ff8f882_16_encode_matmul_cu_b9ee5ddf20encode_matmul_
    kernelILb1EEEv...`` -> ``encode_matmul_kernel<true>``)."""
    if not mangled.startswith("_Z"):
        return mangled
    rest, name = mangled[2:], mangled
    nested = rest.startswith("N")
    rest = rest[nested:]
    while (m := re.match(r"\d+", rest)):
        end = m.end() + int(m.group())
        name, rest = rest[m.end():end], rest[end:]
        if not nested:
            break
    args = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
    if args is None:
        return name
    vals = [{"b0": "false", "b1": "true"}.get(t + v, v) for t, v in
            re.findall(r"L([a-z])(\d+)E", args.group(1))]
    return f"{name}<{', '.join(vals)}>"


def ptxas_report(log: Optional[str] = None) -> Dict[str, Dict[str, object]]:
    """Per kernel of a build log (default: this process's build), what
    ``ptxas -v`` said: source file, registers, stack frame, spill stores and
    loads, static shared memory (bytes)."""
    rows: Dict[str, Dict[str, object]] = {}
    source, props, current = "", None, None

    def row(mangled):
        return rows.setdefault(_kernel_name(mangled), {
            "source": source, "registers": 0, "stack": 0, "spill_stores": 0,
            "spill_loads": 0, "smem": 0})

    for line in (build_log if log is None else log).splitlines():
        line = line.strip()
        if line.startswith("== "):
            source = line[3:]
        elif (m := re.search(r"Compiling entry function '(\w+)'", line)):
            current = row(m.group(1))
        elif (m := re.search(r"Function properties for (\w+)", line)):
            # Device functions (a division's slow path ...) are listed too.
            props = m.group(1)
        elif (m := re.match(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line)):
            if props is not None and props.startswith("_Z") \
                    and "kernel" in props:
                row(props).update(stack=int(m.group(1)),
                                  spill_stores=int(m.group(2)),
                                  spill_loads=int(m.group(3)))
            props = None
        elif current is not None and \
                (m := re.search(r"Used (\d+) registers", line)):
            current["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["smem"] = int(smem.group(1)) if smem else 0
            current = None
    return rows
