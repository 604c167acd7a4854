"""Build, bind and call the kernel libraries of ``csrc/``.

Each kernel source builds into its own shared library with a plain C
interface (:func:`build_kernels`), loaded with ``ctypes`` (:func:`library`)
and declared from one table of every ``extern "C"`` export (``EXPORTS``);
:func:`call` launches one export on PyTorch's current stream.  The only
module of the port that knows how a library is built, loaded and called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

import torch

_CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
# one shared library per kernel source; every source includes the headers
KERNEL_SOURCES = ("fused_trace.cu", "fused_grad.cu", "wide_trace.cu", "wide_grad.cu",
                  "wide_fused_grad.cu")
_HEADERS = ("trace_common.cuh", "adjoint_common.cuh", "wide_common.cuh", "row_reduce.cuh")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def _nvcc() -> str:
    for candidate in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _build_one(name: str, digest: str):
    """Start nvcc on one source; returns ``(lib_path, process or None, tmp)``."""
    lib_path = _BUILD_DIR / f"libpyrayt_{Path(name).stem}_{digest}.so"
    if lib_path.exists():
        return lib_path, None, None
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(),
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v",
        "-o", tmp, str(_CSRC_DIR / name),
    ]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return lib_path, proc, tmp


@lru_cache(maxsize=None)
def build_kernels():
    """Compile every source of ``KERNEL_SOURCES`` for sm_90a into
    ``build/torch_kernels`` (once per version of the sources and the shared
    header), one nvcc process per source, all started together.  Returns
    ``{source stem: (library path, seconds, compiler log)}`` (a library
    built earlier: 0 seconds and "cached" before the log kept beside it);
    raises if a build fails."""
    header = b"".join((_CSRC_DIR / h).read_bytes() for h in _HEADERS)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    started = {}
    for name in KERNEL_SOURCES:
        digest = hashlib.sha256(header + (_CSRC_DIR / name).read_bytes()).hexdigest()[:16]
        started[name] = _build_one(name, digest)
    built = {}
    failures = []
    for name, (lib_path, proc, tmp) in started.items():
        log_path = lib_path.with_suffix(".log")
        if proc is None:
            log = log_path.read_text() if log_path.exists() else ""
            built[Path(name).stem] = (str(lib_path), 0.0, "cached\n" + log)
            continue
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {name} ({proc.returncode}):\n{log}")
            continue
        log_path.write_text(log)
        os.replace(tmp, lib_path)
        built[Path(name).stem] = (str(lib_path), seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


_P, _Q, _I, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
_ERROR_STRING = ((_I,), ctypes.c_char_p)  # cudaGetErrorString of a launch's code
_BLOCK_THREADS = ((), _I)
_REDUCE_SCRATCH = ((_Q, _I), _Q)  # (entries, rows) -> bytes, -1 past the reduce's limits
# PYRAYT_BWD_ARGS of csrc/fused_grad.cu
_BWD_ARGS = ((_P, _Q, _I) + (_P,) * 4 + (_I,) * 3 + (_P,) * 4 + (_I, _P, _I) + (_D,) * 3 + (_I,)
             + (_P,) * 6)

# Every extern "C" export of csrc/*.cu: library stem -> export -> (argtypes,
# restype).  An export named "<name>_f*" stands for its two builds,
# "<name>_f32" and "<name>_f64".  A pointer is c_void_p, long long c_longlong
# (a pointer or a 64-bit count passed as c_int would be cut).
EXPORTS = {
    "fused_trace": {
        # K1: state, n, generations; objtx, prim, glass, program; program_len, n_leaves,
        # n_glass; records, masks, fstate; ray_offset, world_index, threshold; apply, stream
        "pyrayt_fused_trace_f*": ((_P, _Q, _I) + (_P,) * 4 + (_I,) * 3 + (_P,) * 3 + (_D,) * 3
                                  + (_I, _P), _I),
        "pyrayt_error_string": _ERROR_STRING,
    },
    "fused_grad": {
        "pyrayt_fused_bwd_f*": (_BWD_ARGS, _I),  # K4
        "pyrayt_fused_bwd_loss_f*": (_BWD_ARGS, _I),  # K3
        "pyrayt_bwd_block_threads": _BLOCK_THREADS,
        "pyrayt_bwd_occupancy": ((_I,) * 5, _I),
        "pyrayt_bwd_error_string": _ERROR_STRING,
    },
    "wide_trace": {
        # K2: PYRAYT_WIDE_ARGS
        "pyrayt_fused_trace_wide_f*": ((_P, _Q, _I) + (_P,) * 4 + (_I,) * 3 + (_P,) * 7
                                       + (_D,) * 3 + (_I, _P), _I),
        "pyrayt_wide_error_string": _ERROR_STRING,
    },
    "wide_grad": {
        # K5: PYRAYT_TAIL_ARGS
        "pyrayt_staged_tail_f*": ((_P, _Q) + (_P,) * 6 + (_I, _I) + (_P, _I, _P, _I, _P)
                                  + (_D,) * 3 + (_I,) + (_P,) * 5, _I),
        # K6 and K7: PYRAYT_FOLD_ARGS
        "pyrayt_staged_fold_f*": ((_Q,) + (_P,) * 5 + (_I, _I, _P, _I) + (_P,) * 6
                                  + (_I, _P, _P), _I),
        "pyrayt_row_reduce_f*": ((_P, _P, _Q, _I) + (_P,) * 5, _I),
        "pyrayt_staged_reduce_scratch": _REDUCE_SCRATCH,
        "pyrayt_staged_block_threads": _BLOCK_THREADS,
        "pyrayt_staged_error_string": _ERROR_STRING,
    },
    "wide_fused_grad": {
        # K8: PYRAYT_FUSED_WIDE_ARGS
        "pyrayt_wide_fused_bwd_f*": ((_P, _Q, _I) + (_P,) * 4 + (_I,) * 3 + (_P,) * 6
                                     + (_I, _P, _I) + (_D,) * 3 + (_I,) + (_P,) * 5 + (_I,)
                                     + (_P,) * 5, _I),
        "pyrayt_wide_fused_reduce_scratch": _REDUCE_SCRATCH,
        "pyrayt_wide_fused_block_threads": _BLOCK_THREADS,
        "pyrayt_wide_fused_error_string": _ERROR_STRING,
    },
}


def _builds(entry: str):
    """The exports one entry of ``EXPORTS`` declares: both builds of a
    ``<name>_f*`` entry, else the entry's own name."""
    return (entry[:-1] + "32", entry[:-1] + "64") if entry.endswith("_f*") else (entry,)


@lru_cache(maxsize=None)
def library(stem: str):
    """The library of source ``stem`` (:func:`build_kernels`), loaded once,
    with every export of ``EXPORTS[stem]`` declared."""
    lib = ctypes.CDLL(build_kernels()[stem][0])
    for entry, (argtypes, restype) in EXPORTS[stem].items():
        for name in _builds(entry):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def call(stem: str, export: str, dtype, device, *args):
    """Launch ``<export>_f32`` (``dtype`` float32) or ``<export>_f64`` of
    library ``stem`` on ``device``'s current stream: a tensor argument passes
    its ``data_ptr()``, None a null pointer, and the stream comes last.  No
    synchronisation and no allocation.  Raises RuntimeError naming the
    export and the library's error string when the launch returns a code."""
    lib = library(stem)
    name = f"{export}_f{32 if dtype == torch.float32 else 64}"
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        error_string = next(e for e in EXPORTS[stem] if e.endswith("_error_string"))
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{getattr(lib, error_string)(err).decode()}")
