"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``; nothing is
compiled when a module is imported.  The first call to :func:`library`
builds into ``chargeflux_tpu_torch/_build/`` (a file name keyed by the
hash of the sources and flags, so an edited source rebuilds) and records
the compiler's output, ``-Xptxas -v`` register and shared-memory counts
included, in ``_build/build.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("pme_spread.cu", "direct_walk.cu", "structure_factor.cu",
           "cell_bin.cu", "stage_stamp.cu", "bspline_patch.cu",
           "exclusion_pairs.cu", "bonded_terms.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def _nvcc() -> str:
    # PyTorch's own lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, the
    # toolkit's default install prefix
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def build() -> Path:
    """Compile the kernels if the library for the current sources is not
    built yet; returns its path.  One ``nvcc`` per source, all started
    together, then one link."""
    srcs = [CSRC_DIR / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libcftorch_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{s.stem}.o") for s in srcs]
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    failed = [c[-1] for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        cmds.append([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                     *map(str, objs)])
        res = subprocess.run(cmds[-1], capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append("link")
    (BUILD_DIR / "build.log").write_text("".join(
        " ".join(c) + "\n" + log for c, log in zip(cmds, logs)))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           + "".join(logs))
    os.replace(tmp, out)
    return out


PTR, INT, FLOAT, INT64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_longlong)
INT_OUT = ctypes.POINTER(INT)
_declared = {}


def declare(restype=INT, **argtypes):
    """C signatures ``name=[argument types]`` returning ``restype`` (a CUDA
    error code), declared by the module that launches them; applied when
    :func:`library` loads, or at once if it is loaded."""
    _declared.update({k: (list(v), restype) for k, v in argtypes.items()})
    if _lib is not None:
        _apply(_lib)


def _apply(lib):
    for name, (args, res) in _declared.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _apply(lib)
        _lib = lib
    return _lib


@lru_cache(maxsize=None)
def limits(name: str, count: int = 2) -> tuple:
    """Compile-time bounds a kernel family was built with (``count``
    values)."""
    vals = [ctypes.c_int() for _ in range(count)]
    getattr(library(), name)(*map(ctypes.byref, vals))
    return tuple(v.value for v in vals)


def check(err: int, what: str):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
