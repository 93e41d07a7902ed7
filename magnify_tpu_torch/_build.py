"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them at once, and the objects are linked into ONE shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds rather than minutes). The library is built on first
use into ``.cache/magnify_tpu_torch/kernels/<hash>/`` beside the package,
keyed by a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one loads straight from the cache.

Only the CUDA wrappers call :func:`load`; nothing here runs at import, so
the CPU tests import every module without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

__all__ = ["build", "load", "last_build"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
CACHE = CSRC.parent.parent / ".cache" / "magnify_tpu_torch" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# What the last build did: {"seconds", "cached", "path", "log"}.
last_build: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each exported function: (argtypes, restype).
_SIGNATURES = {
    "mg_hysteresis": ([_P, _P, _I, _I, _I, _I, _P, _P, _P], _I),
    "mg_ring_corr": ([_P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P], _I),
    "mg_ring_corr_smem": ([_I, _I], _I),
    "mg_perimeter_score": ([_P, _P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I,
                            _I, _I, _P, _P], _I),
    "mg_normalize_u8": ([_P, _I, _I, _I, _P, _P, _P], _I),
    "mg_bead_ownership": ([_P, _P, _P, _P, _I, _I, _I, _P, _P], _I),
    "mg_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {home}/bin or on PATH; the CUDA kernels "
            "of magnify_tpu_torch need the CUDA toolkit to build"
        )
    return found


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` (if not cached) and return the library path."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = CACHE / digest.hexdigest()[:16]
    lib = out_dir / "libmagnify_kernels.so"
    t0 = time.perf_counter()
    if lib.exists():
        last_build.update(seconds=time.perf_counter() - t0, cached=True,
                          path=str(lib), log="")
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    tmp = out_dir / f"libmagnify_kernels.{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    for obj in objs:
        obj.unlink()
    last_build.update(seconds=time.perf_counter() - t0, cached=False,
                      path=str(lib), log=log + link.stdout + link.stderr)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library with every exported function's C signature set."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        msg = load().mg_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
