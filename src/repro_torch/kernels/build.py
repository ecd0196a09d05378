"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface. At first use ``nvcc``
compiles each source to an object, all of them at once, links them into
one shared library and loads it with ``ctypes``. The library lands in
``build/<hash>/`` beside this file, keyed on a hash of the sources, the
headers they include and the flags, so an edited source or header
rebuilds and an unchanged one loads at once.
Nothing but this package's sources goes into it.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that no
multiply-add is contracted into an FMA — the quantize kernel's codes must
round exactly as the reference's do (the flash-attention and SSD kernels
use explicit ``fmaf`` where they want one). ``--use_fast_math`` is never
used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
SOURCES = ("fused_update.cu", "quantize.cu", "flash_attention.cu", "ssd.cu")
HEADERS = ("hopper.cuh",)   # included by the sources: hashed with them
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the GPU")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Run the commands concurrently; raise with the compiler's output if
    any fails. Every process is waited for."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed "
                               f"({p.returncode}):\n{out}")


def build() -> Path:
    """Compile the kernels (if this source hash was not built yet) and
    return the shared library's path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "librepro_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [out_dir / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
              for s, o in zip(SOURCES, objs)])
    tmp = out_dir / f"librepro_kernels.{tag}.so"
    _run_all([[nvcc, ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, lib_path)   # atomic: concurrent builders never see half
    for o in objs:
        o.unlink(missing_ok=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_float)
        lib.repro_fused_sgd_update.argtypes = [vp, i32, i32, i32, i32, f32,
                                               f32, f32, vp]
        lib.repro_quantize.argtypes = [vp, vp, vp, vp, i64, i64, f32, vp]
        lib.repro_dequant_mean.argtypes = [vp, vp, vp, i64, i64, f32, f32,
                                           vp]
        lib.repro_flash_attention.argtypes = [vp, vp, vp, vp, *[i32] * 9,
                                              f32, f32, vp]
        lib.repro_ssd.argtypes = [vp] * 11 + [i32] * 8 + [vp]
        lib.repro_ssd_bwd.argtypes = [vp] * 25 + [i32] * 8 + [vp]
        for fn in (lib.repro_fused_sgd_update, lib.repro_quantize,
                   lib.repro_dequant_mean, lib.repro_flash_attention,
                   lib.repro_ssd, lib.repro_ssd_bwd):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(status: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
