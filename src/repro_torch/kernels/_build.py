"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The sources are compiled with `nvcc` for Hopper (`sm_90a`) at first use,
each source in its own `nvcc` process (all started together), then linked
into one shared library with a plain C interface that `ctypes` loads.
The library lands in `build/kernels/` at the repository root (listed in
`.gitignore`; `REPRO_TORCH_BUILD_DIR` overrides it), named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import time: the CPU tests import every
module of the package on a machine without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]

# dtype and op codes shared with csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}
OP_CODES = {"copy": 0, "add": 1, "max": 2, "min": 3, "mul": 4}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_LIB = None
BUILD_SECONDS = None   # wall time of the last build in this process


def build_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        "REPRO_TORCH_BUILD_DIR", _REPO_ROOT / "build" / "kernels"))


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC to build the "
                       "port's CUDA kernels")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list) -> None:
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build() -> pathlib.Path:
    """Compile csrc/ into the hashed shared library (if absent); return
    its path."""
    global BUILD_SECONDS
    out_dir = build_dir()
    lib_path = out_dir / f"librepro_torch_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = out_dir / f"tmp_{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    objs = [tmp / (src.stem + ".o") for src in _sources()]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(_sources(), objs)])
    staged = tmp / lib_path.name
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(staged),
               *map(str, objs)]])
    os.replace(staged, lib_path)
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib_path


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C entry points' argument types: c_void_p for every pointer and the
# stream, c_longlong for every size (else ctypes cuts them to 32 bits).
# Every entry point returns an int (cudaGetLastError()).
ARGTYPES = {
    "k1_fused_combine": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
    "k1_fused_combine_at": [_P, _P, _P, _LL, _LL, _LL,
                            _P, _P, _P, _LL, _LL, _LL,
                            _P, _LL, _LL, _LL, _I, _I, _I, _I, _P],
    "region_copy_at": [_P, _P, _P, _LL, _LL, _LL,
                       _P, _P, _P, _LL, _LL, _LL,
                       _LL, _LL, _LL, _I, _P],
    "k2_quantize_blocks": [_P, _P, _P, _LL, _LL, _LL, _I, _P],
    "k2_quantize_blocks_at": [_P, _P, _P, _LL, _LL, _LL, _LL, _LL,
                              _P, _P, _LL, _LL, _I, _P],
    "k3_dequantize_blocks": [_P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P],
    "k3_dequantize_blocks_at": [_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL,
                                _LL, _P, _LL, _LL, _I, _I, _P],
    "k4_matmul_tiled": [_P, _P, _P, _LL, _LL, _LL, _LL, _I, _I, _I, _I, _P],
    "k5_gather_rows": [_P, _P, _P, _LL, _LL, _LL, _LL, _I, _P],
    "k5_lookup_rows": [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                       _LL, _I, _P],
    "ssd_chunked": [_P] * 12 + [_LL] * 16 + [_I, _P],
}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build())), ARGTYPES)
    return _LIB


def bind(lib: ctypes.CDLL, names) -> ctypes.CDLL:
    """Declare the argument types of the entry points `names` on a
    loaded library."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = _I
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_handle(t) -> int:
    """The current PyTorch stream of `t`'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
