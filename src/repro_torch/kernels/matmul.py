"""K4 wrapper: the tiled fp32-accumulating matrix product as a CUDA
kernel on Hopper.

Replaces the TPU kernel `repro/kernels/matmul.py::matmul_tiled` (Pallas,
body `_kernel`): (M, K) @ (K, N) with an fp32 accumulator, cast once to
the output type. The kernel (csrc/matmul.cu) is batched over a leading
dim — the stacked ranks, so one launch serves all of them — masks ragged
tails instead of padding to 128, and sums in IEEE fp32 FMA, never TF32.
At the DLRM FC1 shapes it is bound by bytes at small batch and by fp32
operations at large batch, and `plan` picks a tile configuration for
each: a small-M one whose block tile covers all of M (M <= 64) and a
128 x 128 large-M one; and 16-byte or 4-byte staging copies by the rows'
alignment. Its plain version is `ref.matmul`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_MAX_GRID_YZ = 65535
# tile configurations of csrc/matmul.cu: (name, largest M, rows per block)
CONFIGS = (("small_m32", 32, 32), ("small_m64", 64, 64),
           ("large_m", None, 128))


def _dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in _build.DTYPE_CODES:
        raise TypeError(f"matmul_tiled: unsupported dtype {dtype}")
    return _build.DTYPE_CODES[name]


def plan(M: int, K: int, N: int, dtype, aligned: bool = True) -> tuple:
    """(configuration index, 16-byte staging?) K4 takes for (M, K) @
    (K, N) operands of `dtype`; `aligned`: both bases 16-byte aligned."""
    config = next(i for i, (_n, top, _bm) in enumerate(CONFIGS)
                  if top is None or M <= top)
    vec = (str(dtype) == "torch.float32" and aligned and K % 4 == 0
           and N % 4 == 0)
    return config, vec


def plan_name(M: int, K: int, N: int, dtype, aligned: bool = True) -> str:
    """The configuration `plan` picks, as a name, e.g. 'large_m/vec16'."""
    config, vec = plan(M, K, N, dtype, aligned)
    return f"{CONFIGS[config][0]}/{'vec16' if vec else 'scalar4'}"


def matmul_tiled(x, y, out_dtype=None):
    """Launch K4 on CUDA tensors: (G, M, K) @ (G, K, N) -> (G, M, N),
    fp32 accumulate, cast to `out_dtype` (default x.dtype). Raises on
    anything it cannot take."""
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"matmul_tiled: needs CUDA tensors on one device, "
                         f"got {x.device} and {y.device}")
    if x.dtype != y.dtype:
        raise TypeError(f"matmul_tiled: operand dtypes differ: {x.dtype} "
                        f"vs {y.dtype}")
    if x.ndim != 3 or y.ndim != 3:
        raise ValueError(f"matmul_tiled: needs two 3-D operands, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul_tiled: operands must be contiguous")
    G, M, K = x.shape
    G2, K2, N = y.shape
    if G2 != G or K2 != K:
        raise ValueError(f"matmul_tiled: shapes do not chain: "
                         f"{tuple(x.shape)} @ {tuple(y.shape)}")
    config, vec = plan(M, K, N, x.dtype, x.data_ptr() % 16 == 0
                       and y.data_ptr() % 16 == 0)
    if (G > _MAX_GRID_YZ or -(-M // CONFIGS[config][2]) > _MAX_GRID_YZ
            or max(M, K, N) >= 2**31):
        raise ValueError(f"matmul_tiled: shape {tuple(x.shape)} @ "
                         f"{tuple(y.shape)} exceeds the launch grid")
    in_code = _dtype_code(x.dtype)
    out_dtype = out_dtype or x.dtype
    out_code = _dtype_code(out_dtype)
    out = torch.empty((G, M, N), dtype=out_dtype, device=x.device)
    if out.numel():
        if K == 0:
            out.zero_()
        else:
            lib = _build.library()
            rc = lib.k4_matmul_tiled(x.data_ptr(), y.data_ptr(),
                                     out.data_ptr(), G, M, K, N, in_code,
                                     out_code, config, int(vec),
                                     _build.stream_handle(x))
            matmul_tiled.launches += 1
            # a ctypes launch is invisible to torch's dispatch modes, so
            # its products are counted here (`launch/analysis.py`)
            matmul_tiled.flops += 2 * G * M * N * K
            _build.check(rc, "matmul_tiled")
    return out


matmul_tiled.launches = 0
matmul_tiled.flops = 0
