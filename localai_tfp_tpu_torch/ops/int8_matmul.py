"""Weight-only int8 matrix product: the wrapper around the hand-written
Hopper kernel (csrc/int8_matmul.cu), its plain PyTorch version, and the
launch plan.

Counterpart of localai_tfp_tpu/ops/int8_matmul.py. ``x [M, K]`` (bf16 or
f32) times ``q [K, N]`` int8 (the serving ``[in, out]`` layout) with f32
accumulation, times the per-output-channel f32 ``scale [N]`` once on the
f32 sum, cast to ``out_dtype``. ``eligible`` is the JAX package's shape
contract (M <= 1024, K and N multiples of 512); ``models/quant.py::mm``
sends other shapes to the upcast product instead.

For a CUDA tensor the wrapper launches the kernel or raises. It takes the
plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

KERNEL = "int8_matmul"
BK = 512  # the JAX kernel's tiles: eligible shapes are multiples of these
BN = 512
MAX_M = 1024
TILE_N = 128  # the CUDA kernel's output columns per block
TILE_K = 64  # the K granularity of a split
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def eligible(m: int, q_shape) -> bool:
    """Shapes the kernel takes (the JAX package's rule)."""
    return (1 <= m <= MAX_M and q_shape[0] % BK == 0
            and q_shape[1] % BN == 0)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version: the f32 product, scaled once, then cast."""
    out_dtype = out_dtype or x.dtype
    return ((x.float() @ q.float()) * scale).to(out_dtype)


def plan(m: int, n: int, k: int, sms: int,
         bf16_x: bool = True) -> tuple[int, int, int]:
    """(rows per block, K splits, K elements per split), from static shapes
    only. Decode-sized M (<= 16) and f32 x keep their tiles (16 rows, else
    64) and split K until the grid has about four blocks per SM: their
    blocks are short and several reside on each SM. bf16 x with M > 16
    takes the mixed-step instance: 64-row tiles for M <= 64, else 128-row
    tiles (on the card these beat 64-row tiles even where they leave SMs
    idle; chip_smoke.py times both)."""
    if m <= 16 or not bf16_x:
        bm = 16 if m <= 16 else 64
        return (bm, *split_k(k, -(-4 * sms // (-(-m // bm) * (n // TILE_N)))))
    return mma_plan(64 if m <= 64 else 128, m, n, k, sms)


def mma_plan(bm: int, m: int, n: int, k: int,
             sms: int) -> tuple[int, int, int]:
    """The mixed-step instance's plan at ``bm`` rows: K splits only where
    the tiles leave more than half the SMs idle, into as many splits as
    give each SM one block."""
    return (bm, *split_k(k, sms // (-(-m // bm) * (n // TILE_N))))


def split_k(k: int, want: int) -> tuple[int, int]:
    """(splits, K elements per split): about ``want`` splits (at least one)
    of whole 64-element steps, every split non-empty."""
    steps = k // TILE_K
    per = -(-steps // max(1, min(steps, want)))
    return -(-steps // per), per * TILE_K


@functools.lru_cache(maxsize=None)
def _plan_on(index: int, m: int, n: int, k: int,
             bf16_x: bool) -> tuple[int, int, int]:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return plan(m, n, k, sms, bf16_x)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    # 5 pointers (x, q, scale, y, workspace), M N K bm splits k_split,
    # 2 dtype codes, the stream
    lib.i8mm_forward.argtypes = [p] * 5 + [i] * 8 + [p]
    lib.i8mm_forward.restype = i
    lib.i8mm_occupancy.argtypes = [i, ctypes.POINTER(i)]
    lib.i8mm_occupancy.restype = i
    lib.i8mm_error_string.argtypes = [i]
    lib.i8mm_error_string.restype = ctypes.c_char_p


def occupancy() -> list[dict]:
    """Dynamic shared memory and resident blocks per SM of the mixed-step
    instance at each row tile, on the current card (the build report's
    numbers)."""
    lib = _build.load(KERNEL, _declare)
    rows = []
    for bm in (64, 128):
        occ = (ctypes.c_int * 2)()
        rc = lib.i8mm_occupancy(bm, occ)
        if rc != 0:
            raise RuntimeError(
                f"i8mm_occupancy: {lib.i8mm_error_string(rc).decode()}")
        rows.append({"instance": f"i8mm_mma bm {bm}", "smem_bytes": occ[0],
                     "blocks_per_sm": occ[1]})
    return rows


def _why_not(x, q, scale, out_dtype) -> str:
    """The first reason the kernel cannot take these operands."""
    if not (x.dim() == 2 and q.dim() == 2 and scale.dim() == 1
            and q.shape[0] == x.shape[1] and scale.shape[0] == q.shape[1]):
        return (f"shapes x {tuple(x.shape)} q {tuple(q.shape)} scale "
                f"{tuple(scale.shape)} do not chain")
    if not eligible(x.shape[0], q.shape):
        return (f"shape M={x.shape[0]} K={q.shape[0]} N={q.shape[1]} is not "
                f"eligible (M <= {MAX_M}, K % {BK} == 0, N % {BN} == 0)")
    for name, t, want in (("x", x.dtype, _DTYPE_CODE),
                          ("out", out_dtype, _DTYPE_CODE),
                          ("q", q.dtype, (torch.int8,)),
                          ("scale", scale.dtype, (torch.float32,))):
        if t not in want:
            return f"{name} dtype {t}"
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x.device:
            return f"{name} lives on {t.device}, x on {x.device}"
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if not t.is_contiguous():
            return f"{name} must be contiguous"
    # the kernel reads 16 bytes per vector load
    return "x and q must be 16-byte aligned"


def _launch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
            out_dtype: torch.dtype, bm: int, splits: int,
            k_split: int) -> torch.Tensor:
    """The kernel call at a given plan, on operands the wrapper checked;
    raises if a launch is refused. Counts nothing."""
    (M, K), N = x.shape, q.shape[1]
    y = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    lib = _build.load(KERNEL, _declare)
    rc = lib.i8mm_forward(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, bm, splits, k_split,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            "int8_matmul kernel launch failed: "
            f"{lib.i8mm_error_string(rc).decode()} (cudaError {rc})")
    return y


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M, K] @ q [K, N] int8, times scale [N] f32 -> [M, N] out_dtype
    (default x's dtype), in one kernel call (two launches when K splits).
    The checks are one expression, so a call on the decode path pays for
    no error message it does not raise."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    ok = (x.dim() == 2 and q.dim() == 2 and scale.dim() == 1
          and q.shape[0] == x.shape[1] and scale.shape[0] == q.shape[1]
          and eligible(x.shape[0], q.shape)
          and x.dtype in _DTYPE_CODE and out_dtype in _DTYPE_CODE
          and q.dtype == torch.int8 and scale.dtype == torch.float32
          and q.device == x.device and scale.device == x.device
          and x.is_contiguous() and q.is_contiguous()
          and scale.is_contiguous()
          and x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError(f"int8_matmul: {_why_not(x, q, scale, out_dtype)}")
    y = _launch(x, q, scale, out_dtype,
                *_plan_on(x.device.index, x.shape[0], q.shape[1], x.shape[1],
                          x.dtype == torch.bfloat16))
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0  # kernel launches (not plain calls)
