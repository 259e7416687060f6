"""Ragged paged attention: the wrapper around the hand-written Hopper
kernel (csrc/ragged_paged_attention.cu), its plain PyTorch version, and
the launch plan (query tiles and the split of the kv range).

Counterpart of localai_tfp_tpu/ops/ragged_paged_attention.py. One call
attends every row kind of a dispatch — decode rows (q_len 1), prefill
chunks, spec-verify rows — for one layer of the paged arena:

- arena ``[L, n_pages, page, F]`` (F = n_kv_heads * d_head, head-flat),
  bf16/f32, or int8 with f32 per-token scales ``[L, n_pages, page]``;
- ``page_table [B, max_pages]`` int32 physical pages per row (entries
  beyond a row's allocation point at the trash page, causally masked);
- ``q [B, T, H, Dh]`` with per-row ``pos0`` and ``q_lens``: query t of
  row b sits at position pos0[b] + t and attends
  [max(0, pos + 1 - window), pos] (window 0 or None: [0, pos]);
- ``softcap`` (Gemma 2): the scaled logits become ``cap * tanh(s / cap)``
  before the mask; 0 is none, and it is a runtime argument of the kernel;
- ``seed_kv`` (T == 1 only): the current rows' exact K/V replace their
  arena copies (an int8 cache attends the exact current row).

Returns ``[B, T, H * Dh]`` f32; pad queries (t >= q_lens[b]) are 0.

For a CUDA tensor the wrapper launches the kernel or raises. It takes the
plain version only for tensors on the CPU. The kernel reads q through its
strides and writes the output in place, so no layout copy surrounds it.
A split launch merges through counters that the kernel leaves at zero:
per device, shared by every launch on the current stream, which orders
them; inside ``own_merge_counters(buf)`` (an engine capturing its CUDA
graphs on the capture stream) through the caller's own buffer, which its
graphs then bake in, so one engine's replays never share counters with
another engine's capture-stream work.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
KERNEL = "ragged_paged_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 80, 96, 128, 256)
KV_TILE = 64  # the kernel's kv tokens per tile: split_len is a multiple
SPLIT_BLOCKS_PER_SM = 4  # split the kv range until the grid has this many
MERGE_ROWS = 4096  # the merge's (split, row) weights fit the kernel's staging


def _plan(B: int, n_kv_heads: int, T: int, group: int, ctx_max: int,
          sms: int) -> tuple[int, int, int, int]:
    """(bm, query tiles, splits, split_len) of one launch, from static
    shapes only (never pos0 or q_lens, so the call never waits on the
    device). A query tile holds bm rows of one (row, kv head): T * group
    rows padded to 16 when they fit (decode, verify), else 64. Where the
    (row, kv head, query tile) blocks are fewer than four per SM, each
    also splits its kv range into chunks of split_len tokens (a multiple
    of the kernel's 64-token tile) until there are about that many, and
    at most MERGE_ROWS // bm - 1 chunks."""
    G = T * group
    bm = 16 if G <= 16 else 64
    qtiles = -(-G // bm)
    tiles = max(1, -(-ctx_max // KV_TILE))
    base = B * n_kv_heads * qtiles
    want = max(1, min(tiles, -(-SPLIT_BLOCKS_PER_SM * sms // base),
                      MERGE_ROWS // bm - 1))
    per = -(-tiles // want)
    return bm, qtiles, -(-tiles // per), per * KV_TILE


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _plan_on(index: int, *shape: int) -> tuple[int, int, int, int]:
    return _plan(*shape, _sms(index))


_counters: dict = {}  # device index -> zeroed int32 merge counters
_owned = threading.local()  # .buf: this thread's own_merge_counters buffer


def new_merge_counters(device: torch.device) -> torch.Tensor:
    """A zeroed counter buffer for ``own_merge_counters``: one counter per
    (row, kv head, query tile) of a split launch, which has fewer than
    SPLIT_BLOCKS_PER_SM * SMs of them."""
    return torch.zeros(SPLIT_BLOCKS_PER_SM * _sms(device.index),
                       dtype=torch.int32, device=device)


@contextlib.contextmanager
def own_merge_counters(buf: torch.Tensor):
    """Split launches this thread makes inside the block merge through
    ``buf`` instead of the device's shared counters."""
    prev = getattr(_owned, "buf", None)
    _owned.buf = buf
    try:
        yield
    finally:
        _owned.buf = prev


def _merge_counters(device: torch.device, n: int) -> torch.Tensor:
    """One zeroed counter per (row, kv head, query tile) of a split
    launch; the merging block sets its counter back to 0, so the buffer
    stays zero between launches (and across CUDA-graph replays). Split
    launches have fewer than SPLIT_BLOCKS_PER_SM * SMs such tiles, so the
    first buffer is never outgrown."""
    buf = getattr(_owned, "buf", None)
    if buf is not None:
        if buf.device != device or buf.numel() < n:
            raise ValueError(f"ragged_paged_attention: own merge counters "
                             f"{tuple(buf.shape)} on {buf.device} for {n} "
                             f"tiles on {device}")
        return buf
    buf = _counters.get(device.index)
    if buf is None or buf.numel() < n:
        size = max(n, SPLIT_BLOCKS_PER_SM * _sms(device.index))
        buf = torch.zeros(size, dtype=torch.int32, device=device)
        _counters[device.index] = buf
    return buf


def ragged_attention_plain(
    q, cache_k, cache_v, layer: int, page_table, pos0, q_lens,
    n_kv_heads: int, *, scale: float, page: int,
    sliding_window: Optional[int] = None, softcap: float = 0.0,
    cache_k_scale=None, cache_v_scale=None, seed_kv=None,
) -> torch.Tensor:
    """Plain PyTorch version (port of ``ragged_attention_reference``):
    gather each row's pages into a contiguous window, dequantize, and run
    masked softmax attention in f32."""
    B, T, H, Dh = q.shape
    pt = page_table.long()
    W = pt.shape[1] * page
    k = cache_k[layer][pt].reshape(B, W, -1).float()
    v = cache_v[layer][pt].reshape(B, W, -1).float()
    if cache_k_scale is not None:
        k = k * cache_k_scale[layer][pt].reshape(B, W)[..., None]
        v = v * cache_v_scale[layer][pt].reshape(B, W)[..., None]
    if seed_kv is not None:
        if T != 1:
            raise ValueError("seed_kv is the decode (T == 1) contract")
        rows = torch.arange(B, device=q.device)
        at = pos0.long().clamp(min=0)
        k[rows, at] = seed_kv[0].float()
        v[rows, at] = seed_kv[1].float()
    group = H // n_kv_heads
    heads = torch.arange(H, device=q.device) // group
    kh = k.reshape(B, W, n_kv_heads, Dh)[:, :, heads, :]
    vh = v.reshape(B, W, n_kv_heads, Dh)[:, :, heads, :]
    logits = torch.einsum("bthd,bshd->bhts", q.float(), kh) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    kv_pos = torch.arange(W, device=q.device)[None, None, None, :]
    tq = torch.arange(T, device=q.device)
    qpos = (pos0.long()[:, None] + tq[None, :])[:, None, :, None]
    mask = (kv_pos <= qpos) & (
        tq[None, None, :, None] < q_lens.long()[:, None, None, None])
    if sliding_window:
        mask &= kv_pos > qpos - sliding_window
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # fully-masked pad queries: keep softmax finite, zero the output
    probs = torch.where(mask.any(-1, keepdim=True), probs,
                        torch.zeros((), device=q.device))
    out = torch.einsum("bhts,bshd->bthd", probs, vh)
    return out.reshape(B, T, H * Dh)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    # 14 pointers, 3 query strides, 14 ints (B .. split_len), the f32
    # scale and softcap, 2 dtype codes, the stream
    lib.rpa_forward.argtypes = [p] * 14 + [ctypes.c_longlong] * 3 + [
        i] * 14 + [ctypes.c_float] * 2 + [i, i, p]
    lib.rpa_forward.restype = i
    lib.rpa_occupancy.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.rpa_occupancy.restype = i
    lib.rpa_error_string.argtypes = [i]
    lib.rpa_error_string.restype = ctypes.c_char_p


def occupancy() -> list[dict]:
    """Dynamic shared memory and resident blocks per SM of every kernel
    instance on the current card (the build report's numbers)."""
    lib = _build.load(KERNEL, _declare)
    rows = []
    for q_dtype, kv_dtype in ((torch.bfloat16, torch.bfloat16),
                              (torch.bfloat16, torch.int8),
                              (torch.float32, torch.float32),
                              (torch.float32, torch.int8)):
        for dh in _HEAD_DIMS:
            for bm in (16, 64):
                occ = (ctypes.c_int * 2)()
                rc = lib.rpa_occupancy(
                    _DTYPE_CODE[q_dtype], _DTYPE_CODE[kv_dtype], dh, bm, occ)
                if rc != 0:
                    raise RuntimeError(
                        f"rpa_occupancy: {lib.rpa_error_string(rc).decode()}")
                rows.append({"q": str(q_dtype)[6:], "kv": str(kv_dtype)[6:],
                             "dh": dh, "bm": bm, "smem_bytes": occ[0],
                             "blocks_per_sm": occ[1]})
    return rows


def _why_not(q, cache_k, cache_v, layer, page_table, pos0, q_lens,
             n_kv_heads, page, cache_k_scale, cache_v_scale,
             seed_kv) -> Optional[str]:
    """The first reason the kernel cannot take these operands, or None.
    Messages are formatted only on failure: the decode path calls this
    32 times per step."""
    B, T, H, Dh = q.shape
    L, NP, PG, F = cache_k.shape
    dev = q.device
    if PG != page:
        return f"arena page {PG} != page {page}"
    if F != n_kv_heads * Dh or H % n_kv_heads:
        return f"head geometry H={H} Hkv={n_kv_heads} Dh={Dh} F={F}"
    if Dh not in _HEAD_DIMS:
        return f"head dim {Dh} not in {_HEAD_DIMS}"
    if not 0 <= layer < L:
        return f"layer {layer} out of range [0, {L})"
    if q.dtype not in (torch.float32, torch.bfloat16):
        return f"query dtype {q.dtype}"
    if cache_v.shape != cache_k.shape or cache_v.dtype != cache_k.dtype:
        return "cache_k / cache_v mismatch"
    if cache_k_scale is not None:
        if cache_k.dtype != torch.int8:
            return "scales given for a non-int8 arena"
        for s in (cache_k_scale, cache_v_scale):
            if not (s is not None and s.shape == (L, NP, PG)
                    and s.dtype == torch.float32 and s.is_contiguous()
                    and s.device == dev):
                return "scale planes [L, n_pages, page] f32"
    elif cache_k.dtype != q.dtype:
        return f"arena dtype {cache_k.dtype} != query dtype {q.dtype}"
    for name, t, shape in (("page_table", page_table,
                            (B, page_table.shape[1])),
                           ("pos0", pos0, (B,)), ("q_lens", q_lens, (B,))):
        if not (t.dtype == torch.int32 and t.shape == shape
                and t.is_contiguous() and t.device == dev):
            return f"{name} must be contiguous int32 {shape} on {dev}"
    # the kernel copies 16-byte chunks of arena and seed rows
    for t in (cache_k, cache_v):
        if not (t.is_contiguous() and t.device == dev):
            return "arena must be contiguous on the query's device"
        if t.data_ptr() % 16:
            return "arena and seed rows must be 16-byte aligned"
    if seed_kv is not None:
        if T != 1:
            return "seed_kv is the decode (T == 1) contract"
        for s in seed_kv:
            if not (s.dtype == q.dtype and s.is_contiguous()
                    and s.device == dev and s.numel() == B * F):
                return "seed rows [B, F] in q's dtype"
            if s.data_ptr() % 16:
                return "arena and seed rows must be 16-byte aligned"
    return None


def ragged_paged_attention(
    q: torch.Tensor,  # [B, T, H, Dh] post-rope queries
    cache_k: torch.Tensor,  # [L, n_pages, page, F] arena, already holding
    cache_v: torch.Tensor,  # this dispatch's K/V rows
    layer: int,
    page_table: torch.Tensor,  # [B, max_pages] int32
    pos0: torch.Tensor,  # [B] int32
    q_lens: torch.Tensor,  # [B] int32
    n_kv_heads: int,
    *,
    scale: float,
    page: int,
    sliding_window: Optional[int] = None,  # 0 / None: full causal
    softcap: float = 0.0,  # gemma2's attn_logit_softcapping; 0: none
    cache_k_scale: Optional[torch.Tensor] = None,  # [L, n_pages, page] f32
    cache_v_scale: Optional[torch.Tensor] = None,
    seed_kv: Optional[tuple] = None,  # (new_k [B, F], new_v [B, F]), T == 1
) -> torch.Tensor:
    """Ragged attention for the whole batch in one kernel launch;
    returns [B, T, H * Dh] f32."""
    if q.device.type == "cpu":
        return ragged_attention_plain(
            q, cache_k, cache_v, layer, page_table, pos0, q_lens,
            n_kv_heads, scale=scale, page=page,
            sliding_window=sliding_window, softcap=softcap,
            cache_k_scale=cache_k_scale, cache_v_scale=cache_v_scale,
            seed_kv=seed_kv)
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention: unsupported device {q.device}")
    msg = _why_not(q, cache_k, cache_v, layer, page_table, pos0, q_lens,
                   n_kv_heads, page, cache_k_scale, cache_v_scale, seed_kv)
    if msg is not None:
        raise ValueError(f"ragged_paged_attention: {msg}")
    B, T, H, Dh = q.shape
    NP, F = cache_k.shape[1], cache_k.shape[3]
    if seed_kv is not None:
        seed_k, seed_v = (s.reshape(B, F) for s in seed_kv)
    else:
        seed_k = seed_v = None
    if q.stride(3) != 1 or q.data_ptr() % 16 or any(
            st % (16 // q.element_size()) for st in q.stride()[:3]):
        q = q.contiguous()  # the kernel reads 16-byte query chunks
    group = H // n_kv_heads
    bm, qtiles, splits, split_len = _plan_on(
        q.device.index, B, n_kv_heads, T, group, page_table.shape[1] * page)
    out = torch.empty((B, T, H * Dh), dtype=torch.float32, device=q.device)
    part_acc = part_ml = counters = None
    if splits > 1:  # one scratch buffer: partial acc rows, then (m, l)
        rows = B * n_kv_heads * qtiles * splits * bm
        part = torch.empty(rows * (Dh + 2), dtype=torch.float32,
                           device=q.device)
        part_acc = part.data_ptr()
        part_ml = part_acc + rows * Dh * 4
        counters = _merge_counters(q.device,
                                   B * n_kv_heads * qtiles).data_ptr()
    lib = _build.load(KERNEL, _declare)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.rpa_forward(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        ptr(cache_k_scale), ptr(cache_v_scale), ptr(seed_k), ptr(seed_v),
        page_table.data_ptr(), pos0.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), part_acc, part_ml, counters, *q.stride()[:3],
        B, T, n_kv_heads, group, Dh, NP, page, page_table.shape[1], layer,
        int(sliding_window or 0), bm, qtiles, splits, split_len,
        float(scale), float(softcap or 0.0), _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[cache_k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            "ragged_paged_attention kernel launch failed: "
            f"{lib.rpa_error_string(rc).decode()} (cudaError {rc})")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0  # kernel launches (not plain calls)
