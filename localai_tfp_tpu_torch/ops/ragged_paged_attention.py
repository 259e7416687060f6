"""Ragged paged attention: the wrapper around the hand-written Hopper
kernel (csrc/ragged_paged_attention.cu), its plain PyTorch version, and
the query/output layout handling.

Counterpart of localai_tfp_tpu/ops/ragged_paged_attention.py. One call
attends every row kind of a dispatch — decode rows (q_len 1), prefill
chunks, spec-verify rows — for one layer of the paged arena:

- arena ``[L, n_pages, page, F]`` (F = n_kv_heads * d_head, head-flat),
  bf16/f32, or int8 with f32 per-token scales ``[L, n_pages, page]``;
- ``page_table [B, max_pages]`` int32 physical pages per row (entries
  beyond a row's allocation point at the trash page, causally masked);
- ``q [B, T, H, Dh]`` with per-row ``pos0`` and ``q_lens``: query t of
  row b sits at position pos0[b] + t and attends
  [max(0, pos + 1 - window), pos];
- ``seed_kv`` (T == 1 only): the current rows' exact K/V replace their
  arena copies (an int8 cache attends the exact current row).

Returns ``[B, T, H * Dh]`` f32; pad queries (t >= q_lens[b]) are 0.

For a CUDA tensor the wrapper launches the kernel or raises. It takes the
plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
KERNEL = "ragged_paged_attention"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)


def to_rows(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """[B, T, H, Dh] -> [B, Hkv * G, Dh] (G = group * T), row
    (h * group + g) * T + t — the kernel's query layout, as in the JAX
    wrapper, so a block of rows shares one kv head."""
    B, T, H, Dh = q.shape
    group = H // n_kv_heads
    return (q.reshape(B, T, n_kv_heads, group, Dh).permute(0, 2, 3, 1, 4)
            .reshape(B, n_kv_heads * group * T, Dh).contiguous())


def from_rows(out: torch.Tensor, T: int, n_kv_heads: int,
              group: int) -> torch.Tensor:
    """[B, Hkv * G, Dh] -> [B, T, H * Dh] (inverse of ``to_rows``)."""
    B, _, Dh = out.shape
    return (out.reshape(B, n_kv_heads, group, T, Dh).permute(0, 3, 1, 2, 4)
            .reshape(B, T, n_kv_heads * group * Dh))


def ragged_attention_plain(
    q, cache_k, cache_v, layer: int, page_table, pos0, q_lens,
    n_kv_heads: int, *, scale: float, page: int,
    sliding_window: Optional[int] = None, cache_k_scale=None,
    cache_v_scale=None, seed_kv=None,
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
    kv_pos = torch.arange(W, device=q.device)[None, None, None, :]
    tq = torch.arange(T, device=q.device)
    qpos = (pos0.long()[:, None] + tq[None, :])[:, None, :, None]
    mask = (kv_pos <= qpos) & (
        tq[None, None, :, None] < q_lens.long()[:, None, None, None])
    if sliding_window is not None:
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
    # 11 pointers, 10 ints (B .. window), the f32 scale, 2 dtype codes,
    # the stream
    lib.rpa_forward.argtypes = [p] * 11 + [i] * 10 + [
        ctypes.c_float, i, i, p]
    lib.rpa_forward.restype = i
    lib.rpa_error_string.argtypes = [i]
    lib.rpa_error_string.restype = ctypes.c_char_p


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ragged_paged_attention: {msg}")


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
    sliding_window: Optional[int] = None,
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
            sliding_window=sliding_window, cache_k_scale=cache_k_scale,
            cache_v_scale=cache_v_scale, seed_kv=seed_kv)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    B, T, H, Dh = q.shape
    L, NP, PG, F = cache_k.shape
    quant = cache_k_scale is not None
    _check(PG == page, f"arena page {PG} != page {page}")
    _check(F == n_kv_heads * Dh and H % n_kv_heads == 0,
           f"head geometry H={H} Hkv={n_kv_heads} Dh={Dh} F={F}")
    _check(Dh in _HEAD_DIMS, f"head dim {Dh} not in {_HEAD_DIMS}")
    _check(0 <= layer < L, f"layer {layer} out of range [0, {L})")
    _check(q.dtype in (torch.float32, torch.bfloat16),
           f"query dtype {q.dtype}")
    _check(cache_v.shape == cache_k.shape and cache_v.dtype == cache_k.dtype,
           "cache_k / cache_v mismatch")
    if quant:
        _check(cache_k.dtype == torch.int8, "scales given for a non-int8 arena")
        for s in (cache_k_scale, cache_v_scale):
            _check(s is not None and s.shape == (L, NP, PG)
                   and s.dtype == torch.float32 and s.is_contiguous()
                   and s.device == q.device, "scale planes [L, n_pages, page] f32")
    else:
        _check(cache_k.dtype == q.dtype,
               f"arena dtype {cache_k.dtype} != query dtype {q.dtype}")
    for name, t, shape in (("page_table", page_table, (B, page_table.shape[1])),
                           ("pos0", pos0, (B,)), ("q_lens", q_lens, (B,))):
        _check(t.dtype == torch.int32 and tuple(t.shape) == shape
               and t.is_contiguous() and t.device == q.device,
               f"{name} must be contiguous int32 {shape} on {q.device}")
    for t in (cache_k, cache_v):
        _check(t.is_contiguous() and t.device == q.device,
               "arena must be contiguous on the query's device")
    if seed_kv is not None:
        _check(T == 1, "seed_kv is the decode (T == 1) contract")
        seed_k, seed_v = (s.reshape(B, F) for s in seed_kv)
        for s in (seed_k, seed_v):
            _check(s.dtype == q.dtype and s.is_contiguous()
                   and s.device == q.device, "seed rows [B, F] in q's dtype")
    else:
        seed_k = seed_v = None
    for t in (cache_k, cache_v, seed_k, seed_v):
        # the kernel loads 8 elements per vector load (16 B for bf16)
        _check(t is None or t.data_ptr() % 16 == 0,
               "arena and seed rows must be 16-byte aligned")
    group = H // n_kv_heads
    q2 = to_rows(q, n_kv_heads)
    out = torch.empty((B, n_kv_heads * group * T, Dh), dtype=torch.float32,
                      device=q.device)
    lib = _build.load(KERNEL, _declare)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.rpa_forward(
        ptr(q2), ptr(cache_k), ptr(cache_v), ptr(cache_k_scale),
        ptr(cache_v_scale), ptr(seed_k), ptr(seed_v), ptr(page_table),
        ptr(pos0), ptr(q_lens), ptr(out),
        B, T, n_kv_heads, group, Dh, NP, page, page_table.shape[1], layer,
        int(sliding_window or 0), float(scale), _DTYPE_CODE[q.dtype],
        _DTYPE_CODE[cache_k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            "ragged_paged_attention kernel launch failed: "
            f"{lib.rpa_error_string(rc).decode()} (cudaError {rc})")
    ragged_paged_attention.launches += 1
    return from_rows(out, T, n_kv_heads, group)


ragged_paged_attention.launches = 0  # kernel launches (not plain calls)
