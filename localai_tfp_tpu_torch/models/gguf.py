"""GGUF checkpoints: the reader, dequantization on the load's device, the
parameter tree and the embedded tokenizer (counterpart of
localai_tfp_tpu/models/gguf.py).

``GGUFFile`` parses a GGUF v2/v3 header (metadata and tensor table);
``tensor(name, device)`` reads one tensor's raw blocks, moves them to
``device`` and dequantizes them there with torch operations, so serving
dequantizes on the card and tests on the CPU. The 15 types of the JAX
reader: F32, F16, BF16, Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K,
Q5_K, Q6_K, IQ4_NL and IQ4_XS. Each dequantizer computes the JAX numpy
dequantizer's f32 values bit for bit: the same operations in the same
order, one rounding each (separate torch operations, so no fused
multiply-add), f16 widened exactly, the K-quants' 6-bit scale table
unpacked as ``_k_scale_min`` does. (The numpy Q3_K and Q6_K products
promote to f64; they are exact there, so their f32 rounding is the f32
product here.)

``load_gguf_params`` maps llama-family tensor names onto the port's tree
(as the JAX package's): dense layers, Qwen's q/k/v biases, Qwen3's q/k
norms, Mixtral-style ``ffn_*_exps`` expert stacks with the
``ffn_gate_inp`` router, and a tied head when ``output.weight`` is
absent. Q and K rows (and biases) are un-permuted from llama.cpp's
interleaved rope order to the rotate-half order the forward uses. Each
weight is dequantized on the device, cast to the serving dtype and
written into its slot of a preallocated ``[L, ...]`` stack.

``GGUFTokenizer`` rebuilds the tokenizer from ``tokenizer.ggml.*`` with
no ``tokenizers`` package: a ``gpt2`` vocabulary is byte-level BPE
(``engine/bpe.py``, GPT-2's pre-tokenizer regex); a ``llama`` one is a
Unigram with byte fallback behind Metaspace (``engine/unigram.py``).
Control (type 3) and user-defined (type 4) tokens encode as single ids;
the chat template renders through ``engine/jinja_lite.py``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, BinaryIO, Callable, Optional

import numpy as np
import torch

from ..engine import jinja_lite
from ..engine.bpe import BPETokenizer
from .llm_spec import LLMSpec
from .load_timing import phase
from .transformer import Params, check_supported

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, \
    _T_STR, _T_ARR, _T_U64, _T_I64, _T_F64 = range(13)

_SCALARS: dict[int, tuple[str, int]] = {
    _T_U8: ("<B", 1), _T_I8: ("<b", 1), _T_U16: ("<H", 2),
    _T_I16: ("<h", 2), _T_U32: ("<I", 4), _T_I32: ("<i", 4),
    _T_F32: ("<f", 4), _T_BOOL: ("<?", 1), _T_U64: ("<Q", 8),
    _T_I64: ("<q", 8), _T_F64: ("<d", 8),
}


def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALARS:
        fmt, size = _SCALARS[vtype]
        return struct.unpack(fmt, f.read(size))[0]
    if vtype == _T_STR:
        return _read_str(f)
    if vtype == _T_ARR:
        (etype,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        if etype in _SCALARS:
            fmt, size = _SCALARS[etype]
            return list(struct.unpack(f"<{count}{fmt[1]}",
                                      f.read(size * count)))
        return [_read_value(f, etype) for _ in range(count)]
    raise ValueError(f"unknown gguf metadata type {vtype}")


@dataclasses.dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]  # numpy order (outermost first)
    ggml_type: int
    offset: int


class GGUFFile:
    """A parsed header; tensors are read and dequantized on demand."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        with open(path, "rb") as f:
            magic, version = struct.unpack("<II", f.read(8))
            if magic != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file")
            if version not in (2, 3):
                raise ValueError(f"{path}: unsupported GGUF v{version}")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = _read_str(f)
                (vtype,) = struct.unpack("<I", f.read(4))
                self.metadata[key] = _read_value(f, vtype)
            for _ in range(n_tensors):
                name = _read_str(f)
                (nd,) = struct.unpack("<I", f.read(4))
                ne = struct.unpack(f"<{nd}Q", f.read(8 * nd))
                ggml_type, offset = struct.unpack("<IQ", f.read(12))
                # gguf ne is innermost-first; numpy shape reverses it
                self.tensors[name] = GGUFTensorInfo(
                    name, tuple(reversed(ne)), ggml_type, offset)
            align = int(self.metadata.get("general.alignment", 32))
            self.data_start = (f.tell() + align - 1) // align * align

    def raw(self, name: str) -> np.ndarray:
        """The tensor's raw block bytes (uint8)."""
        ti = self.tensors[name]
        kind = _GGML_TYPES.get(ti.ggml_type)
        if kind is None:
            raise ValueError(
                f"{name}: unsupported ggml tensor type {ti.ggml_type}")
        _, block, block_bytes = kind
        n = int(np.prod(ti.shape))
        return np.fromfile(self.path, dtype=np.uint8,
                           count=n // block * block_bytes,
                           offset=self.data_start + ti.offset)

    def tensor(self, name: str, device: Any = "cpu") -> torch.Tensor:
        """The dequantized f32 tensor, numpy (outermost-first) order, on
        ``device``."""
        ti = self.tensors[name]
        with phase("read_s"):
            host = torch.from_numpy(self.raw(name))
        with phase("transfer_s", device):
            raw = host.to(device)
        with phase("dequant_s", device):
            return dequantize(ti.ggml_type, raw).reshape(ti.shape)


# ---------------------------------------------------------------------------
# dequantization (llama.cpp block layouts), torch over the raw bytes
# ---------------------------------------------------------------------------


def _f16(blk: torch.Tensor, at: int) -> torch.Tensor:
    """The f16 at byte ``at`` of each block, widened: [N, 1] f32."""
    return blk[:, at:at + 2].contiguous().view(torch.float16).float()


def _dq_f32(b: torch.Tensor) -> torch.Tensor:
    return b.view(torch.float32)


def _dq_f16(b: torch.Tensor) -> torch.Tensor:
    return b.view(torch.float16).float()


def _dq_bf16(b: torch.Tensor) -> torch.Tensor:
    return b.view(torch.bfloat16).float()


def _dq_q8_0(b: torch.Tensor) -> torch.Tensor:
    """block: f16 d + 32 int8."""
    blk = b.reshape(-1, 34)
    q = blk[:, 2:].contiguous().view(torch.int8).float()
    return (_f16(blk, 0) * q).reshape(-1)


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    """[N, 16] bytes -> [N, 32] f32: low nibbles, then high."""
    return torch.cat([qs & 0xF, qs >> 4], dim=1).float()


def _dq_q4_0(b: torch.Tensor) -> torch.Tensor:
    """block: f16 d + 16 bytes of nibbles; elems 0..15 = low nibbles,
    16..31 = high."""
    blk = b.reshape(-1, 18)
    return (_f16(blk, 0) * (_nibbles(blk[:, 2:]) - 8.0)).reshape(-1)


def _dq_q4_1(b: torch.Tensor) -> torch.Tensor:
    """block: f16 d + f16 m + 16 nibble bytes; val = d*q + m."""
    blk = b.reshape(-1, 20)
    return (_f16(blk, 0) * _nibbles(blk[:, 4:])
            + _f16(blk, 2)).reshape(-1)


def _q5_bits(blk: torch.Tensor, off: int) -> torch.Tensor:
    """qh u32 + 16 nibble bytes at ``off`` -> [N, 32] 5-bit values
    (elems 0..15 = low nibbles with qh bits 0..15, 16..31 = high with
    bits 16..31)."""
    qh = blk[:, off:off + 4].contiguous().view(torch.int32).long() \
        & 0xFFFFFFFF  # [N, 1]
    qs = blk[:, off + 4:off + 20].long()
    j = torch.arange(16, device=blk.device)
    lo = (qs & 0xF) | (((qh >> j) & 1) << 4)
    hi = (qs >> 4) | (((qh >> (j + 16)) & 1) << 4)
    return torch.cat([lo, hi], dim=1).float()


def _dq_q5_0(b: torch.Tensor) -> torch.Tensor:
    """block: f16 d + u32 qh + 16 nibble bytes; val = d*(q5 - 16)."""
    blk = b.reshape(-1, 22)
    return (_f16(blk, 0) * (_q5_bits(blk, 2) - 16.0)).reshape(-1)


def _dq_q5_1(b: torch.Tensor) -> torch.Tensor:
    """block: f16 d + f16 m + u32 qh + 16 nibble bytes; val = d*q5 + m."""
    blk = b.reshape(-1, 24)
    return (_f16(blk, 0) * _q5_bits(blk, 4) + _f16(blk, 2)).reshape(-1)


def _crumbs(qs: torch.Tensor) -> torch.Tensor:
    """2-bit values of ``qs [N, half, sub, l]`` by shift j: [N, half, j,
    sub, l] f32."""
    shifts = torch.arange(4, device=qs.device, dtype=torch.uint8) * 2
    return ((qs[:, :, None] >> shifts[None, None, :, None, None])
            & 3).float()


def _dq_q2_k(b: torch.Tensor) -> torch.Tensor:
    """super-block of 256: scales[16] (lo nibble = scale, hi = min),
    qs[64] 2-bit, d f16, dmin f16. Element (h, j, sub, l): q =
    qs[32h+16sub+l] >> (2j) & 3, scale index 8h+2j+sub."""
    blk = b.reshape(-1, 84)
    N = blk.shape[0]
    scales = blk[:, :16]
    q = _crumbs(blk[:, 16:80].reshape(N, 2, 2, 16))
    d = _f16(blk, 80)[:, :, None, None, None]
    dmin = _f16(blk, 82)[:, :, None, None, None]
    sc = (scales & 0xF).float().reshape(N, 2, 4, 2)
    mn = (scales >> 4).float().reshape(N, 2, 4, 2)
    return (d * sc[..., None] * q - dmin * mn[..., None]).reshape(-1)


def _dq_q3_k(b: torch.Tensor) -> torch.Tensor:
    """super-block of 256: hmask[32], qs[64] 2-bit, scales[12] packed
    6-bit signed (-32 offset), d f16. q = (qs>>(2j) & 3) - (hmask bit ?
    0 : 4); hmask bit for (h, j, sub, l) = hm[16sub+l] & (1 << (4h+j))."""
    blk = b.reshape(-1, 110)
    N = blk.shape[0]
    hm = blk[:, :32].reshape(N, 2, 16)  # [N, sub, l]
    raw = blk[:, 96:108]
    lo = torch.cat([raw[:, 0:4] & 0xF, raw[:, 4:8] & 0xF,
                    raw[:, 0:4] >> 4, raw[:, 4:8] >> 4], dim=1)
    hs = raw[:, 8:12]
    hi = torch.cat([hs & 3, (hs >> 2) & 3, (hs >> 4) & 3, (hs >> 6) & 3],
                   dim=1)
    scales = (lo | (hi << 4)).float() - 32.0
    q = _crumbs(blk[:, 32:96].reshape(N, 2, 2, 16))
    j = torch.arange(4, device=b.device, dtype=torch.uint8)
    h = torch.arange(2, device=b.device, dtype=torch.uint8)
    mask = torch.ones((), dtype=torch.uint8, device=b.device) << (
        j[None, :] + 4 * h[:, None])  # [half, j]
    have = (hm[:, None, None] & mask[None, :, :, None, None]) != 0
    q = q - torch.where(have, 0.0, 4.0)
    d = _f16(blk, 108)[:, :, None, None, None]
    return (d * scales.reshape(N, 2, 4, 2)[..., None] * q).reshape(-1)


# non-linear 4-bit codebook shared by IQ4_NL / IQ4_XS (ggml kvalues)
IQ4_KVALUES = (-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38,
               53, 69, 89, 113)


def _kvalues(idx: torch.Tensor) -> torch.Tensor:
    table = torch.tensor(IQ4_KVALUES, dtype=torch.float32,
                         device=idx.device)
    return table[idx.long()]


def _dq_iq4_nl(b: torch.Tensor) -> torch.Tensor:
    """block: f16 d + 16 nibble bytes indexing the nonlinear kvalues."""
    blk = b.reshape(-1, 18)
    qs = blk[:, 2:]
    vals = torch.cat([_kvalues(qs & 0xF), _kvalues(qs >> 4)], dim=1)
    return (_f16(blk, 0) * vals).reshape(-1)


def _dq_iq4_xs(b: torch.Tensor) -> torch.Tensor:
    """super-block of 256: f16 d + u16 scales_h + scales_l[4] + qs[128].
    Per 32-block k: scale = ((scales_l nibble) | (scales_h 2 bits << 4))
    - 32; values = d * scale * kvalues[nibble] (lo 0..15, hi 16..31)."""
    blk = b.reshape(-1, 136)
    N = blk.shape[0]
    d = _f16(blk, 0)  # [N, 1]
    sh = blk[:, 2:4].contiguous().view(torch.int16).long() & 0xFFFF
    sl = blk[:, 4:8].long()
    k = torch.arange(8, device=b.device)
    ls_l = (sl[:, k // 2] >> (4 * (k % 2))) & 0xF  # [N, 8]
    ls_h = (sh >> (2 * k)) & 3
    scale = (ls_l | (ls_h << 4)).float() - 32.0
    qs = blk[:, 8:136].reshape(N, 8, 16)
    vals = torch.cat([_kvalues(qs & 0xF), _kvalues(qs >> 4)], dim=2)
    return (d[..., None] * scale[..., None] * vals).reshape(-1)


def _k_scale_min(scales: torch.Tensor) -> tuple[torch.Tensor,
                                                 torch.Tensor]:
    """Unpack the 12-byte 6-bit scale/min table of K-quants: (sc [N, 8],
    m [N, 8]) f32."""
    s = scales.to(torch.int32)
    sc = torch.cat([s[:, 0:4] & 63,
                    (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], dim=1)
    m = torch.cat([s[:, 4:8] & 63,
                   (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], dim=1)
    return sc.float(), m.float()


def _dq_q4_k(b: torch.Tensor) -> torch.Tensor:
    """super-block of 256: d f16, dmin f16, scales[12], qs[128]. Chunk c
    (64 values) uses qs[32c:32c+32]: low nibbles -> scale 2c, high
    nibbles -> scale 2c+1."""
    blk = b.reshape(-1, 144)
    N = blk.shape[0]
    d = _f16(blk, 0)[:, None]  # [N, 1, 1]
    dmin = _f16(blk, 2)[:, None]
    sc, mn = _k_scale_min(blk[:, 4:16])
    sc, mn = sc.reshape(N, 4, 2), mn.reshape(N, 4, 2)
    qs = blk[:, 16:144].reshape(N, 4, 32)
    lo = d * sc[:, :, 0:1] * (qs & 0xF).float() - dmin * mn[:, :, 0:1]
    hi = d * sc[:, :, 1:2] * (qs >> 4).float() - dmin * mn[:, :, 1:2]
    return torch.stack([lo, hi], dim=2).reshape(-1)


def _dq_q5_k(b: torch.Tensor) -> torch.Tensor:
    """super-block of 256: d, dmin, scales[12], qh[32], qs[128]."""
    blk = b.reshape(-1, 176)
    N = blk.shape[0]
    d, dmin = _f16(blk, 0), _f16(blk, 2)  # [N, 1]
    sc, mn = _k_scale_min(blk[:, 4:16])
    qh = blk[:, 16:48]  # [N, 32] high bits, bits 2c/2c+1 per chunk
    qs = blk[:, 48:176].reshape(N, 4, 32)
    out = []
    for c in range(4):
        lo = (qs[:, c] & 0xF).float() + (((qh >> (2 * c)) & 1) << 4).float()
        hi = (qs[:, c] >> 4).float() + (((qh >> (2 * c + 1)) & 1)
                                        << 4).float()
        out.append(d * sc[:, 2 * c:2 * c + 1] * lo
                   - dmin * mn[:, 2 * c:2 * c + 1])
        out.append(d * sc[:, 2 * c + 1:2 * c + 2] * hi
                   - dmin * mn[:, 2 * c + 1:2 * c + 2])
    return torch.stack(out, dim=1).reshape(-1)


def _dq_q6_k(b: torch.Tensor) -> torch.Tensor:
    """super-block of 256: ql[128], qh[64], scales[16] i8, d f16."""
    blk = b.reshape(-1, 210)
    N = blk.shape[0]
    ql = blk[:, 0:128].reshape(N, 2, 64)
    qh = blk[:, 128:192].reshape(N, 2, 32)
    scales = blk[:, 192:208].contiguous().view(torch.int8).float()
    d = _f16(blk, 208)
    sidx = torch.arange(32, device=b.device) // 16
    out = []
    for half in range(2):
        qlh, qhh = ql[:, half], qh[:, half]
        parts = (((qlh[:, :32] & 0xF) | ((qhh & 3) << 4)),
                 ((qlh[:, 32:] & 0xF) | (((qhh >> 2) & 3) << 4)),
                 ((qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4)),
                 ((qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4)))
        for i, q in enumerate(parts):
            qv = (q.to(torch.int32) - 32).float()
            out.append(d * scales[:, 8 * half + 2 * i + sidx] * qv)
    return torch.stack(out, dim=1).reshape(-1)


# ggml_type -> (dequant, block size in elements, block bytes)
_GGML_TYPES: dict[int, tuple[Callable, int, int]] = {
    0: (_dq_f32, 1, 4),
    1: (_dq_f16, 1, 2),
    2: (_dq_q4_0, 32, 18),
    3: (_dq_q4_1, 32, 20),
    6: (_dq_q5_0, 32, 22),
    7: (_dq_q5_1, 32, 24),
    8: (_dq_q8_0, 32, 34),
    10: (_dq_q2_k, 256, 84),
    11: (_dq_q3_k, 256, 110),
    12: (_dq_q4_k, 256, 144),
    13: (_dq_q5_k, 256, 176),
    14: (_dq_q6_k, 256, 210),
    20: (_dq_iq4_nl, 32, 18),
    23: (_dq_iq4_xs, 256, 136),
    30: (_dq_bf16, 1, 2),
}

GGML_TYPE_NAMES = {0: "F32", 1: "F16", 2: "Q4_0", 3: "Q4_1", 6: "Q5_0",
                   7: "Q5_1", 8: "Q8_0", 10: "Q2_K", 11: "Q3_K",
                   12: "Q4_K", 13: "Q5_K", 14: "Q6_K", 20: "IQ4_NL",
                   23: "IQ4_XS", 30: "BF16"}


def dequantize(ggml_type: int, raw: torch.Tensor) -> torch.Tensor:
    """Raw block bytes (uint8, on any device) of one ggml type -> f32."""
    return _GGML_TYPES[ggml_type][0](raw)


# ---------------------------------------------------------------------------
# spec + params mapping (llama-family)
# ---------------------------------------------------------------------------


def _unpermute_qk(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Invert convert_hf_to_gguf's permute(): gguf stores Q/K rows in
    rope-interleaved order; the forward ropes in HF rotate-half order. w
    is [out, in]."""
    out, in_ = w.shape
    hd = out // n_heads
    return (w.reshape(n_heads, hd // 2, 2, in_).transpose(1, 2)
            .reshape(out, in_))


def spec_from_gguf(meta: dict) -> LLMSpec:
    arch = meta.get("general.architecture", "llama")

    def g(key, default=None):
        return meta.get(f"{arch}.{key}", default)

    n_heads = int(g("attention.head_count", 32))
    d_model = int(g("embedding_length", 4096))
    head_dim = int(g("attention.key_length", d_model // n_heads))
    rope_scaling = None
    if g("rope.scaling.type") == "linear":
        rope_scaling = {"rope_type": "linear",
                        "factor": float(g("rope.scaling.factor", 1.0))}
    elif g("rope.scaling.type") == "yarn":
        rope_scaling = {
            "rope_type": "yarn",
            "factor": float(g("rope.scaling.factor", 1.0)),
            "original_max_position_embeddings": int(
                g("rope.scaling.original_context_length", 4096)),
        }
    tokens = meta.get("tokenizer.ggml.tokens") or []
    return LLMSpec(
        vocab_size=int(g("vocab_size", len(tokens) or 32000)),
        d_model=d_model,
        n_layers=int(g("block_count", 32)),
        n_heads=n_heads,
        n_kv_heads=int(g("attention.head_count_kv", n_heads)),
        d_head=head_dim,
        d_ff=int(g("feed_forward_length", 4 * d_model)),
        max_position=int(g("context_length", 4096)),
        rope_theta=float(g("rope.freq_base", 10000.0)),
        norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
        rope_scaling=rope_scaling,
        n_experts=int(g("expert_count", 0)),
        experts_per_token=int(g("expert_used_count", 2)),
    )


def load_gguf_params(path: str, dtype: torch.dtype = torch.bfloat16,
                     device: Any = "cpu",
                     gf: Optional[GGUFFile] = None) -> tuple[LLMSpec,
                                                             Params]:
    """(spec, params) from a GGUF file; every weight dequantized on
    ``device`` and cast to ``dtype``. Pass an already-parsed ``gf`` to
    skip re-reading the (vocabulary-heavy) header."""
    gf = gf or GGUFFile(path)
    spec = spec_from_gguf(gf.metadata)
    check_supported(spec)
    L = spec.n_layers

    def get(name: str) -> torch.Tensor:
        return gf.tensor(name, device)

    def stack(fmt: str, fn: Optional[Callable] = None) -> torch.Tensor:
        out = None
        for i in range(L):
            a = get(fmt.format(i=i))
            if fn is not None:
                a = fn(a)
            if out is None:
                out = torch.empty((L, *a.shape), dtype=dtype, device=device)
            out[i].copy_(a)
        return out

    def t(a: torch.Tensor) -> torch.Tensor:  # [out, in] -> [in, out]
        return a.T

    p: Params = {
        "embed": get("token_embd.weight").to(dtype),
        "ln1_w": stack("blk.{i}.attn_norm.weight"),
        "ln2_w": stack("blk.{i}.ffn_norm.weight"),
        "wq": stack("blk.{i}.attn_q.weight",
                    lambda a: t(_unpermute_qk(a, spec.n_heads))),
        "wk": stack("blk.{i}.attn_k.weight",
                    lambda a: t(_unpermute_qk(a, spec.n_kv_heads))),
        "wv": stack("blk.{i}.attn_v.weight", t),
        "wo": stack("blk.{i}.attn_output.weight", t),
        "final_norm_w": get("output_norm.weight").to(dtype),
    }
    if spec.n_experts:
        # Mixtral-style: ffn_gate_inp [E, D] router, fused expert stacks
        # ffn_{gate,up,down}_exps [E, out, in] -> [L, E, in, out]
        p["router"] = stack("blk.{i}.ffn_gate_inp.weight", t)
        for ours, theirs in (("moe_gate", "ffn_gate_exps"),
                             ("moe_up", "ffn_up_exps"),
                             ("moe_down", "ffn_down_exps")):
            p[ours] = stack("blk.{i}." + theirs + ".weight",
                            lambda a: a.transpose(1, 2))
    else:
        p["w_gate"] = stack("blk.{i}.ffn_gate.weight", t)
        p["w_up"] = stack("blk.{i}.ffn_up.weight", t)
        p["w_down"] = stack("blk.{i}.ffn_down.weight", t)
    if "output.weight" in gf.tensors:
        p["lm_head"] = t(get("output.weight")).to(dtype).contiguous()
    else:
        spec = dataclasses.replace(spec, tie_word_embeddings=True)
    if "blk.0.attn_q.bias" in gf.tensors:  # qwen-style qkv bias
        p["bq"] = stack("blk.{i}.attn_q.bias", lambda a: _unpermute_qk(
            a[:, None], spec.n_heads)[:, 0])
        p["bk"] = stack("blk.{i}.attn_k.bias", lambda a: _unpermute_qk(
            a[:, None], spec.n_kv_heads)[:, 0])
        p["bv"] = stack("blk.{i}.attn_v.bias")
        spec = dataclasses.replace(spec, qkv_bias=True)
    if "blk.0.attn_q_norm.weight" in gf.tensors:  # qwen3 q/k norms
        p["q_norm_w"] = stack("blk.{i}.attn_q_norm.weight")
        p["k_norm_w"] = stack("blk.{i}.attn_k_norm.weight")
        spec = dataclasses.replace(spec, qk_norm=True)
    return spec, p


# ---------------------------------------------------------------------------
# tokenizer from the embedded vocabulary
# ---------------------------------------------------------------------------

_METASPACE = {"type": "Metaspace", "replacement": "▁",
              "prepend_scheme": "always", "split": True}


class GGUFTokenizer:
    """The tokenizer of ``tokenizer.ggml.*`` (the JAX package's
    ``GGUFTokenizer`` without ``tokenizers``): byte-level BPE for a
    ``gpt2`` vocabulary, a byte-fallback Unigram behind Metaspace for a
    ``llama`` (sentencepiece) one; bos/eos ids from the metadata."""

    def __init__(self, meta: dict) -> None:
        kind = meta.get("tokenizer.ggml.model", "llama")
        tokens = list(meta.get("tokenizer.ggml.tokens") or [])
        if not tokens:
            raise ValueError("gguf carries no tokenizer.ggml.tokens")
        self.bos_id = meta.get("tokenizer.ggml.bos_token_id")
        eos = meta.get("tokenizer.ggml.eos_token_id")
        self.eos_ids = {int(eos)} if eos is not None else set()
        self.chat_template = meta.get("tokenizer.chat_template")
        if kind == "gpt2":
            model = {"type": "BPE",
                     "vocab": {tok: i for i, tok in enumerate(tokens)},
                     "merges": [m.split(" ", 1) for m in
                                meta.get("tokenizer.ggml.merges") or []]}
            pre = {"type": "ByteLevel", "add_prefix_space": False,
                   "use_regex": True}
            dec = {"type": "ByteLevel"}
        else:  # sentencepiece-style
            scores = meta.get("tokenizer.ggml.scores") or [0.0] * len(
                tokens)
            model = {"type": "Unigram",
                     "vocab": [(tok, float(s))
                               for tok, s in zip(tokens, scores)],
                     "unk_id": int(meta.get(
                         "tokenizer.ggml.unknown_token_id", 0)),
                     "byte_fallback": True}
            pre = _METASPACE
            dec = {"type": "Sequence", "decoders": [
                {"type": "ByteFallback"}, _METASPACE]}
        # control (3) and user-defined (4) tokens are single ids, or
        # chat-template markers like <|im_start|> shred into pieces the
        # model was never trained on; control tokens match before
        # normalization, user-defined ones after (there is no
        # normalizer). A repeated token string has its last id, as in
        # the model's vocabulary.
        last = {tok: i for i, tok in enumerate(tokens)}
        types = meta.get("tokenizer.ggml.token_type") or []
        added = [{"id": last[tok], "content": tok,
                  "special": int(ty) == 3, "normalized": int(ty) == 4}
                 for tok, ty in zip(tokens, types) if int(ty) in (3, 4)]
        self._tk = BPETokenizer(spec={"model": model, "pre_tokenizer": pre,
                                      "decoder": dec,
                                      "added_tokens": added})
        env = jinja_lite.Environment(loopcontrols=True)
        env.globals["raise_exception"] = jinja_lite._raise_exception
        env.globals["strftime_now"] = jinja_lite._strftime_now
        self._env = env

    @property
    def vocab_size(self) -> int:
        return self._tk.vocab_size

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = self._tk.encode(text)
        if add_bos and self.bos_id is not None:
            ids = [int(self.bos_id)] + ids
        return ids

    def decode(self, ids: list[int]) -> str:
        return self._tk.decode(ids)

    def encode_special(self, text: str) -> list[int]:
        """With special tokens added: the same ids (no post-processor)."""
        return self._tk.encode(text)

    def apply_chat_template(self, messages: list[dict], *,
                            add_generation_prompt: bool = True,
                            tools: Optional[list] = None) -> str:
        """``tokenizer.chat_template`` in a plain Jinja environment with
        loop controls, ``raise_exception`` and ``strftime_now``, as the
        JAX package renders it."""
        if not self.chat_template:
            raise ValueError("gguf has no tokenizer.chat_template")
        return self._env.from_string(self.chat_template).render(
            messages=messages, add_generation_prompt=add_generation_prompt,
            tools=tools, bos_token=self._token_str(self.bos_id),
            eos_token=self._token_str(next(iter(self.eos_ids), None)))

    def _token_str(self, tid) -> str:
        if tid is None:
            return ""
        try:
            return self._tk.id_to_token(int(tid)) or ""
        except (ValueError, TypeError):
            return ""  # non-integral id: no text form


def tokenizer_from_gguf(gf: GGUFFile) -> GGUFTokenizer:
    """The tokenizer of an already-parsed GGUF. A file with no vocabulary
    fails the load: a 128k-vocabulary model served by raw bytes would
    emit gibberish."""
    return GGUFTokenizer(gf.metadata)
