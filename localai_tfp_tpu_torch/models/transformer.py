"""Decoder-only transformer in PyTorch (Llama / Mistral / Qwen2 / Qwen3 /
Gemma 1-3 / Phi / Phi-3, and the mixtures of experts Mixtral / Qwen2-MoE
/ Qwen3-MoE: the families the JAX package serves).

Counterpart of localai_tfp_tpu/models/transformer.py. Parameters keep the
JAX package's tree: a dict of tensors with every per-layer weight stacked
on a leading ``[L, ...]`` axis and projections in ``[in, out]`` layout,
so both packages compute the same thing on the same weights
(models/convert.py carries a JAX tree across). In int8 serving the
projection leaves are ``quant.QTensor`` stacks and every projection goes
through ``quant.mm`` (the int8 kernel for eligible shapes). The layer
loop is a Python loop; the KV arena is updated in place (the JAX package
donates it through jit instead).

Two attention paths:
- the paged ragged path (``page_table``/``write_table``/``q_lens``): the
  chunk's K/V rows scatter into the ``[L, n_pages, page, F]`` arena, then
  one ``ops.ragged_paged_attention`` call per layer — the hand-written
  CUDA kernel on the card, its plain version on the CPU — with that
  layer's window (Gemma 2/3 alternate sliding and global layers), the
  attention softcap and the attention scale;
- the dense path (``page_table=None``): a ``[L, n_slots, max_seq, F]``
  cache and the masked dense ``_attend``, used as the reference in tests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..ops.ragged_paged_attention import ragged_paged_attention
from .llm_spec import LLMSpec
from .quant import QTensor, mm

Params = dict[str, Any]  # tensors, and QTensor leaves in int8 serving
NEG_INF = -1e30


@dataclass
class KVCache:
    """KV storage: the dense cache ``[L, n_slots, max_seq, F]`` or the paged
    arena ``[L, n_pages, page, F]`` (same layout, pages in place of
    slots). F = n_kv_heads * d_head, head-flat. int8 mode keeps per-row
    f32 scale planes ``[L, n_slots|n_pages, max_seq|page]``."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, spec: LLMSpec, n_slots: int, max_seq: int,
               dtype: Any = torch.bfloat16,
               device: Any = "cpu") -> "KVCache":
        shape = (spec.n_layers, n_slots, max_seq, spec.kv_dim)
        if dtype in (torch.int8, "int8", "q8", "q8_0"):
            return cls(
                k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                k_scale=torch.zeros(shape[:3], device=device),
                v_scale=torch.zeros(shape[:3], device=device),
            )
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_scale, self.v_scale)
                   if t is not None)


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., F] -> (int8 rows, per-row f32 scales)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _norm(spec: LLMSpec, x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm or LayerNorm (phi, with a bias) in f32, cast back to x's
    dtype; Gemma scales by ``1 + w``."""
    xf = x.float()
    if spec.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + spec.norm_eps)
    else:
        out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True)
                               + spec.norm_eps)
    wf = w.float()
    if spec.norm_weight_plus_one:
        wf = wf + 1.0
    out = out * wf
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def rope_inv_freq(spec: LLMSpec, device: Any = "cpu") -> torch.Tensor:
    """Rotary inverse frequencies, including llama3 / linear / yarn
    scaling."""
    rd = spec.rotary_dim
    inv = 1.0 / (spec.rope_theta ** (
        torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd))
    sc = spec.rope_scaling or {}
    rtype = (sc.get("rope_type") or sc.get("type") or "").lower()
    if rtype == "linear":
        inv = inv / float(sc.get("factor", 1.0))
    elif rtype == "llama3":
        factor = float(sc.get("factor", 8.0))
        lo = float(sc.get("low_freq_factor", 1.0))
        hi = float(sc.get("high_freq_factor", 4.0))
        orig = float(sc.get("original_max_position_embeddings", 8192))
        wavelen = 2 * math.pi / inv
        ratio = orig / wavelen
        smooth = torch.clamp((ratio - lo) / (hi - lo), 0.0, 1.0)
        inv = torch.where(
            wavelen > orig / lo,  # low-frequency band: fully scaled
            inv / factor,
            torch.where(
                wavelen < orig / hi,  # high-frequency band: unscaled
                inv,
                (1 - smooth) * inv / factor + smooth * inv,
            ),
        )
    elif rtype == "yarn":
        factor = float(sc.get("factor", 1.0))
        orig = float(sc.get("original_max_position_embeddings", 4096))
        beta_fast = float(sc.get("beta_fast", 32.0))
        beta_slow = float(sc.get("beta_slow", 1.0))

        def corr_dim(num_rot):
            return (rd * math.log(orig / (num_rot * 2 * math.pi))) / (
                2 * math.log(spec.rope_theta))

        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), rd - 1)
        ramp = torch.clamp(
            (torch.arange(rd // 2, dtype=torch.float32, device=device) - low)
            / max(high - low, 1), 0.0, 1.0)
        inv = inv / factor * ramp + inv * (1 - ramp)
    return inv


def rope_attn_scale(spec: LLMSpec) -> float:
    """YaRN attention scaling (mscale) applied to cos/sin; 1.0 otherwise."""
    sc = spec.rope_scaling or {}
    rtype = (sc.get("rope_type") or sc.get("type") or "").lower()
    if rtype != "yarn":
        return 1.0
    af = sc.get("attention_factor")
    if af is not None:
        return float(af)
    return 0.1 * math.log(float(sc.get("factor", 1.0))) + 1.0


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, rotary_dim: int,
               scale: float = 1.0) -> torch.Tensor:
    """HF-convention rotate-half RoPE. x: [B, T, H, Dh]; positions:
    [B, T]."""
    angles = positions[..., None].float() * inv_freq  # [B, T, rd/2]
    cos = (torch.cos(angles) * scale)[:, :, None, :]
    sin = (torch.sin(angles) * scale)[:, :, None, :]
    rot, keep = x[..., :rotary_dim], x[..., rotary_dim:]
    x1, x2 = rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), keep], dim=-1)


def _attn_scale(spec: LLMSpec) -> float:
    if spec.query_pre_attn_scalar:  # gemma 2/3
        return 1.0 / math.sqrt(spec.query_pre_attn_scalar)
    return 1.0 / math.sqrt(spec.d_head)


def _attend(spec: LLMSpec, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, q_pos: torch.Tensor,
            window: int = 0) -> torch.Tensor:
    """Dense masked attention (the reference path). q [B, T, H, Dh];
    k/v [B, S, Hkv, Dh]; q_pos [B, T] absolute query positions; the
    layer's window (0 = full). f32 accumulation, Gemma 2's softcap on the
    scaled logits before the mask, probabilities rounded to v's dtype as
    in the JAX package."""
    B, T, H, Dh = q.shape
    S = k.shape[1]
    group = H // spec.n_kv_heads
    qg = q.reshape(B, T, spec.n_kv_heads, group, Dh).float()
    logits = torch.einsum("btkgd,bskd->bktgs", qg, k.float()) \
        * _attn_scale(spec)
    if spec.attn_logit_softcap:
        cap = spec.attn_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    kv_pos = torch.arange(S, device=q.device)
    qp = q_pos.long()[:, None, :, None, None]
    mask = kv_pos <= qp
    if window:
        mask = mask & (kv_pos > qp - window)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bktgs,bskd->btkgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, T, H * Dh).to(q.dtype)


def _act(spec: LLMSpec, x: torch.Tensor) -> torch.Tensor:
    if spec.hidden_act == "silu":
        return F.silu(x)
    if spec.hidden_act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def _layer_is_sliding(spec: LLMSpec) -> Optional[list[bool]]:
    """Per-layer sliding flags; HF layer_types wins over the pattern."""
    if spec.layer_types is not None:
        return [t == "sliding_attention" for t in spec.layer_types]
    if spec.sliding_window_pattern and spec.sliding_window:
        return [(i + 1) % spec.sliding_window_pattern != 0
                for i in range(spec.n_layers)]
    return None


def layer_windows(spec: LLMSpec) -> list[int]:
    """Each layer's sliding window, 0 for full attention: Gemma 2/3
    alternate sliding and global layers, Mistral and Phi-3 slide on every
    layer."""
    sliding = _layer_is_sliding(spec)
    if sliding is not None and spec.sliding_window:
        return [spec.sliding_window if s else 0 for s in sliding]
    return [spec.sliding_window or 0] * spec.n_layers


def _layer_inv_freqs(spec: LLMSpec, device: Any) -> list[torch.Tensor]:
    """Each layer's rotary inverse frequencies. Gemma 3's sliding layers
    rope on ``rope_local_base_freq`` unscaled, its global layers on
    ``rope_theta`` with the rope scaling; the others use one table."""
    global_ = rope_inv_freq(spec, device)
    sliding = _layer_is_sliding(spec)
    if sliding is None or not spec.rope_local_base_freq:
        return [global_] * spec.n_layers
    rd = spec.rotary_dim
    local = 1.0 / (spec.rope_local_base_freq ** (
        torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd))
    return [local if s else global_ for s in sliding]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

_NON_LAYER_KEYS = ("embed", "final_norm_w", "final_norm_b", "lm_head",
                   "lm_head_b")


def check_supported(spec: LLMSpec) -> None:
    """The families the JAX package serves. Anything else raises instead
    of computing another model's function: norms or activations the JAX
    package has no branch for."""
    unported = {
        f"norm_type {spec.norm_type!r}": spec.norm_type not in (
            "rmsnorm", "layernorm"),
        f"hidden_act {spec.hidden_act!r}": spec.hidden_act not in (
            "silu", "gelu", "gelu_tanh"),
    }
    found = [k for k, v in unported.items() if v]
    if found:
        raise NotImplementedError(
            f"model features not ported yet: {', '.join(found)}")


def _layer_body(spec: LLMSpec, x, lp: dict, positions, inv_freq,
                rope_scale, attn_fn, dense_only: bool = False):
    """One transformer layer, as the JAX package's ``_layer_body``:
    pre-norm (RMSNorm or LayerNorm + bias), q/k/v (+ biases, + per-head
    q/k norms), rope on the layer's table, ``attn_fn(q, k, v) -> attn
    [B, T, H*Dh]`` (which owns where K/V live and the contraction), the
    output projection (+ bias), Gemma's sandwich norms, and a gated or
    ungated MLP (+ biases) in sequence or parallel (phi) with attention,
    or the mixture of experts (``dense_only``: a Qwen2-MoE layer whose
    plain MLP sits in the shared-expert slots)."""
    B, T = x.shape[0], x.shape[1]
    h = _norm(spec, x, lp["ln1_w"], lp.get("ln1_b"))
    q = mm(h, lp["wq"])
    k = mm(h, lp["wk"])
    v = mm(h, lp["wv"])
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, T, spec.n_heads, spec.d_head)
    k = k.reshape(B, T, spec.n_kv_heads, spec.d_head)
    v = v.reshape(B, T, spec.n_kv_heads, spec.d_head)
    if "q_norm_w" in lp:  # qwen3 / gemma3: per-head norm before rope
        q = _norm(spec, q, lp["q_norm_w"])
        k = _norm(spec, k, lp["k_norm_w"])
    q = apply_rope(q, positions, inv_freq, spec.rotary_dim, rope_scale)
    k = apply_rope(k, positions, inv_freq, spec.rotary_dim, rope_scale)
    attn = mm(attn_fn(q, k, v), lp["wo"])
    if "bo" in lp:
        attn = attn + lp["bo"]
    if "ln_post_attn_w" in lp:  # gemma 2/3 sandwich: norm the branch
        attn = _norm(spec, attn, lp["ln_post_attn_w"])
    if spec.parallel_residual:
        mlp_in = h
    else:
        x = x + attn
        mlp_in = _norm(spec, x, lp["ln2_w"], lp.get("ln2_b"))
    if "router" in lp:  # mixture of experts
        mlp = _moe_mlp(spec, lp, mlp_in, dense_only)
    else:
        up = mm(mlp_in, lp["w_up"])
        if "b_up" in lp:
            up = up + lp["b_up"]
        if spec.gated_mlp:
            up = _act(spec, mm(mlp_in, lp["w_gate"])) * up
        else:
            up = _act(spec, up)
        mlp = mm(up, lp["w_down"])
        if "b_down" in lp:
            mlp = mlp + lp["b_down"]
    if "ln_post_ffw_w" in lp:
        mlp = _norm(spec, mlp, lp["ln_post_ffw_w"])
    return (x + attn + mlp) if spec.parallel_residual else (x + mlp)


def _router_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in f64, returned as f32. The JAX package takes the
    router product in f32 at HIGHEST precision; in f64 it is at least as
    exact and owes nothing to a process-wide TF32 switch, so near-tie
    routing is not decided by a flag a user may set."""
    return (x.double() @ w.double()).float()


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """(values, indices) of the k largest along the last axis, ties to
    the lower index, as ``lax.top_k`` picks them (a stable descending
    sort): which experts a tie admits decides the gate."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_mlp(spec: LLMSpec, lp: dict, x: torch.Tensor,
             dense_only: bool = False) -> torch.Tensor:
    """Top-k mixture of experts in the JAX package's dense formulation:
    every expert runs over every token, and the outputs are combined with
    the top-k router weights (a one-hot sum, so order within the k does
    not matter, membership does). Static shapes, so it captures into the
    engine's CUDA graphs as the dense MLP does; it costs E/k times the
    routed work (a routed dispatch is later work).

    ``moe_norm_topk`` renormalizes the k router weights (softmax over the
    selected logits); otherwise they are the raw softmax over all E.
    Qwen2-MoE adds a shared expert scaled by ``sigmoid(x . g)``; its
    dense-only layers hold a plain MLP in the shared slots with zeroed
    experts, where the JAX package forces the gate to 1 and multiplies
    the (zero) mixture by 0: here those layers skip the experts, which
    gives the same values."""
    B, T, D = x.shape
    out = None
    if not dense_only:
        E, K = spec.n_experts, spec.experts_per_token
        xt = x.reshape(B * T, D)
        logits = _router_logits(xt, lp["router"])  # [N, E] f32
        if spec.moe_norm_topk:
            vals, idx = _top_k(logits, K)
            w = torch.softmax(vals, dim=-1)
        else:
            w, idx = _top_k(torch.softmax(logits, dim=-1), K)
        gate = torch.zeros_like(logits).scatter_(-1, idx, w)  # [N, E]
        xe = xt.expand(E, B * T, D)
        g = torch.bmm(xe, lp["moe_gate"])  # [E, N, Fm]
        u = torch.bmm(xe, lp["moe_up"])
        y = torch.bmm(_act(spec, g) * u, lp["moe_down"])  # [E, N, D]
        # sum_e gate[n, e] y[e, n]: one product per token over y's
        # [N, E, D] view (strided, no copy)
        out = torch.bmm(gate.to(y.dtype)[:, None, :], y.transpose(0, 1))
        out = out.reshape(B, T, D)
    if "shared_gate" not in lp:
        return out
    s = (_act(spec, x @ lp["shared_gate"]) * (x @ lp["shared_up"])) \
        @ lp["shared_down"]
    s = s.float()
    if dense_only:
        return s.to(x.dtype)
    sg = torch.sigmoid(_router_logits(x, lp["shared_router"][:, None]))
    return (out.float() + s * sg).to(x.dtype)


def _embed_in(spec: LLMSpec, params: Params, tokens: torch.Tensor):
    emb = params["embed"]
    tok = tokens.long()
    if isinstance(emb, QTensor):  # int8 table, per-row scales
        dt = params["ln1_w"].dtype  # the model's compute dtype
        x = emb.q[tok].to(dt) * emb.scale[tok][..., None].to(dt)
    else:
        x = emb[tok]
    if spec.embedding_multiplier != 1.0:  # gemma: sqrt(d_model), in f32
        x = (x.float() * spec.embedding_multiplier).to(x.dtype)
    return x


def _soft_scatter(x: torch.Tensor, rows: torch.Tensor, brow: torch.Tensor,
                  bpos: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] with ``rows`` [R, D] written at (brow, bpos): the JAX
    ``_soft_expand`` + ``where``. Entries whose batch row is B or more
    go to a scratch row that is cut off (no host value: the scatter can
    be captured in a graph)."""
    B, T, D = x.shape
    flat = torch.cat([x.reshape(B * T, D), x.new_zeros((1, D))])
    at = torch.where(brow.long() < B, brow.long() * T + bpos.long(),
                     torch.full_like(brow, B * T, dtype=torch.long))
    flat = flat.index_copy(0, at, rows.to(x.dtype))
    return flat[:B * T].reshape(B, T, D)


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., D] @ [D, V] -> f32, never rounded to x's dtype: on the CPU
    in f32 (bf16 values are exact there), on the card one cuBLAS product
    with an f32 output, so no f32 copy of the head is made."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.device.type == "cpu":
        return x.float() @ w.float()
    x2 = x.reshape(-1, x.shape[-1])
    out = torch.mm(x2, w, out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _lm_head(spec: LLMSpec, params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, T, D] -> f32 logits [B, T, V], as the JAX package computes
    them: the product's f32 sum is returned unrounded (bf16 models
    multiply bf16 values with f32 accumulation and f32 output). An int8
    head (``int8_full``) carries a per-logit scale in both layouts (tied:
    per-row ``[V, D]``; untied: per-column ``[D, V]``), applied to the f32
    logits."""
    tied = spec.tie_word_embeddings
    head = params["embed"] if tied else params["lm_head"]
    if isinstance(head, QTensor):
        w = head.q.to(x.dtype)
        logits = _matmul_f32(x, w.T if tied else w) * head.scale.float()
    else:
        logits = _matmul_f32(x, head.T if tied else head)
    if "lm_head_b" in params:  # phi
        logits = logits + params["lm_head_b"].float()
    if spec.logit_softcap:  # gemma2
        logits = torch.tanh(logits / spec.logit_softcap) * spec.logit_softcap
    return logits


def forward_hidden(
    spec: LLMSpec,
    params: Params,
    tokens: torch.Tensor,  # [B, T] int
    pos0: torch.Tensor,  # [B] int32: absolute position of tokens[:, 0]
    cache: KVCache,
    slot_ids: Optional[torch.Tensor] = None,  # dense path: cache row per
    # batch row; None => identity (row b == slot b)
    *,
    page_table: Optional[torch.Tensor] = None,  # [B, max_pages] int32 READ
    # pages (paged ragged path; ``cache`` is then the arena)
    kv_page: int = 0,  # arena page size when page_table is set
    q_lens: Optional[torch.Tensor] = None,  # [B] int32 valid tokens per row
    write_table: Optional[torch.Tensor] = None,  # [B, max_pages] int32 WRITE
    # pages: entries the host did not grant point at trash page 0
    soft: Optional[tuple] = None,  # multimodal: (rows [R, D], batch row
    # [R], position [R]): each row REPLACES the embedding at (batch row,
    # position); entries with batch row >= B are dropped
) -> tuple[torch.Tensor, KVCache]:
    """Run the stack through the final norm; returns (hidden [B, T, D],
    cache). The cache is written in place: the paged path scatters this
    dispatch's K/V rows through ``write_table`` (pad positions beyond
    ``q_lens`` go to trash page 0), the dense path writes rows ``slot_ids``
    at columns ``pos0 + [0, T)``. Soft rows land after the embedding
    multiplier (Gemma's sqrt(D) never touches them), cast to the
    activations' dtype, as HF's masked scatter of image features."""
    check_supported(spec)
    B, T = tokens.shape
    dev = tokens.device
    x = _embed_in(spec, params, tokens)
    if soft is not None:
        x = _soft_scatter(x, *soft)
    tpos = pos0.long()[:, None] + torch.arange(T, device=dev)[None, :]
    inv_freqs = _layer_inv_freqs(spec, dev)
    windows = layer_windows(spec)
    rope_scale = rope_attn_scale(spec)
    quant = cache.quantized
    ragged = page_table is not None
    if ragged:
        if q_lens is None or write_table is None or slot_ids is not None:
            raise ValueError("paged path needs q_lens + write_table and "
                             "identity rows")
        rows = torch.arange(B, device=dev)[:, None]
        lp_idx = torch.clamp(tpos // kv_page, max=write_table.shape[1] - 1)
        wpg = write_table.long()[rows, lp_idx]
        pad = torch.arange(T, device=dev)[None, :] >= q_lens.long()[:, None]
        wpg = wpg.masked_fill(pad, 0)  # pad positions write trash
        woff = tpos % kv_page
    stacked = {k: v for k, v in params.items() if k not in _NON_LAYER_KEYS}
    scale = _attn_scale(spec)
    softcap = spec.attn_logit_softcap or 0.0
    # Qwen2-MoE's layers with a plain MLP in the shared-expert slots
    dense_layers = frozenset(spec.moe_dense_layers)

    for layer in range(spec.n_layers):
        lp = {k: v.layer(layer) if isinstance(v, QTensor) else v[layer]
              for k, v in stacked.items()}

        def ragged_attn(q, k, v, layer=layer):
            kf = k.reshape(B, T, spec.kv_dim)
            vf = v.reshape(B, T, spec.kv_dim)
            ck, cv = cache.k[layer], cache.v[layer]  # in-place views
            if quant:
                kq, ksc = _quantize_rows(kf)
                vq, vsc = _quantize_rows(vf)
                cache.k_scale[layer][wpg, woff] = ksc
                cache.v_scale[layer][wpg, woff] = vsc
            else:
                kq, vq = kf, vf
            ck[wpg, woff] = kq.to(ck.dtype)
            cv[wpg, woff] = vq.to(cv.dtype)
            # T == 1 keeps the decode contract: the current rows' exact
            # K/V seed the attention (an int8 cache attends the exact
            # row, not its quantized copy); T > 1 rows read their own
            # freshly written arena rows
            seed = ((kf[:, 0].contiguous(), vf[:, 0].contiguous())
                    if T == 1 else None)
            out = ragged_paged_attention(
                q, cache.k, cache.v, layer, page_table, pos0, q_lens,
                spec.n_kv_heads, scale=scale, page=kv_page,
                sliding_window=windows[layer], softcap=softcap,
                cache_k_scale=cache.k_scale, cache_v_scale=cache.v_scale,
                seed_kv=seed)
            return out.to(x.dtype)

        def dense_attn(q, k, v, layer=layer):
            kf = k.reshape(B, T, spec.kv_dim)
            vf = v.reshape(B, T, spec.kv_dim)
            sids = (torch.arange(B, device=dev) if slot_ids is None
                    else slot_ids.long())
            cols = tpos
            srow = sids[:, None].expand(B, T)
            if quant:
                kq, ksc = _quantize_rows(kf)
                vq, vsc = _quantize_rows(vf)
                cache.k_scale[layer][srow, cols] = ksc
                cache.v_scale[layer][srow, cols] = vsc
            else:
                kq, vq = kf, vf
            cache.k[layer][srow, cols] = kq.to(cache.k.dtype)
            cache.v[layer][srow, cols] = vq.to(cache.v.dtype)

            def split(buf, scales):
                out = buf[sids].reshape(B, -1, spec.n_kv_heads, spec.d_head)
                if scales is not None:
                    out = out.to(x.dtype) * scales[sids][
                        :, :, None, None].to(x.dtype)
                return out

            k_eff = split(cache.k[layer], cache.k_scale[layer]
                          if quant else None)
            v_eff = split(cache.v[layer], cache.v_scale[layer]
                          if quant else None)
            return _attend(spec, q, k_eff, v_eff, tpos, windows[layer])

        x = _layer_body(spec, x, lp, tpos, inv_freqs[layer], rope_scale,
                        ragged_attn if ragged else dense_attn,
                        layer in dense_layers)
    if spec.final_norm:
        x = _norm(spec, x, params["final_norm_w"], params.get("final_norm_b"))
    return x, cache


def forward(spec: LLMSpec, params: Params, tokens: torch.Tensor,
            pos0: torch.Tensor, cache: KVCache,
            slot_ids: Optional[torch.Tensor] = None,
            **paged: Any) -> tuple[torch.Tensor, KVCache]:
    """forward_hidden + LM head; returns (logits [B, T, V] f32, cache)."""
    x, cache = forward_hidden(spec, params, tokens, pos0, cache, slot_ids,
                              **paged)
    return _lm_head(spec, params, x), cache
