"""Vision towers and multimodal projectors in PyTorch: SigLIP with the
Gemma 3 projector, CLIP with the LLaVA projector.

Counterpart of localai_tfp_tpu/models/vision.py. The parameter tree is
the JAX package's (``VisionParams``: the patch conv as a ``[C*P*P, D]``
matrix, per-layer weights stacked on a leading ``[L, ...]`` axis,
projections ``[in, out]``), so both packages compute the same thing on
the same weights (``models/convert.py::params_from_numpy``).

- ``vision_encode``: SigLIP (patchify + one product for the patch conv,
  learned positions, pre-LN layers with biased attention and a gelu-tanh
  MLP, a final post-LN).
- ``gemma3_project``: the patch grid average-pooled to ``mm_tokens``,
  a ``(1 + w)`` RMSNorm in f32, then the untransposed
  ``mm_input_projection``.
- ``clip_vision_encode``: CLIP (a CLS token, a pre-LN, quick-gelu
  layers); the penultimate layer's features with the CLS row dropped
  (LLaVA's ``vision_feature_layer=-2``, "default" select).
- ``llava_project``: linear, exact gelu, linear.

Attention is plain torch, as the JAX towers compute it in plain jnp (no
Pallas kernel): f32 logits and softmax, the probabilities cast to the
values' dtype, f32 accumulation. LayerNorms run in f32. An f32 tower
turns TF32 off for its products (``device.f32_products``), as the JAX
package runs f32 at ``Precision.HIGHEST``. Image decoding is
``models/image_io.py``.

``TowerRunner`` serves the tower: on a card one image is one CUDA-graph
replay over static buffers, captured at load. The route's thread runs
it beside the engine's scheduler thread, which holds the interpreter
lock between its own calls; run eagerly, each of the tower's ~30 ops a
layer waited for that lock, so an image admitted beside live streams
waited for them to end. A replay is a few host calls an image.
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_products

VisionParams = dict[str, Any]


@dataclass(frozen=True, eq=False)
class VisionSpec:
    hidden: int
    n_layers: int
    n_heads: int
    d_ff: int
    image_size: int
    patch_size: int
    channels: int = 3
    eps: float = 1e-6
    # gemma3 projector: pooled tokens per image and the text-model width
    mm_tokens: int = 256
    text_d_model: int = 0
    # encoder family: "siglip" (gemma3) | "clip" (llava)
    family: str = "siglip"

    @property
    def d_head(self) -> int:
        return self.hidden // self.n_heads

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def n_patches(self) -> int:
        return self.patches_per_side ** 2

    @property
    def tokens_per_side(self) -> int:
        return int(math.isqrt(self.mm_tokens))


def vision_spec_from_hf(cfg: dict[str, Any], mm_tokens: int,
                        text_d_model: int) -> VisionSpec:
    """An HF ``vision_config`` block (SiglipVisionConfig) -> VisionSpec."""
    return VisionSpec(
        hidden=int(cfg.get("hidden_size") or 1152),
        n_layers=int(cfg.get("num_hidden_layers") or 27),
        n_heads=int(cfg.get("num_attention_heads") or 16),
        d_ff=int(cfg.get("intermediate_size") or 4304),
        image_size=int(cfg.get("image_size") or 896),
        patch_size=int(cfg.get("patch_size") or 14),
        channels=int(cfg.get("num_channels") or 3),
        eps=float(cfg.get("layer_norm_eps") or 1e-6),
        mm_tokens=mm_tokens,
        text_d_model=text_d_model,
    )


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def _patchify(spec: VisionSpec, pixels: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, G*G, C*P*P], the conv's receptive fields."""
    B = pixels.shape[0]
    P, C, G = spec.patch_size, spec.channels, spec.patches_per_side
    x = pixels.reshape(B, C, G, P, G, P).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, G * G, C * P * P)


def _encoder(spec: VisionSpec, layers: dict, x: torch.Tensor,
             n_layers: int, act: Callable) -> torch.Tensor:
    """The first ``n_layers`` pre-LN encoder layers (SigLIP's and CLIP's
    share their structure and HF names)."""
    B, N, _ = x.shape
    H, Dh = spec.n_heads, spec.d_head
    scale = 1.0 / math.sqrt(Dh)
    for i in range(n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        h = _ln(x, lp["ln1_w"], lp["ln1_b"], spec.eps)
        q = (h @ lp["wq"] + lp["bq"]).reshape(B, N, H, Dh).transpose(1, 2)
        k = (h @ lp["wk"] + lp["bk"]).reshape(B, N, H, Dh).transpose(1, 2)
        v = (h @ lp["wv"] + lp["bv"]).reshape(B, N, H, Dh).transpose(1, 2)
        logits = (q.float() @ k.float().transpose(-1, -2)) * scale
        probs = torch.softmax(logits, dim=-1)
        attn = probs.to(v.dtype).float() @ v.float()  # f32 accumulation
        attn = attn.transpose(1, 2).reshape(B, N, H * Dh).to(x.dtype)
        x = x + (attn @ lp["wo"] + lp["bo"])
        h = _ln(x, lp["ln2_w"], lp["ln2_b"], spec.eps)
        h = act(h @ lp["fc1_w"] + lp["fc1_b"])
        x = x + (h @ lp["fc2_w"] + lp["fc2_b"])
    return x


def _gelu_tanh(v: torch.Tensor) -> torch.Tensor:
    return F.gelu(v, approximate="tanh")


def _quick_gelu(v: torch.Tensor) -> torch.Tensor:
    return v * torch.sigmoid(1.702 * v)


def vision_encode(spec: VisionSpec, vp: VisionParams,
                  pixels: torch.Tensor) -> torch.Tensor:
    """SigLIP: pixels [B, C, H, W] (normalised) -> patch features
    [B, n_patches, hidden] after the post-LN."""
    x = _patchify(spec, pixels) @ vp["patch_w"] + vp["patch_b"]
    x = x + vp["pos_embed"][None]
    x = _encoder(spec, vp["layers"], x, spec.n_layers, _gelu_tanh)
    return _ln(x, vp["post_ln_w"], vp["post_ln_b"], spec.eps)


def gemma3_project(spec: VisionSpec, vp: VisionParams,
                   feats: torch.Tensor) -> torch.Tensor:
    """Gemma3MultiModalProjector: [B, n_patches, hidden] -> [B,
    mm_tokens, text_d_model]."""
    B = feats.shape[0]
    G, T = spec.patches_per_side, spec.tokens_per_side
    K = G // T
    grid = feats.reshape(B, T, K, T, K, spec.hidden)
    pooled = grid.mean(dim=(2, 4)).reshape(B, T * T, spec.hidden)
    xf = pooled.float()
    normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + spec.eps) \
        * (1.0 + vp["mm_norm_w"].float())
    return normed.to(feats.dtype) @ vp["mm_proj"]


def clip_vision_encode(spec: VisionSpec, vp: VisionParams,
                       pixels: torch.Tensor) -> torch.Tensor:
    """CLIP: pixels [B, C, H, W] (CLIP-normalised) -> the penultimate
    layer's patch features [B, n_patches, hidden], CLS dropped. The last
    encoder layer and the post-LN feed nothing on this path and are not
    run."""
    B = pixels.shape[0]
    x = _patchify(spec, pixels) @ vp["patch_w"]  # no conv bias
    cls = vp["cls_embed"].to(x.dtype).expand(B, 1, spec.hidden)
    x = torch.cat([cls, x], dim=1) + vp["pos_embed"][None]
    x = _ln(x, vp["pre_ln_w"], vp["pre_ln_b"], spec.eps)
    n = vp["layers"]["wq"].shape[0] - 1
    x = _encoder(spec, vp["layers"], x, n, _quick_gelu)
    return x[:, 1:, :]


def llava_project(spec: VisionSpec, vp: VisionParams,
                  feats: torch.Tensor) -> torch.Tensor:
    """LlavaMultiModalProjector: one soft token per patch."""
    h = F.gelu(feats @ vp["mm_l1_w"] + vp["mm_l1_b"])
    return h @ vp["mm_l2_w"] + vp["mm_l2_b"]


@torch.inference_mode()
def encode_images(spec: VisionSpec, vp: VisionParams,
                  pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, C, H, W] -> soft tokens [B, mm_tokens, text_d_model]."""
    guard = (f32_products() if pixels.dtype == torch.float32
             else contextlib.nullcontext())
    with guard:
        if spec.family == "clip":
            return llava_project(spec, vp,
                                 clip_vision_encode(spec, vp, pixels))
        return gemma3_project(spec, vp, vision_encode(spec, vp, pixels))


class TowerRunner:
    """The tower and projector of one model: ``encode`` takes normalised
    pixels [n, C, S, S] (numpy f32) to soft rows [n, mm_tokens, D] on
    the device. On a card (not ``eager``) each image is one replay of a
    graph captured over a static [1, C, S, S] pixel buffer (``capture``;
    its own memory pool, ``pool_bytes``); on the CPU ``encode_images``
    runs on the whole batch. One encode at a time."""

    def __init__(self, spec: VisionSpec, vp: VisionParams, device: Any,
                 eager: bool = False) -> None:
        self.spec, self.vp = spec, vp
        self.device = torch.device(device)
        self.dtype = vp["patch_w"].dtype
        S = spec.image_size
        self.pixels = torch.zeros((1, spec.channels, S, S), dtype=self.dtype,
                                  device=self.device)
        self.rows: Optional[torch.Tensor] = None  # the graph's output
        self.graph: Any = None
        self.pool_bytes = 0
        self.eager = eager or self.device.type != "cuda"
        self.replays = 0
        self._stage: Optional[torch.Tensor] = None  # pinned pixel staging
        self._copied: Any = None  # event after the staging's last copy
        self._lock = threading.Lock()

    def capture(self) -> None:
        """Capture the one-image graph (a card, not ``eager``): one run on
        a side stream first, then the capture into a pool of its own
        (the route's threads replay it beside the engine's graphs)."""
        if self.eager or self.graph is not None:
            return
        dev = self.device
        s = torch.cuda.Stream(dev)
        pool = torch.cuda.graph_pool_handle()
        with torch.inference_mode():
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                encode_images(self.spec, self.vp, self.pixels)
            torch.cuda.current_stream(dev).wait_stream(s)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=s,
                                  capture_error_mode="thread_local"):
                self.rows = encode_images(self.spec, self.vp, self.pixels)
        self.graph = g
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == tuple(pool))

    @torch.inference_mode()
    def encode(self, pixels: np.ndarray) -> torch.Tensor:
        """Soft rows [n, mm_tokens, D] (the tower's dtype) of ``pixels``:
        by replay, each image staged in pinned memory and copied into
        the static buffer on the stream (the staging is rewritten only
        once its last copy has run)."""
        with self._lock:
            self.capture()
            if self.graph is None:
                return encode_images(self.spec, self.vp, torch.from_numpy(
                    pixels).to(self.device, self.dtype))
            n = len(pixels)
            if self._copied is not None:
                self._copied.synchronize()
            if self._stage is None or len(self._stage) < n:
                self._stage = torch.empty((n, *self.pixels.shape[1:]),
                                          dtype=self.dtype, pin_memory=True)
            self._stage[:n].copy_(torch.from_numpy(pixels))
            out = torch.empty((n, *self.rows.shape[1:]),
                              dtype=self.rows.dtype, device=self.device)
            for i in range(n):
                self.pixels.copy_(self._stage[i:i + 1], non_blocking=True)
                self.graph.replay()
                out[i:i + 1].copy_(self.rows)
            self._copied = torch.cuda.Event()
            self._copied.record()
            self.replays += n
            return out


# ------------------------------------------------------------------- loader


def _loader(get: Callable[[str], torch.Tensor], dtype: torch.dtype,
            device: Any, spec: VisionSpec, pref: str):
    """(one tensor cast onto the device, a per-layer stack of one name)."""

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device).to(dtype).contiguous()

    def stack(name: str, transpose: bool) -> torch.Tensor:
        rows = []
        for i in range(spec.n_layers):
            w = get(f"{pref}encoder.layers.{i}.{name}")
            rows.append(w.T if transpose else w)
        return cast(torch.stack(rows))

    return cast, stack


def _encoder_layer_stack(stack: Callable[[str, bool], torch.Tensor]) -> dict:
    """The SigLIP and CLIP encoder layers share HF tensor names."""
    return {
        "ln1_w": stack("layer_norm1.weight", False),
        "ln1_b": stack("layer_norm1.bias", False),
        "wq": stack("self_attn.q_proj.weight", True),
        "bq": stack("self_attn.q_proj.bias", False),
        "wk": stack("self_attn.k_proj.weight", True),
        "bk": stack("self_attn.k_proj.bias", False),
        "wv": stack("self_attn.v_proj.weight", True),
        "bv": stack("self_attn.v_proj.bias", False),
        "wo": stack("self_attn.out_proj.weight", True),
        "bo": stack("self_attn.out_proj.bias", False),
        "ln2_w": stack("layer_norm2.weight", False),
        "ln2_b": stack("layer_norm2.bias", False),
        "fc1_w": stack("mlp.fc1.weight", True),
        "fc1_b": stack("mlp.fc1.bias", False),
        "fc2_w": stack("mlp.fc2.weight", True),
        "fc2_b": stack("mlp.fc2.bias", False),
    }


def load_clip_vision_params(get: Callable[[str], torch.Tensor],
                            names: list[str], dtype: torch.dtype,
                            spec: VisionSpec, device: Any = "cpu"
                            ) -> Optional[VisionParams]:
    """A CLIP tower + LLaVA MLP projector (tensors under
    ``[model.]vision_tower.vision_model.*`` and
    ``[model.]multi_modal_projector.linear_{1,2}.*``); None when absent."""
    for pref in ("model.vision_tower.vision_model.",
                 "vision_tower.vision_model."):
        if f"{pref}embeddings.class_embedding" in names:
            break
    else:
        return None
    proj = ("model.multi_modal_projector."
            if "model.multi_modal_projector.linear_1.weight" in names
            else "multi_modal_projector.")
    cast, stack = _loader(get, dtype, device, spec, pref)
    conv = get(pref + "embeddings.patch_embedding.weight")  # [D, C, P, P]
    # HF spells it "pre_layrnorm" (sic)
    pre = ("pre_layrnorm"
           if pref + "pre_layrnorm.weight" in names else "pre_layernorm")
    p: VisionParams = {
        "patch_w": cast(conv.reshape(spec.hidden, -1).T),  # [C*P*P, D]
        "cls_embed": cast(get(pref + "embeddings.class_embedding")
                          .reshape(-1)),
        "pos_embed": cast(get(pref + "embeddings.position_embedding.weight")),
        "pre_ln_w": cast(get(pref + f"{pre}.weight")),
        "pre_ln_b": cast(get(pref + f"{pre}.bias")),
        "mm_l1_w": cast(get(proj + "linear_1.weight").T),
        "mm_l1_b": cast(get(proj + "linear_1.bias")),
        "mm_l2_w": cast(get(proj + "linear_2.weight").T),
        "mm_l2_b": cast(get(proj + "linear_2.bias")),
    }
    p["layers"] = _encoder_layer_stack(stack)
    return p


def load_vision_params(get: Callable[[str], torch.Tensor], names: list[str],
                       dtype: torch.dtype, spec: VisionSpec,
                       device: Any = "cpu") -> Optional[VisionParams]:
    """The SigLIP tower + Gemma 3 projector of an HF multimodal checkpoint
    (tensors under ``model.vision_tower.vision_model.*`` and
    ``model.multi_modal_projector.*``); None when absent."""
    for pref in ("model.vision_tower.vision_model.",
                 "vision_tower.vision_model."):
        if f"{pref}embeddings.patch_embedding.weight" in names:
            break
    else:
        return None
    proj = ("model.multi_modal_projector."
            if "model.multi_modal_projector.mm_input_projection_weight"
            in names else "multi_modal_projector.")
    cast, stack = _loader(get, dtype, device, spec, pref)
    conv = get(pref + "embeddings.patch_embedding.weight")  # [D, C, P, P]
    p: VisionParams = {
        "patch_w": cast(conv.reshape(spec.hidden, -1).T),  # [C*P*P, D]
        "patch_b": cast(get(pref + "embeddings.patch_embedding.bias")),
        "pos_embed": cast(get(pref + "embeddings.position_embedding.weight")),
        "post_ln_w": cast(get(pref + "post_layernorm.weight")),
        "post_ln_b": cast(get(pref + "post_layernorm.bias")),
        "mm_proj": cast(get(proj + "mm_input_projection_weight")),
        "mm_norm_w": cast(get(proj + "mm_soft_emb_norm.weight")),
    }
    p["layers"] = _encoder_layer_stack(stack)
    return p

