"""RWKV (v4) recurrent language models in PyTorch.

Counterpart of localai_tfp_tpu/models/rwkv.py (HF ``RwkvForCausalLM``
checkpoints): every block is a LayerNorm, time mixing (the WKV
recurrence over (k, v) with a learned per-channel decay ``w`` and bonus
``u``, kept numerically stable as running sums (aa, bb) scaled by a
log-space maximum pp), a LayerNorm and channel mixing (a squared-ReLU
FFN gated by a sigmoid receptance), both mixing each input with the
previous token's. Block 0 normalises the embedding once more
(``pre_ln``). The state is ``[L, 5, D]`` f32: (attention previous x, aa,
bb, pp, FFN previous x). Everything is f32, as the JAX package loads it.

``step`` is the recurrence; ``forward`` scans it over a prompt (the
parity path); ``generate`` runs it through
``models/recurrent.py::StepRunner`` (a CUDA-graph replay per token on a
card). The HF inference rescale is kept: the output and FFN value
weights are divided by ``2^(layer // rescale_every)`` at load and the
activations halved every ``rescale_every`` layers. No Pallas kernel
exists for this family in the JAX package, and none is written here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .recurrent import StepRunner

Params = dict[str, Any]


@dataclass(frozen=True)
class RwkvSpec:
    vocab_size: int
    d_model: int
    n_layers: int
    layer_norm_eps: float = 1e-5
    rescale_every: int = 6

    @classmethod
    def from_hf(cls, cfg: dict) -> "RwkvSpec":
        return cls(
            vocab_size=int(cfg["vocab_size"]),
            d_model=int(cfg.get("hidden_size", 768)),
            n_layers=int(cfg.get("num_hidden_layers", 12)),
            layer_norm_eps=float(cfg.get("layer_norm_epsilon", 1e-5)),
            rescale_every=int(cfg.get("rescale_every", 6)),
        )


def _ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def init_state(spec: RwkvSpec, device: Any = "cpu") -> tuple:
    """([L, 5, D] f32,): zeros, pp (the running log-space max) -1e30."""
    st = torch.zeros((spec.n_layers, 5, spec.d_model), dtype=torch.float32,
                     device=device)
    st[:, 3, :] = -1e30
    return (st,)


def _time_mix(lp: dict, x, prev_x, aa, bb, pp):
    """WKV attention, one step; all f32 [D]."""
    xk = x * lp["time_mix_key"] + prev_x * (1 - lp["time_mix_key"])
    xv = x * lp["time_mix_value"] + prev_x * (1 - lp["time_mix_value"])
    xr = (x * lp["time_mix_receptance"]
          + prev_x * (1 - lp["time_mix_receptance"]))
    r = torch.sigmoid(xr @ lp["receptance_w"])
    k = xk @ lp["key_w"]
    v = xv @ lp["value_w"]
    ww = lp["time_first"] + k
    p = torch.maximum(pp, ww)
    e1 = torch.exp(pp - p)
    e2 = torch.exp(ww - p)
    wkv = (e1 * aa + e2 * v) / (e1 * bb + e2)
    # the state's update under the per-channel decay w = -exp(time_decay)
    ww = pp + -torch.exp(lp["time_decay"])
    p = torch.maximum(ww, k)
    e1 = torch.exp(ww - p)
    e2 = torch.exp(k - p)
    return (r * wkv) @ lp["output_w"], e1 * aa + e2 * v, e1 * bb + e2, p


def _channel_mix(lp: dict, x, prev_x):
    xk = (x * lp["ffn_time_mix_key"]
          + prev_x * (1 - lp["ffn_time_mix_key"]))
    xr = (x * lp["ffn_time_mix_receptance"]
          + prev_x * (1 - lp["ffn_time_mix_receptance"]))
    r = torch.sigmoid(xr @ lp["ffn_receptance_w"])
    k = torch.square(torch.relu(xk @ lp["ffn_key_w"]))
    return r * (k @ lp["ffn_value_w"])


def step(spec: RwkvSpec, p: Params, token: Any, state: tuple
         ) -> tuple[torch.Tensor, tuple]:
    """One recurrent step: token (an int or a one-element tensor) ->
    (logits [V] f32, (new state,)). Reads the token on the device."""
    (st,) = state
    embed = p["embed"]
    tok = torch.as_tensor(token, device=embed.device).reshape(1).long()
    eps = spec.layer_norm_eps
    x = _ln(embed.index_select(0, tok)[0].float(), p["pre_ln_w"],
            p["pre_ln_b"], eps)
    rows = []
    for i in range(spec.n_layers):
        lp = {k: v[i] for k, v in p["layers"].items()}
        h = _ln(x, lp["ln1_w"], lp["ln1_b"], eps)
        att, aa, bb, pp = _time_mix(lp, h, st[i, 0], st[i, 1], st[i, 2],
                                    st[i, 3])
        x = x + att
        h2 = _ln(x, lp["ln2_w"], lp["ln2_b"], eps)
        x = x + _channel_mix(lp, h2, st[i, 4])
        if spec.rescale_every > 0 and (i + 1) % spec.rescale_every == 0:
            x = x / 2.0
        rows.append(torch.stack([h, aa, bb, pp, h2]))
    x = _ln(x, p["ln_out_w"], p["ln_out_b"], eps)
    return (x @ p["head"]).float(), (torch.stack(rows),)


@torch.inference_mode()
def forward(spec: RwkvSpec, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence logits [T, V] (the parity path): ``step`` over the
    prompt from the initial state."""
    state = init_state(spec, p["embed"].device)
    out = []
    for t in tokens.tolist():
        lg, state = step(spec, p, t, state)
        out.append(lg)
    return torch.stack(out)


def runner(spec: RwkvSpec, p: Params, device: Any,
           eager: bool = False) -> StepRunner:
    """The model's ``StepRunner`` (graphs captured at first use)."""
    return StepRunner(lambda tok, st: step(spec, p, tok, st),
                      lambda: init_state(spec, device), spec.vocab_size,
                      device, eager=eager)


def generate(spec: RwkvSpec, p: Params, prompt_ids: list[int],
             max_tokens: int, temperature: float = 0.0, seed: int = 0,
             eos_id: Optional[int] = None,
             noise: Optional[torch.Tensor] = None,
             run: Optional[StepRunner] = None) -> np.ndarray:
    """As ``models/mamba.py::generate``: the JAX ``generate``'s tokens."""
    run = run or runner(spec, p, p["embed"].device, eager=True)
    return run.generate(prompt_ids, max_tokens, temperature, seed, eos_id,
                        noise)


# -------------------------------------------------------------- loading


def is_rwkv_config(cfg: dict) -> bool:
    return (cfg.get("model_type") or "").lower() == "rwkv"


def load_rwkv(model_dir: str, device: Any = "cpu") -> tuple[RwkvSpec, Params]:
    """An HF ``RwkvForCausalLM`` directory -> (spec, params), f32 on
    ``device`` whatever the checkpoint's dtype (as the JAX package loads
    it), with the inference rescale folded into the output and FFN value
    weights."""
    from .hf_loader import load_hf_state

    config, get, _ = load_hf_state(model_dir)
    spec = RwkvSpec.from_hf(config)

    def f32(name: str) -> torch.Tensor:
        return get(name).float()

    def t(name: str) -> torch.Tensor:
        return f32(name).T

    def v(name: str) -> torch.Tensor:
        return f32(name).reshape(-1)

    layers: dict[str, list] = {}
    for i in range(spec.n_layers):
        b = f"rwkv.blocks.{i}."
        scale = 2.0 ** (i // spec.rescale_every
                        if spec.rescale_every > 0 else 0)
        for key, val in (
                ("ln1_w", v(b + "ln1.weight")), ("ln1_b", v(b + "ln1.bias")),
                ("ln2_w", v(b + "ln2.weight")), ("ln2_b", v(b + "ln2.bias")),
                ("time_decay", v(b + "attention.time_decay")),
                ("time_first", v(b + "attention.time_first")),
                ("time_mix_key", v(b + "attention.time_mix_key")),
                ("time_mix_value", v(b + "attention.time_mix_value")),
                ("time_mix_receptance",
                 v(b + "attention.time_mix_receptance")),
                ("key_w", t(b + "attention.key.weight")),
                ("value_w", t(b + "attention.value.weight")),
                ("receptance_w", t(b + "attention.receptance.weight")),
                ("output_w", t(b + "attention.output.weight") / scale),
                ("ffn_time_mix_key", v(b + "feed_forward.time_mix_key")),
                ("ffn_time_mix_receptance",
                 v(b + "feed_forward.time_mix_receptance")),
                ("ffn_key_w", t(b + "feed_forward.key.weight")),
                ("ffn_value_w", t(b + "feed_forward.value.weight") / scale),
                ("ffn_receptance_w",
                 t(b + "feed_forward.receptance.weight"))):
            layers.setdefault(key, []).append(val)

    def put(x: torch.Tensor) -> torch.Tensor:
        return x.to(device).contiguous()

    return spec, {
        "embed": put(f32("rwkv.embeddings.weight")),
        "pre_ln_w": put(v("rwkv.blocks.0.pre_ln.weight")),
        "pre_ln_b": put(v("rwkv.blocks.0.pre_ln.bias")),
        "layers": {k: put(torch.stack(rows)) for k, rows in layers.items()},
        "ln_out_w": put(v("rwkv.ln_out.weight")),
        "ln_out_b": put(v("rwkv.ln_out.bias")),
        "head": put(t("head.weight")),
    }
