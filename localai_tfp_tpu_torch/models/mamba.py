"""Mamba (selective state-space) language models in PyTorch.

Counterpart of localai_tfp_tpu/models/mamba.py: the same parameter tree
(per-layer leaves stacked ``[L, ...]``, projections ``[in, out]``) and the
same arithmetic, dtype for dtype: the conv window, the SSM state and its
recurrence in f32, the projections in the weights' dtype. No KV cache:
each layer's state is (conv_state ``[Di, K-1]``, ssm_state ``[Di, N]``).

- ``forward``: full-sequence logits (the parity path): the
  position-parallel inputs of each layer, then the selective scan over
  time.
- ``step``: one token through every layer, the recurrence the server
  decodes with; ``generate`` threads it through the prompt and then
  picks tokens, through ``models/recurrent.py::StepRunner`` (a CUDA-graph
  replay per token on a card).

No Pallas kernel exists for this family in the JAX package, and none is
written here: the model runs as plain torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .recurrent import StepRunner

Params = dict[str, Any]


@dataclass(frozen=True, eq=False)
class MambaSpec:
    vocab_size: int
    d_model: int
    n_layers: int
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True

    @classmethod
    def from_hf(cls, cfg: dict) -> "MambaSpec":
        d_model = int(cfg.get("hidden_size") or 768)
        return cls(
            vocab_size=int(cfg.get("vocab_size") or 50280),
            d_model=d_model,
            n_layers=int(cfg.get("num_hidden_layers")
                         or cfg.get("n_layer") or 24),
            d_inner=int(cfg.get("intermediate_size") or 2 * d_model),
            d_state=int(cfg.get("state_size") or 16),
            d_conv=int(cfg.get("conv_kernel") or 4),
            dt_rank=int(cfg.get("time_step_rank") or -(-d_model // 16)),
            norm_eps=float(cfg.get("layer_norm_epsilon") or 1e-5),
            tie_embeddings=bool(cfg.get("tie_word_embeddings", True)),
        )


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (out * w.float()).to(x.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), no cutoff."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _head(spec: MambaSpec, p: Params) -> torch.Tensor:
    return p["embed"].T if spec.tie_embeddings else p["lm_head"]


def _layer_scan_inputs(spec: MambaSpec, lp: Params, x: torch.Tensor):
    """One layer's position-parallel part over ``x`` [T, D]: (conv
    output u, gate z, dt, B, C); only the recurrence is sequential."""
    T = x.shape[0]
    xs, z = (x @ lp["in_w"]).chunk(2, dim=-1)
    K = spec.d_conv
    xp = torch.cat([xs.new_zeros((K - 1, spec.d_inner)), xs], dim=0)
    u = xp[0:T] * lp["conv_w"][:, 0]
    for i in range(1, K):
        u = u + xp[i:i + T] * lp["conv_w"][:, i]
    u = F.silu(u + lp["conv_b"])
    dbc = u @ lp["x_proj_w"]
    R, N = spec.dt_rank, spec.d_state
    dt = _softplus(dbc[:, :R] @ lp["dt_w"] + lp["dt_b"])
    return u, z, dt, dbc[:, R:R + N], dbc[:, R + N:]


def _ssm_scan(spec: MambaSpec, lp: Params, u, dt, B, C,
              h0: Optional[torch.Tensor] = None):
    """h_t = exp(A dt_t) h_{t-1} + dt_t B_t u_t; y_t = C_t . h_t + D u_t,
    in f32. Returns (ys [T, Di] f32, the final state)."""
    A = -torch.exp(lp["A_log"].float())
    D = lp["D"].float()
    h = (torch.zeros((spec.d_inner, spec.d_state), dtype=torch.float32,
                     device=u.device) if h0 is None else h0)
    ys = []
    for t in range(u.shape[0]):
        u_t, dt_t = u[t].float(), dt[t].float()
        dA = torch.exp(dt_t[:, None] * A)
        h = dA * h + dt_t[:, None] * B[t].float()[None, :] * u_t[:, None]
        ys.append(h @ C[t].float() + D * u_t)
    return torch.stack(ys), h


@torch.inference_mode()
def forward(spec: MambaSpec, p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence logits [T, V] f32 (the parity path)."""
    x = p["embed"][tokens.long()]
    for i in range(spec.n_layers):
        lp = {k: v[i] for k, v in p["layers"].items()}
        h = _rms(x, lp["norm_w"], spec.norm_eps)
        u, z, dt, B, C = _layer_scan_inputs(spec, lp, h)
        ys, _ = _ssm_scan(spec, lp, u, dt, B, C)
        x = x + (ys.to(x.dtype) * F.silu(z)) @ lp["out_w"]
    x = _rms(x, p["final_norm_w"], spec.norm_eps)
    return (x @ _head(spec, p)).float()


def init_state(spec: MambaSpec, device: Any = "cpu") -> tuple:
    """(conv_state [L, Di, K-1], ssm_state [L, Di, N]), f32 zeros."""
    return (torch.zeros((spec.n_layers, spec.d_inner, spec.d_conv - 1),
                        dtype=torch.float32, device=device),
            torch.zeros((spec.n_layers, spec.d_inner, spec.d_state),
                        dtype=torch.float32, device=device))


def step(spec: MambaSpec, p: Params, token: Any, state: tuple
         ) -> tuple[torch.Tensor, tuple]:
    """One decode step: token (an int or a one-element tensor) ->
    (logits [V] f32, new state). Reads the token on the device (no host
    value), so the step can be captured in a CUDA graph."""
    conv_all, ssm_all = state
    embed = p["embed"]
    tok = torch.as_tensor(token, device=embed.device).reshape(1).long()
    x = embed.index_select(0, tok)[0]
    R, N = spec.dt_rank, spec.d_state
    convs, ssms = [], []
    for i in range(spec.n_layers):
        lp = {k: v[i] for k, v in p["layers"].items()}
        h = _rms(x, lp["norm_w"], spec.norm_eps)
        xs, z = (h @ lp["in_w"]).chunk(2)
        window = torch.cat([conv_all[i], xs[:, None].float()], dim=1)
        u = (window * lp["conv_w"].float()).sum(1) + lp["conv_b"].float()
        u = F.silu(u).to(x.dtype)
        convs.append(window[:, 1:])
        dbc = u @ lp["x_proj_w"]
        dt = _softplus(dbc[:R] @ lp["dt_w"] + lp["dt_b"])
        A = -torch.exp(lp["A_log"].float())
        dA = torch.exp(dt[:, None].float() * A)
        dBu = (dt[:, None] * dbc[R:R + N][None, :] * u[:, None]).float()
        h_new = dA * ssm_all[i] + dBu
        ssms.append(h_new)
        y = h_new @ dbc[R + N:].float() + lp["D"].float() * u.float()
        x = x + (y.to(x.dtype) * F.silu(z)) @ lp["out_w"]
    x = _rms(x, p["final_norm_w"], spec.norm_eps)
    return (x @ _head(spec, p)).float(), (torch.stack(convs),
                                          torch.stack(ssms))


def runner(spec: MambaSpec, p: Params, device: Any,
           eager: bool = False) -> StepRunner:
    """The model's ``StepRunner`` (graphs captured at first use)."""
    return StepRunner(lambda tok, st: step(spec, p, tok, st),
                      lambda: init_state(spec, device), spec.vocab_size,
                      device, eager=eager)


def generate(spec: MambaSpec, p: Params, prompt_ids: list[int],
             max_tokens: int, temperature: float = 0.0, seed: int = 0,
             eos_id: Optional[int] = None,
             noise: Optional[torch.Tensor] = None,
             run: Optional[StepRunner] = None) -> np.ndarray:
    """Greedy or temperature generation through ``run`` (default: an
    eager runner): the JAX ``generate``'s tokens, trimmed after the
    first ``eos_id``."""
    run = run or runner(spec, p, p["embed"].device, eager=True)
    return run.generate(prompt_ids, max_tokens, temperature, seed, eos_id,
                        noise)


# -------------------------------------------------------------- loading


def is_mamba_config(cfg: dict) -> bool:
    return (cfg.get("model_type") or "").lower() in ("mamba", "falcon_mamba")


def load_mamba(model_dir: str, dtype: torch.dtype = torch.float32,
               device: Any = "cpu") -> tuple[MambaSpec, Params]:
    """An HF ``MambaForCausalLM`` directory -> (spec, params), every leaf
    in ``dtype`` on ``device``."""
    from .hf_loader import load_hf_state

    config, get, names = load_hf_state(model_dir)
    spec = MambaSpec.from_hf(config)
    pre = "backbone.layers.{i}.mixer."

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device).to(dtype).contiguous()

    def stack(name: str, fn=lambda t: t) -> torch.Tensor:
        return put(torch.stack([fn(get(name.format(i=i)))
                                for i in range(spec.n_layers)]))

    def t(w: torch.Tensor) -> torch.Tensor:
        return w.T

    p: Params = {
        "embed": put(get("backbone.embeddings.weight")),
        "final_norm_w": put(get("backbone.norm_f.weight")),
        "layers": {
            "norm_w": stack("backbone.layers.{i}.norm.weight"),
            "in_w": stack(pre + "in_proj.weight", t),
            # HF conv1d weight [Di, 1, K] -> [Di, K]
            "conv_w": stack(pre + "conv1d.weight", lambda w: w[:, 0, :]),
            "conv_b": stack(pre + "conv1d.bias"),
            "x_proj_w": stack(pre + "x_proj.weight", t),
            "dt_w": stack(pre + "dt_proj.weight", t),
            "dt_b": stack(pre + "dt_proj.bias"),
            "A_log": stack(pre + "A_log"),
            "D": stack(pre + "D"),
            "out_w": stack(pre + "out_proj.weight", t),
        },
    }
    if not spec.tie_embeddings and "lm_head.weight" in names:
        p["lm_head"] = put(get("lm_head.weight").T)
    return spec, p
