"""Batched token sampling (counterpart of localai_tfp_tpu/ops/sampling.py).

Per-request knobs are per-slot tensors on the device, indexed by slot, so
mixed temperature/top-k/top-p rows sample in one batched pass. Penalty
state is a dense ``[n_slots, vocab]`` count matrix over a ring window of
the last ``repeat_last_n`` tokens, updated incrementally.

Differences from the JAX package, all PyTorch idiom:
- the state is updated in place (the JAX package returns a new state
  and donates the old one through jit); functions still return it;
- random draws come from one ``torch.Generator`` per slot, seeded from
  the request seed. ``jax.random`` and torch's generators give different
  numbers from the same seed, so ``sample`` also takes the Gumbel noise
  itself (``noise [B, K]``): tests inject JAX's own draws and then the
  two samplers pick the same tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

NEG_INF = -1e30

# Candidate-set size for stochastic sampling: top-p/min-p/typical cutoffs
# are computed within the top-CAND candidates (llama.cpp chains top_k,
# default 40, ahead of them). Same constant as the JAX package.
CAND = 128

@dataclass
class SamplingState:
    """Per-slot sampling parameters, generators and penalty state.

    Every tensor has leading dim ``n_slots``; a slot's row is rewritten
    (``reset_slots``) when a request is admitted."""

    generators: list  # [S] torch.Generator on the state's device
    temperature: torch.Tensor  # [S] f32; <=0 => greedy
    top_k: torch.Tensor  # [S] i32; 0 => disabled
    top_p: torch.Tensor  # [S] f32; >=1 => disabled
    min_p: torch.Tensor  # [S] f32; 0 => disabled
    repeat_penalty: torch.Tensor  # [S] f32; 0 or 1 => disabled
    freq_penalty: torch.Tensor  # [S] f32
    presence_penalty: torch.Tensor  # [S] f32
    token_counts: torch.Tensor  # [S, V] i32 counts within penalty window
    history: torch.Tensor  # [S, W] i32 ring buffer of recent tokens (-1)
    history_pos: torch.Tensor  # [S] i32 ring write cursor
    repeat_last_n: torch.Tensor  # [S] i32 effective window size (<= W)
    typical_p: torch.Tensor  # [S] f32; >=1 => disabled
    mirostat: torch.Tensor  # [S] i32; 0 off, 1 v1, 2 v2
    mirostat_tau: torch.Tensor  # [S] f32 target surprise (bits)
    mirostat_eta: torch.Tensor  # [S] f32 learning rate
    mirostat_mu: torch.Tensor  # [S] f32 adaptive cutoff (2*tau at reset)

    @classmethod
    def create(cls, n_slots: int, vocab_size: int, window: int = 256,
               seed: int = 0, device: Any = "cpu") -> "SamplingState":
        dev = torch.device(device)

        def full(v, dtype):
            return torch.full((n_slots,), v, dtype=dtype, device=dev)

        f32, i32 = torch.float32, torch.int32
        return cls(
            generators=[torch.Generator(device=dev).manual_seed(seed + i)
                        for i in range(n_slots)],
            temperature=full(0.0, f32), top_k=full(0, i32),
            top_p=full(1.0, f32), min_p=full(0.0, f32),
            repeat_penalty=full(0.0, f32), freq_penalty=full(0.0, f32),
            presence_penalty=full(0.0, f32),
            token_counts=torch.zeros((n_slots, vocab_size), dtype=i32,
                                     device=dev),
            history=torch.full((n_slots, window), -1, dtype=i32, device=dev),
            history_pos=full(0, i32),
            repeat_last_n=full(min(64, window), i32),
            typical_p=full(1.0, f32), mirostat=full(0, i32),
            mirostat_tau=full(5.0, f32), mirostat_eta=full(0.1, f32),
            mirostat_mu=full(10.0, f32),
        )

    @property
    def window(self) -> int:
        return self.history.shape[1]

    @property
    def device(self) -> torch.device:
        return self.temperature.device


# the per-slot columns ``reset_slots`` writes, in their JAX argument order
RESET_FIELDS = ("temperature", "top_k", "top_p", "min_p", "repeat_penalty",
                "freq_penalty", "presence_penalty", "repeat_last_n",
                "typical_p", "mirostat", "mirostat_tau", "mirostat_eta")


def reset_slots(state: SamplingState, slot_ids: list[int], cols: dict,
                seeds: list[Optional[int]]) -> SamplingState:
    """Configure a batch of slots for new requests, in place. ``cols``
    maps each of ``RESET_FIELDS`` to one value per slot (``repeat_last_n``
    already clamped to the window); a slot whose seed is not None gets
    its generator reseeded, others keep drawing from theirs."""
    if not slot_ids:
        return state
    reset_rows(state, torch.tensor(slot_ids, device=state.device),
               torch.tensor([cols[name] for name in RESET_FIELDS],
                            dtype=torch.float32, device=state.device))
    reseed(state, slot_ids, seeds)
    return state


def reset_rows(state: SamplingState, slot_ids: torch.Tensor,
               cols: torch.Tensor) -> SamplingState:
    """``reset_slots``' device half over a fixed-size batch, with no host
    value in it (the engine's mixed graphs run it): ``cols
    [len(RESET_FIELDS), B]`` f32, one column per row (integer fields
    hold exact small integers). Rows may repeat a slot id, as sentinel
    rows do; that slot's row is then written by one of them."""
    sid = slot_ids.long()
    for i, name in enumerate(RESET_FIELDS):
        t = getattr(state, name)
        t[sid] = cols[i].to(t.dtype)
    # fills, not scalar assignments: those copy a host scalar, which a
    # CUDA graph capture refuses
    state.token_counts.index_fill_(0, sid, 0)
    state.history.index_fill_(0, sid, -1)
    state.history_pos.index_fill_(0, sid, 0)
    state.mirostat_mu[sid] = 2.0 * state.mirostat_tau[sid]
    return state


def reseed(state: SamplingState, slot_ids: list[int],
           seeds: list[Optional[int]]) -> None:
    """``reset_slots``' host half: a slot whose seed is not None gets its
    generator reseeded."""
    for s, seed in zip(slot_ids, seeds):
        if seed is not None:
            state.generators[s].manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)


def observe_tokens(state: SamplingState, slot_ids: torch.Tensor,
                   tokens: torch.Tensor, valid: torch.Tensor) -> SamplingState:
    """Record tokens into the penalty window, evicting the token that
    falls out of each slot's last-``repeat_last_n`` window. slot_ids,
    tokens, valid: [B] (distinct slots)."""
    W = state.window
    sid = slot_ids.long()
    pos = state.history_pos[sid].long()
    n = state.repeat_last_n[sid].long()
    old = torch.where(pos >= n, state.history[sid, (pos - n) % W].long(),
                      torch.full_like(pos, -1))
    dec = valid & (old >= 0)
    state.token_counts.index_put_(
        (sid, old.clamp(min=0)), -dec.to(torch.int32), accumulate=True)
    tok = tokens.long()
    inc = valid & (tok >= 0)
    state.token_counts.index_put_(
        (sid, tok.clamp(min=0)), inc.to(torch.int32), accumulate=True)
    col = pos % W
    state.history[sid, col] = torch.where(
        valid, tokens.to(torch.int32), state.history[sid, col])
    state.history_pos[sid] = torch.where(valid, pos + 1, pos).to(torch.int32)
    return state


def seed_windows(state: SamplingState, slot_ids: torch.Tensor,
                 tails: torch.Tensor, tail_lens: torch.Tensor) -> SamplingState:
    """Seed freshly reset slots' penalty windows from their prompt tails in
    closed form (equal to observing the tail token by token). slot_ids
    [B]; tails [B, W'] (prompt[-W:], left-aligned); tail_lens [B]."""
    W = state.window
    V = state.token_counts.shape[-1]
    sid = slot_ids.long()
    T = tail_lens.long()[:, None]
    n = torch.minimum(state.repeat_last_n[sid].long()[:, None], T)
    j = torch.arange(tails.shape[1], device=tails.device)[None, :]
    in_window = (j >= T - n) & (j < T)
    safe = torch.where((j < T) & (tails >= 0), tails.long(),
                       torch.full_like(tails, V, dtype=torch.long))
    counts = torch.zeros((len(sid), V + 1), dtype=torch.int32,
                         device=tails.device)
    counts.scatter_add_(1, safe, in_window.to(torch.int32))
    hist = torch.where(j < T, tails.to(torch.int32),
                       torch.full_like(tails, -1, dtype=torch.int32))
    if hist.shape[1] < W:
        hist = torch.nn.functional.pad(hist, (0, W - hist.shape[1]),
                                       value=-1)
    state.token_counts[sid] = counts[:, :V]
    state.history[sid] = hist
    state.history_pos[sid] = tail_lens.to(torch.int32)
    return state


def _apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                     repeat_penalty: torch.Tensor, freq_penalty: torch.Tensor,
                     presence_penalty: torch.Tensor) -> torch.Tensor:
    """llama.cpp-convention penalties: repeat divides positive logits /
    multiplies negative; frequency/presence are OpenAI-style subtractive."""
    present = counts > 0
    rp = repeat_penalty[:, None]
    rp = torch.where(rp > 0, rp, torch.ones_like(rp))
    penalized = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(present, penalized, logits)
    logits = logits - counts.float() * freq_penalty[:, None]
    return logits - present.float() * presence_penalty[:, None]


def _topk_scaled(state: SamplingState, slot_ids: torch.Tensor,
                 logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-CAND truncation + temperature scaling: (scaled [B, K] desc,
    vocab idx [B, K])."""
    K = min(CAND, logits.shape[-1])
    vals, idx = torch.topk(logits.float(), K, dim=-1)
    temp = state.temperature[slot_ids.long()]
    return vals / temp.clamp(min=1e-6)[:, None], idx


def _masked_softmax_inputs(keep: torch.Tensor, scaled: torch.Tensor):
    return torch.where(keep, scaled, torch.full_like(scaled, NEG_INF))


def _chain_probs(state: SamplingState, slot_ids: torch.Tensor,
                 scaled: torch.Tensor) -> torch.Tensor:
    """top_k -> typical_p -> top_p -> min_p over temp-scaled candidate
    logits ``scaled`` [B, K] (desc order). Returns probs [B, K]."""
    sid = slot_ids.long()
    K = scaled.shape[-1]
    rank = torch.arange(K, device=scaled.device)[None, :]
    tk = state.top_k[sid]
    k_eff = torch.where(tk <= 0, torch.full_like(tk, K), tk)[:, None]
    scaled = _masked_softmax_inputs(rank < k_eff, scaled)
    # locally typical filter (llama.cpp chain order top_k -> typ_p ->
    # top_p -> min_p): keep the smallest set, ordered by |surprise -
    # entropy|, whose cumulative probability reaches typical_p
    typ = state.typical_p[sid][:, None]
    probs = torch.softmax(scaled, dim=-1)
    logp = torch.where(probs > 0, torch.log(probs.clamp(min=1e-30)),
                       torch.full_like(probs, NEG_INF))
    entropy = -torch.where(probs > 0, probs * logp,
                           torch.zeros_like(probs)).sum(-1, keepdim=True)
    dev = torch.where(probs > 0, (-logp - entropy).abs(),
                      torch.full_like(probs, float("inf")))
    order = torch.argsort(dev, dim=-1, stable=True)
    p_sorted = torch.gather(probs, -1, order)
    cum = torch.cumsum(p_sorted, dim=-1)
    keep_sorted = (cum - p_sorted) < typ
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    scaled = _masked_softmax_inputs(keep | (typ >= 1.0), scaled)
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < state.top_p[sid][:, None]
    scaled = _masked_softmax_inputs(keep, scaled)
    probs = torch.softmax(scaled, dim=-1)
    keep = probs >= probs[:, :1] * state.min_p[sid][:, None]
    scaled = _masked_softmax_inputs(keep, scaled)
    return torch.softmax(scaled, dim=-1)


def _mirostat_probs(state: SamplingState, slot_ids: torch.Tensor,
                    scaled: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mirostat v1/v2 truncation of the candidate distribution (the mu
    update happens in ``sample`` after the draw).

    v2: drop candidates whose surprise (-log2 p) exceeds mu.
    v1: estimate the Zipf exponent s_hat from the top candidates, derive
        k from (s_hat, mu, vocab), truncate to top-k."""
    sid = slot_ids.long()
    probs = torch.softmax(scaled, dim=-1)
    K = scaled.shape[-1]
    rank = torch.arange(K, device=scaled.device)[None, :]
    mu = state.mirostat_mu[sid][:, None]
    surprise = -torch.log2(probs.clamp(min=1e-30))
    keep_v2 = surprise <= mu
    m = min(100, K)
    i = torch.arange(m - 1, dtype=torch.float32, device=scaled.device)
    t = torch.log((i + 2.0) / (i + 1.0))[None, :]
    p_top = probs[:, :m].clamp(min=1e-30)
    b = torch.log(p_top[:, :-1] / p_top[:, 1:])
    s_hat = (t * b).sum(-1, keepdim=True) / (t * t).sum()
    eps = s_hat - 1.0
    # a fill, not a host-to-device copy: sample() runs inside the
    # engine's captured decode graphs
    n_f = torch.full((), float(vocab), dtype=torch.float32,
                     device=scaled.device)
    k1 = torch.pow(
        (eps * torch.pow(2.0, mu))
        / (1.0 - torch.pow(n_f, -eps)).clamp(min=1e-6),
        1.0 / s_hat.clamp(min=1e-6))
    k1 = torch.nan_to_num(k1, nan=1.0, posinf=float(K), neginf=1.0)
    keep_v1 = rank < torch.round(k1).clamp(1.0, float(K)).to(torch.int32)
    is_v1 = (state.mirostat[sid] == 1)[:, None]
    keep = torch.where(is_v1, keep_v1, keep_v2) | (rank == 0)
    return torch.softmax(_masked_softmax_inputs(keep, scaled), dim=-1)


def filtered_probs(state: SamplingState, slot_ids: torch.Tensor,
                   logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The candidate distribution ``sample`` draws from, after penalties
    are applied by the caller: (probs [B, K], vocab idx [B, K]). Mirostat
    rows use the mirostat truncation, greedy rows are a one-hot on the
    argmax."""
    V = logits.shape[-1]
    scaled, idx = _topk_scaled(state, slot_ids, logits)
    chain = _chain_probs(state, slot_ids, scaled)
    miro = state.mirostat[slot_ids.long()]
    probs = torch.where((miro > 0)[:, None],
                        _mirostat_probs(state, slot_ids, scaled, V), chain)
    return _greedy_one_hot(state, slot_ids, probs), idx


def _greedy_one_hot(state: SamplingState, slot_ids: torch.Tensor,
                    probs: torch.Tensor) -> torch.Tensor:
    """Greedy (temp <= 0) rows become a one-hot on the first candidate,
    the argmax (candidates are in descending order)."""
    temp = state.temperature[slot_ids.long()]
    rank = torch.arange(probs.shape[-1], device=probs.device)[None, :]
    greedy = (rank == 0).float().expand_as(probs)
    return torch.where((temp <= 0.0)[:, None], greedy, probs)


def filtered_candidates(state: SamplingState, slot_ids: torch.Tensor,
                        logits: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row candidate distribution after the temperature / top-k /
    typical-p / top-p / min-p chain: ``sample``'s pipeline minus
    penalties and mirostat (speculative decoding serves neither).
    Returns (probs [B, K], vocab idx [B, K]); temp <= 0 rows are an
    exact one-hot on the argmax. Speculative rejection sampling needs
    both models' distributions, not just a draw."""
    scaled, idx = _topk_scaled(state, slot_ids, logits)
    return _greedy_one_hot(state, slot_ids,
                           _chain_probs(state, slot_ids, scaled)), idx


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))


def gumbel_pick(probs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw of a candidate index from ``probs [..., K]`` with
    Gumbel ``noise`` of the same shape (zeros: the most probable)."""
    logp = torch.where(probs > 0, torch.log(probs.clamp(min=1e-30)),
                       torch.full_like(probs, NEG_INF))
    return torch.argmax(logp + noise, dim=-1)


@dataclass
class SpecDraws:
    """The random numbers of one speculative dispatch (``rounds`` rounds
    of ``kd`` draft tokens over B rows): Gumbel noise for each draft
    token's draw, uniforms for the acceptance tests, Gumbel noise for
    the replacement (residual or bonus) draws."""

    draft: torch.Tensor  # [rounds, kd, B, K]
    accept: torch.Tensor  # [rounds, B, kd - 1] uniforms in [0, 1)
    replace: torch.Tensor  # [rounds, B, kd, K]


def spec_draws(state: SamplingState, slot_ids: list[int],
               stochastic: list[bool], rounds: int, kd: int,
               k: int) -> SpecDraws:
    """A dispatch's draws from each row's slot generator, one call per
    row; rows not marked ``stochastic`` (greedy) draw nothing and get
    zeros, which keep their one-hot distributions exact."""
    B = len(slot_ids)
    per = rounds * (2 * kd * k + kd - 1)
    u = torch.zeros((B, per), dtype=torch.float32, device=state.device)
    for r, (s, draw) in enumerate(zip(slot_ids, stochastic)):
        if draw:
            u[r] = torch.rand((per,), generator=state.generators[s],
                              device=state.device)
    u = u.reshape(B, rounds, -1).transpose(0, 1)  # [rounds, B, ...]
    n = kd * k
    mask = torch.tensor(stochastic, device=state.device)[None, :, None]
    g = torch.where(mask, _gumbel(u), torch.zeros_like(u))
    return SpecDraws(
        draft=g[..., :n].reshape(rounds, B, kd, k).transpose(1, 2),
        accept=u[..., n:n + kd - 1],
        replace=g[..., n + kd - 1:].reshape(rounds, B, kd, k))


def spec_reject(p_probs: torch.Tensor, p_idx: torch.Tensor,
                q_probs: torch.Tensor, q_idx: torch.Tensor,
                drafted: torch.Tensor, q_drafted: torch.Tensor,
                accept: torch.Tensor, replace: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative rejection sampling (Leviathan et al.) over one round.

    p_probs, p_idx [B, kd, K]: the target's filtered candidates at each
    verify position; q_probs, q_idx [B, kd, K]: the draft's at each draft
    step; drafted [B, kd] the draft's tokens and q_drafted [B, kd] their
    q; accept [B, kd - 1] uniforms; replace [B, kd, K] Gumbel noise.
    Draft token i is accepted when u_i < min(1, p(d_i) / q(d_i)),
    cumulatively; the first rejection resamples from norm(max(p - q,
    0)) and the bonus position kd - 1 from p. Returns (replacement
    tokens [B, kd], emitted count j [B] in 1..kd): a row emits
    drafted[:j - 1] and then replacement[j - 1]."""
    kd = p_probs.shape[1]
    p_at_d = (p_probs * (p_idx == drafted[..., None])).sum(-1)
    ratio = p_at_d[:, :kd - 1] / q_drafted[:, :kd - 1].clamp(min=1e-30)
    ok = (accept < ratio.clamp(max=1.0)).to(torch.int32)
    j = 1 + torch.cumprod(ok, dim=1).sum(1)
    match = q_idx[:, :, :, None] == p_idx[:, :, None, :]  # [B, kd, K, K]
    q_on_p = (q_probs[:, :, :, None] * match).sum(2)
    residual = (p_probs - q_on_p).clamp(min=0.0)
    rsum = residual.sum(-1, keepdim=True)
    dist = torch.where(rsum > 1e-9, residual / rsum.clamp(min=1e-30),
                       p_probs)
    bonus = (torch.arange(kd, device=p_probs.device) == kd - 1)[
        None, :, None]
    dist = torch.where(bonus, p_probs, dist)
    pick = gumbel_pick(dist, replace)
    return torch.gather(p_idx, -1, pick[..., None])[..., 0], j


def gumbel_noise(state: SamplingState, slot_ids: list[int], k: int,
                 stochastic: list[bool]) -> torch.Tensor:
    """[B, k] Gumbel(0, 1) draws from each row's slot generator; rows not
    marked ``stochastic`` (greedy) draw nothing and get zeros."""
    out = torch.zeros((len(slot_ids), k), dtype=torch.float32,
                      device=state.device)
    for r, (s, draw) in enumerate(zip(slot_ids, stochastic)):
        if draw:
            u = torch.rand((k,), generator=state.generators[s],
                           device=state.device)
            out[r] = _gumbel(u)
    return out


def sample(state: SamplingState, slot_ids: torch.Tensor,
           logits: torch.Tensor, mask: Optional[torch.Tensor] = None,
           noise: Optional[torch.Tensor] = None
           ) -> tuple[torch.Tensor, SamplingState]:
    """Sample one token per row; returns ([B] i32 tokens, state).

    slot_ids [B] (distinct slots), logits [B, V] f32, mask [B, V] bool
    (True = allowed), noise [B, K] Gumbel draws (K = min(CAND, V)); when
    None they come from the slots' generators. Greedy when temperature
    <= 0. The token is recorded into the penalty window."""
    sid = slot_ids.long()
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    logits = _apply_penalties(
        logits, state.token_counts[sid], state.repeat_penalty[sid],
        state.freq_penalty[sid], state.presence_penalty[sid])
    probs, idx = filtered_probs(state, slot_ids, logits)
    temp = state.temperature[sid]
    greedy_tok = torch.argmax(logits, dim=-1)
    if noise is None:
        noise = gumbel_noise(state, slot_ids.tolist(), probs.shape[-1],
                             (temp > 0).tolist())
    j = gumbel_pick(probs, noise)  # Gumbel-max: a draw from probs
    sampled_tok = torch.gather(idx, -1, j[:, None])[:, 0]
    tok = torch.where(temp <= 0.0, greedy_tok, sampled_tok).to(torch.int32)
    # mirostat mu update: observed surprise (bits) of the drawn token,
    # mu -= eta * (observed - tau)
    p_drawn = torch.gather(probs, -1, j[:, None])[:, 0]
    observed = -torch.log2(p_drawn.clamp(min=1e-30))
    mu = state.mirostat_mu[sid]
    mu_new = mu - state.mirostat_eta[sid] * (observed - state.mirostat_tau[sid])
    state.mirostat_mu[sid] = torch.where(
        (state.mirostat[sid] > 0) & (temp > 0.0), mu_new, mu)
    observe_tokens(state, slot_ids, tok, torch.ones_like(tok, dtype=torch.bool))
    return tok, state
