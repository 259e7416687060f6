"""Per-dispatch FLOPs/bytes accounting, the MFU gauge and the device-time
predictor (counterpart of localai_tfp_tpu/telemetry/costmodel.py).

The contract is the reference's: a table of cost rows keyed by
``dispatch_key``, host-held totals exported as
``engine_device_flops_total{kind}`` / ``engine_device_bytes_total{kind}``,
flight kinds accounted at HARVEST where their device span is known, an
EWMA MFU

    mfu = flops / (span_seconds * peak_flops * n_devices)

and ``predict_ms`` — the roofline bound scaled by a two-level
(variant, then kind) calibration EWMA of measured span / bound, with the
reference's alpha 0.2, three-sample floor and 4x winsorization.

What differs, because there is no XLA to ask:

- a row is not read from ``compiled.cost_analysis()``. ``ModelCost``
  works it out from the model's ``LLMSpec``, the parameter bytes as
  stored (int8 planes and their scales counted as they lie in memory),
  the dispatch's rows and their live context: attention FLOPs count the
  positions each query attends, KV bytes the pages each row reads. So a
  row moves with the context, and ``capture`` records each dispatch's
  own row under its key before the dispatch runs; ``predict_ms`` then
  predicts that dispatch;
- the peak table is keyed by the device's name
  (``torch.cuda.get_device_name``, or ``"cpu"``), not by a jax
  platform; ``LOCALAI_PEAK_FLOPS`` / ``LOCALAI_PEAK_HBM_GBS`` override
  it as in the reference;
- spans come from a pair of CUDA events per dispatch, read after the
  engine's one host read of the dispatch's tokens (on the CPU, the host
  clock around the dispatch: the CPU is the device there).
"""

from __future__ import annotations

import ast
import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence

from ..config import knobs

__all__ = ["CostModel", "ModelCost", "dispatch_key", "peak_rates",
           "analytic_flops_per_token", "FLIGHT_KINDS"]

# kinds whose span is measured, so they account at harvest (the port
# times every dispatch it makes)
FLIGHT_KINDS = frozenset({"mixed", "decodek", "spec", "spec_s"})

# (name substring, peak dense FLOP/s, peak memory bytes/s) per device,
# first match wins. NVIDIA's data sheets, SXM parts, bf16 dense tensor
# core rates. The CPU row is the reference's (a laptop-class core,
# ridge 1 flop/byte), so the tiny CPU test models sit on both sides of
# the ridge as they do there.
_PEAK_TABLE: tuple[tuple[str, float, float], ...] = (
    ("h200", 989e12, 4.8e12),
    ("h100", 989e12, 3.35e12),
    ("cpu", 50e9, 50e9),
)

_EWMA_ALPHA = 0.2

# calibration harvests of a kind before predict_ms() trusts its EWMA;
# below it the bare analytic roofline bound is the prediction (a cold
# EWMA from one outlier span would poison every early prediction)
_CALIB_MIN_SAMPLES = 3

# winsorization bound for calibration samples: measured spans include
# host-side noise, and one 20x outlier shifts an alpha-0.2 EWMA by 4x —
# clip each sample to within this factor of the trusted estimate so a
# spike nudges the EWMA instead of poisoning it
_CALIB_CLIP = 4.0


def peak_rates(platform: str) -> tuple[float, float]:
    """(peak FLOP/s, peak bytes/s) per device — knob overrides first,
    then the device table, then the CPU row."""
    flops = knobs.float_("LOCALAI_PEAK_FLOPS")
    bw = knobs.float_("LOCALAI_PEAK_HBM_GBS") * 1e9
    name = platform.lower()
    row = next((r for r in _PEAK_TABLE if r[0] in name), _PEAK_TABLE[-1])
    return (flops if flops > 0 else row[1], bw if bw > 0 else row[2])


def dispatch_key(kind: str, payload: dict) -> tuple:
    """The signature of one dispatch's variant. ``mixed``: (kind, (row
    bucket, token bucket)), the variant's padded shape; ``decodek``:
    (kind, k, row bucket) — one CUDA graph per bucket, replayed k times
    — and ``"masked"`` last for a masked step's own graph; ``spec`` /
    ``spec_s``: (kind, n_draft, rounds)."""
    p = payload
    if kind == "mixed":
        return (kind, tuple(p["shape"]))
    if kind == "decodek":
        return (kind, p["k"], p["bucket"]) + (
            ("masked",) if p.get("masked") else ())
    if kind in ("spec", "spec_s"):
        return (kind, p.get("kd"), p.get("rounds"))
    return (kind,)


def analytic_flops_per_token(params: Any) -> float:
    """First-principles decode FLOPs/token: 2 x matrix params (every
    leaf of two or more dimensions, both planes of an int8 leaf — one
    multiply-accumulate per weight per token), as the reference counts
    its tree's leaves."""
    from ..models.quant import leaves

    return 2.0 * float(sum(int(t.numel()) for v in params.values()
                           for t in leaves(v) if t.dim() >= 2))


def _attended(ctx: int, q: int, window: int) -> int:
    """Keys attended by q queries at positions ctx .. ctx + q - 1, each
    attending min(pos + 1, window) keys (window 0: no window)."""
    lo, hi = ctx + 1, ctx + q  # each query's causal key count
    if not window or hi <= window:
        return (lo + hi) * q // 2
    if lo >= window:
        return q * window
    return (lo + window) * (window - lo + 1) // 2 + (hi - window) * window


@dataclass(frozen=True)
class ModelCost:
    """Analytic FLOPs and bytes of one forward of one model."""

    n_layers: int
    matmul_params: int  # projection weights of one layer (multiplies)
    attn_width: int  # n_heads * d_head
    windows: tuple[int, ...]  # each layer's sliding window (0: none)
    vocab: int
    d_model: int
    layer_bytes: int  # every per-layer leaf of every layer, as stored
    head_bytes: int  # the LM head (the embedding when tied) and its bias
    # + the final norm
    embed_row_bytes: int  # one embedding row, as stored
    kv_token_bytes: int  # K and V (and int8 scales) of a token, one layer
    page: int

    @classmethod
    def of(cls, spec: Any, params: dict, cache: Any,
           page: int) -> "ModelCost":
        from ..models.quant import leaves
        from ..models.transformer import _NON_LAYER_KEYS, layer_windows

        def nbytes(v) -> int:
            return sum(t.numel() * t.element_size() for t in leaves(v))

        head = params["embed"] if spec.tie_word_embeddings \
            else params["lm_head"]
        emb = leaves(params["embed"])
        per_token = 2 * spec.kv_dim * cache.k.element_size()
        if cache.k_scale is not None:
            per_token += 2 * cache.k_scale.element_size()
        d, qd, kvd = spec.d_model, spec.q_dim, spec.kv_dim
        mlp = (3 if spec.gated_mlp else 2) * d * spec.d_ff
        if spec.n_experts:  # the dense formulation: every expert runs
            E, L = spec.n_experts, spec.n_layers
            shared = (3 * d * (spec.moe_shared_d_ff or spec.d_ff) + d
                      if spec.moe_shared_expert else 0)
            sparse = d * E + 3 * d * (spec.moe_d_ff or spec.d_ff) * E
            dense = len(set(spec.moe_dense_layers))
            mlp = ((L - dense) * sparse + L * shared) // L
        return cls(
            n_layers=spec.n_layers,
            matmul_params=d * qd + 2 * d * kvd + qd * d + mlp,
            attn_width=qd, windows=tuple(layer_windows(spec)),
            vocab=spec.vocab_size, d_model=d,
            layer_bytes=sum(nbytes(v) for k, v in params.items()
                            if k not in _NON_LAYER_KEYS),
            head_bytes=nbytes(head) + sum(
                nbytes(params[k]) for k in ("final_norm_w", "final_norm_b",
                                            "lm_head_b") if k in params),
            embed_row_bytes=sum(t[0].numel() * t.element_size()
                                for t in emb),
            kv_token_bytes=per_token, page=page)

    def forward(self, rows: Sequence[tuple[int, int]], head_rows: int,
                tokens: Optional[int] = None) -> tuple[float, float]:
        """(FLOPs, bytes) of one forward over ``rows`` — (positions
        already in the arena, tokens of this forward) per real row —
        with ``head_rows`` rows through the LM head; ``tokens`` (default:
        the rows' own) is the token count the projections run over, a
        padded variant's rows x token bucket. Bytes: the weights once,
        the embedding rows gathered, the KV pages each row reads (each
        layer, within that layer's window), the new K/V written, the
        logits written."""
        L, P = self.n_layers, self.page
        n = sum(q for _, q in rows) if tokens is None else tokens
        keys = pages = 0
        for w in set(self.windows):  # layers that share a window
            layers = self.windows.count(w)
            keys += layers * sum(_attended(c, q, w) for c, q in rows)
            for c, q in rows:  # the first query sees from c + 1 - w
                start = max(0, c + 1 - w) if w else 0
                pages += layers * (-(-(c + q) // P) - start // P)
        flops = (2.0 * n * self.matmul_params * L
                 + 4.0 * self.attn_width * keys
                 + 2.0 * head_rows * self.d_model * self.vocab)
        by = (self.layer_bytes + n * self.embed_row_bytes
              + self.kv_token_bytes * (pages * P + L * n)
              + (self.head_bytes + 4 * head_rows * self.vocab
                 if head_rows else 0))
        return flops, float(by)


class CostModel:
    """Per-engine dispatch cost table + host-held accounting.

    Thread contract: ``capture`` / ``on_dispatch`` / ``on_harvest`` run
    on the engine thread; ``stats`` / ``roofline`` / ``predict_ms`` may
    be called from any thread (the single lock covers the tables).
    """

    def __init__(self, model: str, platform: str,
                 n_devices: int = 1) -> None:
        self.model = model
        self.platform = platform
        self.n_devices = max(1, int(n_devices))
        self._lock = threading.Lock()
        # (kind, sig) -> (flops, bytes)
        self._table: dict[tuple, tuple[float, float]] = {}
        # kind -> [flops, bytes, dispatches]
        self._totals: dict[str, list[float]] = {}
        self._mfu: Optional[float] = None  # EWMA, None until 1st sample
        self._mfu_samples = 0
        # kind -> [measured/analytic EWMA, samples]: the per-kind
        # calibration predict_ms() multiplies onto the analytic bound
        self._calib: dict[str, list] = {}
        # (kind, sig) -> [measured/analytic EWMA, samples]: a variant
        # that has harvested predicts from its own ratio, cold variants
        # borrow the kind's
        self._calib_var: dict[tuple, list] = {}

    # ------------------------------------------------------- capture

    def capture(self, key: tuple, flops: float, bytes_: float) -> None:
        """Record the analytic cost row of the dispatch about to run
        under ``key`` (a row moves with the live context, so the newest
        dispatch's row replaces the last)."""
        with self._lock:
            self._table[key] = (float(flops), float(bytes_))

    def export_rows(self) -> dict[str, tuple[float, float]]:
        """JSON-serializable snapshot of the cost table. Dispatch keys
        are tuples of primitives, so ``repr`` round-trips through
        ``ast.literal_eval`` in :meth:`import_rows`."""
        with self._lock:
            return {repr(k): v for k, v in self._table.items()}

    def import_rows(self, rows: dict) -> int:
        """Load exported cost rows. Existing rows win; returns rows
        added."""
        added = 0
        with self._lock:
            for rk, v in rows.items():
                try:
                    key = ast.literal_eval(rk)
                    flops, by = float(v[0]), float(v[1])
                except (ValueError, SyntaxError, TypeError, IndexError):
                    continue
                if not isinstance(key, tuple) or key in self._table:
                    continue
                self._table[key] = (flops, by)
                added += 1
        return added

    # ---------------------------------------------------- accounting

    def _account(self, kind: str, key: Optional[tuple]) -> float:
        """Add one dispatch of ``key`` to the totals; returns its flops
        (0 when the key has no row)."""
        if key is None:
            return 0.0
        with self._lock:
            row = self._table.get(key)
            if row is None:
                return 0.0
            t = self._totals.setdefault(kind, [0.0, 0.0, 0.0])
            t[0] += row[0]
            t[1] += row[1]
            t[2] += 1.0
            flops = row[0]
        from . import metrics as tm

        tm.ENGINE_DEVICE_FLOPS.labels(model=self.model,
                                      kind=kind).inc(row[0])
        tm.ENGINE_DEVICE_BYTES.labels(model=self.model,
                                      kind=kind).inc(row[1])
        return flops

    def on_dispatch(self, kind: str, key: Optional[tuple]) -> None:
        """Account a dispatch whose span is not measured."""
        self._account(kind, key)

    def on_harvest(self, kind: str, key: Optional[tuple],
                   span_s: float,
                   predicted_ms: Optional[float] = None) -> None:
        """Account a harvested dispatch and fold an MFU sample into the
        EWMA (its device span is the denominator). The span also
        calibrates the device-time predictor for this kind and variant,
        and a dispatch that carried a prediction lands on the two
        predicted-vs-measured histograms."""
        flops = self._account(kind, key)
        if flops <= 0.0 or span_s <= 0.0:
            return
        peak_flops, _ = peak_rates(self.platform)
        sample = min(1.0, flops / (span_s * peak_flops * self.n_devices))
        span_ms = span_s * 1e3
        with self._lock:
            if self._mfu is None:
                self._mfu = sample
            else:
                self._mfu += _EWMA_ALPHA * (sample - self._mfu)
            self._mfu_samples += 1
            mfu = self._mfu
            base = self._analytic_ms_locked(key)
            if base is not None and base > 0.0:
                ratio = span_ms / base
                kc = self._calib.get(kind)
                anchor = (kc[0] if kc is not None
                          and kc[1] >= _CALIB_MIN_SAMPLES else None)
                for table, ck in ((self._calib, kind),
                                  (self._calib_var, key)):
                    c = table.get(ck)
                    # winsorize against this entry's own trusted EWMA,
                    # else the kind's
                    ref = (c[0] if c is not None and c[1] >= 2
                           else anchor)
                    r = ratio if ref is None else min(
                        max(ratio, ref / _CALIB_CLIP), ref * _CALIB_CLIP)
                    if c is None:
                        table[ck] = [r, 1]
                    else:
                        c[0] += _EWMA_ALPHA * (r - c[0])
                        c[1] += 1
        from . import metrics as tm

        tm.ENGINE_MFU.labels(model=self.model).set(mfu)
        if predicted_ms is not None and predicted_ms > 0.0:
            tm.ENGINE_DISPATCH_PREDICTED.labels(
                model=self.model, kind=kind).observe(predicted_ms / 1e3)
            tm.ENGINE_DISPATCH_PREDICTED_RATIO.labels(
                model=self.model, kind=kind).observe(
                    predicted_ms / span_ms)

    # ------------------------------------------------------ prediction

    def _analytic_ms_locked(self, key: Optional[tuple]
                            ) -> Optional[float]:
        """Roofline lower bound on device ms for one dispatch of
        ``key``: whichever of the compute or bandwidth terms dominates.
        None when the key has no row. Caller holds self._lock."""
        if key is None:
            return None
        row = self._table.get(key)
        if row is None:
            return None
        flops, by = row
        peak_flops, peak_bw = peak_rates(self.platform)
        t_s = max(flops / (peak_flops * self.n_devices),
                  by / (peak_bw * self.n_devices))
        return t_s * 1e3 if t_s > 0.0 else None

    def predict_ms(self, kind: str, key: Optional[tuple]
                   ) -> Optional[float]:
        """Predicted device ms for one dispatch of ``key``: the analytic
        roofline bound scaled by the variant's own calibration EWMA once
        it has harvested twice, else the kind-level EWMA once it has
        ``_CALIB_MIN_SAMPLES`` harvests, else the bare bound; ``None``
        for a key without a row."""
        with self._lock:
            base = self._analytic_ms_locked(key)
            if base is None:
                return None
            cv = self._calib_var.get(key)
            if cv is not None and cv[1] >= 2:
                return base * cv[0]
            c = self._calib.get(kind)
            if c is not None and c[1] >= _CALIB_MIN_SAMPLES:
                return base * c[0]
        return base

    def decode_step_ms(self) -> Optional[float]:
        """Predicted per-token decode ms: the cheapest decodek row
        amortized over its k steps. None until a decodek row exists."""
        with self._lock:
            keys = [k for k in self._table if k[0] == "decodek"]
        best: Optional[float] = None
        for key in keys:
            p = self.predict_ms("decodek", key)
            if p is None:
                continue
            per = p / max(1, int(key[1]))
            if best is None or per < best:
                best = per
        return best

    def prefill_token_ms(self) -> Optional[float]:
        """Predicted per-token prefill ms: the best (most amortized)
        prefill-shaped row divided by its token capacity. Optimistic by
        construction."""
        with self._lock:
            keys = list(self._table)
        best: Optional[float] = None
        for key in keys:
            kind = key[0]
            if kind == "prefill_final":
                tokens = int(key[1]) * int(key[2])
            elif kind == "mixed":
                tokens = int(key[1][0]) * int(key[1][1])
            elif kind == "prefill":
                tokens = int(key[1])
            else:
                continue
            p = self.predict_ms(kind, key)
            if p is None or tokens <= 0:
                continue
            per = p / tokens
            if best is None or per < best:
                best = per
        return best

    # ------------------------------------------------------ summaries

    @property
    def mfu(self) -> Optional[float]:
        with self._lock:
            return self._mfu

    def roofline(self) -> dict[str, dict]:
        """Per-kind roofline summary: accounted totals, arithmetic
        intensity, and compute- vs bandwidth-bound classification
        against the machine balance point. Kinds with traffic use
        accounted totals; kinds only ever captured fall back to their
        rows."""
        peak_flops, peak_bw = peak_rates(self.platform)
        ridge = peak_flops / max(peak_bw, 1.0)
        with self._lock:
            per_kind: dict[str, list[float]] = {
                k: list(v) for k, v in self._totals.items()}
            with_traffic = set(per_kind)
            for (kind, *_), (fl, by) in self._table.items():
                if kind in with_traffic:
                    continue
                t = per_kind.setdefault(kind, [0.0, 0.0, 0.0])
                t[0] += fl
                t[1] += by
        out: dict[str, dict] = {}
        for kind, (fl, by, n) in sorted(per_kind.items()):
            intensity = fl / by if by > 0 else 0.0
            out[kind] = {
                "flops": fl,
                "bytes": by,
                "dispatches": int(n),
                "intensity_flops_per_byte": round(intensity, 3),
                "bound": ("compute" if intensity >= ridge
                          else "bandwidth"),
            }
        return out

    def stats(self) -> dict:
        """Host-held summary for the worker's stats."""
        peak_flops, peak_bw = peak_rates(self.platform)
        with self._lock:
            mfu = self._mfu
            samples = self._mfu_samples
            variants = len(self._table)
            calib = {k: {"ewma": round(c[0], 4), "samples": int(c[1]),
                         "warm": c[1] >= _CALIB_MIN_SAMPLES}
                     for k, c in sorted(self._calib.items())}
            variants_calibrated = sum(
                1 for c in self._calib_var.values() if c[1] >= 2)
        return {
            "platform": self.platform,
            "n_devices": self.n_devices,
            "peak_flops_per_device": peak_flops,
            "peak_hbm_bytes_s_per_device": peak_bw,
            "ridge_flops_per_byte": round(
                peak_flops / max(peak_bw, 1.0), 3),
            "mfu_ewma": round(mfu, 6) if mfu is not None else None,
            "mfu_samples": samples,
            "variants_captured": variants,
            "calibration": calib,
            "variants_calibrated": variants_calibrated,
            "predicted_decode_step_ms": self.decode_step_ms(),
            "predicted_prefill_token_ms": self.prefill_token_ms(),
            "kinds": self.roofline(),
        }
