"""LLM worker: one ``LLMEngine`` over one loaded checkpoint (counterpart
of localai_tfp_tpu/workers/llm.py::JaxLLMBackend, LLM path only).

A checkpoint is an HF directory (dense or mixture of experts) or a
``.gguf`` file, which brings its own tokenizer and chat template and no
vision tower. LoRA adapters merge at load, before ``quantization: int8``
quantizes the projections (the int8 artifact is then neither read nor
written, nor for a GGUF), and ``apply_lora`` / ``remove_lora`` merge or
unmerge one on the running engine, in place, between dispatches.

With ``LOCALAI_WEIGHT_PAGING`` (the default) the engine pages its weights
(engine/weight_pager.py): ``demote_weights`` moves them to host RAM (the
watchdog's demote mode), the next request promotes them, and an int8
artifact's host planes seed the pager's mirror so the first demotion
copies nothing off the device. With ``LOCALAI_DISAGG`` the engine is a
disaggregated pair behind a ``DisaggRouter`` (engine/kv_migrate.py): no
paging, one tree shared by both engines."""

from __future__ import annotations

import gc
import json
import os
import queue
import threading
import time
from typing import Any, Iterator, Optional

import torch

from ..config import knobs
from ..device import resolve
from ..engine.engine import GenRequest, LLMEngine, StreamEvent
from ..engine.jinja_lite import TemplateError
from ..engine.tokenizer import Tokenizer, load_tokenizer
from ..grammars.native import make_constraint
from ..models import artifact_cache, weight_slab
from ..models.gguf import GGUFFile, load_gguf_params, tokenizer_from_gguf
from ..models.hf_loader import load_params, spec_from_config
from ..models.llm_spec import LLMSpec
from ..models import load_timing
from ..models.load_timing import LoadPhases
from ..models.lora import merge_lora
from ..models.quant import leaves, quantize_params
from ..ops import _build, int8_matmul
from ..ops import ragged_paged_attention as rpa
from .base import (Backend, EmbeddingResult, ModelLoadOptions,
                   PredictOptions, Reply, Result, StatusResponse,
                   TokenizationResponse)

_DTYPES = {
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float32": torch.float32, "f32": torch.float32,
    # fp16 serves as bf16, as in the JAX package
    "float16": torch.bfloat16, "f16": torch.bfloat16,
}
# KV-cache-only dtypes: int8 rows with per-row scales
_KV_DTYPES = {**_DTYPES, "int8": torch.int8, "i8": torch.int8,
              "q8": torch.int8, "q8_0": torch.int8}
# weight-only quantization values (the JAX worker's): int8 aliases, and
# the names that mean "none"
_INT8 = ("int8", "q8", "q8_0", "w8", "int8_full")
_NO_QUANT = ("none", "f16", "fp16", "bf16", "bfloat16")


class TorchLLMBackend(Backend):
    """Serves chat completions for an HF checkpoint directory or a GGUF
    file."""

    def __init__(self, device: Any = None) -> None:
        self.device = resolve(device)
        self.engine: Optional[LLMEngine] = None
        self.tokenizer: Optional[Tokenizer] = None
        self.spec: Optional[LLMSpec] = None
        self._state = "UNINITIALIZED"
        self._lock = threading.Lock()
        # how the last load got its weights ("full", "quantized": int8 at
        # load, "artifact": the on-disk int8 tree), its wall seconds, and
        # of those the engine's warmup (every decode graph captured)
        self.load_mode = ""
        self.load_s = 0.0
        # the last load's wall seconds by phase (models/load_timing.py)
        self.phases = LoadPhases()
        # the last shutdown's device memory (card only): allocated bytes
        # when the engine's buffers were dropped, after gc.collect (the
        # share only a collection frees), and the allocator's and the
        # device-wide view (mem_get_info) after empty_cache
        self.unload_stats: Optional[dict] = None
        self._quantized = False  # int8 projections: no LoRA hot apply
        # an int8 artifact's host planes (models/artifact_cache.py
        # keep_host), handed to the weight pager as its mirror
        self._artifact_host: dict = {}
        # built grammar constraints by (grammar, triggers): building one
        # walks the whole vocabulary
        self._grammar_cache: dict[tuple, Any] = {}

    def load_model(self, opts: ModelLoadOptions) -> Result:
        with self._lock:
            quant = (opts.quantization or "").lower()
            if quant and quant not in _INT8 + _NO_QUANT:
                self._state = "ERROR"
                return Result(
                    False,
                    f"load failed: unsupported quantization "
                    f"'{opts.quantization}' (supported: int8, int8_full)")
            model_dir = opts.model
            if not os.path.isabs(model_dir):
                model_dir = os.path.join(opts.model_path or "", model_dir)
            is_gguf = model_dir.endswith(".gguf")
            if not (os.path.isfile(model_dir) if is_gguf
                    else os.path.isdir(model_dir)):
                self._state = "ERROR"
                return Result(False, f"load failed: model not found: "
                                     f"{model_dir}")
            name = (opts.dtype or "bfloat16").lower()
            kv_name = (opts.kv_cache_dtype or opts.dtype or "bfloat16").lower()
            if name not in _DTYPES or kv_name not in _KV_DTYPES:
                self._state = "ERROR"
                return Result(False, f"load failed: unsupported dtype "
                                     f"{name!r} / kv_cache_dtype {kv_name!r}")
            self.phases = LoadPhases()
            try:
                with load_timing.bind(self.phases):
                    return self._load(opts, model_dir, is_gguf, quant,
                                      name, kv_name)
            except (OSError, ValueError, NotImplementedError, KeyError,
                    RuntimeError, TemplateError) as e:
                self._state = "ERROR"
                return Result(False, f"load failed: {e}")

    def _load(self, opts: ModelLoadOptions, model_dir: str, is_gguf: bool,
              quant: str, name: str, kv_name: str) -> Result:
        """The load proper, its phases billed to ``self.phases``."""
        self._state = "BUSY"
        self._drop_engine()
        t0 = time.perf_counter()
        quant = quant if quant in _INT8 else ""
        # the tokenizer first: a file it cannot read (or a GGUF with no
        # vocabulary) fails the load before any weight is read
        if is_gguf:
            gf = GGUFFile(model_dir)
            self.tokenizer = tokenizer_from_gguf(gf)
            self.spec, params = self._load_gguf(gf, _DTYPES[name], quant,
                                                opts)
        else:
            self.tokenizer = load_tokenizer(model_dir)
            self.spec, params = self._load_weights(
                model_dir, _DTYPES[name], quant, opts)
        self._quantized = bool(quant)
        self._grammar_cache = {}
        artifact_host, self._artifact_host = self._artifact_host, {}
        draft = (self._load_draft(opts, _DTYPES[name])
                 if opts.draft_model else None)
        disagg = knobs.flag("LOCALAI_DISAGG") and draft is None
        with load_timing.phase("compile_s"):
            if self.device.type == "cuda":
                # the kernels' first-use nvcc build (and the weight
                # slab's), here rather than inside the first capture
                _build.build_all([rpa.KERNEL] + (
                    [int8_matmul.KERNEL] if quant else []) + (
                    [weight_slab.KERNEL] if knobs.flag(
                        "LOCALAI_WEIGHT_PAGING") else []))
            self.engine = LLMEngine(
                self.spec, params, self.tokenizer,
                n_slots=max(1, opts.batch_slots),
                max_seq=opts.context_size,
                cache_dtype=_KV_DTYPES[kv_name],
                draft=draft, n_draft=opts.n_draft or 4,
                device=self.device, model=opts.model,
                # a disaggregated pair shares one tree by reference:
                # paging it would strand the other engine's dispatches
                weight_paging=False if disagg else None)
        pager = self.engine._pager
        if pager is not None and artifact_host:
            # the artifact's host planes mirror the tree exactly (an
            # artifact load merges no adapter)
            pager.seed_host(artifact_host, self.engine.params)
        del artifact_host
        if disagg:
            # a prefill-tuned sibling shares the weights, and the router
            # relays long prompts through KV page migration
            from ..engine.kv_migrate import DisaggRouter, build_prefill_engine

            with load_timing.phase("disagg_s"):
                prefill = build_prefill_engine(
                    self.spec, params, self.tokenizer, decode=self.engine,
                    cache_dtype=_KV_DTYPES[kv_name], device=self.device)
                self.engine = DisaggRouter(prefill, self.engine)
                prefill.start()
        if knobs.flag("LOCALAI_WARMUP"):
            # capture the decode graphs now: a capture landing
            # mid-request would stall every decoding slot
            with load_timing.phase("warmup_s"):
                self.engine.warmup()
        self.load_s = time.perf_counter() - t0
        self._state = "READY"
        return Result(True, "model loaded")

    def _adapt(self, spec: LLMSpec, params: dict, quant: str,
               opts: ModelLoadOptions) -> dict:
        """Freshly loaded full-precision ``params`` with the config's LoRA
        adapters merged (a relative path is under ``model_path``; a scale
        of 0 skips its adapter, a missing one is 1.0), then, for
        ``quant``, the projections quantized."""
        for i, adir in enumerate(opts.lora_adapters):
            if not os.path.isabs(adir):
                adir = os.path.join(opts.model_path or "", adir)
            scale = (float(opts.lora_scales[i])
                     if i < len(opts.lora_scales) else 1.0)
            if scale == 0.0:
                continue
            params, _ = merge_lora(spec, params, adir, scale=scale,
                                   inplace=True)
        self.load_mode = "full"
        if quant:
            with load_timing.phase("dequant_s", self.device):
                params = quantize_params(params, embeddings=(
                    artifact_cache.canonical_quant(quant) == "int8_full"))
            self.load_mode = "quantized"
        return params

    def _load_gguf(self, gf: GGUFFile, dtype: torch.dtype, quant: str,
                   opts: ModelLoadOptions) -> tuple[LLMSpec, dict]:
        """(spec, params) of a GGUF file, dequantized on the device,
        adapters merged, then (int8) the projections quantized; no
        artifact, as in the JAX package."""
        spec, params = load_gguf_params(gf.path, dtype=dtype,
                                        device=self.device, gf=gf)
        return spec, self._adapt(spec, params, quant, opts)

    def _load_weights(self, model_dir: str, dtype: torch.dtype,
                      quant: str, opts: ModelLoadOptions
                      ) -> tuple[LLMSpec, dict]:
        """(spec, params): full precision, or int8 from the on-disk
        artifact when there is one, else quantized while loading and then
        written as the artifact for the next load. With LoRA adapters the
        weights load full precision, the adapters merge, then the
        projections quantize, and no artifact is read or written."""
        if not quant or opts.lora_adapters:
            spec, params = load_params(model_dir, dtype=dtype,
                                       device=self.device)
            return spec, self._adapt(spec, params, quant, opts)
        mode = artifact_cache.canonical_quant(quant)
        path = artifact_cache.artifact_path(
            model_dir, mode, str(dtype).removeprefix("torch."))
        keep: dict = {}
        params = artifact_cache.try_load(path, self.device, keep_host=keep)
        if params is not None:
            self._artifact_host = keep
            with open(os.path.join(model_dir, "config.json")) as f:
                spec = spec_from_config(json.load(f))
            if "lm_head" not in params:  # the checkpoint tied its head
                object.__setattr__(spec, "tie_word_embeddings", True)
            self.load_mode = "artifact"
            return spec, params
        spec, params = load_params(model_dir, dtype=dtype,
                                   device=self.device, quantize=mode)
        artifact_cache.save(path, params)
        self.load_mode = "quantized"
        return spec, params

    def _load_draft(self, opts: ModelLoadOptions,
                    dtype: torch.dtype) -> tuple[LLMSpec, dict]:
        """The speculative-decoding draft: an HF checkpoint directory or
        a GGUF file (a relative path is under ``model_path``) at the
        target's dtype, never quantized, as the JAX worker loads it. A
        draft that cannot be loaded fails the model's load: a config that
        names a draft is never served without it."""
        ddir = opts.draft_model
        if not os.path.isabs(ddir):
            ddir = os.path.join(opts.model_path or "", ddir)
        if ddir.endswith(".gguf"):
            if not os.path.isfile(ddir):
                raise ValueError(f"draft model not found: {ddir}")
            return load_gguf_params(ddir, dtype=dtype, device=self.device)
        if not os.path.isdir(ddir):
            raise ValueError(f"draft model not found: {ddir}")
        return load_params(ddir, dtype=dtype, device=self.device)

    def apply_lora(self, adapter_dir: str, scale: float = 1.0) -> int:
        """Merge a LoRA adapter into the running engine's weights, in
        place between two dispatches: the captured graphs read the new
        weights from the next dispatch on. Returns the projection sites
        touched. Refused on int8 weights."""
        return self._hot_lora(adapter_dir, scale, 1.0)

    def remove_lora(self, adapter_dir: str, scale: float = 1.0) -> int:
        """Unmerge an adapter applied with the same scale."""
        return self._hot_lora(adapter_dir, scale, -1.0)

    def _hot_lora(self, adapter_dir: str, scale: float, sign: float) -> int:
        eng, spec = self.engine, self.spec
        if eng is None or spec is None:
            raise RuntimeError("model not loaded")
        if self._quantized:
            raise RuntimeError(
                "LoRA hot-apply needs full-precision weights; load the "
                "model without quantization (or restart with the adapter "
                "in lora_adapters, which merges before quantizing)")
        # update_params is the swap hook: a warm tree is promoted and held
        # on the device first, the pager's stale mirror dropped after
        return eng.update_params(lambda params: merge_lora(
            spec, params, adapter_dir, scale=scale, sign=sign,
            inplace=True)[1])

    @property
    def load_breakdown(self) -> dict:
        """The last load's wall seconds by phase, the JAX worker's keys
        (the loader folds the phases into
        ``model_load_phase_seconds_total``). The port keeps no persistent
        compile cache, so ``warmup_reused`` is always False."""
        return {**self.phases.as_dict(total_s=self.load_s),
                "load_mode": self.load_mode, "warmup_reused": False}

    def _drop_engine(self) -> None:
        """Stop the engine's scheduler (its slots end with an error
        event), then drop its device buffers and every reference the
        worker holds to them."""
        eng, self.engine = self.engine, None
        self._grammar_cache = {}
        if eng is not None:
            eng.close()
            eng.release()

    def shutdown(self) -> None:
        """Unload: the device memory is back with the caching allocator,
        and on a card with the device (``empty_cache``), when this
        returns."""
        with self._lock:
            self._drop_engine()
            self.tokenizer = None
            self._state = "UNINITIALIZED"
            if self.device.type == "cuda":
                dev = self.device
                torch.cuda.synchronize(dev)
                before_gc = torch.cuda.memory_allocated(dev)
                gc.collect()
                after_gc = torch.cuda.memory_allocated(dev)
                torch.cuda.empty_cache()
                free, total = torch.cuda.mem_get_info(dev)
                self.unload_stats = {
                    "allocated_before_gc": before_gc,
                    "allocated_after_gc": after_gc,
                    "reserved_after": torch.cuda.memory_reserved(dev),
                    "device_used_after": total - free}

    def health(self) -> bool:
        return self._state in ("READY", "BUSY")

    def status(self) -> StatusResponse:
        """State and the engine's device bytes (``/backend/monitor``).
        With a weight pager the tree's bytes come from its counts (no
        weight is read: a warm tree is not on the device), split into
        ``weights_hot_bytes`` and ``weights_warm_bytes``."""
        mem: dict[str, int] = {}
        eng = self.engine
        if eng is not None:
            mem["kv_cache_bytes"] = eng.cache.nbytes()
            pager = eng._pager
            if pager is not None:
                mem["params_bytes"] = pager.device_bytes()
                mem["weights_hot_bytes"] = pager.device_bytes()
                mem["weights_warm_bytes"] = pager.host_bytes()
            else:
                mem["params_bytes"] = sum(
                    t.numel() * t.element_size()
                    for v in eng.params.values() for t in leaves(v))
        return StatusResponse(state=self._state, memory=mem)

    def demote_weights(self) -> Optional[str]:
        """Page this model's weights out to host RAM (the watchdog's
        demote mode). Returns "demoted" (a demotion started), "busy" (a
        transition is in flight, or the engine has work), "warm" (already
        paged out), or None (no pager: paging off, a draft, a
        disaggregated pair)."""
        pager = getattr(self.engine, "_pager", None)
        if pager is None:
            return None
        st = pager.state
        if st == "hot":
            return ("demoted" if pager.request_demote(reason="watchdog")
                    else "busy")
        if st in ("demoting", "promoting"):
            return "busy"
        return "warm"

    def weight_residency(self) -> Optional[dict]:
        """The pager's snapshot (None when this engine does not page)."""
        pager = getattr(self.engine, "_pager", None)
        return None if pager is None else pager.stats()

    def embedding(self, opts: PredictOptions) -> EmbeddingResult:
        """The mean-pooled final hidden state of ``opts.embeddings`` (or
        the prompt): ``LLMEngine.embed``."""
        eng = self.engine
        if eng is None:
            raise RuntimeError("model not loaded")
        vec = eng.embed(opts.embeddings or opts.prompt)
        return EmbeddingResult(embeddings=vec.tolist())

    def _to_request(self, opts: PredictOptions) -> GenRequest:
        assert self.tokenizer is not None
        constraint = None
        if opts.grammar:
            key = (opts.grammar, tuple(opts.grammar_triggers or ()))
            constraint = self._grammar_cache.get(key)
            if constraint is None:
                constraint = make_constraint(opts.grammar, self.tokenizer,
                                             triggers=opts.grammar_triggers)
                if len(self._grammar_cache) < 32:
                    self._grammar_cache[key] = constraint
        return GenRequest(
            prompt_ids=self.tokenizer.encode(opts.prompt, add_bos=True),
            max_tokens=opts.tokens or 2048,
            temperature=opts.temperature,
            top_k=opts.top_k,
            top_p=opts.top_p,
            min_p=opts.min_p,
            repeat_penalty=opts.repeat_penalty,
            repeat_last_n=opts.repeat_last_n,
            frequency_penalty=opts.frequency_penalty,
            presence_penalty=opts.presence_penalty,
            typical_p=opts.typical_p if opts.typical_p > 0 else 1.0,
            mirostat=opts.mirostat,
            mirostat_tau=opts.mirostat_tau if opts.mirostat_tau > 0 else 5.0,
            mirostat_eta=opts.mirostat_eta if opts.mirostat_eta > 0 else 0.1,
            seed=opts.seed,
            stop=list(opts.stop_prompts),
            ignore_eos=opts.ignore_eos,
            logit_bias=opts.logit_bias or None,
            constraint=constraint,
            correlation_id=opts.correlation_id,
            timeout_s=max(0.0, opts.timeout_s),
            prompt_cache_path=opts.prompt_cache_path,
            prompt_cache_all=opts.prompt_cache_all,
            prompt_cache_ro=opts.prompt_cache_ro,
            **({"id": opts.request_id} if opts.request_id else {}),
        )

    def cancel(self, request_id: str) -> None:
        if self.engine is not None:
            self.engine.cancel(request_id)

    def tokenize_string(self, opts: PredictOptions) -> TokenizationResponse:
        """The prompt's ids, no BOS (``/v1/tokenize``)."""
        if self.tokenizer is None:
            return TokenizationResponse()
        ids = self.tokenizer.encode(opts.prompt)
        return TokenizationResponse(length=len(ids), tokens=ids)

    def engine_stats(self) -> Optional[dict]:
        """The engine's counters, the compiled decode's, the cost
        model's and the HBM ledger's snapshots (host-held values only)."""
        eng = self.engine
        if eng is None:
            return None
        m = eng.metrics
        reused, filled = m.prefix_reused_tokens, m.prefill_tokens
        return {
            "requests_completed": m.requests_completed,
            "tokens_generated": m.tokens_generated,
            "prompt_tokens_processed": m.prompt_tokens_processed,
            "forward_steps": m.forward_steps,
            "decode_steps": m.decode_steps,
            "spec_tokens": m.spec_tokens,
            "spec_dispatches": m.spec_dispatches,
            "prefix_cache": {
                "reused_tokens": reused,
                "prefilled_tokens": filled,
                "copies": m.prefix_copies,
                "hit_rate": round(reused / max(reused + filled, 1), 4),
            },
            "graph_replays": m.graph_replays,
            "masked_replays": m.masked_replays,
            "mixed_replays": m.mixed_replays,
            "spec_replays": m.spec_replays,
            "graph_variants": eng.variant_count(),
            # pad tokens the mixed variants added, over the real tokens
            "mixed_padded_share": round(
                m.mixed_pad_tokens / max(m.mixed_tokens, 1), 4),
            # token buckets chosen by cost packing (ITL budget), by bucket
            "cost_buckets": dict(sorted(eng.cost_buckets.items())),
            "warmup_s": m.warmup_s,
            "costmodel": eng.cost_stats(),
            "hbm": eng.hbm_stats(),
            "kv_tier": eng.tier_stats(),
            "weights": self.weight_residency(),
        }

    def predict(self, opts: PredictOptions) -> Reply:
        if self.engine is None:
            return Reply(error="model not loaded", finish_reason="error")
        return final_reply(self.engine.generate(self._to_request(opts)))

    def stream_queue(self, opts: PredictOptions) -> queue.SimpleQueue:
        """Submit and return the engine's raw event queue (the HTTP layer
        peeks at it for an immediate shed before it sends headers)."""
        if self.engine is None:
            raise RuntimeError("model not loaded")
        return self.engine.submit(self._to_request(opts))

    def predict_stream(self, opts: PredictOptions) -> Iterator[Reply]:
        if self.engine is None:
            yield Reply(error="model not loaded", finish_reason="error")
            return
        q = self.stream_queue(opts)
        while True:
            ev: StreamEvent = q.get()
            if ev.done:
                yield final_reply(ev)
                return
            if ev.text:
                yield Reply(message=ev.text, token_id=ev.token_id)


def final_reply(ev: StreamEvent) -> Reply:
    return Reply(
        message=ev.full_text,
        tokens=ev.completion_tokens,
        prompt_tokens=ev.prompt_tokens,
        timing_prompt_processing=ev.timing_prompt_processing_ms,
        timing_token_generation=ev.timing_token_generation_ms,
        timing_queue=ev.timing_queue_ms,
        timing_first_token=ev.timing_first_token_ms,
        finish_reason=ev.finish_reason,
        error=ev.error,
        retry_after_s=ev.retry_after_s,
    )
