"""LLM worker: one ``LLMEngine`` over one loaded checkpoint (counterpart
of localai_tfp_tpu/workers/llm.py::JaxLLMBackend, LLM path only).

A checkpoint is an HF directory (dense or mixture of experts) or a
``.gguf`` file, which brings its own tokenizer and chat template and no
vision tower. A multimodal HF checkpoint (Gemma 3 with SigLIP, LLaVA with
CLIP) also loads its tower and projector (``models/hf_loader.py::
load_multimodal``): a request's images are decoded
(``models/image_io.py``), encoded in one tower call, and their soft rows
spliced over image-token runs where the prompt's ``[img-N]`` markers
stand (``_splice_images``). A Mamba or RWKV checkpoint is served without
an engine: its step function decodes token by token
(``models/recurrent.py``), a CUDA-graph replay per token on a card, and
a stream gets the whole text, then the final. LoRA adapters merge at load, before ``quantization: int8``
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
import logging
import os
import queue
import re
import threading
import time
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..config import knobs
from ..device import resolve
from ..engine.engine import GenRequest, LLMEngine, StreamEvent
from ..engine.jinja_lite import TemplateError
from ..engine.tokenizer import Tokenizer, load_tokenizer
from ..grammars.native import make_constraint
from ..models import artifact_cache, image_io, mamba, rwkv, weight_slab
from ..models.gguf import GGUFFile, load_gguf_params, tokenizer_from_gguf
from ..models.hf_loader import load_multimodal, load_params, spec_from_config
from ..models.llm_spec import LLMSpec
from ..models import load_timing
from ..models.load_timing import LoadPhases
from ..models.lora import merge_lora
from ..models.quant import QTensor, leaves, quantize_params
from ..models.vision import TowerRunner
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
_IMG_MARKER = re.compile(r"\[img-(\d+)\]")

log = logging.getLogger(__name__)


class TorchLLMBackend(Backend):
    """Serves chat completions for an HF checkpoint directory or a GGUF
    file."""

    def __init__(self, device: Any = None) -> None:
        self.device = resolve(device)
        self.engine: Optional[LLMEngine] = None
        self.tokenizer: Optional[Tokenizer] = None
        self.spec: Optional[LLMSpec] = None
        # a multimodal checkpoint's (VisionSpec, VisionParams, mm_info)
        self.vision: Optional[tuple] = None
        # its tower and projector (one graph replay an image on a card)
        self.tower: Optional[TowerRunner] = None
        # a Mamba or RWKV checkpoint: (module, spec, params, StepRunner)
        self.recurrent: Optional[tuple] = None
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
        if not is_gguf:
            with open(os.path.join(model_dir, "config.json")) as f:
                config = json.load(f)
            if rwkv.is_rwkv_config(config) or mamba.is_mamba_config(config):
                return self._load_recurrent(model_dir, config,
                                            _DTYPES[name], t0)
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
        if not is_gguf:
            self.vision = self._load_vision(model_dir, params)
            self.tower = (TowerRunner(*self.vision[:2], self.device)
                          if self.vision is not None else None)
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
                multimodal=self.vision is not None,
                # a disaggregated pair shares one tree by reference:
                # paging it would strand the other engine's dispatches
                weight_paging=False if disagg else None)
        if self.tower is not None and self.engine._ledger is not None:
            # the tower and projector live beside the engine's weights,
            # their graph's activations in a pool of its own
            tower = self.tower
            self.engine._ledger.register("vision_tower", tower.vp)
            self.engine._ledger.register("vision_graph",
                                         lambda: tower.pool_bytes)
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
                if self.tower is not None:
                    self.tower.capture()
        self.load_s = time.perf_counter() - t0
        self._state = "READY"
        return Result(True, "model loaded")

    def _load_vision(self, model_dir: str, params: dict) -> Optional[tuple]:
        """The checkpoint's vision tower and projector (None when it has
        none), at the serving dtype, bf16 when the embedding is int8. A
        multimodal checkpoint whose tower fails to load is served
        text-only, with a warning: its image parts are then dropped."""
        emb = params["embed"]
        dtype = torch.bfloat16 if isinstance(emb, QTensor) else emb.dtype
        try:
            return load_multimodal(model_dir, dtype=dtype,
                                   device=self.device)
        except (OSError, ValueError, KeyError, RuntimeError) as e:
            log.warning("vision tower load failed for %s: %r; serving "
                        "text-only, image parts will be ignored",
                        model_dir, e)
            return None

    def _load_recurrent(self, model_dir: str, config: dict,
                        dtype: torch.dtype, t0: float) -> Result:
        """A Mamba (at ``dtype``) or RWKV (f32) checkpoint: no engine, no
        KV cache; its step graphs are captured now (``LOCALAI_WARMUP``)
        or at the first request."""
        self.tokenizer = load_tokenizer(model_dir)
        if rwkv.is_rwkv_config(config):
            mod, (spec, params) = rwkv, rwkv.load_rwkv(model_dir,
                                                        self.device)
        else:
            mod, (spec, params) = mamba, mamba.load_mamba(
                model_dir, dtype, self.device)
        run = mod.runner(spec, params, self.device)
        if knobs.flag("LOCALAI_WARMUP"):
            with load_timing.phase("warmup_s"):
                run.capture()
        self.recurrent = (mod, spec, params, run)
        self.load_mode = "full"
        self.load_s = time.perf_counter() - t0
        self._state = "READY"
        return Result(True, f"{mod.__name__.rsplit('.', 1)[-1]} model "
                            "loaded")

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
        self.vision = self.tower = self.recurrent = None
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

    @torch.inference_mode()
    def _splice_images(self, prompt: str, images: list[bytes]
                       ) -> tuple[list[int], Optional[torch.Tensor],
                                  Optional[np.ndarray]]:
        """Expand ``[img-N]`` markers into ``<boi>``, ``mm_tokens``
        image-token ids and ``<eoi>`` (the ids the checkpoint has) and
        encode the images through the tower runner (the JAX
        ``_splice_images``).
        A marker naming no image stays as literal text; with no marker
        the images go before the prompt. Returns (prompt ids, soft rows
        [n, D] f32 on the device, their positions [n]); no rows when
        every marker was bogus."""
        mm = self.vision[2]
        pix = np.stack([image_io.preprocess_image(
            b, mm["image_size"], mm.get("family", "siglip")) for b in images])
        soft_all = self.tower.encode(pix).float()
        parts = _IMG_MARKER.split(prompt)
        if len(parts) == 1:  # the template placed no marker
            parts = [""]
            for i in range(len(images)):
                parts += [str(i), prompt if i == len(images) - 1 else ""]
        tk = self.tokenizer
        ids = tk.encode(parts[0], add_bos=True)
        positions: list[int] = []
        rows: list[torch.Tensor] = []
        for j in range(1, len(parts), 2):
            img, text = int(parts[j]), parts[j + 1]
            if img >= len(images):
                # no such image: the marker and the text after it stay
                ids.extend(tk.encode(f"[img-{parts[j]}]" + text,
                                     add_bos=False))
                continue
            if mm.get("boi_token") is not None:
                ids.append(mm["boi_token"])
            start = len(ids)
            ids.extend([mm["image_token"]] * mm["mm_tokens"])
            positions.extend(range(start, start + mm["mm_tokens"]))
            rows.append(soft_all[img])
            if mm.get("eoi_token") is not None:
                ids.append(mm["eoi_token"])
            if text:
                ids.extend(tk.encode(text, add_bos=False))
        if not rows:
            return ids, None, None
        return ids, torch.cat(rows), np.asarray(positions, np.int64)

    def _to_request(self, opts: PredictOptions) -> GenRequest:
        assert self.tokenizer is not None
        soft = positions = None
        if opts.images and self.vision is not None:
            prompt_ids, soft, positions = self._splice_images(opts.prompt,
                                                              opts.images)
        else:
            prompt_ids = self.tokenizer.encode(opts.prompt, add_bos=True)
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
            prompt_ids=prompt_ids,
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
            soft_embeds=soft,
            soft_positions=positions,
            **({"id": opts.request_id} if opts.request_id else {}),
        )

    def _recurrent_reply(self, opts: PredictOptions) -> Reply:
        """The whole reply of a Mamba or RWKV model (the JAX
        ``_recurrent_reply``): up to ``tokens`` (default 256), cut at the
        first EOS (dropped) and at the first stop string."""
        _, _, _, run = self.recurrent
        ids = self.tokenizer.encode(opts.prompt, add_bos=True)
        t0 = time.perf_counter()
        eos = next(iter(getattr(self.tokenizer, "eos_ids", []) or []), None)
        budget = opts.tokens or 256
        out = [int(t) for t in run.generate(
            ids, budget, temperature=opts.temperature, seed=opts.seed or 0,
            eos_id=None if opts.ignore_eos else eos)]
        finish = "stop"
        if eos is not None and out and out[-1] == eos:
            out = out[:-1]
        elif len(out) >= budget:
            finish = "length"
        text = self.tokenizer.decode(out)
        for stop in opts.stop_prompts or []:
            i = text.find(stop)
            if i >= 0:
                text = text[:i]
                finish = "stop"
        return Reply(message=text, tokens=len(out), prompt_tokens=len(ids),
                     finish_reason=finish,
                     timing_token_generation=(time.perf_counter() - t0) * 1e3)

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
        if self.recurrent is not None:
            return self._recurrent_reply(opts)
        if self.engine is None:
            return Reply(error="model not loaded", finish_reason="error")
        return final_reply(self.engine.generate(self._to_request(opts)))

    def stream_queue(self, opts: PredictOptions) -> queue.SimpleQueue:
        """Submit and return the engine's raw event queue (the HTTP layer
        peeks at it for an immediate shed before it sends headers). A
        recurrent model's queue holds its whole text, then the final."""
        if self.recurrent is not None:
            r = self._recurrent_reply(opts)
            q: queue.SimpleQueue = queue.SimpleQueue()
            if r.message:
                q.put(StreamEvent(text=r.message))
            q.put(StreamEvent(
                done=True, finish_reason=r.finish_reason, full_text=r.message,
                prompt_tokens=r.prompt_tokens, completion_tokens=r.tokens,
                timing_token_generation_ms=r.timing_token_generation))
            return q
        if self.engine is None:
            raise RuntimeError("model not loaded")
        return self.engine.submit(self._to_request(opts))

    def predict_stream(self, opts: PredictOptions) -> Iterator[Reply]:
        if self.recurrent is not None:
            # the whole text, then the final (the JAX worker's granularity)
            r = self._recurrent_reply(opts)
            if r.message:
                yield Reply(message=r.message)
            yield r
            return
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
