"""Model lifecycle: the registry of live backends, load-or-reuse, and the
busy/idle watchdog (counterpart of localai_tfp_tpu/engine/loader.py;
ref: pkg/model/loader.go:20-37,119-188, initializers.go:24-42,
watchdog.go:19-156, loader.go:469-496 single-active-backend).

Backends are in-process objects, one per loaded model. ``ModelLoader``
never holds its registry lock across a load: a minutes-long load of
model B leaves requests to a loaded model A served, and concurrent loads
of one name coalesce onto one build. In single-active mode whole loads
are serialised, so two leaders can never each hold a model on the card.

An unload hands the device memory back before it returns: the worker's
``shutdown`` stops its engine's scheduler and drops every reference to
the weights, the KV arena and the graphs (workers/llm.py).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ..config import knobs
from ..config.model_config import ModelConfig
from ..telemetry import metrics as tm
from ..utils import faultinject
from ..workers.base import Backend, ModelLoadOptions

# the load_breakdown keys folded into model_load_phase_seconds_total
_LOAD_PHASES = ("read_s", "dequant_s", "transfer_s", "compile_s",
                "warmup_s", "other_s")

log = logging.getLogger(__name__)

LLM_BACKEND = "torch-llm"
EMBEDDINGS_BACKEND = "torch-embeddings"
RERANK_BACKEND = "torch-rerank"
# the audio workers keep the JAX package's names, which its aliases use
WHISPER_BACKEND = "jax-whisper"
VAD_BACKEND = "jax-vad"
TTS_BACKEND = "jax-tts"

BackendFactory = Callable[[], Backend]

# backend-name aliasing (ref: initializers.go:24-42), the JAX package's
# table with its workers' names ("jax-llm", "jax-embeddings",
# "jax-rerank") mapped to this port's, so one YAML loads in both
# packages; the media aliases keep the JAX names: the audio workers are
# registered under them, and a load of the image names, which this port
# does not serve yet, is refused
ALIASES = {
    "": LLM_BACKEND,
    "jax-llm": LLM_BACKEND,
    "llama": LLM_BACKEND,
    "llama-cpp": LLM_BACKEND,
    "llama-grpc": LLM_BACKEND,
    "vllm": LLM_BACKEND,
    "transformers": LLM_BACKEND,
    "exllama2": LLM_BACKEND,
    "langchain-huggingface": LLM_BACKEND,
    "sentencetransformers": EMBEDDINGS_BACKEND,
    "huggingface-embeddings": EMBEDDINGS_BACKEND,
    "embeddings": EMBEDDINGS_BACKEND,
    "jax-embeddings": EMBEDDINGS_BACKEND,
    "rerankers": RERANK_BACKEND,
    "rerank": RERANK_BACKEND,
    "jax-rerank": RERANK_BACKEND,
    "whisper": WHISPER_BACKEND,
    "faster-whisper": WHISPER_BACKEND,
    "diffusers": "jax-diffusion",
    "stablediffusion": "jax-diffusion",
    "flux": "jax-diffusion",
    "piper": TTS_BACKEND,
    "coqui": TTS_BACKEND,
    "kokoro": TTS_BACKEND,
    "bark": TTS_BACKEND,
    "bark-cpp": TTS_BACKEND,
    "tts": TTS_BACKEND,
    "silero-vad": VAD_BACKEND,
    "vad": VAD_BACKEND,
    "local-store": "local-store",
    "stores": "local-store",
}


def resolve_backend(name: str) -> str:
    n = (name or "").strip().lower()
    return ALIASES.get(n, n)


class _Registry:
    """Factory registry for backend types."""

    def __init__(self) -> None:
        self._factories: dict[str, BackendFactory] = {}

    def register(self, name: str, factory: BackendFactory) -> None:
        self._factories[name] = factory

    def unregister(self, name: str) -> bool:
        return self._factories.pop(name, None) is not None

    def create(self, name: str) -> Backend:
        f = self._factories.get(name)
        if f is None:
            raise KeyError(
                f"no backend '{name}' registered "
                f"(known: {sorted(self._factories)})")
        return f()

    def known(self) -> list[str]:
        return sorted(self._factories)


registry = _Registry()


def register_default_backends(device=None) -> None:
    """Register the port's workers; ``device`` is where each loads its
    model (the card unless the caller asks for the CPU)."""
    from ..store.backend import LocalStoreBackend
    from ..workers.embeddings import TorchEmbeddingsBackend
    from ..workers.llm import TorchLLMBackend
    from ..workers.rerank import TorchRerankBackend
    from ..workers.tts import TorchTTSBackend
    from ..workers.vad import TorchVADBackend
    from ..workers.whisper import TorchWhisperBackend

    registry.register(LLM_BACKEND, lambda: TorchLLMBackend(device))
    registry.register(EMBEDDINGS_BACKEND,
                      lambda: TorchEmbeddingsBackend(device))
    registry.register(RERANK_BACKEND, lambda: TorchRerankBackend(device))
    registry.register("local-store", lambda: LocalStoreBackend(device))
    registry.register(WHISPER_BACKEND, lambda: TorchWhisperBackend(device))
    registry.register(VAD_BACKEND, lambda: TorchVADBackend(device))
    registry.register(TTS_BACKEND, lambda: TorchTTSBackend(device))


class LoadedModel:
    def __init__(self, name: str, backend_type: str, backend: Backend):
        self.name = name
        self.backend_type = backend_type
        self.backend = backend
        self.last_used = time.monotonic()
        self.busy_since: Optional[float] = None  # the latest call's start
        # inference calls in flight: the model turns idle when the last
        # one ends, not when the first of two overlapping calls does
        self.busy_calls = 0
        self.load_s: float = 0.0  # wall time of the load that built it

    def mark_busy(self) -> None:
        self.busy_since = time.monotonic()
        self.busy_calls += 1
        self.last_used = self.busy_since

    def mark_idle(self) -> None:
        self.busy_calls = max(0, self.busy_calls - 1)
        if self.busy_calls == 0:
            self.busy_since = None
        self.last_used = time.monotonic()


class _InFlightLoad:
    """One coalesced load of one model name: the first caller leads and
    loads; concurrent callers for the name wait on ``done`` and share
    the leader's outcome."""

    __slots__ = ("done", "backend", "error")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.backend: Optional[Backend] = None
        self.error: Optional[BaseException] = None


class ModelLoader:
    """Keyed registry of live backends with load-or-reuse semantics.

    ``_lock`` guards only the registry maps and is never held across a
    backend load or shutdown."""

    def __init__(self, models_path: str = "models", *,
                 single_active_backend: bool = False) -> None:
        self.models_path = models_path
        self.single_active = single_active_backend
        self._lock = threading.Lock()  # registry map mutations only
        self._models: dict[str, LoadedModel] = {}
        self._loads: dict[str, _InFlightLoad] = {}
        # single-active mode serialises whole loads: two concurrent
        # leaders would each evict the other, then both publish
        self._single_gate = threading.Lock()

    # ------------------------------------------------------------- loading

    def get_loaded(self, name: str) -> Optional[Backend]:
        """The already-loaded healthy backend, or None."""
        with self._lock:
            lm = self._models.get(name)
            if lm is not None and lm.backend.health():
                lm.last_used = time.monotonic()
                return lm.backend
        return None

    def load(self, cfg: ModelConfig) -> Backend:
        """Load-or-reuse: a healthy loaded backend is returned, a dead one
        rebuilt. Concurrent loads of one name coalesce onto one build;
        loads of different names run in parallel (but one at a time in
        single-active mode)."""
        while True:
            with self._lock:
                lm = self._models.get(cfg.name)
                if lm is not None and lm.backend.health():
                    lm.last_used = time.monotonic()
                    return lm.backend
                fl = self._loads.get(cfg.name)
                if fl is None:
                    fl = _InFlightLoad()
                    self._loads[cfg.name] = fl
                    break  # we are the leader
            fl.done.wait()
            if fl.error is not None:
                raise RuntimeError(
                    f"loading model '{cfg.name}': coalesced onto a "
                    f"concurrent load that failed: {fl.error}"
                ) from fl.error
            if fl.backend is not None:
                return fl.backend
        try:
            backend = self._load_as_leader(cfg)
            fl.backend = backend
            return backend
        except BaseException as e:
            fl.error = e
            tm.MODEL_LOADS.labels(model=cfg.name, result="error").inc()
            raise
        finally:
            with self._lock:
                if self._loads.get(cfg.name) is fl:
                    del self._loads[cfg.name]
            fl.done.set()

    def _load_as_leader(self, cfg: ModelConfig) -> Backend:
        """The load itself, without the registry lock (only brief map
        mutations take it)."""
        if faultinject.ACTIVE:
            # an injected load failure takes the path of a backend that
            # failed to build: every coalesced waiter gets the error
            faultinject.fire("loader.load")
        if self.single_active:
            self._single_gate.acquire()
        try:
            stale = None
            with self._lock:
                if cfg.name in self._models:
                    # the pre-leader check saw this entry unhealthy
                    stale = self._models.pop(cfg.name)
            if stale is not None:
                log.warning("backend for %s unhealthy; rebuilding",
                            cfg.name)
                self._shutdown_backend(stale)
            if self.single_active:
                with self._lock:
                    victims = [self._models.pop(n)
                               for n in list(self._models)
                               if n != cfg.name]
                for v in victims:
                    tm.MODEL_EVICTIONS.labels(reason="single_active").inc()
                    self._shutdown_backend(v)
                if victims:
                    self._update_gauges()

            btype = ("subprocess" if cfg.isolation == "subprocess"
                     else resolve_backend(cfg.backend))
            backend = registry.create(btype)
            t0 = time.monotonic()
            res = backend.load_model(self.load_options(cfg))
            if not res.success:
                backend.shutdown()
                raise RuntimeError(
                    f"loading model '{cfg.name}': {res.message}")
            lm = LoadedModel(cfg.name, btype, backend)
            lm.load_s = time.monotonic() - t0
            with self._lock:
                self._models[cfg.name] = lm
            tm.MODEL_LOADS.labels(model=cfg.name, result="success").inc()
            # the worker's load phases into the cumulative counters
            bd = getattr(backend, "load_breakdown", None) or {}
            for phase in _LOAD_PHASES:
                if bd.get(phase):
                    tm.MODEL_LOAD_PHASE.labels(
                        phase=phase.removesuffix("_s")).inc(float(bd[phase]))
            self._update_gauges()
            return backend
        finally:
            if self.single_active:
                self._single_gate.release()

    @staticmethod
    def _shutdown_backend(lm: LoadedModel) -> None:
        try:
            lm.backend.shutdown()
        except Exception as e:  # one bad unload must not stop the others
            log.warning("shutdown of %s raised: %s", lm.name, e)

    def load_options(self, cfg: ModelConfig) -> ModelLoadOptions:
        return ModelLoadOptions(
            model=cfg.model, model_path=self.models_path,
            context_size=cfg.context_size or 4096,
            batch_slots=cfg.max_batch_slots,
            dtype=cfg.dtype or "bfloat16",
            kv_cache_dtype=cfg.kv_cache_dtype,
            quantization=cfg.quantization,
            draft_model=cfg.draft_model, n_draft=cfg.n_draft or 0,
            lora_adapters=(list(cfg.lora_adapters)
                           or ([cfg.lora_adapter] if cfg.lora_adapter
                               else [])),
            lora_scales=(list(cfg.lora_scales)
                         or ([cfg.lora_scale] if cfg.lora_scale else [])),
            options=list(cfg.options), type=cfg.type)

    # ------------------------------------------------------------ lifecycle

    def get(self, name: str) -> Optional[LoadedModel]:
        with self._lock:
            return self._models.get(name)

    def loaded_names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def shutdown_model(self, name: str, reason: str = "api") -> bool:
        """Unload one model: the entry leaves the registry under the map
        lock, the (slow: scheduler join, memory release) backend shutdown
        runs outside it. ``reason`` labels the eviction counter."""
        with self._lock:
            lm = self._models.pop(name, None)
        if lm is None:
            return False
        tm.MODEL_EVICTIONS.labels(reason=reason).inc()
        self._update_gauges()
        self._shutdown_backend(lm)
        return True

    def stop_all(self) -> None:
        with self._lock:
            victims = [self._models.pop(n) for n in list(self._models)]
        for lm in victims:
            tm.MODEL_EVICTIONS.labels(reason="shutdown").inc()
            self._shutdown_backend(lm)
        self._update_gauges()

    def _update_gauges(self) -> None:
        with self._lock:
            n = len(self._models)
            busy = sum(1 for lm in self._models.values()
                       if lm.busy_since is not None)
        tm.MODELS_LOADED.set(n)
        tm.MODELS_BUSY.set(busy)

    # ------------------------------------------------- busy/idle accounting

    def mark_busy(self, name: str) -> None:
        with self._lock:
            lm = self._models.get(name)
            if lm is not None:
                lm.mark_busy()
        if lm is not None:
            self._update_gauges()

    def mark_idle(self, name: str) -> None:
        with self._lock:
            lm = self._models.get(name)
            if lm is not None:
                lm.mark_idle()
        if lm is not None:
            self._update_gauges()


class WatchDog:
    """Unloads models busy or idle beyond their timeouts, checked on
    periodic ticks (ref: pkg/model/watchdog.go:19-156; 30 s ticks).
    With ``LOCALAI_WATCHDOG_DEMOTE`` an idle model's weights are first
    demoted to host RAM (its engine, tokenizer and KV state stay), and
    only a model idle through another full timeout while warm is
    unloaded; without it, or without a weight pager, an idle model is
    unloaded."""

    def __init__(self, loader: ModelLoader, *,
                 busy_timeout: float = 5 * 60, idle_timeout: float = 15 * 60,
                 enable_busy: bool = False, enable_idle: bool = False,
                 interval: float = 30.0) -> None:
        self.loader = loader
        self.busy_timeout = busy_timeout
        self.idle_timeout = idle_timeout
        self.enable_busy = enable_busy
        self.enable_idle = enable_idle
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is None and (self.enable_busy or self.enable_idle):
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="watchdog", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.check(time.monotonic())

    def check(self, now: float) -> list[str]:
        """One tick; returns the names unloaded."""
        killed = []
        for name in self.loader.loaded_names():
            lm = self.loader.get(name)
            if lm is None:
                continue
            if (self.enable_busy and lm.busy_since is not None
                    and now - lm.busy_since > self.busy_timeout):
                log.warning("watchdog: %s busy > %.0fs, killing",
                            name, self.busy_timeout)
                tm.WATCHDOG_KILLS.labels(kind="busy").inc()
                self.loader.shutdown_model(name, reason="watchdog_busy")
                killed.append(name)
            elif (self.enable_idle and lm.busy_since is None
                  and now - lm.last_used > self.idle_timeout):
                if knobs.flag("LOCALAI_WATCHDOG_DEMOTE"):
                    outcome = self._try_demote(lm)
                    if outcome == "demoted":
                        # demote instead of unload; the idle clock
                        # restarts, so a model idle through another full
                        # timeout (now warm) is unloaded below
                        log.warning("watchdog: %s idle > %.0fs, demoting "
                                    "weights to host RAM", name,
                                    self.idle_timeout)
                        tm.MODEL_EVICTIONS.labels(
                            reason="watchdog_demote").inc()
                        lm.last_used = now
                        continue
                    if outcome == "busy":
                        continue  # a transfer in flight: next tick
                log.warning("watchdog: %s idle > %.0fs, killing",
                            name, self.idle_timeout)
                tm.WATCHDOG_KILLS.labels(kind="idle").inc()
                self.loader.shutdown_model(name, reason="watchdog_idle")
                killed.append(name)
        return killed

    @staticmethod
    def _try_demote(lm) -> Optional[str]:
        """Ask the backend to page its weights out: "demoted" (started),
        "busy" (one is in flight), "warm" (nothing hot: the kill timer
        runs on), or None (no pager: the kill path)."""
        fn = getattr(lm.backend, "demote_weights", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception as e:
            log.warning("watchdog: demote of %s raised %r; falling back "
                        "to kill", lm.name, e)
            return None
