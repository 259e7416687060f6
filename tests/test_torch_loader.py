"""The port's model lifecycle (localai_tfp_tpu_torch/engine/loader.py)
against the JAX package's (localai_tfp_tpu/engine/loader.py).

Each case runs one scripted sequence — the cases of tests/test_loader.py:
aliasing, reuse, unhealthy rebuild, load failure, single-active eviction,
unknown backend, the busy / idle / busy-not-idle watchdog, ``stop_all``,
a loaded model served while another load is in flight, same-name
coalescing and a coalesced failure, plus concurrent single-active
leaders — through both packages' ``ModelLoader`` with fake backends, and
the outcomes (return values, errors, instances built and shut down, the
lifecycle counters' increments) must be equal. The two packages' LLM
worker names (``jax-llm``, ``torch-llm``) read as ``LLM`` in outcomes.

Then two real tiny engines loaded side by side (not single-active) serve
interleaved requests, each reply equal to the same request served by that
model alone: the two engines' graphs share B1's merge counters, which is
safe while their launches cannot overlap.
"""

import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

import localai_tfp_tpu.config.model_config as jmc
import localai_tfp_tpu.engine.loader as jl
import localai_tfp_tpu.telemetry.metrics as jm
import localai_tfp_tpu.workers.base as jb
import localai_tfp_tpu_torch.config.model_config as tmc
import localai_tfp_tpu_torch.engine.loader as tl
import localai_tfp_tpu_torch.telemetry.metrics as tm
import localai_tfp_tpu_torch.workers.base as tb

PKGS = {
    "jax": SimpleNamespace(loader=jl, config=jmc.ModelConfig, base=jb,
                           metrics=jm, llm="jax-llm"),
    "torch": SimpleNamespace(loader=tl, config=tmc.ModelConfig, base=tb,
                             metrics=tm, llm="torch-llm"),
}
GATE_S = 30.0


def _classes(pkg):
    """Fake backends for one package: ``Fake`` loads at once; ``Slow``
    parks its load on a gate; ``Failing``/``SlowFailing`` fail."""
    ns = SimpleNamespace(instances=0, live=0, max_live=0,
                         started=threading.Event(), gate=threading.Event(),
                         lock=threading.Lock())

    class Fake(pkg.base.Backend):
        def __init__(self):
            with ns.lock:
                ns.instances += 1
            self.healthy = True
            self.shut = False

        def _ok(self):
            with ns.lock:
                ns.live += 1
                ns.max_live = max(ns.max_live, ns.live)
            return pkg.base.Result(True)

        def load_model(self, opts):
            self.opts = opts
            return self._ok()

        def predict(self, opts):
            raise NotImplementedError

        def predict_stream(self, opts):
            raise NotImplementedError

        def health(self):
            return self.healthy

        def shutdown(self):
            if not self.shut and hasattr(self, "opts"):
                with ns.lock:
                    ns.live -= 1
            self.shut = True

    class Failing(Fake):
        def load_model(self, opts):
            return pkg.base.Result(False, "nope")

    class Slow(Fake):
        def load_model(self, opts):
            self.opts = opts
            ns.started.set()
            assert ns.gate.wait(GATE_S), "gate never released"
            return self._ok()

    class SlowFailing(Fake):
        def load_model(self, opts):
            ns.started.set()
            assert ns.gate.wait(GATE_S)
            return pkg.base.Result(False, "disk on fire")

    ns.Fake, ns.Failing, ns.Slow, ns.SlowFailing = (Fake, Failing, Slow,
                                                    SlowFailing)
    return ns


def _cfg(pkg, name="m1", backend=""):
    return pkg.config.from_dict({"name": name, "backend": backend,
                                 "parameters": {"model": "dir"}})


def _counters(pkg) -> dict:
    m = pkg.metrics
    out = {}
    for fam, key, values in (
            (m.MODEL_EVICTIONS, "reason", ("single_active", "api",
                                           "watchdog_busy", "watchdog_idle",
                                           "shutdown")),
            (m.WATCHDOG_KILLS, "kind", ("busy", "idle"))):
        for v in values:
            out[f"{fam.name}{{{v}}}"] = fam.labels(**{key: v}).snapshot()[
                "value"]
    for model in ("a", "b", "m1"):
        for result in ("success", "error"):
            out[f"loads{{{model},{result}}}"] = m.MODEL_LOADS.labels(
                model=model, result=result).snapshot()["value"]
    return out


def _norm(pkg, x):
    return json.loads(json.dumps(x, default=str).replace(pkg.llm, "LLM"))


# ------------------------------------------------------------ the cases


def case_aliasing(pkg, ns):
    names = ["llama", "vLLM", "", "llama-cpp", "transformers",
             "exllama2", "piper", "whisper", "custom-thing", "Stores"]
    return {n: pkg.loader.resolve_backend(n) for n in names}


def case_reuse(pkg, ns):
    ml = pkg.loader.ModelLoader()
    b1, b2 = ml.load(_cfg(pkg)), ml.load(_cfg(pkg))
    return {"same": b1 is b2, "instances": ns.instances,
            "model": b1.opts.model, "loaded": ml.loaded_names()}


def case_unhealthy_rebuild(pkg, ns):
    ml = pkg.loader.ModelLoader()
    b1 = ml.load(_cfg(pkg))
    b1.healthy = False
    b2 = ml.load(_cfg(pkg))
    return {"rebuilt": b2 is not b1, "old_shut": b1.shut,
            "instances": ns.instances, "get_loaded_new": ml.get_loaded(
                "m1") is b2}


def case_load_failure(pkg, ns):
    pkg.loader.registry.register("bad", ns.Failing)
    ml = pkg.loader.ModelLoader()
    with pytest.raises(RuntimeError) as e:
        ml.load(_cfg(pkg, backend="bad"))
    return {"error": str(e.value), "loaded": ml.loaded_names()}


def case_single_active_evicts(pkg, ns):
    ml = pkg.loader.ModelLoader(single_active_backend=True)
    b1 = ml.load(_cfg(pkg, "a"))
    ml.load(_cfg(pkg, "b"))
    return {"loaded": ml.loaded_names(), "a_shut": b1.shut,
            "gauge": pkg.metrics.MODELS_LOADED._solo().snapshot()["value"]}


def case_unknown_backend(pkg, ns):
    ml = pkg.loader.ModelLoader()
    with pytest.raises(KeyError) as e:
        ml.load(_cfg(pkg, backend="never-registered"))
    return {"error": str(e.value), "loaded": ml.loaded_names()}


def case_watchdog_busy_kill(pkg, ns):
    ml = pkg.loader.ModelLoader()
    b = ml.load(_cfg(pkg, "a"))
    ml.mark_busy("a")
    wd = pkg.loader.WatchDog(ml, busy_timeout=10, enable_busy=True)
    return {"early": wd.check(time.monotonic() + 5),
            "late": wd.check(time.monotonic() + 11),
            "loaded": ml.loaded_names(), "shut": b.shut}


def case_watchdog_idle_kill(pkg, ns):
    ml = pkg.loader.ModelLoader()
    ml.load(_cfg(pkg, "a"))
    ml.mark_idle("a")
    wd = pkg.loader.WatchDog(ml, idle_timeout=100, enable_idle=True)
    return {"early": wd.check(time.monotonic() + 50),
            "late": wd.check(time.monotonic() + 101),
            "loaded": ml.loaded_names()}


def case_watchdog_busy_not_idle(pkg, ns):
    ml = pkg.loader.ModelLoader()
    ml.load(_cfg(pkg, "a"))
    ml.mark_busy("a")
    wd = pkg.loader.WatchDog(ml, idle_timeout=10, enable_idle=True)
    return {"killed": wd.check(time.monotonic() + 1000),
            "loaded": ml.loaded_names(),
            "busy": pkg.metrics.MODELS_BUSY._solo().snapshot()["value"]}


def case_stop_all(pkg, ns):
    ml = pkg.loader.ModelLoader()
    a, b = ml.load(_cfg(pkg, "a")), ml.load(_cfg(pkg, "b"))
    ml.stop_all()
    return {"loaded": ml.loaded_names(), "shut": [a.shut, b.shut],
            "shutdown_model_gone": ml.shutdown_model("a")}


def case_served_while_other_load_in_flight(pkg, ns):
    pkg.loader.registry.register("slow", ns.Slow)
    ml = pkg.loader.ModelLoader()
    a = ml.load(_cfg(pkg, "a"))
    t = threading.Thread(target=ml.load, args=(_cfg(pkg, "b", "slow"),),
                         daemon=True)
    t.start()
    assert ns.started.wait(10)
    t0 = time.monotonic()
    out = {"get_loaded_a": ml.get_loaded("a") is a,
           "load_a": ml.load(_cfg(pkg, "a")) is a,
           "loaded_mid": ml.loaded_names()}
    out["prompt"] = time.monotonic() - t0 < 5.0
    ns.gate.set()
    t.join(GATE_S)
    out["loaded_after"] = ml.loaded_names()
    return out


def case_same_name_coalesces(pkg, ns):
    pkg.loader.registry.register("slow", ns.Slow)
    ml = pkg.loader.ModelLoader()
    got = [None, None]

    def call(i):
        got[i] = ml.load(_cfg(pkg, "b", "slow"))

    t1 = threading.Thread(target=call, args=(0,), daemon=True)
    t1.start()
    assert ns.started.wait(10)
    t2 = threading.Thread(target=call, args=(1,), daemon=True)
    t2.start()
    time.sleep(0.2)
    mid = ns.instances
    ns.gate.set()
    t1.join(GATE_S)
    t2.join(GATE_S)
    return {"instances_mid": mid, "instances": ns.instances,
            "same": got[0] is got[1] is ml.get_loaded("b")}


def case_coalesced_failure(pkg, ns):
    pkg.loader.registry.register("slowfail", ns.SlowFailing)
    ml = pkg.loader.ModelLoader()
    errs = []

    def call():
        try:
            ml.load(_cfg(pkg, "b", "slowfail"))
        except RuntimeError as e:
            errs.append(str(e))

    t1 = threading.Thread(target=call, daemon=True)
    t1.start()
    assert ns.started.wait(10)
    t2 = threading.Thread(target=call, daemon=True)
    t2.start()
    time.sleep(0.2)
    ns.gate.set()
    t1.join(GATE_S)
    t2.join(GATE_S)
    return {"errors": sorted(errs), "loaded": ml.loaded_names(),
            "instances": ns.instances}


def case_single_active_concurrent_leaders(pkg, ns):
    """Two names loading at once in single-active mode: the gate
    serialises the whole loads, so never two backends live at once."""
    pkg.loader.registry.register("slow", ns.Slow)
    ml = pkg.loader.ModelLoader(single_active_backend=True)
    t1 = threading.Thread(target=ml.load, args=(_cfg(pkg, "a", "slow"),),
                          daemon=True)
    t1.start()
    assert ns.started.wait(10)
    t2 = threading.Thread(target=ml.load, args=(_cfg(pkg, "b", "slow"),),
                          daemon=True)
    t2.start()
    time.sleep(0.2)
    mid = ns.instances  # b's leader waits at the gate, unbuilt
    ns.gate.set()
    t1.join(GATE_S)
    t2.join(GATE_S)
    return {"instances_mid": mid, "max_live": ns.max_live,
            "loaded": ml.loaded_names(), "live": ns.live}


CASES = {n[5:]: f for n, f in sorted(globals().items())
         if n.startswith("case_")}


@pytest.fixture
def registries():
    saved = {k: dict(p.loader.registry._factories) for k, p in PKGS.items()}
    yield
    for k, p in PKGS.items():
        p.loader.registry._factories.clear()
        p.loader.registry._factories.update(saved[k])


def _run(case: str, which: str):
    pkg = PKGS[which]
    ns = _classes(pkg)
    pkg.loader.registry._factories.clear()
    pkg.loader.registry.register(pkg.llm, ns.Fake)
    before = _counters(pkg)
    try:
        out = CASES[case](pkg, ns)
    finally:
        ns.gate.set()  # never leave a loader thread parked
    after = _counters(pkg)
    deltas = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return _norm(pkg, {"out": out, "counters": deltas})


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_case_matches_jax(case, registries):
    want = _run(case, "jax")
    got = _run(case, "torch")
    assert got == want


def test_cases_pin_the_reference_outcomes(registries):
    """A few outcomes spelled out, so a change in both packages at once
    cannot pass unseen."""
    assert _run("reuse", "torch")["out"] == {
        "same": True, "instances": 1, "model": "dir", "loaded": ["m1"]}
    sa = _run("single_active_evicts", "torch")
    assert sa["out"]["loaded"] == ["b"] and sa["out"]["a_shut"]
    assert sa["counters"]["model_evictions_total{single_active}"] == 1
    assert "LLM" in _run("unknown_backend", "torch")["out"]["error"]
    co = _run("same_name_coalesces", "torch")
    assert co["out"] == {"instances_mid": 1, "instances": 1, "same": True}
    assert co["counters"] == {"loads{b,success}": 1}
    lead = _run("single_active_concurrent_leaders", "torch")["out"]
    assert lead == {"instances_mid": 1, "max_live": 1, "loaded": ["b"],
                    "live": 1}


def test_port_aliases_cover_the_jax_llm_names():
    for name in ("", "jax-llm", "llama", "llama-cpp", "llama-grpc", "vllm",
                 "transformers", "exllama2", "langchain-huggingface"):
        assert tl.resolve_backend(name) == "torch-llm"
        assert jl.resolve_backend(name) == "jax-llm"
    assert set(tl.ALIASES) == set(jl.ALIASES) | {"jax-llm", "jax-embeddings",
                                                 "jax-rerank"}
    # the encoder aliases, and the JAX workers' names, reach the port's
    for name in ("sentencetransformers", "huggingface-embeddings",
                 "embeddings", "jax-embeddings"):
        assert tl.resolve_backend(name) == "torch-embeddings"
        assert jl.resolve_backend(name) == "jax-embeddings"
    for name in ("rerankers", "rerank", "jax-rerank"):
        assert tl.resolve_backend(name) == "torch-rerank"
        assert jl.resolve_backend(name) == "jax-rerank"


def test_busy_window_counts_overlapping_calls(registries):
    """Two overlapping calls: the model stays busy until the last one
    ends (the JAX loader turns idle at the first end)."""
    ns = _classes(PKGS["torch"])
    tl.registry._factories.clear()
    tl.registry.register("torch-llm", ns.Fake)
    ml = tl.ModelLoader()
    ml.load(_cfg(PKGS["torch"], "a"))
    ml.mark_busy("a")
    ml.mark_busy("a")
    ml.mark_idle("a")
    assert ml.get("a").busy_since is not None
    ml.mark_idle("a")
    assert ml.get("a").busy_since is None


# ------------------------------------------- two real engines side by side


@pytest.fixture(scope="module")
def two_models(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    root = tmp_path_factory.mktemp("two_models")
    for name, seed in (("m-a", 0), ("m-b", 1)):
        torch.manual_seed(seed)
        LlamaForCausalLM(LlamaConfig(
            vocab_size=300, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256,
        )).save_pretrained(root / name, safe_serialization=True)
    return root


def _llm_cfg(name: str):
    return tmc.ModelConfig.from_dict({
        "name": name, "backend": "torch-llm", "context_size": 128,
        "max_batch_slots": 4, "dtype": "float32",
        "parameters": {"model": name}})


def test_two_loaded_engines_interleave_like_each_alone(two_models,
                                                       registries):
    from localai_tfp_tpu_torch.workers.base import PredictOptions

    tl.registry._factories.clear()
    tl.register_default_backends("cpu")
    prompts = ["hello there", "count to three", "a b c d e f", "zzz"]

    def opts(p):
        return PredictOptions(prompt=p, tokens=6, temperature=0.0,
                              ignore_eos=True)

    alone = {}
    for name in ("m-a", "m-b"):
        ml = tl.ModelLoader(str(two_models))
        b = ml.load(_llm_cfg(name))
        alone[name] = [b.predict(opts(p)).message for p in prompts]
        ml.stop_all()
    assert alone["m-a"] != alone["m-b"]  # two different models

    ml = tl.ModelLoader(str(two_models))
    backends = {n: ml.load(_llm_cfg(n)) for n in ("m-a", "m-b")}
    got = {n: [None] * len(prompts) for n in backends}

    def run(name, i):
        got[name][i] = backends[name].predict(opts(prompts[i])).message

    threads = [threading.Thread(target=run, args=(n, i))
               for i in range(len(prompts)) for n in ("m-a", "m-b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    try:
        assert got == alone
    finally:
        ml.stop_all()
    assert all(b.engine is None for b in backends.values())
