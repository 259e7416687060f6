"""LoRA adapters through the port against the JAX package, on the CPU
(the mirror of tests/test_lora.py).

- ``merge_lora`` on the same PEFT adapter and the same weights (JAX
  ``init_params``): bitwise equal to the JAX package's merge in f32 and
  bf16 (the delta's product in f64, rounded to f32, added in f32, rounded
  to the leaf's dtype), on all seven projections; unmerge restores the
  logits; scale; errors (no adapter file, an adapter matching nothing as
  Phi-3's fused projections do, a shape mismatch, int8 leaves); the
  in-place merge keeps every tensor's storage.
- The worker: ``lora_adapters`` merged at load equal to the JAX worker's
  merge, greedy text equal; a scale of 0 skips its adapter; with
  ``quantization: int8`` the adapter merges before quantization, the
  codes equal JAX ``quantize_params`` of the merged tree, and no
  artifact is read or written.
- Hot apply and remove on a running engine, through the graph variant
  path: after ``apply_lora`` the greedy ids equal a fresh load with the
  adapter, after ``remove_lora`` the base model's; the engine's weight
  tensors are the same storage throughout; refused on int8 weights.
- The config fields map onto the load options as the JAX loader maps
  them.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.models import lora as jl
from localai_tfp_tpu.models import quant as jq
from localai_tfp_tpu.models.llm_spec import tiny_spec as jax_tiny
from localai_tfp_tpu.models.transformer import init_params
from localai_tfp_tpu_torch.models import lora as tl
from localai_tfp_tpu_torch.models import quant as tq
from localai_tfp_tpu_torch.models import transformer as tt
from localai_tfp_tpu_torch.models.convert import params_from_numpy
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec

PROJS = (("q_proj", "q"), ("k_proj", "kv"), ("v_proj", "kv"),
         ("o_proj", "d"), ("gate_proj", "f"), ("up_proj", "f"),
         ("down_proj", "d"))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def save_adapter(d, spec, rank=2, alpha=4.0, layers=(0,), seed=0,
                 projs=("q_proj", "v_proj")) -> dict:
    """A PEFT-format adapter on ``projs`` of ``layers`` (f32)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    dims = {"q": spec.q_dim, "kv": spec.kv_dim, "d": spec.d_model,
            "f": spec.d_ff}
    tensors = {}
    for layer in layers:
        for proj, kind in PROJS:
            if proj not in projs:
                continue
            out_dim = dims[kind]
            in_dim = spec.d_ff if proj == "down_proj" else (
                spec.q_dim if proj == "o_proj" else spec.d_model)
            part = "mlp" if proj in ("gate_proj", "up_proj",
                                     "down_proj") else "self_attn"
            base = f"base_model.model.model.layers.{layer}.{part}.{proj}"
            tensors[f"{base}.lora_A.weight"] = (rng.standard_normal(
                (rank, in_dim)) * 0.1).astype(np.float32)
            tensors[f"{base}.lora_B.weight"] = (rng.standard_normal(
                (out_dim, rank)) * 0.1).astype(np.float32)
    d.mkdir(parents=True, exist_ok=True)
    save_file(tensors, str(d / "adapter_model.safetensors"))
    (d / "adapter_config.json").write_text(json.dumps(
        {"r": rank, "lora_alpha": alpha}))
    return tensors


def _weights(dtype, seed=0):
    spec = jax_tiny()
    params = init_params(jax.random.PRNGKey(seed), spec, dtype=dtype)
    return spec, params


def _equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(v).astype(np.float32),
                                      err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_jax(tmp_path, dtype):
    spec, params = _weights(getattr(jnp, dtype))
    save_adapter(tmp_path, spec, layers=(0, 1),
                 projs=[p for p, _ in PROJS])
    want, n_want = jl.merge_lora(spec, params, str(tmp_path), scale=0.5)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 params.items()})
    got, n = tl.merge_lora(tiny_spec(), tparams, str(tmp_path), scale=0.5)
    assert n == n_want == 14
    _equal(got, want)
    assert got["wq"].dtype == getattr(torch, dtype)
    # untouched leaves are shared, touched ones new; the input unchanged
    assert got["embed"] is tparams["embed"]
    assert got["wq"] is not tparams["wq"]
    _equal(tparams, params)


def test_inplace_merge_keeps_storage_and_unmerge_restores(tmp_path):
    spec, params = _weights(jnp.float32, seed=1)
    save_adapter(tmp_path, spec)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 params.items()})
    ptrs = {k: v.data_ptr() for k, v in tparams.items()}
    toks = torch.tensor([[3, 5, 7]])
    zeros = torch.zeros(1, dtype=torch.int32)

    def logits(p):
        cache = tt.KVCache.create(tiny_spec(), 1, 8, torch.float32)
        return tt.forward(tiny_spec(), p, toks, zeros, cache, zeros)[0]

    base = logits(tparams)
    merged, _ = tl.merge_lora(tiny_spec(), tparams, str(tmp_path),
                              inplace=True)
    assert {k: v.data_ptr() for k, v in merged.items()} == ptrs
    assert not torch.allclose(logits(merged), base)
    jmerged, _ = jl.merge_lora(spec, params, str(tmp_path))
    _equal(merged, jmerged)
    restored, _ = tl.merge_lora(tiny_spec(), merged, str(tmp_path),
                                sign=-1.0, inplace=True)
    torch.testing.assert_close(logits(restored), base, rtol=1e-4,
                               atol=1e-4)


def test_bf16_remove_and_apply_round_trip_matches_jax(tmp_path):
    """bf16 leaves: merge, unmerge, merge again. The unmerge rounds
    (W + d) - d to bf16 again, so the round trip need not give back the
    first merge bitwise (ROADMAP §C 15); each stage is the JAX package's
    bitwise, so the port drifts exactly as the reference does."""
    spec, params = _weights(jnp.bfloat16, seed=3)
    save_adapter(tmp_path, spec, layers=(0, 1), projs=[p for p, _ in PROJS])
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 params.items()})
    want, got = params, tparams
    for sign in (1.0, -1.0, 1.0):
        want, _ = jl.merge_lora(spec, want, str(tmp_path), scale=0.5,
                                sign=sign)
        got, _ = tl.merge_lora(tiny_spec(), got, str(tmp_path), scale=0.5,
                               sign=sign)
        _equal(got, want)


def test_merge_scale_and_errors(tmp_path):
    spec, params = _weights(jnp.float32, seed=2)
    save_adapter(tmp_path / "a", spec)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 params.items()})
    m1, _ = tl.merge_lora(tiny_spec(), tparams, str(tmp_path / "a"),
                          scale=2.0)
    m2, _ = tl.merge_lora(tiny_spec(), tparams, str(tmp_path / "a"))
    d1, d2 = m1["wq"] - tparams["wq"], m2["wq"] - tparams["wq"]
    torch.testing.assert_close(d1, 2 * d2, rtol=1e-5, atol=1e-6)
    with pytest.raises(FileNotFoundError):
        tl.merge_lora(tiny_spec(), tparams, str(tmp_path / "nope"))
    # Phi-3's fused projections match no leaf, in both packages
    from safetensors.numpy import save_file

    fused = tmp_path / "fused"
    fused.mkdir()
    save_file({"base_model.model.model.layers.0.self_attn.qkv_proj."
               "lora_A.weight": np.zeros((2, 64), np.float32),
               "base_model.model.model.layers.0.self_attn.qkv_proj."
               "lora_B.weight": np.zeros((128, 2), np.float32)},
              str(fused / "adapter_model.safetensors"))
    for merge, p in ((jl.merge_lora, params), (tl.merge_lora, tparams)):
        with pytest.raises(ValueError, match="matched no parameters"):
            merge(spec, p, str(fused))
    # a shape mismatch names the leaf and changes nothing
    wide = tmp_path / "wide"
    save_adapter(wide, jax_tiny(d_model=32, n_heads=2, d_head=16))
    before = tparams["wq"].clone()
    with pytest.raises(ValueError, match=r"shape mismatch on wq\[0\]"):
        tl.merge_lora(tiny_spec(), tparams, str(wide), inplace=True)
    assert torch.equal(tparams["wq"], before)
    with pytest.raises(ValueError, match="int8"):
        tl.merge_lora(tiny_spec(), tq.quantize_params(tparams),
                      str(tmp_path / "a"))


# ------------------------------------------------------------------ worker


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny HF llama (byte tokenizer) and an adapter on all seven
    projections of both layers."""
    from transformers import LlamaConfig, LlamaForCausalLM

    from localai_tfp_tpu.models.hf_loader import load_params

    root = tmp_path_factory.mktemp("lora")
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256)).save_pretrained(
        root / "ckpt", safe_serialization=True)
    spec, _ = load_params(str(root / "ckpt"), dtype=jnp.float32)
    save_adapter(root / "adapter", spec, rank=4, alpha=8.0, layers=(0, 1),
                 projs=[p for p, _ in PROJS], seed=3)
    return root


def _backend(root, **kw):
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend

    b = TorchLLMBackend("cpu")
    res = b.load_model(ModelLoadOptions(**{
        "model": "ckpt", "model_path": str(root), "context_size": 128,
        "batch_slots": 2, "dtype": "float32", **kw}))
    assert res.success, res.message
    return b


def _greedy(b, prompt="Hello there", n=10) -> str:
    from localai_tfp_tpu_torch.workers.base import PredictOptions

    r = b.predict(PredictOptions(prompt=prompt, tokens=n, temperature=0.0,
                                 ignore_eos=True))
    assert not r.error and r.tokens == n
    return r.message


def test_worker_loads_with_adapter(ckpt):
    from localai_tfp_tpu.workers.base import ModelLoadOptions as JOpts
    from localai_tfp_tpu.workers.base import PredictOptions as JPred
    from localai_tfp_tpu.workers.llm import JaxLLMBackend

    kw = dict(model=str(ckpt / "ckpt"), context_size=128, batch_slots=2,
              dtype="float32", lora_adapters=[str(ckpt / "adapter")],
              lora_scales=[0.5])
    j = JaxLLMBackend()
    assert j.load_model(JOpts(**kw)).success
    try:
        want = j.predict(JPred(prompt="Hello there", tokens=10,
                               temperature=0.0, ignore_eos=True)).message
        jparams = {k: np.asarray(v) for k, v in j.engine.params.items()}
    finally:
        j.shutdown()
    b = _backend(ckpt, lora_adapters=["adapter"], lora_scales=[0.5])
    try:
        _equal(b.engine.params, jparams)
        assert _greedy(b) == want
    finally:
        b.shutdown()
    # a scale of 0 skips the adapter: the base weights
    b0, base = _backend(ckpt, lora_adapters=["adapter"], lora_scales=[0.0]), \
        _backend(ckpt)
    try:
        _equal(b0.engine.params, {k: v.numpy() for k, v in
                                  base.engine.params.items()})
    finally:
        b0.shutdown()
        base.shutdown()


def test_int8_with_adapter_quantizes_the_merge_and_skips_the_artifact(
        ckpt, tmp_path, monkeypatch):
    from localai_tfp_tpu.models.hf_loader import load_params

    cache = tmp_path / "artifacts"
    monkeypatch.setenv("LOCALAI_QUANT_ARTIFACTS", "on")
    monkeypatch.setenv("LOCALAI_QUANT_CACHE_DIR", str(cache))
    spec, jparams = load_params(str(ckpt / "ckpt"), dtype=jnp.bfloat16)
    jmerged, _ = jl.merge_lora(spec, jparams, str(ckpt / "adapter"))
    want = jq.quantize_params(jmerged)
    b = _backend(ckpt, dtype="bfloat16", quantization="int8",
                 lora_adapters=["adapter"])
    try:
        assert b.load_mode == "quantized"
        for k, v in want.items():
            if isinstance(v, jq.QTensor):
                np.testing.assert_array_equal(b.engine.params[k].q.numpy(),
                                              np.asarray(v.q), err_msg=k)
                np.testing.assert_array_equal(
                    b.engine.params[k].scale.numpy(), np.asarray(v.scale),
                    err_msg=k)
        _greedy(b, n=4)
        for hot in (b.apply_lora, b.remove_lora):
            with pytest.raises(RuntimeError, match="full-precision"):
                hot(str(ckpt / "adapter"))
    finally:
        b.shutdown()
    assert not cache.exists() or not any(cache.rglob("*.safetensors"))


def test_hot_apply_and_remove_match_fresh_loads(ckpt):
    """On a running engine (its decode and mixed steps through the graph
    variant path): apply, then the ids of a fresh load with the adapter;
    remove, then the base model's; the weights stay the same tensors."""
    base = _backend(ckpt)
    try:
        want_base = _greedy(base)
    finally:
        base.shutdown()
    fresh = _backend(ckpt, lora_adapters=["adapter"], lora_scales=[0.75])
    try:
        want_lora = _greedy(fresh)
        fresh_params = {k: v.clone() for k, v in fresh.engine.params.items()}
    finally:
        fresh.shutdown()
    assert want_lora != want_base
    b = _backend(ckpt)
    try:
        eng = b.engine
        bodies = []
        body = eng._decode_body

        def counted(v):
            bodies.append(v)
            return body(v)

        eng._decode_body = counted  # the variant path's decode forward
        ptrs = {k: v.data_ptr() for k, v in eng.params.items()}
        assert _greedy(b) == want_base
        assert b.apply_lora(str(ckpt / "adapter"), scale=0.75) == 14
        for k, v in fresh_params.items():
            assert torch.equal(eng.params[k], v), k
        assert _greedy(b) == want_lora
        assert b.remove_lora(str(ckpt / "adapter"), scale=0.75) == 14
        assert _greedy(b) == want_base
        assert b.engine is eng
        assert {k: v.data_ptr() for k, v in eng.params.items()} == ptrs
        # the decode forwards went through variant bodies (9 per
        # request at least), the prompts through padded mixed variants
        assert len(bodies) >= 3 * 9
        assert eng.metrics.mixed_pad_tokens > 0
    finally:
        b.shutdown()
    with pytest.raises(RuntimeError, match="not loaded"):
        b.apply_lora(str(ckpt / "adapter"))


def test_config_maps_lora_fields_like_jax(tmp_path):
    from localai_tfp_tpu.config.model_config import ModelConfig as JCfg
    from localai_tfp_tpu.engine.loader import ModelLoader as JLoader
    from localai_tfp_tpu_torch.config.model_config import ModelConfig
    from localai_tfp_tpu_torch.engine.loader import ModelLoader

    for doc in ({"name": "m", "parameters": {"model": "x"},
                 "lora_adapter": "a", "lora_scale": 0.5},
                {"name": "m", "parameters": {"model": "x"},
                 "lora_adapters": ["a", "b"], "lora_scales": [0.0, 2.0]},
                {"name": "m", "parameters": {"model": "x"},
                 "lora_adapters": ["a"]}):
        want = JLoader(str(tmp_path))._load_options(JCfg.from_dict(doc))
        got = ModelLoader(str(tmp_path)).load_options(
            ModelConfig.from_dict(doc))
        assert (got.lora_adapters, got.lora_scales) == (
            want.lora_adapters, want.lora_scales)
