"""The dense families the JAX package serves beyond Llama, Mistral and
Qwen — Gemma 1/2/3 and Phi/Phi-3 — through the port against the JAX
package, on the CPU in f32.

- Checkpoints: tiny models saved with transformers ``save_pretrained``
  (``gemma``, ``gemma2``, ``gemma3`` with 7 layers so five sliding layers
  and a global one are crossed, ``phi``, ``phi3`` with its fused
  ``qkv_proj`` / ``gate_up_proj``), every weight redrawn from a seed so
  norms, biases and softcaps matter; ``gemma3`` also in the multimodal
  layout (``model_type: gemma3`` with a ``text_config``, tensors under
  ``language_model.model.`` or ``model.language_model.``). Both loaders
  read each: the trees are bitwise equal, and the port's logits through
  the paged path (two prefill chunks of ragged rows, then two decode
  steps, one B1 call per layer with that layer's window and softcap)
  match the JAX package's ``forward`` within 1e-4. The JAX engine does
  not take its ragged kernel for per-layer windows or a softcap (it
  gathers a dense window), so its dense path is the reference.
- Serving: greedy text of ``gemma3`` and ``phi3`` through the JAX server
  and the port's server from YAMLs with a Gemma-style Go template is
  byte-identical. Each chat goes to a model of its own: the JAX engine
  answers a windowed model's second request on one engine otherwise than
  its dense forward does (ROADMAP C9), so the port's own run of the
  chats in turn on one engine is held to a fresh engine's answers.
- B1's plain version with a softcap and per-layer windows against JAX's
  ``_attend`` and ``ragged_attention_reference``.
- ``spec_from_hf_config`` equal in both packages for each family's
  config dict (nested ``text_config``, ``layer_types`` over the pattern,
  ``partial_rotary_factor``).
- int8 loads of a tiny ``gemma3`` and ``phi`` (ungated) bitwise equal to
  the JAX package's ``quantize_params`` tree, and their logits.
- The cost model's FLOPs and bytes for a ``gemma3`` spec: FLOPs per token
  equal to JAX's, per-layer windows counted layer by layer.
- A Gemma-style chat template rendered by the port's Jinja subset as by
  jinja2 and the JAX package's tokenizer.
- Refusals: a mixture-of-experts checkpoint fails its load naming the
  feature; an unported ``model_type`` names the served list.
- The engine unchanged for another depth and head dim: ``LLMEngine.embed``
  of ``gemma3`` and ``phi`` against the JAX engine's within 1e-4, and the
  on-disk prompt cache's round trip on ``gemma3``.
"""

import asyncio
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from localai_tfp_tpu.models import hf_loader as jhf  # noqa: E402
from localai_tfp_tpu.models import llm_spec as jspec  # noqa: E402
from localai_tfp_tpu.models import quant as jq  # noqa: E402
from localai_tfp_tpu.models import transformer as jt  # noqa: E402
from localai_tfp_tpu.ops import ragged_paged_attention as jrpa  # noqa: E402
from localai_tfp_tpu_torch.models import hf_loader as thf  # noqa: E402
from localai_tfp_tpu_torch.models import llm_spec as tspec  # noqa: E402
from localai_tfp_tpu_torch.models import quant as tq  # noqa: E402
from localai_tfp_tpu_torch.models import transformer as tt  # noqa: E402
from localai_tfp_tpu_torch.ops.ragged_paged_attention import (  # noqa: E402
    ragged_attention_plain,
)
from localai_tfp_tpu_torch.telemetry import costmodel as tcm  # noqa: E402

TOL = 1e-4
PAGE, MAX_PAGES = 8, 4
COMMON = dict(vocab_size=300, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=256)
GELU = "gelu_pytorch_tanh"
FAMILIES = ("gemma", "gemma2", "gemma3", "gemma3_mm", "gemma3_mm2", "phi",
            "phi3")
# the multimodal layouts: tensor-name prefix of the text tower
MM_PREFIX = {"gemma3_mm": "language_model.model.",
             "gemma3_mm2": "model.language_model."}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hf_model(family: str):
    from transformers import (Gemma2Config, Gemma2ForCausalLM, Gemma3ForCausalLM,
                              Gemma3TextConfig, GemmaConfig, GemmaForCausalLM,
                              Phi3Config, Phi3ForCausalLM, PhiConfig,
                              PhiForCausalLM)

    if family == "gemma":
        return GemmaForCausalLM(GemmaConfig(
            **COMMON, head_dim=16, hidden_activation=GELU))
    if family == "gemma2":
        return Gemma2ForCausalLM(Gemma2Config(
            **COMMON, head_dim=16, query_pre_attn_scalar=12,
            attn_logit_softcapping=2.0, final_logit_softcapping=3.0,
            sliding_window=8, hidden_activation=GELU))
    if family.startswith("gemma3"):
        cfg = {**COMMON, "num_hidden_layers": 7}  # 5 local + 1 global + 1
        return Gemma3ForCausalLM(Gemma3TextConfig(
            **cfg, head_dim=16, query_pre_attn_scalar=16, sliding_window=8,
            rope_local_base_freq=10000.0, rope_theta=1000000.0,
            rope_scaling={"rope_type": "linear", "factor": 8.0}))
    if family == "phi":
        return PhiForCausalLM(PhiConfig(
            **{**COMMON, "num_key_value_heads": 4},
            partial_rotary_factor=0.5))
    if family == "phi3":
        return Phi3ForCausalLM(Phi3Config(
            **{**COMMON, "num_key_value_heads": 4}, sliding_window=12,
            pad_token_id=0))
    raise ValueError(family)


def _redraw(model, seed: int) -> None:
    """Every weight from a seed, at a scale where norms, biases and the
    softcaps change the logits: matrices at 1/sqrt(fan-in), vectors
    around their identity (Gemma's norms scale by 1 + w)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.dim() >= 2:
                p.copy_(r * p.shape[-1] ** -0.5)
            elif name.endswith("bias") or "gemma" in type(model).__name__ \
                    .lower():
                p.copy_(0.1 * r)
            else:
                p.copy_(1.0 + 0.1 * r)


def save_tiny(root, family: str, seed: int = 0) -> str:
    """A tiny checkpoint of ``family`` under ``root``; the multimodal
    layouts rename the text tower's tensors and nest its config."""
    torch.manual_seed(seed)
    model = _hf_model(family)
    _redraw(model, seed)
    d = root / family
    model.save_pretrained(d, safe_serialization=True)
    if family in MM_PREFIX:
        from safetensors.torch import load_file, save_file

        files = sorted(d.glob("*.safetensors"))
        tensors = {}
        for f in files:
            tensors.update(load_file(str(f)))
            f.unlink()
        pre = MM_PREFIX[family]
        save_file({pre + k[len("model."):]: v for k, v in tensors.items()},
                  str(d / "model.safetensors"))
        text = json.loads((d / "config.json").read_text())
        (d / "config.json").write_text(json.dumps({
            "architectures": ["Gemma3ForConditionalGeneration"],
            "model_type": "gemma3", "text_config": text,
            "mm_tokens_per_image": 256}))
    return str(d)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    return {f: save_tiny(root, f) for f in FAMILIES}


def _tree_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, jq.QTensor):
            assert isinstance(got[k], tq.QTensor), k
            np.testing.assert_array_equal(got[k].q.numpy(), np.asarray(v.q),
                                          err_msg=k)
            np.testing.assert_array_equal(got[k].scale.numpy(),
                                          np.asarray(v.scale), err_msg=k)
        else:
            np.testing.assert_array_equal(
                got[k].float().numpy(),
                np.asarray(v).astype(np.float32), err_msg=k)


PROMPT_LENS = (20, 14)
CHUNKS = (12, 8)  # two prefill chunks, then decode steps


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, vocab, (2, sum(CHUNKS) + 2)).astype(np.int32)


def _jax_logits(spec, params, toks: np.ndarray) -> list:
    """Per step [B, T, V] logits of the dense path: the chunks of the
    prompts, then two decode steps."""
    B = toks.shape[0]
    cache = jt.KVCache.create(spec, B, MAX_PAGES * PAGE, jnp.float32)
    out, pos = [], 0
    for T in CHUNKS:
        lg, cache = jt.forward(spec, params, jnp.asarray(toks[:, pos:pos + T]),
                               jnp.full((B,), pos, jnp.int32), cache, None)
        out.append(np.asarray(lg))
        pos += T
    lens = np.asarray(PROMPT_LENS, np.int32)
    for s in range(2):
        nxt = toks[np.arange(B), lens + s][:, None]
        lg, cache = jt.forward(spec, params, jnp.asarray(nxt),
                               jnp.asarray(lens + s), cache, None)
        out.append(np.asarray(lg))
    return out


def _port_logits(spec, params, toks: np.ndarray) -> list:
    """The same steps through the paged ragged path: rows carry only
    their valid tokens (q_lens), shuffled page tables."""
    B = toks.shape[0]
    pt = torch.from_numpy(np.random.default_rng(5).permutation(
        np.arange(1, B * MAX_PAGES + 1)).reshape(B, MAX_PAGES).astype(
            np.int32))
    cache = tt.KVCache.create(spec, B * MAX_PAGES + 1, PAGE, torch.float32)
    kw = dict(page_table=pt, kv_page=PAGE, write_table=pt)
    lens = np.asarray(PROMPT_LENS, np.int32)
    out, pos = [], 0
    for T in CHUNKS:
        q_lens = np.clip(lens - pos, 0, T).astype(np.int32)
        lg, cache = tt.forward(
            spec, params, torch.from_numpy(toks[:, pos:pos + T].copy()),
            torch.full((B,), pos, dtype=torch.int32), cache,
            q_lens=torch.from_numpy(q_lens), **kw)
        out.append(lg.numpy())
        pos += T
    for s in range(2):
        nxt = toks[np.arange(B), lens + s][:, None]
        lg, cache = tt.forward(
            spec, params, torch.from_numpy(nxt.copy()),
            torch.from_numpy(lens + s), cache,
            q_lens=torch.ones(B, dtype=torch.int32), **kw)
        out.append(lg.numpy())
    return out


def _assert_logits_match(got: list, want: list) -> None:
    lens = np.asarray(PROMPT_LENS)
    pos = 0
    for i, T in enumerate(CHUNKS):  # each row's valid prefill positions
        for b in range(2):
            n = int(np.clip(lens[b] - pos, 0, T))
            np.testing.assert_allclose(got[i][b, :n], want[i][b, :n],
                                       rtol=0, atol=TOL)
        pos += T
    for i in (2, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_checkpoint_loads_and_logits_match_jax(ckpts, family):
    jspec_, jparams = jhf.load_params(ckpts[family], dtype=jnp.float32)
    spec, params = thf.load_params(ckpts[family], torch.float32)
    assert spec.extra == jspec_.extra
    assert spec.tie_word_embeddings == jspec_.tie_word_embeddings
    _tree_equal(params, jparams)
    toks = _tokens(spec.vocab_size)
    want = _jax_logits(jspec_, jparams, toks)
    got = _port_logits(spec, params, toks)
    assert all(np.isfinite(g).all() for g in got)
    _assert_logits_match(got, want)


def test_gemma3_checkpoint_has_sliding_and_global_layers(ckpts):
    """The 7-layer Gemma 3: five sliding layers on the local rope base,
    then a global layer on the scaled global base, then a sliding one;
    a 20-token prompt is longer than the window of 8, so the two kinds
    see different keys."""
    spec, _ = thf.load_params(ckpts["gemma3"], torch.float32)
    assert tt.layer_windows(spec) == [8, 8, 8, 8, 8, 0, 8]
    freqs = tt._layer_inv_freqs(spec, "cpu")
    rd = spec.rotary_dim
    local = 1.0 / 10000.0 ** (torch.arange(0, rd, 2).float() / rd)
    torch.testing.assert_close(freqs[0], local, rtol=0, atol=0)
    torch.testing.assert_close(freqs[5], tt.rope_inv_freq(spec), rtol=0,
                               atol=0)
    assert not torch.equal(freqs[5], freqs[0])


# ------------------------------------------------------------ int8 loads


@pytest.mark.parametrize("family", ["gemma3", "phi"])
def test_int8_load_matches_jax_quantization(ckpts, family):
    """``quantization: int8`` at load: the projections (no ``w_gate`` for
    the ungated phi) are the JAX package's int8 codes and scales bit for
    bit, biases and norms stay bf16, the tied Gemma head stays the bf16
    embedding; logits of the two trees agree."""
    jspec_, jparams = jhf.load_params(ckpts[family], dtype=jnp.bfloat16)
    jtree = jq.quantize_params(jparams)
    spec, params = thf.load_params(ckpts[family], torch.bfloat16,
                                   quantize="int8")
    _tree_equal(params, jtree)
    quantized = {k for k, v in params.items() if isinstance(v, tq.QTensor)}
    assert quantized == set(tq.QUANTIZABLE) & set(params)
    assert ("w_gate" in params) == (family != "phi")
    assert params["embed"].dtype == torch.bfloat16
    if family == "phi":
        assert params["b_up"].dtype == params["ln1_b"].dtype == \
            torch.bfloat16
    toks = _tokens(spec.vocab_size)[:, :CHUNKS[0]]
    cache_j = jt.KVCache.create(jspec_, 2, 32, jnp.bfloat16)
    want, _ = jt.forward(jspec_, jtree, jnp.asarray(toks),
                         jnp.zeros(2, jnp.int32), cache_j, None)
    cache_t = tt.KVCache.create(spec, 2, 32, torch.bfloat16)
    got, _ = tt.forward(spec, params, torch.from_numpy(toks),
                        torch.zeros(2, dtype=torch.int32), cache_t)
    want = np.asarray(want)
    # bf16 activations round at other places in the two frameworks
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


# -------------------------------------------------------------- specs


def _config_dicts() -> dict:
    """One config.json dict per family, in the published checkpoints'
    shape (Gemma 3 nested under text_config, with and without
    layer_types)."""
    g3 = {"model_type": "gemma3_text", "hidden_size": 2560,
          "intermediate_size": 10240, "num_attention_heads": 8,
          "num_key_value_heads": 4, "head_dim": 256, "num_hidden_layers": 34,
          "vocab_size": 262208, "sliding_window": 1024,
          "sliding_window_pattern": 6, "rope_theta": 1000000.0,
          "rope_local_base_freq": 10000.0, "query_pre_attn_scalar": 256,
          "rms_norm_eps": 1e-6, "max_position_embeddings": 131072,
          "rope_scaling": {"factor": 8.0, "rope_type": "linear"}}
    types = ["sliding_attention"] * 34
    types[3] = types[11] = "full_attention"  # layer_types wins
    return {
        "gemma": {"model_type": "gemma", "hidden_size": 2048,
                  "intermediate_size": 16384, "num_attention_heads": 8,
                  "num_key_value_heads": 1, "head_dim": 256,
                  "num_hidden_layers": 18, "vocab_size": 256000,
                  "hidden_activation": GELU, "rms_norm_eps": 1e-6},
        "gemma2": {"model_type": "gemma2", "hidden_size": 2304,
                   "intermediate_size": 9216, "num_attention_heads": 8,
                   "num_key_value_heads": 4, "head_dim": 256,
                   "num_hidden_layers": 26, "vocab_size": 256000,
                   "sliding_window": 4096, "attn_logit_softcapping": 50.0,
                   "final_logit_softcapping": 30.0,
                   "query_pre_attn_scalar": 256, "hidden_act": GELU,
                   "rms_norm_eps": 1e-6},
        "gemma3": {"model_type": "gemma3", "text_config": g3},
        "gemma3_types": {"model_type": "gemma3",
                         "text_config": {**g3, "layer_types": types}},
        "gemma3_text": g3,
        "phi": {"model_type": "phi", "hidden_size": 2560,
                "intermediate_size": 10240, "num_attention_heads": 32,
                "num_hidden_layers": 32, "vocab_size": 51200,
                "partial_rotary_factor": 0.4, "hidden_act": "gelu_new",
                "layer_norm_eps": 1e-5},
        "phi3": {"model_type": "phi3", "hidden_size": 3072,
                 "intermediate_size": 8192, "num_attention_heads": 32,
                 "num_key_value_heads": 32, "num_hidden_layers": 32,
                 "vocab_size": 32064, "sliding_window": 2047,
                 "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
                 "max_position_embeddings": 4096},
    }


@pytest.mark.parametrize("name", sorted(_config_dicts()))
def test_spec_from_hf_config_equals_jax(name):
    cfg = _config_dicts()[name]
    want = jspec.spec_from_hf_config(json.loads(json.dumps(cfg)))
    got = tspec.spec_from_hf_config(json.loads(json.dumps(cfg)))
    assert got.__dict__ == want.__dict__
    tt.check_supported(got)
    assert thf.spec_from_config(cfg).__dict__ == got.__dict__
    assert jt._layer_windows(want) is None or \
        tt.layer_windows(got) == list(np.asarray(jt._layer_windows(want)))


def test_layer_types_take_precedence_over_the_pattern():
    spec = tspec.spec_from_hf_config(_config_dicts()["gemma3_types"])
    wins = tt.layer_windows(spec)
    assert [i for i, w in enumerate(wins) if w == 0] == [3, 11]
    assert tspec.spec_from_hf_config(_config_dicts()["phi"]).rotary_dim == 32


def test_moe_and_unknown_families_are_refused(tmp_path):
    """The mixtures of experts, once refused here, load now (their trees
    and logits are held to JAX in tests/test_torch_moe.py), and so does a
    LLaVA wrapper, as its nested text model (its tower: tests/
    test_torch_vision.py); a family the loader does not map still fails
    naming the served list."""
    from transformers import MixtralConfig, MixtralForCausalLM

    MixtralForCausalLM(MixtralConfig(**COMMON, num_local_experts=4,
                                     num_experts_per_tok=2)).save_pretrained(
        tmp_path / "moe", safe_serialization=True)
    spec, params = thf.load_params(str(tmp_path / "moe"), torch.float32)
    assert spec.n_experts == 4 and params["moe_gate"].shape == (2, 4, 64,
                                                                128)
    for mt in ("qwen2_moe", "qwen3_moe"):
        assert thf.spec_from_config({**COMMON, "model_type": mt}).n_experts
    llava = thf.spec_from_config({"model_type": "llava", "text_config": {
        **COMMON, "model_type": "llama"}})
    assert llava.d_model == COMMON["hidden_size"]
    with pytest.raises(NotImplementedError, match=r"not ported yet \(served"):
        thf.spec_from_config({**COMMON, "model_type": "gpt2"})
    with pytest.raises(NotImplementedError, match=r"not ported yet \(served"):
        thf.spec_from_config({"model_type": "llava", "text_config": {
            **COMMON, "model_type": "gpt2"}})


# ----------------------------------------------------- B1's plain version


def _attention_case(seed: int, dh: int = 16, hkv: int = 2, h: int = 4):
    rng = np.random.default_rng(seed)
    B, T, L = 3, 5, 2
    q_lens = np.asarray([1, 5, 3], np.int32)
    pos0 = np.asarray([27, 9, 20], np.int32)
    n_pages = B * MAX_PAGES + 1
    pt = rng.permutation(np.arange(1, n_pages)).reshape(
        B, MAX_PAGES).astype(np.int32)
    F = hkv * dh
    return dict(
        q=(rng.standard_normal((B, T, h, dh)) * 0.6).astype(np.float32),
        k=(rng.standard_normal((L, n_pages, PAGE, F))).astype(np.float32),
        v=(rng.standard_normal((L, n_pages, PAGE, F))).astype(np.float32),
        pt=pt, pos0=pos0, q_lens=q_lens, hkv=hkv)


@pytest.mark.parametrize("window", [0, 6])
def test_plain_attention_matches_jax_reference(window):
    c = _attention_case(1)
    kw = dict(scale=0.25, page=PAGE, sliding_window=window)
    got = ragged_attention_plain(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k"]),
        torch.from_numpy(c["v"]), 1, torch.from_numpy(c["pt"]),
        torch.from_numpy(c["pos0"]), torch.from_numpy(c["q_lens"]),
        c["hkv"], **kw).numpy()
    want = np.asarray(jrpa.ragged_attention_reference(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]), 1,
        jnp.asarray(c["pt"]), jnp.asarray(c["pos0"]),
        jnp.asarray(c["q_lens"]), c["hkv"], scale=0.25, page=PAGE,
        sliding_window=window or None))
    for b, n in enumerate(c["q_lens"]):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0, atol=TOL)


@pytest.mark.parametrize("window", [0, 6, 11])
@pytest.mark.parametrize("softcap", [0.0, 1.5])
def test_plain_softcap_and_window_match_jax_attend(window, softcap):
    """The plain version with a layer's window and Gemma 2's softcap
    against JAX's dense ``_attend`` over each row's gathered window, the
    layer's window passed as ``_attend`` gets it per layer."""
    c = _attention_case(2 + window)
    spec = jspec.tiny_spec(n_heads=4, n_kv_heads=2, d_head=16,
                           attn_logit_softcap=softcap,
                           query_pre_attn_scalar=12.0)
    scale = 12.0 ** -0.5
    got = ragged_attention_plain(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k"]),
        torch.from_numpy(c["v"]), 1, torch.from_numpy(c["pt"]),
        torch.from_numpy(c["pos0"]), torch.from_numpy(c["q_lens"]),
        c["hkv"], scale=scale, page=PAGE, sliding_window=window,
        softcap=softcap).numpy()
    B, T = c["q"].shape[:2]
    W = MAX_PAGES * PAGE
    k = c["k"][1][c["pt"]].reshape(B, W, 2, 16)
    v = c["v"][1][c["pt"]].reshape(B, W, 2, 16)
    qpos = c["pos0"][:, None] + np.arange(T)[None]
    want = np.asarray(jt._attend(spec, jnp.asarray(c["q"]), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(qpos),
                                 jnp.asarray(window, jnp.int32)))
    for b, n in enumerate(c["q_lens"]):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=0, atol=TOL)


# -------------------------------------------------------------- cost model


def test_costmodel_counts_gemma3_layer_by_layer(ckpts):
    """FLOPs per token of the gemma3 tree equal the JAX package's count;
    a forward's attention keys and KV pages are summed layer by layer
    over each layer's window; the ungated phi MLP counts two products."""
    from localai_tfp_tpu.telemetry import costmodel as jcm

    jspec_, jparams = jhf.load_params(ckpts["gemma3"], dtype=jnp.float32)
    spec, params = thf.load_params(ckpts["gemma3"], torch.float32)
    assert tcm.analytic_flops_per_token(params) == \
        jcm.analytic_flops_per_token(jparams)
    cache = tt.KVCache.create(spec, 9, PAGE, torch.float32)
    mc = tcm.ModelCost.of(spec, params, cache, PAGE)
    assert mc.windows == (8, 8, 8, 8, 8, 0, 8)
    rows = [(30, 1), (0, 20)]  # a decode row at 30, a 20-token chunk
    flops, by = mc.forward(rows, head_rows=2)
    d, qd, kvd, ff = 64, 64, 32, 128
    keys_local = 8 + sum(min(p + 1, 8) for p in range(20))
    keys_global = 31 + sum(p + 1 for p in range(20))
    keys = 6 * keys_local + keys_global
    want = (2.0 * 21 * (d * qd + 2 * d * kvd + qd * d + 3 * d * ff) * 7
            + 4.0 * qd * keys + 2.0 * 2 * d * 300)
    assert flops == want
    pages_local = (4 - 2) + 3  # [23, 31) on pages 2-3; [0, 20) on 0-2
    # (the chunk's first query sees from position 0)
    pages_global = 4 + 3
    per_token = 2 * kvd * 4
    layer_bytes = sum(v.numel() * 4 for k, v in params.items()
                      if k not in ("embed", "final_norm_w"))
    want_by = (layer_bytes + 21 * d * 4
               + per_token * ((6 * pages_local + pages_global) * PAGE
                              + 7 * 21)
               + 300 * d * 4 + d * 4 + 4 * 2 * 300)
    assert by == want_by
    pspec, pparams = thf.load_params(ckpts["phi"], torch.float32)
    pc = tcm.ModelCost.of(pspec, pparams,
                          tt.KVCache.create(pspec, 9, PAGE, torch.float32),
                          PAGE)
    assert pc.matmul_params == 4 * 64 * 64 + 2 * 64 * 128


# ------------------------------------------------------------ chat template

GEMMA_TEMPLATE = """{{ bos_token }}
{%- if messages[0]['role'] == 'system' -%}
    {{ raise_exception('System role not supported') }}
{%- endif -%}
{%- for message in messages -%}
    {%- if (message['role'] == 'user') != (loop.index0 % 2 == 0) -%}
        {{ raise_exception('Conversation roles must alternate user/assistant/user/assistant/...') }}
    {%- endif -%}
    {%- if message['role'] == 'assistant' -%}
        {%- set role = 'model' -%}
    {%- else -%}
        {%- set role = message['role'] -%}
    {%- endif -%}
    {{ '<start_of_turn>' + role + '\\n' + message['content'] | trim + '<end_of_turn>\\n' }}
{%- endfor -%}
{%- if add_generation_prompt -%}
    {{ '<start_of_turn>model\\n' }}
{%- endif -%}
"""
GEMMA_CHATS = [
    [{"role": "user", "content": " Hello there. "}],
    [{"role": "user", "content": "Hi"}, {"role": "assistant",
                                          "content": "Hello!"},
     {"role": "user", "content": "Name a colour."}],
    [{"role": "system", "content": "Be brief."},
     {"role": "user", "content": "Hi"}],
    [{"role": "user", "content": "a"}, {"role": "user", "content": "b"}],
]


@pytest.mark.parametrize("gen", [False, True])
@pytest.mark.parametrize("i", range(len(GEMMA_CHATS)))
def test_gemma_template_renders_as_jinja2_and_the_jax_package(
        tmp_path, i, gen):
    from tests.test_torch_jinja import _jinja2_chat_env, _port_chat_env
    from tests.test_torch_text_routes import _both, _save_tokenizer

    ctx = dict(messages=GEMMA_CHATS[i], bos_token="<bos>",
               add_generation_prompt=gen)
    outs = []
    for make in (_jinja2_chat_env, _port_chat_env):
        try:
            outs.append(("ok", make().from_string(GEMMA_TEMPLATE).render(
                **ctx)))
        except Exception as e:
            outs.append(("error", str(e)))
    assert outs[0] == outs[1]
    assert (outs[0][0] == "error") == (i >= 2)
    _save_tokenizer(tmp_path, cleanup=False, template=GEMMA_TEMPLATE)
    jtok, ttok = _both(tmp_path)
    res = []
    for tok in (jtok, ttok):
        try:
            res.append(("ok", tok.apply_chat_template(
                GEMMA_CHATS[i], add_generation_prompt=gen)))
        except Exception as e:
            res.append(("error", str(e)))
    if res[0][0] == "ok":
        assert res == [("ok", res[0][1])] * 2
        assert "<start_of_turn>user\n" in res[0][1]
    else:
        assert res[1][0] == "error" and \
            res[0][1].split(":")[-1].strip() in res[1][1]


# ----------------------------------------------------------------- serving

GO_GEMMA = """\
name: {name}
backend: jax-llm
parameters:
  model: {ckpt}
  temperature: 0.0
  max_tokens: 10
context_size: 256
max_batch_slots: 4
dtype: float32
stopwords: ["<end_of_turn>"]
template:
  chat_message: |-
    <start_of_turn>{{{{if eq .RoleName "assistant" }}}}model{{{{else}}}}{{{{ .RoleName }}}}{{{{end}}}}
    {{{{ if .Content -}}}}
    {{{{.Content -}}}}
    {{{{ end -}}}}<end_of_turn>
  chat: |
    {{{{.Input }}}}
    <start_of_turn>model
"""
SERVED = ("gemma3", "phi3")
CHATS = [
    [{"role": "user", "content": "Hello!"}],
    [{"role": "user", "content": "Count: one two three four five six"},
     {"role": "assistant", "content": "seven"},
     {"role": "user", "content": "and then?"}],
]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("families_served")
    models = root / "models"
    models.mkdir()
    for f in SERVED:
        save_tiny(models, f, seed=3)
        (models / f"{f}.yaml").write_text(GO_GEMMA.format(name=f, ckpt=f))
        for i in range(len(CHATS)):  # one model per chat
            (models / f"{f}-{i}.yaml").write_text(
                GO_GEMMA.format(name=f"{f}-{i}", ckpt=f))
    return root


def _jax_chat(root, bodies: list) -> list:
    from aiohttp.test_utils import TestClient, TestServer

    from localai_tfp_tpu.config.app_config import ApplicationConfig
    from localai_tfp_tpu.server.app import build_app
    from localai_tfp_tpu.server.state import Application

    loop = asyncio.new_event_loop()
    state = Application(ApplicationConfig(
        models_path=str(root / "models"),
        generated_content_dir=str(root / "generated"),
        upload_dir=str(root / "uploads"),
        config_dir=str(root / "configuration")))
    tc = TestClient(TestServer(build_app(state)), loop=loop)
    loop.run_until_complete(tc.start_server())

    async def go(body):
        r = await tc.request("POST", "/v1/chat/completions", json=body)
        return r.status, json.loads(await r.read())

    try:
        return [loop.run_until_complete(go(b)) for b in bodies]
    finally:
        loop.run_until_complete(tc.close())
        loop.close()


def _port_chat(root, bodies: list) -> list:
    from localai_tfp_tpu_torch.server.app import build_server

    srv = build_server(str(root / "models"), port=0, device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    out = []
    try:
        for body in bodies:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}"
                "/v1/chat/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                out.append((r.status, json.loads(r.read())))
    finally:
        srv.close()
        th.join(timeout=30)
    return out


def test_greedy_server_text_matches_jax_server(served):
    bodies = [{"model": f"{f}-{i}", "messages": m, "ignore_eos": True}
              for f in SERVED for i, m in enumerate(CHATS)]
    want = _jax_chat(served, bodies)
    got = _port_chat(served, bodies)
    for (js, jo), (ps, po) in zip(want, got):
        assert js == ps == 200
        assert po["choices"][0]["message"]["content"] == \
            jo["choices"][0]["message"]["content"]
        assert po["usage"]["prompt_tokens"] == jo["usage"]["prompt_tokens"]
        assert po["usage"]["completion_tokens"] == \
            jo["usage"]["completion_tokens"] > 0
    # the port's one engine per family, the chats in turn: the same text
    again = _port_chat(served, [{**b, "model": b["model"].split("-")[0]}
                                for b in bodies])
    assert [o["choices"][0]["message"]["content"] for _, o in again] == \
        [o["choices"][0]["message"]["content"] for _, o in got]


# ------------------------------------------------- engine: embed, cache


def _engines(ckpts, family: str):
    from localai_tfp_tpu.engine import engine as je
    from localai_tfp_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
    from localai_tfp_tpu_torch.engine import engine as te
    from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer

    jspec_, jparams = jhf.load_params(ckpts[family], dtype=jnp.float32)
    spec, params = thf.load_params(ckpts[family], torch.float32)
    kw = dict(n_slots=2, max_seq=128, prefill_buckets=(8, 32, 128))
    jeng = je.LLMEngine(jspec_, jparams, JaxBytes(), cache_dtype=jnp.float32,
                        **kw)
    teng = te.LLMEngine(spec, params, ByteTokenizer(),
                        cache_dtype=torch.float32, device="cpu", **kw)
    return jeng, teng


@pytest.mark.parametrize("family", ["gemma3", "phi"])
def test_embed_matches_jax_engine(ckpts, family):
    """``LLMEngine.embed`` for a family with another depth and head dim
    (Gemma 3: 7 layers, per-layer windows; Phi: LayerNorm, parallel
    residual) equals the JAX engine's within 1e-4, for a text longer than
    Gemma 3's window of 8."""
    jeng, teng = _engines(ckpts, family)
    try:
        for text in ("hi", "a sentence longer than the sliding window"):
            np.testing.assert_allclose(teng.embed(text).numpy(),
                                       np.asarray(jeng.embed(text)),
                                       rtol=0, atol=TOL)
    finally:
        jeng.close()
        teng.close()


def test_prompt_cache_round_trip_on_gemma3(ckpts, tmp_path):
    """The on-disk prompt cache on a Gemma 3: a second engine restores the
    saved rows and serves the cold engine's greedy text, computing one
    prompt token."""
    import time

    from localai_tfp_tpu_torch.engine import engine as te
    from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer

    spec, params = thf.load_params(ckpts["gemma3"], torch.float32)
    path = str(tmp_path / "g3.cache")
    prompt = ByteTokenizer().encode(
        "a prompt longer than the sliding window of eight", add_bos=True)
    texts = []
    for i in range(2):
        eng = te.LLMEngine(spec, params, ByteTokenizer(), n_slots=2,
                           max_seq=128, cache_dtype=torch.float32,
                           device="cpu")
        try:
            ev = eng.generate(te.GenRequest(
                prompt_ids=prompt, max_tokens=8, ignore_eos=True,
                prompt_cache_path=path))
            texts.append(ev.full_text)
            if i:
                assert eng.metrics.prefill_tokens == 1
        finally:
            eng.close()
        for _ in range(200):  # persistence runs on a background thread
            if os.path.exists(path):
                break
            time.sleep(0.05)
    assert texts[0] == texts[1]


def test_artifact_path_moves_with_the_family(tmp_path):
    """An int8 artifact is never reused across families: the fingerprint
    hashes ``config.json``'s name, size and mtime, so a checkpoint whose
    family changed gets another artifact path, in both packages alike."""
    from localai_tfp_tpu.models import artifact_cache as jac
    from localai_tfp_tpu_torch.models import artifact_cache as tac

    (tmp_path / "model.safetensors").write_bytes(b"\0" * 16)
    cfg = tmp_path / "config.json"
    paths = []
    for i, mt in enumerate(("gemma3_text", "phi")):
        cfg.write_text(json.dumps({"model_type": mt}))
        os.utime(cfg, ns=(10 ** 18 + i, 10 ** 18 + i))
        got = tac.artifact_path(str(tmp_path), "int8", "bfloat16")
        assert os.path.basename(got) == os.path.basename(
            jac.artifact_path(str(tmp_path), "int8", "bfloat16"))
        paths.append(got)
    assert paths[0] != paths[1]
