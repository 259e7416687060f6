"""GGUF checkpoints through the port against the JAX package, on the CPU
(the mirror of tests/test_gguf.py, with the files written by
tests/gguf_fixture.py).

- The header: metadata and an f32 tensor as the JAX reader reads them.
- Dequantization: every one of the 15 ggml types, on seeded random block
  bytes, bitwise equal to the JAX package's numpy dequantizers (NaN
  where they have NaN; the numpy Q3_K products are f64 and exact, so
  compared after their f32 rounding).
- Trees: a tiny llama written in llama.cpp's Q4_K_M mix (Q4_K, Q6_K for
  ``attn_v``/``ffn_down``/``output``, Q8_0 embedding, F32 norms) and a
  Qwen-style one (q/k/v biases, q/k norms, a tied head): the port's
  ``load_gguf_params`` bitwise equal to the JAX package's in f32 and bf16,
  specs equal; a Mixtral-style MoE GGUF the same, and its logits equal
  to the HF checkpoint's through the port's own HF loader.
- Tokenizers: both kinds against the JAX ``GGUFTokenizer`` (``tokenizers``
  0.22) on the same metadata: a byte-level BPE vocabulary with merges and
  control tokens, and a sentencepiece Unigram with byte-fallback pieces,
  control and user-defined tokens: encode, decode, bos/eos, control
  tokens as single ids, over fixed and seeded random texts; the chat
  template rendered as the JAX package renders it.
- The worker: a GGUF served through the port's worker and the JAX
  worker, greedy ids equal; ``quantization: int8`` of a GGUF equal to JAX
  ``quantize_params`` of its bf16 tree with no artifact written; a GGUF
  draft (spec dispatches, the same greedy ids); a GGUF with no
  vocabulary fails its load.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.models import gguf as jg
from localai_tfp_tpu.models import quant as jq
from localai_tfp_tpu_torch.models import gguf as tg
from localai_tfp_tpu_torch.models import quant as tq

from . import gguf_fixture as fx

_QT = {"F32": 0, "F16": 1, "Q4_0": 2, "Q4_1": 3, "Q5_0": 6, "Q5_1": 7,
       "Q8_0": 8, "Q2_K": 10, "Q3_K": 11, "Q4_K": 12, "Q5_K": 13,
       "Q6_K": 14, "IQ4_NL": 20, "IQ4_XS": 23, "BF16": 30}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_header_metadata_and_f32_tensor(tmp_path):
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = str(tmp_path / "t.gguf")
    fx.write_gguf(path, [
        ("general.architecture", "str", "llama"),
        ("llama.block_count", "u32", 2),
        ("tokenizer.ggml.tokens", "arr:str", ["a", "b"]),
        ("llama.rope.freq_base", "f32", 500000.0),
        ("tokenizer.ggml.scores", "arr:f32", [0.5, -1.25]),
        ("general.name", "str", "tiny ✓"),
    ], [("x.weight", 0, (4, 3), fx.enc_f32(w))])
    got, want = tg.GGUFFile(path), jg.GGUFFile(path)
    assert got.metadata == want.metadata
    assert got.data_start == want.data_start
    assert {k: (v.shape, v.ggml_type, v.offset)
            for k, v in got.tensors.items()} == {
        k: (v.shape, v.ggml_type, v.offset) for k, v in want.tensors.items()}
    np.testing.assert_array_equal(got.tensor("x.weight").numpy(), w)
    with pytest.raises(ValueError, match="not a GGUF"):
        (tmp_path / "bad.gguf").write_bytes(b"\0" * 64)
        tg.GGUFFile(str(tmp_path / "bad.gguf"))


@pytest.mark.parametrize("name", sorted(_QT))
def test_dequant_bitwise_matches_jax(name):
    """Seeded random blocks of every type: the port's torch dequantizer on
    the CPU gives the JAX numpy dequantizer's f32 values bit for bit."""
    gt = _QT[name]
    _, block, block_bytes = jg._GGML_TYPES[gt]
    rng = np.random.default_rng(gt)
    raw = rng.integers(0, 256, 97 * block_bytes, dtype=np.uint8)
    with np.errstate(invalid="ignore", over="ignore"):  # inf/NaN scales
        want = np.asarray(jg._GGML_TYPES[gt][0](raw.copy())).astype(
            np.float32)
    got = tg.dequantize(gt, torch.from_numpy(raw.copy()))
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


# ------------------------------------------------------------------ trees


def _blocks(gt: int, n: int, rng) -> bytes:
    """``n`` values of ggml type ``gt`` with sane scales, by the
    fixture's encoders."""
    if gt == 0:
        return fx.enc_f32(rng.standard_normal(n).astype(np.float32) * 0.1)
    if gt == 8:
        nb = n // 32
        return fx.enc_q8_0(rng.uniform(0.001, 0.01, nb),
                           rng.integers(-127, 128, (nb, 32)))
    out = b""
    for _ in range(n // 256):
        if gt == 12:
            out += fx.enc_q4_k(np.float16(rng.uniform(0.001, 0.004)),
                               np.float16(rng.uniform(0.001, 0.004)),
                               rng.integers(0, 64, 8), rng.integers(0, 64, 8),
                               rng.integers(0, 16, 256))
        elif gt == 14:
            out += fx.enc_q6_k(np.float16(rng.uniform(0.0005, 0.002)),
                               rng.integers(-30, 31, 16),
                               rng.integers(-32, 32, 256))
        else:
            raise ValueError(gt)
    return out


Q4_K_M = {"attn_q": 12, "attn_k": 12, "attn_v": 14, "attn_output": 12,
          "ffn_gate": 12, "ffn_up": 12, "ffn_down": 14}


def write_tiny_gguf(path, *, d=64, heads=4, kv=2, ff=128, layers=2,
                    vocab=96, experts=0, qwen=False, tokenizer=None,
                    seed=0) -> None:
    """A llama-family GGUF of random weights in the Q4_K_M mix (Q8_0
    embedding, Q6_K head, F32 norms); ``qwen`` adds q/k/v biases and q/k
    norms and ties the head; ``experts`` writes Mixtral-style expert
    stacks (Q4_K, down Q6_K) and a router instead of the dense MLP."""
    rng = np.random.default_rng(seed)
    dh = d // heads
    tensors = []

    def add(name, gt, shape):
        n = int(np.prod(shape))
        tensors.append((name, gt, tuple(reversed(shape)), _blocks(gt, n,
                                                                  rng)))

    add("token_embd.weight", 8, (vocab, d))
    add("output_norm.weight", 0, (d,))
    if not qwen:
        add("output.weight", 14, (vocab, d))
    shapes = {"attn_q": (heads * dh, d), "attn_k": (kv * dh, d),
              "attn_v": (kv * dh, d), "attn_output": (d, heads * dh),
              "ffn_gate": (ff, d), "ffn_up": (ff, d), "ffn_down": (d, ff)}
    for i in range(layers):
        b = f"blk.{i}."
        add(b + "attn_norm.weight", 0, (d,))
        add(b + "ffn_norm.weight", 0, (d,))
        for part, gt in Q4_K_M.items():
            if experts and part.startswith("ffn_"):
                continue
            add(b + part + ".weight", gt, shapes[part])
        if experts:
            add(b + "ffn_gate_inp.weight", 0, (experts, d))
            add(b + "ffn_gate_exps.weight", 12, (experts, ff, d))
            add(b + "ffn_up_exps.weight", 12, (experts, ff, d))
            add(b + "ffn_down_exps.weight", 14, (experts, d, ff))
        if qwen:
            add(b + "attn_q.bias", 0, (heads * dh,))
            add(b + "attn_k.bias", 0, (kv * dh,))
            add(b + "attn_v.bias", 0, (kv * dh,))
            add(b + "attn_q_norm.weight", 0, (dh,))
            add(b + "attn_k_norm.weight", 0, (dh,))
    meta = [
        ("general.architecture", "str", "llama"),
        ("llama.vocab_size", "u32", vocab),
        ("llama.embedding_length", "u32", d),
        ("llama.block_count", "u32", layers),
        ("llama.attention.head_count", "u32", heads),
        ("llama.attention.head_count_kv", "u32", kv),
        ("llama.feed_forward_length", "u32", ff),
        ("llama.context_length", "u32", 256),
        ("llama.rope.freq_base", "f32", 10000.0),
        ("llama.attention.layer_norm_rms_epsilon", "f32", 1e-5),
    ]
    if experts:
        meta += [("llama.expert_count", "u32", experts),
                 ("llama.expert_used_count", "u32", 2)]
    meta += tokenizer if tokenizer is not None else _sp_tokenizer(vocab)
    fx.write_gguf(str(path), meta, tensors)


def _spec_fields(spec) -> dict:
    import dataclasses

    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


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
            assert got[k].dtype == {jnp.float32: torch.float32,
                                    jnp.bfloat16: torch.bfloat16}[
                                        np.asarray(v).dtype.type], k
            np.testing.assert_array_equal(
                got[k].float().numpy(), np.asarray(v).astype(np.float32),
                err_msg=k)


@pytest.mark.parametrize("kind", ["llama", "qwen", "moe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trees_and_spec_match_jax(tmp_path, kind, dtype):
    path = tmp_path / f"{kind}.gguf"
    write_tiny_gguf(path, qwen=kind == "qwen",
                    experts=4 if kind == "moe" else 0)
    jspec_, jparams = jg.load_gguf_params(str(path),
                                          dtype=getattr(jnp, dtype))
    spec, params = tg.load_gguf_params(str(path),
                                       dtype=getattr(torch, dtype))
    assert _spec_fields(spec) == _spec_fields(jspec_)
    assert spec.tie_word_embeddings == (kind == "qwen")
    _tree_equal(params, jparams)


def _hf_llama(tmp_path, moe: bool, vocab: int = 96):
    from transformers import (LlamaConfig, LlamaForCausalLM, MixtralConfig,
                              MixtralForCausalLM)

    torch.manual_seed(0)
    common = dict(vocab_size=vocab, hidden_size=64, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128,
                  rope_theta=10000.0, rms_norm_eps=1e-5,
                  tie_word_embeddings=False)
    model = (MixtralForCausalLM(MixtralConfig(
        **common, num_local_experts=4, num_experts_per_tok=2)) if moe
        else LlamaForCausalLM(LlamaConfig(**common)))
    d = tmp_path / "hf"
    model.save_pretrained(d, safe_serialization=True)
    return str(d), model


def _convert_to_gguf(model, path, tokenizer=None) -> None:
    """Test-side convert_hf_to_gguf (llama.cpp names, the Q/K permute) in
    f32, Mixtral's experts as fused ``ffn_*_exps`` stacks."""
    sd = {k: v.detach().float().numpy() for k, v in
          model.state_dict().items()}
    cfg = model.config
    heads, kv = cfg.num_attention_heads, cfg.num_key_value_heads
    E = getattr(cfg, "num_local_experts", 0)
    tensors = []

    def add(gname, w):
        tensors.append((gname, 0, tuple(reversed(w.shape)),
                        fx.enc_f32(np.ascontiguousarray(w))))

    add("token_embd.weight", sd["model.embed_tokens.weight"])
    add("output_norm.weight", sd["model.norm.weight"])
    add("output.weight", sd["lm_head.weight"])
    for i in range(cfg.num_hidden_layers):
        p, b = f"model.layers.{i}.", f"blk.{i}."
        add(b + "attn_norm.weight", sd[p + "input_layernorm.weight"])
        add(b + "ffn_norm.weight", sd[p + "post_attention_layernorm.weight"])
        add(b + "attn_q.weight", fx.hf_to_gguf_permute(
            sd[p + "self_attn.q_proj.weight"], heads))
        add(b + "attn_k.weight", fx.hf_to_gguf_permute(
            sd[p + "self_attn.k_proj.weight"], kv))
        add(b + "attn_v.weight", sd[p + "self_attn.v_proj.weight"])
        add(b + "attn_output.weight", sd[p + "self_attn.o_proj.weight"])
        if E:
            add(b + "ffn_gate_inp.weight",
                sd[p + "block_sparse_moe.gate.weight"])
            for gg, hh in (("ffn_gate_exps", "w1"), ("ffn_up_exps", "w3"),
                           ("ffn_down_exps", "w2")):
                add(b + gg + ".weight", np.stack([
                    sd[p + f"block_sparse_moe.experts.{e}.{hh}.weight"]
                    for e in range(E)]))
        else:
            add(b + "ffn_gate.weight", sd[p + "mlp.gate_proj.weight"])
            add(b + "ffn_up.weight", sd[p + "mlp.up_proj.weight"])
            add(b + "ffn_down.weight", sd[p + "mlp.down_proj.weight"])
    meta = [
        ("general.architecture", "str", "llama"),
        ("llama.vocab_size", "u32", cfg.vocab_size),
        ("llama.embedding_length", "u32", cfg.hidden_size),
        ("llama.block_count", "u32", cfg.num_hidden_layers),
        ("llama.attention.head_count", "u32", heads),
        ("llama.attention.head_count_kv", "u32", kv),
        ("llama.feed_forward_length", "u32", cfg.intermediate_size),
        ("llama.context_length", "u32", cfg.max_position_embeddings),
        ("llama.rope.freq_base", "f32", cfg.rope_theta),
        ("llama.attention.layer_norm_rms_epsilon", "f32", cfg.rms_norm_eps),
    ]
    if E:
        meta += [("llama.expert_count", "u32", E),
                 ("llama.expert_used_count", "u32",
                  cfg.num_experts_per_tok)]
    meta += tokenizer if tokenizer is not None else _sp_tokenizer(
        cfg.vocab_size)
    fx.write_gguf(str(path), meta, tensors)


@pytest.mark.parametrize("moe", [False, True], ids=["llama", "mixtral"])
def test_gguf_logits_match_hf_loader(tmp_path, moe):
    """The same weights through the GGUF (un-permuted Q/K, fused expert
    stacks) and the HF loader give the same logits in the port; the GGUF
    tree equals the JAX package's."""
    from localai_tfp_tpu_torch.models.hf_loader import load_params
    from localai_tfp_tpu_torch.models.transformer import KVCache, forward

    hf_dir, model = _hf_llama(tmp_path, moe)
    gpath = tmp_path / "m.gguf"
    _convert_to_gguf(model, gpath)
    spec_hf, p_hf = load_params(hf_dir, torch.float32)
    spec_gg, p_gg = tg.load_gguf_params(str(gpath), torch.float32)
    _, jparams = jg.load_gguf_params(str(gpath), dtype=jnp.float32)
    _tree_equal(p_gg, jparams)
    assert spec_gg.n_experts == spec_hf.n_experts
    ids = torch.tensor([[1, 5, 9, 13, 2, 7]])
    zeros = torch.zeros(1, dtype=torch.int32)

    def logits(spec, p):
        lg, _ = forward(spec, p, ids, zeros,
                        KVCache.create(spec, 1, 32, torch.float32), zeros)
        return lg.numpy()

    np.testing.assert_allclose(logits(spec_gg, p_gg), logits(spec_hf, p_hf),
                               rtol=2e-5, atol=2e-5)


def test_spec_from_gguf_rope_scaling():
    for meta in ({"general.architecture": "llama",
                  "llama.embedding_length": 64, "llama.block_count": 2,
                  "llama.attention.head_count": 4,
                  "llama.rope.scaling.type": "yarn",
                  "llama.rope.scaling.factor": 4.0,
                  "llama.rope.scaling.original_context_length": 2048,
                  "tokenizer.ggml.tokens": ["a"] * 10},
                 {"general.architecture": "qwen2",
                  "qwen2.embedding_length": 32, "qwen2.block_count": 3,
                  "qwen2.attention.head_count": 2,
                  "qwen2.attention.key_length": 24,
                  "qwen2.rope.scaling.type": "linear",
                  "qwen2.rope.scaling.factor": 2.0,
                  "qwen2.expert_count": 8, "qwen2.expert_used_count": 2}):
        got, want = tg.spec_from_gguf(meta), jg.spec_from_gguf(meta)
        assert _spec_fields(got) == _spec_fields(want)
    assert got.rope_scaling == {"rope_type": "linear", "factor": 2.0}


# -------------------------------------------------------------- tokenizers


def _sp_tokenizer(vocab: int) -> list:
    """A sentencepiece (``llama``) vocabulary of ``vocab`` pieces: <unk>,
    <s>, </s>, the 256 byte pieces only when they fit, then words."""
    rng = np.random.default_rng(11)
    toks = ["<unk>", "<s>", "</s>"]
    types = [2, 3, 3]
    words = ["▁" + w for w in ("the", "a", "hi", "there", "hello",
                               "world", "count", "one", "two", "three")]
    toks += words + list("abcdefghijklmnopqrstuvwxyz▁ ")
    types += [1] * (len(toks) - len(types))
    while len(toks) < vocab:
        toks.append(f"<t{len(toks)}>")
        types.append(1)
    toks, types = toks[:vocab], types[:vocab]
    scores = [0.0, 0.0, 0.0] + list(-rng.uniform(1, 10, vocab - 3))
    return [("tokenizer.ggml.model", "str", "llama"),
            ("tokenizer.ggml.tokens", "arr:str", toks),
            ("tokenizer.ggml.scores", "arr:f32", scores),
            ("tokenizer.ggml.token_type", "arr:i32", types),
            ("tokenizer.ggml.unknown_token_id", "u32", 0),
            ("tokenizer.ggml.bos_token_id", "u32", 1),
            ("tokenizer.ggml.eos_token_id", "u32", 2)]


def _meta(items: list) -> dict:
    return {k: v for k, _, v in items}


def _unigram_meta() -> dict:
    """A sentencepiece vocabulary with the 256 byte pieces, control and
    user-defined tokens, repeated pieces with near-equal scores (ties in
    the lattice) and multi-character words."""
    rng = np.random.default_rng(5)
    toks = ["<unk>", "<s>", "</s>", "<|im_start|>", "<|im_end|>", "<tool>"]
    types = [2, 3, 3, 3, 3, 4]
    toks += [f"<0x{b:02X}>" for b in range(256)]
    types += [6] * 256
    alpha = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789.,!?'-:;()\n") + ["▁", "é", "ß", "日", "本"]
    toks += alpha
    types += [1] * len(alpha)
    pieces = set()
    while len(pieces) < 1500:
        n = int(rng.integers(2, 7))
        w = "".join(rng.choice(alpha[:26], n))
        pieces.add(("▁" + w) if rng.random() < 0.5 else w)
    toks += sorted(pieces)
    types += [1] * len(pieces)
    toks += ["▁the", "▁the"]  # a repeated piece: its last id wins
    types += [1, 1]
    scores = [0.0] * 6 + [0.0] * 256 + list(
        np.round(-rng.uniform(1, 12, len(toks) - 262), 1))
    return {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": toks,
            "tokenizer.ggml.scores": [float(np.float32(s)) for s in scores],
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.unknown_token_id": 0,
            "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": 4}


def _bpe_meta(n_merges: int = 1500) -> dict:
    """A byte-level BPE vocabulary (GPT-2's byte alphabet, merges of
    printable ASCII, space and newline symbols) with Llama-3-style control
    tokens."""
    import chip_smoke

    alphabet = chip_smoke._byte_alphabet()
    toks = list(alphabet)
    vocab = set(toks)
    base = [chr(b) for b in range(0x61, 0x7B)] + ["Ġ", "Ċ", "e"]
    merges = []
    level = list(base)
    while len(merges) < n_merges:
        nxt = []
        for a in level:
            for b in base:
                if len(merges) >= n_merges or a + b in vocab:
                    continue
                vocab.add(a + b)
                toks.append(a + b)
                merges.append(f"{a} {b}")
                nxt.append(a + b)
        level = nxt
    specials = ["<|begin_of_text|>", "<|end_of_text|>",
                "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>"]
    types = [1] * len(toks) + [3] * len(specials)
    toks += specials
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": toks,
            "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.bos_token_id": len(toks) - 5,
            "tokenizer.ggml.eos_token_id": len(toks) - 1}


FIXED_TEXTS = ["hello", "hi there", "  two  spaces", "Hello, World!",
               "naïve café ß 日本語 🎉", "<|im_start|>user\nhi<|im_end|>",
               "x<tool>y <tool> z", "<s>the</s>", "tab\tand\nnewline",
               "<|begin_of_text|><|start_header_id|>user<|end_header_id|>"
               "\n\nhey<|eot_id|>", "", " ", "▁already", "<0x41>"]


def _random_texts(seed: int, n: int = 80) -> list:
    rng = np.random.default_rng(seed)
    pool = list("abcdefghij klmnop qrstuvwxyz  ,.!?\n") + [
        "é", "ß", "日", "🎉", "<s>", "<|im_end|>", "<tool>", "the",
        "<|eot_id|>", "\t", "▁"]
    return ["".join(rng.choice(pool, int(rng.integers(0, 40))))
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_tokenizer_matches_jax(kind):
    meta = _bpe_meta() if kind == "gpt2" else _unigram_meta()
    got, want = tg.GGUFTokenizer(meta), jg.GGUFTokenizer(meta)
    assert got.bos_id == want.bos_id and got.eos_ids == want.eos_ids
    assert got.vocab_size == want.vocab_size
    for text in FIXED_TEXTS + _random_texts(len(kind)):
        ids = want.encode(text, add_bos=True)
        assert got.encode(text, add_bos=True) == ids, text
        assert got.encode_special(text) == want.encode_special(text), text
        assert got.decode(ids) == want.decode(ids), text
        assert got.decode(ids[1:]) == want.decode(ids[1:]), text
    rng = np.random.default_rng(3)
    for _ in range(40):  # arbitrary id runs, byte pieces mid-character
        ids = [int(i) for i in rng.integers(0, len(
            meta["tokenizer.ggml.tokens"]), int(rng.integers(1, 12)))]
        assert got.decode(ids) == want.decode(ids), ids


def test_gguf_tokenizer_gpt2_roundtrip():
    toks = ["h", "e", "l", "o", " ", "he", "<s>", "</s>"]
    meta = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": toks,
            "tokenizer.ggml.merges": ["h e"],
            "tokenizer.ggml.bos_token_id": 6,
            "tokenizer.ggml.eos_token_id": 7}
    got, want = tg.GGUFTokenizer(meta), jg.GGUFTokenizer(meta)
    ids = got.encode("hello")
    assert ids == want.encode("hello") and ids[0] == toks.index("he")
    assert got.decode(ids) == want.decode(ids) == "hello"
    assert got.eos_ids == {7}


def test_gguf_tokenizer_sentencepiece_bytes():
    toks = ["<unk>", "<s>", "</s>", "▁hi", "▁the", "re"]
    meta = {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": toks,
            "tokenizer.ggml.scores": [0.0, 0.0, 0.0, -1.0, -1.0, -2.0],
            "tokenizer.ggml.unknown_token_id": 0,
            "tokenizer.ggml.bos_token_id": 1}
    got, want = tg.GGUFTokenizer(meta), jg.GGUFTokenizer(meta)
    ids = got.encode("hi there", add_bos=True)
    assert ids == want.encode("hi there", add_bos=True)
    assert ids[0] == 1 and toks.index("▁hi") in ids
    assert got.decode(ids) == want.decode(ids)


def test_gguf_tokenizer_control_tokens_single_ids():
    toks = ["h", "i", "<|im_start|>", "<|im_end|>"]
    meta = {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.tokens": toks,
            "tokenizer.ggml.merges": [],
            "tokenizer.ggml.token_type": [1, 1, 3, 3]}
    ids = tg.GGUFTokenizer(meta).encode_special("<|im_start|>hi<|im_end|>")
    assert ids == jg.GGUFTokenizer(meta).encode_special(
        "<|im_start|>hi<|im_end|>") == [2, 0, 1, 3]


LLAMA3_TEMPLATE = (
    "{{- bos_token }}{%- if messages[0]['role'] == 'system' %}"
    "{%- set sys = messages[0]['content'] %}{%- set messages = "
    "messages[1:] %}{%- else %}{%- set sys = '' %}{%- endif %}"
    "<|start_header_id|>system<|end_header_id|>\n\n{{ sys }}"
    "{%- if tools is not none %}\n{{ tools | tojson }}{%- endif %}"
    "<|eot_id|>\n{%- for m in messages %}"
    "{%- if m['role'] not in ['user', 'assistant'] %}"
    "{{- raise_exception('bad role ' ~ m['role']) }}{%- endif %}"
    "{%- if loop.index > 8 %}{% break %}{% endif %}"
    "<|start_header_id|>{{ m['role'] }}<|end_header_id|>\n\n"
    "{{ m['content'] | trim }}<|eot_id|>\n{%- endfor %}"
    "{%- if add_generation_prompt %}<|start_header_id|>assistant"
    "<|end_header_id|>\n\n{%- endif %}{{ eos_token if false }}\n")


@pytest.mark.parametrize("gen", [False, True])
def test_chat_template_renders_as_jax(gen):
    meta = {**_bpe_meta(200), "tokenizer.chat_template": LLAMA3_TEMPLATE}
    got, want = tg.GGUFTokenizer(meta), jg.GGUFTokenizer(meta)
    msgs = [{"role": "system", "content": "Be brief <b>&</b>."},
            {"role": "user", "content": " Hi! "},
            {"role": "assistant", "content": "Hello."},
            {"role": "user", "content": "Again?"}]
    tools = [{"type": "function", "function": {"name": "f<x>",
                                               "parameters": {}}}]
    for t in (None, tools):
        text = want.apply_chat_template(msgs, add_generation_prompt=gen,
                                        tools=t)
        assert got.apply_chat_template(msgs, add_generation_prompt=gen,
                                       tools=t) == text
        assert got.encode(text, add_bos=True) == want.encode(text,
                                                             add_bos=True)
    from localai_tfp_tpu_torch.engine.jinja_lite import TemplateError

    with pytest.raises(TemplateError, match="bad role tool"):
        got.apply_chat_template([{"role": "tool", "content": "x"}])
    with pytest.raises(ValueError, match="no tokenizer.chat_template"):
        tg.GGUFTokenizer(_bpe_meta(10)).apply_chat_template(msgs)


# ------------------------------------------------------------------ worker


def _served_ids(backend, prompt: str, n: int) -> tuple:
    from localai_tfp_tpu_torch.workers.base import PredictOptions

    replies = list(backend.predict_stream(PredictOptions(
        prompt=prompt, tokens=n, temperature=0.0, ignore_eos=True)))
    assert not any(r.error for r in replies), replies
    return ([r.token_id for r in replies[:-1]], replies[-1].message,
            replies[-1].tokens)


def test_llm_worker_serves_gguf(tmp_path):
    """A GGUF configured like a gallery entry loads and serves through the
    port's worker; its greedy text equals the JAX worker's."""
    from localai_tfp_tpu.workers.base import ModelLoadOptions as JOpts
    from localai_tfp_tpu.workers.base import PredictOptions as JPred
    from localai_tfp_tpu.workers.llm import JaxLLMBackend
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend

    _, model = _hf_llama(tmp_path, moe=False)
    _convert_to_gguf(model, tmp_path / "tiny.gguf")
    kw = dict(model="tiny.gguf", model_path=str(tmp_path), context_size=64,
              batch_slots=2, dtype="float32")
    b = TorchLLMBackend("cpu")
    res = b.load_model(ModelLoadOptions(**kw))
    try:
        assert res.success, res.message
        assert isinstance(b.tokenizer, tg.GGUFTokenizer)
        _, text, n = _served_ids(b, "▁hello▁world", 8)
    finally:
        b.shutdown()
    assert n == 8
    j = JaxLLMBackend()
    assert j.load_model(JOpts(**kw)).success
    try:
        want = j.predict(JPred(prompt="▁hello▁world", tokens=8,
                               temperature=0.0, ignore_eos=True))
    finally:
        j.shutdown()
    assert text == want.message and n == want.tokens


def test_int8_gguf_matches_jax_and_writes_no_artifact(tmp_path,
                                                      monkeypatch):
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend

    write_tiny_gguf(tmp_path / "q.gguf", d=256, ff=512, heads=4, kv=2)
    cache = tmp_path / "artifacts"
    monkeypatch.setenv("LOCALAI_QUANT_ARTIFACTS", "on")
    monkeypatch.setenv("LOCALAI_QUANT_CACHE_DIR", str(cache))
    _, jparams = jg.load_gguf_params(str(tmp_path / "q.gguf"),
                                     dtype=jnp.bfloat16)
    b = TorchLLMBackend("cpu")
    res = b.load_model(ModelLoadOptions(
        model="q.gguf", model_path=str(tmp_path), context_size=64,
        batch_slots=2, dtype="bfloat16", quantization="int8"))
    try:
        assert res.success, res.message
        assert b.load_mode == "quantized"
        _tree_equal(b.engine.params, jq.quantize_params(jparams))
        _, _, n = _served_ids(b, "▁the", 4)
        assert n == 4
        with pytest.raises(RuntimeError, match="full-precision"):
            b.apply_lora(str(tmp_path))
    finally:
        b.shutdown()
    assert not cache.exists() or not any(cache.rglob("*.safetensors"))


def test_gguf_draft_serves_the_same_greedy_ids(tmp_path):
    """A GGUF draft (the model's own file) loads beside an HF target:
    speculative dispatches run and the greedy text is the target's
    alone."""
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend

    hf_dir, model = _hf_llama(tmp_path, moe=False, vocab=300)  # bytes
    _convert_to_gguf(model, tmp_path / "draft.gguf")
    out = []
    for draft in ("", "draft.gguf"):
        b = TorchLLMBackend("cpu")
        res = b.load_model(ModelLoadOptions(
            model=hf_dir, model_path=str(tmp_path), context_size=64,
            batch_slots=2, dtype="float32", draft_model=draft, n_draft=3))
        try:
            assert res.success, res.message
            out.append(_served_ids(b, "hi", 12)[1:])
            if draft:
                assert b.engine.draft is not None
                assert b.engine_stats()["spec_dispatches"] > 0
        finally:
            b.shutdown()
    assert out[0] == out[1]


def test_gguf_without_vocabulary_fails_the_load(tmp_path):
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend

    write_tiny_gguf(tmp_path / "novocab.gguf", tokenizer=[])
    b = TorchLLMBackend("cpu")
    res = b.load_model(ModelLoadOptions(
        model="novocab.gguf", model_path=str(tmp_path), context_size=64,
        batch_slots=2, dtype="float32"))
    assert not res.success and "tokenizer.ggml.tokens" in res.message
    res = b.load_model(ModelLoadOptions(
        model="missing.gguf", model_path=str(tmp_path)))
    assert not res.success and "not found" in res.message


def test_parameters_shorthand_names_the_gguf():
    from localai_tfp_tpu_torch.config.model_config import ModelConfig

    assert ModelConfig.from_dict({"name": "m", "parameters":
                                  "llama.Q4_K_M.gguf"}).model == \
        "llama.Q4_K_M.gguf"
    cfg = ModelConfig.from_dict({"name": "m", "parameters": {
        "model": "x.gguf"}, "lora_adapter": "a", "lora_scale": 0.5})
    assert cfg.model == "x.gguf"
    assert (cfg.lora_adapter, cfg.lora_scale) == ("a", 0.5)
