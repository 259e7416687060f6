"""Mixtures of experts — Mixtral, Qwen2-MoE and Qwen3-MoE — through the
port against the JAX package, on the CPU.

- ``forward``: tiny specs of each family (Qwen2-MoE with a shared expert,
  raw top-k weights and a dense-only layer; Qwen3-MoE with q/k norms and
  renormalized weights) through JAX ``init_params``, carried across by
  ``convert``: the port's paged logits (two ragged prefill chunks, then
  two decode steps) within 1e-4 of JAX ``forward`` in f32.
- Checkpoints: ``transformers`` ``save_pretrained`` of each family
  (Qwen2-MoE with ``mlp_only_layers`` and ``decoder_sparse_step`` 2, so
  two of its four layers are dense) through both loaders: trees bitwise
  equal in f32; in bf16 with ``quantize="int8"`` bitwise equal to JAX
  ``quantize_params``, the expert, shared-expert and router stacks still
  bf16, only the attention projections int8.
- The router: ties at the k-th value admit the lower expert, as
  ``lax.top_k`` does; router logits within 1e-6 of JAX's f32 HIGHEST
  product.
- Serving: greedy text of the three checkpoints through the JAX server
  and the port's server (its decode and mixed steps through the graph
  variant path) byte-identical.
- The refusal the JAX loader keeps: Qwen2-MoE dense layers whose shared
  expert is narrower than ``intermediate_size``.
"""

import asyncio
import json
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
from localai_tfp_tpu_torch.models import hf_loader as thf  # noqa: E402
from localai_tfp_tpu_torch.models import llm_spec as tspec  # noqa: E402
from localai_tfp_tpu_torch.models import quant as tq  # noqa: E402
from localai_tfp_tpu_torch.models import transformer as tt  # noqa: E402
from localai_tfp_tpu_torch.models.convert import params_from_numpy  # noqa

TOL = 1e-4
PAGE, MAX_PAGES = 8, 4
SPECS = {
    "mixtral": dict(n_experts=4, experts_per_token=2),
    "qwen2_moe": dict(n_experts=6, experts_per_token=2, moe_d_ff=48,
                      moe_shared_expert=True, moe_shared_d_ff=128,
                      moe_norm_topk=False, moe_dense_layers=(1,),
                      qkv_bias=True),
    "qwen3_moe": dict(n_experts=8, experts_per_token=3, moe_d_ff=32,
                      qk_norm=True),
}
COMMON = dict(vocab_size=300, hidden_size=64, intermediate_size=128,
              num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=256)
FAMILIES = ("mixtral", "qwen2_moe", "qwen3_moe")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
            assert not isinstance(got[k], tq.QTensor), k
            np.testing.assert_array_equal(
                got[k].float().numpy(), np.asarray(v).astype(np.float32),
                err_msg=k)


PROMPT_LENS = (20, 14)
CHUNKS = (12, 8)


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(7).integers(
        0, vocab, (2, sum(CHUNKS) + 2)).astype(np.int32)


def _jax_logits(spec, params, toks: np.ndarray) -> list:
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
    """The same steps through the paged ragged path: rows carry only their
    valid tokens (q_lens), shuffled page tables."""
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
    for i, T in enumerate(CHUNKS):
        for b in range(2):
            n = int(np.clip(lens[b] - pos, 0, T))
            np.testing.assert_allclose(got[i][b, :n], want[i][b, :n],
                                       rtol=0, atol=TOL)
        pos += T
    for i in (2, 3):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_logits_match_jax(family):
    spec_j = jspec.tiny_spec(vocab_size=96, **SPECS[family])
    spec_t = tspec.tiny_spec(vocab_size=96, **SPECS[family])
    tt.check_supported(spec_t)
    jparams = jt.init_params(jax.random.PRNGKey(1), spec_j, jnp.float32)
    tree = {k: np.asarray(v) for k, v in jparams.items()}
    params = params_from_numpy(tree)
    _tree_equal(params, jparams)
    toks = _tokens(96)
    got = _port_logits(spec_t, params, toks)
    assert all(np.isfinite(g).all() for g in got)
    _assert_logits_match(got, _jax_logits(spec_j, jparams, toks))


# ---------------------------------------------------------- checkpoints


def _hf_model(family: str):
    from transformers import (MixtralConfig, MixtralForCausalLM,
                              Qwen2MoeConfig, Qwen2MoeForCausalLM,
                              Qwen3MoeConfig, Qwen3MoeForCausalLM)

    if family == "mixtral":
        return MixtralForCausalLM(MixtralConfig(
            **COMMON, num_hidden_layers=2, num_local_experts=4,
            num_experts_per_tok=2))
    if family == "qwen2_moe":
        # layers 0 and 2 dense (off the step-2 grid), 1 sparse, 3 listed
        # in mlp_only_layers: dense too
        return Qwen2MoeForCausalLM(Qwen2MoeConfig(
            **COMMON, num_hidden_layers=4, moe_intermediate_size=48,
            shared_expert_intermediate_size=128, num_experts=6,
            num_experts_per_tok=2, decoder_sparse_step=2,
            mlp_only_layers=[3], norm_topk_prob=False))
    if family == "qwen3_moe":
        return Qwen3MoeForCausalLM(Qwen3MoeConfig(
            **COMMON, num_hidden_layers=2, head_dim=16,
            moe_intermediate_size=32, num_experts=8, num_experts_per_tok=3,
            norm_topk_prob=True))
    raise ValueError(family)


def save_tiny(root, family: str, seed: int = 0) -> str:
    """A tiny checkpoint of ``family`` with every weight redrawn from a
    seed (matrices at 1/sqrt(fan-in), norms and biases around their
    identity), so routers, gates and biases move the logits."""
    torch.manual_seed(seed)
    model = _hf_model(family)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            r = torch.randn(p.shape, generator=g)
            if p.dim() >= 2:
                p.copy_(r * p.shape[-1] ** -0.5)
            elif name.endswith("bias"):
                p.copy_(0.1 * r)
            else:
                p.copy_(1.0 + 0.1 * r)
    d = root / family
    model.save_pretrained(d, safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe")
    return {f: save_tiny(root, f) for f in FAMILIES}


@pytest.mark.parametrize("family", FAMILIES)
def test_checkpoint_trees_and_logits_match_jax(ckpts, family):
    jspec_, jparams = jhf.load_params(ckpts[family], dtype=jnp.float32)
    spec, params = thf.load_params(ckpts[family], torch.float32)
    assert spec.n_experts == jspec_.n_experts > 0
    assert spec.moe_dense_layers == jspec_.moe_dense_layers
    if family == "qwen2_moe":
        assert spec.moe_dense_layers == (0, 2, 3)
    _tree_equal(params, jparams)
    toks = _tokens(spec.vocab_size)
    _assert_logits_match(_port_logits(spec, params, toks),
                         _jax_logits(jspec_, jparams, toks))


@pytest.mark.parametrize("family", FAMILIES)
def test_int8_tree_keeps_experts_bf16(ckpts, family):
    """``quantization: int8``: the attention projections are the JAX
    package's int8 codes and scales bit for bit; router, expert and
    shared-expert stacks stay bf16, bitwise equal to JAX's."""
    _, jparams = jhf.load_params(ckpts[family], dtype=jnp.bfloat16)
    jtree = jq.quantize_params(jparams)
    spec, params = thf.load_params(ckpts[family], torch.bfloat16,
                                   quantize="int8")
    _tree_equal(params, jtree)
    quantized = {k for k, v in params.items() if isinstance(v, tq.QTensor)}
    assert quantized == {"wq", "wk", "wv", "wo"}
    for k in params:
        if k.startswith(("moe_", "shared_")) or k == "router":
            assert params[k].dtype == torch.bfloat16, k
    # the same tree from quantize_params over the bf16 load
    _, full = thf.load_params(ckpts[family], torch.bfloat16)
    _tree_equal(tq.quantize_params(full), jtree)


def test_qwen2_moe_narrow_shared_expert_with_dense_layers_is_refused(
        tmp_path):
    from transformers import Qwen2MoeConfig, Qwen2MoeForCausalLM

    Qwen2MoeForCausalLM(Qwen2MoeConfig(
        **COMMON, num_hidden_layers=2, moe_intermediate_size=48,
        shared_expert_intermediate_size=64, num_experts=4,
        num_experts_per_tok=2, decoder_sparse_step=2)).save_pretrained(
        tmp_path / "q", safe_serialization=True)
    for load in (lambda: jhf.load_params(str(tmp_path / "q"),
                                         dtype=jnp.float32),
                 lambda: thf.load_params(str(tmp_path / "q"),
                                         torch.float32)):
        with pytest.raises(NotImplementedError,
                           match="shared_expert_intermediate_size"):
            load()


# ---------------------------------------------------------------- router


def test_top_k_ties_pick_the_lower_expert():
    """Equal scores at the k-th place admit the lower index, as
    ``lax.top_k`` does; the gate is a one-hot sum, so membership is what
    must agree."""
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (64, 12)).astype(np.float32)
    for k in (1, 2, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
        tv, ti = tt._top_k(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_router_logits_match_jax_highest():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((9, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 16)) * 0.02).astype(np.float32)
    want = np.asarray(jnp.einsum("td,de->te", x, w,
                                 precision=jax.lax.Precision.HIGHEST))
    got = tt._router_logits(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- serving

GO_YAML = """
name: {name}
backend: jax-llm
parameters:
  model: {ckpt}
  temperature: 0.0
  max_tokens: 12
context_size: 256
max_batch_slots: 4
dtype: float32
template:
  chat_message: |-
    <|{{{{ .RoleName }}}}|>{{{{ .Content }}}}
  chat: |
    {{{{.Input }}}}
    <|assistant|>
"""
CHATS = [
    [{"role": "user", "content": "Hello!"}],
    [{"role": "user", "content": "Count: one two three four five six"},
     {"role": "assistant", "content": "seven"},
     {"role": "user", "content": "and then?"}],
]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_served")
    models = root / "models"
    models.mkdir()
    for f in FAMILIES:
        save_tiny(models, f, seed=3)
        for i in range(len(CHATS)):  # one model per chat
            (models / f"{f}-{i}.yaml").write_text(GO_YAML.format(
                name=f"{f}-{i}", ckpt=f))
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
              for f in FAMILIES for i, m in enumerate(CHATS)]
    want = _jax_chat(served, bodies)
    got = _port_chat(served, bodies)
    for (js, jo), (ps, po) in zip(want, got):
        assert js == ps == 200, (jo, po)
        assert po["choices"][0]["message"]["content"] == \
            jo["choices"][0]["message"]["content"]
        assert po["usage"]["prompt_tokens"] == jo["usage"]["prompt_tokens"]
        assert po["usage"]["completion_tokens"] == \
            jo["usage"]["completion_tokens"] == 12


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("what", ["mixed", "decode"])
def test_moe_variant_bodies_read_no_host_value(family, what):
    """The expert MLP inside a variant body reads only engine state and
    earlier ops' outputs (no host value becomes a tensor), so a card
    captures it into the decode and mixed graphs as it does the dense
    MLP."""
    from localai_tfp_tpu_torch.engine.engine import LLMEngine
    from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer

    from .test_torch_mixed_graphs import _Foreign, _storages

    spec_j = jspec.tiny_spec(vocab_size=258, **SPECS[family])
    jparams = jt.init_params(jax.random.PRNGKey(2), spec_j, jnp.float32)
    eng = LLMEngine(tspec.tiny_spec(vocab_size=258, **SPECS[family]),
                    params_from_numpy({k: np.asarray(v)
                                       for k, v in jparams.items()}),
                    ByteTokenizer(), n_slots=4, max_seq=256,
                    prefill_buckets=(8, 32), cache_dtype=torch.float32,
                    device="cpu", autostart=False)
    v = eng._new_mixed(4, 32) if what == "mixed" else eng._new_variant(4)
    body = eng._mixed_body if what == "mixed" else eng._decode_body
    known = _storages([eng.params, eng.cache, eng.sampling, v,
                       eng._mask_dev], set())
    try:
        with torch.inference_mode(), _Foreign(known) as spy:
            body(v)
        assert spy.found == []
    finally:
        eng.close()
