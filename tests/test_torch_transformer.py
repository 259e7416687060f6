"""The port's transformer forward (localai_tfp_tpu_torch/models/
transformer.py) against the JAX package's ``forward``, in f32 on the CPU
on the same weights (carried across by models/convert.py).

Families: Llama (with a llama3 rope_scaling block), Mistral (uniform
sliding window), Qwen2 (qkv bias), Qwen3 (per-head q/k norm). Paths: the
dense cache and the paged ragged arena (scatter through the write table,
one ragged attention call per layer), each for a prefill (T > 1, ragged
row lengths) followed by a decode step (T == 1, the seeded contract).
Logits must agree within 1e-4 (f32; summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.models import llm_spec as jspec
from localai_tfp_tpu.models import transformer as jt
from localai_tfp_tpu_torch.models import llm_spec as tspec
from localai_tfp_tpu_torch.models import transformer as tt
from localai_tfp_tpu_torch.models.convert import params_from_numpy

FAMILIES = {
    "llama": dict(rope_theta=500000.0, rope_scaling={
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 64}),
    "mistral": dict(sliding_window=5),
    "qwen2": dict(qkv_bias=True),
    "qwen3": dict(qk_norm=True),
}
B, T, PAGE, MAX_PAGES = 2, 6, 8, 4
LENS = np.asarray([6, 4], np.int32)  # ragged prefill rows
TOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(family: str):
    kw = FAMILIES[family]
    spec_j = jspec.tiny_spec(vocab_size=64, **kw)
    spec_t = tspec.tiny_spec(vocab_size=64, **kw)
    params = jt.init_params(jax.random.PRNGKey(3), spec_j, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    tree = {}
    for k, v in params.items():
        a = np.asarray(v)
        if k in ("bq", "bk", "bv", "q_norm_w", "k_norm_w"):
            # zero/one at init: perturb so the family's extra weights matter
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        tree[k] = a
    return spec_j, spec_t, tree


def _tokens(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 64, shape).astype(np.int32)


def _paged_tables():
    pt = np.random.default_rng(5).permutation(
        np.arange(1, B * MAX_PAGES + 1)).reshape(B, MAX_PAGES).astype(np.int32)
    return pt, B * MAX_PAGES + 1


def _run_jax(spec, tree, paged: bool):
    params = {k: jnp.asarray(v) for k, v in tree.items()}
    toks = jnp.asarray(_tokens(0, (B, T)))
    nxt = jnp.asarray(_tokens(1, (B, 1)))
    lens = jnp.asarray(LENS)
    if not paged:
        cache = jt.KVCache.create(spec, B, 32, jnp.float32)
        lg1, cache = jt.forward(spec, params, toks, jnp.zeros(B, jnp.int32),
                                cache, None)
        lg2, _ = jt.forward(spec, params, nxt, lens, cache, None)
        return np.asarray(lg1), np.asarray(lg2)
    pt, n_pages = _paged_tables()
    pt = jnp.asarray(pt)
    cache = jt.KVCache.create(spec, n_pages, PAGE, jnp.float32)
    kw = dict(page_table=pt, kv_page=PAGE, write_table=pt)
    lg1, cache = jt.forward(spec, params, toks, jnp.zeros(B, jnp.int32),
                            cache, None, q_lens=lens, **kw)
    lg2, _ = jt.forward(spec, params, nxt, lens, cache, None,
                        q_lens=jnp.ones(B, jnp.int32), **kw)
    return np.asarray(lg1), np.asarray(lg2)


def _run_torch(spec, tree, paged: bool):
    params = params_from_numpy(tree)
    toks = torch.from_numpy(_tokens(0, (B, T)))
    nxt = torch.from_numpy(_tokens(1, (B, 1)))
    lens = torch.from_numpy(LENS)
    if not paged:
        cache = tt.KVCache.create(spec, B, 32, torch.float32)
        lg1, cache = tt.forward(spec, params, toks,
                                torch.zeros(B, dtype=torch.int32), cache)
        lg2, _ = tt.forward(spec, params, nxt, lens, cache)
        return lg1.numpy(), lg2.numpy()
    pt, n_pages = _paged_tables()
    pt = torch.from_numpy(pt)
    cache = tt.KVCache.create(spec, n_pages, PAGE, torch.float32)
    kw = dict(page_table=pt, kv_page=PAGE, write_table=pt)
    lg1, cache = tt.forward(spec, params, toks,
                            torch.zeros(B, dtype=torch.int32), cache,
                            q_lens=lens, **kw)
    lg2, _ = tt.forward(spec, params, nxt, lens, cache,
                        q_lens=torch.ones(B, dtype=torch.int32), **kw)
    return lg1.numpy(), lg2.numpy()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_match_jax_forward(family, paged):
    spec_j, spec_t, tree = _model(family)
    want1, want2 = _run_jax(spec_j, tree, paged)
    got1, got2 = _run_torch(spec_t, tree, paged)
    assert got1.dtype == np.float32 and got1.shape == want1.shape
    for b, n in enumerate(LENS):  # prefill: each row's valid positions
        np.testing.assert_allclose(got1[b, :n], want1[b, :n], rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(got2, want2, rtol=0, atol=TOL)  # decode


def test_rope_inv_freq_llama3_matches_jax():
    spec_j, spec_t, _ = _model("llama")
    np.testing.assert_allclose(tt.rope_inv_freq(spec_t).numpy(),
                               np.asarray(jt.rope_inv_freq(spec_j)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("over", [
    dict(n_experts=4),  # mixtral / qwen-moe
    dict(sliding_window=4, sliding_window_pattern=2),  # gemma2/3 layers
    dict(attn_logit_softcap=50.0, logit_softcap=30.0),  # gemma2
    dict(norm_weight_plus_one=True, embedding_multiplier=8.0),  # gemma
    dict(parallel_residual=True, gated_mlp=False, hidden_act="gelu"),  # phi
    dict(o_bias=True, mlp_bias=True),  # phi biases
], ids=["moe", "window-pattern", "softcap", "gemma-norms", "phi", "biases"])
def test_unported_families_raise(over):
    """Features outside Llama/Mistral/Qwen2/Qwen3 raise rather than being
    silently computed as a Llama (the kernel has no softcap, say)."""
    spec = tspec.tiny_spec(vocab_size=64, **over)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tt.check_supported(spec)
    for family in FAMILIES:
        tt.check_supported(tspec.tiny_spec(vocab_size=64, **FAMILIES[family]))
