"""The port's encoder (localai_tfp_tpu_torch/models/encoder.py) against
the JAX package's (localai_tfp_tpu/models/encoder.py) on the same
weights, in f32 on the CPU.

- ``encode``, ``mean_pool`` and ``classify`` within 1e-5 absolute, on
  weights from the JAX ``init_encoder_params`` carried across by
  ``encoder_params_from_jax``: two batch shapes with padded rows, with
  and without type ids, a 1-class and a 3-class head; padded rows stay
  finite.
- ``load_encoder_params`` on transformers ``save_pretrained`` checkpoints
  (``BertModel``, ``BertForSequenceClassification`` with 1 and 3 labels,
  a bare-prefix layout) gives the JAX loader's tree bitwise and the same
  spec, and the hidden states of transformers' own ``BertModel`` within
  1e-5.
- ``f32_products`` keeps TF32 off while it runs and puts the process's
  setting back after.
"""

import jax
import numpy as np
import pytest
import torch

from localai_tfp_tpu.models import encoder as je
from localai_tfp_tpu_torch.device import f32_products
from localai_tfp_tpu_torch.models import encoder as te
from localai_tfp_tpu_torch.models.convert import encoder_params_from_jax

TOL = 1e-5  # absolute, f32 on both sides


def _jax_params(spec, seed: int) -> dict:
    """JAX init with non-zero biases and LayerNorm affines, as numpy."""
    p = je.init_encoder_params(jax.random.PRNGKey(seed), spec)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in p.items():
        a = np.asarray(v, np.float32)
        if k.startswith("b") or k.endswith("_b"):
            a = a + rng.standard_normal(a.shape).astype(np.float32) * 0.02
        if k.endswith("ln_w"):
            a = a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        out[k] = a
    return out


def _inputs(B: int, T: int, seed: int, vocab: int):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, T)).astype(np.int32)
    lens = rng.integers(1, T + 1, B)
    lens[0] = T  # one full row beside padded ones
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.int32)
    types = ((np.arange(T)[None, :] >= (lens // 2)[:, None]) & (mask > 0)
             ).astype(np.int32)
    return toks, mask, types


@pytest.mark.parametrize("n_classes", [0, 1, 3])
@pytest.mark.parametrize("shape", [(3, 16), (5, 40)])
@pytest.mark.parametrize("with_types", [False, True])
def test_encode_pool_classify_match_jax(n_classes, shape, with_types):
    spec_j = je.tiny_encoder_spec(n_classes=n_classes)
    spec_t = te.tiny_encoder_spec(n_classes=n_classes)
    tree = _jax_params(spec_j, seed=n_classes + 7)
    params = encoder_params_from_jax(tree)
    toks, mask, types = _inputs(*shape, seed=shape[0], vocab=spec_j.vocab_size)
    jt = types if with_types else None
    want = np.asarray(je.encode(spec_j, tree, toks, mask, jt))
    got = te.encode(spec_t, params, torch.from_numpy(toks),
                    torch.from_numpy(mask),
                    torch.from_numpy(types) if with_types else None)
    assert got.dtype == torch.float32
    assert torch.isfinite(got).all()  # padded rows too
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    pooled = te.mean_pool(got, torch.from_numpy(mask))
    np.testing.assert_allclose(
        pooled.numpy(), np.asarray(je.mean_pool(want, mask)), rtol=0,
        atol=TOL)
    np.testing.assert_allclose(pooled.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    if n_classes:
        logits = te.classify(spec_t, params, got)
        assert logits.shape == (shape[0], n_classes)
        np.testing.assert_allclose(
            logits.numpy(), np.asarray(je.classify(spec_j, tree, want)),
            rtol=0, atol=TOL)


def _checkpoints(root):
    from transformers import (BertConfig, BertForSequenceClassification,
                              BertModel)

    kw = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64,
              max_position_embeddings=64)
    torch.manual_seed(0)
    BertModel(BertConfig(**kw)).save_pretrained(root / "bi",
                                                safe_serialization=True)
    for labels in (1, 3):
        torch.manual_seed(labels)
        BertForSequenceClassification(BertConfig(num_labels=labels, **kw)
                                      ).save_pretrained(
            root / f"cross{labels}", safe_serialization=True)
    return kw


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("enc_ckpts")
    _checkpoints(root)
    return root


@pytest.mark.parametrize("name", ["bi", "cross1", "cross3"])
def test_loader_matches_jax_loader(ckpts, name):
    spec_j, tree = je.load_encoder_params(str(ckpts / name))
    spec_t, params = te.load_encoder_params(str(ckpts / name))
    assert spec_t.n_classes == spec_j.n_classes == (
        0 if name == "bi" else int(name[-1]))
    for f in ("vocab_size", "d_model", "n_layers", "n_heads", "d_ff",
              "max_position", "type_vocab_size", "norm_eps"):
        assert getattr(spec_t, f) == getattr(spec_j, f)
    assert sorted(params) == sorted(tree)
    for k in tree:
        assert params[k].dtype == torch.float32
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(tree[k]))


def test_bi_encoder_hidden_states_match_transformers(ckpts):
    from transformers import BertModel

    spec, params = te.load_encoder_params(str(ckpts / "bi"))
    toks, mask, types = _inputs(3, 20, seed=1, vocab=spec.vocab_size)
    ref = BertModel.from_pretrained(str(ckpts / "bi")).eval()
    with torch.no_grad():
        want = ref(input_ids=torch.from_numpy(toks).long(),
                   attention_mask=torch.from_numpy(mask).long(),
                   token_type_ids=torch.from_numpy(types).long()
                   ).last_hidden_state
    got = te.encode(spec, params, torch.from_numpy(toks),
                    torch.from_numpy(mask), torch.from_numpy(types))
    real = torch.from_numpy(mask).bool()
    np.testing.assert_allclose(got[real].numpy(), want[real].numpy(),
                               rtol=0, atol=TOL)


def test_bare_prefix_checkpoint_loads(ckpts, tmp_path):
    """A checkpoint whose names have no ``bert.`` prefix (as
    sentence-transformers writes ``BertModel``) reads the same tree."""
    from localai_tfp_tpu_torch.models.safetensors_io import (
        SafeTensorsFile, save_file)

    src = ckpts / "cross1"
    f = SafeTensorsFile(str(src / "model.safetensors"))
    tensors = {(k[len("bert."):] if k.startswith("bert.") else k): f.get(k)
               for k in f.keys()}
    tmp_path.joinpath("config.json").write_text(
        (src / "config.json").read_text())
    save_file(tensors, str(tmp_path / "model.safetensors"))
    spec_a, a = te.load_encoder_params(str(src))
    spec_b, b = te.load_encoder_params(str(tmp_path))
    assert spec_a == spec_b and sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_f32_products_restores_the_process_setting():
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with f32_products():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            with f32_products():  # nested (two encodes at once)
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_f32_products_under_concurrent_encodes():
    """Many threads entering and leaving at once: TF32 stays off while any
    is inside, and the process's setting is back when all have left."""
    import sys
    import threading

    saved = torch.backends.cuda.matmul.allow_tf32
    interval = sys.getswitchinterval()
    bad = []

    def worker():
        for _ in range(200):
            with f32_products():
                if torch.backends.cuda.matmul.allow_tf32:
                    bad.append(1)

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert bad == []
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cuda.matmul.allow_tf32 = saved
