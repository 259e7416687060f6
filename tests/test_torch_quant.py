"""The port's int8 quantization (localai_tfp_tpu_torch/models/quant.py)
against the JAX package's (localai_tfp_tpu/models/quant.py), on the CPU,
on the same numpy inputs.

Quantizers: on f32 inputs, bf16 inputs, and f32 values served at bf16
(rounded to bf16 first). Tolerance as tests/test_staging.py's
``_tree_equal``: int8 codes equal, or one code apart on under 0.5 % of the
elements (a value on a rounding knife edge); scales rtol 1e-6.
``mm``: an eligible shape (the kernel's plain version here) and an odd
shape (the upcast product), rtol and atol 2e-4 as tests/test_int8_matmul.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.models import quant as jq
from localai_tfp_tpu_torch.models import quant as tq
from localai_tfp_tpu_torch.models.convert import params_from_numpy, to_tensor


def assert_qtensor_close(got, want, name=""):
    """The port's QTensor against a JAX QTensor (test_staging's rule)."""
    assert isinstance(got, tq.QTensor), name
    qa = got.q.numpy().astype(np.int32)
    qb = np.asarray(want.q).astype(np.int32)
    assert qa.shape == qb.shape, (name, qa.shape, qb.shape)
    diff = np.abs(qa - qb)
    assert diff.max() <= 1, (name, diff.max())
    assert (diff > 0).mean() < 0.005, (name, (diff > 0).mean())
    assert got.scale.dtype == torch.float32
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-6, err_msg=name)


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 0.05).astype(np.float32)


def _pair(w: np.ndarray, kind: str):
    """(jax array, torch tensor) of the same values: f32, bf16, or f32
    served at bf16 (the JAX side rounds with astype, the port with .to)."""
    if kind == "f32":
        return jnp.asarray(w), torch.from_numpy(w)
    if kind == "bf16":
        jb = jnp.asarray(w).astype(jnp.bfloat16)
        return jb, to_tensor(np.asarray(jb))
    return (jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32),
            torch.from_numpy(w).bfloat16().float())


KINDS = ["f32", "bf16", "f32-served-bf16"]


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_tensor_matches_jax(kind):
    jw, tw = _pair(_weights((3, 64, 48), 0), kind)
    assert_qtensor_close(tq.quantize_tensor(tw), jq.quantize_tensor(jw))


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_embed_matches_jax(kind):
    w = _weights((96, 32), 1)
    w[5] *= 40.0  # one high-norm row: per-row scales keep the others fine
    jw, tw = _pair(w, kind)
    assert_qtensor_close(tq.quantize_embed(tw), jq.quantize_embed(jw))


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_raw_tensor_matches_jax(kind):
    jw, tw = _pair(_weights((2, 48, 64), 2), kind)  # [L, out, in]
    got = tq.quantize_raw_tensor(tw)
    assert got.q.shape == (2, 64, 48) and got.q.is_contiguous()
    assert_qtensor_close(got, jq.quantize_raw_tensor(jw))
    # the same values as quantize_tensor on the transposed weight
    again = tq.quantize_tensor(tw.transpose(-1, -2))
    assert torch.equal(got.q, again.q) and torch.equal(got.scale, again.scale)


@pytest.mark.parametrize("embeddings", [False, True],
                         ids=["int8", "int8_full"])
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_params_matches_jax(kind, embeddings):
    shapes = {"embed": (64, 32), "wq": (2, 32, 32), "wk": (2, 32, 16),
              "wv": (2, 32, 16), "wo": (2, 32, 32), "w_gate": (2, 32, 64),
              "w_up": (2, 32, 64), "w_down": (2, 64, 32),
              "ln1_w": (2, 32), "lm_head": (32, 64)}
    jtree, ttree = {}, {}
    for i, (k, s) in enumerate(shapes.items()):
        jtree[k], ttree[k] = _pair(_weights(s, 10 + i), kind)
    jout = jq.quantize_params(jtree, embeddings=embeddings)
    tout = tq.quantize_params(ttree, embeddings=embeddings)
    assert set(tout) == set(jout)
    for k in tout:
        if isinstance(jout[k], jq.QTensor):
            assert_qtensor_close(tout[k], jout[k], k)
        else:
            assert not isinstance(tout[k], tq.QTensor), k
            assert torch.equal(tout[k], ttree[k])
    quantized = set(tq.QUANTIZABLE) | ({"embed", "lm_head"} if embeddings
                                       else set())
    assert {k for k, v in tout.items() if isinstance(v, tq.QTensor)} == \
        quantized
    # already-quantized leaves pass through untouched
    again = tq.quantize_params(tout, embeddings=embeddings)
    assert all(again[k] is tout[k] for k in tout)


def test_dequantize_matches_jax():
    w = _weights((2, 32, 24), 3)
    jt_, tt_ = jq.quantize_tensor(jnp.asarray(w)), \
        tq.quantize_tensor(torch.from_numpy(w))
    np.testing.assert_allclose(tq.dequantize(tt_).numpy(),
                               np.asarray(jq.dequantize(jt_)), rtol=1e-6,
                               atol=0)
    plain = torch.ones(3)
    assert tq.dequantize(plain) is plain


def test_qtensor_layer_slices_both_planes():
    qt = tq.quantize_tensor(torch.from_numpy(_weights((3, 16, 8), 4)))
    one = qt.layer(1)
    assert torch.equal(one.q, qt.q[1]) and torch.equal(one.scale, qt.scale[1])
    # indexing the tuple itself would return a field, not a layer
    assert qt[1] is qt.scale


def test_convert_carries_jax_qtensor_leaves():
    w = _weights((2, 32, 16), 5)
    jtree = {"wq": jq.quantize_tensor(jnp.asarray(w)),
             "ln1_w": jnp.ones((2, 32), jnp.float32)}
    got = params_from_numpy(jtree, dtype=torch.bfloat16)
    assert isinstance(got["wq"], tq.QTensor)
    assert got["wq"].q.dtype == torch.int8
    assert got["wq"].scale.dtype == torch.float32  # dtype casts neither
    assert got["ln1_w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["wq"].q.numpy(),
                                  np.asarray(jtree["wq"].q))


def _mm_case(k, n, seed):
    w = _weights((k, n), seed)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, 4, k)).astype(np.float32)
    jqt = jq.quantize_tensor(jnp.asarray(w))
    tqt = tq.QTensor(torch.from_numpy(np.array(jqt.q)),
                     torch.from_numpy(np.array(jqt.scale)))
    return x, jqt, tqt


@pytest.mark.parametrize("jax_kernel", ["1", "0"], ids=["pallas", "xla"])
@pytest.mark.parametrize("k,n,kernel", [(512, 512, True), (96, 64, False)],
                         ids=["eligible", "odd"])
def test_mm_matches_jax(monkeypatch, k, n, kernel, jax_kernel):
    """The port's mm on a QTensor against the JAX mm (its Pallas kernel in
    interpret mode, or its XLA path); the port sends only eligible shapes
    to the int8 wrapper."""
    x, jqt, tqt = _mm_case(k, n, seed=k + n)
    monkeypatch.setenv("LOCALAI_INT8_KERNEL", jax_kernel)
    want = np.asarray(jq.mm(jnp.asarray(x), jqt))
    calls = []
    real = tq.int8_matmul

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tq, "int8_matmul", spy)
    got = tq.mm(torch.from_numpy(x), tqt)
    assert calls == ([(8, k)] if kernel else [])
    assert got.shape == (2, 4, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # a plain weight is a plain product
    wd = tq.dequantize(tqt)
    assert torch.equal(tq.mm(torch.from_numpy(x), wd),
                       torch.from_numpy(x) @ wd)
