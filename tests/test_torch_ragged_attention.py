"""The port's ragged paged attention (localai_tfp_tpu_torch/ops/
ragged_paged_attention.py) against the JAX package's.

On the CPU the wrapper takes its plain PyTorch version; it is held
against the JAX oracle ``ragged_attention_reference`` (f32, tolerance
1e-5) and against the Pallas kernel itself run in interpret mode
(tolerance 1e-4: the online softmax sums in another order), on the row
mixes of ops/kernel_check.check_ragged_attention — decode, prefill,
mixed, verify — with shuffled page tables, f32 and int8 pages, seeded
decode and a sliding window (cases from tests/test_torch_cuda.py, whose
``cuda``-marked tests hold the hand-written kernel against the plain
version on a card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.models.transformer import (
    _quantize_rows as jax_quantize_rows,
)
from localai_tfp_tpu.ops.ragged_paged_attention import (
    ragged_attention_reference, ragged_paged_attention as jax_ragged,
)
from localai_tfp_tpu_torch.models.transformer import _quantize_rows
from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
    from_rows, ragged_paged_attention, to_rows,
)
from tests.test_torch_cuda import B, CASES, DH, H, HKV, PAGE, make_case


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(fn, c, as_array, layer=1):
    seed = c.get("seed_kv")
    return fn(
        as_array(c["q"]), as_array(c["cache_k"]), as_array(c["cache_v"]),
        layer,
        as_array(c["page_table"]), as_array(c["pos0"]),
        as_array(c["q_lens"]), HKV, scale=DH ** -0.5, page=PAGE,
        sliding_window=c["window"],
        cache_k_scale=(as_array(c["cache_k_scale"])
                       if "cache_k_scale" in c else None),
        cache_v_scale=(as_array(c["cache_v_scale"])
                       if "cache_v_scale" in c else None),
        seed_kv=None if seed is None else tuple(as_array(s) for s in seed))


@pytest.mark.parametrize("mix,quant,seeded,window", CASES)
def test_plain_matches_jax(mix, quant, seeded, window):
    c = make_case(mix, quant, seeded, seed=len(mix) + 3 * quant,
                  window=window)
    got = _run(ragged_paged_attention, c, torch.from_numpy).numpy()
    assert got.dtype == np.float32 and got.shape == (
        B, c["q"].shape[1], H * DH)
    layer = jnp.asarray(1, jnp.int32)
    want = np.asarray(_run(ragged_attention_reference, c, jnp.asarray,
                           layer))
    # f32 everywhere: only summation order differs from the dense oracle
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    kern = np.asarray(_run(jax_ragged, c, jnp.asarray, layer))
    # the Pallas kernel's online softmax sums page by page; pad queries
    # beyond each row's q_len are garbage by its contract
    for b, n in enumerate(c["q_lens"]):
        np.testing.assert_allclose(got[b, :n], kern[b, :n], rtol=0,
                                   atol=1e-4)


def test_quantize_rows_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 32)).astype(
        np.float32)
    q, s = _quantize_rows(torch.from_numpy(x))
    jq, js = jax_quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_row_layout_round_trip():
    """[B, T, H, Dh] -> the kernel's [B, Hkv*G, Dh] rows (row
    (h*group+g)*T + t, as the JAX wrapper lays them out) and back."""
    q = torch.randn(2, 3, H, DH)
    rows = to_rows(q, HKV)
    group = H // HKV
    assert rows.shape == (2, HKV * group * 3, DH) and rows.is_contiguous()
    assert torch.equal(rows[1, (1 * group + 1) * 3 + 2], q[1, 2, 1 * group + 1])
    assert torch.equal(from_rows(rows, 3, HKV, group), q.reshape(2, 3, -1))


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor may take the plain version: any other device must
    launch the kernel or raise (here: a meta tensor raises)."""
    c = make_case("decode", False, False, seed=0)
    meta = {k: (torch.from_numpy(v).to("meta") if isinstance(v, np.ndarray)
                else v) for k, v in c.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        _run(ragged_paged_attention, meta, lambda a: a)
