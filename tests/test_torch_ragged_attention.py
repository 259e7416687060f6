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
    KV_TILE, MERGE_ROWS, NEG_INF, _plan, ragged_paged_attention,
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


H100_SMS = 132


@pytest.mark.parametrize("B,hkv,T,group,ctx", [
    (8, 8, 1, 4, 2048), (8, 8, 4, 4, 2048), (8, 8, 512, 4, 2048),
    (8, 8, 256, 4, 2048), (1, 8, 1, 4, 131072), (2, 2, 1, 4, 1024),
    (4, 2, 1, 2, 32), (3, 1, 7, 7, 300), (1, 4, 2048, 8, 8192),
])
def test_plan_splits_in_whole_tiles(B, hkv, T, group, ctx):
    """The kernel's plan: 16-row query tiles when a row's T * group rows
    fit, else 64; split lengths are whole 64-token tiles; the splits
    cover the kv range and none is empty."""
    bm, qtiles, splits, split_len = _plan(B, hkv, T, group, ctx, H100_SMS)
    assert bm == (16 if T * group <= 16 else 64)
    assert qtiles == -(-T * group // bm)
    assert split_len % KV_TILE == 0 and split_len > 0
    assert splits * split_len >= ctx > (splits - 1) * split_len
    assert (splits + 1) * bm <= MERGE_ROWS


def test_plan_fills_the_card_at_the_decode_shape():
    """The chip's decode step (8 rows, 8 kv heads, 8 pages of 256) has
    64 (row, kv head) blocks on 132 SMs: the kv range splits until the
    grid holds about four blocks per SM. A 512-token or 256-token mixed
    step already fills the card with query tiles and does not split."""
    bm, qtiles, splits, split_len = _plan(8, 8, 1, 4, 8 * 256, H100_SMS)
    assert (bm, qtiles) == (16, 1)
    assert 8 * 8 * qtiles * splits >= 3 * H100_SMS and splits > 1
    for T in (512, 256):
        bm, qtiles, splits, _ = _plan(8, 8, T, 4, 8 * 256, H100_SMS)
        assert bm == 64 and 8 * 8 * qtiles >= 4 * H100_SMS
        assert splits == 1


def split_merge_attention(c: dict, split_len: int) -> torch.Tensor:
    """The kernel's split-and-merge rule stated in torch (f32): for each
    query, a partial (m, l, acc) over every split_len-token range of the
    row's window — a range with no visible position has m = NEG_INF and
    l = 0 and adds nothing — then the partials merged in split order."""
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in c.items()}
    q, pt = t["q"], t["page_table"].long()
    B, T, H, Dh = q.shape
    W = pt.shape[1] * PAGE
    k = t["cache_k"][1][pt].reshape(B, W, -1).float()
    v = t["cache_v"][1][pt].reshape(B, W, -1).float()
    if "cache_k_scale" in t:
        k = k * t["cache_k_scale"][1][pt].reshape(B, W)[..., None]
        v = v * t["cache_v_scale"][1][pt].reshape(B, W)[..., None]
    if "seed_kv" in c:
        rows = torch.arange(B)
        k[rows, t["pos0"].long()] = torch.from_numpy(c["seed_kv"][0])
        v[rows, t["pos0"].long()] = torch.from_numpy(c["seed_kv"][1])
    heads = torch.arange(H) // (H // HKV)
    kh = k.reshape(B, W, HKV, Dh)[:, :, heads]
    vh = v.reshape(B, W, HKV, Dh)[:, :, heads]
    s = torch.einsum("bthd,bshd->bhts", q, kh) * DH ** -0.5
    kv = torch.arange(W)[None, None, None, :]
    tq = torch.arange(T)
    qpos = (t["pos0"].long()[:, None] + tq[None])[:, None, :, None]
    mask = (kv <= qpos) & (tq[None, None, :, None]
                           < t["q_lens"].long()[:, None, None, None])
    if c["window"] is not None:
        mask &= kv > qpos - c["window"]
    s = s.masked_fill(~mask, NEG_INF)
    parts = []
    for lo in range(0, W, split_len):
        ss, mm = s[..., lo:lo + split_len], mask[..., lo:lo + split_len]
        m = ss.amax(-1)
        p = torch.where(mm, torch.exp(ss - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum(
            "bhts,bshd->bhtd", p, vh[:, lo:lo + split_len])))
    m = torch.stack([pm for pm, _, _ in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, H, T, Dh)
    for pm, pl, pa in parts:  # in split order
        w = torch.where(pl > 0, torch.exp(pm - m), 0.0)
        l = l + pl * w
        acc = acc + pa * w[..., None]
    out = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None],
                      0.0)
    return out.permute(0, 2, 1, 3).reshape(B, T, H * Dh)


SPLIT_CASES = [case + (split_len,) for case in CASES for split_len in (8, 16)]
# windows that leave whole splits of a row's range with nothing visible
SPLIT_CASES += [("decode", False, False, 3, 8), ("decode", True, True, 2, 8),
                ("mixed", False, False, 4, 8), ("prefill", True, False, 9, 16)]


@pytest.mark.parametrize("mix,quant,seeded,window,split_len", SPLIT_CASES)
def test_split_merge_rule_matches_jax(mix, quant, seeded, window, split_len):
    c = make_case(mix, quant, seeded, seed=len(mix) + 5 * quant,
                  window=window)
    got = split_merge_attention(c, split_len).numpy()
    want = np.asarray(_run(ragged_attention_reference, c, jnp.asarray,
                           jnp.asarray(1, jnp.int32)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor may take the plain version: any other device must
    launch the kernel or raise (here: a meta tensor raises)."""
    c = make_case("decode", False, False, seed=0)
    meta = {k: (torch.from_numpy(v).to("meta") if isinstance(v, np.ndarray)
                else v) for k, v in c.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        _run(ragged_paged_attention, meta, lambda a: a)
