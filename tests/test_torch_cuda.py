"""Card-only tests of the PyTorch/CUDA port (marker ``cuda``).

This file imports no JAX, so it also runs on the GPU machine, which has
none. The suite's ``conftest.py`` imports jax, so run it there with

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Each test asks a fixture whether a card is present and skips without
one (collection is the same everywhere). The int8 kernel's tests hold it
against its plain version and check that its wrapper raises rather than
falls back. ``make_case`` is shared with
tests/test_torch_ragged_attention.py, which holds the plain version
against the JAX package on the same cases.
"""

import numpy as np
import pytest
import torch

from localai_tfp_tpu_torch.engine.engine import GenRequest, LLMEngine
from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
from localai_tfp_tpu_torch.models import transformer as tt
from localai_tfp_tpu_torch.models import quant as tq
from localai_tfp_tpu_torch.models.llm_spec import tiny_spec
from localai_tfp_tpu_torch.ops.int8_matmul import (
    int8_matmul, int8_matmul_plain, plan,
)
from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
    ragged_attention_plain, ragged_paged_attention,
)

L, HKV, DH, H, PAGE, B, MAX_PAGES = 2, 2, 16, 4, 8, 4, 4


def make_case(mix: str, quant: bool, seeded: bool, seed: int,
              window=None, dh: int = DH) -> dict:
    """Numpy inputs in the style of ops/kernel_check.py
    check_ragged_attention, at a small width (page 8): decode, prefill,
    mixed or verify rows, shuffled page tables, f32 or int8 pages (the
    port's row quantization, bit-identical to the JAX package's)."""
    rng = np.random.default_rng(seed)
    if mix == "decode":
        q_lens = np.ones(B, np.int32)
    elif mix == "prefill":
        q_lens = rng.integers(2, 12, B).astype(np.int32)
    elif mix == "verify":
        q_lens = np.full(B, 4, np.int32)
    else:  # decode rows + a chunk + a verify row together
        q_lens = np.asarray([1, 1, 9, 4], np.int32)
    T = int(q_lens.max())
    cap = MAX_PAGES * PAGE
    pos0 = np.asarray([int(rng.integers(0, cap - int(n) + 1))
                       for n in q_lens], np.int32)
    n_pages = B * MAX_PAGES + 1
    pt = rng.permutation(np.arange(1, n_pages)).reshape(
        B, MAX_PAGES).astype(np.int32)
    F = HKV * dh
    ak = (rng.standard_normal((L, n_pages, PAGE, F)) * 0.5).astype(np.float32)
    av = (rng.standard_normal((L, n_pages, PAGE, F)) * 0.5).astype(np.float32)
    case = {
        "q": (rng.standard_normal((B, T, H, dh)) * 0.3).astype(np.float32),
        "page_table": pt, "pos0": pos0, "q_lens": q_lens, "window": window,
    }
    if quant:
        kq, ks = tt._quantize_rows(torch.from_numpy(ak))
        vq, vs = tt._quantize_rows(torch.from_numpy(av))
        case.update(cache_k=kq.numpy(), cache_v=vq.numpy(),
                    cache_k_scale=ks.numpy(), cache_v_scale=vs.numpy())
    else:
        case.update(cache_k=ak, cache_v=av)
    if seeded:
        case["seed_kv"] = tuple(
            (rng.standard_normal((B, F)) * 0.5).astype(np.float32)
            for _ in range(2))
    return case


CASES = [(mix, quant, False, None) for mix in ("decode", "prefill", "mixed",
                                                "verify")
         for quant in (False, True)]
CASES += [("decode", quant, True, None) for quant in (False, True)]
CASES += [("mixed", False, False, 5), ("decode", True, True, 6)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is built with nvcc)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mix,quant,seeded,window", CASES)
def test_kernel_matches_plain_on_card(cuda_device, mix, quant, seeded,
                                      window):
    """The hand-written kernel against the plain version, on the card,
    at the small shapes of the CPU tests (Dh 16 is not a kernel head dim,
    so the card case widens to Dh 64): f32 both, tolerance 1e-4."""
    dh = 64
    c = make_case(mix, quant, seeded, seed=11, window=window, dh=dh)

    def run(fn):
        seed = c.get("seed_kv")
        t = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
        return fn(t(c["q"]), t(c["cache_k"]), t(c["cache_v"]), 1,
                  t(c["page_table"]), t(c["pos0"]), t(c["q_lens"]), HKV,
                  scale=dh ** -0.5, page=PAGE, sliding_window=window,
                  cache_k_scale=(t(c["cache_k_scale"])
                                 if "cache_k_scale" in c else None),
                  cache_v_scale=(t(c["cache_v_scale"])
                                 if "cache_v_scale" in c else None),
                  seed_kv=None if seed is None else tuple(t(s) for s in seed))

    before = ragged_paged_attention.launches
    got = run(ragged_paged_attention)
    want = run(ragged_attention_plain)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    assert float((got - want).abs().max()) < 1e-4


def make_wide_case(q_lens, pos0, *, max_pages, page, dh=128, hkv=2, h=8,
                   quant=False, seeded=False, window=None, q_dtype=None,
                   seed=0, device="cpu", softcap=0.0) -> dict:
    """Torch inputs at a kernel head dim with given rows (q_lens, pos0):
    bf16 queries with bf16 or int8 pages by default, shuffled page
    tables, a 2-layer arena; the call's keyword arguments included."""
    rng = np.random.default_rng(seed)
    q_lens = np.asarray(q_lens, np.int32)
    pos0 = np.asarray(pos0, np.int32)
    nb, T = len(q_lens), int(q_lens.max())
    n_pages = nb * max_pages + 1
    pt = rng.permutation(np.arange(1, n_pages)).reshape(
        nb, max_pages).astype(np.int32)
    F = hkv * dh
    qd = q_dtype or torch.bfloat16
    ak = torch.from_numpy(
        (rng.standard_normal((2, n_pages, page, F)) * 0.5).astype(np.float32))
    av = torch.from_numpy(
        (rng.standard_normal((2, n_pages, page, F)) * 0.5).astype(np.float32))
    c = {"q": torch.from_numpy(rng.standard_normal((nb, T, h, dh)).astype(
             np.float32)).to(qd),
         "page_table": torch.from_numpy(pt), "pos0": torch.from_numpy(pos0),
         "q_lens": torch.from_numpy(q_lens)}
    if quant:
        c["cache_k"], c["cache_k_scale"] = tt._quantize_rows(ak)
        c["cache_v"], c["cache_v_scale"] = tt._quantize_rows(av)
    else:
        c["cache_k"], c["cache_v"] = ak.to(qd), av.to(qd)
    if seeded:
        c["seed_kv"] = tuple(torch.from_numpy(
            (rng.standard_normal((nb, F)) * 0.5).astype(np.float32)).to(qd)
            for _ in range(2))
    c = {k: (tuple(s.to(device) for s in v) if isinstance(v, tuple)
             else v.to(device)) for k, v in c.items()}
    c.update(layer=1, n_kv_heads=hkv, scale=dh ** -0.5, page=page,
             sliding_window=window, softcap=softcap)
    return c


def call_case(fn, c):
    return fn(c["q"], c["cache_k"], c["cache_v"], c["layer"],
              c["page_table"], c["pos0"], c["q_lens"], c["n_kv_heads"],
              scale=c["scale"], page=c["page"],
              sliding_window=c["sliding_window"],
              softcap=c.get("softcap", 0.0),
              cache_k_scale=c.get("cache_k_scale"),
              cache_v_scale=c.get("cache_v_scale"),
              seed_kv=c.get("seed_kv"))


def _check_wide(c, tol=1e-4):
    before = ragged_paged_attention.launches
    got = call_case(ragged_paged_attention, c)
    want = call_case(ragged_attention_plain, c)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err < tol, err
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16kv", "int8kv"])
@pytest.mark.parametrize("mix", ["decode", "seeded", "prefill", "mixed",
                                 "verify"])
def test_bf16_kernel_matches_plain_on_card(cuda_device, mix, quant, dh):
    """bf16 queries on the tensor-core path, bf16 and int8 pages, both
    kernel head dims, page 8 (tiles span pages), every row kind."""
    rows = {"decode": ([1, 1, 1, 1], [37, 200, 5, 254]),
            "seeded": ([1, 1, 1, 1], [37, 200, 5, 254]),
            "prefill": ([40, 17, 70, 3], [0, 100, 150, 9]),
            "mixed": ([1, 1, 70, 4], [90, 3, 120, 60]),
            "verify": ([4, 4, 4, 4], [0, 61, 130, 251])}[mix]
    c = make_wide_case(*rows, max_pages=32, page=8, dh=dh, quant=quant,
                       seeded=mix == "seeded", seed=dh + quant,
                       device=cuda_device)
    _check_wide(c)


# rows (q_lens, pos0), window and softcap of each row mix at the family
# head dims: split decode rows in and out of a window, seeded decode rows
# with a softcap, a 64-row-tile prefill, decode rows beside a chunk
FAMILY_MIXES = {
    "decode": ([1, 1, 1], [1830, 700, 144], 1024, 50.0),
    "seeded": ([1, 1], [1000, 300], 0, 50.0),
    "prefill": ([70, 33], [0, 150], 48, 0.0),
    "mixed": ([1, 1, 90], [900, 60, 400], 100, 30.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16q", "f32q"])
@pytest.mark.parametrize("quant", [False, True], ids=["fpkv", "int8kv"])
@pytest.mark.parametrize("mix", list(FAMILY_MIXES))
@pytest.mark.parametrize("dh", [80, 96, 256])
def test_family_head_dims_match_plain_on_card(cuda_device, dh, mix, quant,
                                              q_dtype):
    """B1 at Phi-2's, Phi-3's and Gemma's head dims (group 1 at 80 and 96,
    group 2 at 256), with windows and Gemma 2's softcap, on fp and int8
    pages, against the plain version within 1e-4, and bitwise on
    repeat."""
    q_lens, pos0, window, cap = FAMILY_MIXES[mix]
    hkv, h = (4, 8) if dh == 256 else (4, 4)
    c = make_wide_case(q_lens, pos0, max_pages=8, page=256, dh=dh, hkv=hkv,
                       h=h, quant=quant, seeded=mix == "seeded",
                       window=window, q_dtype=q_dtype, seed=dh,
                       device=cuda_device, softcap=cap)
    got = _check_wide(c)
    again = call_case(ragged_paged_attention, c)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_softcap_changes_the_kernel_output(cuda_device):
    """A kernel that dropped the cap would still match a plain version
    without one: the capped and uncapped outputs differ, and each
    matches its own plain version."""
    outs = []
    for cap in (0.0, 5.0):
        c = make_wide_case([1, 40], [500, 20], max_pages=8, page=256,
                           dh=256, hkv=4, h=8, seed=4, device=cuda_device,
                           softcap=cap)
        c["q"] = c["q"] * 4  # logits well past the cap
        outs.append(_check_wide(c))
    assert float((outs[0] - outs[1]).abs().max()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("page,max_pages", [(8, 128), (256, 4)])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16kv", "int8kv"])
def test_long_decode_spans_many_splits(cuda_device, page, max_pages, quant):
    """Decode rows whose contexts cover 8 or more kv splits (the plan
    splits a 1024-token range into 64-token chunks at 2 rows x 2 kv
    heads), one seeded with its current row in a middle split."""
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import _plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, _, splits, split_len = _plan(2, 2, 1, 4, page * max_pages, sms)
    assert splits >= 8 and split_len == 64
    for seeded, pos0 in ((False, [1023, 700]), (True, [540, 1000])):
        c = make_wide_case([1, 1], pos0, max_pages=max_pages, page=page,
                           quant=quant, seeded=seeded, seed=page,
                           device=cuda_device)
        _check_wide(c)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [100, 200], ids=["edge_inside_split",
                                                    "whole_splits_out"])
def test_windowed_decode_across_splits(cuda_device, window):
    """A sliding window whose edge falls inside a 64-token split, and one
    that leaves whole splits with no visible position (they must add
    nothing and make no NaN), beside a short row the window does not cut."""
    for seeded in (False, True):
        c = make_wide_case([1, 1, 1], [900, 530, 40], max_pages=128, page=8,
                           seeded=seeded, window=window, seed=window,
                           device=cuda_device)
        got = _check_wide(c)
        assert torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16kv", "int8kv"])
def test_pad_queries_beside_a_long_chunk(cuda_device, quant):
    """Rows whose q_len is far below the step's T (512) write zeros past
    their q_len; the 512-token chunk beside them is attended in full."""
    c = make_wide_case([512, 3, 1, 0], [1400, 77, 1200, 5], max_pages=8,
                       page=256, quant=quant, seed=5, device=cuda_device)
    got = _check_wide(c)
    assert not got[1, 3:].any() and not got[2, 1:].any()
    assert not got[3].any()


@pytest.mark.cuda
def test_kernel_reads_strided_queries_and_writes_rows(cuda_device):
    """The kernel's own layout: q as a strided view of a wider
    [B, T, H + 2, Dh] tensor is read in place, and query (t, head j) of
    row b lands at out[b, t, j * Dh:(j + 1) * Dh], for a split decode
    step and for a prefill tile."""
    for q_lens, pos0 in (([1, 1], [900, 300]), ([50, 20], [10, 500])):
        c = make_wide_case(q_lens, pos0, max_pages=128, page=8, seed=3,
                           device=cuda_device)
        B, T, H, Dh = c["q"].shape
        wide = torch.randn((B, T, H + 2, Dh), device=cuda_device).to(
            torch.bfloat16)
        wide[:, :, 1:H + 1] = c["q"]
        c["q"] = wide[:, :, 1:H + 1]
        assert not c["q"].is_contiguous()
        got = _check_wide(c)
        assert got.shape == (B, T, H * Dh) and got.is_contiguous()
        dense = call_case(ragged_attention_plain,
                          {**c, "q": c["q"].contiguous()})
        b, t, j = 1, q_lens[1] - 1, H - 1
        assert float((got[b, t, j * Dh:(j + 1) * Dh]
                      - dense[b, t, j * Dh:(j + 1) * Dh]).abs().max()) < 1e-4


@pytest.mark.cuda
def test_kernel_is_bitwise_repeatable(cuda_device):
    """Split partials are merged in a fixed order: the same inputs give
    identical outputs, for a split decode step and a mixed step."""
    for q_lens, pos0, seeded in (([1, 1], [1000, 333], True),
                                 ([1, 64, 4], [700, 100, 20], False)):
        c = make_wide_case(q_lens, pos0, max_pages=128, page=8,
                           seeded=seeded, seed=9, device=cuda_device)
        a = call_case(ragged_paged_attention, c)
        b = call_case(ragged_paged_attention, c)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_captures_in_a_cuda_graph(cuda_device):
    """One split call captured in a CUDA graph and replayed on new inputs
    copied into the captured tensors equals an eager call on those
    inputs: the wrapper never syncs with the host, and the merge
    counters reset themselves between replays."""
    c = make_wide_case([1, 1], [1000, 333], max_pages=128, page=8,
                       seeded=True, seed=1, device=cuda_device)
    new = make_wide_case([1, 1], [640, 999], max_pages=128, page=8,
                         seeded=True, seed=2, device=cuda_device)
    call_case(ragged_paged_attention, c)  # build, plan and counters eagerly
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call_case(ragged_paged_attention, c)
    for _ in range(2):
        for k in ("q", "cache_k", "cache_v", "page_table", "pos0", "q_lens"):
            c[k].copy_(new[k])
        for s, t in zip(c["seed_kv"], new["seed_kv"]):
            s.copy_(t)
        graph.replay()
        want = call_case(ragged_paged_attention, new)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert float((want - call_case(ragged_attention_plain, new)).abs().max()
                 ) < 1e-4


def _tiny_model(device):
    """A 2-layer Llama-style model with kernel-sized heads (Dh 64) and
    random f32 weights from a seed, in the port's [in, out] layout."""
    spec = tiny_spec(vocab_size=258, d_model=128, n_heads=4, n_kv_heads=2,
                     d_head=64, d_ff=256, max_position=256)
    g = torch.Generator().manual_seed(0)
    D, Q, F, FF, V, NL = (spec.d_model, spec.q_dim, spec.kv_dim, spec.d_ff,
                          spec.vocab_size, spec.n_layers)
    shapes = {"embed": (V, D), "wq": (NL, D, Q), "wk": (NL, D, F),
              "wv": (NL, D, F), "wo": (NL, Q, D), "w_gate": (NL, D, FF),
              "w_up": (NL, D, FF), "w_down": (NL, FF, D), "lm_head": (D, V)}
    params = {k: (torch.randn(s, generator=g) * s[-2] ** -0.5).to(device)
              for k, s in shapes.items()}
    for k in ("ln1_w", "ln2_w"):
        params[k] = torch.ones((NL, D), device=device)
    params["final_norm_w"] = torch.ones(D, device=device)
    return spec, params


@pytest.mark.cuda
def test_paged_forward_on_card_matches_cpu(cuda_device):
    """The paged ragged forward on the card (the kernel in every layer)
    against the same forward on the CPU (the plain version): f32 logits
    within 1e-3 for a ragged prefill and a seeded decode step."""
    outs = {}
    for dev in (torch.device("cpu"), cuda_device):
        spec, params = _tiny_model(dev)
        pt = torch.arange(1, 9, dtype=torch.int32, device=dev).reshape(2, 4)
        cache = tt.KVCache.create(spec, 9, 16, torch.float32, device=dev)
        kw = dict(page_table=pt, kv_page=16, write_table=pt)
        toks = torch.arange(2 * 20, device=dev).reshape(2, 20) % 258
        lens = torch.tensor([20, 13], dtype=torch.int32, device=dev)
        before = ragged_paged_attention.launches
        lg1, cache = tt.forward(spec, params, toks,
                                torch.zeros(2, dtype=torch.int32, device=dev),
                                cache, q_lens=lens, **kw)
        lg2, _ = tt.forward(spec, params, toks[:, :1], lens, cache,
                            q_lens=torch.ones_like(lens), **kw)
        launched = ragged_paged_attention.launches - before
        assert launched == (2 * spec.n_layers if dev.type == "cuda" else 0)
        outs[dev.type] = (lg1[0].cpu(), lg1[1, :13].cpu(), lg2.cpu())
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert float((a - b).abs().max()) < 1e-3


@pytest.mark.cuda
def test_engine_serves_on_card(cuda_device):
    """The engine on the card: two concurrent requests of different
    prompt lengths finish with their token counts, the kernel ran in
    every layer of every forward, and the page pool is leak-free."""
    spec, params = _tiny_model(cuda_device)
    eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=2, max_seq=256,
                    cache_dtype=torch.float32, device=cuda_device)
    try:
        before = ragged_paged_attention.launches
        qs = eng.submit_many([
            GenRequest(prompt_ids=list(range(1, 40)), max_tokens=9,
                       ignore_eos=True),
            GenRequest(prompt_ids=list(range(1, 180)), max_tokens=5,
                       ignore_eos=True, temperature=0.7, seed=3)])
        finals = []
        for q in qs:
            ev = q.get(timeout=300)
            while not ev.done:
                ev = q.get(timeout=300)
            finals.append(ev)
        assert [e.finish_reason for e in finals] == ["length", "length"]
        assert [e.completion_tokens for e in finals] == [9, 5]
        launched = ragged_paged_attention.launches - before
        assert eng.metrics.forward_steps > 0
        assert launched == spec.n_layers * eng.metrics.forward_steps
        eng.leak_check()
    finally:
        eng.close()


# ------------------------------------------------------------ int8 kernel


def _int8_operands(m, k, n, x_dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((k, n), generator=g) * 0.05
    qt = tq.quantize_tensor(w)
    x = torch.randn((m, k), generator=g).to(x_dtype)
    return x.to(device), qt.q.to(device), qt.scale.to(device)


def _bf16_excess(got, want):
    """max error beyond one unit of want's bf16 spacing (2^(exponent -
    7)), relative to max |want|."""
    w = want.float()
    spacing = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2 ** -126)))
                         - 7)
    d = (got.float() - w).abs()
    return float((d - spacing).clamp_min(0).max() / w.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32out", "bf16out"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32x", "bf16x"])
@pytest.mark.parametrize("m", [1, 3, 1000])
def test_int8_kernel_matches_plain_on_card(cuda_device, m, x_dtype,
                                           out_dtype):
    """The hand-written kernel against its plain version at odd row counts
    (one 16-row tile, a ragged 64-row tile edge): f32 out within 1e-4 of
    the largest output; bf16 out within one bf16 unit of each output plus
    that bound. The two sum the same products in another order, which moves
    an output that cancels to near zero by many of its own tiny units."""
    x, q, s = _int8_operands(m, 1024, 1536, x_dtype, cuda_device, seed=m)
    before = int8_matmul.launches
    got = int8_matmul(x, q, s, out_dtype)
    want = int8_matmul_plain(x, q, s, out_dtype)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, 1536)
    if out_dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max())
    else:
        assert _bf16_excess(got, want) <= 1e-4


def _int8_operands_on_card(m, k, n, device, seed):
    """bf16 x, int8 weights over the whole range and positive scales,
    made on the card from a seed (the 8B shapes are large for the CPU)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randint(-128, 128, (k, n), generator=g, device=device,
                      dtype=torch.int8)
    scale = torch.rand((n,), generator=g, device=device) * 2e-3 + 1e-4
    x = torch.randn((m, k), generator=g, device=device).bfloat16()
    return x, q, scale


def _mma_plan(x, q):
    (m, k), n = x.shape, q.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return plan(m, n, k, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32out", "bf16out"])
@pytest.mark.parametrize("k,n", [(4096, 1024), (4096, 14336), (14336, 4096)],
                         ids=["n1024", "n14336", "k14336"])
@pytest.mark.parametrize("m", [17, 64, 65, 127, 128, 129, 1000, 1024])
def test_int8_mma_instance_matches_plain_on_card(cuda_device, m, k, n,
                                                 out_dtype):
    """The mixed-step instance (bf16 x, M > 16) at its tile edges (64 and
    128 rows), with split K (N 1024), wide N and long K, under the
    tolerance of test_int8_kernel_matches_plain_on_card. One call is one
    counted launch."""
    x, q, s = _int8_operands_on_card(m, k, n, cuda_device, seed=m + k + n)
    assert _mma_plan(x, q)[0] in (64, 128)
    before = int8_matmul.launches
    got = int8_matmul(x, q, s, out_dtype)
    want = int8_matmul_plain(x, q, s, out_dtype)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (m, n)
    if out_dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max())
    else:
        assert _bf16_excess(got, want) <= 1e-4


# (m, k, n) at 132 SMs: 128-row tiles; 64-row tiles; 128-row tiles with K
# split 2 ways; 64-row tiles with K split 16 ways
MMA_PLANS = [(1000, 4096, 14336), (64, 4096, 14336), (1024, 4096, 1024),
             (37, 4096, 1024)]
MMA_IDS = ["bm128", "bm64", "bm128_split", "bm64_split"]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MMA_PLANS, ids=MMA_IDS)
def test_int8_mma_instance_is_bitwise_repeatable(cuda_device, m, k, n):
    x, q, s = _int8_operands_on_card(m, k, n, cuda_device, seed=7)
    a = int8_matmul(x, q, s)
    b = int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MMA_PLANS, ids=MMA_IDS)
def test_int8_mma_instance_captures_in_a_cuda_graph(cuda_device, m, k, n):
    """A call captured in a CUDA graph and replayed on new operands copied
    into the captured ones equals an eager call on those operands; the
    counter rises once per wrapper call, not per replay."""
    ops = _int8_operands_on_card(m, k, n, cuda_device, seed=1)
    new = _int8_operands_on_card(m, k, n, cuda_device, seed=2)
    int8_matmul(*ops)  # build and set the shared memory size eagerly
    torch.cuda.synchronize()
    before = int8_matmul.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int8_matmul(*ops)
    assert int8_matmul.launches == before + 1
    for t, v in zip(ops, new):
        t.copy_(v)
    graph.replay()
    want = int8_matmul(*new)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert int8_matmul.launches == before + 2


@pytest.mark.cuda
def test_int8_wrapper_raises_instead_of_falling_back(cuda_device):
    x, q, s = _int8_operands(8, 1024, 512, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="not eligible"):
        int8_matmul(x[:, :96].contiguous(), q[:96], s)
    big = torch.zeros((1025, 1024), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="not eligible"):
        int8_matmul(big, q, s)
    with pytest.raises(ValueError, match="lives on cpu"):
        int8_matmul(x, q.cpu(), s)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul(x, q.T.contiguous().T, s)


@pytest.mark.cuda
def test_mm_on_a_cuda_qtensor_launches_the_kernel(cuda_device):
    x, q, s = _int8_operands(8, 512, 512, torch.bfloat16, cuda_device)
    before = int8_matmul.launches
    y = tq.mm(x.reshape(2, 4, 512), tq.QTensor(q, s))
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1 and y.shape == (2, 4, 512)
    # an ineligible shape takes the upcast product, no launch
    tq.mm(x[:, :96], tq.QTensor(q[:96].contiguous(), s))
    assert int8_matmul.launches == before + 1


@pytest.mark.cuda
def test_lm_head_bf16_on_card_returns_f32_sums(cuda_device):
    """The card's f32-output bf16 product against the CPU's f32 product of
    the same bf16 values, untied and tied (a transposed head)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 3, 256), generator=g).bfloat16()
    head = (torch.randn((256, 1000), generator=g) * 0.05).bfloat16()
    for tied in (False, True):
        spec = tiny_spec(vocab_size=1000, d_model=256,
                         tie_word_embeddings=tied)
        params = {"embed" if tied else "lm_head":
                  head.T.contiguous() if tied else head}
        want = tt._lm_head(spec, params, x)
        got = tt._lm_head(spec, {k: v.to(cuda_device)
                                 for k, v in params.items()},
                          x.to(cuda_device))
        assert got.dtype == torch.float32
        assert float((got.cpu() - want).abs().max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16kv", "int8kv"])
def test_aliased_page_tables_match_plain_on_card(cuda_device, quant):
    """Prefix sharing's tables at the 8B attention width (H 32, Hkv 8,
    Dh 128, page 256): rows 1-5 alias row 0's first 4 physical pages (a
    shared 1024-token prefix), then read private pages; rows 6-7 are
    unrelated. Decode rows, suffix prefill chunks after the shared
    prefix, and a seedless mix; within 1e-4 of the plain version and
    bitwise on repeat."""
    q_lens = [1, 40, 1, 23, 60, 1, 1, 128]
    pos0 = [1500, 1100, 1180, 1076, 1090, 1300, 700, 0]
    c = make_wide_case(q_lens, pos0, max_pages=8, page=256, dh=128, hkv=8,
                       h=32, quant=quant, seed=7 + quant, device=cuda_device)
    pt = c["page_table"].clone()
    pt[1:6, :4] = pt[0, :4]
    c["page_table"] = pt
    got = _check_wide(c)
    assert torch.equal(got, call_case(ragged_paged_attention, c))


# ------------------------------------------------ speculative decoding


SPEC_POS0 = [143, 1827, 700, 1200, 50, 2043, 512, 1023]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16kv", "int8kv"])
@pytest.mark.parametrize("shape", ["verify", "draft_decode"])
def test_spec_shapes_match_plain_on_card(cuda_device, shape, quant):
    """Speculative decoding's two new attention shapes at the served
    widths (H 32, Hkv 8, page 256, 8 rows of 8 pages): ``verify`` rows
    of q_len 4 at Dh 128 (the 8B target), and seeded T == 1
    ``draft_decode`` rows at Dh 64 (the Llama-3.2-1B draft); within 1e-4
    of the plain version and bitwise on repeat."""
    verify = shape == "verify"
    pos0 = [min(p, 2048 - 4) for p in SPEC_POS0] if verify else SPEC_POS0
    c = make_wide_case([4 if verify else 1] * 8, pos0, max_pages=8,
                       page=256, dh=128 if verify else 64, hkv=8, h=32,
                       quant=quant, seeded=not verify, seed=21 + quant,
                       device=cuda_device)
    got = _check_wide(c)
    assert torch.equal(got, call_case(ragged_paged_attention, c))


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["spec", "spec_s"])
def test_spec_engine_on_card(cuda_device, temperature):
    """The speculative engine on the card, the model its own draft's
    target and a 1-layer draft beside it: every kernel launch is one
    layer of a target forward (verify rounds included) or of a draft
    forward, greedy text equals the plain engine's on the card, and a
    sampled request finishes with its token count."""
    spec, params = _tiny_model(cuda_device)
    dspec = tiny_spec(vocab_size=258, d_model=128, n_heads=4, n_kv_heads=2,
                      d_head=64, d_ff=256, max_position=256, n_layers=1)
    dparams = {k: (v[:1] if v.dim() > 1 and k not in ("embed", "lm_head")
                   else v) for k, v in params.items()}
    dparams["final_norm_w"] = params["final_norm_w"]
    texts = []
    for draft in (None, (dspec, dparams)):
        eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=2,
                        max_seq=256, cache_dtype=torch.float32, draft=draft,
                        n_draft=4, device=cuda_device)
        try:
            before = ragged_paged_attention.launches
            ev = eng.generate(GenRequest(
                prompt_ids=list(range(1, 60)), max_tokens=20,
                ignore_eos=True, temperature=temperature, seed=4))
            assert ev.finish_reason == "length" and \
                ev.completion_tokens == 20
            m = eng.metrics
            launched = ragged_paged_attention.launches - before
            assert launched == (spec.n_layers * m.forward_steps
                                + dspec.n_layers * m.draft_forwards)
            assert (m.spec_dispatches > 0) == (draft is not None)
            texts.append(ev.full_text)
            eng.leak_check()
        finally:
            eng.close()
    if temperature == 0.0:
        assert texts[0] == texts[1]


# ------------------------------------------------ compiled decode (graphs)


def _graph_model(device, int8: bool):
    """A 2-layer bf16 Llama-style model whose projections B2 takes (K, N
    multiples of 512) and whose heads B1 takes (Dh 64); int8 weights
    through ``quant.quantize_params``."""
    spec = tiny_spec(vocab_size=258, d_model=512, n_heads=8, n_kv_heads=8,
                     d_head=64, d_ff=1024, max_position=256)
    g = torch.Generator().manual_seed(1)
    D, Q, F, FF, V, NL = (spec.d_model, spec.q_dim, spec.kv_dim, spec.d_ff,
                          spec.vocab_size, spec.n_layers)
    shapes = {"embed": (V, D), "wq": (NL, D, Q), "wk": (NL, D, F),
              "wv": (NL, D, F), "wo": (NL, Q, D), "w_gate": (NL, D, FF),
              "w_up": (NL, D, FF), "w_down": (NL, FF, D), "lm_head": (D, V)}
    params = {k: (torch.randn(s, generator=g) * s[-2] ** -0.5).to(
        device, torch.bfloat16) for k, s in shapes.items()}
    for k in ("ln1_w", "ln2_w"):
        params[k] = torch.ones((NL, D), device=device, dtype=torch.bfloat16)
    params["final_norm_w"] = torch.ones(D, device=device,
                                        dtype=torch.bfloat16)
    return spec, tq.quantize_params(params) if int8 else params


def _drive(eng, reqs) -> dict:
    """Serve ``reqs`` on an engine made with autostart=False, stepping
    it by hand (one schedule, whatever the host's timing): each
    request's generated ids by prompt."""
    ids = {}
    orig = eng._finish

    def finish(slot, reason):
        ids[tuple(slot.request.prompt_ids)] = list(slot.generated)
        return orig(slot, reason)

    eng._finish = finish
    eng.submit_many(reqs)
    while eng._pending or any(s.active for s in eng.slots):
        eng._admit()
        eng.step()
    del eng._finish
    return ids


def _graph_pair(cuda_device, int8_weights, kv):
    spec, params = _graph_model(cuda_device, int8_weights)
    pair = []
    for eager in (False, True):
        eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=4,
                        max_seq=256, cache_dtype=kv, autostart=False,
                        device=cuda_device)
        if eager:  # the same variant body, run eagerly at the bucket
            eng._decode_launch = eng._decode_body
        pair.append(eng)
    return pair


def _graph_wave(i: int) -> list:
    return [GenRequest(prompt_ids=list(range(1 + i + 7 * r, 30 + i + 9 * r)),
                       max_tokens=11 + 5 * r, ignore_eos=True,
                       **({"temperature": 0.8, "top_k": 40, "seed": r}
                          if r % 2 else {}))
            for r in range(3 - i % 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8],
                         ids=["bf16kv", "int8kv"])
@pytest.mark.parametrize("int8_weights", [False, True],
                         ids=["bf16w", "int8w"])
def test_graph_decode_equals_eager_at_the_bucket(cuda_device, int8_weights,
                                                 kv):
    """Every plain decode step by graph replay against the same body run
    eagerly at the same bucket: greedy and seeded sampled ids, and every
    K/V page but the trash page, bitwise; the graph engine ran no eager
    decode forward, and its kernel counts per replay equal the eager
    engine's per call."""
    graph, eager = _graph_pair(cuda_device, int8_weights, kv)
    try:
        got, want, launches = [], [], []
        for eng, out in ((graph, got), (eager, want)):
            b1, b2 = ragged_paged_attention.launches, int8_matmul.launches
            out.append(_drive(eng, _graph_wave(0)))
            launches.append((ragged_paged_attention.launches - b1,
                             int8_matmul.launches - b2))
        torch.cuda.synchronize()
        assert got == want
        assert torch.equal(graph.cache.k[:, 1:], eager.cache.k[:, 1:])
        assert torch.equal(graph.cache.v[:, 1:], eager.cache.v[:, 1:])
        m = graph.metrics
        assert m.graph_replays == m.decode_steps > 0
        assert eager.metrics.graph_replays == 0
        assert launches[0] == launches[1]
        assert launches[0][0] == 2 * m.forward_steps
        assert (launches[0][1] > 0) == int8_weights
    finally:
        graph.close()
        eager.close()


@pytest.mark.cuda
def test_graph_replays_on_new_tables_stay_bitwise(cuda_device):
    """Three waves through the captured graphs (other rows, pages,
    tokens and buckets each time) stay bitwise the eager body's."""
    graph, eager = _graph_pair(cuda_device, False, torch.bfloat16)
    try:
        for i in range(3):
            assert _drive(graph, _graph_wave(i)) == \
                _drive(eager, _graph_wave(i))
        assert graph.metrics.graph_replays == graph.metrics.decode_steps
        assert len(graph._variants) >= 2
    finally:
        graph.close()
        eager.close()


@pytest.mark.cuda
def test_warmup_captures_every_bucket_on_card(cuda_device):
    spec, params = _graph_model(cuda_device, True)
    eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=8, max_seq=256,
                    cache_dtype=torch.bfloat16, autostart=False,
                    device=cuda_device)
    try:
        b1, b2 = ragged_paged_attention.launches, int8_matmul.launches
        eng.warmup()
        assert sorted(eng._variants) == [1, 2, 4, 8]
        assert all(v.graph is not None for v in eng._variants.values())
        assert all(v.launches == {"ragged_paged_attention": 2,
                                  "int8_matmul": 14}
                   for v in eng._variants.values())
        # pad forwards are not traffic
        assert (ragged_paged_attention.launches, int8_matmul.launches) == \
            (b1, b2)
        assert eng._graph_pool_bytes > 0
        assert eng.hbm_stats()["components"]["graph_pool"] == \
            eng._graph_pool_bytes
    finally:
        eng.close()


def _mixed_wave() -> list:
    """A 199-token prompt (a 128-token chunk, then 71 beside two decode
    rows: both steps at variant [4, 128]), a seeded sampled row and a
    logit_bias row (masked decode steps while it decodes)."""
    return [GenRequest(prompt_ids=list(range(1, 200)), max_tokens=6,
                       ignore_eos=True),
            GenRequest(prompt_ids=list(range(3, 30)), max_tokens=9,
                       ignore_eos=True, temperature=0.8, top_k=40, seed=2),
            GenRequest(prompt_ids=list(range(5, 21)), max_tokens=7,
                       ignore_eos=True,
                       logit_bias={i: -100.0 for i in range(10, 60)})]


@pytest.mark.cuda
@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8],
                         ids=["bf16kv", "int8kv"])
@pytest.mark.parametrize("int8_weights", [False, True],
                         ids=["bf16w", "int8w"])
def test_mixed_and_masked_graphs_equal_eager_at_the_variant(
        cuda_device, int8_weights, kv):
    """Every mixed step and masked decode step by graph replay against
    the same bodies run eagerly at the same variants: greedy and seeded
    sampled ids and every K/V page but the trash page bitwise; the graph
    engine ran no eager mixed step or decode forward, and its kernel
    counts per replay equal the eager engine's per call."""
    spec, params = _graph_model(cuda_device, int8_weights)
    engines = []
    for eager in (False, True):
        eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=4,
                        max_seq=256, cache_dtype=kv, autostart=False,
                        device=cuda_device)
        if eager:  # the variant bodies, run eagerly
            eng._mixed_launch = eng._mixed_body
            eng._decode_launch = eng._decode_body
        engines.append(eng)
    graph, eager = engines
    try:
        got, want, launches = [], [], []
        for eng, out in ((graph, got), (eager, want)):
            b1, b2 = ragged_paged_attention.launches, int8_matmul.launches
            out.append(_drive(eng, _mixed_wave()))
            launches.append((ragged_paged_attention.launches - b1,
                             int8_matmul.launches - b2))
        torch.cuda.synchronize()
        assert got == want
        assert torch.equal(graph.cache.k[:, 1:], eager.cache.k[:, 1:])
        assert torch.equal(graph.cache.v[:, 1:], eager.cache.v[:, 1:])
        m = graph.metrics
        assert m.mixed_replays == m.mixed_steps >= 2
        assert m.graph_replays == m.decode_steps and m.masked_replays > 0
        assert (4, 128) in graph._mixed_variants
        assert eager.metrics.mixed_replays == 0
        assert eager.metrics.graph_replays == 0
        assert launches[0] == launches[1]
        assert launches[0][0] == 2 * m.forward_steps
        assert (launches[0][1] > 0) == int8_weights
    finally:
        graph.close()
        eager.close()


@pytest.mark.cuda
def test_lone_prompt_chunks_while_the_card_lags(cuda_device):
    """A lone 192-token prompt on an idle 8-slot engine (token buckets up
    to 64): three [1, 64] mixed steps in a row, the first two sampling
    nothing, so no step reads back and the host fills the next step's
    staging while the card is still behind (a spin queued before every
    mixed replay keeps it behind). Ids and every K/V page but the trash
    page bitwise equal to the same engine synchronized after every
    mixed replay, and greedy ids equal to the eager paths' (the same
    [1, 64] shapes)."""
    spec, params = _graph_model(cuda_device, False)
    engines = {}
    for mode in ("lagging", "synced", "eager"):
        eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=8,
                        max_seq=256, prefill_buckets=(4, 16, 64),
                        cache_dtype=torch.bfloat16, autostart=False,
                        device=cuda_device)
        launch = eng._mixed_launch
        if mode == "lagging":
            def lagging(v, launch=launch):
                torch.cuda._sleep(20_000_000)  # ~10 ms of spinning
                launch(v)
            eng._mixed_launch = lagging
        elif mode == "synced":
            def synced(v, launch=launch):
                launch(v)
                torch.cuda.synchronize()
            eng._mixed_launch = synced
        else:
            eng._mixed_graph = eng._mixed_eager
            eng._decode_graph = eng._decode_eager
        engines[mode] = eng
    try:
        ids = {m: _drive(e, [GenRequest(prompt_ids=list(range(1, 193)),
                                        max_tokens=8, ignore_eos=True)])
               for m, e in engines.items()}
        torch.cuda.synchronize()
        lag, synced = engines["lagging"], engines["synced"]
        assert lag.metrics.mixed_replays == lag.metrics.mixed_steps == 3
        assert list(lag._mixed_variants) == [(1, 64)]
        assert ids["lagging"] == ids["synced"] == ids["eager"]
        assert torch.equal(lag.cache.k[:, 1:], synced.cache.k[:, 1:])
        assert torch.equal(lag.cache.v[:, 1:], synced.cache.v[:, 1:])
    finally:
        for eng in engines.values():
            eng.close()


@pytest.mark.cuda
def test_warmup_captures_every_variant_on_card(cuda_device):
    """Decode, masked decode and mixed variants (row buckets 1-8, token
    buckets 4, 16, 128: every product at M <= 1024, so B2 takes each)
    captured, with their launches per replay; the pad runs count no
    launch."""
    spec, params = _graph_model(cuda_device, True)
    eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=8, max_seq=256,
                    cache_dtype=torch.bfloat16, autostart=False,
                    device=cuda_device)
    try:
        b1, b2 = ragged_paged_attention.launches, int8_matmul.launches
        eng.warmup()
        assert sorted(eng._mixed_variants) == [
            (r, t) for r in (1, 2, 4, 8) for t in (4, 16, 128)]
        assert sorted(eng._masked_variants) == [1, 2, 4, 8]
        every = (list(eng._variants.values())
                 + list(eng._masked_variants.values())
                 + list(eng._mixed_variants.values()))
        assert len(every) == eng.variant_count() == 20
        assert all(v.graph is not None and v.launches == {
            "ragged_paged_attention": 2, "int8_matmul": 14} for v in every)
        assert (ragged_paged_attention.launches, int8_matmul.launches) == \
            (b1, b2)
        assert eng.hbm_stats()["components"]["graph_pool"] == \
            eng._graph_pool_bytes > 0
    finally:
        eng.close()


def _spec_models(device, int8: bool):
    """``_graph_model``'s target (int8 weights when asked) and a 1-layer
    bf16 draft of the same width cut from its first layer."""
    spec, params = _graph_model(device, False)
    dspec = tiny_spec(vocab_size=258, d_model=512, n_heads=8, n_kv_heads=8,
                      d_head=64, d_ff=1024, max_position=256, n_layers=1)
    dparams = {k: (v[:1] if v.dim() > 1 and k not in ("embed", "lm_head")
                   else v) for k, v in params.items()}
    return spec, tq.quantize_params(params) if int8 else params, \
        (dspec, dparams)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["spec", "spec_s"])
@pytest.mark.parametrize("int8_weights", [False, True],
                         ids=["bf16w", "int8w"])
def test_spec_graphs_equal_eager_at_the_variant(cuda_device, int8_weights,
                                                temperature):
    """Every speculative dispatch by graph replay against the same body
    run eagerly at the same variant: greedy or seeded sampled ids, and
    every target and draft K/V page but the trash page, bitwise; the
    graph engine ran every dispatch as a replay, and its kernel counts
    per replay equal the eager engine's per call."""
    spec, params, draft = _spec_models(cuda_device, int8_weights)
    engines = []
    for eager in (False, True):
        eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=4,
                        max_seq=256, cache_dtype=torch.bfloat16, draft=draft,
                        n_draft=4, autostart=False, device=cuda_device)
        if eager:  # the variant body, run eagerly
            eng._spec_launch = eng._spec_body
        engines.append(eng)
    graph, eager = engines
    reqs = lambda: [GenRequest(  # noqa: E731
        prompt_ids=list(range(1 + 5 * r, 40 + 9 * r)), max_tokens=13 + 4 * r,
        ignore_eos=True, temperature=temperature, seed=r) for r in range(3)]
    try:
        got, want, launches = [], [], []
        for eng, out in ((graph, got), (eager, want)):
            b1, b2 = ragged_paged_attention.launches, int8_matmul.launches
            out.append(_drive(eng, reqs()))
            launches.append((ragged_paged_attention.launches - b1,
                             int8_matmul.launches - b2))
        torch.cuda.synchronize()
        assert got == want
        for a, b in ((graph.cache, eager.cache),
                     (graph.draft_cache, eager.draft_cache)):
            assert torch.equal(a.k[:, 1:], b.k[:, 1:])
            assert torch.equal(a.v[:, 1:], b.v[:, 1:])
        m = graph.metrics
        assert m.spec_replays == m.spec_dispatches > 0
        assert eager.metrics.spec_replays == 0
        assert {k for k, _, _ in graph._spec_variants} == {
            "spec" if temperature == 0.0 else "spec_s"}
        assert launches[0] == launches[1]
        assert launches[0][0] == 2 * m.forward_steps + m.draft_forwards
        assert (launches[0][1] > 0) == int8_weights
    finally:
        graph.close()
        eager.close()


@pytest.mark.cuda
def test_mixed_capture_failure_raises_and_fails_the_request(cuda_device):
    """A mixed variant whose capture cannot complete raises; the request
    fails through the loop's error path with no eager step in its
    place."""
    spec, params = _graph_model(cuda_device, False)
    eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=2, max_seq=256,
                    cache_dtype=torch.bfloat16, device=cuda_device)
    body = eng._mixed_body

    def syncing(v):
        body(v)
        v.out.sum().item()  # not permitted while the stream captures

    eng._mixed_body = syncing
    try:
        ev = eng.generate(GenRequest(prompt_ids=list(range(1, 20)),
                                     max_tokens=4, ignore_eos=True))
        assert ev.finish_reason == "error" and ev.error
        assert eng.metrics.mixed_steps == 0 and not eng._mixed_variants
    finally:
        eng.close()


@pytest.mark.cuda
def test_capture_failure_raises_and_fails_the_requests(cuda_device):
    """A capture that cannot complete (here: a host read inside the
    captured region) raises; the dispatch's request fails through the
    loop's error path and nothing runs eagerly in its place. Last in the
    file: it leaves a failed capture behind."""
    spec, params = _graph_model(cuda_device, False)
    eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=2, max_seq=256,
                    cache_dtype=torch.bfloat16, device=cuda_device)
    body = eng._decode_body

    def syncing(v):
        body(v)
        v.out.sum().item()  # not permitted while the stream captures

    eng._decode_body = syncing
    try:
        ev = eng.generate(GenRequest(prompt_ids=list(range(1, 20)),
                                     max_tokens=8, ignore_eos=True))
        assert ev.finish_reason == "error" and ev.error
        assert eng.metrics.decode_steps == 0
        assert not eng._variants
    finally:
        eng.close()


# ------------------------------------------------------------- text routes


@pytest.mark.cuda
def test_text_routes_on_card_match_cpu(cuda_device, tmp_path):
    """A chat through the tokenizer's chat template and a completion on a
    tiny Llama whose tokenizer.json is chip_smoke.py's Llama-3-layout BPE
    at 1024 ids: the port's server on the card hands the engine the same
    prompt ids as on the CPU and streams the same greedy text."""
    import json
    import threading
    import urllib.request

    import chip_smoke
    from localai_tfp_tpu_torch.server.app import build_server

    models = tmp_path / "models"
    ckpt = models / "tiny"
    chip_smoke.write_text_tokenizer(ckpt, vocab_size=1024)
    chip_smoke.write_checkpoint(ckpt, 2, 0, {
        "hidden_size": 128, "intermediate_size": 256,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64,
        "num_hidden_layers": 2, "vocab_size": 1024, "rope_theta": 10000.0,
        "max_position_embeddings": 512, "rms_norm_eps": 1e-5,
        "rope_scaling": None, "tie_word_embeddings": False})
    (models / "tiny.yaml").write_text(
        "name: tiny\nbackend: torch-llm\nparameters:\n  model: tiny\n"
        "  temperature: 0.0\n  max_tokens: 12\ncontext_size: 256\n"
        "max_batch_slots: 2\ndtype: float32\ntrimsuffix: [\"<|eot_id|>\"]\n"
        "template:\n  use_tokenizer_template: yes\n")
    bodies = [("/v1/chat/completions", {"model": "tiny", "ignore_eos": True,
                                        "messages": [{"role": "user",
                                                      "content": "Hello!"}]}),
              ("/v1/completions", {"model": "tiny", "ignore_eos": True,
                                   "prompt": "The paged arena"})]
    got = {}
    for dev in ("cpu", "cuda"):
        srv = build_server(str(models), port=0, device=dev)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            backend = srv.app.model_loader.load(
                srv.app.config_loader.get("tiny"))
            seen = []
            orig = backend._to_request
            backend._to_request = lambda o: (
                lambda r: (seen.append(list(r.prompt_ids)), r)[1])(orig(o))
            texts = []
            for path, body in bodies:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.server_address[1]}{path}",
                    data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    c = json.loads(r.read().decode())["choices"][0]
                texts.append(c.get("text", (c.get("message") or {}).get(
                    "content")))
            got[dev] = (seen, texts)
        finally:
            srv.close()
            th.join(timeout=30)
    assert got["cuda"] == got["cpu"]
    assert got["cpu"][0][0][:2] == [768, 768]  # BOS, then the template's


# ------------------------------------------------- lifecycle and embeddings


def _small_checkpoint(path, seed=0):
    import chip_smoke

    chip_smoke.write_checkpoint(path, 2, seed, {
        "hidden_size": 128, "intermediate_size": 256,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 64,
        "num_hidden_layers": 2, "vocab_size": 1024, "rope_theta": 10000.0,
        "max_position_embeddings": 512, "rms_norm_eps": 1e-5,
        "rope_scaling": None, "tie_word_embeddings": False})


@pytest.mark.cuda
def test_unload_returns_allocated_memory(cuda_device, tmp_path, monkeypatch):
    """A worker loaded on the card with its graphs captured, one request
    served, then shut down: allocated memory is back within 1 MiB of
    what it was before the load, and the weight pager's slab (device
    memory the caching allocator does not see, counted beside it) is
    given back. A first load and unload comes before the baseline, for
    what the process keeps once for all engines (the capture stream's
    cuBLAS workspace, B1's merge counters)."""
    from localai_tfp_tpu_torch.workers.base import (ModelLoadOptions,
                                                    PredictOptions)
    from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend

    monkeypatch.setenv("LOCALAI_WARMUP", "1")
    _small_checkpoint(tmp_path / "m")
    opts = ModelLoadOptions(model=str(tmp_path / "m"), context_size=256,
                            batch_slots=2, dtype="bfloat16")

    def cycle():
        b = TorchLLMBackend(cuda_device)
        assert b.load_model(opts).success
        assert b.engine.variant_count() > 0
        out = b.predict(PredictOptions(prompt="hello", tokens=6,
                                       ignore_eos=True))
        assert out.tokens == 6
        slab = b.engine._pager.slab
        loaded = torch.cuda.memory_allocated(cuda_device) \
            + slab.mapped_bytes()
        b.shutdown()
        assert slab.released and slab.mapped_bytes() == 0
        return loaded, b.unload_stats

    cycle()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    loaded, stats = cycle()
    after = torch.cuda.memory_allocated(cuda_device)
    assert loaded - base > 1 << 20  # the model held more than the bound
    assert abs(after - base) <= 1 << 20, (base, loaded, after)
    # the links are broken before any collection: gc frees nothing more
    assert stats["allocated_before_gc"] == stats["allocated_after_gc"]


@pytest.mark.cuda
def test_embedding_runs_b1_and_matches_plain(cuda_device, monkeypatch):
    """``LLMEngine.embed`` on the card launches B1 once per layer of its
    one forward and equals the same forward through the plain attention
    on the card within 1e-4 (f32 weights)."""
    spec, params = _tiny_model(cuda_device)
    eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=2, max_seq=256,
                    cache_dtype=torch.float32, device=cuda_device)
    try:
        for text in ("hello", "a longer text that pads to 128 tokens " * 2):
            before = ragged_paged_attention.launches
            got = eng.embed(text)
            assert ragged_paged_attention.launches - before == spec.n_layers
            with monkeypatch.context() as m:
                m.setattr(tt, "ragged_paged_attention", ragged_attention_plain)
                want = eng.embed(text)
            assert got.shape == (spec.d_model,)
            assert float((got - want).abs().max()) < 1e-4
            assert torch.equal(got, eng.embed(text))  # repeatable
    finally:
        eng.close()


@pytest.mark.cuda
def test_own_merge_counters_are_what_a_split_launch_uses(cuda_device):
    """Inside ``own_merge_counters(buf)`` a split launch merges through
    ``buf``, not the device's shared counters: a poisoned ``buf`` stops
    every merge (its slots move, the shared ones stay zero), a zeroed one
    gives the shared counters' output bitwise and is zero again after."""
    from localai_tfp_tpu_torch.ops import ragged_paged_attention as rpa

    c = make_wide_case([1, 1], [1023, 700], max_pages=128, page=8,
                       device=cuda_device)
    want = call_case(ragged_paged_attention, c)
    shared = rpa._counters[cuda_device.index if cuda_device.index is not None
                           else torch.cuda.current_device()]
    buf = rpa.new_merge_counters(cuda_device)
    buf.fill_(1000)
    with rpa.own_merge_counters(buf):
        call_case(ragged_paged_attention, c)
    torch.cuda.synchronize()
    assert int((buf != 1000).sum()) > 0 and int(shared.abs().sum()) == 0
    buf.zero_()
    with rpa.own_merge_counters(buf):
        got = call_case(ragged_paged_attention, c)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(buf.abs().sum()) == 0


@pytest.mark.cuda
def test_engine_serves_while_another_engine_captures(cuda_device):
    """One engine serves greedy requests on its scheduler thread while
    other engines on the same card are built and capture their graphs
    (their warm-up runs on the shared capture stream): every reply equals
    the same request served with no other engine about."""
    import threading

    spec, params = _tiny_model(cuda_device)

    def engine():
        return LLMEngine(spec, params, ByteTokenizer(), n_slots=2,
                         max_seq=256, cache_dtype=torch.float32,
                         device=cuda_device)

    def serve(eng, n):
        out = []
        for i in range(n):
            qs = eng.submit_many([GenRequest(
                prompt_ids=list(range(1 + i, 30 + 7 * j)), max_tokens=24,
                ignore_eos=True) for j in range(2)])
            for q in qs:
                ev = q.get(timeout=300)
                while not ev.done:
                    ev = q.get(timeout=300)
                out.append(ev.full_text)
        return out

    a = engine()
    try:
        a.warmup()
        alone = serve(a, 6)
        got: list = []
        th = threading.Thread(target=lambda: got.extend(serve(a, 6)))
        th.start()
        for _ in range(3):
            b = engine()
            b.warmup()
            b.close()
            b.release()
        th.join(600)
        assert got == alone
    finally:
        a.close()


# ------------------------------------------------ the dense families


def _family_model(device, family: str):
    """A tiny bf16 Gemma 3 (7 layers: five sliding, one global, one
    sliding; Dh 256, q/k and sandwich norms, two rope bases, a tied head)
    or Phi-3 (Dh 96, group 1, a uniform window), random from a seed, in
    the port's parameter tree."""
    if family == "gemma3":
        spec = tiny_spec(
            vocab_size=258, d_model=512, n_layers=7, n_heads=2,
            n_kv_heads=1, d_head=256, d_ff=1024, max_position=256,
            norm_weight_plus_one=True, hidden_act="gelu_tanh",
            embedding_multiplier=512 ** 0.5, tie_word_embeddings=True,
            sandwich_norms=True, qk_norm=True, query_pre_attn_scalar=256.0,
            rope_theta=1e6, rope_scaling={"rope_type": "linear",
                                          "factor": 8.0},
            rope_local_base_freq=1e4, sliding_window=48,
            sliding_window_pattern=6, norm_eps=1e-6)
    else:
        spec = tiny_spec(vocab_size=258, d_model=384, n_layers=3,
                         n_heads=4, n_kv_heads=4, d_head=96, d_ff=1024,
                         max_position=256, sliding_window=40)
    g = torch.Generator().manual_seed(5)
    D, Q, F, FF, V, NL = (spec.d_model, spec.q_dim, spec.kv_dim, spec.d_ff,
                          spec.vocab_size, spec.n_layers)
    shapes = {"embed": (V, D), "wq": (NL, D, Q), "wk": (NL, D, F),
              "wv": (NL, D, F), "wo": (NL, Q, D), "w_gate": (NL, D, FF),
              "w_up": (NL, D, FF), "w_down": (NL, FF, D)}
    if not spec.tie_word_embeddings:
        shapes["lm_head"] = (D, V)
    params = {k: torch.randn(s, generator=g) * s[-2] ** -0.5
              for k, s in shapes.items()}
    if spec.tie_word_embeddings:  # else the ids echo the input (chip_smoke)
        params["embed"] /= 20
    one = 0.0 if spec.norm_weight_plus_one else 1.0
    norms = {"ln1_w": (NL, D), "ln2_w": (NL, D), "final_norm_w": (D,)}
    if spec.sandwich_norms:
        norms.update(ln_post_attn_w=(NL, D), ln_post_ffw_w=(NL, D))
    if spec.qk_norm:
        norms.update(q_norm_w=(NL, spec.d_head), k_norm_w=(NL, spec.d_head))
    for k, s in norms.items():
        params[k] = one + 0.1 * torch.randn(s, generator=g)
    return spec, {k: v.to(device, torch.bfloat16) for k, v in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gemma3", "phi3"])
def test_family_graphs_equal_eager_bodies(cuda_device, family):
    """A tiny Gemma 3 and Phi-3 served by graph replay against the same
    variant bodies run eagerly (decode, masked and mixed steps, a prompt
    longer than the windows): greedy and seeded sampled ids and every
    K/V page but the trash page bitwise, B1 once per layer of every
    forward, every forward a replay."""
    spec, params = _family_model(cuda_device, family)
    engines = []
    for eager in (False, True):
        eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=4,
                        max_seq=256, cache_dtype=torch.bfloat16,
                        autostart=False, device=cuda_device)
        if eager:
            eng._mixed_launch = eng._mixed_body
            eng._decode_launch = eng._decode_body
        engines.append(eng)
    graph, eager = engines
    try:
        got, want, launches = [], [], []
        for eng, out in ((graph, got), (eager, want)):
            b1 = ragged_paged_attention.launches
            out.append(_drive(eng, _mixed_wave()))
            launches.append(ragged_paged_attention.launches - b1)
        torch.cuda.synchronize()
        assert got == want
        assert torch.equal(graph.cache.k[:, 1:], eager.cache.k[:, 1:])
        assert torch.equal(graph.cache.v[:, 1:], eager.cache.v[:, 1:])
        m = graph.metrics
        assert m.mixed_replays == m.mixed_steps >= 2
        assert m.graph_replays == m.decode_steps > 0
        assert launches[0] == launches[1] == spec.n_layers * m.forward_steps
    finally:
        graph.close()
        eager.close()


def _encoder(n_classes: int, seed: int):
    """A tiny encoder with seeded random f32 weights on the CPU."""
    from localai_tfp_tpu_torch.models.encoder import tiny_encoder_spec

    spec = tiny_encoder_spec(n_classes=n_classes, max_position=64)
    g = torch.Generator().manual_seed(seed)
    D, F, L, C = spec.d_model, spec.d_ff, spec.n_layers, n_classes
    shapes = {"word_emb": (spec.vocab_size, D), "pos_emb": (64, D),
              "type_emb": (2, D), "emb_ln_w": (D,), "emb_ln_b": (D,),
              "wq": (L, D, D), "bq": (L, D), "wk": (L, D, D), "bk": (L, D),
              "wv": (L, D, D), "bv": (L, D), "wo": (L, D, D), "bo": (L, D),
              "attn_ln_w": (L, D), "attn_ln_b": (L, D), "w_up": (L, D, F),
              "b_up": (L, F), "w_down": (L, F, D), "b_down": (L, D),
              "out_ln_w": (L, D), "out_ln_b": (L, D)}
    if C:
        shapes.update(pool_w=(D, D), pool_b=(D,), cls_w=(D, C), cls_b=(C,))
    params = {k: torch.randn(s, generator=g) * 0.1 for k, s in shapes.items()}
    for k in params:
        if k.endswith("ln_w"):
            params[k] += 1.0
    return spec, params


@pytest.mark.cuda
@pytest.mark.parametrize("n_classes", [0, 3])
def test_encoder_on_the_card_matches_the_cpu(cuda_device, n_classes):
    """encode, mean_pool and classify on the card within 1e-5 of the CPU
    (f32 products, whatever the process's TF32 setting)."""
    from localai_tfp_tpu_torch.models.encoder import (classify, encode,
                                                      mean_pool)

    spec, params = _encoder(n_classes, seed=3)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, spec.vocab_size, (4, 40), generator=g)
    mask = (torch.arange(40)[None] < torch.tensor([40, 3, 17, 29])[:, None]
            ).int()
    types = (torch.arange(40)[None] >= 10).int() * mask
    want = encode(spec, params, toks, mask, types)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        dev = {k: v.to(cuda_device) for k, v in params.items()}
        got = encode(spec, dev, toks.to(cuda_device), mask.to(cuda_device),
                     types.to(cuda_device))
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.isfinite(got).all()
        assert (got.cpu() - want).abs().max().item() <= 1e-5
        pooled = mean_pool(got, mask.to(cuda_device)).cpu()
        assert (pooled - mean_pool(want, mask)).abs().max().item() <= 1e-5
        if n_classes:
            d = (classify(spec, dev, got).cpu()
                 - classify(spec, params, want)).abs().max().item()
            assert d <= 1e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_python_store_find_on_the_card_matches_numpy(cuda_device,
                                                     monkeypatch):
    """Above its threshold the Python store's matvec runs on the card:
    the same top 10 as a numpy f64 scan, similarities within 1e-5."""
    import numpy as np

    from localai_tfp_tpu_torch.store import backend as sb

    monkeypatch.setattr(sb, "_DEVICE_THRESHOLD", 1000)
    rng = np.random.default_rng(9)
    keys = rng.standard_normal((5000, 384)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=1, keepdims=True)
    store = sb.VectorStore(cuda_device)
    store.set(keys, list(range(5000)))
    calls = []
    real = sb.device_dots
    monkeypatch.setattr(sb, "device_dots",
                        lambda k, q, d: calls.append(d) or real(k, q, d))
    for i in range(3):
        q = keys[i * 7] + rng.standard_normal(384).astype(np.float32) * 0.05
        dots = keys.astype(np.float64) @ q.astype(np.float64)
        order = np.argsort(-dots)[:10]
        k, v, sims = store.find(q, 10)
        assert v == [int(j) for j in order]
        assert np.abs(sims - dots[order]).max() <= 1e-5
    assert calls == [cuda_device] * 3


# ------------------------------------------------------------- the KV tier


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_urgent_spill_races_the_overwrite_of_its_pages(cuda_device,
                                                       monkeypatch, kv):
    """A reclaim spills a resident urgently and hands its pages straight
    to another request, whose prefill (a graph replay) overwrites them in
    the same admission. The tier's gather runs on the engine's stream
    before that replay and its side stream copies the gathered tensor,
    never the arena: the host pages must equal a gather of the same pages
    taken before the overwrite, bitwise, and the arena pages must have
    changed (the overwrite happened), the pinned host pages in use."""
    monkeypatch.setenv("LOCALAI_KV_PAGE", "16")
    spec, params = _tiny_model(cuda_device)
    params = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in params.items()}
    # 7 pages for the resident, 10 for the newcomer: 11 usable pages
    eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=2, max_seq=256,
                    kv_pages=12, cache_dtype=(torch.int8 if kv == "int8"
                                              else torch.bfloat16),
                    device=cuda_device)
    try:
        assert eng._tier is not None and eng._tier.slab.buf.is_pinned()
        first = list(range(1, 101))
        ev = eng.generate(GenRequest(prompt_ids=first, max_tokens=4,
                                     ignore_eos=True))
        assert ev.finish_reason == "length"
        slot = next(s for s in eng.slots if s.cache_tokens)
        tokens = list(slot.cache_tokens)
        pages = eng._pool.table(slot.idx)
        tbl = torch.tensor(pages, dtype=torch.long, device=cuda_device)
        planes = eng._tier._planes()
        before = {nm: a[:, tbl].clone() for nm, a in planes.items()}
        spills0 = eng._tier.counters["spills"]
        ev = eng.generate(GenRequest(prompt_ids=list(range(3, 153)),
                                     max_tokens=4, ignore_eos=True))
        assert ev.finish_reason == "length"
        eng._tier.settle()
        assert eng._tier.counters["spills"] == spills0 + 1
        ent = next(e for e in eng._tier.entries() if e.tokens == tokens)
        rows = eng._tier.host_rows(ent)
        changed = False
        for nm, ref in before.items():
            want = ref.reshape(ref.shape[0], -1, *ref.shape[3:])
            got = rows[nm]
            assert got.shape == want.shape
            assert torch.equal(got.contiguous().view(torch.uint8),
                               want.cpu().contiguous().view(torch.uint8))
            changed |= not torch.equal(planes[nm][:, tbl], ref)
        assert changed, "the newcomer did not overwrite the spilled pages"
        eng._tier.leak_check()
        eng.leak_check()
    finally:
        eng.close()


# ------------------------------------------------- weight paging, disagg


def _big_tree(device, mib: int = 256) -> dict:
    """A parameter-shaped tree of about ``mib`` MiB (stacked leaves, a
    norm, an int8 QTensor), random from a seed, on ``device``."""
    g = torch.Generator().manual_seed(5)
    n = mib * (1 << 20) // 2 // 4 // 1024
    return {"wq": torch.randn((4, n, 1024), generator=g).to(
                device, torch.bfloat16),
            "ln1_w": torch.randn((4, 1024), generator=g).to(device),
            "w_up": tq.QTensor(torch.randint(-127, 128, (4, 256, 1024),
                                             dtype=torch.int8,
                                             generator=g).to(device),
                               torch.rand((4, 1024), generator=g).to(device))}


@pytest.mark.cuda
def test_weight_slab_frees_hbm_on_unmap(cuda_device):
    """The slab's memory is released on unmap (free device
    memory rises by at least the tree's bytes less one granule), comes
    back at the same addresses on map, and the views read what is copied
    into them; release returns the range."""
    from localai_tfp_tpu_torch.models.weight_slab import WeightSlab

    tree = _big_tree(cuda_device)
    want = {k: (tuple(t.cpu() for t in v) if isinstance(v, tq.QTensor)
                else v.cpu()) for k, v in tree.items()}
    own = tree
    slab = WeightSlab(own, cuda_device)  # the leaves move in place
    ptrs = {k: tuple(t.data_ptr() for t in tq.leaves(v))
            for k, v in own.items()}
    assert all(slab._ptr <= p < slab._ptr + slab.nbytes
               for v in ptrs.values() for p in v)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0, _ = torch.cuda.mem_get_info()
    slab.unmap()
    free1, _ = torch.cuda.mem_get_info()
    assert free1 - free0 >= slab.tree_bytes - slab.granularity, (
        free0, free1, slab.tree_bytes)
    slab.map()
    for k, v in own.items():
        src = want[k] if isinstance(want[k], tuple) else (want[k],)
        for t, s in zip(tq.leaves(v), src):
            t.copy_(s)
    assert {k: tuple(t.data_ptr() for t in tq.leaves(v))
            for k, v in own.items()} == ptrs
    for k, v in own.items():
        src = want[k] if isinstance(want[k], tuple) else (want[k],)
        for t, s in zip(tq.leaves(v), src):
            assert torch.equal(t.cpu(), s)
    del own, tree, v, t
    slab.release()
    assert slab.released and not slab.mapped


def _paged_engine(device, **kw):
    spec, params = _tiny_model(device)
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    return LLMEngine(spec, params, ByteTokenizer(), n_slots=2, max_seq=256,
                     cache_dtype=torch.bfloat16, device=device,
                     weight_paging=True, **kw)


def _demote(pager):
    import time

    deadline = time.monotonic() + 60
    while not pager.request_demote():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert pager.settle(60) and pager.state == "warm"


@pytest.mark.cuda
def test_graph_captured_before_unmap_replays_bitwise_after_map(cuda_device):
    """Every variant is captured while hot; the weights are demoted (the
    slab unmapped) and promoted (fresh memory at the same addresses); the
    same graph objects replay and give bitwise the logits they gave
    before, and a greedy request's ids are the same."""
    eng = _paged_engine(cuda_device)
    try:
        eng.warmup()
        graphs = {id(v.graph) for d in (eng._variants,
                                        eng._masked_variants,
                                        eng._mixed_variants)
                  for v in d.values()}
        n = eng.variant_count()
        v = eng._variant(2)
        # an all-pad replay (the trash page, the sentinel row) from the
        # same inputs each time: the graph chains its next input itself
        with torch.inference_mode():
            eng._fill(v, [], 1)
            v.graph.replay()
            before = v.logits.clone()
        req = dict(prompt_ids=list(range(1, 60)), max_tokens=12,
                   ignore_eos=True)
        ids0 = eng.generate(GenRequest(**req)).full_text
        _demote(eng._pager)
        assert not eng._pager.slab.mapped and eng.params is None
        assert eng._pager.ensure_hot(60)
        with torch.inference_mode():
            eng._fill(v, [], 1)
            v.graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(v.logits, before)
        b1 = ragged_paged_attention.launches
        assert eng.generate(GenRequest(**req)).full_text == ids0
        assert ragged_paged_attention.launches > b1
        assert eng.variant_count() == n
        assert {id(v.graph) for d in (eng._variants, eng._masked_variants,
                                      eng._mixed_variants)
                for v in d.values()} == graphs
        eng.leak_check()
    finally:
        eng.close()
        eng.release()


@pytest.mark.cuda
def test_seeded_mirror_is_pinned_by_its_demotion(cuda_device):
    """A mirror seeded from pageable host planes (an int8 artifact's
    file mapping) is pinned by the seed demotion, which copies nothing
    off the device; the promotion from it restores the tree bitwise."""
    eng = _paged_engine(cuda_device)
    try:
        pager = eng._pager
        host = {k: (tq.QTensor(*(t.cpu() for t in v))
                    if isinstance(v, tq.QTensor) else v.cpu())
                for k, v in eng.params.items()}
        assert not any(t.is_pinned() for v in host.values()
                       for t in tq.leaves(v))
        want = {k: [t.clone() for t in tq.leaves(v)]
                for k, v in host.items()}
        pager.seed_host(host, eng.params)
        _demote(pager)
        assert pager.timings["demote_outcome"] == "seed"
        assert "demote_copy_s" not in pager.timings
        assert pager.timings["mirror_pin_s"] > 0
        assert all(t.is_pinned() for v in pager._host.values()
                   for t in tq.leaves(v))
        assert pager.ensure_hot(60)
        for k, v in eng.params.items():
            for t, w in zip(tq.leaves(v), want[k]):
                assert torch.equal(t.cpu(), w)
        eng.leak_check()
    finally:
        eng.close()
        eng.release()


@pytest.mark.cuda
def test_warm_engine_refuses_embed_until_hot(cuda_device):
    """An embedding on a warm engine never reads the unmapped slab: it
    waits behind the promotion and then gives the hot engine's vector,
    bitwise."""
    eng = _paged_engine(cuda_device)
    try:
        want = eng.embed("an embedding across a round trip")
        _demote(eng._pager)
        got = eng.embed("an embedding across a round trip")
        assert eng._pager.state == "hot"
        assert eng._pager.counters["promotes"] == 1
        assert torch.equal(got, want)
        eng.leak_check()
    finally:
        eng.close()
        eng.release()


@pytest.mark.cuda
def test_migration_gather_races_the_overwrite_of_its_pages(cuda_device,
                                                          monkeypatch):
    """A probe's pages are gathered for migration; before the router's
    pump copies them to the host, the next probe (a graph replay on the
    prefill engine) overwrites those pages. The gather ran on the
    engine's stream first and the pump copies the gathered tensor, never
    the arena: the migrated host pages equal the pages as captured,
    bitwise, and the arena pages did change."""
    import threading

    from localai_tfp_tpu_torch.engine.kv_migrate import (
        DisaggRouter, build_prefill_engine)

    monkeypatch.setenv("LOCALAI_KV_PAGE", "16")
    monkeypatch.setenv("LOCALAI_DISAGG_MIN_PROMPT", "16")
    monkeypatch.setenv("LOCALAI_DISAGG_PREFILL_SLOTS", "1")
    spec, params = _tiny_model(cuda_device)
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    decode = LLMEngine(spec, params, ByteTokenizer(), n_slots=2,
                       max_seq=256, cache_dtype=torch.bfloat16,
                       device=cuda_device, weight_paging=False)
    # one slot and 8 usable pages: the second probe reuses the first's
    prefill = build_prefill_engine(spec, params, ByteTokenizer(),
                                   decode=decode)
    prefill._pool.__init__(9, prefill.page)
    router = DisaggRouter(prefill, decode)
    captured, hosts, second_done = {}, {}, threading.Event()
    on_finish = prefill._migrator.on_finish

    def spy_finish(slot, reason):
        if slot.request.id.endswith(":prefill") and "first" not in captured:
            captured["rid"] = slot.request.id[:-len(":prefill")]
            tbl = torch.tensor(prefill._pool.table(slot.idx)[:7],
                               device=cuda_device)
            captured["first"] = (tbl, {"k": prefill.cache.k[:, tbl].clone(),
                                       "v": prefill.cache.v[:, tbl].clone()})
        elif slot.request.id.endswith(":prefill"):
            second_done.set()
        return on_finish(slot, reason)

    collect = router.bus.collect

    def late_collect(rid, timeout):
        # each request has its own pump: only the first probe's collect
        # waits for the overwrite and keeps its host pages
        first = rid == captured.get("rid")
        if first:
            assert second_done.wait(60), "the second probe never finished"
            torch.cuda.synchronize()
        h, why = collect(rid, timeout)
        if h is not None and first:
            blocks = router.bus.blocks(h.hpids)
            hosts.update({nm: torch.stack([b.arrays[nm] for b in blocks],
                                          1).clone() for nm in ("k", "v")})
        return h, why

    monkeypatch.setattr(prefill._migrator, "on_finish", spy_finish)
    monkeypatch.setattr(router.bus, "collect", late_collect)
    router.start()
    try:
        qs = router.submit_many([
            GenRequest(prompt_ids=list(range(1, 101)), max_tokens=4,
                       ignore_eos=True),
            GenRequest(prompt_ids=list(range(3, 103)), max_tokens=4,
                       ignore_eos=True)])
        for q in qs:
            ev = q.get(timeout=300)
            while not ev.done:
                ev = q.get(timeout=300)
            assert ev.finish_reason == "length", ev.error
        tbl, ref = captured["first"]
        changed = False
        for nm in ("k", "v"):
            want = ref[nm][:, :hosts[nm].shape[1]]
            assert torch.equal(hosts[nm].view(torch.uint8).cpu(),
                               want.contiguous().view(torch.uint8).cpu())
            arena = getattr(prefill.cache, nm)
            changed |= not torch.equal(arena[:, tbl], ref[nm])
        assert changed, "the second probe did not overwrite the pages"
        assert decode._migrator.counters["adoptions"] >= 1
        router.leak_check()
    finally:
        router.close()


def _soft_wave(spec, seed: int) -> list:
    """Two image prompts (soft rows at positions 100..163, across the
    first 128-token chunk's end, and 10..41) beside a text prompt: two
    mixed steps carry soft rows."""
    rng = np.random.default_rng(seed)

    def soft(n_pos, start, length):
        return GenRequest(
            prompt_ids=[(7 * i) % 250 + 1 for i in range(length)],
            max_tokens=6, ignore_eos=True,
            soft_embeds=rng.normal(size=(n_pos, spec.d_model)).astype(
                np.float32),
            soft_positions=np.arange(start, start + n_pos))

    return [soft(64, 100, 200), soft(32, 10, 60),
            GenRequest(prompt_ids=list(range(3, 40)), max_tokens=6,
                       ignore_eos=True)]


@pytest.mark.cuda
def test_image_prefill_replays_equal_the_eager_bodies(cuda_device):
    """Image prompts (soft rows) through a multimodal engine's mixed
    variants by graph replay, every one captured at warmup (none
    mid-request), against the same bodies run eagerly: ids
    and every K/V page but the trash page bitwise, every soft step a
    replay, B1 once per layer of every forward."""
    spec, params = _family_model(cuda_device, "gemma3")
    engines = []
    for eager in (False, True):
        eng = LLMEngine(spec, params, ByteTokenizer(), n_slots=4,
                        max_seq=256, cache_dtype=torch.bfloat16,
                        autostart=False, device=cuda_device, multimodal=True)
        if eager:
            eng._mixed_launch = eng._mixed_body
            eng._decode_launch = eng._decode_body
        else:
            eng.warmup()
            captured = set(eng._mixed_variants)
        engines.append(eng)
    graph, eager = engines
    try:
        got, want, launches = [], [], []
        for eng, out in ((graph, got), (eager, want)):
            b1 = ragged_paged_attention.launches
            out.append(_drive(eng, _soft_wave(spec, 4)))
            launches.append(ragged_paged_attention.launches - b1)
        torch.cuda.synchronize()
        assert got == want
        assert torch.equal(graph.cache.k[:, 1:], eager.cache.k[:, 1:])
        assert torch.equal(graph.cache.v[:, 1:], eager.cache.v[:, 1:])
        m = graph.metrics
        assert m.soft_replays == m.soft_steps >= 2
        assert m.mixed_replays == m.mixed_steps
        assert set(graph._mixed_variants) == captured
        assert launches[0] == launches[1] == spec.n_layers * m.forward_steps
    finally:
        graph.close()
        eager.close()


def _tower(cuda_device, family: str):
    """A small SigLIP + Gemma 3 projector or CLIP + LLaVA projector in the
    port's tree (bf16), random from a seed."""
    from localai_tfp_tpu_torch.models.vision import VisionSpec

    spec = VisionSpec(hidden=64, n_layers=2, n_heads=4, d_ff=128,
                      image_size=56, patch_size=14, mm_tokens=4,
                      text_d_model=96, family=family)
    g = torch.Generator().manual_seed(5)
    L, D, F, T = 2, 64, 128, 96

    def rnd(*s):
        return torch.randn(s, generator=g) * 0.1

    lay = {"ln1_w": 1 + rnd(L, D), "ln1_b": rnd(L, D),
           "ln2_w": 1 + rnd(L, D), "ln2_b": rnd(L, D),
           "fc1_w": rnd(L, D, F), "fc1_b": rnd(L, F),
           "fc2_w": rnd(L, F, D), "fc2_b": rnd(L, D)}
    for w in ("q", "k", "v", "o"):
        lay[f"w{w}"], lay[f"b{w}"] = rnd(L, D, D), rnd(L, D)
    n = spec.n_patches + (family == "clip")
    vp = {"patch_w": rnd(3 * 14 * 14, D), "pos_embed": rnd(n, D),
          "layers": lay}
    if family == "clip":
        vp.update(cls_embed=rnd(D), pre_ln_w=1 + rnd(D), pre_ln_b=rnd(D),
                  mm_l1_w=rnd(D, T), mm_l1_b=rnd(T), mm_l2_w=rnd(T, T),
                  mm_l2_b=rnd(T))
    else:
        vp.update(patch_b=rnd(D), post_ln_w=1 + rnd(D), post_ln_b=rnd(D),
                  mm_norm_w=rnd(D), mm_proj=rnd(D, T))

    def cast(t):
        return t.to(cuda_device, torch.bfloat16)

    vp = {k: ({n: cast(t) for n, t in v.items()} if isinstance(v, dict)
              else cast(v)) for k, v in vp.items()}
    return spec, vp


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["siglip", "clip"])
def test_tower_replays_equal_the_eager_tower(cuda_device, family):
    """The served tower (``TowerRunner``: one graph replay an image)
    against ``encode_images`` run eagerly on each image: soft rows
    bitwise, one replay an image, nothing captured after ``capture``."""
    from localai_tfp_tpu_torch.models.vision import TowerRunner, encode_images

    spec, vp = _tower(cuda_device, family)
    run = TowerRunner(spec, vp, cuda_device)
    run.capture()
    graph = run.graph
    pix = np.random.default_rng(3).normal(
        size=(3, 3, spec.image_size, spec.image_size)).astype(np.float32)
    for _ in range(2):  # the staging reused
        got = run.encode(pix)
        want = torch.cat([encode_images(spec, vp, torch.from_numpy(
            pix[i:i + 1]).to(cuda_device, torch.bfloat16))
            for i in range(len(pix))])
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert run.replays == 6 and run.graph is graph and run.pool_bytes > 0


def _recurrent(cuda_device, family: str):
    """A small Mamba (bf16) or RWKV (f32) in the port's tree, random from
    a seed."""
    from localai_tfp_tpu_torch.models import mamba, rwkv

    g = torch.Generator().manual_seed(11)

    def rnd(*s, scale=None):
        return torch.randn(s, generator=g) * (scale or s[-2] ** -0.5)

    if family == "mamba":
        spec = mamba.MambaSpec(vocab_size=300, d_model=128, n_layers=3,
                               d_inner=256, d_state=16, d_conv=4, dt_rank=8)
        L, D, Di, N, R = 3, 128, 256, 16, 8
        p = {"embed": rnd(300, D, scale=0.1), "final_norm_w": torch.ones(D),
             "layers": {
                 "norm_w": torch.ones(L, D), "in_w": rnd(L, D, 2 * Di),
                 "conv_w": rnd(L, Di, 4, scale=0.5), "conv_b": rnd(L, Di),
                 "x_proj_w": rnd(L, Di, R + 2 * N),
                 "dt_w": rnd(L, R, Di), "dt_b": rnd(L, Di, scale=0.1),
                 "A_log": torch.log(torch.arange(1, N + 1).float()).expand(
                     L, Di, N).clone(),
                 "D": torch.ones(L, Di), "out_w": rnd(L, Di, D)}}
        cast = {k: v.to(cuda_device, torch.bfloat16) for k, v in p.items()
                if k != "layers"}
        cast["layers"] = {k: v.to(cuda_device, torch.bfloat16)
                          for k, v in p["layers"].items()}
        return mamba, spec, cast
    spec = rwkv.RwkvSpec(vocab_size=300, d_model=128, n_layers=3,
                         rescale_every=2)
    L, D, F = 3, 128, 256
    lay = {k: torch.ones(L, D) for k in ("ln1_w", "ln2_w")}
    lay.update({k: torch.zeros(L, D) for k in ("ln1_b", "ln2_b")})
    lay.update({k: torch.rand(L, D, generator=g) for k in (
        "time_mix_key", "time_mix_value", "time_mix_receptance",
        "ffn_time_mix_key", "ffn_time_mix_receptance")})
    lay.update(time_decay=rnd(L, D, scale=0.5),
               time_first=rnd(L, D, scale=0.5),
               key_w=rnd(L, D, D), value_w=rnd(L, D, D),
               receptance_w=rnd(L, D, D), output_w=rnd(L, D, D),
               ffn_key_w=rnd(L, D, F), ffn_value_w=rnd(L, F, D),
               ffn_receptance_w=rnd(L, D, D))
    p = {"embed": rnd(300, D, scale=1.0), "pre_ln_w": torch.ones(D),
         "pre_ln_b": torch.zeros(D), "ln_out_w": torch.ones(D),
         "ln_out_b": torch.zeros(D), "head": rnd(D, 300), "layers": lay}
    cast = {k: v.to(cuda_device) for k, v in p.items() if k != "layers"}
    cast["layers"] = {k: v.to(cuda_device) for k, v in lay.items()}
    return rwkv, spec, cast


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mamba", "rwkv"])
def test_recurrent_decode_graphs_equal_the_eager_step(cuda_device, family):
    """The step graphs (one replay per prompt token and per decode token)
    against the same step run eagerly: greedy ids bitwise, seeded
    sampled ids too, and the replay count."""
    mod, spec, params = _recurrent(cuda_device, family)
    run = mod.runner(spec, params, cuda_device)
    eager = mod.runner(spec, params, cuda_device, eager=True)
    prompt = [5, 77, 3, 140, 9, 250, 31]
    got = run.generate(prompt, 40)
    assert run.replays == len(prompt) + 40 and run.graphs
    assert got.tolist() == eager.generate(prompt, 40).tolist()
    a = run.generate(prompt, 24, temperature=0.9, seed=4)
    b = eager.generate(prompt, 24, temperature=0.9, seed=4)
    assert a.tolist() == b.tolist()
    eos = int(got[10])
    trimmed = run.generate(prompt, 40, eos_id=eos).tolist()
    assert trimmed == got[:got.tolist().index(eos) + 1].tolist()


def _whisper(cuda_device):
    """A small Whisper in the port's tree (f32, random from a seed) and
    a log-mel chunk."""
    from localai_tfp_tpu_torch.models import whisper as tw

    spec = tw.WhisperSpec(vocab_size=600, d_model=128, n_audio_layers=2,
                          n_text_layers=2, n_heads=4, d_ff=256,
                          max_target=96, sot=597, eot=598, no_timestamps=599,
                          timestamp_begin=599, lang_base=596,
                          task_transcribe=595, task_translate=594)
    g = torch.Generator().manual_seed(21)
    D, F, L = 128, 256, 2

    def rnd(*s, scale=0.05):
        return (torch.randn(s, generator=g) * scale).to(cuda_device)

    def attn():
        return {"wq": rnd(L, D, D), "bq": rnd(L, D), "wk": rnd(L, D, D),
                "wv": rnd(L, D, D), "bv": rnd(L, D), "wo": rnd(L, D, D),
                "bo": rnd(L, D), "ln_w": 1 + rnd(L, D), "ln_b": rnd(L, D)}

    def mlp():
        return {"w_up": rnd(L, D, F), "b_up": rnd(L, F),
                "w_down": rnd(L, F, D), "b_down": rnd(L, D),
                "ln_w": 1 + rnd(L, D), "ln_b": rnd(L, D)}

    p = {"conv1_w": rnd(3, 80, D), "conv1_b": rnd(D),
         "conv2_w": rnd(3, D, D), "conv2_b": rnd(D),
         "enc_pos": rnd(1500, D, scale=0.5), "enc_attn": attn(),
         "enc_mlp": mlp(), "enc_ln_w": 1 + rnd(D), "enc_ln_b": rnd(D),
         "tok_emb": rnd(600, D, scale=0.5), "dec_pos": rnd(96, D),
         "dec_self": attn(), "dec_cross": attn(), "dec_mlp": mlp(),
         "dec_ln_w": 1 + rnd(D), "dec_ln_b": rnd(D)}
    audio = np.random.default_rng(5).normal(size=16000 * 20) * 0.1
    return tw, spec, p, tw.log_mel_spectrogram(audio.astype(np.float32))


@pytest.mark.cuda
def test_whisper_replays_equal_the_eager_decoder(cuda_device):
    """The served Whisper (``WhisperRunner``: one encoder replay a chunk,
    one replay a decode step) against the same bodies run eagerly: the
    encoder states bitwise equal to the eager encoder's, greedy ids equal
    (and each equal to the plain full-recompute decoder's unless the
    plain logits' top two are within 1e-4 at the first difference), the
    replay count, nothing captured after ``capture``."""
    tw, spec, p, mel = _whisper(cuda_device)
    run = tw.WhisperRunner(spec, p, cuda_device)
    run.capture()
    graphs = dict(run.graphs)
    eager = tw.WhisperRunner(spec, p, cuda_device, eager=True)
    m = torch.from_numpy(mel)[None].to(cuda_device)
    enc = run.encode(mel).clone()
    assert torch.equal(enc, tw.encode_audio(spec, p, m))
    prompt = [597, 596, 595, 599]
    for _ in range(2):
        got = run.transcribe(mel, 80, prompt)
        assert got.tolist() == eager.transcribe(mel, 80, prompt).tolist()
    assert run.graphs == graphs and run.replays >= 2 * (1 + 4 + 32)
    plain = tw.greedy_transcribe(spec, p, m, 80, torch.tensor(prompt))
    plain = plain.cpu().numpy()
    if plain.tolist() != got.tolist():
        i = int(np.nonzero(plain != got)[0][0])
        buf = torch.tensor([prompt + plain[:i].tolist()], device=cuda_device)
        lg = tw.decode_logits(spec, p, buf, enc)[0, -1]
        assert float(lg[plain[i]] - lg[got[i]]) < 1e-4


@pytest.mark.cuda
def test_vad_block_replays_equal_the_chunk_loop(cuda_device):
    """The served VAD (the batched front end, then one graph replay a
    block of LSTM steps) against the eager block bodies (bitwise) and the
    chunk-by-chunk loop (within 1e-5), over 1875 chunks (60 s)."""
    from localai_tfp_tpu_torch.models import vad_net as tv

    g = torch.Generator().manual_seed(8)

    def t(*shape, scale=0.1):
        return torch.randn(*shape, generator=g) * scale

    H = 128
    sd = {"_model.stft.forward_basis_buffer": t(258, 1, 256)}
    for i, (cin, cout) in enumerate(((129, 128), (128, 64), (64, 64),
                                     (64, 128))):
        sd[f"_model.encoder.{i}.reparam_conv.weight"] = t(cout, cin, 3)
        sd[f"_model.encoder.{i}.reparam_conv.bias"] = t(cout)
    for k in ("weight_ih", "weight_hh"):
        sd[f"_model.decoder.rnn.{k}"] = t(4 * H, H)
    for k in ("bias_ih", "bias_hh"):
        sd[f"_model.decoder.rnn.{k}"] = t(4 * H)
    sd["_model.decoder.decoder.2.weight"] = t(1, H, 1, scale=1.0)
    sd["_model.decoder.decoder.2.bias"] = t(1)
    params = tv.load_state_dict(sd, cuda_device)
    audio = (np.random.default_rng(2).normal(size=16000 * 60) * 0.2
             ).astype(np.float32)
    run = tv.VADRunner(params, cuda_device)
    got = run.probabilities(audio)
    assert got.shape == (1875,) and run.replays == 30
    eager = tv.VADRunner(params, cuda_device, eager=True)
    assert np.array_equal(got, eager.probabilities(audio))
    np.testing.assert_allclose(got, tv.speech_probs(params, audio), rtol=0,
                               atol=1e-5)
