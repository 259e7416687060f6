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
                   seed=0, device="cpu") -> dict:
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
             sliding_window=window)
    return c


def call_case(fn, c):
    return fn(c["q"], c["cache_k"], c["cache_v"], c["layer"],
              c["page_table"], c["pos0"], c["q_lens"], c["n_kv_heads"],
              scale=c["scale"], page=c["page"],
              sliding_window=c["sliding_window"],
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
