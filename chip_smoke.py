"""Chip smoke test for the PyTorch/CUDA port (localai_tfp_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one result line each; any failure raises and exits non-zero:

1. device  — the card's name and count, and nvidia-smi's name and power
   limit.
2. build   — nvcc builds every kernel from csrc/ (all sources at once);
   prints build seconds, each instance's -Xptxas -v registers and spill
   bytes (ragged_paged_attention must spill nothing), and its shared
   memory and resident blocks per SM.
3. kernels — every kernel against its plain PyTorch version.
   ragged_paged_attention at the Llama-3.1-8B attention width (H 32,
   Hkv 8, Dh 128, page 256): the decode / prefill / mixed / verify row
   mixes with shuffled page tables, bf16 and int8 pages, and seeded
   decode; then the main path's shapes (8 slots, context 2048): a seeded
   decode step, one with every row near the context's end, a windowed
   one, a mixed step, and a mixed step with a 512-token chunk near the
   context's end; every comparison within 1e-4 absolute, and every call
   repeated bitwise. Its times are cold: each timed call reads another
   layer of a 4-layer arena, so a layer's K/V has left the L2 when its
   turn comes round.
   int8_matmul at every 8B projection shape (K x N 4096 x 4096,
   4096 x 1024, 4096 x 14336, 14336 x 4096), M in {1, 8, 37, 128, 1024},
   bf16 and f32 x, bf16 and f32 out: f32 out within 1e-4 of the largest
   output, bf16 out within one bf16 ulp of each output plus that bound. Then times each kernel, its plain
   version, one library call and (int8) the bf16 cuBLAS product over the
   dequantized weight, and computes each kernel's bound.
4. main    — writes a Llama-3.1-8B-geometry checkpoint (random bf16
   weights from a seed), starts the port's HTTP server in-process, sends
   concurrent streaming and non-streaming /v1/chat/completions requests,
   checks the responses, and checks that the main path launched the
   kernels (attention exactly once per layer of every forward). Then
   eight decoding requests run under torch.profiler: device busy time
   against the host clock of the decode steps, and the top kernels. Twice: the bf16 model (attention kernel), then the same
   checkpoint served with ``quantization: int8`` (both kernels),
   quantized on the card at a cold load, then reloaded from its on-disk
   artifact.

The last line of standard output is the result object; the line before
it lists every kernel with its numbers.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the 8B model's attention geometry (Llama-3.1-8B config.json)
H, HKV, DH, PAGE = 32, 8, 128, 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
# The JAX harness's bounds (localai_tfp_tpu/ops/kernel_check.py) hold a
# bf16 Pallas kernel against an f32 reference. Here the kernel and its
# plain version both compute in f32 from the same bf16/int8 values, so the
# check fails at a far tighter absolute bound: 1e-4 is well below what a
# wrong mask, seed row or page (>= ~3e-4 at ctx 2048) moves an output.
JAX_TOL = {"bf16": 2e-2, "int8": 5e-2}
TOL = 1e-4


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require_package():
    if not (ROOT / "localai_tfp_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py must run from a checkout of the repo "
                         "(localai_tfp_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(ROOT))


# ------------------------------------------------------------------ phase 1


def phase_device():
    import torch

    from localai_tfp_tpu_torch.device import describe

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = describe()
    log("device", **dev, nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda)
    return dev, smi


# ------------------------------------------------------------------ phase 2


def phase_build():
    from localai_tfp_tpu_torch.ops import _build, int8_matmul
    from localai_tfp_tpu_torch.ops import ragged_paged_attention as rpa

    t0 = time.perf_counter()
    built = _build.build_all([rpa.KERNEL, int8_matmul.KERNEL])
    report = {}
    for name, b in built.items():
        report[name] = ptxas_summary(b.ptxas)
        log("build", kernel=name, nvcc_s=round(b.seconds, 3),
            wall_s=round(time.perf_counter() - t0, 3), ptxas=report[name])
    occ = rpa.occupancy()
    log("build_occupancy", kernel=rpa.KERNEL, instances=occ)
    spilled = [r for r in report[rpa.KERNEL] if r["spill_bytes"]]
    if spilled:
        raise AssertionError(f"{rpa.KERNEL} spills registers: {spilled}")
    return report, occ


def ptxas_summary(text: str) -> list[dict]:
    """Per kernel instance: registers and spill bytes from -Xptxas -v."""
    import re

    def short(entry: str) -> str:
        # rpa_kernel<QT, KT, DH, BM> as "q/kv/dh/bm"; other kernels whole
        m = re.search(r"rpa_kernelI(13__nv_bfloat16|f)(S1_|a|f)Li(\d+)ELi(\d+)E",
                      entry)
        if not m:
            return entry
        q = "bf16" if m.group(1) != "f" else "f32"
        kv = {"S1_": "bf16", "a": "i8", "f": "f32"}[m.group(2)]
        return f"rpa q {q} kv {kv} dh {m.group(3)} bm {m.group(4)}"

    rows = []
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            rows.append({"entry": short(m.group(1)), "registers": None,
                         "spill_bytes": 0})
        elif rows and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            rows[-1]["spill_bytes"] = int(st) + int(ld)
        elif rows and "Used" in ln and "registers" in ln:
            rows[-1]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return rows


# ------------------------------------------------------------------ phase 3


def make_case(mix: str, quant: bool, seeded: bool, *, B: int, max_pages: int,
              seed: int, L: int = 2, window=None):
    """Inputs in the style of localai_tfp_tpu/ops/kernel_check.py
    check_ragged_attention: shuffled page tables over a shared arena, at
    the 8B attention width, on the card. ``chunk512`` is the main path's
    mixed step at its fullest: a 512-token prefill chunk (the engine's
    chunk at 8 slots) beside decode, verify and shorter chunk rows, every
    row ending within 64 tokens of the context's end; ``decode_long``
    a decode step whose every row ends within 160 tokens of it. ``L``
    layers of arena; the call reads layer 1, or ``layer`` as cycled by
    the timing."""
    import numpy as np
    import torch

    from localai_tfp_tpu_torch.models.transformer import _quantize_rows

    rng = np.random.default_rng(seed)
    kd = 4
    if mix in ("decode", "decode_long"):
        q_lens = np.ones(B, np.int32)
    elif mix == "prefill":
        q_lens = rng.integers(2, 257, B).astype(np.int32)
    elif mix == "verify":
        q_lens = np.full(B, kd, np.int32)
    elif mix == "chunk512":
        q_lens = np.resize(np.asarray([512, 1, 1, 7, kd, 64, 1, 300],
                                      np.int32), B)
    else:  # decode rows + chunks + one verify row together
        q_lens = np.resize(np.asarray([1, 1, 7, 256, kd, 64], np.int32), B)
    T = int(q_lens.max())
    cap = max_pages * PAGE
    near = {"chunk512": 64, "decode_long": 160}.get(mix)
    lo = (lambda n: cap - n - near) if near else (lambda n: 0)
    pos0 = np.asarray([int(rng.integers(lo(int(n)), cap - int(n) + 1))
                       for n in q_lens], np.int32)
    n_pages = B * max_pages + 1
    pt = rng.permutation(np.arange(1, n_pages)).reshape(
        B, max_pages).astype(np.int32)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    F = HKV * DH
    ak = torch.randn((L, n_pages, PAGE, F), generator=g, device=dev) * 0.5
    av = torch.randn((L, n_pages, PAGE, F), generator=g, device=dev) * 0.5
    # logits with a std of about 0.5, so the softmax is not near uniform
    q = torch.randn((B, T, H, DH), generator=g, device=dev).to(torch.bfloat16)
    case = {
        "q": q, "layer": 1, "n_kv_heads": HKV, "scale": DH ** -0.5,
        "page_table": torch.from_numpy(pt).to(dev),
        "pos0": torch.from_numpy(pos0).to(dev),
        "q_lens": torch.from_numpy(q_lens).to(dev), "window": window,
    }
    if quant:
        kq, ks = _quantize_rows(ak)
        vq, vs = _quantize_rows(av)
        case.update(cache_k=kq, cache_v=vq, cache_k_scale=ks,
                    cache_v_scale=vs)
    else:
        case.update(cache_k=ak.to(torch.bfloat16),
                    cache_v=av.to(torch.bfloat16))
    if seeded:
        case["seed_kv"] = (
            (torch.randn((B, F), generator=g, device=dev) * 0.5
             ).to(torch.bfloat16),
            (torch.randn((B, F), generator=g, device=dev) * 0.5
             ).to(torch.bfloat16))
    return case


def _call(fn, c):
    return fn(c["q"], c["cache_k"], c["cache_v"], c["layer"],
              c["page_table"], c["pos0"], c["q_lens"], c["n_kv_heads"],
              scale=c["scale"], page=PAGE, sliding_window=c["window"],
              cache_k_scale=c.get("cache_k_scale"),
              cache_v_scale=c.get("cache_v_scale"),
              seed_kv=c.get("seed_kv"))


def attention_work(c) -> tuple[int, int]:
    """(bytes, flops) the call must do on these inputs: q, out and each
    row's live K/V rows (and scales) read or written once; 4 flops per
    (query, kv position, head dim) pair actually attended."""
    q_lens = c["q_lens"].tolist()
    pos0 = c["pos0"].tolist()
    elem = c["cache_k"].element_size()
    F = HKV * DH
    nbytes = c["q"].numel() * c["q"].element_size()  # q in
    nbytes += c["q"].shape[0] * c["q"].shape[1] * H * DH * 4  # out f32
    nbytes += c["page_table"].numel() * 4 + 8 * len(q_lens)
    flops = 0
    for n, p0 in zip(q_lens, pos0):
        ctx = p0 + n
        nbytes += 2 * ctx * F * elem
        if "cache_k_scale" in c:
            nbytes += 2 * ctx * 4
        attended = sum(p0 + t + 1 for t in range(n))
        flops += 4 * H * DH * attended
    return nbytes, flops


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _library_call(c):
    """One PyTorch call computing the same attention: scaled_dot_product_
    attention over each row's gathered [B, H, W, Dh] window with the
    causal/ragged mask (gather and mask built outside the timed call).
    Used here as a yardstick only; the port never calls it."""
    import torch
    import torch.nn.functional as Fnn

    B, T = c["q"].shape[:2]
    pt = c["page_table"].long()
    W = pt.shape[1] * PAGE
    k = c["cache_k"][c["layer"]][pt].reshape(B, W, HKV, DH)
    v = c["cache_v"][c["layer"]][pt].reshape(B, W, HKV, DH)
    if "cache_k_scale" in c:
        ks = c["cache_k_scale"][c["layer"]][pt].reshape(B, W, 1, 1)
        vs = c["cache_v_scale"][c["layer"]][pt].reshape(B, W, 1, 1)
        k, v = k.float() * ks, v.float() * vs
    k = k.to(torch.bfloat16).transpose(1, 2).contiguous()
    v = v.to(torch.bfloat16).transpose(1, 2).contiguous()
    q = c["q"].transpose(1, 2).contiguous()
    kv_pos = torch.arange(W, device=q.device)
    tq = torch.arange(T, device=q.device)
    qpos = c["pos0"].long()[:, None] + tq[None]
    mask = (kv_pos[None, None] <= qpos[..., None]) & (
        tq[None, :, None] < c["q_lens"].long()[:, None, None])
    mask = mask | ~mask.any(-1, keepdim=True)  # keep pad rows finite
    mask = mask[:, None]

    def run():
        return Fnn.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=c["scale"], enable_gqa=True)

    return run


ATTN_LAYERS = 4  # arena depth of the timed cases: see _layers


def _layers(c):
    """The case at each layer of its arena, in turn, as a decode step
    walks its layers: a decode step's live K/V (~30 MB a layer at the
    main path's shapes) is cold again when its layer comes round, since
    the other layers' (~90 MB) pass through the 50 MB L2 in between."""
    return [({**c, "layer": i},) for i in range(ATTN_LAYERS)]


def phase_kernels(n_slots: int, max_pages: int):
    import torch

    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_attention_plain, ragged_paged_attention,
    )

    # the four row mixes on a small arena, then the main path's shapes
    # (every slot, the full context): a seeded decode step, a seeded
    # decode step with every row near the context's end (the longest
    # split ranges), a windowed seeded decode step (window edges inside
    # splits, whole splits outside), a mixed step with and without a
    # window (its chunk rows see the window's edge move), and a step with
    # the engine's 512-token chunk near ctx 2048
    small = [(mix, seeded, 6, 4, None)
             for mix in ("decode", "prefill", "mixed", "verify")
             for seeded in ((False, True) if mix == "decode" else (False,))]
    full = [(mix, seeded, n_slots, max_pages, window)
            for mix, seeded, window in (
                ("decode", True, None), ("decode_long", True, None),
                ("decode", True, 300), ("mixed", False, None),
                ("mixed", False, 300),
                ("chunk512", False, None))]
    worst = {"bf16": 0.0, "int8": 0.0}
    timed = {}  # the full-shape bf16 cases, timed below
    for mix, seeded, B, pages, window in small + full:
        for quant in (False, True):
            seed = len(mix) + 10 * quant + 100 * seeded + B
            is_timed = (B == n_slots and window is None and not quant
                        and mix != "decode_long")
            c = make_case(mix, quant, seeded, B=B, max_pages=pages,
                          seed=seed, window=window,
                          L=ATTN_LAYERS if is_timed else 2)
            if is_timed:
                timed[mix] = (c, seeded)
            got = _call(ragged_paged_attention, c)
            want = _call(ragged_attention_plain, c)
            again = _call(ragged_paged_attention, c)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            repeat = bool(torch.equal(got, again))
            kind = "int8" if quant else "bf16"
            worst[kind] = max(worst[kind], err)
            log("kernel_check", kernel="ragged_paged_attention", mix=mix,
                pages=kind, seeded=seeded, window=window, rows=B,
                max_pages=pages, q_lens=c["q_lens"].tolist(),
                ctx=[p + n for p, n in zip(c["pos0"].tolist(),
                                           c["q_lens"].tolist())],
                max_abs_err=err, max_abs_want=float(want.abs().max()),
                tol=TOL, jax_harness_tol=JAX_TOL[kind],
                bitwise_repeat=repeat)
            if not err < min(TOL, JAX_TOL[kind]):
                raise AssertionError(
                    f"ragged_paged_attention {mix}/{kind}/seeded={seeded} "
                    f"window={window} B={B}: max abs err {err} >= {TOL}")
            if not repeat:
                raise AssertionError(
                    f"ragged_paged_attention {mix}/{kind}: two calls on the "
                    "same inputs differ")
    # timing at the main path's shapes, bf16 pages as the engine serves,
    # each call on a cold layer (_layers)
    timings = {}
    for mix, (c, seeded) in timed.items():
        B = c["q"].shape[0]
        nbytes, flops = attention_work(c)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / BF16_FLOPS else "operations")
        sets = _layers(c)
        before = ragged_paged_attention.launches
        ms = _time_graph(_cycled(
            lambda c: _call(ragged_paged_attention, c), sets), 48)
        # the same calls launched one by one from Python, as the engine
        # launches them today
        eager_ms = _time_ms(_cycled(
            lambda c: _call(ragged_paged_attention, c), sets), 48)
        ragged_paged_attention.launches = before  # timing is not the path
        plain_ms = _time_ms(_cycled(
            lambda c: _call(ragged_attention_plain, c), sets), 8)
        lib_runs = [_library_call(cl) for (cl,) in sets]
        library_ms = _time_graph(_cycled(lambda run: run(),
                                         [(r,) for r in lib_runs]), 24)
        del lib_runs
        timings[mix] = {
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bytes": nbytes, "flops": flops,
            "rows": B, "q_lens": c["q_lens"].tolist(),
            "ctx": [p + n for p, n in zip(c["pos0"].tolist(),
                                          c["q_lens"].tolist())],
            "layers_cycled": ATTN_LAYERS,
        }
        log("kernel_time", kernel="ragged_paged_attention", mix=mix,
            seeded=seeded, **timings[mix])
    return worst, timings


# the 8B projections (K, N): wq/wo, wk/wv, w_gate/w_up, w_down
PROJ_8B = {"wq": (4096, 4096), "wk": (4096, 1024), "w_gate": (4096, 14336),
           "w_down": (14336, 4096)}
INT8_M = (1, 8, 37, 128, 1024)  # decode rows up to a full mixed step
INT8_REL_TOL = 1e-4  # of the largest |output|: f32 out, and bf16 out
# beyond one bf16 unit of each output
L2_BYTES = 50 << 20


def _int8_operands(m: int, k: int, n: int, x_dtype, seed: int):
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    scale = torch.rand((n,), generator=g, device=dev) * 2e-3 + 1e-4
    x = torch.randn((m, k), generator=g, device=dev).to(x_dtype)
    return x, q, scale


def bf16_errors(got, want) -> tuple[float, float]:
    """(max |got - want| in units of want's bf16 spacing, max error beyond
    one such unit relative to max |want|). Both sides round an f32 sum to
    bf16; the two sums differ by their summation order, which moves an
    output that cancels to near zero by many of its own tiny units, so the
    check is one unit plus the f32 bound."""
    import torch

    w = want.float()
    d = (got.float() - w).abs()
    spacing = torch.exp2(torch.floor(torch.log2(
        w.abs().clamp_min(2 ** -126))) - 7)
    excess = (d - spacing).clamp_min(0).max() / w.abs().max()
    return float((d / spacing).max()), float(excess)


def int8_work(m: int, k: int, n: int, x_elem: int, out_elem: int):
    """(bytes, flops): x, q, scale read once, y written once; 2 flops per
    multiply-add."""
    return m * k * x_elem + k * n + n * 4 + m * n * out_elem, 2 * m * n * k


def _time_graph(fn, iters: int) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's per-call cost (Python, allocation, the ctypes
    call) is not in the figure."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


def _cycled(fn, sets):
    """fn over operand copies in turn: together they exceed the L2
    cache, so each call reads its weight from device memory, as a decode
    step does."""
    cyc = itertools.cycle(sets)
    return lambda: fn(*next(cyc))


def phase_int8_kernels():
    """int8_matmul against its plain version at the 8B shapes, then times
    at M = 8 and M = 1024 for w_gate and wk (bf16 x and out, as served)."""
    import torch

    from localai_tfp_tpu_torch.ops.int8_matmul import (
        int8_matmul, int8_matmul_plain, plan,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in f32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {"abs_f32out": 0.0, "abs_bf16out": 0.0, "rel_f32out": 0.0,
             "ulp_bf16out": 0.0, "excess_bf16out": 0.0}
    for name, (k, n) in PROJ_8B.items():
        for m in INT8_M:
            for x_dtype in (torch.bfloat16, torch.float32):
                x, q, s = _int8_operands(m, k, n, x_dtype, seed=m + k + n)
                for out_dtype in (torch.bfloat16, torch.float32):
                    got = int8_matmul(x, q, s, out_dtype)
                    want = int8_matmul_plain(x, q, s, out_dtype)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    top = float(want.float().abs().max())
                    rec = {"kernel": "int8_matmul", "proj": name, "m": m,
                           "k": k, "n": n, "x": str(x_dtype)[6:],
                           "out": str(out_dtype)[6:], "max_abs_err": err,
                           "max_abs_want": top, "plan": plan(m, n, k, sms)}
                    out = "f32out" if out_dtype == torch.float32 \
                        else "bf16out"
                    worst[f"abs_{out}"] = max(worst[f"abs_{out}"], err)
                    if out_dtype == torch.float32:
                        rel = err / top
                        worst["rel_f32out"] = max(worst["rel_f32out"], rel)
                        ok = err <= INT8_REL_TOL * top
                        rec["rel_err"] = rel
                    else:
                        ulps, excess = bf16_errors(got, want)
                        worst["ulp_bf16out"] = max(worst["ulp_bf16out"],
                                                   ulps)
                        worst["excess_bf16out"] = max(
                            worst["excess_bf16out"], excess)
                        ok = excess <= INT8_REL_TOL
                        rec.update(bf16_ulps=ulps, rel_err_beyond_1ulp=excess)
                    log("kernel_check", **rec)
                    if not ok:
                        raise AssertionError(f"int8_matmul disagrees: {rec}")
    timings = {}
    for name in ("w_gate", "wk"):
        k, n = PROJ_8B[name]
        copies = max(1, -(-2 * L2_BYTES // (k * n)))
        for m in (8, 1024):
            sets = [_int8_operands(m, k, n, torch.bfloat16, seed=i)
                    for i in range(copies)]
            nbytes, flops = int8_work(m, k, n, 2, 2)
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
            before = int8_matmul.launches
            ms = _time_graph(_cycled(int8_matmul, sets), 50)
            # the same calls launched one by one from Python, as the
            # engine launches them today
            eager_ms = _time_ms(_cycled(int8_matmul, sets), 50)
            int8_matmul.launches = before  # timing is not the path
            plain_ms = _time_graph(_cycled(int8_matmul_plain, sets), 10)
            lib_sets = [(x, q.T.contiguous(), s.to(x.dtype))
                        for x, q, s in sets]
            try:
                library_ms = _time_graph(
                    _cycled(torch._weight_int8pack_mm, lib_sets),
                    20 if m <= 16 else 2)
                library_error = None
            except (RuntimeError, NotImplementedError) as e:
                library_ms, library_error = None, str(e).splitlines()[0][:160]
            del lib_sets
            bf_sets = [(x, (q.float() * s).to(torch.bfloat16))
                       for x, q, s in sets]
            bf16_matmul_ms = _time_graph(_cycled(torch.matmul, bf_sets), 50)
            del bf_sets
            key = f"{name}_m{m}"
            timings[key] = {
                "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                             >= flops / BF16_FLOPS else "operations"),
                "library_ms": library_ms, "library_error": library_error,
                "bf16_matmul_ms": bf16_matmul_ms, "bytes": nbytes,
                "flops": flops, "m": m, "k": k, "n": n,
                "weight_copies": copies,
            }
            log("kernel_time", kernel="int8_matmul", case=key, **timings[key])
    return worst, timings


# ------------------------------------------------------------------ phase 4

# Llama-3.1-8B-Instruct's published config.json geometry
GEOMETRY = {
    "hidden_size": 4096, "intermediate_size": 14336,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "num_hidden_layers": 32, "vocab_size": 128256, "rope_theta": 500000.0,
    "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "tie_word_embeddings": False,
}
CONTEXT = 2048  # the model config's context_size
SLOTS = 8  # the model config's max_batch_slots


def checkpoint_layout(layers: int) -> list[tuple[str, tuple]]:
    """(name, HF [out, in] shape) of every tensor of the checkpoint."""
    g = GEOMETRY
    D, F, V = g["hidden_size"], g["intermediate_size"], g["vocab_size"]
    q, kv = g["num_attention_heads"] * g["head_dim"], \
        g["num_key_value_heads"] * g["head_dim"]
    out = [("model.embed_tokens.weight", (V, D)), ("model.norm.weight", (D,)),
           ("lm_head.weight", (V, D))]
    for i in range(layers):
        lp = f"model.layers.{i}."
        out += [(lp + "self_attn.q_proj.weight", (q, D)),
                (lp + "self_attn.k_proj.weight", (kv, D)),
                (lp + "self_attn.v_proj.weight", (kv, D)),
                (lp + "self_attn.o_proj.weight", (D, q)),
                (lp + "mlp.gate_proj.weight", (F, D)),
                (lp + "mlp.up_proj.weight", (F, D)),
                (lp + "mlp.down_proj.weight", (D, F)),
                (lp + "input_layernorm.weight", (D,)),
                (lp + "post_attention_layernorm.weight", (D,))]
    return out


PROJ_SUFFIXES = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                 "o_proj.weight", "gate_proj.weight", "up_proj.weight",
                 "down_proj.weight")


def artifact_bytes(layers: int) -> int:
    """Bytes of the int8 model's on-disk artifact: int8 projections with
    f32 per-output scales, everything else bf16."""
    import math

    total = 0
    for name, shape in checkpoint_layout(layers):
        if name.endswith(PROJ_SUFFIXES):
            total += math.prod(shape) + 4 * shape[0]
        else:
            total += 2 * math.prod(shape)
    return total


def choose_depth(want: int, path: Path) -> int:
    """The deepest model up to ``want`` layers whose bf16 checkpoint and
    int8 artifact fit the disk with 4 GB to spare (only depth is ever
    cut)."""
    import math
    import shutil

    def nbytes(layers):
        return (sum(2 * math.prod(s) for _, s in checkpoint_layout(layers))
                + artifact_bytes(layers))

    path.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(path).free
    layers = want
    while layers > 1 and nbytes(layers) + (4 << 30) > free:
        layers -= 1
    if nbytes(layers) + (4 << 30) > free:
        raise SystemExit(f"disk too small for even one layer ({free} B free)")
    return layers


def write_checkpoint(ckpt: Path, layers: int, seed: int) -> tuple[bool, float]:
    """A Llama-3.1-8B-geometry HF checkpoint with random bf16 weights made
    on the card from ``seed`` (``config.json`` as the JAX bench writes it,
    with the published rope_scaling block; no tokenizer.json, so the
    byte tokenizer serves). Reused when its marker matches. Returns
    (written, seconds)."""
    import torch

    from localai_tfp_tpu_torch.models.safetensors_io import save_iter

    marker = ckpt / "written.json"
    want = {"seed": seed, "layers": layers, "geometry": GEOMETRY}
    if marker.is_file() and json.loads(marker.read_text()) == want:
        return False, 0.0
    t0 = time.perf_counter()
    ckpt.mkdir(parents=True, exist_ok=True)
    marker.unlink(missing_ok=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    layout = checkpoint_layout(layers)
    shapes = [(n, torch.empty(s, dtype=torch.bfloat16, device="meta"))
              for n, s in layout]

    def tensors():
        for name, shape in layout:
            if len(shape) == 1:  # norm weights
                yield name, torch.ones(shape, dtype=torch.bfloat16, device=dev)
            else:
                w = torch.randn(shape, generator=g, device=dev)
                yield name, (w * shape[1] ** -0.5).to(torch.bfloat16)

    save_iter(tensors(), str(ckpt / "model.safetensors"), shapes=shapes)
    g_ = GEOMETRY
    config = {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "hidden_size": g_["hidden_size"],
        "intermediate_size": g_["intermediate_size"],
        "num_attention_heads": g_["num_attention_heads"],
        "num_key_value_heads": g_["num_key_value_heads"],
        "num_hidden_layers": layers, "vocab_size": g_["vocab_size"],
        "head_dim": g_["head_dim"], "rope_theta": g_["rope_theta"],
        "rope_scaling": g_["rope_scaling"],
        "max_position_embeddings": g_["max_position_embeddings"],
        "rms_norm_eps": g_["rms_norm_eps"], "torch_dtype": "bfloat16",
        "tie_word_embeddings": False,
        "bos_token_id": 128000, "eos_token_id": 128009,
    }
    (ckpt / "config.json").write_text(json.dumps(config, indent=1))
    marker.write_text(json.dumps(want))
    return True, time.perf_counter() - t0


def _http(port: int, body: dict, timeout: float = 600.0):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


def check_reply(name: str, body: dict, status: int, ctype: str,
                text: str) -> dict:
    """The response's shape and usage, as the JAX server frames them."""
    if status != 200:
        raise AssertionError(f"{name}: HTTP {status}")
    max_tokens = body["max_tokens"]
    if body.get("stream"):
        if not ctype.startswith("text/event-stream"):
            raise AssertionError(f"{name}: content type {ctype}")
        frames = text.split("\n\n")
        if frames[-1] != "" or frames[-2] != "data: [DONE]":
            raise AssertionError(f"{name}: stream does not end in [DONE]")
        chunks = []
        for f in frames[:-2]:
            if not f.startswith("data: "):
                raise AssertionError(f"{name}: bad SSE frame {f[:80]!r}")
            chunks.append(json.loads(f[len("data: "):]))
        if any(c["object"] != "chat.completion.chunk" for c in chunks):
            raise AssertionError(f"{name}: wrong chunk object")
        if chunks[0]["choices"][0]["delta"] != {"role": "assistant",
                                                "content": ""}:
            raise AssertionError(f"{name}: first delta is not the role")
        last = chunks[-1]
        finish = last["choices"][0]["finish_reason"]
        usage = last["usage"]
        content = "".join(c["choices"][0]["delta"].get("content", "")
                          for c in chunks[1:-1])
    else:
        obj = json.loads(text)
        if obj["object"] != "chat.completion":
            raise AssertionError(f"{name}: object {obj['object']}")
        finish = obj["choices"][0]["finish_reason"]
        usage = obj["usage"]
        content = obj["choices"][0]["message"]["content"]
    n = usage["completion_tokens"]
    ok = n > 0 and ((finish == "length" and n == max_tokens)
                    or (finish == "stop" and n <= max_tokens))
    if not ok or usage["total_tokens"] != n + usage["prompt_tokens"]:
        raise AssertionError(f"{name}: finish {finish!r} with usage {usage}")
    return {"name": name, "stream": bool(body.get("stream")),
            "finish_reason": finish, "prompt_tokens": usage["prompt_tokens"],
            "completion_tokens": n, "content_chars": len(content)}


def reference_check(backend, layers: int) -> dict:
    """Greedy tokens the engine serves (paged arena, the CUDA kernel) must
    be argmax — within a tolerance for bf16 rounding — of the plain dense
    forward (``_attend``) over the same prompt and tokens."""
    import torch

    from localai_tfp_tpu_torch.engine.engine import GenRequest
    from localai_tfp_tpu_torch.models.transformer import KVCache, forward

    eng = backend.engine
    got = {}
    orig = eng._finish

    def spy(slot, reason):
        got["ids"] = list(slot.generated)
        return orig(slot, reason)

    eng._finish = spy
    try:
        prompt = backend.tokenizer.encode(
            "A reference prompt for the dense path check. " * 3, add_bos=True)
        ev = eng.generate(GenRequest(prompt_ids=prompt, max_tokens=12,
                                     ignore_eos=True))
    finally:
        eng._finish = orig
    if ev.error:
        raise AssertionError(f"reference request failed: {ev.error}")
    ids = got["ids"]
    seq = prompt + ids[:-1]
    dev = eng.device
    cache = KVCache.create(eng.spec, 1, len(seq), torch.bfloat16, device=dev)
    with torch.inference_mode():
        logits, _ = forward(eng.spec, eng.params,
                            torch.tensor([seq], device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev),
                            cache)
    rows = logits[0, len(prompt) - 1:].float()  # one row per generated token
    tok = torch.tensor(ids, device=dev)
    deficit = rows.max(-1).values - rows.gather(-1, tok[:, None])[:, 0]
    tol = 0.25 * float(rows.std())
    worst = float(deficit.max())
    exact = int((rows.argmax(-1) == tok).sum())
    if not worst <= tol or not torch.isfinite(rows).all():
        raise AssertionError(
            f"served greedy tokens are not the dense reference's argmax: "
            f"worst logit deficit {worst} > tol {tol}")
    return {"tokens": len(ids), "exact_argmax": exact,
            "worst_logit_deficit": worst, "tol": tol}


def param_bytes(params: dict) -> int:
    from localai_tfp_tpu_torch.models.quant import leaves

    return sum(t.numel() * t.element_size() for v in params.values()
               for t in leaves(v))


def run_burst(port: int, model: str, eng) -> dict:
    """Four concurrent requests (two first, two a second later, so both
    arrive while others decode); every kernel count is set to 0 just
    before and read just after."""
    import threading

    import torch

    from localai_tfp_tpu_torch.ops.int8_matmul import int8_matmul
    from localai_tfp_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    long_text = ("The paged arena holds every slot's keys and values. "
                 * 30)
    first = [
        ("short_stream", {"stream": True, "max_tokens": 48,
                          "messages": [{"role": "user",
                                        "content": "Say hello."}]}),
        ("medium", {"max_tokens": 32, "messages": [
            {"role": "system", "content": "You answer briefly."},
            {"role": "user", "content": "Describe ragged attention. "
             * 12}]}),
    ]
    later = [
        ("long_stream", {"stream": True, "max_tokens": 24,
                         "messages": [{"role": "user",
                                       "content": long_text}]}),
        ("sampled", {"max_tokens": 16, "temperature": 0.8, "seed": 7,
                     "top_k": 40, "top_p": 0.9, "messages": [
                         {"role": "user", "content": "Pick a word."}]}),
    ]
    results: dict = {}
    errors: list = []

    def send(name, body):
        body = {"model": model, **body}
        try:
            results[name] = check_reply(name, body, *_http(port, body))
        except Exception as e:  # re-raised below
            errors.append(f"{name}: {e!r}")

    # host-clock seconds inside the engine's step functions (each ends in
    # a host read of the sampled tokens, so device time is included)
    spent = {"_decode_step": 0.0, "_mixed_step": 0.0}

    def clocked(name):
        fn = getattr(eng, name)

        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t
        return run

    for name in spent:
        setattr(eng, name, clocked(name))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.metrics.forward_steps
    mixed0, decode0 = eng.metrics.mixed_steps, eng.metrics.decode_steps
    ragged_paged_attention.launches = 0
    int8_matmul.launches = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=send, args=a) for a in first]
    for t in threads:
        t.start()
    time.sleep(1.0)  # the first two are decoding when the rest arrive
    threads += [threading.Thread(target=send, args=a) for a in later]
    for t in threads[len(first):]:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    launches = {"ragged_paged_attention": ragged_paged_attention.launches,
                "int8_matmul": int8_matmul.launches}
    for name in spent:
        delattr(eng, name)  # the class's methods again
    if errors or len(results) != len(first) + len(later):
        raise AssertionError(f"main path requests failed: {errors}")
    decode = eng.metrics.decode_steps - decode0
    return {
        "requests": list(results.values()), "wall_s": round(wall, 3),
        "completion_tokens": sum(r["completion_tokens"]
                                 for r in results.values()),
        "forward_steps": eng.metrics.forward_steps - steps0,
        "mixed_forwards": eng.metrics.mixed_steps - mixed0,
        "decode_forwards": decode,
        "decode_ms_per_forward": round(
            spent["_decode_step"] * 1e3 / max(1, decode), 3),
        "mixed_steps_s": round(spent["_mixed_step"], 3),
        "launches": launches,
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
    }


def profile_decode(eng) -> dict:
    """Where a decode forward's time goes: 8 concurrent requests (all 8
    slots decoding after one mixed step) under torch.profiler; device
    busy time is the sum of the CUDA kernels' own times, host time the
    host clock around the engine's decode steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from localai_tfp_tpu_torch.engine.engine import GenRequest

    spent = [0.0]
    fn = eng._decode_step

    def clocked(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t

    reqs = [GenRequest(prompt_ids=list(range(1 + i, 101 + i)),
                       max_tokens=24, ignore_eos=True) for i in range(8)]
    eng._decode_step = clocked
    decode0 = eng.metrics.decode_steps
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for q in eng.submit_many(reqs):
                ev = q.get(timeout=600)
                while not ev.done:
                    ev = q.get(timeout=600)
            torch.cuda.synchronize()
    finally:
        del eng._decode_step  # the class's method again
    decode = eng.metrics.decode_steps - decode0
    kernels = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + t / 1e3
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"decode_forwards": decode,
            "host_ms_per_decode_forward": spent[0] * 1e3 / max(1, decode),
            "device_busy_ms_total": busy,
            "top_kernels_ms": {k[:80]: v for k, v in top}}


def serve_model(models: Path, model: str, layers: int,
                quantized: bool) -> dict:
    """Serve one model config through the port's HTTP server: load, the
    burst, its checks, (int8) a reload from the artifact, and the dense
    reference check."""
    import threading

    import torch

    from localai_tfp_tpu_torch.server.app import build_server

    srv = build_server(str(models), port=0, device="cuda")
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warm = {"model": model, "max_tokens": 4,
                "messages": [{"role": "user", "content": "warm up"}]}
        check_reply("load", warm, *_http(port, warm))
        backend = srv.app.loaded()[model]
        eng = backend.engine
        load = {"mode": backend.load_mode, "load_s": round(backend.load_s, 3),
                "load_and_first_request_s": round(time.perf_counter() - t0, 3),
                "param_bytes": param_bytes(eng.params),
                "load_peak_mem_gib": round(
                    torch.cuda.max_memory_allocated() / 2**30, 3)}
        log("main_load", model=model, **load, n_slots=eng.n_slots,
            page=eng.page, kv_pages=eng.kv_pages)
        if load["mode"] != ("quantized" if quantized else "full"):
            raise AssertionError(f"{model}: load mode {load['mode']}")
        burst = run_burst(port, model, eng)
        log("main_requests", model=model, **burst)
        steps = burst["forward_steps"]
        got = burst["launches"]
        if not burst["mixed_forwards"] or not burst["decode_forwards"]:
            raise AssertionError(f"{model}: mixed {burst['mixed_forwards']} / "
                                 f"decode {burst['decode_forwards']} "
                                 "forwards: both kinds must run")
        # attention: exactly one launch per layer of every forward
        if steps == 0 or got["ragged_paged_attention"] != layers * steps:
            raise AssertionError(
                f"{model}: ragged_paged_attention launched "
                f"{got['ragged_paged_attention']} times on the main path "
                f"for {steps} forwards of {layers} layers")
        # 7 projections per layer in every decode forward, and those of
        # mixed steps of eligible size
        need = 7 * layers * burst["decode_forwards"]
        if quantized and got["int8_matmul"] < need:
            raise AssertionError(
                f"{model}: int8_matmul launched {got['int8_matmul']} times "
                f"on the main path; it needs at least {need}")
        eng.leak_check()
        reload = None
        if quantized:  # the second load reads the on-disk int8 tree
            del eng
            res = backend.load_model(srv.app.load_options(
                srv.app.configs[model]))
            if not res.success or backend.load_mode != "artifact":
                raise AssertionError(f"{model}: reload {res.message!r} in "
                                     f"mode {backend.load_mode}")
            reload = {"mode": backend.load_mode,
                      "load_s": round(backend.load_s, 3),
                      "param_bytes": param_bytes(backend.engine.params)}
            if reload["param_bytes"] != load["param_bytes"]:
                raise AssertionError(f"{model}: reloaded tree differs")
            log("main_reload", model=model, **reload)
        ref = reference_check(backend, layers)
        log("main_reference", model=model, **ref)
        prof = profile_decode(backend.engine)
        log("main_profile", model=model, **prof)
        backend.engine.leak_check()
        return {"load": load, "burst": burst, "reload": reload,
                "reference": ref, "profile": prof}
    finally:
        srv.close()
        th.join(timeout=30)


def phase_main(layers_wanted: int, seed: int) -> dict:
    """Serve the 8B-geometry model on the card through the port's HTTP
    server: bf16, then the same checkpoint with int8 weights."""
    import gc
    import shutil

    import torch

    models = ROOT / "build" / "chip_smoke" / "models"
    quant_cache = ROOT / "build" / "chip_smoke" / "quant"
    layers = choose_depth(layers_wanted, models)
    ckpt_name = f"llama31-8b-geometry-L{layers}-s{seed}"
    written, write_s = write_checkpoint(models / ckpt_name, layers, seed)
    for name, extra in (("llama-3.1-8b", {}),
                        ("llama-3.1-8b-int8", {"quantization": "int8"})):
        (models / f"{name}.yaml").write_text(json.dumps({
            "name": name, "backend": "torch-llm",
            "parameters": {"model": ckpt_name, "temperature": 0.0,
                           "max_tokens": 32},
            "context_size": CONTEXT, "max_batch_slots": SLOTS,
            "dtype": "bfloat16", **extra,
            "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                         "chat": "{{.Input}}\nassistant:"},
        }, indent=1))
    log("main_checkpoint", layers=layers, layers_wanted=layers_wanted,
        written=written, write_s=round(write_s, 3), dir=ckpt_name)
    bf16 = serve_model(models, "llama-3.1-8b", layers, quantized=False)
    gc.collect()
    torch.cuda.empty_cache()
    # a cold int8 load: quantize on the card, then write the artifact
    shutil.rmtree(quant_cache, ignore_errors=True)
    os.environ["LOCALAI_QUANT_CACHE_DIR"] = str(quant_cache)
    os.environ["LOCALAI_QUANT_ARTIFACTS"] = "on"
    int8 = serve_model(models, "llama-3.1-8b-int8", layers, quantized=True)
    log("main_models", layers=layers,
        param_gb={"bf16": bf16["load"]["param_bytes"] / 1e9,
                  "int8": int8["load"]["param_bytes"] / 1e9},
        load_s={"bf16": bf16["load"]["load_s"],
                "int8_cold": int8["load"]["load_s"],
                "int8_warm": int8["reload"]["load_s"]})
    return {"layers": layers, "bf16": bf16, "int8": int8}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="device,build,kernels,main")
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth of the main-path model (8B: 32)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    require_package()
    dev, smi = phase_device()
    build = occupancy = None
    if "build" in phases:
        build, occupancy = phase_build()
    entries = []
    if "kernels" in phases:  # correctness first, then times at 8B shapes
        worst, timings = phase_kernels(n_slots=SLOTS,
                                       max_pages=CONTEXT // PAGE)
        t = timings["decode"]
        entries.append({
            "name": "ragged_paged_attention", "route": "cuda",
            "source": "localai_tfp_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "localai_tfp_tpu/ops/ragged_paged_attention.py:68",
            "launches": None,
            "max_abs_err": max(worst.values()),
            "max_abs_err_bf16": worst["bf16"],
            "max_abs_err_int8": worst["int8"], "tol": TOL,
            "ms": t["ms"], "eager_ms": t["eager_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": "decode",
            "timing": "cold: layers cycled past the L2; ms by CUDA-graph "
                      "replay, eager_ms call by call",
            **{f"{mix}_step": {k: timings[mix][k] for k in (
                "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
               for mix in ("mixed", "chunk512")},
        })
        if build is not None:
            rows = build["ragged_paged_attention"]
            entries[-1].update(
                registers={r["entry"]: r["registers"] for r in rows},
                spill_bytes=sum(r["spill_bytes"] for r in rows),
                blocks_per_sm={f"{o['q']}/{o['kv']}/dh{o['dh']}/bm{o['bm']}":
                               o["blocks_per_sm"] for o in occupancy})
        worst8, t8 = phase_int8_kernels()
        t = t8["w_gate_m8"]
        entries.append({
            "name": "int8_matmul", "route": "cuda",
            "source": "localai_tfp_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "localai_tfp_tpu/ops/int8_matmul.py:32",
            "launches": None,
            "max_abs_err": worst8["abs_f32out"],
            "max_abs_err_bf16out": worst8["abs_bf16out"],
            "max_rel_err_f32out": worst8["rel_f32out"],
            "max_ulps_bf16out": worst8["ulp_bf16out"],
            "max_rel_err_beyond_1ulp_bf16out": worst8["excess_bf16out"],
            "tol": f"f32 out {INT8_REL_TOL} x max|want|; bf16 out 1 ulp "
                   f"+ {INT8_REL_TOL} x max|want|",
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "bf16_matmul_ms", "eager_ms")},
            "shape": "w_gate_m8",
            **{case: {k: t8[case][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "bf16_matmul_ms", "eager_ms")}
               for case in ("w_gate_m1024", "wk_m8", "wk_m1024")},
        })
    if "main" in phases:
        res = phase_main(args.layers, args.seed)
        # each kernel's count on its own path, read just after that path
        # ran: attention on the bf16 model, the int8 product on the int8
        # model (which also runs attention)
        own = {"ragged_paged_attention": res["bf16"]["burst"]["launches"],
               "int8_matmul": res["int8"]["burst"]["launches"]}
        for e in entries:
            e["launches"] = own[e["name"]][e["name"]]
            e["launches_int8_model"] = \
                res["int8"]["burst"]["launches"][e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
