"""Image chats through the port's worker, engine and server against the
JAX package's.

Tiny ``save_pretrained`` checkpoints (a Gemma 3 with its SigLIP tower,
a LLaVA with its CLIP tower; f32, a byte tokenizer) are served by the
JAX worker and the port's worker on the same prompts and PNGs (made
from a seed), and the greedy ids each engine generates are compared
exactly:

- ``[img-N]`` markers for two images, a bogus marker kept as text, and
  no marker (the images go first);
- then the same text with another image on the same engines: the JAX
  ids again, so no image-conditioned prefix leaked into the second
  request (and the port's slots keep no tokens or pages of it);
- a text-only model given image parts drops them, as the JAX server
  does;
- both HTTP servers on a ``data:`` URL; a JPEG is a 400 naming it.

The Gemma 3 checkpoint's window (512) exceeds every prompt here: the
JAX engine's second request on a windowed model is not its dense
forward's (ROADMAP §C 9), and these tests compare second requests.
"""

import asyncio
import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from localai_tfp_tpu.workers.base import ModelLoadOptions as JOpts
from localai_tfp_tpu.workers.base import PredictOptions as JPred
from localai_tfp_tpu.workers.llm import JaxLLMBackend
from localai_tfp_tpu_torch.engine.engine import GenRequest, LLMEngine
from localai_tfp_tpu_torch.models import image_io
from localai_tfp_tpu_torch.workers.base import ModelLoadOptions, PredictOptions
from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend


def gemma3_checkpoint(d):
    from transformers import Gemma3Config, Gemma3ForConditionalGeneration

    torch.manual_seed(0)
    cfg = Gemma3Config(
        text_config=dict(
            vocab_size=300, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, query_pre_attn_scalar=16,
            sliding_window=512, rope_local_base_freq=10000.0,
            rope_theta=1000000.0, max_position_embeddings=512),
        vision_config=dict(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, image_size=56, patch_size=14,
            num_channels=3),
        mm_tokens_per_image=4, boi_token_index=288, eoi_token_index=289,
        image_token_index=290)
    Gemma3ForConditionalGeneration(cfg).save_pretrained(
        d, safe_serialization=True)


def llava_checkpoint(d):
    from transformers import LlavaConfig, LlavaForConditionalGeneration

    torch.manual_seed(0)
    cfg = LlavaConfig(
        text_config=dict(
            model_type="llama", vocab_size=300, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=512),
        vision_config=dict(
            model_type="clip_vision_model", hidden_size=32,
            num_hidden_layers=3, num_attention_heads=2,
            intermediate_size=64, image_size=28, patch_size=14,
            num_channels=3),
        image_token_index=290, vision_feature_layer=-2,
        vision_feature_select_strategy="default")
    LlavaForConditionalGeneration(cfg).save_pretrained(
        d, safe_serialization=True)


def llama_checkpoint(d):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512)).save_pretrained(
        d, safe_serialization=True)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("mm_served")
    models = root / "models"
    models.mkdir()
    for name, make in (("gemma3", gemma3_checkpoint),
                       ("llava", llava_checkpoint),
                       ("llama", llama_checkpoint)):
        make(models / name)
        (models / f"{name}.yaml").write_text(json.dumps({
            "name": name, "backend": "torch-llm",
            "parameters": {"model": name, "temperature": 0.0,
                           "max_tokens": 6},
            "context_size": 256, "max_batch_slots": 2, "dtype": "float32",
            "template": {"chat_message": "{{.RoleName}}: {{.Content}}",
                         "chat": "{{.Input}}\nassistant:"}}))
    return root


def png(seed: int, w: int = 40, h: int = 30) -> bytes:
    rgb = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                               dtype=np.uint8)
    return image_io.encode_png(rgb)


def _spy_ids(eng) -> list:
    """Each finished request's generated ids, in finishing order."""
    got = []
    orig = eng._finish

    def finish(slot, reason):
        got.append(list(slot.generated))
        return orig(slot, reason)

    eng._finish = finish
    return got


@pytest.fixture(scope="module", params=["gemma3", "llava"])
def workers(request, models):
    kw = dict(model=request.param, model_path=str(models / "models"),
              context_size=256, batch_slots=2, dtype="float32")
    j = JaxLLMBackend()
    assert j.load_model(JOpts(**kw)).success
    p = TorchLLMBackend("cpu")
    res = p.load_model(ModelLoadOptions(**kw))
    assert res.success, res.message
    assert p.vision is not None and j.vision is not None
    assert p.vision[2] == j.vision[2]
    yield request.param, j, p, _spy_ids(j.engine), _spy_ids(p.engine)
    j.shutdown()
    p.shutdown()


PROMPTS = [
    ("two markers", "user: look [img-0] then [img-1] now", [1, 2]),
    ("bogus marker", "user: see [img-0] and [img-5] too", [3]),
    ("no marker", "user: what is this?", [4, 5]),
]


@pytest.mark.parametrize("case", [p[0] for p in PROMPTS])
def test_image_chat_ids_match_jax_worker(workers, case):
    kind, j, p, jids, pids = workers
    _, prompt, seeds = next(x for x in PROMPTS if x[0] == case)
    images = [png(s) for s in seeds]
    pre_j, pre_p = len(jids), len(pids)
    want = j.predict(JPred(prompt=prompt, tokens=6, ignore_eos=True,
                           images=images))
    got = p.predict(PredictOptions(prompt=prompt, tokens=6, ignore_eos=True,
                                   images=images))
    assert not want.error and not got.error, (want.error, got.error)
    assert pids[pre_p:] == jids[pre_j:] and len(pids[-1]) == 6
    assert got.message == want.message
    assert got.prompt_tokens == want.prompt_tokens
    eng = p.engine
    # the image request left no prefix behind
    assert all(not s.cache_tokens for s in eng.slots if not s.active)
    if case == "bogus marker":
        # [img-5] stayed as text: one image's tokens in the prompt
        mm = p.vision[2]
        n_img = mm["mm_tokens"] + (2 if mm["boi_token"] else 0)
        text = len(p.tokenizer.encode(prompt.replace("[img-0]", ""),
                                      add_bos=True))
        assert got.prompt_tokens == text + n_img


def test_same_text_with_another_image_gives_the_jax_ids(workers):
    """The same prompt twice, with another image the second time: both
    engines re-prefill the whole prompt (no image-conditioned reuse), so
    the second answer is the JAX engine's second answer."""
    kind, j, p, jids, pids = workers
    prompt = "user: compare [img-0] please"
    out = []
    for seed in (7, 8):
        pre_j, pre_p = len(jids), len(pids)
        reused = p.engine.metrics.prefix_reused_tokens
        want = j.predict(JPred(prompt=prompt, tokens=6, ignore_eos=True,
                               images=[png(seed)]))
        got = p.predict(PredictOptions(prompt=prompt, tokens=6,
                                       ignore_eos=True, images=[png(seed)]))
        assert not want.error and not got.error
        assert pids[pre_p:] == jids[pre_j:]
        assert p.engine.metrics.prefix_reused_tokens == reused
        out.append(pids[-1])
    assert p.engine.metrics.soft_steps >= 2


# ------------------------------------------------------------ engine rules


def _tiny_engine(tmp_path, multimodal=True, **kw):
    from localai_tfp_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tfp_tpu_torch.models.hf_loader import load_params

    llama_checkpoint(tmp_path / "llama")
    spec, params = load_params(str(tmp_path / "llama"), dtype=torch.float32)
    return LLMEngine(spec, params, ByteTokenizer(), n_slots=2, max_seq=128,
                     prefill_buckets=(8, 32), cache_dtype=torch.float32,
                     device="cpu", autostart=False, multimodal=multimodal,
                     **kw), spec


def _soft_request(spec, seed: int, **kw) -> GenRequest:
    rows = np.random.default_rng(seed).normal(
        size=(4, spec.d_model)).astype(np.float32)
    ids = [2, 5, 17, 88, 290, 290, 290, 290, 89, 23, 42]
    return GenRequest(prompt_ids=ids, max_tokens=5, ignore_eos=True,
                      soft_embeds=rows, soft_positions=np.arange(4, 8), **kw)


def _run(eng, req) -> list:
    """Step the engine by hand until ``req`` ends; its generated ids."""
    ids = _spy_ids(eng)
    q = eng.submit(req)
    for _ in range(200):
        eng._admit()
        eng.step()
        while not q.empty():
            ev = q.get()
            if ev.done:
                assert not ev.error, ev.error
                return ids[-1]
    raise AssertionError("the request did not end")


def test_image_requests_share_no_prefix_tier_or_prompt_cache(tmp_path):
    eng, spec = _tiny_engine(tmp_path, kv_tier=True)
    try:
        cache = tmp_path / "pc.npz"
        a = _run(eng, _soft_request(spec, 0, prompt_cache_path=str(cache)))
        # no prompt-cache file, no resident tokens or pages kept
        assert not cache.exists()
        assert all(not s.cache_tokens for s in eng.slots)
        assert all(not eng._pool.table(s.idx) for s in eng.slots)
        # the same ids with other rows: re-prefilled, not reused
        b = _run(eng, _soft_request(spec, 1))
        assert eng.metrics.prefix_reused_tokens == 0
        assert a != b
        # the same ids as text: nothing of the image requests reused
        text = _soft_request(spec, 0)
        _run(eng, GenRequest(prompt_ids=text.prompt_ids, max_tokens=3,
                             ignore_eos=True))
        assert eng.metrics.prefix_reused_tokens == 0
        assert eng.metrics.soft_steps >= 2
        assert not LLMEngine._spec_eligible(
            type("S", (), {"request": _soft_request(spec, 2)})())
    finally:
        eng.close()


def test_soft_rows_are_the_dense_forward_with_the_override(tmp_path):
    """The variant path's greedy ids equal the argmax of one dense
    forward (plain attention) over prompt + ids with the same soft
    override, at every step (f32, exact argmax)."""
    from localai_tfp_tpu_torch.models.transformer import KVCache, forward

    eng, spec = _tiny_engine(tmp_path)
    try:
        req = _soft_request(spec, 3)
        ids = _run(eng, req)
    finally:
        eng.close()
    seq = list(req.prompt_ids) + ids[:-1]
    cache = KVCache.create(spec, 1, len(seq), torch.float32, device="cpu")
    logits, _ = forward(spec, eng.params, torch.tensor([seq]),
                        torch.zeros(1, dtype=torch.int32), cache,
                        soft=(torch.as_tensor(req.soft_embeds),
                              torch.zeros(4, dtype=torch.int32),
                              torch.arange(4, 8, dtype=torch.int32)))
    want = logits[0, len(req.prompt_ids) - 1:].argmax(-1).tolist()
    assert ids == want


def test_refused_soft_requests(tmp_path):
    eng, spec = _tiny_engine(tmp_path)
    try:
        bad = _soft_request(spec, 0)
        bad.soft_positions = np.arange(4, 7)
        ev = eng.submit(bad).get()
        assert ev.done and "differ in length" in ev.error
        wide = _soft_request(spec, 0)
        wide.soft_embeds = np.zeros((4, spec.d_model + 1), np.float32)
        ev = eng.submit(wide).get()
        assert ev.done and "width" in ev.error
    finally:
        eng.close()
    # a text-only engine's variants carry no soft buffers: refused, not
    # served without its rows
    eng, spec = _tiny_engine(tmp_path, multimodal=False)
    try:
        ev = eng.submit(_soft_request(spec, 0)).get()
        assert ev.done and "without multimodal" in ev.error
    finally:
        eng.close()


# ------------------------------------------------------------------ HTTP


def _data_url(data: bytes) -> str:
    return "data:image/png;base64," + base64.b64encode(data).decode()


def _bodies(model: str) -> list:
    img = [{"type": "image_url", "image_url": {"url": _data_url(png(11))}}]
    return [
        {"model": model, "max_tokens": 6, "ignore_eos": True, "messages": [
            {"role": "user", "content": [{"type": "text", "text": "look "}]
             + img + [{"type": "text", "text": " ok"}]}]},
        {"model": model, "max_tokens": 6, "ignore_eos": True, "stream": True,
         "messages": [{"role": "user", "content": img + [
             {"type": "text", "text": "and this?"}]}]},
    ]


def _jax_server(root, bodies: list) -> list:
    from aiohttp.test_utils import TestClient, TestServer

    from localai_tfp_tpu.config.app_config import ApplicationConfig
    from localai_tfp_tpu.server.app import build_app
    from localai_tfp_tpu.server.state import Application

    # the JAX server reads these configs as jax-llm ones
    models = root / "models"
    for y in models.glob("*.yaml"):
        cfg = json.loads(y.read_text())
        cfg["backend"] = "jax-llm"
        (root / "jax_models").mkdir(exist_ok=True)
        (root / "jax_models" / y.name).write_text(json.dumps(cfg))
        link = root / "jax_models" / cfg["parameters"]["model"]
        if not link.exists():
            link.symlink_to(models / cfg["parameters"]["model"])
    loop = asyncio.new_event_loop()
    state = Application(ApplicationConfig(
        models_path=str(root / "jax_models"),
        generated_content_dir=str(root / "generated"),
        upload_dir=str(root / "uploads"),
        config_dir=str(root / "configuration")))
    tc = TestClient(TestServer(build_app(state)), loop=loop)
    loop.run_until_complete(tc.start_server())

    async def go(body):
        r = await tc.request("POST", "/v1/chat/completions", json=body)
        return r.status, await r.read()

    try:
        return [loop.run_until_complete(go(b)) for b in bodies]
    finally:
        loop.run_until_complete(tc.close())
        loop.close()


def _port_server(root, bodies: list) -> list:
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
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    out.append((r.status, r.read()))
            except urllib.error.HTTPError as e:
                out.append((e.code, e.read()))
    finally:
        srv.close()
        th.join(timeout=30)
    return out


def _content(raw: bytes, stream: bool) -> tuple:
    if not stream:
        o = json.loads(raw)
        return (o["choices"][0]["message"]["content"],
                o["usage"]["prompt_tokens"], o["usage"]["completion_tokens"])
    frames = [json.loads(line[6:]) for line in raw.decode().splitlines()
              if line.startswith("data: {")]
    text = "".join(f["choices"][0]["delta"].get("content") or ""
                   for f in frames)
    return text, frames[-1]["choices"][0]["finish_reason"]


def test_servers_answer_image_chats_alike(models):
    bodies = [b for m in ("gemma3", "llava", "llama") for b in _bodies(m)]
    want = _jax_server(models, bodies)
    got = _port_server(models, bodies)
    for body, (js, jraw), (ps, praw) in zip(bodies, want, got):
        assert js == ps == 200, (body["model"], jraw[:200], praw[:200])
        stream = bool(body.get("stream"))
        assert _content(praw, stream) == _content(jraw, stream)


def test_port_server_refuses_a_jpeg_by_name(models):
    buf = io.BytesIO()
    Image.new("RGB", (8, 8), (1, 2, 3)).save(buf, "JPEG")
    body = {"model": "gemma3", "max_tokens": 2, "messages": [
        {"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": _data_url(
                buf.getvalue())}}]}]}
    (status, raw), = _port_server(models, [body])
    assert status == 400 and b"JPEG" in raw
    # a text-only model drops the same part: no 400
    (status, _), = _port_server(models, [{**body, "model": "llama"}])
    assert status == 200


def test_port_server_fetches_an_http_image(models, monkeypatch):
    """An ``http://`` image part is fetched with urllib (from a server on
    127.0.0.1 here): the same answer as the same PNG in a ``data:`` URL;
    past the byte cap it is a 413, and a fetch that fails is a 400."""
    import http.server

    from localai_tfp_tpu_torch.server import openai_routes

    data = png(11)

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path != "/img.png":
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def body(url):
        return {"model": "gemma3", "max_tokens": 4, "ignore_eos": True,
                "messages": [{"role": "user", "content": [
                    {"type": "text", "text": "look "},
                    {"type": "image_url", "image_url": {"url": url}}]}]}

    try:
        (s1, r1), (s2, r2), (s3, r3) = _port_server(models, [
            body(base + "/img.png"), body(_data_url(data)),
            body(base + "/missing.png")])
        assert s1 == s2 == 200
        assert _content(r1, False) == _content(r2, False)
        assert s3 == 400 and b"could not fetch image" in r3
        monkeypatch.setattr(openai_routes, "MEDIA_MAX_BYTES", len(data) - 1)
        (s4, r4), = _port_server(models, [body(base + "/img.png")])
        assert s4 == 413
    finally:
        httpd.shutdown()
        th.join(timeout=10)
