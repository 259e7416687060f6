"""The port's TTS worker and speech routes against the JAX package's.

- Worker (``workers/tts.py``): the formant voice and the sound-generation
  noise bands give the JAX worker's WAV bytes exactly; every family loads
  with the JAX worker's message and fails a broken load with the JAX
  worker's "<family> load failed" prefix (never the formant voice); a
  reload leaves no earlier family reachable; ``TorchTTSBackend()``
  raises without a card; ``backend: piper|tts|kokoro|coqui`` resolve to
  it.
- HTTP: the JAX server (aiohttp) and the port's on one models directory
  of YAMLs (the formant voice, a tiny VITS with a ``tts.voice``):
  ``/v1/audio/speech``, ``/audio/speech``, ``/tts``,
  ``/v1/text-to-speech/{voice_id}``, ``/v1/sound-generation`` give equal
  status, ``Content-Type``, WAV header and samples (bytes); a non-string
  ``input``/``text`` is the same 400, no TTS model the same 404; the
  generated-content mounts serve the same bytes. Kokoro, piper and
  OuteTTS YAMLs through the port's routes serve the WAV of the port's
  worker (held to the JAX models in tests/test_torch_tts.py).
- bark, XTTS and MusicGen (tiny checkpoints from tests/test_torch_bark.py,
  test_torch_xtts.py and test_torch_musicgen.py): each loads with the JAX
  worker's message; ``/tts`` and ``/v1/audio/speech`` with bark at
  ``temperature=0`` and with XTTS, ``/v1/text-to-speech/{voice_id}`` with
  an XTTS voice, an unknown voice and a directory without a speakers
  file, ``/v1/sound-generation`` with MusicGen (greedy and seeded
  sampled) answer as the JAX server does (samples within one unit plus
  1e-4 of max|JAX|, errors with the same message); an unload brings back
  the noise bands and a reload leaves no earlier family reachable, byte
  for byte as the JAX worker.
"""

import asyncio
import http.client
import io
import json
import os
import threading
import wave

import numpy as np
import pytest
import torch

from tests.test_torch_tts import (CODES, REL, VOCAB, _tiny_encodec,
                                  _vits_config, write_piper_voice)

TEXTS = ["Hello there, world!", "quick zebras vex", "", "x"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _wav(path_or_bytes):
    f = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) \
        else open(path_or_bytes, "rb")
    with wave.open(f) as w:
        head = (w.getnchannels(), w.getsampwidth(), w.getframerate())
        return head, np.frombuffer(w.readframes(w.getnframes()), "<i2")


# ---------------------------------------------------------------- worker


@pytest.mark.parametrize("voice", ["", "alloy", "echo", "fable", "onyx",
                                   "nova", "shimmer", "Nova", "unknown"])
@pytest.mark.parametrize("text", TEXTS)
def test_formant_voice_bytes_equal_jax(tmp_path, voice, text):
    from localai_tfp_tpu.workers.base import ModelLoadOptions as JOpts
    from localai_tfp_tpu.workers.tts import JaxTTSBackend
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.tts import TorchTTSBackend

    j, t = JaxTTSBackend(), TorchTTSBackend("cpu")
    assert j.load_model(JOpts()).message == t.load_model(
        ModelLoadOptions()).message
    a, b = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    assert j.tts(text, voice=voice, dst=a).success
    assert t.tts(text, voice=voice, dst=b).success
    assert open(a, "rb").read() == open(b, "rb").read()
    assert t.family() == "formant"


@pytest.mark.parametrize("kw", [{}, {"duration": 1.25},
                                 {"duration": None, "temperature": 0.2}])
@pytest.mark.parametrize("text", ["rain on a tin roof", ""])
def test_sound_generation_bytes_equal_jax(tmp_path, kw, text):
    from localai_tfp_tpu.workers.tts import JaxTTSBackend
    from localai_tfp_tpu_torch.workers.tts import TorchTTSBackend

    a, b = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    assert JaxTTSBackend().sound_generation(text, dst=a, **kw).success
    assert TorchTTSBackend("cpu").sound_generation(text, dst=b,
                                                   **kw).success
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """One directory per family and a piper voice, all tiny."""
    from tokenizers import Tokenizer, decoders, models as tkm
    from tokenizers import pre_tokenizers
    from tokenizers.trainers import BpeTrainer
    from transformers import (PreTrainedTokenizerFast, Qwen2Config,
                              Qwen2ForCausalLM, VitsModel, VitsTokenizer)

    from tests.test_kokoro import CFG, build_torch_model
    from localai_tfp_tpu.models.kokoro import spec_from_config

    root = tmp_path_factory.mktemp("tts_models")
    torch.manual_seed(0)
    VitsModel(_vits_config(
        resblock_dilation_sizes=[[1, 3], [1, 3]], wavenet_dilation_rate=1,
    )).save_pretrained(root / "mms", safe_serialization=True)
    vf = root / "mms" / "vocab.json"
    vf.write_text(json.dumps({c: i for i, c in enumerate(VOCAB)}))
    VitsTokenizer(str(vf), pad_token=VOCAB[0], add_blank=True,
                  normalize=True, phonemize=False).save_pretrained(
        root / "mms")
    write_piper_voice(str(root / "mms"), str(root / "piper"))

    spec = spec_from_config(CFG)
    net = {n: m.state_dict() for n, m in build_torch_model(spec).items()}
    (root / "kokoro").mkdir()
    torch.save({"net": net}, root / "kokoro" / "kokoro-tiny.pth")
    (root / "kokoro" / "config.json").write_text(json.dumps(CFG))
    (root / "kokoro" / "voices").mkdir()
    g = torch.Generator().manual_seed(7)
    for v in ("af", "bf"):
        torch.save(torch.randn(32, 1, 2 * spec.style_dim, generator=g) * 0.1,
                   root / "kokoro" / "voices" / f"{v}.pt")

    d = root / "oute"
    tk = Tokenizer(tkm.BPE())
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    tk.train_from_iterator(["hello world speak"] * 4, BpeTrainer(
        vocab_size=280, special_tokens=["<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tk.add_special_tokens(["<|im_start|>", "<|text_end|>",
                           "<|audio_start|>"])
    tk.add_tokens([f"<|c_{c}|>" for c in range(CODES)])
    PreTrainedTokenizerFast(tokenizer_object=tk, bos_token="<s>",
                            eos_token="</s>").save_pretrained(d)
    lm = Qwen2ForCausalLM(Qwen2Config(
        vocab_size=tk.get_vocab_size(), hidden_size=112,
        intermediate_size=128, num_hidden_layers=1, num_attention_heads=14,
        num_key_value_heads=2, max_position_embeddings=128,
        tie_word_embeddings=True))
    with torch.no_grad():
        codes = [tk.token_to_id(f"<|c_{c}|>") for c in range(CODES)]
        lm.model.embed_tokens.weight[codes] *= 8
    lm.save_pretrained(d, safe_serialization=True)
    _tiny_encodec(d / "codec", n_codes=CODES)
    return root


def _both_load(path, **kw):
    from localai_tfp_tpu.workers.base import ModelLoadOptions as JOpts
    from localai_tfp_tpu.workers.tts import JaxTTSBackend
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.tts import TorchTTSBackend

    jkw = dict(kw)
    if "type" in jkw:
        jkw = {"extra": {"type": jkw.pop("type")}, **jkw}
    j, t = JaxTTSBackend(), TorchTTSBackend("cpu")
    return (j, j.load_model(JOpts(model=path, **jkw))), \
        (t, t.load_model(ModelLoadOptions(model=path, **kw)))


@pytest.mark.parametrize("rel,kw,family", [
    ("mms", {}, "vits"), ("piper/voice.onnx", {}, "piper"),
    ("kokoro", {}, "kokoro"), ("oute", {"type": "OuteTTS"}, "outetts")])
def test_each_family_loads_as_jax(models, rel, kw, family):
    (j, jr), (t, tr) = _both_load(str(models / rel), **kw)
    try:
        assert (tr.success, tr.message) == (jr.success, jr.message)
        assert t.family() == family and t.health()
    finally:
        t.shutdown()
        j.shutdown()


@pytest.mark.parametrize("rel,kw,prefix", [
    ("piper/missing.onnx", {}, "piper load failed: "),
    ("bad_oute", {"type": "OuteTTS"}, "outetts load failed: "),
    ("bad_kokoro", {}, "kokoro load failed: "),
    ("bad_vits", {}, "vits load failed: "),
    ("bad_xtts", {}, "xtts load failed: "),
    ("bad_bark", {}, "bark load failed: "),
    ("bad_musicgen", {}, "musicgen load failed: ")])
def test_a_broken_load_fails_as_jax(models, tmp_path, rel, kw, prefix):
    """A named model that cannot load is an error with the JAX worker's
    family prefix, and the worker does not answer with the formant
    voice."""
    (tmp_path / "bad_oute").mkdir()
    (tmp_path / "bad_oute" / "config.json").write_text("{}")
    (tmp_path / "bad_kokoro").mkdir()
    (tmp_path / "bad_kokoro" / "config.json").write_text(
        json.dumps({"istftnet": {}, "style_dim": 8}))
    (tmp_path / "bad_vits").mkdir()
    (tmp_path / "bad_vits" / "config.json").write_text(
        json.dumps({"model_type": "vits"}))
    for name, cfg in (("bad_xtts", {"model": "xtts"}),
                      ("bad_bark", {"model_type": "bark"}),
                      ("bad_musicgen", {"model_type": "musicgen"})):
        (tmp_path / name).mkdir()
        (tmp_path / name / "config.json").write_text(json.dumps(cfg))
    base = models if rel.startswith("piper") else tmp_path
    (j, jr), (t, tr) = _both_load(str(base / rel), **kw)
    assert not jr.success and not tr.success
    assert jr.message.startswith(prefix) and tr.message.startswith(prefix)
    assert not t.health() and t.family() == "formant"


def test_a_reload_leaves_no_earlier_family(models, tmp_path):
    """Load kokoro, then VITS, then nothing: each answers as the family
    last loaded (the last as the formant voice, byte for byte)."""
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.tts import (TorchTTSBackend,
                                                   _g2p, _render,
                                                   write_wav)

    t = TorchTTSBackend("cpu")
    for rel, family in (("kokoro", "kokoro"), ("mms", "vits"),
                        ("piper/voice.onnx", "piper"), ("", "formant")):
        path = str(models / rel) if rel else ""
        assert t.load_model(ModelLoadOptions(model=path)).success
        assert t.family() == family
    dst, ref = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    t.tts("hello", dst=dst)
    write_wav(ref, _render(_g2p("hello"), 120.0, 1.0))
    assert open(dst, "rb").read() == open(ref, "rb").read()


def test_backend_names_and_device_rule(monkeypatch):
    from localai_tfp_tpu_torch.engine import loader as tl
    from localai_tfp_tpu_torch.workers.tts import TorchTTSBackend

    for name in ("piper", "tts", "kokoro", "coqui", "bark", "jax-tts"):
        assert tl.resolve_backend(name) == tl.TTS_BACKEND == "jax-tts"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchTTSBackend()
    saved = dict(tl.registry._factories)
    try:
        tl.register_default_backends("cpu")
        assert isinstance(tl.registry.create("jax-tts"), TorchTTSBackend)
    finally:
        tl.registry._factories.clear()
        tl.registry._factories.update(saved)


# ------------------------------------------------------------------ HTTP


class Servers:
    """The JAX server (aiohttp test server) and the port's (stdlib, on a
    thread) over one models directory, each with its own
    ``generated_content_dir``; ``both`` returns each one's (status,
    Content-Type, body)."""

    def __init__(self, tmp, models) -> None:
        from aiohttp.test_utils import TestClient, TestServer

        from localai_tfp_tpu.config.app_config import \
            ApplicationConfig as JaxConfig
        from localai_tfp_tpu.server.app import build_app
        from localai_tfp_tpu.server.state import Application as JaxApp
        from localai_tfp_tpu_torch.config.app_config import \
            ApplicationConfig
        from localai_tfp_tpu_torch.server.app import Server
        from localai_tfp_tpu_torch.server.state import Application

        common = dict(models_path=str(models), config_dir=str(tmp / "conf"),
                      state_dir=str(tmp / "run"), upload_dir=str(tmp / "up"))
        self.jgen, self.tgen = tmp / "jgen", tmp / "tgen"
        self.loop = asyncio.new_event_loop()
        self.tc = TestClient(TestServer(build_app(JaxApp(JaxConfig(
            generated_content_dir=str(self.jgen), **common)))),
            loop=self.loop)
        self.loop.run_until_complete(self.tc.start_server())
        self.app = Application(ApplicationConfig(
            address="127.0.0.1", port=0,
            generated_content_dir=str(self.tgen), **common), device="cpu")
        self.srv = Server(self.app)
        self.th = threading.Thread(target=self.srv.serve_forever,
                                   daemon=True)
        self.th.start()
        self.port = self.srv.server_address[1]

    def jax(self, method, path, body=None):
        async def go():
            r = await self.tc.request(
                method, path,
                data=None if body is None else json.dumps(body))
            return r.status, r.headers.get("Content-Type", ""), \
                await r.read()
        return self.loop.run_until_complete(go())

    def torch(self, method, path, body=None):
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        c.request(method, path, body=None if body is None
                  else json.dumps(body).encode())
        r = c.getresponse()
        out = r.status, r.getheader("Content-Type", ""), r.read()
        c.close()
        return out

    def both(self, path, body, method="POST"):
        return self.jax(method, path, body), self.torch(method, path, body)

    def close(self) -> None:
        self.srv.close()
        self.th.join(timeout=30)
        self.loop.run_until_complete(self.tc.close())
        self.loop.close()


@pytest.fixture(scope="module")
def servers(tmp_path_factory, models):
    """Both servers over ``models`` with two YAMLs: the formant voice and
    the tiny VITS with ``tts.voice: onyx``."""
    for name, doc in (("voice", {"backend": "tts"}),
                      ("vits", {"backend": "tts",
                                "parameters": {"model": "mms"},
                                "tts": {"voice": "onyx"}})):
        (models / f"{name}.yaml").write_text(json.dumps({"name": name,
                                                         **doc}))
    s = Servers(tmp_path_factory.mktemp("tts_srv"), models)
    yield s
    s.close()


def _message(ctype, body):
    """An error's message: the port's JSON body, or the JAX server's
    plain-text "<status>: <reason>" (aiohttp's own rendering of an
    HTTPException a speech route raises)."""
    if ctype.startswith("application/json"):
        return json.loads(body)["error"]["message"]
    return body.decode().split(": ", 1)[1]


def _same(res, exact=True):
    """Equal status; for a 200, ``audio/x-wav`` and the same WAV header,
    then the same bytes (``exact``: the host-numpy formant and noise-band
    voices) or samples within one unit of the int16 cast plus 1e-4 of
    max|JAX| (a model's f32 waveform, tests/test_torch_tts.py's
    tolerance); for an error the same message."""
    (js, jt, jb), (ts, tt, tb) = res
    assert ts == js, (jb[:300], tb[:300])
    if js == 200:
        assert tt == jt == "audio/x-wav"
        (th, tpcm), (jh, jpcm) = _wav(tb), _wav(jb)
        assert th == jh and tpcm.shape == jpcm.shape
        if exact:
            assert tb == jb
        else:
            bound = 1 + REL * float(np.abs(jpcm).max())
            assert np.abs(tpcm.astype(int) - jpcm).max() <= bound
    else:
        assert _message(tt, tb) == _message(jt, jb)
    return js


@pytest.mark.parametrize("path,body", [
    ("/v1/audio/speech", {"model": "voice", "input": "hello", "voice":
                          "nova"}),
    ("/audio/speech", {"model": "voice", "input": "sea shells"}),
    ("/v1/audio/speech", {"model": "vits", "input": "hello world"}),
    ("/v1/audio/speech", {"model": "vits", "input": "hello world",
                          "voice": "fable"}),
    ("/tts", {"model": "voice", "input": "a b c", "voice": "echo"}),
    ("/tts", {"model": "vits", "input": "hello world"}),
    ("/tts", {"model": "vits", "text": "only text"}),
    ("/v1/text-to-speech/shimmer", {"model_id": "voice", "text": "hi"}),
    ("/v1/text-to-speech/nova", {"model_id": "vits",
                                 "text": "hello world"}),
    ("/v1/text-to-speech/No%20Such", {"model_id": "voice", "text": "hi"}),
    ("/v1/sound-generation", {"model_id": "voice", "text": "wind"}),
    ("/v1/sound-generation", {"model_id": "vits", "text": "rain",
                              "duration_seconds": 0.5}),
    ("/v1/sound-generation", {"model_id": "voice", "text": "rain",
                              "duration": 0.75, "temperature": 0}),
])
def test_speech_routes_match_jax_server(servers, path, body):
    exact = "vits" not in (body.get("model"), body.get("model_id")) \
        or "sound-generation" in path
    assert _same(servers.both(path, body), exact) == 200


@pytest.mark.parametrize("path,body", [
    ("/tts", {"model": "voice", "input": 5}),
    ("/tts", {"model": "voice", "text": ["a"]}),
    ("/tts", {"model": "voice", "input": "x", "voice": 3}),
    ("/v1/text-to-speech/nova", {"model_id": "voice", "text": {"a": 1}}),
    ("/v1/sound-generation", {"text": 7}),
    ("/v1/sound-generation", {"text": "x", "duration_seconds": "long"}),
    ("/v1/sound-generation", {"text": "x", "do_sample": "yes"}),
    ("/v1/audio/speech", {"model": "nope", "input": "x"}),
])
def test_speech_route_errors_match_jax_server(servers, path, body):
    assert _same(servers.both(path, body)) in (400, 404)


def test_no_tts_model_is_the_same_404(tmp_path):
    """With no TTS config at all every speech route is the JAX server's
    404."""
    (tmp_path / "m").mkdir()
    s = Servers(tmp_path, tmp_path / "m")
    try:
        for path, body in (("/tts", {"input": "x"}),
                           ("/v1/text-to-speech/nova", {"text": "x"}),
                           ("/v1/audio/speech", {"input": "x"}),
                           ("/v1/sound-generation", {"text": "x"})):
            assert _same(s.both(path, body)) == 404
    finally:
        s.close()


def test_generated_content_mounts(servers):
    """The three mounts serve one directory's files as the JAX server's
    static routes do; a missing file is a 404 in both."""
    for d in (servers.jgen, servers.tgen):
        d.mkdir(exist_ok=True)
        (d / "clip.wav").write_bytes(b"RIFF0000WAVE")
    for mount in ("/generated-audio", "/generated-images",
                  "/generated-videos"):
        (js, jt, jb), (ts, tt, tb) = servers.both(f"{mount}/clip.wav",
                                                  None, "GET")
        assert (ts, tt, tb) == (js, jt, jb) == (200, "audio/x-wav",
                                                b"RIFF0000WAVE")
        assert servers.jax("GET", f"{mount}/none.wav")[0] == \
            servers.torch("GET", f"{mount}/none.wav")[0] == 404
    assert servers.torch("GET", "/generated-audio/..%2F..%2Fetc%2Fpasswd"
                         )[0] == 404


@pytest.mark.parametrize("doc,path,body,voice", [
    ({"backend": "kokoro", "parameters": {"model": "kokoro"},
      "tts": {"voice": "bf"}}, "/tts", {"input": "hello"}, "bf"),
    ({"backend": "kokoro", "parameters": {"model": "kokoro"}},
     "/v1/text-to-speech/af%2Bbf", {"text": "hello"}, "af+bf"),
    ({"backend": "piper", "parameters": {"model": "piper/voice.onnx"}},
     "/v1/audio/speech", {"input": "hello world"}, ""),
    ({"backend": "tts", "type": "OuteTTS", "parameters": {"model": "oute"}},
     "/v1/audio/speech", {"input": "hello world"}, ""),
])
def test_port_routes_serve_the_worker_wav(models, tmp_path, doc, path, body,
                                          voice):
    """Kokoro (the config's voice, a blended path voice), piper and
    OuteTTS behind the port's routes: 200, ``audio/x-wav``, and the bytes
    the port's worker writes for the same text and voice."""
    from localai_tfp_tpu_torch.config.app_config import ApplicationConfig
    from localai_tfp_tpu_torch.server.app import Server
    from localai_tfp_tpu_torch.server.state import Application
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.tts import TorchTTSBackend

    (models / "m.yaml").write_text(json.dumps({"name": "m", **doc}))
    try:
        srv = Server(Application(ApplicationConfig(
            models_path=str(models), address="127.0.0.1", port=0,
            config_dir=str(tmp_path / "c"), state_dir=str(tmp_path / "r"),
            generated_content_dir=str(tmp_path / "g")), device="cpu"))
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        c = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                       timeout=120)
        key = "model_id" if "text-to-speech" in path else "model"
        c.request("POST", path, body=json.dumps({key: "m", **body}))
        r = c.getresponse()
        status, ctype, got = r.status, r.getheader("Content-Type"), r.read()
        c.close()
        srv.close()
        th.join(timeout=30)
    finally:
        os.unlink(models / "m.yaml")
    assert (status, ctype) == (200, "audio/x-wav"), got[:300]
    t = TorchTTSBackend("cpu")
    assert t.load_model(ModelLoadOptions(
        model=doc["parameters"]["model"], model_path=str(models),
        type=doc.get("type", ""))).success
    ref = str(tmp_path / "ref.wav")
    assert t.tts(body.get("input", body.get("text")), voice=voice,
                 dst=ref).success
    t.shutdown()
    assert got == open(ref, "rb").read()


# ------------------------------------------ bark, XTTS and MusicGen


BARK0 = ["temperature=0", "max_semantic=6"]


@pytest.fixture(scope="module")
def ar_models(tmp_path_factory):
    """Tiny bark, XTTS (with a vocab.json and two voices; another without
    a speakers file) and MusicGen (musicgen-small's layout) directories
    and their YAMLs."""
    from tests.test_torch_bark import write_bark_dir
    from tests.test_torch_musicgen import write_musicgen_dir
    from tests.test_torch_xtts import write_vocab, write_xtts_dir

    root = tmp_path_factory.mktemp("tts_ar")
    write_bark_dir(root / "bark")
    write_xtts_dir(root / "xtts")
    write_vocab(root / "xtts")
    write_xtts_dir(root / "xtts_nospk", seed=1, speakers=False)
    write_musicgen_dir(root / "mg", True)
    for name, doc in (
            ("voice", {"backend": "tts"}),
            ("bark0", {"backend": "bark", "parameters": {"model": "bark"},
                       "options": BARK0}),
            ("xtts", {"backend": "coqui", "parameters": {"model": "xtts"}}),
            ("xtts_nospk", {"backend": "coqui",
                            "parameters": {"model": "xtts_nospk"}}),
            ("mg", {"backend": "tts", "parameters": {"model": "mg"}})):
        (root / f"{name}.yaml").write_text(json.dumps({"name": name, **doc}))
    return root


@pytest.mark.parametrize("rel,kw,family", [
    ("bark", {"options": BARK0}, "bark"), ("bark", {}, "bark"),
    ("xtts", {}, "xtts"), ("xtts_nospk", {}, "xtts"),
    ("mg", {}, "musicgen")])
def test_ar_families_load_as_jax(ar_models, rel, kw, family):
    (j, jr), (t, tr) = _both_load(str(ar_models / rel), **kw)
    try:
        assert (tr.success, tr.message) == (jr.success, jr.message)
        assert t.family() == family and t.health()
        if family == "bark":
            assert t._bark_opts == j._bark_opts
    finally:
        t.shutdown()
        j.shutdown()


@pytest.fixture(scope="module")
def ar_servers(tmp_path_factory, ar_models):
    s = Servers(tmp_path_factory.mktemp("tts_ar_srv"), ar_models)
    yield s
    s.close()


@pytest.mark.parametrize("path,body", [
    ("/tts", {"model": "bark0", "input": "hello world"}),
    ("/v1/audio/speech", {"model": "bark0", "input": "hi"}),
    ("/tts", {"model": "xtts", "input": "hello world", "language": "de"}),
    ("/v1/audio/speech", {"model": "xtts", "input": "the quick fox"}),
    ("/v1/text-to-speech/alice", {"model_id": "xtts", "text": "hello"}),
    ("/v1/text-to-speech/bob", {"model_id": "xtts", "text": "speak"}),
    ("/v1/text-to-speech/nope", {"model_id": "xtts", "text": "hi"}),
    ("/v1/text-to-speech/alice", {"model_id": "xtts_nospk", "text": "hi"}),
    ("/v1/sound-generation", {"model_id": "mg", "text": "rain",
                              "duration_seconds": 0.01, "temperature": 0}),
    ("/v1/sound-generation", {"model_id": "mg", "text": "rain",
                              "duration_seconds": 0.01}),
    ("/v1/sound-generation", {"model_id": "mg", "text": "drums",
                              "duration": 0.02, "temperature": 0.8}),
])
def test_ar_routes_match_jax_server(ar_servers, path, body):
    """200s with the JAX server's WAV header and samples (within one unit
    plus 1e-4 of max|JAX|); the unknown voice and the missing speakers
    file as the JAX server's 500 and message."""
    status = _same(ar_servers.both(path, body), exact=False)
    assert status == (500 if "nope" in path or "nospk" in
                      body.get("model_id", "") else 200)


def _sound(b, tmp_path, name, **kw):
    dst = str(tmp_path / name)
    assert b.sound_generation("rain", dst=dst, duration=0.01, **kw).success
    return open(dst, "rb").read()


def test_unload_and_reload_leave_no_musicgen(ar_models, tmp_path):
    """MusicGen's sound, then after an unload the noise bands, byte for
    byte as the JAX worker; MusicGen then bark loaded into one worker:
    the noise bands again (no MusicGen reachable) and bark's speech."""
    (j, jr), (t, tr) = _both_load(str(ar_models / "mg"))
    assert jr.success and tr.success
    jm, tm = (_sound(j, tmp_path, "jm.wav", temperature=0.0,
                     do_sample=False),
              _sound(t, tmp_path, "tm.wav", temperature=0.0,
                     do_sample=False))
    (jh, jpcm), (th, tpcm) = _wav(jm), _wav(tm)
    assert jh == th and jpcm.shape == tpcm.shape
    assert np.abs(tpcm.astype(int) - jpcm).max() <= \
        1 + REL * float(np.abs(jpcm).max())
    j.shutdown()
    t.shutdown()
    noise = _sound(j, tmp_path, "jn.wav")
    assert _sound(t, tmp_path, "tn.wav") == noise != tm
    from localai_tfp_tpu.workers.base import ModelLoadOptions as JOpts
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions

    for path in ("mg", "bark"):
        assert j.load_model(JOpts(model=str(ar_models / path),
                                  options=BARK0)).success
        assert t.load_model(ModelLoadOptions(model=str(ar_models / path),
                                             options=BARK0)).success
    assert t.family() == "bark" and t._musicgen is None
    assert _sound(t, tmp_path, "tb.wav") == _sound(j, tmp_path, "jb.wav") \
        == noise
    a, b = str(tmp_path / "jt.wav"), str(tmp_path / "tt.wav")
    assert j.tts("hello", dst=a).success and t.tts("hello", dst=b).success
    (jh, jpcm), (th, tpcm) = _wav(a), _wav(b)
    assert jh == th and np.abs(tpcm.astype(int) - jpcm).max() <= \
        1 + REL * float(np.abs(jpcm).max())
    t.shutdown()
    j.shutdown()


def _unigram_files(d):
    """A T5-style ``tokenizer.json`` (Unigram, Metaspace, ``$A </s>``)
    made with ``tokenizers``, ids below the tiny T5's vocabulary, and a
    ``tokenizer_config.json`` that transformers' AutoTokenizer reads."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)] + [
        (p, -float(i)) for i, p in enumerate(
            ["▁", "▁rain", "▁on", "▁a", "▁roof", "r", "a", "i", "n", "o",
             "f", "▁t", "in", "e", "s", "d", "u", "m"])]
    tk = Tokenizer(models.Unigram(pieces, unk_id=2))
    tk.pre_tokenizer = pre_tokenizers.Metaspace()
    tk.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    tk.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "</s>",
        "unk_token": "<unk>", "pad_token": "<pad>"}))


@pytest.mark.parametrize("text", ["rain on a tin roof", "drums", ""])
def test_musicgen_tokenizer_ids_equal_jax(ar_models, tmp_path, text):
    """A readable ``tokenizer.json``: the port's ids (post-processor
    included) are the JAX worker's AutoTokenizer ids."""
    import shutil

    d = tmp_path / "mg_tok"
    shutil.copytree(ar_models / "mg", d)
    _unigram_files(d)
    (j, jr), (t, tr) = _both_load(str(d))
    assert jr.success and tr.success
    want = j._musicgen[1](text)["input_ids"]
    assert t._musicgen[1].encode_special(text) == want
    assert want[-1] == 1
    t.shutdown()


def test_musicgen_precompiled_normalizer_fails_the_load(ar_models, tmp_path):
    """T5's published ``tokenizer.json`` carries a ``Precompiled``
    normalizer (a sentencepiece charsmap) the port's reader does not
    know: the load fails naming it, never the byte ids."""
    import shutil

    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.tts import TorchTTSBackend

    d = tmp_path / "mg_pre"
    shutil.copytree(ar_models / "mg", d)
    _unigram_files(d)
    spec = json.loads((d / "tokenizer.json").read_text())
    spec["normalizer"] = {"type": "Precompiled", "precompiled_charsmap": ""}
    (d / "tokenizer.json").write_text(json.dumps(spec))
    t = TorchTTSBackend("cpu")
    res = t.load_model(ModelLoadOptions(model=str(d)))
    assert not res.success and t.family() == "formant"
    assert res.message.startswith("musicgen load failed: ")
    assert "Precompiled" in res.message


@pytest.mark.parametrize("rel", ["bark", "xtts", "mg"])
def test_ar_loaders_need_a_card_unless_asked(ar_models, monkeypatch, rel):
    """Each new loader defaults to the card and raises without one; with
    ``device="cpu"`` it loads."""
    from localai_tfp_tpu_torch.models import bark, musicgen, xtts

    load = {"bark": bark.BarkTTS.load, "xtts": xtts.load_xtts,
            "mg": musicgen.load_musicgen}[rel]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(str(ar_models / rel))
    assert load(str(ar_models / rel), "cpu") is not None
