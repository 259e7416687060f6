"""The port's audio-in path (Whisper transcription and the silero-class
VAD) against the JAX package's, on the same inputs on the CPU.

Checkpoints are tiny and made offline: a Whisper from transformers'
``save_pretrained`` (vocab 1000, d_model 64, 2 + 2 layers, as
tests/test_media_workers.py makes it), once with a byte-level BPE
``tokenizer.json`` in Whisper's special-token layout and once without a
tokenizer; the silero-schema state dict of tests/test_vad_net.py. Audio
and mels come from seeded numpy generators. Held to the JAX package:

- ``log_mel_spectrogram``: bitwise;
- ``encode_audio`` at the full 3000 frames (the stride-2 ``"SAME"``
  conv pads 0 frames on the left and 1 on the right: pinned on the
  windows themselves) and ``decode_logits``: within 1e-5;
- greedy ids: the JAX ``greedy_transcribe`` against the port's plain
  decoder and its served ``WhisperRunner``: equal;
- ``load_pcm``: 8-, 16-, 24- and 32-bit, stereo and resampled WAVs,
  bitwise;
- the VAD network's probabilities within 1e-5 (the chunk loop and the
  served runner), its segments equal, and the DSP detector's segments
  equal;
- both HTTP servers: one multipart request in each ``response_format``
  (same text, segments and tokens), ``/v1/vad`` (same segments), a
  non-WAV upload without ``ffmpeg`` on ``PATH`` and a missing VAD model
  (same status and body shape).
"""

import http.client
import json
import os
import uuid
import wave

import numpy as np
import pytest
import torch

from tests.test_torch_retrieval import Pair

TOL = 1e-5  # f32 against f32, different summation orders
SPECIALS = {994: "<|translate|>", 995: "<|transcribe|>", 996: "<|en|>",
            997: "<|startoftranscript|>", 998: "<|endoftext|>",
            999: "<|notimestamps|>"}
VAD_SPEC = dict(bins=33, win=64, hidden=16, enc=((33, 24), (24, 16)))


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_whisper_tokenizer(d) -> None:
    """A byte-level BPE ``tokenizer.json`` of 994 regular ids (the 256
    bytes and 738 merges) and the tiny checkpoint's special ids above
    them, with a ``tokenizer_config.json`` naming ``<|endoftext|>`` the
    unknown token."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers

    alphabet = sorted(pre_tokenizers.ByteLevel.alphabet())
    vocab = {c: i for i, c in enumerate(alphabet)}
    merges = []
    letters = "abcdefghijklmnopqrstuvwxyz"
    pairs = [(a, b) for a in letters for b in letters]
    pairs += [("Ġ", a) for a in letters]
    pairs += [("Ġ", a + b) for a, b in pairs[:36]]
    for a, b in pairs:
        merges.append((a, b))
        vocab[a + b] = len(vocab)
    assert len(vocab) == min(SPECIALS)
    tk = Tokenizer(models.BPE(vocab, merges))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    tk.add_special_tokens([SPECIALS[i] for i in sorted(SPECIALS)])
    tk.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "unk_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
        "clean_up_tokenization_spaces": True}))


def vad_state_dict(seed: int = 0) -> dict:
    """Random weights in silero's key schema (tests/test_vad_net.py's),
    the head scaled up and its bias centring the logits of
    ``bursts(9.0, seed)`` at 0, so the probabilities span (0, 1)."""
    from localai_tfp_tpu_torch.models import vad_net as tv

    g = torch.Generator().manual_seed(seed)
    B, W, H = VAD_SPEC["bins"], VAD_SPEC["win"], VAD_SPEC["hidden"]

    def t(*shape, scale=0.3):
        return torch.randn(*shape, generator=g) * scale

    sd = {"_model.stft.forward_basis_buffer": t(2 * B, 1, W)}
    for i, (cin, cout) in enumerate(VAD_SPEC["enc"]):
        sd[f"_model.encoder.{i}.reparam_conv.weight"] = t(cout, cin, 3)
        sd[f"_model.encoder.{i}.reparam_conv.bias"] = t(cout)
    sd["_model.decoder.rnn.weight_ih"] = t(4 * H, H)
    sd["_model.decoder.rnn.weight_hh"] = t(4 * H, H)
    sd["_model.decoder.rnn.bias_ih"] = t(4 * H)
    sd["_model.decoder.rnn.bias_hh"] = t(4 * H)
    sd["_model.decoder.decoder.2.weight"] = t(1, H, 1, scale=12.0)
    sd["_model.decoder.decoder.2.bias"] = torch.zeros(1)
    p = tv.speech_probs(tv.load_state_dict(sd), bursts(9.0, seed))
    logits = np.log(p / (1 - p))
    sd["_model.decoder.decoder.2.bias"] -= float(np.median(logits))
    return sd


def bursts(seconds: float, seed: int) -> np.ndarray:
    """16 kHz audio: low noise with voiced bursts (harmonics of a pitch)
    of 0.3–1.2 s."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    x = (rng.standard_normal(n) * 0.003).astype(np.float32)
    t = 0.2
    while t < seconds - 0.4:
        dur = float(rng.uniform(0.3, 1.2))
        a, b = int(t * 16000), min(n, int((t + dur) * 16000))
        tt = np.arange(b - a) / 16000
        f0 = float(rng.uniform(100, 220))
        x[a:b] += sum(0.3 / k * np.sin(2 * np.pi * k * f0 * tt)
                      for k in range(1, 6)).astype(np.float32)
        t += dur + float(rng.uniform(0.3, 0.9))
    return x


def write_wav(path, pcm: np.ndarray, sr: int = 16000, width: int = 2,
              channels: int = 1) -> None:
    """float PCM [n] (or [n, channels]) -> a WAV of ``width`` bytes a
    sample (8-bit unsigned, else signed little-endian)."""
    x = np.clip(pcm, -1, 1)
    if width == 1:
        raw = np.round(x * 127 + 128).astype(np.uint8).tobytes()
    elif width == 3:
        v = np.round(x.astype(np.float64) * (2 ** 23 - 1)).astype(
            np.int32).reshape(-1)
        raw = np.stack([(v >> s) & 0xFF for s in (0, 8, 16)], -1).astype(
            np.uint8).tobytes()
    else:
        dt = {2: "<i2", 4: "<i4"}[width]
        raw = np.round(x.astype(np.float64) * (2 ** (8 * width - 1) - 1)
                       ).astype(dt).tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """whisper-bare (no tokenizer), whisper (its tokenizer.json), vad.pt
    and vad.safetensors, and the YAMLs both servers read."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    from localai_tfp_tpu_torch.models.safetensors_io import save_file

    root = tmp_path_factory.mktemp("audio_models")
    torch.manual_seed(0)
    cfg = WhisperConfig(
        vocab_size=1000, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=1500, max_target_positions=64,
        num_mel_bins=80, decoder_start_token_id=997, eos_token_id=998,
        pad_token_id=998, bos_token_id=998,
    )
    m = WhisperForConditionalGeneration(cfg)
    with torch.no_grad():  # non-trivial norms and biases
        g = torch.Generator().manual_seed(1)
        for name, p in m.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    for sub in ("whisper-bare", "whisper"):
        m.save_pretrained(root / sub, safe_serialization=True)
    write_whisper_tokenizer(root / "whisper")
    sd = vad_state_dict(4)
    torch.save(sd, root / "vad.pt")
    save_file(sd, str(root / "vad.safetensors"))
    yamls = {
        "stt": "backend: whisper\nparameters:\n  model: whisper\n",
        "stt-bare": "backend: faster-whisper\nparameters:\n"
                    "  model: whisper-bare\n",
        "vad": "backend: silero-vad\nparameters:\n  model: vad.pt\n",
        "vad-st": "backend: vad\nparameters:\n  model: vad.safetensors\n",
        "vad-dsp": "backend: silero-vad\n",
        "vad-missing": "backend: silero-vad\nparameters:\n"
                       "  model: nowhere.jit\n",
    }
    for name, y in yamls.items():
        (root / f"{name}.yaml").write_text(f"name: {name}\n{y}")
    return root


# ------------------------------------------------------------ model


@pytest.fixture(scope="module")
def whisper_pair(models):
    """The same checkpoint through both loaders: (JAX spec, params; the
    port's spec, params on the CPU)."""
    from localai_tfp_tpu.models import whisper as jw
    from localai_tfp_tpu_torch.models import whisper as tw

    js, jp = jw.load_whisper_params(str(models / "whisper"))
    ts, tp = tw.load_whisper_params(str(models / "whisper"))
    return js, jp, ts, tp


def _mel(seed: int, seconds: float = 30.0) -> np.ndarray:
    from localai_tfp_tpu_torch.models import whisper as tw

    return tw.log_mel_spectrogram(bursts(seconds, seed))


@pytest.mark.parametrize("seconds", [0.5, 12.0, 30.0, 45.0])
def test_log_mel_is_bitwise_the_jax_front_end(seconds):
    from localai_tfp_tpu.models import whisper as jw
    from localai_tfp_tpu_torch.models import whisper as tw

    audio = bursts(seconds, 7)
    got = tw.log_mel_spectrogram(audio)
    assert got.shape == (80, 3000)
    assert np.array_equal(got, jw.log_mel_spectrogram(audio))


def test_whisper_trees_and_specs_match(whisper_pair):
    """The port's loader and ``params_from_numpy`` (the JAX tree
    carried across) both give the JAX loader's tree, bitwise."""
    import jax

    from localai_tfp_tpu_torch.models.convert import params_from_numpy

    js, jp, ts, tp = whisper_pair
    assert vars(ts) == vars(js)
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        for tree in (tp, carried):
            node = tree
            for k in path:
                node = node[k.key]
            assert np.array_equal(node.numpy(), np.asarray(leaf)), path


def test_stride_two_conv_pads_zero_left_one_right():
    """At 3000 frames the first window of ``conv2`` is frames 0-2 and the
    last frames 2998, 2999 and one zero pad (XLA's ``"SAME"``), not a
    pad frame first (``Conv1d(padding=1)``)."""
    from localai_tfp_tpu_torch.models.whisper import _same

    x = torch.arange(1, 3001, dtype=torch.float32)[None, :, None]
    win = _same(x, 3, 2)
    assert win.shape == (1, 1500, 3)
    assert win[0, 0].tolist() == [1.0, 2.0, 3.0]
    assert win[0, -1].tolist() == [2999.0, 3000.0, 0.0]
    first = _same(x, 3, 1)  # conv1: one pad frame each side
    assert first[0, 0].tolist() == [0.0, 1.0, 2.0]
    assert first[0, -1].tolist() == [2999.0, 3000.0, 0.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_and_decode_logits_match_jax(whisper_pair, seed):
    import jax.numpy as jnp

    from localai_tfp_tpu.models import whisper as jw
    from localai_tfp_tpu_torch.models import whisper as tw

    js, jp, ts, tp = whisper_pair
    mel = _mel(seed)[None]
    want = np.asarray(jw.encode_audio(js, jp, jnp.asarray(mel)))
    got = tw.encode_audio(ts, tp, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, 1500, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    rng = np.random.default_rng(seed)
    # ids past the vocabulary clamp into it in both packages
    toks = np.concatenate([[997, 50259, 50359, 50363],
                           rng.integers(0, 1000, 12)]).astype(np.int32)[None]
    lw = np.asarray(jw.decode_logits(js, jp, jnp.asarray(toks),
                                     jnp.asarray(want)))
    lg = tw.decode_logits(ts, tp, torch.from_numpy(toks).long(),
                          torch.from_numpy(want)).numpy()
    assert lg.shape == lw.shape == (1, 16, 1000)
    np.testing.assert_allclose(lg, lw, rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_greedy_ids_match_jax_greedy_transcribe(whisper_pair, seed):
    """The JAX ``greedy_transcribe`` against the port's plain decoder and
    its served runner, at the worker's prompt and ``max_new`` (59 at the
    checkpoint's 64 target positions): ids equal, eot-padded alike."""
    import jax.numpy as jnp

    from localai_tfp_tpu.models import whisper as jw
    from localai_tfp_tpu_torch.models import whisper as tw

    js, jp, ts, tp = whisper_pair
    prompt = [ts.sot, ts.lang_base, ts.task_transcribe, ts.no_timestamps]
    mel = _mel(seed)
    want = np.asarray(jw.greedy_transcribe(
        js, jp, jnp.asarray(mel)[None], 59, jnp.asarray(prompt, jnp.int32)))
    plain = tw.greedy_transcribe(ts, tp, torch.from_numpy(mel)[None], 59,
                                 torch.tensor(prompt)).numpy()
    served = tw.WhisperRunner(ts, tp, "cpu").transcribe(mel, 59, prompt)
    assert want.shape == (59,)
    assert plain.tolist() == want.tolist()
    assert served.tolist() == want.tolist()


def test_runner_pads_with_eot_after_eot(whisper_pair):
    """With eot set to an id the greedy decode picks at step 10, the
    runner stops reading at the block holding it and pads with eot, as
    the plain decoder does."""
    import dataclasses

    from localai_tfp_tpu_torch.models import whisper as tw

    _, _, ts, tp = whisper_pair
    mel = _mel(5)
    prompt = [ts.sot, ts.lang_base, ts.task_transcribe, ts.no_timestamps]
    free = tw.greedy_transcribe(ts, tp, torch.from_numpy(mel)[None], 59,
                                torch.tensor(prompt)).numpy()
    spec = dataclasses.replace(ts, eot=int(free[10]))
    want = tw.greedy_transcribe(spec, tp, torch.from_numpy(mel)[None], 59,
                                torch.tensor(prompt)).numpy()
    got = tw.WhisperRunner(spec, tp, "cpu").transcribe(mel, 59, prompt)
    first = want.tolist().index(spec.eot)
    assert first <= 10 and (want[first:] == spec.eot).all()
    assert got.tolist() == want.tolist()


# ------------------------------------------------------------ load_pcm


@pytest.mark.parametrize("width,sr,channels", [
    (1, 16000, 1), (2, 16000, 1), (3, 16000, 1), (4, 16000, 1),
    (2, 16000, 2), (2, 8000, 1), (3, 44100, 2)])
def test_load_pcm_matches_jax(tmp_path, width, sr, channels):
    from localai_tfp_tpu.workers.whisper import load_pcm as jax_load_pcm
    from localai_tfp_tpu_torch.workers.whisper import load_pcm

    rng = np.random.default_rng(width * 10 + channels)
    pcm = (rng.standard_normal((int(0.7 * sr), channels)) * 0.3).astype(
        np.float32)
    path = tmp_path / "a.wav"
    write_wav(path, pcm.reshape(-1), sr, width, channels)
    got, want = load_pcm(str(path)), jax_load_pcm(str(path))
    assert got.dtype == want.dtype == np.float32
    assert abs(len(got) - 0.7 * 16000) <= 2
    assert np.array_equal(got, want)


# ------------------------------------------------------------ VAD


@pytest.mark.parametrize("seed", [3, 4])
def test_vad_network_matches_jax(seed):
    from localai_tfp_tpu.models import vad_net as jv
    from localai_tfp_tpu_torch.models import vad_net as tv

    sd = vad_state_dict(seed)
    audio = bursts(9.0, seed)
    want = jv.speech_probs(jv.load_state_dict(sd), audio)
    params = tv.load_state_dict(sd)
    loop = tv.speech_probs(params, audio)
    served = tv.VADRunner(params, "cpu").probabilities(audio)
    assert want.shape == loop.shape == served.shape == (282,)
    np.testing.assert_allclose(loop, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(served, want, rtol=0, atol=TOL)
    # thresholds midway between neighbouring probabilities, far from a tie
    srt = np.sort(want)
    for q in (0.3, 0.6):
        i = int(q * len(srt))
        thr = float(srt[i] + srt[i + 1]) / 2
        j = int((q - 0.2) * len(srt))
        neg = float(srt[j] + srt[j + 1]) / 2
        segs = jv.probs_to_segments(want, threshold=thr, neg_threshold=neg)
        assert len(segs) >= 2
        assert tv.probs_to_segments(served, threshold=thr,
                                    neg_threshold=neg) == segs


@pytest.fixture(scope="module")
def vad_workers(models):
    from localai_tfp_tpu.workers.base import ModelLoadOptions as JaxOpts
    from localai_tfp_tpu.workers.vad import JaxVADBackend
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.vad import TorchVADBackend

    out = {}
    for model in ("vad.pt", "vad.safetensors", ""):
        opts = dict(model=model, model_path=str(models),
                    options=["threshold=0.5"] if model else [])
        j, t = JaxVADBackend(), TorchVADBackend("cpu")
        assert j.load_model(JaxOpts(**opts)).success
        assert t.load_model(ModelLoadOptions(**opts)).success
        out[model or "dsp"] = j, t
    return out


@pytest.mark.parametrize("kind", ["vad.pt", "vad.safetensors", "dsp"])
@pytest.mark.parametrize("seed", [2, 4])
def test_vad_workers_give_the_jax_segments(vad_workers, kind, seed):
    j, t = vad_workers[kind]
    audio = bursts(11.0, seed).tolist()
    want = [(s.start, s.end) for s in j.vad(audio).segments]
    got = [(s.start, s.end) for s in t.vad(audio).segments]
    assert got == want
    assert len(got) >= 3
    assert t.vad(audio[:100]).segments == []


def test_missing_vad_model_fails_its_load(models):
    from localai_tfp_tpu.workers.base import ModelLoadOptions as JaxOpts
    from localai_tfp_tpu.workers.vad import JaxVADBackend
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.vad import TorchVADBackend

    for model in ("nowhere.jit", "vad.onnx"):
        if model == "vad.onnx":
            (models / model).write_bytes(b"\0")
        opts = dict(model=model, model_path=str(models))
        j = JaxVADBackend().load_model(JaxOpts(**opts))
        t = TorchVADBackend("cpu").load_model(ModelLoadOptions(**opts))
        assert not j.success and not t.success
        assert t.message == j.message


def test_audio_workers_default_to_the_card(monkeypatch):
    from localai_tfp_tpu_torch.workers.vad import TorchVADBackend
    from localai_tfp_tpu_torch.workers.whisper import TorchWhisperBackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TorchWhisperBackend, TorchVADBackend):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
        assert cls("cpu").device == torch.device("cpu")


# ------------------------------------------------------------ servers


class AudioPair(Pair):
    """``Pair`` with raw bodies (multipart uploads)."""

    def raw(self, path: str, data: bytes, ctype: str):
        async def go():
            r = await self.tc.request("POST", path, data=data,
                                      headers={"Content-Type": ctype})
            return r.status, r.headers.get("Content-Type", ""), await r.read()

        j = self.loop.run_until_complete(go())
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=300)
        c.request("POST", path, body=data, headers={"Content-Type": ctype})
        r = c.getresponse()
        t = r.status, r.getheader("Content-Type", ""), r.read()
        c.close()
        return j, t


def multipart(fields: dict, filename: str, data: bytes) -> tuple:
    """(body, content type) of a form with ``fields`` and one ``file``."""
    b = uuid.uuid4().hex
    out = b""
    for k, v in fields.items():
        out += (f"--{b}\r\nContent-Disposition: form-data; name=\"{k}\""
                f"\r\n\r\n{v}\r\n").encode()
    out += (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: "
            "application/octet-stream\r\n\r\n").encode()
    out += data + f"\r\n--{b}--\r\n".encode()
    return out, f"multipart/form-data; boundary={b}"


@pytest.fixture(scope="module")
def pair(tmp_path_factory, models):
    p = AudioPair(tmp_path_factory.mktemp("audio_srv"), models)
    yield p
    p.close()


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """A 2 s 16 kHz mono 16-bit WAV and a 33 s 8 kHz stereo 24-bit one
    (two chunks, resampled)."""
    d = tmp_path_factory.mktemp("wavs")
    write_wav(d / "short.wav", bursts(2.0, 11))
    a = bursts(33.0, 12)[::2]
    write_wav(d / "long.wav", np.stack([a, a * 0.5], -1).reshape(-1), 8000,
              3, 2)
    return {k: (d / f"{k}.wav").read_bytes() for k in ("short", "long")}


@pytest.mark.parametrize("fmt", ["json", "verbose_json", "text"])
@pytest.mark.parametrize("case", ["short-tok", "long-bare"])
def test_transcription_route_matches_jax_server(pair, wavs, fmt, case):
    wav, model = {"short-tok": ("short", "stt"),
                  "long-bare": ("long", "stt-bare")}[case]
    fields = {"model": model, "response_format": fmt}
    if case == "short-tok":
        fields.update(language="en", translate="true")
    body, ctype = multipart(fields, f"{wav}.wav", wavs[wav])
    (js, jct, jb), (ts, tct, tb) = pair.raw("/v1/audio/transcriptions",
                                            body, ctype)
    assert js == ts == 200, (jb[:300], tb[:300])
    if fmt == "text":
        assert jct.startswith("text/plain") and tct.startswith("text/plain")
        assert tb.decode() == jb.decode()
        return
    want, got = json.loads(jb), json.loads(tb)
    assert got == want
    if fmt == "verbose_json":
        n = {"short": 1, "long": 2}[wav]
        assert len(got["segments"]) == n
        assert got["segments"][-1]["end"] == got["duration"]
        assert all(s["tokens"] for s in got["segments"])
        if case == "long-bare":  # no tokenizer: the space-joined ids
            s = got["segments"][0]
            assert s["text"] == " ".join(str(i) for i in s["tokens"]
                                         if i != 997)
    assert not os.listdir(pair.app.config.upload_dir)


def test_prompt_language_lookup_matches_jax(pair, models):
    """``<|en|>`` is the tokenizer's id; an unknown language and no
    tokenizer fall back to the spec's ``lang_base``."""
    from localai_tfp_tpu.workers.base import ModelLoadOptions as JaxOpts
    from localai_tfp_tpu.workers.whisper import JaxWhisperBackend
    from localai_tfp_tpu_torch.workers.base import ModelLoadOptions
    from localai_tfp_tpu_torch.workers.whisper import TorchWhisperBackend

    for sub in ("whisper", "whisper-bare"):
        j, t = JaxWhisperBackend(), TorchWhisperBackend("cpu")
        assert j.load_model(JaxOpts(model=str(models / sub))).success
        assert t.load_model(ModelLoadOptions(model=str(models / sub))).success
        for lang, tr in (("en", False), ("xx", True), ("", False),
                         ("endoftext", False)):
            assert t._prompt(lang, tr) == j._prompt(lang, tr)
        ids = [5, 997, 998, 300, 50364, 42]
        assert t._decode_text(ids) == j._decode_text(ids)
    assert t._prompt("en", False)[1] == t.spec.lang_base


def test_vad_route_matches_jax_server(pair):
    audio = bursts(6.0, 9).tolist()
    for model in ("vad", "vad-st", "vad-dsp"):
        (js, jb), (ts, tb) = pair.both("/v1/vad", {"model": model,
                                                   "audio": audio})
        assert js == ts == 200, (jb[:300], tb[:300])
        assert json.loads(tb) == json.loads(jb)
        assert len(json.loads(tb)["segments"]) >= 2
    (js, jb), (ts, tb) = pair.both("/vad", {"model": "vad", "audio": []})
    assert js == ts == 200 and json.loads(tb) == json.loads(jb)


def test_missing_vad_model_is_the_jax_error(pair):
    (js, jb), (ts, tb) = pair.both("/v1/vad", {"model": "vad-missing",
                                               "audio": [0.0] * 600})
    assert js == ts == 500
    want, got = json.loads(jb)["error"], json.loads(tb)["error"]
    assert got.keys() == want.keys() == {"code", "message", "type"}
    assert got == want
    assert "vad model not found" in got["message"]


def test_non_wav_upload_without_ffmpeg_is_the_jax_error(pair, monkeypatch,
                                                       tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    body, ctype = multipart({"model": "stt"}, "speech.mp3", b"ID3\0\0\0")
    (js, _, jb), (ts, _, tb) = pair.raw("/v1/audio/transcriptions", body,
                                        ctype)
    assert js == ts == 500
    want, got = json.loads(jb)["error"], json.loads(tb)["error"]
    assert got == want and "ffmpeg" in got["message"]
    assert not os.listdir(pair.app.config.upload_dir)


def test_transcription_without_a_file_or_model(pair, wavs):
    body, ctype = multipart({"model": "nowhere"}, "a.wav", wavs["short"])
    (js, _, _), (ts, _, tb) = pair.raw("/v1/audio/transcriptions", body,
                                       ctype)
    assert js == ts == 404
    assert json.loads(tb)["error"]["message"] == "model 'nowhere' not found"
    b = uuid.uuid4().hex
    body = (f"--{b}\r\nContent-Disposition: form-data; name=\"model\"\r\n"
            f"\r\nstt\r\n--{b}--\r\n").encode()
    (js, _, _), (ts, _, _) = pair.raw(
        "/v1/audio/transcriptions", body,
        f"multipart/form-data; boundary={b}")
    assert js == ts == 400
