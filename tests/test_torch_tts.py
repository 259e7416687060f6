"""The port's TTS models against the JAX package's on the same inputs.

- VITS (``models/vits.py``): a tiny ``VitsModel`` written with
  transformers ``save_pretrained`` loads through both loaders; the trees
  are bitwise equal (and ``from_jax_params`` of the JAX tree too); at the
  config's own noise scales (numpy draws from the seed in both) the
  duration vector is equal and the waveform within 1e-4 of ``max|JAX|``.
  The character tokenizer's ids equal transformers' ``VitsTokenizer``'s.
- Piper (``models/piper.py``): a voice written from the same weights by
  this file's copy of the piper writer; phoneme ids equal, durations
  equal, waveform within 1e-4 of ``max|JAX|``; the fallback g2p equal.
- Kokoro (``models/kokoro.py``): an official-layout ``.pth`` (the JAX
  tests' torch reference modules); with one injected source-noise sample,
  durations equal and audio within 1e-4 of ``max|JAX|``; the
  bidirectional LSTM, the STFT pair and the phase scan against the JAX
  functions.
- EnCodec (``models/encodec.py``): a tiny ``EncodecModel``; the same codes
  decode within 1e-4 of ``max|JAX|``.
- OuteTTS (``models/outetts.py``): a tiny Qwen2-family LM (14 query heads
  over 2 KV heads, the 0.2-500M attention layout) with a byte-level BPE
  tokenizer whose audio codes are added tokens; greedy code ids equal to
  the JAX engine's, audio within 1e-4 of ``max|JAX|``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from localai_tfp_tpu.models import kokoro as JK
from localai_tfp_tpu.models import vits as JV
from localai_tfp_tpu_torch.models import kokoro as TK
from localai_tfp_tpu_torch.models import vits as TV

REL = 1e-4  # of max|JAX output|, every waveform comparison below


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _bitwise_trees(port, jax_tree):
    pl, jl = list(_leaves(port)), list(_leaves(jax_tree))
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        if b is None or isinstance(b, (str, bool)):
            assert a == b
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------------ VITS

VOCAB = list("_ abcdefghijklmnopqrstuvwxyz'-")  # id 0 is the blank


def _vits_config(**kw):
    from transformers import VitsConfig

    base = dict(
        vocab_size=40, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, ffn_dim=64, flow_size=32,
        spectrogram_bins=33, upsample_initial_channel=64,
        upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
        resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 2], [1]],
        prior_encoder_num_flows=2, posterior_encoder_num_wavenet_layers=2,
        prior_encoder_num_wavenet_layers=2,
        depth_separable_num_layers=2, duration_predictor_flow_bins=4,
        duration_predictor_num_flows=2, wavenet_dilation_rate=2,
        wavenet_kernel_size=3)
    base.update(kw)
    return VitsConfig(**base)


@pytest.fixture(scope="module")
def vits_dir(tmp_path_factory):
    """A tiny MMS-style directory: VitsModel weights, vocab.json and the
    tokenizer config (pad = the blank, as the MMS conversion writes)."""
    from transformers import VitsModel, VitsTokenizer

    d = tmp_path_factory.mktemp("vits") / "mms"
    torch.manual_seed(0)
    VitsModel(_vits_config()).save_pretrained(d, safe_serialization=True)
    vf = d / "vocab.json"
    vf.write_text(json.dumps({c: i for i, c in enumerate(VOCAB)}))
    VitsTokenizer(str(vf), pad_token=VOCAB[0], language="eng",
                  add_blank=True, normalize=True, phonemize=False
                  ).save_pretrained(d)
    return str(d)


TEXTS = ["Hello, World!", "the quick brown fox", "A_B c-d 'e' 42 ÄÖ",
         "", "   spaced   out  ", "_", "<unk> x"]


@pytest.mark.parametrize("text", TEXTS)
def test_vits_tokenizer_ids_equal_transformers(vits_dir, text):
    """ids equal, exactly (transformers' VitsTokenizer through
    AutoTokenizer, as the JAX worker loads it)."""
    from transformers import AutoTokenizer

    ref = AutoTokenizer.from_pretrained(vits_dir)(text)["input_ids"]
    assert TV.load_vits_tokenizer(vits_dir).encode(text) == ref


def test_vits_trees_bitwise(vits_dir):
    """The port's loader and ``from_jax_params`` of the JAX tree give the
    JAX loader's tree, bitwise (weight norm folded in numpy f32 both)."""
    jspec, jp = JV.load_vits(vits_dir)
    spec, p = TV.load_vits(vits_dir, "cpu")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    _bitwise_trees(p, jp)
    _bitwise_trees(TV.from_jax_params(
        {k: _np_tree(v) for k, v in jp.items()}, "cpu"), jp)


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_np_tree(v) for v in t]
    return None if t is None else np.asarray(t)


def jax_vits(spec, p, ids, seed, noise_scale=None,
             noise_scale_duration=None, speaking_rate=None):
    """``localai_tfp_tpu.models.vits.synthesize``'s body, its pieces
    under ``jax.jit`` (the same XLA f32 programs, compiled once per shape
    instead of op by op): (waveform, duration vector)."""
    import jax

    ns = spec.noise_scale if noise_scale is None else noise_scale
    nsd = (spec.noise_scale_duration if noise_scale_duration is None
           else noise_scale_duration)
    rate = spec.speaking_rate if speaking_rate is None else speaking_rate
    rng = np.random.default_rng(seed)
    T = len(ids)

    @jax.jit
    def front(p, ids, dnoise):
        mask = jnp.ones((1, T), jnp.float32)
        hidden, means, log_var = JV.text_encoder(spec, p["text_encoder"],
                                                 ids, mask)
        return JV.duration_reverse(spec, p["duration"], hidden,
                                   mask[:, None, :], dnoise), means, log_var

    @jax.jit
    def back(p, z):
        fmask = jnp.ones((1, 1, z.shape[-1]), jnp.float32)
        return JV.hifigan(spec, p["decoder"],
                          JV.flow_reverse(spec, p["flow"], z, fmask))

    dnoise = jnp.asarray(rng.standard_normal((1, 2, T)).astype(np.float32)
                         * nsd)
    log_dur, means, log_var = front(p, jnp.asarray(ids[None], jnp.int32),
                                    dnoise)
    dur = np.ceil(np.exp(np.asarray(log_dur[0, 0])) * rate ** -1)
    dur = np.maximum(dur, 0).astype(np.int64)
    idx = np.repeat(np.arange(T), dur)
    means_e = np.asarray(means[0])[idx]
    logv_e = np.asarray(log_var[0])[idx]
    z = means_e + rng.standard_normal(means_e.shape).astype(np.float32) \
        * np.exp(logv_e) * ns
    return np.asarray(back(p, jnp.asarray(z.T[None]))[0]), dur


@pytest.mark.parametrize("seed,text,scales", [
    (0, "hello neural world", {}),
    (3, "the quick brown fox jumps", {}),
    (7, "a", {}),
    (1, "speak up", {"noise_scale": 0.0, "noise_scale_duration": 0.0}),
    (2, "slower please", {"speaking_rate": 0.7}),
])
def test_vits_waveform_matches_jax(vits_dir, seed, text, scales):
    """Durations equal (integers), then the waveform within 1e-4 of
    max|JAX| at the config's noise scales, numpy draws from ``seed``."""
    jspec, jp = JV.load_vits(vits_dir)
    spec, p = TV.load_vits(vits_dir, "cpu")
    ids = np.asarray(TV.load_vits_tokenizer(vits_dir).encode(text),
                     np.int32)
    got, dur = TV.synthesize_with_durations(spec, p, ids, seed=seed,
                                            **scales)
    want, want_dur = jax_vits(jspec, jp, ids, seed, **scales)
    np.testing.assert_array_equal(dur, want_dur)
    _close(got, want)
    assert len(got) == max(int(dur.sum()), 1) * spec.upsample_factor


def test_vits_rqs_spline_matches_jax():
    """The spline in both directions, inside and outside the tail bound,
    within 1e-6 (f32 both)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 1, 13)) * 4).astype(np.float32)
    uw, uh = (rng.standard_normal((2, 1, 13, 6)).astype(np.float32)
              for _ in range(2))
    ud = rng.standard_normal((2, 1, 13, 5)).astype(np.float32)
    for reverse in (False, True):
        want = np.asarray(JV._rqs_reverse_or_forward(
            jnp.asarray(x), jnp.asarray(uw), jnp.asarray(uh),
            jnp.asarray(ud), reverse, 5.0, 6))
        got = TV._rqs(*(torch.from_numpy(a) for a in (x, uw, uh, ud)),
                      reverse, 5.0, 6).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- piper

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | 0x80 if n else b)
        if not n:
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def write_piper_voice(model_dir: str, out_dir: str) -> str:
    """An HF VitsModel checkpoint as a piper voice: original-VITS names
    (the port's name shim), weight norm fused, attention projections as
    1x1 convs, float initializers in an ONNX ModelProto's graph; a text
    phoneme map over the model's vocabulary. Returns the .onnx path."""
    from localai_tfp_tpu_torch.models.piper import _piper_name
    from localai_tfp_tpu_torch.models.safetensors_io import load_file

    sd = {k: v.float().numpy()
          for k, v in load_file(os.path.join(model_dir,
                                             "model.safetensors")).items()}
    fused = {}
    for key, arr in sd.items():
        if key.endswith(".parametrizations.weight.original0"):
            base = key[: -len(".parametrizations.weight.original0")]
            v = sd[base + ".parametrizations.weight.original1"]
            norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)),
                                        keepdims=True))
            fused[base + ".weight"] = arr * v / np.maximum(norm, 1e-12)
        elif not key.endswith(".parametrizations.weight.original1"):
            fused.setdefault(key, arr)
    graph = b""
    vocab = 0
    for hf, arr in fused.items():
        pn = _piper_name(hf)
        if pn is None:
            continue
        if hf.endswith(("q_proj.weight", "k_proj.weight", "v_proj.weight",
                        "out_proj.weight")):
            arr = arr[..., None]
        if pn == "enc_p.emb.weight":
            vocab = arr.shape[0]
        t = b"".join(_varint(1 << 3) + _varint(d) for d in arr.shape)
        t += _varint(2 << 3) + _varint(1)  # FLOAT
        t += _ld(8, pn.encode())
        t += _ld(9, np.ascontiguousarray(arr, np.float32).tobytes())
        graph += _ld(5, t)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "voice.onnx")
    with open(path, "wb") as f:
        f.write(_ld(7, graph))
    id_map = {"^": [1], "$": [2], "_": [0]}
    for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz ,.!?"):
        id_map[ch] = [3 + i % max(vocab - 3, 1)]
    with open(path + ".json", "w") as f:
        json.dump({"audio": {"sample_rate": 22050}, "num_speakers": 1,
                   "phoneme_type": "text", "phoneme_id_map": id_map,
                   "inference": {"noise_scale": 0.667, "length_scale": 1.1,
                                 "noise_w": 0.8}}, f)
    return path


@pytest.fixture(scope="module")
def piper_voice(tmp_path_factory):
    """Piper geometry (uniform dilations, WaveNet dilation 1)."""
    from transformers import VitsModel

    d = tmp_path_factory.mktemp("pvits") / "hf"
    torch.manual_seed(1)
    VitsModel(_vits_config(
        resblock_dilation_sizes=[[1, 3], [1, 3]], wavenet_dilation_rate=1,
        sampling_rate=22050)).save_pretrained(d, safe_serialization=True)
    return write_piper_voice(str(d), str(tmp_path_factory.mktemp("pv")))


@pytest.mark.parametrize("seed,text", [(0, "hello world"),
                                       (4, "piper, speak!")])
def test_piper_matches_jax(piper_voice, seed, text):
    """Phoneme ids equal, durations equal, waveform within 1e-4 of
    max|JAX| (the voice's own noise scales and length scale)."""
    from localai_tfp_tpu.models.piper import PiperVoice as JaxVoice
    from localai_tfp_tpu_torch.models.piper import PiperVoice

    jv, tv = JaxVoice.load(piper_voice), PiperVoice.load(piper_voice, "cpu")
    assert dataclasses.asdict(tv.spec) == dataclasses.asdict(jv.spec)
    ids = tv.phoneme_ids(text)
    np.testing.assert_array_equal(ids, jv.phoneme_ids(text))
    got, dur = TV.synthesize_with_durations(tv.spec, tv.params, ids,
                                            seed=seed)
    want, want_dur = jax_vits(jv.spec, jv.params, ids, seed)
    np.testing.assert_array_equal(dur, want_dur)
    _close(got, want)
    np.testing.assert_array_equal(tv.synthesize(text, seed=seed), got)


@pytest.mark.parametrize("text", ["the thing, quickly!", "Ships & shoes"])
def test_piper_fallback_g2p_equal(text):
    from localai_tfp_tpu.models.piper import _g2p_fallback as jg
    from localai_tfp_tpu_torch.models.piper import _g2p_fallback as tg

    assert tg(text) == jg(text)


# ---------------------------------------------------------------- Kokoro


@pytest.fixture(scope="module")
def kokoro_dir(tmp_path_factory):
    """The JAX tests' official-layout checkpoint: .pth with a "net"
    wrapper, a "module."-prefixed decoder, weight_g/weight_v tensors."""
    from tests.test_kokoro import CFG, build_torch_model

    root = tmp_path_factory.mktemp("kokoro")
    spec = JK.spec_from_config(CFG)
    net = {}
    for name, m in build_torch_model(spec).items():
        sd = m.state_dict()
        if name == "decoder":
            sd = {f"module.{k}": v for k, v in sd.items()}
        net[name] = sd
    torch.save({"net": net}, root / "kokoro-tiny.pth")
    (root / "config.json").write_text(json.dumps(CFG))
    (root / "voices").mkdir()
    g = torch.Generator().manual_seed(7)
    for v in ("af", "bf"):
        torch.save(torch.randn(32, 1, 2 * spec.style_dim, generator=g) * 0.1,
                   root / "voices" / f"{v}.pt")
    return str(root)


def test_kokoro_load_matches_jax(kokoro_dir):
    jspec, jp, jvoices = JK.load_kokoro(kokoro_dir)
    spec, p, voices = TK.load_kokoro(kokoro_dir, "cpu")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert sorted(p) == sorted(jp)
    for k in p:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))
    assert sorted(voices) == sorted(jvoices)
    ported = TK.from_jax_params({k: np.asarray(v) for k, v in jp.items()},
                                "cpu")
    for k in p:
        assert torch.equal(ported[k], p[k])


WRAP = TK.PI_FOLD  # radians: an angle this close to -pi is +pi


def _wrapped_to_plus_pi(monkeypatch):
    """The JAX package's STFT phase with every angle within ``WRAP`` of
    -pi moved to +pi, as the port's ``_stft_mag_phase`` reads them. The
    first and last frames are palindromes (reflect padding), so every bin
    there is real: its phase is 0 or +-pi, the sign of pi set by the sign
    of an imaginary part that is zero up to the FFT's rounding (pocketfft
    in JAX, another order in torch). The generator reads the phase as a
    feature, so the end-to-end comparison is made with the angle on the
    port's side of the cut."""
    stft = JK._stft_mag_phase

    def folded(spec, x):
        mag, ph = stft(spec, x)
        return mag, jnp.where(ph < -np.pi + WRAP, ph + 2 * np.pi, ph)

    monkeypatch.setattr(JK, "_stft_mag_phase", folded)


@pytest.mark.parametrize("tokens,voice,speed", [
    ([0, 5, 9, 3, 14, 7, 2, 11, 0], "af", 1.0),
    ([0, 1, 2, 3, 4, 0], "af+bf", 1.3),
])
def test_kokoro_audio_matches_jax(kokoro_dir, monkeypatch, tokens, voice,
                                  speed):
    """Durations equal, then audio within 1e-4 of max|JAX| with one
    injected harmonic-source noise sample (phases at the +-pi cut on one
    side in both: ``_wrapped_to_plus_pi``)."""
    jspec, jp, jvoices = JK.load_kokoro(kokoro_dir)
    spec, p, voices = TK.load_kokoro(kokoro_dir, "cpu")
    ref = JK.pick_voice(jvoices, voice, len(tokens), jspec.style_dim)
    np.testing.assert_array_equal(
        TK.pick_voice(voices, voice, len(tokens), spec.style_dim), ref)
    s_pros = ref[:, jspec.style_dim:]
    jdur, _ = JK.durations(jspec, jp, jnp.asarray(tokens, jnp.int32)[None],
                           jnp.asarray(s_pros), speed)
    with torch.inference_mode():
        tdur, _ = TK.durations(spec, p, torch.tensor(tokens)[None],
                               torch.from_numpy(s_pros), speed)
    np.testing.assert_array_equal(tdur.numpy(), np.asarray(jdur))
    t_up = 2 * int(np.asarray(jdur).sum()) * jspec.total_upsample
    noise = np.random.default_rng(3).standard_normal(
        (1, t_up, jspec.harmonic_num + 1)).astype(np.float32)
    _wrapped_to_plus_pi(monkeypatch)
    want = jax_kokoro(jspec, jp, tokens, ref, speed, noise)
    got = TK.synthesize_kokoro(spec, p, tokens, ref, speed=speed,
                               source_noise=noise)
    _close(got, want)


def jax_kokoro(spec, p, tokens, ref_s, speed, noise):
    """``localai_tfp_tpu.models.kokoro._synthesize_cpu``'s body with its
    pieces under ``jax.jit`` (compiled once instead of op by op)."""
    import jax

    tok = jnp.asarray(np.asarray(tokens, np.int32))[None]
    ref_s = jnp.asarray(np.asarray(ref_s, np.float32)).reshape(1, -1)
    s_pros, s_ref = ref_s[:, spec.style_dim:], ref_s[:, :spec.style_dim]
    pred, d = jax.jit(lambda p, t, s: JK.durations(spec, p, t, s, speed))(
        p, tok, s_pros)
    reps = np.asarray(pred)
    n = int(reps.sum())

    @jax.jit
    def rest(p, d, tok, s_pros, s_ref, noise):
        en = jnp.repeat(jnp.swapaxes(d, 1, 2), reps, axis=-1,
                        total_repeat_length=n)
        f0, nc = JK._prosody_f0n(spec, p, en, s_pros)
        asr = jnp.repeat(JK._text_encoder(spec, p, tok), reps, axis=-1,
                         total_repeat_length=n)
        return JK._decoder(spec, p, asr, f0, nc, s_ref, None, noise)

    return np.asarray(rest(p, d, tok, s_pros, s_ref,
                           jnp.asarray(noise))[0], np.float32)


def test_kokoro_stft_phase_differs_only_at_the_pi_cut():
    """Unpatched, the two packages' STFT of one signal agree within 1e-5
    in magnitude, and in phase except where both angles are pi up to
    ``WRAP``, on opposite sides of the cut (the palindromic edge frames'
    real bins, which the port folds to +pi)."""
    spec = TK.KokoroSpec()
    jspec = JK.KokoroSpec()
    x = np.tanh(np.random.default_rng(4).standard_normal((1, 4000))
                ).astype(np.float32)
    jm, jph = (np.asarray(a) for a in JK._stft_mag_phase(jspec,
                                                          jnp.asarray(x)))
    tm, tph = (a.numpy() for a in TK._stft_mag_phase(spec,
                                                     torch.from_numpy(x)))
    np.testing.assert_allclose(tm, jm, atol=1e-5)
    apart = np.abs(tph - jph) > 1e-4
    assert np.allclose(np.abs(tph[apart]), np.pi, atol=WRAP)
    assert np.allclose(np.abs(tph[apart] - jph[apart]), 2 * np.pi,
                       atol=2 * WRAP)
    assert set(np.nonzero(apart)[2]) <= {0, tph.shape[2] - 1}
    assert (tph > -np.pi + WRAP).all()
    np.testing.assert_allclose(tph[~apart], jph[~apart], atol=1e-4)


def test_kokoro_seeded_source_is_finite(kokoro_dir):
    """Without injected noise the port draws it from a generator seeded
    with ``seed``: the same audio for one seed, another for the next."""
    spec, p, voices = TK.load_kokoro(kokoro_dir, "cpu")
    ref = TK.pick_voice(voices, "af", 5, spec.style_dim)
    a = TK.synthesize_kokoro(spec, p, [0, 3, 4, 5, 0], ref, seed=1)
    b = TK.synthesize_kokoro(spec, p, [0, 3, 4, 5, 0], ref, seed=1)
    c = TK.synthesize_kokoro(spec, p, [0, 3, 4, 5, 0], ref, seed=2)
    assert np.isfinite(a).all() and np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_kokoro_pieces_match_jax():
    """The bidirectional LSTM (gate order i, f, g, o) within 1e-6, the
    STFT pair within 1e-5, and the phase scan bitwise against
    ``jnp.cumsum`` on the same f32 input."""
    rng = np.random.default_rng(9)
    H, D, T = 6, 5, 11
    p = {}
    for suf in ("_l0", "_l0_reverse"):
        p[f"l.weight_ih{suf}"] = rng.standard_normal((4 * H, D))
        p[f"l.weight_hh{suf}"] = rng.standard_normal((4 * H, H))
        p[f"l.bias_ih{suf}"] = rng.standard_normal(4 * H)
        p[f"l.bias_hh{suf}"] = rng.standard_normal(4 * H)
    p = {k: (v * 0.3).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((1, T, D)).astype(np.float32)
    want = np.asarray(JK._bilstm({k: jnp.asarray(v) for k, v in p.items()},
                                 "l", jnp.asarray(x)))
    got = TK._bilstm({k: torch.from_numpy(v) for k, v in p.items()}, "l",
                     torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the same LSTM as torch.nn.LSTM computes it (the checkpoint's module)
    ref = torch.nn.LSTM(D, H, batch_first=True, bidirectional=True)
    with torch.no_grad():
        for name, prm in ref.named_parameters():
            prm.copy_(torch.from_numpy(p[f"l.{name}"]))
        np.testing.assert_allclose(ref(torch.from_numpy(x))[0].numpy(), got,
                                   rtol=1e-6, atol=1e-6)

    spec = TK.KokoroSpec(gen_istft_n_fft=8, gen_istft_hop_size=2)
    jspec = JK.KokoroSpec(gen_istft_n_fft=8, gen_istft_hop_size=2)
    sig = rng.standard_normal((1, 64)).astype(np.float32)
    jm, jph = JK._stft_mag_phase(jspec, jnp.asarray(sig))
    tm, tph = TK._stft_mag_phase(spec, torch.from_numpy(sig))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(np.cos(tph.numpy()), np.cos(np.asarray(jph)),
                               atol=1e-4)
    np.testing.assert_allclose(
        TK._istft(spec, tm, tph).numpy(),
        np.asarray(JK._istft(jspec, jm, jph)), atol=1e-5)

    for n in (1, 2, 7, 64, 301):
        r = rng.random((1, 9, n)).astype(np.float32)
        np.testing.assert_array_equal(
            TK._scan_add(torch.from_numpy(r)).numpy(),
            np.asarray(jnp.cumsum(jnp.asarray(r), -1)))


# --------------------------------------------------------------- EnCodec


def _tiny_encodec(d, n_codes=64, seed=1):
    from transformers import EncodecConfig, EncodecModel

    torch.manual_seed(seed)
    EncodecModel(EncodecConfig(
        # n_q = bandwidth / (frame rate 3000 x 6 bits) = 2 codebooks
        target_bandwidths=[36.0], sampling_rate=24000,
        audio_channels=1, num_filters=8, num_residual_layers=1,
        upsampling_ratios=[4, 2], codebook_size=n_codes,
        codebook_dim=16, hidden_size=16, num_lstm_layers=2,
        kernel_size=3, last_kernel_size=3, residual_kernel_size=3,
    )).save_pretrained(d, safe_serialization=True)


@pytest.mark.parametrize("frames", [1, 2, 37])
def test_encodec_decode_matches_jax(tmp_path, frames):
    """The same codes (one and two codebooks) within 1e-4 of max|JAX|,
    through the port's loader and through ``from_jax_params``; a short
    input exercises HF's zero extension before the reflect pad."""
    from safetensors.numpy import load_file as np_load

    from localai_tfp_tpu.models.bark import (encodec_decode as jdec,
                                             load_encodec_decoder as jload)
    from localai_tfp_tpu_torch.models import encodec as TE

    _tiny_encodec(tmp_path / "codec")
    sd = np_load(str(tmp_path / "codec" / "model.safetensors"))
    jd = jload(sd, prefix="")
    td = TE.load_encodec_decoder(sd, prefix="", device="cpu")
    ported = TE.from_jax_params({"codebooks": np.asarray(jd["codebooks"]),
                                 "layers": [(k, _np_tree(lp), e)
                                            for k, lp, e in jd["layers"]]},
                                "cpu")
    rng = np.random.default_rng(frames)
    for nq in (1, 2):
        codes = rng.integers(0, 64, (nq, frames)).astype(np.int32)
        want = np.asarray(jdec(jd, jnp.asarray(codes), [4, 2]))
        _close(TE.encodec_decode(td, codes, [4, 2]), want)
        _close(TE.encodec_decode(ported, codes, [4, 2]), want)


# --------------------------------------------------------------- OuteTTS

CODES = 64


@pytest.fixture(scope="module")
def oute_dir(tmp_path_factory):
    """A tiny OuteTTS-style directory: a Qwen2 LM (14 query heads over 2
    KV heads), a byte-level BPE whose prompt markers and 64 audio codes
    are added tokens, and an EnCodec-layout codec/."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers.trainers import BpeTrainer
    from transformers import (PreTrainedTokenizerFast, Qwen2Config,
                              Qwen2ForCausalLM)

    d = tmp_path_factory.mktemp("oute") / "model"
    tk = Tokenizer(models.BPE())
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = decoders.ByteLevel()
    tk.train_from_iterator(
        ["hello world speak test", "the sound of a voice"] * 4,
        BpeTrainer(vocab_size=300, special_tokens=["<s>", "</s>"],
                   initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tk.add_special_tokens(["<|im_start|>", "<|text_end|>",
                           "<|audio_start|>", "<|audio_end|>"])
    tk.add_tokens([f"<|c_{c}|>" for c in range(CODES)] + ["<|t_0.50|>"])
    fast = PreTrainedTokenizerFast(tokenizer_object=tk, bos_token="<s>",
                                   eos_token="</s>")
    fast.save_pretrained(d)
    torch.manual_seed(0)
    lm = Qwen2ForCausalLM(Qwen2Config(
        vocab_size=tk.get_vocab_size(), hidden_size=112,
        intermediate_size=128, num_hidden_layers=2, num_attention_heads=14,
        num_key_value_heads=2, max_position_embeddings=512,
        tie_word_embeddings=True))
    with torch.no_grad():  # the tied head's code rows 8x: random weights
        # then emit audio codes (as a trained model does after
        # <|audio_start|>)
        codes = [tk.token_to_id(f"<|c_{c}|>") for c in range(CODES)]
        lm.model.embed_tokens.weight[codes] *= 8
    lm.save_pretrained(d, safe_serialization=True)
    _tiny_encodec(d / "codec", n_codes=CODES)
    with open(d / "speaker.json", "w") as f:
        json.dump({"words": [{"word": "hello", "codes": [3, 9]},
                             {"word": "world", "codes": [27, 14, 5]}]}, f)
    return str(d)


@pytest.fixture(scope="module")
def oute_pair(oute_dir):
    from localai_tfp_tpu.models.outetts import OuteTTSModel as JaxOute
    from localai_tfp_tpu_torch.models.outetts import OuteTTSModel

    j = JaxOute.load(oute_dir)
    t = OuteTTSModel.load(oute_dir, device="cpu")
    yield j, t
    j.close()
    t.close()


def test_outetts_code_table_matches_jax(oute_pair):
    j, t = oute_pair
    assert t.code_ids == j.code_ids and len(t.code_ids) == CODES
    assert (t.ratios, t.sample_rate) == (j.ratios, j.sample_rate)


@pytest.mark.parametrize("text,speaker", [("hello world", False),
                                          ("speak test", True)])
def test_outetts_greedy_matches_jax(oute_pair, oute_dir, text, speaker):
    """Greedy: the prompt ids equal; the port's generated text is the
    JAX engine's whole text for the same request (its done event's
    ``full_text``: the JAX ``synthesize`` keeps one code a decode
    dispatch, ROADMAP §C 16), and the codes it holds decode, through the
    JAX package's ``encodec_decode`` and the port's, within 1e-4 of
    max|JAX|."""
    from localai_tfp_tpu.models.bark import encodec_decode as jdec
    from localai_tfp_tpu.models.outetts import load_speaker as jload
    from localai_tfp_tpu_torch.models.encodec import encodec_decode
    from localai_tfp_tpu_torch.models.outetts import load_speaker

    j, t = oute_pair
    spk = load_speaker(os.path.join(oute_dir, "speaker.json")) \
        if speaker else None
    jspk = jload(os.path.join(oute_dir, "speaker.json")) if speaker else None
    assert spk == jspk
    assert t._prompt(text, spk) == j._prompt(text, jspk)
    assert t.tokenizer.encode(t._prompt(text, spk), add_bos=True) == \
        j.tokenizer.encode(j._prompt(text, jspk), add_bos=True)
    out = t.generate(text, spk, temperature=0.0, max_tokens=24)
    assert out == _jax_full_text(j, text, jspk, 24)
    codes = t.codes(out)
    assert codes.shape == (1, 24)  # every greedy id a code
    want = np.asarray(jdec(j.codec, jnp.asarray(codes), j.ratios))
    _close(encodec_decode(t.codec, codes, t.ratios), want)
    _close(t.synthesize(text, spk, temperature=0.0, max_tokens=24), want)


def _jax_full_text(j, text, speaker, max_tokens):
    """The JAX engine's whole greedy text for the request its
    ``synthesize`` submits."""
    from localai_tfp_tpu.engine.engine import GenRequest

    q = j.engine.submit(GenRequest(
        prompt_ids=j.tokenizer.encode(j._prompt(text, speaker),
                                      add_bos=True),
        max_tokens=max_tokens, temperature=0.0, top_k=64, top_p=1.0,
        seed=0, ignore_eos=False))
    while True:
        ev = q.get()
        if ev.done:
            return ev.full_text


def test_outetts_refuses_a_codecless_dir(tmp_path):
    from localai_tfp_tpu_torch.models.outetts import OuteTTSModel

    with pytest.raises(ValueError, match="codec"):
        OuteTTSModel.load(str(tmp_path), device="cpu")
