"""The port's XTTS (``models/xtts.py``) against the JAX package's on the
same inputs.

A tiny checkpoint in the official layout (``{"model": state_dict}`` with
``gpt.gpt.h.*`` HF GPT-2 tensors, ``hifigan_decoder.waveform_decoder.*``
with ``weight_g``/``weight_v`` pairs, ``speakers_xtts.pth``), written by
this file's copy of tests/test_xtts.py's writer, loads through both
loaders (trees bitwise). Tolerances: the GPT's hidden states and the
latents within 1e-4 of max|JAX|; greedy codes equal (with the stop
logit lowered so that all ``max_new`` steps run, as it is, and raised so
that the run ends at once); waveforms within 1e-4 of max|JAX|; the
perceiver latents and the mel within 1e-5 of max|JAX|. A ``vocab.json``
built with ``tokenizers`` (a ``Whitespace`` pre-tokenizer) gives
``tokenizers``' ids.
"""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.nn.utils import weight_norm

import jax
import jax.numpy as jnp

from localai_tfp_tpu.models import xtts as JX
from localai_tfp_tpu_torch.models import xtts as TX

REL = 1e-4  # of max|JAX output|
FINE = 1e-5  # the perceiver latents and the mel

SPEC = dict(
    gpt_layers=2, gpt_dim=32, gpt_heads=4,
    n_text_tokens=40, n_audio_tokens=18,
    start_audio_token=16, stop_audio_token=17,
    start_text_token=1, stop_text_token=0,
    max_audio_tokens=12, max_text_tokens=16,
    cond_latents=4, cond_mels=8, cond_heads=2,
    decoder_input_dim=32, d_vector_dim=6,
    up_rates=(4, 2), up_kernels=(8, 4),
    up_initial=16, resblock_kernels=(3, 5),
    resblock_dilations=((1, 3), (1, 2)),
)


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


# ------------------------------------ the checkpoint writer (a copy) ---


class _Hifigan(nn.Module):
    """coqui HifiganGenerator's tensors: conv_pre, the global and
    per-stage conditioning, the resblock banks."""

    def __init__(self, s):
        super().__init__()
        ch = s["up_initial"]
        self.conv_pre = weight_norm(
            nn.Conv1d(s["decoder_input_dim"], ch, 7, padding=3))
        self.cond_layer = nn.Conv1d(s["d_vector_dim"], ch, 1)
        self.ups = nn.ModuleList()
        self.conds = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (r, k) in enumerate(zip(s["up_rates"], s["up_kernels"])):
            out = ch // (2 ** (i + 1))
            self.ups.append(weight_norm(nn.ConvTranspose1d(
                ch // (2 ** i), out, k, r, padding=(k - r) // 2)))
            self.conds.append(nn.Conv1d(s["d_vector_dim"], out, 1))
            for kk, dils in zip(s["resblock_kernels"],
                                s["resblock_dilations"]):
                c1, c2 = nn.ModuleList(), nn.ModuleList()
                for d in dils:
                    c1.append(weight_norm(nn.Conv1d(
                        out, out, kk, padding=d * (kk // 2), dilation=d)))
                    c2.append(weight_norm(nn.Conv1d(
                        out, out, kk, padding=kk // 2)))
                self.resblocks.append(nn.ModuleList([c1, c2]))
        self.conv_post = weight_norm(nn.Conv1d(out, 1, 7, padding=3))


class _Cond(nn.Module):
    """The conditioning conv stack and the perceiver's tensors."""

    def __init__(self, s):
        super().__init__()
        D = s["gpt_dim"]
        self.convs = nn.ModuleList([
            nn.Conv1d(s["cond_mels"], D, 3, 1, padding=1),
            nn.Conv1d(D, D, 3, 2, padding=1),
        ])
        self.latents = nn.Parameter(torch.randn(s["cond_latents"], D) * 0.1)
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(torch.randn(D, D) * 0.05))


def write_xtts_dir(d, seed=0, speakers=True):
    """The official XTTS layout at ``SPEC``'s widths: model.pth,
    config.json and (``speakers``) speakers_xtts.pth with voices alice
    and bob."""
    from transformers import GPT2Config, GPT2Model

    torch.manual_seed(seed)
    s = SPEC
    D = s["gpt_dim"]
    gpt = GPT2Model(GPT2Config(
        vocab_size=8, n_positions=128, n_embd=D, n_layer=s["gpt_layers"],
        n_head=s["gpt_heads"], activation_function="gelu_new"))
    hifi, cond = _Hifigan(s), _Cond(s)
    sd = {
        "gpt.text_embedding.weight":
            nn.Embedding(s["n_text_tokens"], D).weight,
        "gpt.text_pos_embedding.emb.weight":
            nn.Embedding(s["max_text_tokens"] + 2, D).weight,
        "gpt.mel_embedding.weight":
            nn.Embedding(s["n_audio_tokens"], D).weight,
        "gpt.mel_pos_embedding.emb.weight":
            nn.Embedding(s["max_audio_tokens"] + 2, D).weight,
    }
    head = nn.Linear(D, s["n_audio_tokens"])
    sd["gpt.mel_head.weight"], sd["gpt.mel_head.bias"] = head.weight, \
        head.bias
    for k, v in gpt.state_dict().items():
        if k.startswith(("h.", "ln_f")):
            sd[f"gpt.gpt.{k}"] = v
    for i, c in enumerate(cond.convs):
        sd[f"gpt.conditioning_encoder.convs.{i}.weight"] = c.weight
        sd[f"gpt.conditioning_encoder.convs.{i}.bias"] = c.bias
    for name in ("latents", "wq", "wk", "wv", "wo"):
        sd[f"gpt.conditioning_perceiver.{name}"] = getattr(cond, name)
    for k, v in hifi.state_dict().items():
        if k.startswith("resblocks."):  # banks as convs1/convs2
            parts = k.split(".")
            r = parts.index("resblocks")
            which = "convs1" if parts[r + 2] == "0" else "convs2"
            k = ".".join(parts[:r + 2] + [which] + parts[r + 3:])
        sd[f"hifigan_decoder.waveform_decoder.{k}"] = v
    d.mkdir(parents=True, exist_ok=True)
    torch.save({"model": {k: v.detach().clone() for k, v in sd.items()}},
               d / "model.pth")
    args = {
        "gpt_layers": s["gpt_layers"], "gpt_n_model_channels": D,
        "gpt_n_heads": s["gpt_heads"],
        "gpt_number_text_tokens": s["n_text_tokens"],
        "gpt_num_audio_tokens": s["n_audio_tokens"],
        "gpt_start_audio_token": s["start_audio_token"],
        "gpt_stop_audio_token": s["stop_audio_token"],
        "gpt_start_text_token": s["start_text_token"],
        "gpt_stop_text_token": s["stop_text_token"],
        "gpt_max_audio_tokens": s["max_audio_tokens"],
        "gpt_max_text_tokens": s["max_text_tokens"],
        "gpt_num_audio_channels": s["cond_mels"],
        "decoder_input_dim": s["decoder_input_dim"],
        "d_vector_dim": s["d_vector_dim"],
        "hifigan_up_rates": list(s["up_rates"]),
        "hifigan_up_kernels": list(s["up_kernels"]),
        "hifigan_up_initial": s["up_initial"],
        "hifigan_resblock_kernels": list(s["resblock_kernels"]),
        "hifigan_resblock_dilations": [list(x) for x in
                                       s["resblock_dilations"]],
        "perceiver_heads": s["cond_heads"],
        "perceiver_latents": s["cond_latents"],
    }
    (d / "config.json").write_text(json.dumps({
        "model": "xtts", "model_args": args,
        "audio": {"output_sample_rate": 24000}}))
    if speakers:
        torch.manual_seed(seed + 1)
        torch.save({name: {
            "gpt_cond_latent": torch.randn(1, s["cond_latents"], D) * 0.1,
            "speaker_embedding": torch.randn(1, s["d_vector_dim"], 1) * 0.2,
        } for name in ("alice", "bob")}, d / "speakers_xtts.pth")
    return str(d)


def write_vocab(d, texts=("hello world speak", "the quick brown fox")):
    """An XTTS-layout ``vocab.json`` built with ``tokenizers``: BPE with
    ``[UNK]``, a ``Whitespace`` pre-tokenizer, language tags; ids below
    ``n_text_tokens``."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from tokenizers.trainers import BpeTrainer

    tk = Tokenizer(models.BPE(unk_token="[UNK]"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    tk.train_from_iterator(list(texts) * 4, BpeTrainer(
        vocab_size=34, show_progress=False,
        special_tokens=["[STOP]", "[UNK]", "[SPACE]"]))
    tk.add_special_tokens(["[en]", "[de]"])
    assert tk.get_vocab_size() <= SPEC["n_text_tokens"]
    tk.save(str(d / "vocab.json"))


@pytest.fixture(scope="module")
def xtts_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("xtts") / "xtts"
    write_xtts_dir(d)
    write_vocab(d)
    return str(d)


@pytest.fixture(scope="module")
def both(xtts_dir):
    return JX.load_xtts(xtts_dir), TX.load_xtts(xtts_dir, "cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _bitwise(port, jax_tree):
    pl, jl = list(_leaves(port)), list(_leaves(jax_tree))
    assert len(pl) == len(jl)
    for a, b in zip(pl, jl):
        if b is None or isinstance(b, int):
            assert a == b and type(a) is type(b)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_spec_dir_and_trees_bitwise(both, xtts_dir):
    (js, jp, _, jv), (ts, tp, _, tv) = both
    assert TX.is_xtts_dir(xtts_dir) and JX.is_xtts_dir(xtts_dir)
    assert vars(ts) == vars(js)
    _bitwise(tp, jp)
    _bitwise(TX.from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu"), jp)
    assert sorted(tv) == sorted(jv) == ["alice", "bob"]
    for name in tv:
        for a, b in zip(tv[name], jv[name]):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("T,pos", [(9, 0), (1, 5), (3, 6)])
def test_gpt_forward_matches_jax(both, T, pos):
    """Hidden states after ln_f over a span at ``pos`` of a cache whose
    earlier positions hold the same rows in both."""
    (js, jp, _, _), (ts, tp, _, _) = both
    emb = np.random.default_rng(T + pos).normal(
        size=(1, pos + T, SPEC["gpt_dim"])).astype(np.float32) * 0.3
    S = pos + T + 2
    jc = JX._empty_caches(js, 1, S, jnp.float32)
    tc = TX.new_caches(ts, tp, S)
    with torch.inference_mode():
        if pos:
            _, jc = JX.gpt_forward(js, jp, jnp.asarray(emb[:, :pos]), jc,
                                   jnp.asarray(0))
            TX.gpt_forward(ts, tp, torch.tensor(emb[:, :pos]), tc, 0)
        want, _ = JX.gpt_forward(js, jp, jnp.asarray(emb[:, pos:]), jc,
                                 jnp.asarray(pos))
        got = TX.gpt_forward(ts, tp, torch.tensor(emb[:, pos:]), tc, pos)
    _close(got, want)


def _stop_bias(jp, tp, bias):
    """Both trees with ``bias`` added to the stop token's logit."""
    stop = SPEC["stop_audio_token"]
    jp = {**jp, "mel_head_b": jp["mel_head_b"].at[stop].add(bias)}
    b = tp["mel_head_b"].clone()
    b[stop] += bias
    return jp, {**tp, "mel_head_b": b}


@pytest.mark.parametrize("bias", [-40.0, 0.0, 40.0])
@pytest.mark.parametrize("ids", [[3, 5, 7], list(range(2, 14))])
def test_greedy_codes_and_latents_match_jax(both, ids, bias):
    """Greedy codes equal and latents within 1e-4: the JAX scan runs all
    ``max_new`` steps and trims at the first stop, the port stops
    there."""
    (js, jp, _, jv), (ts, tp, _, tv) = both
    jp, tp = _stop_bias(jp, tp, bias)
    lat = jv["alice"][0]
    want_c, want_l = JX.gpt_generate(js, jp, np.asarray(ids), lat)
    with torch.inference_mode():
        got_c, got_l = TX.gpt_generate(ts, tp, ids, torch.tensor(
            np.asarray(lat)))
    np.testing.assert_array_equal(got_c, want_c)
    if len(want_c):
        _close(got_l, want_l)
    # -40: no stop, all max_new steps; 0: a stop on the way; 40: at once
    assert (len(got_c) == SPEC["max_audio_tokens"]) == (bias < 0)
    assert (len(got_c) == 0) == (bias > 0)


@pytest.mark.parametrize("voice,ids", [("alice", [3, 5, 7]),
                                       ("bob", list(range(2, 14)))])
def test_synthesize_through_a_named_voice_matches_jax(both, voice, ids):
    (js, jp, _, jv), (ts, tp, _, tv) = both
    want = JX.synthesize(js, jp, np.asarray(ids), *jv[voice])
    got = TX.synthesize(ts, tp, ids, *tv[voice])
    assert got.size and got.size % math.prod(SPEC["up_rates"]) == 0
    _close(got, want)


@pytest.mark.parametrize("T", [1, 5, 23])
def test_hifigan_matches_jax(both, T):
    (js, jp, _, _), (ts, tp, _, _) = both
    rng = np.random.default_rng(T)
    lat = rng.normal(size=(T, SPEC["decoder_input_dim"])).astype(
        np.float32) * 0.3
    g = rng.normal(size=(SPEC["d_vector_dim"],)).astype(np.float32) * 0.3
    want = JX.hifigan_decode(js, jp, jnp.asarray(lat), jnp.asarray(g))
    with torch.inference_mode():
        got = TX.hifigan_decode(ts, tp, torch.tensor(lat), g)
    _close(got, want)


@pytest.mark.parametrize("seconds", [0.3, 1.1])
def test_mel_and_perceiver_latents_match_jax(both, seconds):
    (js, jp, _, _), (ts, tp, _, _) = both
    wav = np.random.default_rng(7).normal(
        size=int(22050 * seconds)).astype(np.float32) * 0.1
    want_mel = JX.mel_spectrogram(wav, SPEC["cond_mels"])
    got_mel = TX.mel_spectrogram(wav, SPEC["cond_mels"])
    _close(got_mel, want_mel, FINE)
    want = JX.conditioning_latents(js, jp, jnp.asarray(want_mel))
    with torch.inference_mode():
        got = TX.conditioning_latents(ts, tp, got_mel)
    _close(got, want, FINE)


@pytest.mark.parametrize("text,lang", [
    ("hello world", ""), ("the quick brown fox", "de"),
    ("Hello, world! ½ ⅧⅨ naïve a‿b x²", "en"), ("", "")])
def test_vocab_ids_equal_tokenizers(both, xtts_dir, text, lang):
    """``[{language or "en"}]{text}`` through the port's reader: the ids
    of ``tokenizers.Tokenizer.from_file`` (the JAX loader's reader)."""
    from tokenizers import Tokenizer

    (js, _, jtok, _), (ts, _, ttok, _) = both
    want = Tokenizer.from_file(f"{xtts_dir}/vocab.json").encode(
        f"[{lang or 'en'}]{text}").ids
    assert jtok.encode(f"[{lang or 'en'}]{text}").ids == want
    assert TX.text_ids(ts, ttok, text, lang) == want


def test_byte_fallback_without_a_vocab(tmp_path):
    d = write_xtts_dir(tmp_path / "x", speakers=False)
    spec, _, tok, voices = TX.load_xtts(d, "cpu")
    assert tok is None and voices == {}
    assert TX.text_ids(spec, None, "hé!") == [
        b % (SPEC["n_text_tokens"] - 2) + 1 for b in "hé!".encode()]
