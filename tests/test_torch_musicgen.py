"""The port's MusicGen (``models/musicgen.py``) against the JAX package's
on the same inputs.

Two tiny HF ``MusicgenForConditionalGeneration`` checkpoints written with
``save_pretrained``: the JAX tests' (2 codebooks, a causal EnCodec, one
LSTM layer, no projection) and musicgen-small's layout in small (4
codebooks, T5's 32 relative buckets, ``enc_to_dec_proj`` from a narrower
T5, a non-causal EnCodec with reflect padding and two LSTM layers). Both
load through both loaders (trees bitwise). Tolerances: the T5 states and
every decoder logit within 1e-4 of max|JAX|; the relative buckets equal;
greedy codes equal; seeded sampled codes with guidance equal (a draw can
differ only where the uniform falls within the logits' f32 error of a
boundary, which these seeds do not meet); waveforms within 1e-4 of
max|JAX|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from localai_tfp_tpu.models import musicgen as JM
from localai_tfp_tpu_torch.models import musicgen as TM

REL = 1e-4  # of max|JAX output|


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jit_jax():
    """The JAX module's eager pieces under ``jax.jit`` (the same XLA f32
    programs; its decoder step is jitted already)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("t5_encode", "mg_decode_full", "encodec_decode"):
            mp.setattr(JM, name, jax.jit(getattr(JM, name),
                                         static_argnums=0))
        yield


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def write_musicgen_dir(d, small_layout: bool, seed=0, shortcut=True):
    """A tiny MusicGen: the JAX tests' geometry, or (``small_layout``)
    musicgen-small's layout in small."""
    from transformers import (EncodecConfig, MusicgenConfig,
                              MusicgenForConditionalGeneration, T5Config)
    from transformers.models.musicgen.configuration_musicgen import \
        MusicgenDecoderConfig

    torch.manual_seed(seed)
    nb = 4 if small_layout else 2
    t5 = T5Config(vocab_size=99, d_model=24 if small_layout else 32, d_kv=8,
                  d_ff=64, num_layers=2, num_heads=4,
                  relative_attention_num_buckets=32 if small_layout else 8,
                  decoder_start_token_id=0)
    # frame rate 16000 / 8 = 2000 Hz, 6 bits a codebook: 12 kbps each
    enc = EncodecConfig(
        target_bandwidths=[12.0 * nb], sampling_rate=16000,
        audio_channels=1, num_filters=8, hidden_size=16,
        num_residual_layers=1, upsampling_ratios=[4, 2], codebook_size=64,
        codebook_dim=16, num_lstm_layers=2 if small_layout else 1,
        use_causal_conv=not small_layout, pad_mode="reflect",
        use_conv_shortcut=shortcut)
    dec = MusicgenDecoderConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, ffn_dim=64, num_codebooks=nb,
        max_position_embeddings=128, pad_token_id=64, bos_token_id=64)
    model = MusicgenForConditionalGeneration(
        MusicgenConfig.from_sub_models_config(t5, enc, dec))
    with torch.no_grad():  # transformers starts the codebooks at zero
        for layer in model.audio_encoder.quantizer.layers:
            layer.codebook.embed.normal_()
    model.generation_config.pad_token_id = 64
    model.generation_config.bos_token_id = 64
    model.generation_config.decoder_start_token_id = 64
    model.save_pretrained(str(d), safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module", params=["jax_tests", "small_layout"])
def both(request, tmp_path_factory):
    d = write_musicgen_dir(tmp_path_factory.mktemp("mg") / "mg",
                           request.param == "small_layout")
    return JM.load_musicgen(d), TM.load_musicgen(d, "cpu")


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
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bundles_bitwise(both):
    """Specs and meta equal; the three trees bitwise, through the port's
    loader and through ``from_jax_params``."""
    jb, tb = both
    for i in (0, 2, 4):
        assert vars(tb[i]) == vars(jb[i])
    assert tb[6] == jb[6]
    carried = TM.from_jax_params(
        tuple(jax.tree_util.tree_map(np.asarray, x) if i in (1, 3, 5) else x
              for i, x in enumerate(jb)), "cpu")
    for i in (1, 3, 5):
        _bitwise(tb[i], jb[i])
        _bitwise(carried[i], jb[i])
    assert ("enc_proj_w" in tb[3]) == (tb[0].d_model != tb[2].d_model)


@pytest.mark.parametrize("buckets,max_distance", [(8, 128), (32, 128),
                                                  (32, 20)])
def test_relative_buckets_equal_jax(buckets, max_distance):
    rel = np.arange(-300, 301)
    want = JM._t5_rel_bucket(jnp.asarray(rel), buckets, max_distance)
    got = TM._t5_rel_bucket(torch.tensor(rel), buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("S", [1, 5, 70])
def test_t5_states_match_jax(both, S):
    jb, tb = both
    ids = np.random.default_rng(S).integers(0, 99, (1, S))
    want = JM.t5_encode(jb[0], jb[1], jnp.asarray(ids))
    with torch.inference_mode():
        got = TM.t5_encode(tb[0], tb[1], torch.tensor(ids))
    _close(got, want)


def test_decoder_logits_match_jax(both):
    jb, tb = both
    rng = np.random.default_rng(1)
    nb = tb[2].n_codebooks
    codes = rng.integers(0, 65, (2, nb, 9))
    enc = rng.normal(size=(2, 5, tb[2].d_model)).astype(np.float32)
    want = JM.mg_decode_full(jb[2], jb[3], jnp.asarray(codes),
                             jnp.asarray(enc))
    with torch.inference_mode():
        got = TM.mg_decode_full(tb[2], tb[3], torch.tensor(codes),
                                torch.tensor(enc))
    _close(got, want)


def test_cached_steps_match_the_full_pass(both):
    """The KV-cached steps' logits within 1e-4 of the full pass's at each
    position (the JAX module's ``mg_decode_full``)."""
    jb, tb = both
    rng = np.random.default_rng(2)
    nb, T = tb[2].n_codebooks, 7
    codes = rng.integers(0, 65, (2, nb, T))
    enc = rng.normal(size=(2, 4, tb[2].d_model)).astype(np.float32)
    want = np.asarray(JM.mg_decode_full(jb[2], jb[3], jnp.asarray(codes),
                                        jnp.asarray(enc)))
    with torch.inference_mode():
        e = torch.tensor(enc)
        cross = TM.mg_cross_kv(tb[3], e)
        shape = (tb[2].n_layers, 2, T, tb[2].d_model)
        ck, cv = torch.zeros(shape), torch.zeros(shape)
        for t in range(T):
            got = TM.mg_step(tb[2], tb[3], torch.tensor(codes[:, :, t]),
                             cross, ck, cv, t)
            _close(got, want[:, :, t])


@pytest.mark.parametrize("frames", [1, 8, 13])
def test_encodec_decode_matches_jax(both, frames):
    jb, tb = both
    n_q = tb[5]["codebooks"].shape[0]
    codes = np.random.default_rng(frames).integers(0, 64, (n_q, 1, frames))
    want = JM.encodec_decode(jb[4], jb[5], jnp.asarray(codes))
    with torch.inference_mode():
        got = TM.encodec_decode(tb[4], tb[5], torch.tensor(codes))
    _close(got, want)


@pytest.fixture
def jax_frames(monkeypatch):
    """The frames the JAX ``mg_generate`` hands its EnCodec decoder."""
    seen = {}
    dec = JM.encodec_decode

    def spy(spec, p, codes):
        seen["frames"] = np.asarray(codes)[:, 0]
        return dec(spec, p, codes)

    monkeypatch.setattr(JM, "encodec_decode", spy)
    return seen


@pytest.mark.parametrize("kw", [
    dict(do_sample=False, guidance_scale=1.0),
    dict(do_sample=False, guidance_scale=3.0),
    dict(do_sample=True, guidance_scale=3.0, seed=0),
    dict(do_sample=True, guidance_scale=3.0, seed=4, temperature=0.7,
         top_k=20),
    dict(do_sample=True, guidance_scale=1.0, seed=2, top_k=0)])
def test_generation_matches_jax(both, jax_frames, kw):
    """Greedy codes equal, seeded sampled codes (with and without
    guidance) equal, the waveform within 1e-4 of max|JAX|."""
    jb, tb = both
    text = np.asarray([3, 17, 42, 7], np.int32)
    want = JM.mg_generate(jb, text, max_new_tokens=12, **kw)
    frames = TM.mg_codes(tb, text, max_new_tokens=12, **kw)
    np.testing.assert_array_equal(frames, jax_frames["frames"])
    assert frames.shape == (tb[2].n_codebooks, 13 - tb[2].n_codebooks)
    _close(TM.decode_frames(tb, frames), want)
    _close(TM.mg_generate(tb, text, max_new_tokens=12, **kw), want)


def test_c18_no_conv_shortcut_fails_both_loaders(tmp_path):
    """ROADMAP §C 18, shared with the reference: an EnCodec whose config
    turns ``use_conv_shortcut`` off (facebook/encodec_32khz's, under
    musicgen-small) has no ``shortcut.conv`` tensors, which both loaders
    read unconditionally."""
    d = write_musicgen_dir(tmp_path / "mg", True, shortcut=False)
    with pytest.raises(KeyError, match="shortcut.conv"):
        JM.load_musicgen(d)
    with pytest.raises(KeyError, match="shortcut.conv"):
        TM.load_musicgen(d, "cpu")
