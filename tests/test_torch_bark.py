"""The port's bark (``models/bark.py``) against the JAX package's on the
same inputs.

A tiny HF ``BarkModel`` written with ``save_pretrained`` loads through
both loaders (trees bitwise). Its windows are cut so that both causal
stages slide: the semantic stage's 513-token prompt fits a 516-token
window for its first steps (the port's KV cache) and then slides (a fresh
forward a step); the coarse stage's window of 16 slides after eight steps.
Tolerances: every stage's logits within 1e-4 of max|JAX|; greedy codes
equal; sampled codes equal under the JAX key chain's Gumbel draws (fed to
the port as ``noise``); waveforms within 1e-4 of max|JAX|. The JAX
stages run under ``jax.jit`` (eager JAX dispatches op by op).
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from localai_tfp_tpu.models import bark as JB
from localai_tfp_tpu_torch.models import bark as TB
from localai_tfp_tpu_torch.models import encodec as TE

REL = 1e-4  # of max|JAX output|
H, LAYERS, HEADS = 32, 2, 2
MAX_SEMANTIC = 6  # 513 + 6 passes the semantic window of 516


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jit_jax():
    """The JAX stages under ``jax.jit`` (the same XLA f32 programs,
    compiled once per window bucket)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "bark_causal_logits",
                   jax.jit(JB.bark_causal_logits, static_argnums=0))
        mp.setattr(JB, "bark_fine_logits",
                   jax.jit(JB.bark_fine_logits, static_argnums=(0, 3)))
        yield


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= bound, (err, bound)


def write_bark_dir(d, seed=0):
    """A tiny HF BarkModel: bias in the semantic and fine stages, none in
    the coarse one (bark-small has none anywhere); windows 516 / 16 /
    16; an EnCodec of 8 codebooks of 1024."""
    from transformers import BarkConfig, BarkModel, EncodecConfig
    from transformers.models.bark import (BarkCoarseConfig, BarkFineConfig,
                                          BarkSemanticConfig)
    from transformers.models.bark import modeling_bark

    init = modeling_bark.BarkPreTrainedModel._init_weights

    def init_weights(self, module):
        # transformers zeroes every LayerNorm's bias, which a bias-free
        # stage (bark-small's layout) does not have
        if isinstance(module, torch.nn.LayerNorm) and module.bias is None:
            module.weight.data.fill_(1.0)
        else:
            init(self, module)

    torch.manual_seed(seed)
    sem = BarkSemanticConfig(
        hidden_size=H, num_layers=LAYERS, num_heads=HEADS,
        input_vocab_size=129_600, output_vocab_size=10_048,
        block_size=516, bias=True)
    co = BarkCoarseConfig(
        hidden_size=H, num_layers=LAYERS, num_heads=HEADS,
        input_vocab_size=12_096, output_vocab_size=12_096,
        block_size=16, bias=False)
    fi = BarkFineConfig(
        hidden_size=H, num_layers=LAYERS, num_heads=HEADS,
        input_vocab_size=1056, output_vocab_size=1056, block_size=16,
        bias=True, n_codes_total=8, n_codes_given=1)
    enc = EncodecConfig(
        hidden_size=16, num_filters=4, num_residual_layers=1,
        upsampling_ratios=[2, 2], codebook_size=1024, codebook_dim=16,
        sampling_rate=16_000, audio_channels=1, normalize=False,
        target_bandwidths=[320.0])  # 8 quantizers at this frame rate
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(modeling_bark.BarkPreTrainedModel, "_init_weights",
                   init_weights)
        model = BarkModel(BarkConfig.from_sub_model_configs(sem, co, fi,
                                                            enc))
    with torch.no_grad():  # transformers starts the codebooks at zero
        for layer in model.codec_model.quantizer.layers:
            layer.codebook.embed.normal_()
    model.save_pretrained(str(d), safe_serialization=True)
    return str(d)


@pytest.fixture(scope="module")
def bark_dir(tmp_path_factory):
    return write_bark_dir(tmp_path_factory.mktemp("bark") / "bark")


@pytest.fixture(scope="module")
def pipes(bark_dir):
    return JB.BarkTTS.load(bark_dir), TB.BarkTTS.load(bark_dir, "cpu")


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
        if b is None or isinstance(b, (str, bool)):
            assert a == b
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("stage", ["semantic", "coarse", "fine", "codec"])
def test_trees_bitwise(pipes, stage):
    """The port's loader and ``from_jax_params`` of the JAX tree give the
    JAX loader's tree, bitwise; the specs are equal."""
    jp, tp = pipes
    jt, tt = getattr(jp, stage), getattr(tp, stage)
    _bitwise(tt, jt)
    if stage == "codec":
        assert (tp.ratios, tp.sample_rate) == (jp.ratios, jp.sample_rate)
        return
    assert getattr(tp, f"{stage}_spec") == TB.BarkGPTSpec(
        **vars(getattr(jp, f"{stage}_spec")))
    _bitwise(TB.from_jax_params(jax.tree_util.tree_map(np.asarray, jt),
                                "cpu"), jt)


@pytest.mark.parametrize("stage,vocab,n", [("semantic", 129_600, 12),
                                           ("semantic", 129_600, 516),
                                           ("coarse", 12_096, 16)])
def test_causal_logits_match_jax(pipes, stage, vocab, n):
    jp, tp = pipes
    ids = np.random.default_rng(n).integers(0, vocab, (1, n))
    want = JB.bark_causal_logits(getattr(jp, f"{stage}_spec"),
                                 getattr(jp, stage), jnp.asarray(ids))
    with torch.inference_mode():
        got = TB.bark_causal_logits(getattr(tp, f"{stage}_spec"),
                                    getattr(tp, stage), torch.tensor(ids))
    _close(got, want)


@pytest.mark.parametrize("codebook", [1, 2, 5, 7])
def test_fine_logits_match_jax(pipes, codebook):
    jp, tp = pipes
    codes = np.random.default_rng(codebook).integers(0, 1024, (1, 11, 8))
    want = JB.bark_fine_logits(jp.fine_spec, jp.fine, jnp.asarray(codes),
                               codebook)
    with torch.inference_mode():
        got = TB.bark_fine_logits(tp.fine_spec, tp.fine,
                                  torch.tensor(codes), codebook)
    _close(got, want)


@pytest.mark.parametrize("stage,vocab,prompt,steps", [
    ("semantic", 129_600, 510, 9), ("coarse", 12_096, 5, 15)])
def test_loop_logits_match_jax_windows(pipes, stage, vocab, prompt, steps):
    """Each step's last logits of the port's loop (KV-cached, then
    sliding) within 1e-4 of the JAX module's bucketed window forward over
    ``ids[-block_size:]``, step by step over the same ids."""
    jp, tp = pipes
    spec, p = getattr(tp, f"{stage}_spec"), getattr(tp, stage)
    rng = np.random.default_rng(prompt)
    ids = [int(t) for t in rng.integers(0, vocab, prompt)]
    forced = [int(t) for t in rng.integers(0, 10_000, steps)]
    seen = []

    def pick(step, logits):
        seen.append(logits.numpy().copy())
        return forced[step]

    with torch.inference_mode():
        TB.causal_loop(spec, p, ids, steps, pick)
    assert len(ids) + steps > spec.block_size  # the window slides
    full = ids + forced
    for step in range(steps):
        window = full[:len(ids) + step][-spec.block_size:]
        want = JB._bucketed_last_logits(getattr(jp, f"{stage}_spec"),
                                        getattr(jp, stage), window)
        _close(seen[step], want)


def jax_noise(seed, n_semantic, n_coarse):
    """The Gumbel draws ``jax.random.categorical`` adds along the JAX
    ``generate``'s key chain: PRNGKey(seed) -> split per stage -> split
    per step."""
    rng = jax.random.PRNGKey(seed)
    out = {}
    for stage, steps, width in (("semantic", n_semantic, 10_001),
                                ("coarse", n_coarse, 1024)):
        rng, k = jax.random.split(rng)
        rows = []
        for _ in range(steps):
            k, key = jax.random.split(k)
            rows.append(np.asarray(jax.random.gumbel(key, (width,),
                                                     jnp.float32)))
        out[stage] = np.stack(rows)
    return out


@pytest.fixture
def codes_of(monkeypatch):
    """The codes each package's ``generate`` hands its EnCodec decoder."""
    seen = {}
    jdec, tdec = JB.encodec_decode, TB.encodec_decode

    def jcap(dec, codes, ratios):
        seen["jax"] = np.asarray(codes)
        return jdec(dec, codes, ratios)

    def tcap(dec, codes, ratios):
        seen["port"] = np.asarray(codes)
        return tdec(dec, codes, ratios)

    monkeypatch.setattr(JB, "encodec_decode", jcap)
    monkeypatch.setattr(TB, "encodec_decode", tcap)
    return seen


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.7, 0),
                                              (0.7, 3), (1.3, 5)])
@pytest.mark.parametrize("text", ["hello world", "a"])
def test_generate_matches_jax(pipes, codes_of, text, temperature, seed):
    """Greedy codes equal; sampled codes equal under the JAX draws; the
    waveform within 1e-4 of max|JAX|."""
    jp, tp = pipes
    kw = dict(temperature=temperature, max_semantic=MAX_SEMANTIC, seed=seed)
    want = jp.generate(text, **kw)
    noise = None
    if temperature > 0:
        noise = jax_noise(seed, MAX_SEMANTIC,
                          TB.BarkTTS.n_coarse(MAX_SEMANTIC))
    got = tp.generate(text, noise=noise, **kw)
    np.testing.assert_array_equal(codes_of["port"], codes_of["jax"])
    assert codes_of["port"].shape[0] == 8
    _close(got, want)


def test_sampling_without_noise_is_seeded(pipes, codes_of):
    """Without injected draws, a seed gives the same codes and audio
    twice and another seed other codes."""
    _, tp = pipes
    runs = []
    for seed in (1, 1, 2):
        runs.append((tp.generate("hi", max_semantic=4, seed=seed),
                     codes_of["port"]))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert not np.array_equal(runs[0][1], runs[2][1])


def test_c17_a_vocab_txt_is_read_by_neither(bark_dir, tmp_path,
                                            monkeypatch, codes_of):
    """ROADMAP §C 17, shared with the reference: the JAX loader builds a
    tokenizer from ``vocab.txt`` and drops it, so both packages byte-map
    the text (``b % 1000``): the same prompt ids and the same audio."""
    d = tmp_path / "bark_vocab"
    shutil.copytree(bark_dir, d)
    (d / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world"]))
    prompts = []
    loop = JB.BarkTTS._sample_loop

    def spy(self, spec, p, prompt, **kw):
        prompts.append(np.asarray(prompt))
        return loop(self, spec, p, prompt, **kw)

    monkeypatch.setattr(JB.BarkTTS, "_sample_loop", spy)
    jp, tp = JB.BarkTTS.load(str(d)), TB.BarkTTS.load(str(d), "cpu")
    assert jp.tokenizer is None
    text = "hello world"
    want = jp.generate(text, temperature=0.0, max_semantic=4)
    got = tp.generate(text, temperature=0.0, max_semantic=4)
    ids = [b % 1000 for b in text.encode()]
    np.testing.assert_array_equal(
        prompts[0][:len(ids)], np.asarray(ids) + TB.TEXT_ENCODING_OFFSET)
    np.testing.assert_array_equal(codes_of["port"], codes_of["jax"])
    _close(got, want)


def test_codec_is_the_encodec_module():
    """Bark decodes through ``models/encodec.py`` (no second copy)."""
    assert TB.encodec_decode is TE.encodec_decode
    assert TB.load_encodec_decoder is TE.load_encodec_decoder
