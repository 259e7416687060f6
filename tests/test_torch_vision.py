"""The port's vision towers and image decoding against the JAX package.

- Both towers and both projectors (SigLIP + Gemma 3, CLIP + LLaVA) of
  tiny ``save_pretrained`` checkpoints: the port's loader gives the JAX
  loader's tree bitwise and the same ``mm_info``, and ``encode_images``
  on the same pixels (numpy, seed 0) agrees with the JAX one within
  1e-5 (f32 both).
- ``models/image_io.py`` against the JAX ``preprocess_image`` (which
  calls PIL): PNGs of every colour type PIL writes (gray, gray +
  alpha, RGB, RGBA, palette at 2, 4 and 8 bits, 1-bit), upscaled,
  downscaled and non-square, decode to PIL's RGB bitwise and resize to
  PIL's pixels, so the normalised tensors agree within one uint8 level
  (they agree exactly here).
- Formats the decoder does not read are refused with their name.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from localai_tfp_tpu.models import hf_loader as jax_loader
from localai_tfp_tpu.models import vision as jax_vision
from localai_tfp_tpu_torch.models import hf_loader, image_io, vision
from localai_tfp_tpu_torch.models.convert import params_from_numpy

TOWER_TOL = 1e-5  # f32 both sides


def gemma3_mm_checkpoint(d):
    """A tiny Gemma 3 with its SigLIP tower (4 soft tokens per image)."""
    from transformers import Gemma3Config, Gemma3ForConditionalGeneration

    torch.manual_seed(0)
    cfg = Gemma3Config(
        text_config=dict(
            vocab_size=300, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, query_pre_attn_scalar=16,
            sliding_window=8, rope_local_base_freq=10000.0,
            rope_theta=1000000.0, max_position_embeddings=512),
        vision_config=dict(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, image_size=56, patch_size=14,
            num_channels=3),
        mm_tokens_per_image=4, boi_token_index=288, eoi_token_index=289,
        image_token_index=290)
    Gemma3ForConditionalGeneration(cfg).save_pretrained(
        d, safe_serialization=True)
    return str(d)


def llava_checkpoint(d):
    """A tiny LLaVA: a 3-layer CLIP tower (4 patches) over a Llama."""
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
    return str(d)


@pytest.fixture(scope="module", params=["gemma3", "llava"])
def mm_ckpt(request, tmp_path_factory):
    make = gemma3_mm_checkpoint if request.param == "gemma3" \
        else llava_checkpoint
    return request.param, make(tmp_path_factory.mktemp("mm") / request.param)


def _flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{pre}{k}.")
        else:
            yield pre + k, v


def test_loader_trees_and_mm_info_match_jax(mm_ckpt):
    kind, path = mm_ckpt
    jspec, jparams, jmm = jax_loader.load_multimodal(path, dtype=jnp.float32)
    spec, params, mm = hf_loader.load_multimodal(path, dtype=torch.float32)
    assert mm == jmm
    assert mm["family"] == ("clip" if kind == "llava" else "siglip")
    for f in ("hidden", "n_layers", "n_heads", "d_ff", "image_size",
              "patch_size", "eps", "mm_tokens", "text_d_model", "family"):
        assert getattr(spec, f) == getattr(jspec, f), f
    want = dict(_flat(jparams))
    got = dict(_flat(params))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k


def test_towers_and_projectors_match_jax(mm_ckpt):
    kind, path = mm_ckpt
    jspec, jparams, _ = jax_loader.load_multimodal(path, dtype=jnp.float32)
    spec, params, _ = hf_loader.load_multimodal(path, dtype=torch.float32)
    converted = params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items() if k != "layers"}
        | {"layers": {
            k: np.asarray(v) for k, v in jparams["layers"].items()}})
    rng = np.random.default_rng(0)
    S = spec.image_size
    pixels = rng.normal(size=(2, 3, S, S)).astype(np.float32)
    want = np.asarray(jax_vision.encode_images(jspec, jparams,
                                               jnp.asarray(pixels)))
    for tree in (params, converted):
        got = vision.encode_images(spec, tree, torch.from_numpy(pixels))
        assert got.shape == (2, spec.mm_tokens, spec.text_d_model)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOWER_TOL)


# ------------------------------------------------------------ image_io


def _png(mode: str, w: int, h: int, seed: int, bits=None) -> bytes:
    rng = np.random.default_rng(seed)
    if mode == "P":
        img = Image.fromarray(
            rng.integers(0, 1 << (bits or 8), (h, w), dtype=np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tolist())
    elif mode == "1":
        img = Image.fromarray(
            rng.integers(0, 2, (h, w), dtype=np.uint8) * 255, "L").convert("1")
    else:
        ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        y, x = np.mgrid[0:h, 0:w]
        # gradients and noise, so the encoder picks every row filter
        base = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256,
                         rng.integers(0, 256, (h, w)), (x + 2 * y) % 256],
                        axis=-1)[..., :ch].astype(np.uint8)
        img = Image.fromarray(base[..., 0] if ch == 1 else base, mode)
    buf = io.BytesIO()
    img.save(buf, "PNG", **({"bits": bits} if bits else {}))
    return buf.getvalue()


CASES = [(m, w, h, None) for m in ("L", "LA", "RGB", "RGBA", "P", "1")
         for w, h in ((37, 23), (120, 90), (9, 7))] + [
    ("P", 40, 30, 2), ("P", 33, 17, 4)]


@pytest.mark.parametrize("mode,w,h,bits", CASES)
def test_decode_png_matches_pil(mode, w, h, bits):
    data = _png(mode, w, h, seed=w * h, bits=bits)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = image_io.decode_png(data)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def _levels(arr: np.ndarray, family: str) -> np.ndarray:
    """A normalised [3, S, S] tensor back to uint8 levels."""
    x = arr.transpose(1, 2, 0)
    if family == "clip":
        x = x * image_io._CLIP_STD + image_io._CLIP_MEAN
    else:
        x = x * 0.5 + 0.5
    return x * 255.0


@pytest.mark.parametrize("family", ["siglip", "clip"])
@pytest.mark.parametrize("mode,w,h", [("RGB", 37, 23), ("RGBA", 120, 90),
                                      ("L", 9, 7), ("P", 120, 90),
                                      ("LA", 90, 120)])
@pytest.mark.parametrize("size", [16, 56, 224])
def test_preprocess_matches_pil(family, mode, w, h, size):
    """Upscale (9x7, 37x23 to 56 and 224), downscale (120x90 to 16 and
    56), non-square: within one uint8 level of PIL's."""
    data = _png(mode, w, h, seed=size + w)
    want = jax_vision.preprocess_image(data, size, family)
    got = image_io.preprocess_image(data, size, family)
    assert got.shape == want.shape == (3, size, size)
    assert got.dtype == np.float32
    diff = np.abs(_levels(got, family) - _levels(want, family)).max()
    assert diff <= 1.0 + 1e-3


@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
def test_resize_matches_pil_bitwise(kind):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (61, 83, 3), dtype=np.uint8)
    pil = Image.fromarray(img)
    flag = Image.BILINEAR if kind == "bilinear" else Image.BICUBIC
    for w, h in ((83, 20), (20, 61), (200, 150), (31, 97), (7, 7)):
        want = np.asarray(pil.resize((w, h), flag))
        assert np.array_equal(image_io.resize(img, w, h, kind), want), (w, h)


def test_encode_png_round_trips_through_pil():
    rgb = np.random.default_rng(5).integers(0, 256, (13, 21, 3),
                                            dtype=np.uint8)
    data = image_io.encode_png(rgb)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), rgb)
    assert np.array_equal(image_io.decode_png(data), rgb)


def _saved(fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("fmt,name", [("JPEG", "JPEG"), ("GIF", "GIF"),
                                      ("BMP", "BMP"), ("TIFF", "TIFF")])
def test_other_formats_are_refused_by_name(fmt, name):
    data = _saved(fmt)
    with pytest.raises(image_io.UnsupportedImage, match=name):
        image_io.decode_png(data)
    with pytest.raises(image_io.UnsupportedImage, match=name):
        image_io.png_header(data)


def test_interlaced_and_16_bit_pngs_are_refused_by_name():
    data = bytearray(_png("RGB", 8, 8, 0))
    data[28] = 1  # IHDR's interlace method: Adam7
    with pytest.raises(image_io.UnsupportedImage, match="interlaced PNG"):
        image_io.decode_png(bytes(data))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16), "I;16").save(buf, "PNG")
    with pytest.raises(image_io.UnsupportedImage, match="16-bit PNG"):
        image_io.decode_png(buf.getvalue())
    with pytest.raises(image_io.UnsupportedImage, match="unknown"):
        image_io.decode_png(b"not an image at all")
