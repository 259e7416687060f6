"""Image decoding and resizing without PIL, for the vision towers.

Counterpart of the decode-and-resize half of
localai_tfp_tpu/models/vision.py::preprocess_image, which calls PIL: the
machine with the card has no PIL, so this module reads PNG files with
``zlib`` and numpy and resamples them as PIL's ``Image.resize`` does.

- ``decode_png``: non-interlaced PNG, 8-bit gray, gray + alpha, RGB and
  RGBA, palette at 1, 2, 4 or 8 bits and gray at 1, 2 or 4 bits (scaled
  to 8 as PIL reads them); the five row filters are undone along
  anti-diagonals, so each step is one vectorised update of every row.
  The result is RGB as ``Image.convert("RGB")`` gives it: alpha dropped
  (not composited), gray replicated, palette entries looked up.
- ``resize``: PIL's two separable passes (horizontal, then vertical),
  each with PIL's fixed-point arithmetic: the filter's support widened
  by the scale factor on a downscale (antialiasing), weights normalised
  per output pixel then rounded to 22 fractional bits, and every pass
  rounded to uint8. Bilinear and bicubic (``a = -0.5``) as PIL has them.
- ``preprocess_image``: the towers' input, as the JAX package makes it
  (SigLIP: bilinear resize to the square size, ``(x / 255 - 0.5) /
  0.5``; CLIP: bicubic resize of the short side, centre crop, CLIP's
  mean and std).

Any other format (JPEG, GIF, WebP, BMP, interlaced or 16-bit PNG) raises
``UnsupportedImage`` naming it; the HTTP routes answer it with a 400.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point fraction for 8-bit passes
_CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
_CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
# PNG colour type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# decompressed bytes a PNG may hold: 16384 x 16384 RGBA plus filter bytes
_MAX_PIXEL_BYTES = 16384 * (16384 * 4 + 1)


class UnsupportedImage(ValueError):
    """An image this module cannot read; the message names its format."""


def image_format(data: bytes) -> str:
    """The container format ``data`` starts with, by its magic bytes."""
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:2] == b"BM":
        return "BMP"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    return "unknown"


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    at = len(PNG_SIGNATURE)
    while at + 8 <= len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        kind = data[at + 4:at + 8]
        body = data[at + 8:at + 8 + n]
        crc = data[at + 8 + n:at + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise UnsupportedImage("truncated PNG")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise UnsupportedImage(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        at += 12 + n
    raise UnsupportedImage("truncated PNG (no IEND chunk)")


def png_header(data: bytes) -> dict:
    """The IHDR fields of a PNG this module decodes; raises
    ``UnsupportedImage`` for any other image (read from the first 33
    bytes: a cheap check before an image is queued)."""
    fmt = image_format(data)
    if fmt != "PNG":
        raise UnsupportedImage(
            f"unsupported image format: {fmt} (only PNG is decoded)")
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise UnsupportedImage("truncated PNG (no IHDR chunk)")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", data[16:29])
    if interlace:
        raise UnsupportedImage("unsupported image format: interlaced PNG")
    if ctype not in _CHANNELS or comp or filt:
        raise UnsupportedImage(f"invalid PNG header (colour type {ctype})")
    ok = {0: (1, 2, 4, 8), 3: (1, 2, 4, 8)}.get(ctype, (8,))
    if depth not in ok:
        raise UnsupportedImage(
            f"unsupported image format: {depth}-bit PNG of colour type "
            f"{ctype}")
    if not (0 < w <= 16384 and 0 < h <= 16384):
        raise UnsupportedImage(f"PNG of {w} x {h} pixels")
    return {"width": w, "height": h, "depth": depth, "color_type": ctype}


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``raw`` ([h, 1 + rowbytes] uint8): each
    unit of ``bpp`` bytes depends on its left, upper and upper-left
    units, so every anti-diagonal of units is one vectorised step."""
    ftype = raw[:, 0].astype(np.int64)
    if int(ftype.max(initial=0)) > 4:
        raise UnsupportedImage("PNG row with an unknown filter type")
    units = rowbytes // bpp
    filt = raw[:, 1:].reshape(h, units, bpp).astype(np.int64)
    # padded with a zero row above and a zero unit to the left
    out = np.zeros((h + 1, units + 1, bpp), np.int64)
    if not ftype.any():
        out[1:, 1:] = filt
        return out[1:, 1:].astype(np.uint8).reshape(h, rowbytes)
    for d in range(h + units - 1):
        r = np.arange(max(0, d - units + 1), min(h, d + 1))
        c = d - r
        x = filt[r, c]
        a = out[r + 1, c]  # left
        b = out[r, c + 1]  # up
        ul = out[r, c]  # upper left
        ft = ftype[r][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, ul)], 0)
        out[r + 1, c + 1] = (x + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, rowbytes)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG -> [H, W, 3] uint8 RGB, as ``Image.open(...).convert("RGB")``
    reads it (alpha dropped, palette looked up, gray replicated)."""
    hdr = png_header(data)
    w, h, depth, ctype = (hdr["width"], hdr["height"], hdr["depth"],
                          hdr["color_type"])
    idat, plte = [], None
    for kind, body in _chunks(data):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
    ch = _CHANNELS[ctype]
    rowbytes = -(-w * ch * depth // 8)
    bpp = max(1, ch * depth // 8)
    want = h * (rowbytes + 1)
    if want > _MAX_PIXEL_BYTES:
        raise UnsupportedImage(f"PNG of {w} x {h} pixels")
    try:
        d = zlib.decompressobj()
        raw = d.decompress(b"".join(idat), want)
    except zlib.error as e:
        raise UnsupportedImage(f"corrupt PNG data: {e}") from None
    if len(raw) < want:
        raise UnsupportedImage("truncated PNG image data")
    rows = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, rowbytes + 1),
                     h, rowbytes, bpp)
    if depth < 8:  # 1, 2 or 4-bit samples, most significant first
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        vals = (bits * weights).sum(axis=2)[:, :w].astype(np.uint8)
        if ctype == 0:  # gray: scaled to 8 bits as PIL reads "L;2"/"L;4"
            vals = (vals.astype(np.int64) * (255 // ((1 << depth) - 1))
                    ).astype(np.uint8)
        pix = vals[:, :, None]
    else:
        pix = rows.reshape(h, w, ch)
    if ctype == 3:
        if plte is None or len(plte) % 3:
            raise UnsupportedImage("palette PNG without a valid PLTE chunk")
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(plte, np.uint8).reshape(-1, 3)[:256]
        pal[:len(entries)] = entries
        return pal[pix[:, :, 0]]
    if ctype in (0, 4):  # gray (+ alpha): replicated, alpha dropped
        return np.repeat(pix[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pix[:, :, :3])


# ---------------------------------------------------------------- resize


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
        np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, kind: str):
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``: each
    output pixel's first input index [out] and its int32 weights [out,
    ksize] (22 fractional bits; zero past the pixel's span)."""
    fn, support0 = _FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; negatives clamp to 0 either way
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    ss = 1.0 / filterscale
    x = np.arange(ksize)
    w = fn(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss)
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # PIL's left-to-right sum
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    one = float(1 << _PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, k.astype(np.int64)


def _pass(img: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    """One 8-bit resampling pass of ``img`` ([H, W, C] uint8) along
    ``axis`` (1: horizontal, 0: vertical), in int32 as PIL sums it (the
    weights' absolute sum times 255 stays below 2^31)."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size, kind)
    k = k.astype(np.int32)
    src = img.astype(np.int32)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)
        acc += np.take(src, idx, axis=axis) * k[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, width: int, height: int,
           kind: str = "bilinear") -> np.ndarray:
    """``Image.resize((width, height), BILINEAR or BICUBIC)`` of an
    [H, W, C] uint8 image: the horizontal pass first, each pass only
    where that size changes."""
    if img.shape[1] != width:
        img = _pass(img, width, 1, kind)
    if img.shape[0] != height:
        img = _pass(img, height, 0, kind)
    return img


def preprocess_image(data: bytes, image_size: int,
                     family: str = "siglip") -> np.ndarray:
    """One encoded image -> [3, S, S] f32, the tower's input: the JAX
    package's ``preprocess_image`` with this module's decoder and
    resampler in place of PIL's."""
    img = decode_png(data)
    if family == "clip":
        h, w = img.shape[:2]
        short = min(w, h)
        nw, nh = (round(w * image_size / short),
                  round(h * image_size / short))
        img = resize(img, nw, nh, "bicubic")
        left = (nw - image_size) // 2
        top = (nh - image_size) // 2
        img = img[top:top + image_size, left:left + image_size]
        arr = np.asarray(img, dtype=np.float32) / 255.0
        arr = (arr - _CLIP_MEAN) / _CLIP_STD
    else:
        img = resize(img, image_size, image_size, "bilinear")
        arr = np.asarray(img, dtype=np.float32) / 255.0
        arr = (arr - 0.5) / 0.5
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> a PNG (filter type 0 rows), for tests and
    the chip smoke, which have no PIL on the card."""
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rgb, np.uint8).reshape(h, -1)],
                         axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
