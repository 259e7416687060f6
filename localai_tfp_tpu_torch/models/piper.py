"""Piper voices (.onnx + sidecar .onnx.json) for the port's VITS: the
counterpart of localai_tfp_tpu/models/piper.py.

Every piper voice in the LocalAI gallery is an original-VITS checkpoint
exported to ONNX (ref: backend/go/tts/piper.go:49). This module loads
those voices into ``models/vits.py`` without onnxruntime or the onnx
package, as the JAX module does:

- a minimal ONNX protobuf wire reader (the initializer tensors only);
- a name shim from original-VITS module paths (enc_p/dp/flow/dec, which
  piper's torch.onnx export keeps) to the HF ``VitsModel`` names
  ``build_vits_params`` reads;
- architecture inference from tensor shapes (piper's json carries no
  hyperparameters);
- phonemization: ``espeak-ng`` through ``subprocess`` when the binary
  exists, else a built-in approximate English grapheme-to-phoneme
  fallback; then the config's ``phoneme_id_map`` with piper's ^/_/$
  framing (interspersed pad, BOS/EOS).

The voice's tensors go to ``device`` (the card unless the caller asks
for the CPU); phonemization and the id map stay on the host.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

# ------------------------------------------------------- ONNX wire reader

_F32, _F16, _I64, _I32, _F64 = 1, 10, 7, 6, 11


def _walk(buf: memoryview):
    """Yield (field_number, wire_type, value) over one protobuf
    message. Length-delimited values come back as memoryviews."""
    i = 0
    n = len(buf)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        fieldnum, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                val |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield fieldnum, wt, val
        elif wt == 2:  # length-delimited
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield fieldnum, wt, buf[i:i + ln]
            i += ln
        elif wt == 5:  # 32-bit
            yield fieldnum, wt, bytes(buf[i:i + 4])
            i += 4
        elif wt == 1:  # 64-bit
            yield fieldnum, wt, bytes(buf[i:i + 8])
            i += 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")


_DTYPES = {_F32: np.float32, _F16: np.float16, _I64: np.int64,
           _I32: np.int32, _F64: np.float64}


def _tensor(buf: memoryview) -> tuple[str, np.ndarray]:
    """TensorProto -> (name, array). Handles raw_data and the packed
    float_data/int64_data variants."""
    dims: list[int] = []
    dtype = _F32
    name = ""
    raw = b""
    floats = b""
    int64s: list[int] = []
    for f, wt, v in _walk(buf):
        if f == 1 and wt == 0:
            dims.append(v)
        elif f == 1 and wt == 2:  # packed dims
            j = 0
            while j < len(v):
                val = 0
                shift = 0
                while True:
                    b = v[j]
                    j += 1
                    val |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                dims.append(val)
        elif f == 2:
            dtype = v
        elif f == 8:
            name = bytes(v).decode()
        elif f == 9:
            raw = bytes(v)
        elif f == 4 and wt == 2:
            floats = bytes(v)
        elif f == 7 and wt == 0:
            int64s.append(v)
    np_dt = _DTYPES.get(dtype)
    if np_dt is None:
        raise ValueError(f"initializer {name!r}: unsupported ONNX "
                         f"data_type {dtype}")
    if raw:
        arr = np.frombuffer(raw, np_dt)
    elif floats:
        arr = np.frombuffer(floats, np.float32)
    else:
        arr = np.asarray(int64s, np.int64)
    return name, arr.reshape(dims or (-1,)).astype(
        np.float32 if np_dt != np.int64 else np.int64)


def read_onnx_initializers(path: str) -> dict[str, np.ndarray]:
    """{initializer name: array} from an ONNX file."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    out: dict[str, np.ndarray] = {}
    for f1, wt, v in _walk(data):
        if f1 == 7 and wt == 2:  # ModelProto.graph
            for f2, wt2, v2 in _walk(v):
                if f2 == 5 and wt2 == 2:  # GraphProto.initializer
                    name, arr = _tensor(v2)
                    out[name] = arr
    if not out:
        raise ValueError(f"{path}: no initializers found (not an ONNX "
                         "model, or an external-data export)")
    return out


# ------------------------------------------------- piper -> HF name shim

_ATTN = {"q_proj": "conv_q", "k_proj": "conv_k", "v_proj": "conv_v",
         "out_proj": "conv_o"}


def _piper_name(hf: str) -> Optional[str]:
    """HF VitsModel parameter name -> original-VITS (piper) initializer
    name. The inverse of the transformers conversion-script mapping.
    None = no counterpart (training-only branches)."""
    m = re.match(r"text_encoder\.embed_tokens\.(.*)", hf)
    if m:
        return f"enc_p.emb.{m.group(1)}"
    m = re.match(r"text_encoder\.project\.(.*)", hf)
    if m:
        return f"enc_p.proj.{m.group(1)}"
    m = re.match(
        r"text_encoder\.encoder\.layers\.(\d+)\.attention\.(\w+)\.(.*)",
        hf)
    if m:
        i, sub, leaf = m.groups()
        return f"enc_p.encoder.attn_layers.{i}.{_ATTN[sub]}.{leaf}"
    m = re.match(
        r"text_encoder\.encoder\.layers\.(\d+)\.attention\.(emb_rel_[kv])",
        hf)
    if m:
        return f"enc_p.encoder.attn_layers.{m.group(1)}.{m.group(2)}"
    m = re.match(r"text_encoder\.encoder\.layers\.(\d+)\.layer_norm\.(.*)",
                 hf)
    if m:
        leaf = {"weight": "gamma", "bias": "beta"}[m.group(2)]
        return f"enc_p.encoder.norm_layers_1.{m.group(1)}.{leaf}"
    m = re.match(
        r"text_encoder\.encoder\.layers\.(\d+)\.feed_forward\.(.*)", hf)
    if m:
        return f"enc_p.encoder.ffn_layers.{m.group(1)}.{m.group(2)}"
    m = re.match(
        r"text_encoder\.encoder\.layers\.(\d+)\.final_layer_norm\.(.*)",
        hf)
    if m:
        leaf = {"weight": "gamma", "bias": "beta"}[m.group(2)]
        return f"enc_p.encoder.norm_layers_2.{m.group(1)}.{leaf}"

    # stochastic duration predictor: HF flows.0 is the ElementwiseAffine
    # (m/logs), HF flows.i>=1 map to piper's ConvFlows at odd indices
    # (original interleaves Flip modules that carry no weights)
    m = re.match(r"duration_predictor\.conv_pre\.(.*)", hf)
    if m:
        return f"dp.pre.{m.group(1)}"
    m = re.match(r"duration_predictor\.conv_proj\.(.*)", hf)
    if m:
        return f"dp.proj.{m.group(1)}"
    m = re.match(r"duration_predictor\.conv_dds\.(.*)", hf)
    if m:
        return f"dp.convs.{_dds_leaf(m.group(1))}"
    m = re.match(r"duration_predictor\.cond\.(.*)", hf)
    if m:
        return f"dp.cond.{m.group(1)}"
    if hf == "duration_predictor.flows.0.translate":
        return "dp.flows.0.m"
    if hf == "duration_predictor.flows.0.log_scale":
        return "dp.flows.0.logs"
    m = re.match(r"duration_predictor\.flows\.(\d+)\.(.*)", hf)
    if m:
        i = int(m.group(1))
        rest = m.group(2)
        rest = (rest.replace("conv_pre", "pre")
                .replace("conv_proj", "proj"))
        if rest.startswith("conv_dds."):
            rest = "convs." + _dds_leaf(rest[len("conv_dds."):])
        return f"dp.flows.{2 * i - 1}.{rest}"

    # prior flow: HF flows.i <-> piper flow.flows.{2i} (Flips skipped)
    m = re.match(r"flow\.flows\.(\d+)\.(.*)", hf)
    if m:
        i = int(m.group(1))
        rest = (m.group(2)
                .replace("conv_pre", "pre").replace("conv_post", "post")
                .replace("wavenet.", "enc."))
        return f"flow.flows.{2 * i}.{rest}"

    m = re.match(r"decoder\.upsampler\.(\d+)\.(.*)", hf)
    if m:
        return f"dec.ups.{m.group(1)}.{m.group(2)}"
    m = re.match(r"decoder\.(.*)", hf)
    if m:
        return f"dec.{m.group(1)}"
    if hf.startswith("embed_speaker."):
        return "emb_g." + hf.split(".", 1)[1]
    return None


def _dds_leaf(rest: str) -> str:
    rest = (rest.replace("convs_dilated", "convs_sep")
            .replace("convs_pointwise", "convs_1x1"))
    m = re.match(r"(norms_[12]\.\d+)\.(weight|bias)", rest)
    if m:
        return f"{m.group(1)}." + {"weight": "gamma",
                                   "bias": "beta"}[m.group(2)]
    return rest


def _infer_config(t: dict[str, np.ndarray], pcfg: dict) -> dict:
    """Piper's json carries no architecture hyperparameters — derive the
    HF-style config from initializer shapes."""
    hidden = t["enc_p.emb.weight"].shape[1]
    n_layers = 0
    while f"enc_p.encoder.attn_layers.{n_layers}.conv_q.weight" in t:
        n_layers += 1
    n_ups = 0
    rates, kernels = [], []
    while f"dec.ups.{n_ups}.weight" in t:
        k = t[f"dec.ups.{n_ups}.weight"].shape[-1]
        kernels.append(int(k))
        rates.append(int(k) // 2)  # the VITS stride = kernel/2 export
        n_ups += 1
    n_res_total = 0
    while f"dec.resblocks.{n_res_total}.convs1.0.weight" in t:
        n_res_total += 1
    res_kernels = [
        int(t[f"dec.resblocks.{i}.convs1.0.weight"].shape[-1])
        for i in range(n_res_total // max(n_ups, 1))
    ]
    n_flows = 0
    while f"flow.flows.{2 * n_flows}.pre.weight" in t:
        n_flows += 1
    wn_layers = 0
    while f"flow.flows.0.enc.in_layers.{wn_layers}.weight" in t:
        wn_layers += 1
    dp_flows = 0
    while f"dp.flows.{2 * dp_flows + 1}.pre.weight" in t:
        dp_flows += 1
    dp_layers = 0
    while f"dp.convs.convs_sep.{dp_layers}.weight" in t:
        dp_layers += 1
    n_dil = 0
    while f"dec.resblocks.0.convs1.{n_dil}.weight" in t:
        n_dil += 1
    dil = tuple(1 + 2 * j for j in range(n_dil))  # (1, 3, 5) standard
    return {
        "vocab_size": int(t["enc_p.emb.weight"].shape[0]),
        "hidden_size": hidden,
        "num_hidden_layers": n_layers,
        "num_attention_heads": 2,
        "ffn_dim": int(
            t["enc_p.encoder.ffn_layers.0.conv_1.weight"].shape[0]),
        "ffn_kernel_size": int(
            t["enc_p.encoder.ffn_layers.0.conv_1.weight"].shape[-1]),
        "window_size": int(
            (t["enc_p.encoder.attn_layers.0.emb_rel_k"].shape[1] - 1)
            // 2),
        "flow_size": int(t["flow.flows.0.pre.weight"].shape[1] * 2),
        "prior_encoder_num_flows": n_flows,
        "prior_encoder_num_wavenet_layers": wn_layers,
        "wavenet_kernel_size": int(
            t["flow.flows.0.enc.in_layers.0.weight"].shape[-1]),
        "duration_predictor_num_flows": dp_flows,
        "depth_separable_num_layers": dp_layers,
        # ConvFlow proj emits half_channels * (3*bins - 1) rows with
        # half_channels == 1 (2-channel duration flow split in half)
        "duration_predictor_flow_bins": (
            (int(t["dp.flows.1.proj.weight"].shape[0]) + 1) // 3
            if "dp.flows.1.proj.weight" in t else 10),
        # the DP's pre/proj convs are 1x1; the characteristic kernel
        # lives in the depth-separable convs
        "duration_predictor_kernel_size": int(
            t["dp.convs.convs_sep.0.weight"].shape[-1])
        if "dp.convs.convs_sep.0.weight" in t else 3,
        "upsample_rates": rates,
        "upsample_kernel_sizes": kernels,
        "upsample_initial_channel": int(t["dec.conv_pre.weight"].shape[0]),
        "resblock_kernel_sizes": res_kernels or [3, 7, 11],
        "resblock_dilation_sizes": [list(dil)] * max(len(res_kernels), 1),
        "sampling_rate": int(
            (pcfg.get("audio") or {}).get("sample_rate", 22050)),
        "noise_scale": float(
            (pcfg.get("inference") or {}).get("noise_scale", 0.667)),
        "noise_scale_duration": float(
            (pcfg.get("inference") or {}).get("noise_w", 0.8)),
        "speaking_rate": 1.0 / max(float(
            (pcfg.get("inference") or {}).get("length_scale", 1.0)),
            1e-6),
    }


@dataclass
class PiperVoice:
    spec: Any
    params: Any
    id_map: dict[str, list[int]]
    phoneme_type: str = "espeak"
    espeak_voice: str = "en-us"

    @classmethod
    def load(cls, onnx_path: str, device: Any = None) -> "PiperVoice":
        from .vits import build_vits_params

        cfg_path = onnx_path + ".json"
        if not os.path.exists(cfg_path):
            base = os.path.splitext(onnx_path)[0]
            cfg_path = base + ".json"
        if not os.path.exists(cfg_path):
            raise ValueError(
                f"piper voice {onnx_path} has no sidecar json config "
                "(<voice>.onnx.json)")
        with open(cfg_path) as f:
            pcfg = json.load(f)
        if int(pcfg.get("num_speakers", 1) or 1) > 1:
            raise ValueError(
                "multi-speaker piper voices are not supported yet; "
                "export or choose a single-speaker voice")
        tensors = read_onnx_initializers(onnx_path)
        if "enc_p.emb.weight" not in tensors:
            raise ValueError(
                f"{onnx_path} does not look like a piper VITS export "
                "(no enc_p.emb.weight initializer)")
        config = _infer_config(tensors, pcfg)

        def get(hf_name: str):
            pn = _piper_name(hf_name)
            if pn is None or pn not in tensors:
                raise KeyError(hf_name)
            arr = tensors[pn]
            if hf_name.endswith(
                    ("q_proj.weight", "k_proj.weight", "v_proj.weight",
                     "out_proj.weight")):
                arr = arr[..., 0]  # 1x1 conv -> the HF linear layout
            return arr

        names = [hf for hf in _hf_names_for(config)
                 if (_piper_name(hf) or "") in tensors]
        spec, params = build_vits_params(config, get, names, device)
        return cls(
            spec=spec, params=params,
            id_map={k: list(v) for k, v in
                    (pcfg.get("phoneme_id_map") or {}).items()},
            phoneme_type=str(pcfg.get("phoneme_type", "espeak")),
            espeak_voice=str((pcfg.get("espeak") or {}
                              ).get("voice", "en-us")),
        )

    def phoneme_ids(self, text: str) -> np.ndarray:
        """piper framing: ^ <pad-interspersed phoneme ids> $."""
        phonemes = (list(text) if self.phoneme_type == "text"
                    else _phonemize(text, self.espeak_voice))
        ids: list[int] = []
        ids += self.id_map.get("^", [1])
        pad = self.id_map.get("_", [0])
        for ph in phonemes:
            pid = self.id_map.get(ph)
            if not pid:
                continue  # piper skips unknown phonemes too
            ids += pad
            ids += pid
        ids += pad
        ids += self.id_map.get("$", [2])
        return np.asarray(ids, np.int32)

    def synthesize(self, text: str, seed: int = 0) -> np.ndarray:
        from .vits import synthesize

        return synthesize(self.spec, self.params, self.phoneme_ids(text),
                          seed=seed)


def _hf_names_for(config: dict) -> list[str]:
    """The optional-presence names build_vits_params probes via its
    nameset (cond layers, post/resblock biases); enumerating only these
    keeps the shim honest without materializing every tensor name."""
    out = []
    for i in range(int(config["prior_encoder_num_flows"])):
        out.append(f"flow.flows.{i}.conv_post.bias")
        out.append(f"flow.flows.{i}.wavenet.cond_layer.bias")
    out += ["duration_predictor.cond.weight", "decoder.cond.weight",
            "decoder.conv_post.bias"]
    n_res = (len(config["upsample_rates"])
             * len(config["resblock_kernel_sizes"]))
    n_dil = max(len(d) for d in config["resblock_dilation_sizes"])
    for i in range(n_res):
        for j in range(n_dil):
            out.append(f"decoder.resblocks.{i}.convs1.{j}.bias")
            out.append(f"decoder.resblocks.{i}.convs2.{j}.bias")
    return out


# ----------------------------------------------------------- phonemize

# tiny approximate English grapheme->IPA fallback for when espeak-ng is
# not installed (the reference ships espeak data as a backend asset;
# this image has no espeak binary). Digraphs first, then single letters.
_G2P_DIGRAPHS = [
    ("tch", "tʃ"), ("sh", "ʃ"), ("ch", "tʃ"), ("th", "θ"), ("ph", "f"),
    ("wh", "w"), ("ng", "ŋ"), ("qu", "kw"), ("oo", "uː"), ("ee", "iː"),
    ("ea", "iː"), ("ou", "aʊ"), ("ow", "aʊ"), ("ai", "eɪ"), ("ay", "eɪ"),
    ("oi", "ɔɪ"), ("oy", "ɔɪ"), ("ck", "k"),
]
_G2P_SINGLE = {
    "a": "æ", "b": "b", "c": "k", "d": "d", "e": "ɛ", "f": "f",
    "g": "ɡ", "h": "h", "i": "ɪ", "j": "dʒ", "k": "k", "l": "l",
    "m": "m", "n": "n", "o": "ɒ", "p": "p", "q": "k", "r": "ɹ",
    "s": "s", "t": "t", "u": "ʌ", "v": "v", "w": "w", "x": "ks",
    "y": "j", "z": "z", " ": " ", ",": ",", ".": ".", "?": "?",
    "!": "!",
}


def _g2p_fallback(text: str) -> list[str]:
    out: list[str] = []
    s = text.lower()
    i = 0
    while i < len(s):
        for di, ph in _G2P_DIGRAPHS:
            if s.startswith(di, i):
                out.extend(ph)
                i += len(di)
                break
        else:
            out.extend(_G2P_SINGLE.get(s[i], ""))
            i += 1
    return out


def _phonemize(text: str, voice: str) -> list[str]:
    """espeak-ng IPA phonemization when the binary exists (what piper
    itself uses), else the built-in approximation."""
    try:
        res = subprocess.run(
            ["espeak-ng", "-q", "--ipa=3", "-v", voice, text],
            capture_output=True, check=True, timeout=30,
        )
        ipa = res.stdout.decode().strip().replace("\n", " ")
        # --ipa=3 separates phonemes with underscores; piper's id map
        # keys are SINGLE codepoints, so clusters (diphthongs 'aɪ',
        # length marks 'iː', stress-marked onsets) must be emitted per
        # codepoint, exactly as piper-phonemize does
        phs: list[str] = []
        for word in ipa.split():
            if phs:
                phs.append(" ")
            for p in word.split("_"):
                phs.extend(p)
        return phs
    except (OSError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired):
        return _g2p_fallback(text)
