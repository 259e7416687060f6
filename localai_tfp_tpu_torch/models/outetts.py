"""OuteTTS-class LLM-driven text-to-speech: the port's counterpart of
localai_tfp_tpu/models/outetts.py (ref: backend/python/transformers/
backend.py:205-233, :509-527, ``type: OuteTTS``).

A causal LM whose vocabulary holds per-frame audio-code tokens reads the
text as a prompt and emits code tokens; the EnCodec-layout decoder under
the model directory's ``codec/`` (``models/encodec.py``) turns them into a
waveform. A speaker profile (a transcript and its codes) is prepended to
the prompt, as the JAX module does.

The LM runs through the port's ``LLMEngine`` (the paged engine the chat
path serves from: the ragged paged attention kernel on the card, and the
int8 product when ``quantization`` asks for int8 weights), with its step
graphs captured at load (``LOCALAI_WARMUP``). The engine is the TTS
worker's own: outside the weight pager and the KV tier. Code tokens are
read from the tokenizer's vocabulary strings (``<|c_123|>`` /
``<|123|>``), added tokens included.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..config import knobs
from ..device import resolve
from .encodec import encodec_decode, load_encodec_decoder

# matches <|c_123|> and <|123|> but not <|t_0.23|> / <|text_end|>
_CODE_RE = re.compile(r"^<\|(?:c_)?(\d+)\|>$")


@dataclass
class OuteTTSModel:
    engine: Any
    tokenizer: Any
    codec: dict
    ratios: list
    model_dir: str = ""
    sample_rate: int = 24000
    n_q: int = 1  # codebooks per frame in the token stream
    code_ids: dict = field(default_factory=dict)  # token id -> code

    @classmethod
    def load(cls, model_dir: str, dtype: torch.dtype = torch.bfloat16,
             n_slots: int = 2, device: Any = None,
             quantization: str = "") -> "OuteTTSModel":
        from ..engine.engine import LLMEngine
        from ..engine.tokenizer import load_tokenizer
        from ..ops import _build
        from ..ops import int8_matmul, ragged_paged_attention as rpa
        from .hf_loader import load_params
        from .safetensors_io import SafeTensorsFile

        dev = resolve(device)
        codec_dir = os.path.join(model_dir, "codec")
        if not os.path.isdir(codec_dir):
            raise ValueError(
                f"{model_dir} has no codec/ directory (EnCodec-layout "
                "audio codec) — an OuteTTS-class model needs one to "
                "decode its audio tokens")
        sd: dict = {}
        for fname in sorted(os.listdir(codec_dir)):
            if fname.endswith(".safetensors"):
                f = SafeTensorsFile(os.path.join(codec_dir, fname))
                for key in f.keys():
                    sd[key] = f.get(key)
        codec = load_encodec_decoder(sd, prefix="", device=dev)
        with open(os.path.join(codec_dir, "config.json")) as f:
            ccfg = json.load(f)
        tok = load_tokenizer(model_dir)
        # the audio-code token table from the vocabulary strings
        code_ids: dict[int, int] = {}
        vocab = tok.get_vocab() if hasattr(tok, "get_vocab") else {}
        for token, tid in vocab.items():
            m = _CODE_RE.match(token)
            if m:
                code_ids[tid] = int(m.group(1))
        if not code_ids:
            raise ValueError(
                "tokenizer has no audio code tokens (<|c_N|>/<|N|>) — "
                "not an OuteTTS-class vocabulary")
        spec, params = load_params(model_dir, dtype=dtype, device=dev,
                                   quantize=quantization)
        if dev.type == "cuda":  # the kernels' first-use build, here
            _build.build_all([rpa.KERNEL] + (
                [int8_matmul.KERNEL] if quantization else []))
        engine = LLMEngine(spec, params, tok, n_slots=n_slots,
                           max_seq=min(spec.max_position, 4096),
                           cache_dtype=dtype, device=dev, model=model_dir,
                           kv_tier=False, weight_paging=False)
        if knobs.flag("LOCALAI_WARMUP"):
            engine.warmup()
        return cls(
            engine=engine, tokenizer=tok, codec=codec,
            ratios=list(ccfg.get("upsampling_ratios", [8, 5, 4, 2])),
            model_dir=model_dir,
            sample_rate=int(ccfg.get("sampling_rate", 24000)),
            code_ids=code_ids,
        )

    def _prompt(self, text: str, speaker: Optional[dict]) -> str:
        parts = ["<|im_start|>\n"]
        if speaker:
            parts.append(str(speaker.get("text", "")).strip() + " ")
        parts.append(text.strip())
        parts.append("<|text_end|>\n<|audio_start|>\n")
        if speaker:
            parts.extend(f"<|c_{int(c)}|>"
                         for c in speaker.get("codes", []))
        return "".join(parts)

    def generate(self, text: str, speaker: Optional[dict] = None,
                 temperature: float = 0.4, seed: Optional[int] = 0,
                 max_tokens: int = 1024) -> str:
        """The LM's whole output text for ``text`` (the done event's):
        until <|audio_end|>/EOS or the budget, sampled at ``temperature``
        with top-k 64 (0: greedy). The JAX module collects the streamed
        events' ``token_id`` instead, which is one id a multi-token step:
        it keeps one code of every decode dispatch (ROADMAP §C 16)."""
        from ..engine.engine import GenRequest

        ids = self.tokenizer.encode(self._prompt(text, speaker),
                                    add_bos=True)
        q = self.engine.submit(GenRequest(
            prompt_ids=ids, max_tokens=max_tokens,
            temperature=temperature, top_k=64, top_p=1.0, seed=seed,
            ignore_eos=False,
        ))
        while True:
            ev = q.get()
            if ev.done:
                if ev.error:
                    raise RuntimeError(
                        f"audio LM generation failed: {ev.error}")
                return ev.full_text

    def codes(self, generated: str) -> np.ndarray:
        """The audio codes of the generated text as [n_q, frames]: its
        code tokens (added tokens, so re-encoding the text gives back
        exactly the ids generated for them); other tokens are skipped, as
        the reference's interface skips them."""
        codes = [self.code_ids[t] for t in self.tokenizer.encode(generated)
                 if t in self.code_ids]
        if not codes:
            # a content-free generation must be audible as an error,
            # not silence of plausible length
            raise RuntimeError(
                "model generated no audio code tokens for this prompt")
        n_q = max(1, self.n_q)
        frames = len(codes) // n_q
        return np.asarray(codes[: frames * n_q],
                          np.int32).reshape(frames, n_q).T

    def synthesize(self, text: str, speaker: Optional[dict] = None,
                   temperature: float = 0.4, seed: Optional[int] = 0,
                   max_tokens: int = 1024) -> np.ndarray:
        """text -> waveform [samples] f32 (host)."""
        generated = self.generate(text, speaker, temperature, seed,
                                  max_tokens)
        return encodec_decode(self.codec, self.codes(generated),
                              self.ratios)

    def close(self) -> None:
        """Stop the engine and free its device memory (weights, KV arena,
        graphs); the codec's tensors go with the model object."""
        if self.engine is not None:
            self.engine.close()
            self.engine.release()
            self.engine = None
        self.codec = {}


def load_speaker(path: str) -> dict:
    """OuteTTS speaker profile json: {"text": ..., "codes": [...]} (flat)
    or the word-granular {"words": [{"word", "codes"}]} layout."""
    with open(path) as f:
        data = json.load(f)
    if "words" in data and "codes" not in data:
        data = {
            "text": " ".join(w.get("word", "") for w in data["words"]),
            "codes": [c for w in data["words"]
                      for c in w.get("codes", [])],
        }
    return data
