"""Embeddings worker (counterpart of localai_tfp_tpu/workers/
embeddings.py; ref: the reference serves /v1/embeddings through
sentence-transformers, backend/python/transformers/backend.py:286-324).

An encoder checkpoint (BERT / MiniLM family, ``models/encoder.py``):
each text encoded with its special tokens, cut at the checkpoint's
positions, padded to the next length bucket, then masked mean pool and
L2 normalisation (sentence-transformers' semantics).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.encoder import encode, mean_pool
from .base import EmbeddingResult, PredictOptions
from .encoder_base import EncoderWorkerBase


class TorchEmbeddingsBackend(EncoderWorkerBase):
    LEN_BUCKETS = (16, 64, 128, 256, 512)

    def embed_ids(self, toks: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
        """Pooled, normalised embeddings [B, D] of padded ids on the
        device."""
        with torch.inference_mode():
            return mean_pool(encode(self.spec, self.params, toks, mask), mask)

    def embed_batch(self, texts: list[str]) -> np.ndarray:
        self._ready()
        ids = [self.tokenizer.encode_special(t)[: self.spec.max_position]
               or [0] for t in texts]
        toks, mask, _ = self._batch(ids)
        out = self.embed_ids(self._on_device(toks), self._on_device(mask))
        return out.cpu().numpy().astype(np.float32)

    def embedding(self, opts: PredictOptions) -> EmbeddingResult:
        vec = self.embed_batch([opts.embeddings or opts.prompt])[0]
        return EmbeddingResult(embeddings=[float(x) for x in vec])
