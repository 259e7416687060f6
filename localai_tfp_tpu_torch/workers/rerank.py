"""Rerank worker (counterpart of localai_tfp_tpu/workers/rerank.py; ref:
backend/python/rerankers/backend.py, Jina-style ``/v1/rerank``).

Two scoring modes, decided by the checkpoint:
- a cross-encoder (a classifier head): the head over ``[CLS] query [SEP]
  document [SEP]`` with type 1 on the document half. One class gives the
  raw logit; more give the last class's margin against the log-sum-exp
  of the others (monotone in P(relevant));
- any other checkpoint: the cosine between the masked mean-pooled
  embeddings of the query and each document.

Results are ordered by ``argsort(-scores)`` and cut to ``top_n``;
``usage`` counts the tokens encoded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.encoder import classify, encode, mean_pool
from .base import DocumentResult, RerankResult
from .encoder_base import EncoderWorkerBase


class TorchRerankBackend(EncoderWorkerBase):
    def _scores(self, query: str,
                documents: list[str]) -> tuple[np.ndarray, int]:
        """(scores, tokens encoded)."""
        tk = self.tokenizer
        dev = self._on_device
        if self.spec.n_classes:  # [CLS] q [SEP] d [SEP]
            pairs = [tk.encode_pair(query, d) for d in documents]
            toks, mask, types = self._batch([p[0] for p in pairs],
                                            [p[1] for p in pairs])
            m = dev(mask)
            with torch.inference_mode():
                hidden = encode(self.spec, self.params, dev(toks), m,
                                dev(types))
                logits = classify(self.spec, self.params, hidden)
            logits = logits.cpu().numpy().astype(np.float32)
            n_tok = sum(len(p[0]) for p in pairs)
            if logits.shape[1] == 1:
                return logits[:, 0], n_tok
            rest = logits[:, :-1]
            mx = rest.max(axis=-1)
            lse = mx + np.log(np.exp(rest - mx[:, None]).sum(axis=-1))
            return logits[:, -1] - lse, n_tok
        seqs = [tk.encode_special(query)] + [tk.encode_special(d)
                                             for d in documents]
        toks, mask, _ = self._batch(seqs)
        m = dev(mask)
        with torch.inference_mode():
            embs = mean_pool(encode(self.spec, self.params, dev(toks), m), m)
        embs = embs.cpu().numpy().astype(np.float32)
        return embs[1:] @ embs[0], sum(len(s) for s in seqs)

    def rerank(self, query: str, documents: list[str],
               top_n: int = 0) -> RerankResult:
        self._ready()
        if not documents:
            return RerankResult()
        scores, n_tok = self._scores(query, documents)
        order = np.argsort(-scores)[: top_n or len(documents)]
        return RerankResult(
            results=[DocumentResult(index=int(i), text=documents[int(i)],
                                    relevance_score=float(scores[int(i)]))
                     for i in order],
            usage={"total_tokens": n_tok, "prompt_tokens": n_tok})
