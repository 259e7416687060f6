"""A sentencepiece-style Unigram model with no ``tokenizers`` package.

``UnigramModel`` tokenizes one pre-tokenized piece as ``tokenizers``'
``models.Unigram`` (0.22) does, id for id: the best-scoring segmentation
by Viterbi over the vocabulary's log-probability scores (f64 sums), ties
kept by the first candidate found (earlier start, then shorter token), a
character no token starts with scored as unknown at the lowest score
minus 10, runs of unknowns fused into one piece, and each unknown piece
spelled by its ``<0xNN>`` byte tokens when all of them exist (byte
fallback), else the unknown id. A token string that appears twice in the
vocabulary resolves to its last id, whose score the lattice uses.

The GGUF tokenizer (``models/gguf.py``) puts it behind the Metaspace
pre-tokenizer and the ByteFallback + Metaspace decoder of
``engine/bpe.py``.
"""

from __future__ import annotations

from typing import Optional

K_UNK_PENALTY = 10.0
_WORD_CACHE_MAX = 1 << 16
_END = ""  # the trie key that marks a whole token


class UnigramModel:
    def __init__(self, vocab: list[tuple[str, float]],
                 unk_id: Optional[int], byte_fallback: bool = False) -> None:
        if not vocab:
            raise ValueError("Unigram vocabulary is empty")
        if unk_id is not None and not 0 <= unk_id < len(vocab):
            raise ValueError(f"Unigram unk id {unk_id} is not in the "
                             f"vocabulary of {len(vocab)}")
        self.pieces = [(t, float(s)) for t, s in vocab]
        self.unk_id = unk_id
        self.byte_fallback = byte_fallback
        self.vocab: dict[str, int] = {}
        self.trie: dict = {}
        for i, (tok, _) in enumerate(self.pieces):
            self.vocab[tok] = i
            node = self.trie
            for ch in tok:
                node = node.setdefault(ch, {})
            node[_END] = True
        self.vocab_r = {i: t for i, (t, _) in enumerate(self.pieces)}
        self.min_score = min(s for _, s in self.pieces)
        self._cache: dict[str, list[int]] = {}

    def _segment(self, text: str) -> list[str]:
        """The best path's pieces, unknown runs fused."""
        n = len(text)
        unk_score = self.min_score - K_UNK_PENALTY
        # per end position: (best score, start or None, id)
        best: list[list] = [[0.0, None, 0] for _ in range(n + 1)]
        for start in range(n):
            here = best[start][0]
            single = False
            node = self.trie
            for end in range(start, n):
                node = node.get(text[end])
                if node is None:
                    break
                if _END in node:
                    tid = self.vocab[text[start:end + 1]]
                    cand = self.pieces[tid][1] + here
                    tgt = best[end + 1]
                    if tgt[1] is None or cand > tgt[0]:
                        tgt[0], tgt[1], tgt[2] = cand, start, tid
                    if end == start:
                        single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram: a character no token covers "
                                     "and no unk id")
                cand = unk_score + here
                tgt = best[start + 1]
                if tgt[1] is None or cand > tgt[0]:
                    tgt[0], tgt[1], tgt[2] = cand, start, self.unk_id
        out: list[str] = []
        unk: list[str] = []
        end = n
        while end > 0:
            start = best[end][1]
            piece = text[start:end]
            if self.unk_id is not None and best[end][2] == self.unk_id:
                unk.append(piece)
            else:
                if unk:
                    out.append("".join(reversed(unk)))
                    unk = []
                out.append(piece)
            end = start
        if unk:
            out.append("".join(reversed(unk)))
        out.reverse()
        return out

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids: list[int] = []
        for piece in self._segment(word):
            tid = self.vocab.get(piece)
            if tid is None:
                if self.byte_fallback:
                    bs = [self.vocab.get(f"<0x{b:02X}>")
                          for b in piece.encode("utf-8")]
                    if all(b is not None for b in bs):
                        ids.extend(bs)
                        continue
                if self.unk_id is None:
                    raise ValueError(f"Unigram: no id for {piece!r}")
                tid = self.unk_id
            ids.append(tid)
        if len(self._cache) >= _WORD_CACHE_MAX:
            self._cache.clear()
        self._cache[word] = ids
        return ids
