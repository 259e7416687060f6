"""Token-by-token generation for the recurrent families (Mamba, RWKV).

A recurrent model has no KV cache: its state is a few fixed-size tensors
per layer, and ``step(token, state)`` gives the next logits and state.
The JAX package runs its prefill and its decode as one ``lax.scan``
dispatch each; on a card the counterpart is a CUDA graph per step that
touches only static buffers, so a token costs one graph replay and no
host read.

``StepRunner`` holds those buffers (the token, the state, the logits, the
picks' Gumbel noise and temperature, and the picked tokens) and two
bodies over them:

- ``feed``: one step on the token in the token buffer (prefill);
- ``decode``: pick the next token from the logits buffer, ``argmax(
  logits / temperature + noise[i])`` with i the on-device counter
  (noise zeros and temperature 1 for greedy: the argmax), write it to
  the token buffer and to output row i, then step on it. As in the JAX
  ``_decode_jit``, the step after the last pick is run too. A sampled
  request's draws are made ``READ_EVERY`` rows at a time, so its
  memory does not grow with ``max_tokens``.

On a card each body is captured once into a CUDA graph (``capture``);
on the CPU, or with ``eager=True``, the bodies run as they are. The host
reads the picked tokens every ``READ_EVERY`` tokens and stops at the
first EOS (the JAX package runs every step and trims after, with the
same tokens). One runner serves one generation at a time.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..ops.sampling import _gumbel

READ_EVERY = 32  # tokens between two host reads of the picked tokens


class StepRunner:
    """Static buffers and (on a card) the graphs of one model's step."""

    def __init__(self, step: Callable, init_state: Callable[[], tuple],
                 vocab_size: int, device: Any, eager: bool = False) -> None:
        self._step = step
        self._init = init_state
        self.device = torch.device(device)
        self.vocab_size = vocab_size
        self.state = tuple(t.clone() for t in init_state())
        dev = self.device
        self.tok = torch.zeros(1, dtype=torch.long, device=dev)
        self.logits = torch.zeros(vocab_size, dtype=torch.float32, device=dev)
        # the Gumbel draws of the picks between two host reads, row i for
        # the i-th (zeros for greedy): a request's draws never take more
        self.noise = torch.zeros((READ_EVERY, vocab_size),
                                 dtype=torch.float32, device=dev)
        self.temp = torch.ones(1, dtype=torch.float32, device=dev)
        self.out = torch.zeros(READ_EVERY, dtype=torch.long, device=dev)
        self.at = torch.zeros(1, dtype=torch.long, device=dev)
        self.graphs: dict[str, Any] = {}
        self.eager = eager or dev.type != "cuda"
        self.replays = 0
        self._lock = threading.Lock()

    # ---------------------------------------------------------- bodies

    def _feed_body(self) -> None:
        logits, state = self._step(self.tok, self.state)
        self.logits.copy_(logits)
        for dst, src in zip(self.state, state):
            dst.copy_(src)

    def _decode_body(self) -> None:
        noise = self.noise.index_select(0, self.at)[0]
        nxt = torch.argmax(self.logits / self.temp + noise)
        self.tok.copy_(nxt.reshape(1))
        self.out.index_copy_(0, self.at, self.tok)
        self.at.add_(1)
        self._feed_body()

    def capture(self) -> None:
        """Capture both bodies into CUDA graphs (a card, not ``eager``):
        each body runs once on a side stream first, then the state is
        reset."""
        if self.eager or self.graphs:
            return
        s = torch.cuda.Stream(self.device)
        with torch.inference_mode():
            for name, body in (("feed", self._feed_body),
                               ("decode", self._decode_body)):
                s.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(s):
                    body()
                torch.cuda.current_stream(self.device).wait_stream(s)
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, stream=s):
                    body()
                self.graphs[name] = g
        self._reset()

    def _run(self, name: str) -> None:
        g = self.graphs.get(name)
        if g is None:
            (self._feed_body if name == "feed" else self._decode_body)()
        else:
            g.replay()
            self.replays += 1

    def _reset(self) -> None:
        for dst, src in zip(self.state, self._init()):
            dst.copy_(src)
        self.at.zero_()

    # ------------------------------------------------------- generation

    @torch.inference_mode()
    def generate(self, prompt_ids: list[int], max_tokens: int,
                 temperature: float = 0.0, seed: int = 0,
                 eos_id: Optional[int] = None,
                 noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """Prefill the prompt token by token, then pick up to
        ``max_tokens`` tokens; trimmed after the first ``eos_id``.
        ``noise`` ([max_tokens, V] Gumbel draws) replaces the draws a
        sampled request makes from ``seed``, ``READ_EVERY`` rows at a
        time into the static noise buffer (tests inject the JAX
        package's)."""
        if not prompt_ids:
            raise ValueError("empty prompt")
        with self._lock:
            self.capture()
            dev = self.device
            self._reset()
            prompt = torch.tensor(prompt_ids, dtype=torch.long, device=dev)
            for i in range(len(prompt_ids)):
                self.tok.copy_(prompt[i:i + 1])
                self._run("feed")
            sampled = temperature > 0
            self.temp.fill_(float(temperature) if sampled else 1.0)
            self.noise.zero_()
            gen = None
            if not sampled:
                noise = None  # greedy: the argmax, whatever was given
            elif noise is None:
                gen = torch.Generator(device=dev).manual_seed(int(seed))
            else:
                noise = noise.to(device=dev, dtype=torch.float32)
            toks: list[int] = []
            done = 0
            while done < max_tokens:
                n = min(READ_EVERY, max_tokens - done)
                self.at.zero_()
                if gen is not None:  # the next READ_EVERY draws
                    self.noise.copy_(_gumbel(self.noise.uniform_(
                        generator=gen)))
                elif noise is not None:
                    self.noise[:n].copy_(noise[done:done + n])
                for _ in range(n):
                    self._run("decode")
                toks += self.out[:n].tolist()
                done += n
                if eos_id is not None and eos_id in toks:
                    break
            out = np.asarray(toks[:max_tokens], np.int64)
        if eos_id is not None:
            stop = np.nonzero(out == eos_id)[0]
            if len(stop):
                out = out[: int(stop[0]) + 1]
        return out
