"""The port's Mamba and RWKV against the JAX package's.

Tiny ``save_pretrained`` checkpoints (f32, vocabulary 300 so the byte
tokenizer's ids fit):

- both loaders give the same tree (bitwise) and ``forward`` the same
  logits (f32, within 1e-5); the port's ``step`` threaded over the
  prompt gives its own ``forward``'s;
- greedy ``generate`` ids equal the JAX ones, with and without an EOS
  (trimmed after it); sampled ids equal the JAX ones when the port is
  given the JAX draws' Gumbel noise (``jax.random`` is not torch's RNG);
- the JAX worker and the port's worker, and both HTTP servers, answer
  the same chat with the same text, streamed and not.
"""

import asyncio
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from localai_tfp_tpu.models import mamba as jmamba
from localai_tfp_tpu.models import rwkv as jrwkv
from localai_tfp_tpu_torch.models import mamba, rwkv

TOL = 1e-5  # f32 logits, both sides


def mamba_checkpoint(d):
    from transformers import MambaConfig, MambaForCausalLM

    torch.manual_seed(0)
    MambaForCausalLM(MambaConfig(
        vocab_size=300, hidden_size=32, state_size=8, num_hidden_layers=2,
        conv_kernel=4, expand=2, time_step_rank=4, use_cache=False,
    )).save_pretrained(d, safe_serialization=True)


def rwkv_checkpoint(d):
    from transformers import RwkvConfig, RwkvForCausalLM

    torch.manual_seed(0)
    RwkvForCausalLM(RwkvConfig(
        vocab_size=300, hidden_size=32, num_hidden_layers=3,
        attention_hidden_size=32, intermediate_size=64, context_length=64,
        rescale_every=2, use_cache=False,  # the /2 ladder
    )).save_pretrained(d, safe_serialization=True)


FAMILIES = {
    "mamba": (mamba_checkpoint, jmamba, mamba),
    "rwkv": (rwkv_checkpoint, jrwkv, rwkv),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("recurrent")
    for name, (make, _, _) in FAMILIES.items():
        make(root / "models" / name)
        (root / "models" / f"{name}.yaml").write_text(json.dumps({
            "name": name, "backend": "torch-llm",
            "parameters": {"model": name, "temperature": 0.0,
                           "max_tokens": 12},
            "context_size": 256, "dtype": "float32"}))
    return root


def _load(root, name):
    _, jmod, mod = FAMILIES[name]
    d = str(root / "models" / name)
    jspec, jp = (jmod.load_rwkv(d) if name == "rwkv"
                 else jmod.load_mamba(d, dtype=jnp.float32))
    spec, p = (mod.load_rwkv(d) if name == "rwkv"
               else mod.load_mamba(d, dtype=torch.float32))
    return jspec, jp, spec, p


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{pre}{k}.")
        else:
            yield pre + k, v


IDS = [3, 17, 55, 9, 101, 2, 44, 250, 7]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_trees_and_logits_match_jax(root, name):
    _, jmod, mod = FAMILIES[name]
    jspec, jp, spec, p = _load(root, name)
    assert spec.__dict__ == jspec.__dict__
    want_tree = dict(_leaves(jp))
    got_tree = dict(_leaves(p))
    assert sorted(got_tree) == sorted(want_tree)
    for k, v in want_tree.items():
        assert np.array_equal(got_tree[k].numpy(), np.asarray(v)), k
    want = np.asarray(jmod.forward(jspec, jp, jnp.asarray(IDS, jnp.int32)))
    got = mod.forward(spec, p, torch.tensor(IDS))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the serving recurrence reproduces the forward
    state = mod.init_state(spec)
    rows = []
    for t in IDS:
        lg, state = mod.step(spec, p, t, state)
        rows.append(lg)
    np.testing.assert_allclose(torch.stack(rows).numpy(), want, rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_greedy_ids_and_eos_trim_match_jax(root, name):
    _, jmod, mod = FAMILIES[name]
    jspec, jp, spec, p = _load(root, name)
    want = jmod.generate(jspec, jp, IDS, 20)
    got = mod.generate(spec, p, IDS, 20)
    assert got.tolist() == np.asarray(want).tolist() and len(got) == 20
    eos = int(want[5])  # trimmed after its first occurrence
    want = jmod.generate(jspec, jp, IDS, 20, eos_id=eos)
    got = mod.generate(spec, p, IDS, 20, eos_id=eos)
    assert got.tolist() == np.asarray(want).tolist()
    assert got[-1] == eos and len(got) <= 6


def _jax_gumbel(seed: int, steps: int, vocab: int) -> np.ndarray:
    """The Gumbel draws the JAX ``_decode_jit`` makes: one split of the
    key per step, ``categorical`` = argmax(gumbel + logits)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (vocab,), jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sampled_ids_match_jax_with_its_draws(root, name):
    _, jmod, mod = FAMILIES[name]
    jspec, jp, spec, p = _load(root, name)
    want = jmod.generate(jspec, jp, IDS, 16, temperature=0.8, seed=3)
    noise = torch.from_numpy(_jax_gumbel(3, 16, spec.vocab_size))
    got = mod.generate(spec, p, IDS, 16, temperature=0.8, noise=noise)
    assert got.tolist() == np.asarray(want).tolist()
    # the port's own draws are seeded: the same seed, the same ids
    a = mod.generate(spec, p, IDS, 16, temperature=0.8, seed=3)
    b = mod.generate(spec, p, IDS, 16, temperature=0.8, seed=3)
    assert a.tolist() == b.tolist()


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sampled_draws_do_not_grow_with_max_tokens(root, name):
    """A sampled request's draws come READ_EVERY rows at a time: a
    max_tokens whose [max_tokens, V] draws no host could hold (10**9 x
    300 f32, 1.2 TB) serves, with the ids of a short request of the same
    seed up to its EOS, and the noise buffer stays [READ_EVERY, V]."""
    from localai_tfp_tpu_torch.models.recurrent import READ_EVERY

    _, _, mod = FAMILIES[name]
    _, _, spec, p = _load(root, name)
    run = mod.runner(spec, p, "cpu", eager=True)
    short = run.generate(IDS, 3 * READ_EVERY, temperature=1.5, seed=5)
    # an EOS that first appears past the first host read
    eos = next(int(t) for i, t in enumerate(short)
               if i >= READ_EVERY and t not in short[:i])
    got = run.generate(IDS, 10 ** 9, temperature=1.5, seed=5, eos_id=eos)
    stop = short.tolist().index(eos)
    assert got.tolist() == short[:stop + 1].tolist()
    assert tuple(run.noise.shape) == (READ_EVERY, spec.vocab_size)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_workers_answer_alike(root, name):
    from localai_tfp_tpu.workers.base import ModelLoadOptions as JOpts
    from localai_tfp_tpu.workers.base import PredictOptions as JPred
    from localai_tfp_tpu.workers.llm import JaxLLMBackend
    from localai_tfp_tpu_torch.workers.base import (ModelLoadOptions,
                                                    PredictOptions)
    from localai_tfp_tpu_torch.workers.llm import TorchLLMBackend

    kw = dict(model=name, model_path=str(root / "models"), dtype="float32")
    j = JaxLLMBackend()
    assert j.load_model(JOpts(**kw)).success
    b = TorchLLMBackend("cpu")
    res = b.load_model(ModelLoadOptions(**kw))
    try:
        assert res.success and name in res.message, res.message
        assert b.engine is None and b.recurrent is not None
        for opts in (dict(prompt="ab", tokens=10, ignore_eos=True),
                     dict(prompt="hello there", tokens=8),
                     dict(prompt="xy", tokens=12, ignore_eos=True,
                          stop_prompts=["\x01"])):
            want = j.predict(JPred(**opts))
            got = b.predict(PredictOptions(**opts))
            assert (got.message, got.tokens, got.prompt_tokens,
                    got.finish_reason) == (want.message, want.tokens,
                                           want.prompt_tokens,
                                           want.finish_reason)
            chunks = list(b.predict_stream(PredictOptions(**opts)))
            assert chunks[-1].finish_reason == want.finish_reason
            assert "".join(c.message for c in chunks[:-1]) == want.message
    finally:
        b.shutdown()
        j.shutdown()


def _jax_chats(root, bodies: list) -> list:
    from aiohttp.test_utils import TestClient, TestServer

    from localai_tfp_tpu.config.app_config import ApplicationConfig
    from localai_tfp_tpu.server.app import build_app
    from localai_tfp_tpu.server.state import Application

    jdir = root / "jax_models"
    jdir.mkdir(exist_ok=True)
    for name in FAMILIES:
        cfg = json.loads((root / "models" / f"{name}.yaml").read_text())
        (jdir / f"{name}.yaml").write_text(json.dumps(
            {**cfg, "backend": "jax-llm"}))
        if not (jdir / name).exists():
            (jdir / name).symlink_to(root / "models" / name)
    loop = asyncio.new_event_loop()
    state = Application(ApplicationConfig(
        models_path=str(jdir), generated_content_dir=str(root / "gen"),
        upload_dir=str(root / "up"), config_dir=str(root / "conf")))
    tc = TestClient(TestServer(build_app(state)), loop=loop)
    loop.run_until_complete(tc.start_server())

    async def go(body):
        r = await tc.request("POST", "/v1/chat/completions", json=body)
        return r.status, await r.read()

    try:
        return [loop.run_until_complete(go(b)) for b in bodies]
    finally:
        loop.run_until_complete(tc.close())
        loop.close()


def _port_chats(root, bodies: list) -> list:
    from localai_tfp_tpu_torch.server.app import build_server

    srv = build_server(str(root / "models"), port=0, device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    out = []
    try:
        for body in bodies:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}"
                "/v1/chat/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                out.append((r.status, r.read()))
    finally:
        srv.close()
        th.join(timeout=30)
    return out


def _answer(raw: bytes, stream: bool) -> tuple:
    if not stream:
        o = json.loads(raw)
        return (o["choices"][0]["message"]["content"],
                o["choices"][0]["finish_reason"], o["usage"])
    frames = [json.loads(line[6:]) for line in raw.decode().splitlines()
              if line.startswith("data: {")]
    return ("".join(f["choices"][0]["delta"].get("content") or ""
                    for f in frames),
            frames[-1]["choices"][0]["finish_reason"])


def test_servers_answer_recurrent_chats_alike(root):
    bodies = [{"model": name, "stream": stream, "ignore_eos": True,
               "messages": [{"role": "user", "content": "Say hi."}]}
              for name in sorted(FAMILIES) for stream in (False, True)]
    want = _jax_chats(root, bodies)
    got = _port_chats(root, bodies)
    for body, (js, jraw), (ps, praw) in zip(bodies, want, got):
        assert js == ps == 200
        assert _answer(praw, body["stream"]) == _answer(jraw, body["stream"])
