"""The port's vector stores (localai_tfp_tpu_torch/store/: the native
C++ store, csrc/vecstore.cpp, and the Python one) against the JAX
package's, through ``/stores/{set,get,delete,find}`` on both servers and
directly.

- The routes: set, get, delete and find through the ``default-store``
  (registered at its first use) and a named store, an upsert on an equal
  key, a width mismatch (500 with the same message), an unknown key;
  bodies equal, similarities within 1e-5. The typed client
  (``clients/store.py``) reads the port's server.
- The Python store below and above its device threshold (lowered through
  the module attribute ``_DEVICE_THRESHOLD``; on the CPU the "device"
  matvec is torch's) and the native store give the same keys, values and
  order as the JAX ``VectorStore``, similarities within 1e-5 of a numpy
  f64 reference, for unit-norm keys (the dot-product fast path) and for
  keys of any norm (the full cosine).
- ``LOCALAI_NATIVE_STORE`` picks the store; the native library is built
  from the port's own source.
"""

import json

import numpy as np
import pytest

from localai_tfp_tpu.store import backend as jsb
from localai_tfp_tpu_torch.store import backend as tsb
from localai_tfp_tpu_torch.store.native import NativeVectorStore
from tests.test_torch_retrieval import Pair

TOL = 1e-5


def _keys(n: int, d: int, seed: int, unit: bool = True) -> np.ndarray:
    k = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    if unit:
        k /= np.linalg.norm(k, axis=1, keepdims=True)
    return k


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    models = tmp_path_factory.mktemp("store_models")
    p = Pair(tmp_path_factory.mktemp("store_srv"), models)
    yield p
    p.close()


def _same(res, status: int = 200):
    (js, jb), (ts, tb) = res
    assert js == ts == status, (jb[:300], tb[:300])
    return json.loads(jb), json.loads(tb)


@pytest.mark.parametrize("store", [None, "named"])
def test_store_routes_match_jax_server(pair, store):
    keys = _keys(12, 4, seed=3).round(4)
    vals = [f"v{i}" for i in range(12)]

    def body(**kw):
        return {**kw, **({"store": store} if store else {})}

    want, got = _same(pair.both("/stores/set", body(
        keys=keys.tolist(), values=vals)))
    assert got == want == {}
    # an upsert on an equal key replaces the value
    _same(pair.both("/stores/set", body(keys=keys[:2].tolist(),
                                        values=["new0", "new1"])))
    want, got = _same(pair.both("/stores/get", body(
        keys=[keys[0].tolist(), [9.0, 9.0, 9.0, 9.0], keys[5].tolist()])))
    assert got == want
    assert got["values"] == ["new0", "v5"]
    want, got = _same(pair.both("/stores/find", body(key=keys[7].tolist(),
                                                     topk=5)))
    assert got["keys"] == want["keys"] and got["values"] == want["values"]
    assert got["values"][0] == "v7"
    np.testing.assert_allclose(got["similarities"], want["similarities"],
                               rtol=0, atol=TOL)
    _same(pair.both("/stores/delete", body(keys=keys[7:9].tolist())))
    want, got = _same(pair.both("/stores/find", body(key=keys[7].tolist())))
    assert got["keys"] == want["keys"] and got["values"] == want["values"]
    assert "v7" not in got["values"] and len(got["values"]) == 10
    want, got = _same(pair.both("/stores/set", body(
        keys=[[1.0, 2.0, 3.0]], values=["x"])), 500)
    assert got == want
    assert "key width 3 != store width 4" in got["error"]["message"]


def test_client_reads_the_ports_server(pair):
    from localai_tfp_tpu_torch.clients.store import StoreClient

    c = StoreClient(f"http://127.0.0.1:{pair.port}", store="client-store")
    keys = _keys(6, 8, seed=4)
    c.set(keys.tolist(), [f"c{i}" for i in range(6)])
    got_k, got_v = c.get(keys[2:4].tolist())
    assert got_v == ["c2", "c3"]
    np.testing.assert_array_equal(np.asarray(got_k, np.float32), keys[2:4])
    c.delete(keys[:1].tolist())
    fk, fv, fs = c.find(keys[0].tolist(), topk=3)
    assert len(fv) == 3 and "c0" not in fv
    assert fs == sorted(fs, reverse=True)


def _reference(keys: np.ndarray, q: np.ndarray, k: int, unit: bool):
    dots = keys.astype(np.float64) @ q.astype(np.float64)
    if not unit:
        dots /= np.linalg.norm(keys.astype(np.float64), axis=1) * \
            np.linalg.norm(q.astype(np.float64))
    order = np.argsort(-dots, kind="stable")[:k]
    return order, dots[order]


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("threshold", [10 ** 9, 100])
def test_python_and_native_stores_match_jax(monkeypatch, unit, threshold):
    monkeypatch.setattr(tsb, "_DEVICE_THRESHOLD", threshold)
    keys = _keys(500, 32, seed=5, unit=unit)
    vals = [f"v{i}" for i in range(500)]
    stores = {"jax": jsb.VectorStore(), "python": tsb.VectorStore("cpu"),
              "native": NativeVectorStore()}
    for s in stores.values():
        s.set(keys, vals)
        assert len(s) == 500
    rng = np.random.default_rng(6)
    for _ in range(5):
        q = (keys[rng.integers(500)]
             + rng.standard_normal(32).astype(np.float32) * 0.05)
        order, sims = _reference(keys, q, 10, unit)
        out = {n: s.find(q, 10) for n, s in stores.items()}
        for name, (k, v, sim) in out.items():
            assert v == [vals[i] for i in order], name
            np.testing.assert_array_equal(k, keys[order])
            np.testing.assert_allclose(sim, sims, rtol=0, atol=TOL)
    # delete and get agree too
    for s in stores.values():
        assert s.delete(keys[10:20]) == 10
        got_k, got_v = s.get(keys[5:25])
        assert got_v == vals[5:10] + vals[20:25]
    with pytest.raises(ValueError, match="key width 3 != store width 32"):
        stores["python"].set(np.ones((1, 3), np.float32), ["x"])
    with pytest.raises(ValueError, match="key width 3 != store width 32"):
        stores["native"].set(np.ones((1, 3), np.float32), ["x"])


def test_device_matvec_is_used_above_the_threshold(monkeypatch):
    calls = []
    real = tsb.device_dots

    def spy(keys, key, device):
        calls.append(keys.shape)
        return real(keys, key, device)

    monkeypatch.setattr(tsb, "device_dots", spy)
    monkeypatch.setattr(tsb, "_DEVICE_THRESHOLD", 50)
    s = tsb.VectorStore("cpu")
    s.set(_keys(49, 8, seed=7), list(range(49)))
    s.find(np.ones(8, np.float32), 3)
    assert calls == []
    s.set(_keys(1, 8, seed=8), [49])
    s.find(np.ones(8, np.float32), 3)
    assert calls == [(50, 8)]


def test_native_store_knob_picks_the_store(monkeypatch):
    monkeypatch.setenv("LOCALAI_NATIVE_STORE", "0")
    assert type(tsb.make_store()) is tsb.VectorStore
    monkeypatch.setenv("LOCALAI_NATIVE_STORE", "1")
    assert type(tsb.make_store()) is NativeVectorStore
    b = tsb.LocalStoreBackend("cpu")
    assert b.load_model(None).success and b.health()


def test_native_store_is_built_from_the_ports_source():
    from localai_tfp_tpu_torch.ops._build import BUILD_DIR, CSRC
    from localai_tfp_tpu_torch.store import native
    from localai_tfp_tpu_torch.utils import cxx

    assert native.SRC == CSRC / "vecstore.cpp"
    so = cxx.build(native.SRC, "native vector store")
    assert so == cxx.library_path(native.SRC)
    assert so.parent == BUILD_DIR and so.name.startswith("libvecstore-")
    assert native.load_library()._name == str(so)
