"""The port's int8 matrix product (localai_tfp_tpu_torch/ops/int8_matmul.py)
against the JAX package's Pallas kernel, on the CPU.

- ``int8_matmul_plain`` against JAX ``int8_matmul`` run in Pallas
  interpret mode (as tests/test_int8_matmul.py runs it), on the same
  numpy inputs: rtol and atol 2e-4 (the JAX test's tolerance; both sum
  in f32 in another order).
- The wrapper takes the plain version for CPU tensors (bit for bit, no
  launch counted), refuses any other non-CUDA device instead of falling
  back, and keeps the JAX package's eligibility rule.
- The launch plan (``plan``) covers K exactly with non-empty splits at
  every projection shape of the 8B path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localai_tfp_tpu.models import quant as jq
from localai_tfp_tpu.ops import int8_matmul as jmm
from localai_tfp_tpu_torch.ops import int8_matmul as tmm

K, N = 2 * jmm.BK, jmm.BN  # 1024 x 512, as the JAX kernel test


def _operands(m: int, seed: int, k: int = K, n: int = N):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    qt = jq.quantize_tensor(jnp.asarray(w))
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, np.array(qt.q), np.array(qt.scale)  # writable copies


@pytest.mark.parametrize("m", [8, 16, 128])
def test_plain_matches_jax_kernel_interpret(m):
    x, q, s = _operands(m, seed=m)
    want = jmm.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                           out_dtype=jnp.float32)
    got = tmm.int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                                torch.from_numpy(s), torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_plain_bf16_out_matches_jax_kernel_interpret():
    """bf16 x and bf16 out: both cast the same f32 sums, so they agree to
    one bf16 rounding step."""
    x, q, s = _operands(8, seed=3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jmm.int8_matmul(xb, jnp.asarray(q), jnp.asarray(s),
                                      out_dtype=jnp.bfloat16)
                      ).astype(np.float32)
    got = tmm.int8_matmul_plain(torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def test_cpu_wrapper_takes_the_plain_version():
    x, q, s = (torch.from_numpy(a) for a in _operands(8, seed=1))
    before = tmm.int8_matmul.launches
    got = tmm.int8_matmul(x, q, s)
    assert tmm.int8_matmul.launches == before
    assert torch.equal(got, tmm.int8_matmul_plain(x, q, s))


def test_wrapper_refuses_a_device_that_is_neither_cpu_nor_cuda():
    x = torch.empty((8, K), device="meta")
    q = torch.empty((K, N), dtype=torch.int8, device="meta")
    s = torch.empty((N,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tmm.int8_matmul(x, q, s)


@pytest.mark.parametrize("m,k,n", [(1, 512, 512), (1024, 4096, 1024),
                                   (1025, 512, 512), (8, 96, 512),
                                   (8, 512, 64), (0, 512, 512),
                                   (8, 14336, 4096)])
def test_eligible_is_the_jax_rule(m, k, n):
    want = jmm.eligible(m, (k, n)) and m >= 1
    assert tmm.eligible(m, (k, n)) == want


# the 8B path's projections (K, N) and the row counts the engine gives them
SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("m", [1, 8, 37, 128, 1024])
@pytest.mark.parametrize("k,n", SHAPES_8B)
def test_plan_covers_k_with_nonempty_splits(m, k, n):
    bm, splits, k_split = tmm.plan(m, n, k, sms=132)
    assert bm == (16 if m <= 16 else 64)
    assert k_split % tmm.TILE_K == 0 and splits >= 1
    assert (splits - 1) * k_split < k <= splits * k_split
    tiles = -(-m // bm) * (n // tmm.TILE_N)
    if tiles >= 4 * 132:  # the output tiles alone fill the card
        assert splits == 1
    else:  # K splits until every SM has a block
        assert splits > 1 and tiles * splits >= 132


def _why(**over):
    ops = dict(x=torch.zeros((8, 512)), q=torch.zeros((512, 512),
                                                       dtype=torch.int8),
               scale=torch.zeros(512), out_dtype=torch.float32)
    ops.update(over)
    return tmm._why_not(ops["x"], ops["q"], ops["scale"], ops["out_dtype"])


@pytest.mark.parametrize("over,reason", [
    (dict(x=torch.zeros((8, 256))), "do not chain"),
    (dict(scale=torch.zeros(256)), "do not chain"),
    (dict(x=torch.zeros((1025, 512))), "not eligible"),
    (dict(x=torch.zeros((8, 512), dtype=torch.float16)), "x dtype"),
    (dict(out_dtype=torch.int8), "out dtype"),
    (dict(q=torch.zeros((512, 512))), "q dtype"),
    (dict(scale=torch.zeros(512, dtype=torch.bfloat16)), "scale dtype"),
    (dict(q=torch.zeros((512, 512), dtype=torch.int8, device="meta")),
     "q lives on meta"),
    (dict(x=torch.zeros((512, 8)).T), "x must be contiguous"),
], ids=["k", "scale-n", "m", "x-dtype", "out-dtype", "q-dtype",
        "scale-dtype", "device", "contiguous"])
def test_the_wrapper_names_what_it_refuses(over, reason):
    """The card-side wrapper raises with the first failing check's reason
    (computed only when a check fails)."""
    assert reason in _why(**over)
