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
  every projection shape of the 8B path, picks the mixed-step
  instance's 64- or 128-row tile from static shapes, and keeps the
  decode and f32-x plans.
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
    """bf16 x, as served: tiles cover M and N, splits cover K with none
    empty, M <= 16 keeps the 16-row decode plan (about four blocks per
    SM), and the mixed-step instance's grid gives more than half the SMs
    a block, splitting K only where its tiles alone would not, and then
    no further than one block per SM."""
    sms = 132
    bm, splits, k_split = tmm.plan(m, n, k, sms)
    assert k_split % tmm.TILE_K == 0 and splits >= 1
    assert (splits - 1) * k_split < k <= splits * k_split
    tiles = -(-m // bm) * (n // tmm.TILE_N)
    assert tiles * bm >= m * (n // tmm.TILE_N)
    if m <= 16:
        assert bm == 16
        if tiles >= 4 * sms:  # the output tiles alone fill the card
            assert splits == 1
        else:  # K splits until every SM has a block
            assert splits > 1 and tiles * splits >= sms
    else:
        assert bm == (64 if m <= 64 else 128)
        assert tiles * splits * 2 > sms
        assert (splits > 1) == (tiles <= sms // 2)
        if splits > 1:
            assert tiles * splits <= sms


@pytest.mark.parametrize("m,k,n,want", [
    (17, 4096, 14336, (64, 1, 4096)),     # M <= 64: 64-row tiles
    (64, 4096, 4096, (64, 4, 1024)),      # 32 tiles: K splits 4 ways
    (37, 4096, 1024, (64, 16, 256)),      # 8 tiles: 16 splits
    (65, 4096, 14336, (128, 1, 4096)),    # M > 64: 128-row tiles
    (128, 4096, 14336, (128, 1, 4096)),   # 112 tiles: most SMs busy
    (128, 4096, 4096, (128, 4, 1024)),
    (128, 4096, 1024, (128, 16, 256)),
    (512, 4096, 14336, (128, 1, 4096)),
    (800, 14336, 4096, (128, 1, 14336)),  # the 8 x 100-token mixed step
    (800, 4096, 1024, (128, 2, 2048)),
    (1024, 4096, 14336, (128, 1, 4096)),  # 896 tiles
    (1024, 4096, 1024, (128, 2, 2048)),   # 64 tiles: K splits 2 ways
], ids=lambda v: str(v) if not isinstance(v, tuple) else "x".join(map(str, v)))
def test_plan_picks_the_mixed_step_tile(m, k, n, want):
    assert tmm.plan(m, n, k, sms=132) == want


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("m", [17, 128, 1024])
@pytest.mark.parametrize("k,n", SHAPES_8B)
def test_mma_plan_at_either_row_tile_covers_k(bm, m, k, n):
    """The plan at the row tile the rule did not pick (timed beside the
    chosen one on the card) is a valid launch too."""
    got_bm, splits, k_split = tmm.mma_plan(bm, m, n, k, sms=132)
    assert got_bm == bm and k_split % tmm.TILE_K == 0
    assert (splits - 1) * k_split < k <= splits * k_split
    assert -(-m // bm) * (n // tmm.TILE_N) * splits <= max(
        132, -(-m // bm) * (n // tmm.TILE_N))


@pytest.mark.parametrize("k,want,splits", [(4096, 2, 2), (4096, 0, 1),
                                           (4096, 500, 64), (14336, 3, 3),
                                           (4096, 3, 3), (832, 5, 5)])
def test_split_k_covers_k_with_whole_nonempty_steps(k, want, splits):
    got, k_split = tmm.split_k(k, want)
    assert got == splits and k_split % tmm.TILE_K == 0
    assert (got - 1) * k_split < k <= got * k_split


@pytest.mark.parametrize("m,want", [(8, (16, 64, 64)), (37, (64, 64, 64)),
                                    (1024, (64, 5, 832))])
def test_plan_keeps_the_f32_x_tiles(m, want):
    """f32 x keeps 16- / 64-row tiles and splits K toward four blocks per
    SM (the f32 kernel has no 128-row instance)."""
    assert tmm.plan(m, 1024, 4096, sms=132, bf16_x=False) == want


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
