"""The port's threefry PRNG (``ray_tpu_torch._private.prng``) against the
installed ``jax.random`` on the CPU.

Integer outputs (keys, splits, 32-bit draws) and ``uniform`` floats are
held BIT-equal. Gumbel noise goes through ``log`` twice, and torch's and
XLA's ``log`` may round one ulp apart; an ulp of the inner
``-log(u)`` (relative ``2**-23``) reaches the result as an absolute
``2**-23``. So it is held within ``4 * (ulp(g) + 2**-23)`` of the
reference value ``g`` (measured: at most ``1 * (ulp(g) + 2**-23)``).
``categorical`` tokens must be identical on logits whose scores lie far
apart relative to that tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch._private import prng
from torch_threads import one_torch_thread  # noqa: F401

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32 + 5, -1, -12345]


def _t(keys):
    return torch.from_numpy(np.asarray(keys, np.uint32).astype(np.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_partitionable_threefry_is_the_installed_setting():
    """The port reproduces the partitionable bit stream (fold-like split,
    ``bits1 ^ bits2`` draws); if JAX's default changes, parity breaks
    here first, with this reason."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is False


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    ref = np.asarray(jax.random.PRNGKey(seed))
    got = prng.PRNGKey(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, ref)


def test_prng_key_rejects_seeds_outside_int64():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 64)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 7])
def test_split(seed, num):
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.split(key, num))
    got = _u32(prng.split(_t(key), num))
    np.testing.assert_array_equal(got, ref)
    # Chained splits stay on the reference's chain.
    np.testing.assert_array_equal(
        _u32(prng.split(prng.split(_t(key))[1])),
        np.asarray(jax.random.split(jax.random.split(key)[1])))


def test_split_over_lanes():
    """``[B, 2]`` keys split per lane, as ``jax.vmap(jax.random.split)``
    (the reference's ``_sample_slots``), and nested lanes too."""
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in SEEDS])
    ref = np.asarray(jax.vmap(jax.random.split)(jnp.asarray(keys)))
    np.testing.assert_array_equal(_u32(prng.split(_t(keys))), ref)
    ref5 = np.asarray(jax.vmap(lambda k: jax.random.split(k, 5))(
        jnp.asarray(keys)))
    np.testing.assert_array_equal(_u32(prng.split(_t(keys), 5)), ref5)
    nested = keys.reshape(7, 1, 2).repeat(3, axis=1)        # [7, 3, 2]
    np.testing.assert_array_equal(_u32(prng.split(_t(nested)))[:, 1],
                                  ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (1,), (5,), (3, 517), (2, 2, 33)])
def test_bits_and_uniform_bit_equal(seed, shape):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        _u32(prng.random_bits(_t(key), shape)),
        np.asarray(jax.random.bits(key, shape)))
    ref = np.asarray(jax.random.uniform(key, shape))
    got = prng.uniform(_t(key), shape).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    tiny = float(np.finfo(np.float32).tiny)
    ref = np.asarray(jax.random.uniform(key, shape, minval=tiny,
                                        maxval=1.0))
    got = prng.uniform(_t(key), shape, tiny, 1.0).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_uniform_over_lanes():
    keys = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in SEEDS])
    ref = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (9,)))(
        jnp.asarray(keys)))
    got = prng.uniform(_t(keys), (9,)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_ulp(seed):
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.gumbel(key, (4, 4099), mode="low"))
    got = prng.gumbel(_t(key), (4, 4099)).numpy()
    tol = 4 * (np.spacing(np.abs(ref)) + 2.0 ** -23)
    assert np.all(np.abs(got - ref) <= tol)


def _separated_logits(rng, shape):
    """Logits on a grid of step 0.05 (a permutation per row), so no two
    scores of a row lie within 1e-3 of each other before the noise."""
    n = shape[-1]
    rows = [rng.permutation(n) for _ in range(int(np.prod(shape[:-1])))]
    return (np.stack(rows).reshape(shape) * 0.05 - n * 0.025
            ).astype(np.float32)


def _margin(noise_plus_logits):
    """Gap between the best and second-best score of every row."""
    top2 = np.sort(noise_plus_logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]).min()


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_tokens_equal(seed):
    """Both forms the reference uses: one key over a ``[B, V]`` block
    (``_sample``) and one key per row (``_sample_slots``)."""
    rng = np.random.default_rng(seed % 1000)
    logits = _separated_logits(rng, (6, 300))
    key = jax.random.PRNGKey(seed)
    noise = np.asarray(jax.random.gumbel(key, logits.shape, mode="low"))
    # The test is only meaningful where the top-2 gap exceeds the noise
    # tolerance by far.
    assert _margin(noise + logits) > 1e-4
    ref = np.asarray(jax.random.categorical(key, logits))
    got = prng.categorical(_t(key), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, ref)

    keys = np.asarray(jax.random.split(key, 6))
    ref = np.asarray(jax.vmap(jax.random.categorical)(jnp.asarray(keys),
                                                      logits))
    got = prng.categorical(_t(keys), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, ref)
