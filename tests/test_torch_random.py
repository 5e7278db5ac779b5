"""The port's counter-based random numbers (``repro_torch.random``)
against ``jax.random``: keys and folded keys, random bits at 8, 16 and
32 bits and uniforms in fp32 and bf16 bit for bit; Gumbel noise within
a stated tolerance; categorical draws equal except at counted near ties;
a seeded frequency test against softmax; the published Threefry-2x32-20
known answers."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import random as R  # noqa: E402

SEEDS = (0, 1, 2**31 - 1)
# (request id, position): ids up to 2**32 - 1 (the reference keeps them
# as uint32), positions up to a long context.
GRID = [(0, 0), (0, 1), (1, 0), (3, 17), (77, 4095), (2**31, 9),
        (2**32 - 1, 131071)]
SHAPES = [(7,), (3, 1000), (2, 256000)]
# Gumbel noise: fp32 logs differ by rounding between XLA and torch;
# bf16 values are allowed one ulp.
GUMBEL_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
              torch.bfloat16: dict(rtol=2**-7, atol=0.0)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# Random123's kat_vectors for threefry2x32_20: (key, counter) -> out.
KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
       ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
        (0x1CB996FC, 0xBB002BE7)),
       ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
        (0xC4923A9C, 0x483DF7A0))]

# fold_in(fold_in(PRNGKey(seed), rid), pos) words, from jax.random.key_data
# (chip_smoke.py holds the same table and checks the card against it).
KEY_WORDS = {(0, 0, 0): (0xF84E8312, 0x2FEF64F3),
             (0, 100, 133): (0xAC830C4B, 0x2A29DA69),
             (0, 107, 160): (0x44563976, 0x804B3348),
             (2**31 - 1, 7, 159): (0x9FDCBB65, 0x8241141D),
             (1, 2**32 - 1, 131071): (0x7FBA2311, 0xFCFBF4D7)}


def _key_data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("kat", KAT, ids=["zeros", "ones", "pi"])
def test_threefry_known_answers(kat):
    (k0, k1), (x0, x1), want = kat
    got = R.threefry2x32(*(torch.tensor(v, dtype=torch.int64)
                           for v in (k0, k1, x0, x1)))
    assert tuple(int(v) for v in got) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_nested_fold_in_equal_jax(seed):
    key = R.prng_key(seed)
    jkey = jax.random.PRNGKey(seed)
    assert key.tolist() == _key_data(jkey).tolist()
    rids = torch.tensor([r for r, _ in GRID], dtype=torch.int64)
    pos = torch.tensor([p for _, p in GRID], dtype=torch.int64)
    got = R.fold_in(R.fold_in(key, rids), pos)  # batched over the grid
    want = [_key_data(jax.random.fold_in(
        jax.random.fold_in(jkey, np.uint32(r)), np.int32(p)))
        for r, p in GRID]
    assert got.tolist() == [w.tolist() for w in want]


@pytest.mark.parametrize("case", sorted(KEY_WORDS), ids=str)
def test_pinned_key_words(case):
    seed, rid, pos = case
    got = R.fold_in(R.fold_in(R.prng_key(seed), rid), pos)
    assert tuple(got.tolist()) == KEY_WORDS[case]
    want = _key_data(jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(rid)),
        np.int32(pos)))
    assert tuple(want.tolist()) == KEY_WORDS[case]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("width", [8, 16, 32])
def test_random_bits_equal_jax(shape, width):
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = np.asarray(jax.random.bits(
        jkey, shape, {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32}[width]))
    got = R.random_bits(R.fold_in(R.prng_key(3), 11), width, shape)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_uniform_bitwise_and_gumbel_close(shape, dtype):
    jkey = jax.random.PRNGKey(5)
    key = R.prng_key(5)
    want = np.asarray(jax.random.uniform(jkey, shape, JDT[dtype]),
                      np.float32)
    got = R.uniform(key, shape, dtype).float().numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    g_want = np.asarray(jax.random.gumbel(jkey, shape, JDT[dtype]),
                        np.float32)
    g_got = R.gumbel(key, shape, dtype).float().numpy()
    np.testing.assert_allclose(g_got, g_want, **GUMBEL_TOL[dtype])


def test_batched_rows_equal_one_key_each():
    keys = R.fold_in(R.prng_key(0), torch.arange(4))
    rows = R.random_bits(keys, 32, (50,))
    for i in range(4):
        assert torch.equal(rows[i], R.random_bits(keys[i], 32, (50,)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_categorical_equals_jax_but_at_near_ties(dtype):
    """Per-row draws of ``categorical(fold_in(key, row), logits[row] / t)``
    against the reference's vmapped call. A draw may differ only where
    the top two perturbed logits lie within the Gumbel tolerance; such
    rows are counted, and most rows must be exact."""
    rng = np.random.default_rng(0)
    B, V, t = 64, 1000, 0.8
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    lt = torch.from_numpy(logits).to(dtype)
    keys = R.fold_in(R.prng_key(0), torch.arange(B))
    got = R.sample(keys, lt, t).numpy()
    jl = jnp.asarray(logits).astype(JDT[dtype])
    jkeys = jax.vmap(lambda r: jax.random.fold_in(
        jax.random.PRNGKey(0), r))(jnp.arange(B, dtype=jnp.uint32))
    want = np.asarray(jax.vmap(lambda k, l: jax.random.categorical(
        k, l / t))(jkeys, jl))
    pert = (R.gumbel(keys, (V,), dtype) + lt / torch.tensor(t, dtype=dtype)
            ).float().numpy()
    top2 = np.sort(pert, axis=-1)[:, -2:]
    tol = GUMBEL_TOL[dtype]
    near = (top2[:, 1] - top2[:, 0]
            <= 2 * (tol["atol"] + tol["rtol"] * np.abs(top2[:, 1])))
    differ = got != want
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    assert differ.sum() <= near.sum() and (~near).sum() >= B // 2


def test_sampled_frequencies_follow_softmax():
    """65,536 keys at one position: the token frequencies are within a
    total variation of 0.01 of softmax(logits / t)."""
    V, t, n = 16, 0.8, 65536
    logits = torch.linspace(-2.0, 2.0, V)
    keys = R.fold_in(R.fold_in(R.prng_key(0), torch.arange(n)), 5)
    draws = R.sample(keys, logits.expand(n, V), t)
    freq = torch.bincount(draws, minlength=V).double() / n
    p = torch.softmax(logits.double() / t, dim=-1)
    assert 0.5 * (freq - p).abs().sum().item() < 0.01


def test_temperature_rounds_to_the_logits_dtype():
    """JAX divides bf16 logits by bf16(t); so does the port."""
    x = torch.tensor([1.0, 3.0, 7.0], dtype=torch.bfloat16)
    assert torch.equal(
        R.sample(R.prng_key(0), x, 0.8),
        R.categorical(R.prng_key(0), x / torch.tensor(0.8,
                                                      dtype=torch.bfloat16)))
    jx = np.asarray(jnp.asarray([1.0, 3.0, 7.0], jnp.bfloat16) / 0.8,
                    np.float32)
    np.testing.assert_array_equal(
        (x / torch.tensor(0.8, dtype=torch.bfloat16)).float().numpy(), jx)
