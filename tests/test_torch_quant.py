"""Quantized paged KV pools of the PyTorch port against the JAX
reference.

- ``repro_torch.kernels.quant`` equals ``repro.kernels.quant`` bit for
  bit (int8 values, int4 packed bytes, fp32 scales) on the same fp32
  input, ties at .5, all-zero rows and bf16-origin values included.
- The plain quantized paged attention is held against
  ``ref.paged_attention`` and the Pallas kernel in interpret mode on the
  *same* quantized pool (never against fp32: the reference's own int4
  vs fp32 bound fails), on valid queries, atol 1e-5 in fp32.
- Quantize-on-insert (``layers.paged_cache_insert``) writes the values
  and scales the JAX layer writes, trash page excluded.
- On a card only (marked ``cuda``), the kernel's int8 and int4 branches
  against the plain version.

The JAX side is imported inside a fixture, so the ``cuda`` tests run on
a machine that has no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, quant
from repro_torch.kernels import paged_attention as pa

FP32_ATOL = 1e-5  # both sides fp32; sums in another order
BF16_TOL = dict(rtol=3e-2, atol=3e-2)  # bf16 output rounding


@pytest.fixture(scope="module")
def jref():
    """The reference's quant, oracle, Pallas kernel and layers."""
    pytest.importorskip("jax")
    from repro.kernels import paged_attention as pallas_pa
    from repro.kernels import quant as jquant
    from repro.kernels import ref
    from repro.models import layers as jlayers

    return dict(quant=jquant, ref=ref, pallas=pallas_pa, layers=jlayers)


def _quant_inputs(seed):
    """fp32 rows (..., hd) with the hard cases: a wide range of scales,
    exact .5 ties after scaling, all-zero rows and bf16-origin values."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((6, 5, 3, 32)).astype(np.float32)
    x *= np.float32(10.0) ** rng.randint(-4, 4, size=(6, 5, 3, 1))
    x[0, 0] = 0.0                                   # all-zero rows
    x[1, 0, 0] = np.arange(32) - 15.5               # amax 16.5: ties
    x[1, 0, 1] = (np.arange(32) % 15 - 7).astype(np.float32)  # exact ints
    x[1, 0, 2] = np.linspace(-127, 127, 32).astype(np.float32) / 2
    x[2] = torch.from_numpy(x[2]).bfloat16().float().numpy()  # bf16-origin
    return x


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("seed", range(3))
def test_quantize_bit_exact(jref, kind, seed):
    import jax.numpy as jnp

    x = _quant_inputs(seed)
    jfn = getattr(jref["quant"], f"quantize_{kind}")
    want_q, want_s = (np.asarray(a) for a in jfn(jnp.asarray(x)))
    got_q, got_s = getattr(quant, f"quantize_{kind}")(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  want_s.view(np.int32))
    got_d = quant.dequantize(got_q, got_s, 32).numpy()
    want_d = np.asarray(jref["quant"].dequantize(jnp.asarray(want_q),
                                                 jnp.asarray(want_s), 32))
    np.testing.assert_array_equal(got_d.view(np.int32), want_d.view(np.int32))
    # bf16 inputs quantize as the reference's bf16 inputs do
    xb = torch.from_numpy(x).bfloat16()
    jb = jfn(jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(
        getattr(quant, f"quantize_{kind}")(xb)[0].numpy(), np.asarray(jb[0]))


def test_pack_unpack_round_trip(jref):
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    q = rng.randint(-8, 8, size=(7, 4, 64)).astype(np.int32)
    packed = quant.pack_int4(torch.from_numpy(q))
    assert packed.shape == (7, 4, 32) and packed.dtype == torch.int8
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jref["quant"].pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(quant.unpack_int4(packed).numpy(), q)
    # every byte value unpacks as the reference unpacks it
    every = torch.arange(-128, 128, dtype=torch.int8)[None]
    np.testing.assert_array_equal(
        quant.unpack_int4(every).numpy(),
        np.asarray(jref["quant"].unpack_int4(jnp.asarray(every.numpy()))))
    with pytest.raises(ValueError, match="even"):
        quant.pack_int4(torch.zeros(3, 5, dtype=torch.int32))


# --------------------------------------------------------------------------- #
# Quantized paged attention, plain version vs the reference.
# --------------------------------------------------------------------------- #
CASES = {
    # deep decode row, mid-prefill chunk row, short row, idle row; GQA 4/2
    "gqa": dict(B=4, C=4, H=4, K=2, D=32, page=4, P=14, npg=8,
                lens=[13, 6, 2, 0], nvs=[1, 4, 2, 1], idle=(3,)),
    # MHA, page 2
    "mha": dict(B=3, C=3, H=2, K=2, D=16, page=2, P=12, npg=6,
                lens=[9, 3, 0], nvs=[3, 1, 1], idle=(2,)),
}


def quant_case(seed, kind, *, B, C, H, K, D, page, P, npg, lens, nvs,
               idle=()):
    """numpy q, quantized pools and scales (quantized by the port's own
    ``quant``, bit-equal to the reference's), page table, pos, n_valid."""
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    qz = getattr(quant, f"quantize_{kind}")
    pools = []
    for _ in range(2):
        vals, scale = qz(torch.from_numpy(
            rng.standard_normal((P, page, K, D)).astype(np.float32)))
        pools += [vals.numpy(), scale.numpy()]
    pt = np.full((B, npg), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    free = list(rng.permutation(P))
    for b in range(B):
        if b in idle:
            continue
        n = -(-lens[b] // page)
        pt[b, :n] = [free.pop() for _ in range(n)]
        pos[b] = max(0, lens[b] - nvs[b])
    kp, ks, vp, vs = pools
    return dict(q=q, kp=kp, vp=vp, kp_scale=ks, vp_scale=vs, page_table=pt,
                pos=pos, n_valid=np.asarray(nvs, np.int32))


def _valid(case):
    return [(b, n) for b, n in enumerate(case["nvs"])
            if b not in case.get("idle", ())]


def _to_torch(arrays, qdtype, device="cpu"):
    out = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    out["q"] = out["q"].to(getattr(torch, qdtype))
    return out


def _to_jax(arrays, qdtype):
    import jax.numpy as jnp

    out = {k: jnp.asarray(v) for k, v in arrays.items()}
    out["q"] = jnp.asarray(arrays["q"], getattr(jnp, qdtype))
    return out


def _call(fn, a, window, **kw):
    return fn(a["q"], a["kp"], a["vp"], a["page_table"], pos=a["pos"],
              n_valid=a["n_valid"], window=window, kp_scale=a["kp_scale"],
              vp_scale=a["vp_scale"], **kw)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_plain_quantized_matches_reference(jref, name, kind, window, qdtype):
    case = CASES[name]
    arrays = quant_case(7, kind, **case)
    if kind == "int4":
        assert arrays["kp"].shape[-1] == case["D"] // 2
    got = _call(ops.paged_attention, _to_torch(arrays, qdtype), window)
    assert got.dtype == getattr(torch, qdtype)
    got = got.float().numpy()
    ja = _to_jax(arrays, qdtype)
    want_ref = np.asarray(_call(jref["ref"].paged_attention, ja, window),
                          np.float32)
    want_pallas = np.asarray(_call(jref["pallas"].paged_attention, ja, window,
                                   interpret=True), np.float32)
    tol = (dict(rtol=0, atol=FP32_ATOL) if qdtype == "float32"
           else BF16_TOL)
    for b, n in _valid(case):
        np.testing.assert_allclose(got[b, :n], want_ref[b, :n], **tol)
        np.testing.assert_allclose(got[b, :n], want_pallas[b, :n], **tol)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_cache_insert_matches_reference(jref, kind):
    """Quantize-on-insert: pools and scales equal to the JAX layer's on
    every real page; colliding masked writes land on the trash page in
    an unspecified order, so it is left out."""
    import dataclasses

    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config

    from repro_torch.configs import get_config
    from repro_torch.models import layers

    jcfg = dataclasses.replace(jax_get_config("gemma-7b").reduced(),
                               kv_cache_dtype=kind)
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(),
                              kv_cache_dtype=kind)
    n_pages, page, B, C = 6, 4, 3, 4
    K, hd = cfg.n_kv_heads, cfg.head_dim
    rng = np.random.RandomState(1)
    k_new = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    v_new = rng.standard_normal((B, C, K, hd)).astype(np.float32)
    pt = np.asarray([[2, 0, -1], [4, -1, -1], [-1, -1, -1]], np.int32)
    pos = np.asarray([2, 1, 0], np.int32)
    nv = np.asarray([4, 2, 1], np.int32)
    want = jref["layers"].paged_cache_insert(
        jref["layers"].init_paged_kv_cache(jcfg, n_pages, page),
        jnp.asarray(k_new, jnp.bfloat16), jnp.asarray(v_new, jnp.bfloat16),
        jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(nv))
    cache = layers.init_paged_kv_cache(cfg, n_pages, page, device="cpu")
    cache = {k: v[0] for k, v in cache.items()}
    assert sorted(cache) == sorted(want)
    store_hd = hd // 2 if kind == "int4" else hd
    assert cache["kp"].shape == (n_pages + 1, page, K, store_hd)
    assert cache["kp_scale"].shape == (n_pages + 1, page, K)
    layers.paged_cache_insert(
        cache, torch.from_numpy(k_new).bfloat16(),
        torch.from_numpy(v_new).bfloat16(), torch.from_numpy(pt),
        torch.from_numpy(pos), torch.from_numpy(nv))
    for name in sorted(want):
        got, ref = cache[name].numpy(), np.asarray(want[name])
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got[:n_pages], ref[:n_pages], name)
    assert np.abs(cache["kp_scale"][:n_pages].numpy()).sum() > 0


def test_quantized_copy_pages_and_defrag_move_scales():
    """A copy-on-write copy and a defrag move each page's scales with
    its values."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.serve.cache import apply_defrag

    cfg = dataclasses.replace(get_config("gemma-7b").reduced(),
                              kv_cache_dtype="int8", n_layers=2)
    cache = layers.init_paged_kv_cache(cfg, 4, 2, n_layers=2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for name, t in cache.items():
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen).to(t.dtype))
    before = {k: v.clone() for k, v in cache.items()}
    layers.paged_copy_pages(cache, [1], [3])
    for name, t in cache.items():
        assert torch.equal(t[:, 3], before[name][:, 1]), name
    perm = np.asarray([2, 0, 3, 1, 4], np.int32)
    snap = {k: v.clone() for k, v in cache.items()}
    apply_defrag(cache, perm)
    for name, t in cache.items():
        assert torch.equal(t, snap[name][:, torch.from_numpy(perm).long()])


def test_cuda_wrapper_rejects_cpu_quantized_tensors():
    a = _to_torch(quant_case(0, "int8", **CASES["gqa"]), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        _call(pa.paged_attention_cuda, a, None)


# --------------------------------------------------------------------------- #
# On the card: the kernel's quantized branches vs the plain version.
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("D,H,K", [(64, 4, 2), (128, 4, 4), (256, 8, 2)])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_cuda_quantized_kernel_matches_plain(cuda_device, kind, D, H, K,
                                             window, qdtype):
    """The int8/int4 branch == the plain version on the same quantized
    pool, on valid queries; queries past n_valid and the idle row come
    out as 0. fp32: 1e-4 (sums in another order); bf16: 2e-2 (the
    output's rounding)."""
    case = dict(CASES["gqa"], D=D, H=H, K=K)
    a = _to_torch(quant_case(3, kind, **case), qdtype, cuda_device)
    before = dict(pa.paged_attention_cuda.launches_by_kind)
    got = _call(pa.paged_attention_cuda, a, window)
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda.launches_by_kind[kind] == before[kind] + 1
    want = _call(pa.paged_attention_torch, a, window)
    tol = 1e-4 if qdtype == "float32" else 2e-2
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    for b, n in _valid(case):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=tol, atol=tol)
        assert (got[b, n:] == 0).all()
    assert (got[3] == 0).all()


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_quantized_inputs(cuda_device):
    a = _to_torch(quant_case(0, "int8", **dict(CASES["gqa"], D=64)),
                  "float32", cuda_device)
    with pytest.raises(ValueError, match="float32"):
        _call(pa.paged_attention_cuda,
              dict(a, kp_scale=a["kp_scale"].double()), None)
    with pytest.raises(TypeError, match="int8"):
        _call(pa.paged_attention_cuda,
              dict(a, kp=a["kp"].float(), vp=a["vp"].float()), None)
