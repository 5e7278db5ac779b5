"""Paged attention of the PyTorch port against the JAX reference.

The port's plain version is held against ``repro.kernels.ref`` and the
Pallas kernel in interpret mode on the same numpy inputs, on the valid
queries of a ragged mixed batch (rows past ``n_valid`` and rows with
nothing to attend are garbage by contract). The CUDA kernel is held
against the plain version on the card (marked ``cuda``; skipped here).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as pallas_pa  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}  # tests/test_kernels.py _tol


def _case(seed, B, C, H, K, D, page, P, npg, lens, nvs, idle=()):
    """Numpy inputs in the layout of tests/test_kernels.py:_paged_case;
    rows in ``idle`` map no page (the engine's idle slot)."""
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, K, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, K, D)).astype(np.float32)
    pt = np.full((B, npg), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    free = list(rng.permutation(P))
    for b in range(B):
        if b in idle:
            continue
        n_pages = -(-lens[b] // page) if lens[b] else 0
        pt[b, :n_pages] = [free.pop() for _ in range(n_pages)]
        pos[b] = max(0, lens[b] - nvs[b])
    return q, kp, vp, pt, pos, np.asarray(nvs, np.int32)


CASES = {
    # deep decode row, mid-prefill chunk row, short row; GQA 4 -> 2
    "ragged_gqa": dict(seed=3, B=3, C=4, H=4, K=2, D=32, page=4, P=12,
                       npg=8, lens=[13, 6, 2], nvs=[1, 4, 2]),
    # MQA, page 2, plus an idle row with an all -1 page table
    "mqa_idle": dict(seed=5, B=3, C=3, H=4, K=1, D=16, page=2, P=10, npg=6,
                     lens=[9, 1, 0], nvs=[3, 1, 1], idle=(2,)),
}


def _valid_rows(case):
    idle = case.get("idle", ())
    return [(b, n) for b, n in enumerate(case["nvs"]) if b not in idle]


def _port(arrays, dtype, window):
    q, kp, vp, pt, pos, nv = arrays
    tdt = getattr(torch, dtype)
    out = ops.paged_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(pt),
        pos=torch.from_numpy(pos), n_valid=torch.from_numpy(nv),
        window=window)
    assert out.dtype == tdt and out.shape == q.shape
    return out.float().numpy()


def _jax_inputs(arrays, dtype):
    q, kp, vp, pt, pos, nv = arrays
    jdt = getattr(jnp, dtype)
    return (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
            jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(nv))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle(name, window, dtype):
    case = CASES[name]
    arrays = _case(**case)
    q, kp, vp, pt, pos, nv = _jax_inputs(arrays, dtype)
    want = np.asarray(ref.paged_attention(q, kp, vp, pt, pos=pos, n_valid=nv,
                                          window=window), np.float32)
    got = _port(arrays, dtype, window)
    for b, n in _valid_rows(case):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL[dtype])


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_interpret(name, window, dtype):
    case = CASES[name]
    arrays = _case(**case)
    q, kp, vp, pt, pos, nv = _jax_inputs(arrays, dtype)
    want = np.asarray(pallas_pa.paged_attention(
        q, kp, vp, pt, pos=pos, n_valid=nv, window=window, interpret=True),
        np.float32)
    got = _port(arrays, dtype, window)
    for b, n in _valid_rows(case):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **TOL[dtype])


def test_plain_idle_row_is_finite_mean_of_v():
    """An idle row (all -1 pages, n_valid=1) is fully masked: finite
    -1e30 masking gives the uniform mean of the gathered V, like the
    reference's jnp path, never NaN."""
    case = CASES["mqa_idle"]
    q, kp, vp, pt, pos, nv = _case(**case)
    out = _port((q, kp, vp, pt, pos, nv), "float32", None)
    assert np.isfinite(out).all()
    gathered = vp[np.clip(pt[2], 0, None)].reshape(-1, 1, 16)
    np.testing.assert_allclose(out[2, 0], np.broadcast_to(
        gathered.mean(0), (4, 16)), rtol=1e-5, atol=1e-5)


def test_cuda_wrapper_rejects_cpu_tensors():
    """On CPU tensors the kernel wrapper raises; only ``ops`` routes
    them to the plain version."""
    q, kp, vp, pt, pos, nv = (torch.from_numpy(a) for a in _case(
        **CASES["ragged_gqa"]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pa.paged_attention_cuda(q, kp, vp, pt, pos=pos, n_valid=nv)


def test_ops_refuses_quantized_pools():
    """Quantized pools are ported (tests/test_torch_quant.py); ``ops``
    still refuses the malformed ones the reference refuses: one scale
    without the other, and a trailing axis that is neither head_dim
    (int8) nor head_dim // 2 (int4)."""
    q, kp, vp, pt, pos, nv = (torch.from_numpy(a) for a in _case(
        **CASES["ragged_gqa"]))
    s = torch.ones(kp.shape[:3])
    with pytest.raises(ValueError, match="together"):
        ops.paged_attention(q, kp.to(torch.int8), vp.to(torch.int8), pt,
                            pos=pos, n_valid=nv, kp_scale=s)
    with pytest.raises(ValueError, match="matches neither"):
        ops.paged_attention(q, kp[..., :5].to(torch.int8),
                            vp[..., :5].to(torch.int8), pt, pos=pos,
                            n_valid=nv, kp_scale=s, vp_scale=s)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda_device, D, window, dtype):
    """The hand-written kernel == the plain version on the card, on
    valid queries; queries past n_valid come out as 0."""
    case = dict(CASES["mqa_idle"], D=D, H=4, K=2)
    arrays = _case(**case)
    tdt = getattr(torch, dtype)
    q, kp, vp = (torch.from_numpy(a).to(cuda_device, tdt)
                 for a in arrays[:3])
    pt, pos, nv = (torch.from_numpy(a).to(cuda_device) for a in arrays[3:])
    before = pa.paged_attention_cuda.launches
    got = pa.paged_attention_cuda(q, kp, vp, pt, pos=pos, n_valid=nv,
                                  window=window)
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda.launches == before + 1
    want = pa.paged_attention_torch(q, kp, vp, pt, pos=pos, n_valid=nv,
                                    window=window)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else TOL[dtype]
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    for b, n in _valid_rows(case):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **tol)
        assert (got[b, n:] == 0).all()
    assert (got[2] == 0).all()  # idle row: nothing to attend -> 0


def test_key_splits_come_from_static_shapes():
    """The split count and scratch size depend on the page table's shape
    only, so the wrapper never reads pos, n_valid or the table back."""
    assert pa.SPLIT_KEYS == 64
    assert [pa.key_splits(16, n) for n in (1, 4, 5, 8, 10, 12)] == \
        [1, 1, 2, 2, 3, 3]
    assert pa.key_splits(2, 6) == 1 and pa.key_splits(4, 17) == 2
    assert pa.scratch_floats(8, 8, 16, 256, 16, 10) == 8 * 8 * 16 * 3 * 258


# Split edges (64 keys a split, 4 pages of 16): (H, K, D, C, npg, lens,
# nvs, window, holes). Rows: a range ending exactly on a split boundary
# (64, 128), a row spanning every split (192), one whose middle split
# maps no page, a window that drops the leading splits, GQA 8 (C x G =
# 64 rows), C x G past 64 rows (two row passes), decode C 1 at 190 keys;
# the last row is idle.
SPLIT_CASES = {
    "boundary": (4, 2, 128, 4, 12, [64, 128, 192, 5, 0], [1, 4, 3, 2, 1],
                 None, ()),
    "hole_split": (4, 4, 128, 4, 12, [192, 190, 70, 0], [4, 1, 2, 1], None,
                   [(0, 4), (0, 5), (0, 6), (0, 7), (1, 4), (1, 5), (1, 6),
                    (1, 7)]),
    "window_drops": (4, 2, 256, 4, 12, [190, 150, 66, 0], [1, 4, 2, 1], 40,
                     ()),
    "gqa8": (16, 2, 128, 8, 12, [190, 64, 100, 0], [8, 8, 3, 1], None, ()),
    "rows_past_64": (16, 2, 64, 16, 12, [130, 40, 0], [16, 9, 1], None, ()),
    "decode190": (4, 4, 256, 1, 12, [190, 190, 63, 0], [1, 1, 1, 1], None,
                  ()),
}


def _split_case(name, kind, dtype, device):
    H, K, D, C, npg, lens, nvs, window, holes = SPLIT_CASES[name]
    B = len(lens)
    q, kp, vp, pt, pos, nv = _case(
        seed=7, B=B, C=C, H=H, K=K, D=D, page=16, P=B * npg, npg=npg,
        lens=lens, nvs=nvs, idle=(B - 1,))
    for b, p in holes:
        pt[b, p] = -1
    tdt = getattr(torch, dtype)
    case = dict(q=torch.from_numpy(q).to(device, tdt),
                page_table=torch.from_numpy(pt).to(device),
                pos=torch.from_numpy(pos).to(device),
                n_valid=torch.from_numpy(nv).to(device))
    kpt, vpt = (torch.from_numpy(a).to(device) for a in (kp, vp))
    if kind:
        qz = quant.quantize_int8 if kind == "int8" else quant.quantize_int4
        case["kp"], case["kp_scale"] = qz(kpt)
        case["vp"], case["vp_scale"] = qz(vpt)
    else:
        case["kp"], case["vp"] = kpt.to(tdt), vpt.to(tdt)
    return case, window, nvs


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["", "int8", "int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_cuda_kernel_split_edges(cuda_device, name, dtype, kind):
    """Split-KV edges against the plain version on valid queries (fp32
    1e-4, bf16 the output's rounding); queries past n_valid and the idle
    row are 0; one call counts one launch of its pool kind."""
    case, window, nvs = _split_case(name, kind, dtype, cuda_device)
    pool = kind or dtype
    before = dict(pa.paged_attention_cuda.launches_by_kind)
    got = pa.paged_attention_cuda(**case, window=window)
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda.launches_by_kind[pool] == before[pool] + 1
    want = pa.paged_attention_torch(**case, window=window)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else TOL[dtype]
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    for b, n in enumerate(nvs[:-1]):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **tol,
                                   err_msg=f"row {b}")
        assert (got[b, n:] == 0).all()
    assert (got[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["", "int8", "int4"])
@pytest.mark.parametrize("name", ["gqa8", "hole_split", "rows_past_64"])
def test_cuda_kernel_is_deterministic(cuda_device, name, kind):
    """Reruns are bitwise equal: every sum has one fixed order and the
    splits merge in ascending order, with no atomics."""
    case, window, _ = _split_case(name, kind, "bfloat16", cuda_device)
    runs = [pa.paged_attention_cuda(**case, window=window) for _ in range(3)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
