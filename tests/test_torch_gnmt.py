"""The port's GNMT against ``repro.models.gnmt`` on the same (bridged)
weights, in fp32: loss and per-example nll, hoisted and in-loop, with a
target mask and lengths that make the scans chunk; the gradient of every
leaf against ``jax.grad``; three Adam steps of the reference's copy task;
the initialiser's names, shapes and scales; the port's scan against a
plain loop; the CLI on the CPU and its refusal without a card; and, on a
card only (marked ``cuda``), the kernels' path against the plain one."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.dist import split_tree  # noqa: E402
from repro.models import gnmt as JG  # noqa: E402
from repro.models import scan_utils as jax_scan  # noqa: E402
from repro.optim import adam as jax_adam  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro_torch.kernels import lstm_cell as lk  # noqa: E402
from repro_torch.launch import gnmt as cli  # noqa: E402
from repro_torch.models import gnmt as G  # noqa: E402
from repro_torch.models import scan_utils  # noqa: E402
from repro_torch.optim import adam, constant  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

FP32 = dict(dtype="float32")


def _cfgs(**kw):
    """GNMT_TINY on both sides, fp32."""
    kw = {**FP32, **kw}
    return (dataclasses.replace(JG.GNMT_TINY, **kw),
            dataclasses.replace(G.GNMT_TINY, **kw))


def _jax_params(cfg, seed=0):
    tree = split_tree(JG.init_gnmt(cfg, jax.random.PRNGKey(seed)))[0]
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(vocab, B, s_src, s_tgt, seed=0):
    """src, tgt int32 and a tgt_mask with ragged real lengths (row 0
    full, the others padded), as numpy."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, vocab, (B, s_src)).astype(np.int32)
    tgt = rng.integers(1, vocab, (B, s_tgt)).astype(np.int32)
    lens = np.concatenate([[s_tgt], rng.integers(2, s_tgt + 1, B - 1)])
    mask = (np.arange(s_tgt)[None, :] < lens[:, None]).astype(np.float32)
    return {"src": src, "tgt": tgt, "tgt_mask": mask}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# (src length, tgt length): encoder S 70 scans 2 chunks of 35 and decoder
# S 40 two chunks of 20; a prime S 37 is one encoder chunk and 37 decoder
# chunks of 1.
LENGTHS = [(70, 40), (37, 37)]


def test_scan_chunking_of_the_cases():
    div = scan_utils._largest_divisor_leq
    assert div(70, 64) == 35 and div(40, 32) == 20
    assert div(37, 64) == 37 and div(37, 32) == 1
    for n, k in [(70, 64), (40, 32), (37, 32), (12, 5), (1, 256)]:
        assert div(n, k) == jax_scan._largest_divisor_leq(n, k)


@pytest.mark.parametrize("hoist", [True, False], ids=["hoisted", "in_loop"])
@pytest.mark.parametrize("lengths", LENGTHS, ids=str)
def test_loss_nll_and_every_gradient_match_reference(lengths, hoist):
    """Loss and per-example nll within 1e-5; every leaf's gradient within
    1e-4 of the largest entry of its reference (rel. 1e-4)."""
    jcfg, cfg = _cfgs(hoist_input_projection=hoist)
    tree = _jax_params(jcfg)
    nb = _batch(jcfg.vocab, 3, *lengths)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JG.loss_fn(p, jcfg, jb), has_aux=True))(tree)
    jnll, _ = jax.jit(lambda p: JG.per_example_nll(p, jcfg, jb))(tree)

    params = G.params_from_numpy(tree, device="cpu")
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    loss, aux = G.loss_fn(params, cfg, _to_torch(nb))
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        nll, zero = G.per_example_nll(params, cfg, _to_torch(nb))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5, atol=1e-5)
    assert aux["nll"] is loss
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=1e-5,
                               atol=1e-5)
    assert float(zero) == 0.0
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads) == 3 * (2 + 1 + 2) + 2
    for g, w in zip(grads, jleaves):
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0,
                                   atol=1e-4)


def test_three_adam_steps_match_reference_copy_task():
    """``test_gnmt_trains``'s copy task (src (4, 10), tgt = src shifted)
    under ``adam(constant(3e-3))``: three losses within 1e-4."""
    jcfg, cfg = _cfgs()
    tree = _jax_params(jcfg)
    rng = np.random.default_rng(0)
    src = rng.integers(1, jcfg.vocab, (4, 10)).astype(np.int32)
    tgt = np.concatenate([src[:, :1], src[:, :-1]], 1)
    opt = jax_adam(jax_constant(3e-3))
    st = opt.init(tree)
    batch = {"src": jnp.asarray(src), "tgt": jnp.asarray(tgt)}

    @jax.jit
    def step(vals, st):
        (l, _), g = jax.value_and_grad(
            lambda p: JG.loss_fn(p, jcfg, batch), has_aux=True)(vals)
        vals, st = opt.update(g, st, vals)
        return vals, st, l

    want, vals = [], tree
    for _ in range(3):
        vals, st, l = step(vals, st)
        want.append(float(l))

    params = G.params_from_numpy(tree, device="cpu")
    topt = adam(constant(3e-3))
    tst = topt.init(params)
    tstep = cli.make_train_step(cfg, topt)
    tb = {"src": torch.from_numpy(src), "tgt": torch.from_numpy(tgt)}
    got = []
    for _ in range(3):
        params, tst, loss = tstep(params, tst, tb)
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert got[-1] < got[0]


def test_init_matches_reference_names_shapes_and_scales():
    for jcfg, cfg in (_cfgs(), (JG.GNMTConfig(), G.GNMTConfig())):
        want = jax.eval_shape(lambda k, c=jcfg: split_tree(
            JG.init_gnmt(c, k))[0], jax.random.PRNGKey(0))
        shapes = jax.tree_util.tree_map(lambda a: a.shape, want)
        if cfg.d_model <= 64:
            params = G.init_gnmt(cfg, seed=0, device="cpu")
            assert sorted(params) == sorted(shapes)
            for name, sub in shapes.items():
                if isinstance(sub, dict):
                    assert {k: tuple(params[name][k].shape) for k in sub} \
                        == {k: tuple(v) for k, v in sub.items()}
                else:
                    assert tuple(params[name].shape) == tuple(sub)
            F = cfg.d_model
            assert params["enc1"]["w_x"].std().item() == pytest.approx(
                (2 * F) ** -0.5, rel=0.05)
            assert params["dec0"]["w_h"].std().item() == pytest.approx(
                F ** -0.5, rel=0.05)
            assert (params["enc_fwd0"]["b"] == 0).all()
            assert all(p.dtype == torch.float32 for p in tree_leaves(params))
            again = G.init_gnmt(cfg, seed=0, device="cpu")
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(params), tree_leaves(again)))
        else:  # the published widths: count only
            n = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
                shapes, is_leaf=lambda x: isinstance(x, tuple)))
            assert n == 162_041_856


def test_chunked_scan_with_remat_equals_one_plain_loop():
    """Chunked and checkpointed (chunks of 4 and of 3) against one plain
    loop (a chunk of 12): the same carry, outputs and gradient."""
    torch.manual_seed(0)
    w = torch.randn(8, 8, requires_grad=True)
    xs = torch.randn(12, 3, 8)

    def f(carry, x):
        carry = torch.tanh(carry @ w + x)
        return carry, carry.sum(-1)

    outs = []
    for chunk in (12, 5, 3):
        carry, ys = scan_utils.chunked_scan(f, torch.zeros(3, 8), xs,
                                            chunk=chunk)
        (g,) = torch.autograd.grad(carry.sum() + ys.sum(), w)
        outs.append((carry, ys, g))
    for carry, ys, g in outs[1:]:
        torch.testing.assert_close(carry, outs[0][0], rtol=0, atol=1e-6)
        torch.testing.assert_close(ys, outs[0][1], rtol=0, atol=1e-6)
        torch.testing.assert_close(g, outs[0][2], rtol=0, atol=1e-5)
    assert outs[0][1].shape == (12, 3)


@pytest.fixture
def counted_kernels(monkeypatch):
    """``ops.lstm_cell`` routed through ``LSTMCell`` on the CPU, its two
    kernels swapped for their plain versions, with the wrappers' launch
    counters: the path the card takes, countable here."""
    def fwd(xp, h, c, w, b, *, save_gates=False):
        fwd.launches += 1
        h2, c2 = lk.lstm_cell_torch(xp, h, c, w, b)
        if not save_gates:
            return h2, c2, None
        pre = xp.float() + h.float() @ w.float() + b
        i, f, g, o = pre.chunk(4, dim=-1)
        return h2, c2, torch.cat([torch.sigmoid(i), torch.sigmoid(f),
                                  torch.tanh(g), torch.sigmoid(o)], -1)

    def bwd(*args):
        bwd.launches += 1
        return lk.lstm_cell_bwd_torch(*args)

    fwd.launches = bwd.launches = 0
    monkeypatch.setattr(lk, "lstm_cell_fwd_cuda", fwd)
    monkeypatch.setattr(lk, "lstm_cell_bwd_cuda", bwd)
    monkeypatch.setattr(G.ops, "lstm_cell", lk.lstm_cell_cuda)
    return fwd, bwd


@pytest.mark.parametrize("L", [12, 40, 37])
def test_kernel_launches_per_step_follow_the_formula(counted_kernels, L):
    """One train step on src = tgt of padded length L <= 64 launches the
    forward kernel 5L + 4L*r times (r = 2 when the decoder's scan has
    more than one chunk, which the backward recomputes) and the backward
    9L times, for GNMT's 4 + 4 layers (a forward without a gradient: 9L,
    no gates); the loss and gradients equal the plain path's."""
    cfg = dataclasses.replace(G.GNMT_TINY, dtype="float32", n_enc_layers=4,
                              n_dec_layers=4)
    fwd, bwd = counted_kernels
    params = G.init_gnmt(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(L).integers(
        1, cfg.vocab, (2, L)))
    batch = {"src": toks, "tgt": toks, "tgt_mask": torch.ones(2, L)}
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    loss, _ = G.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    r = 2 if L > 32 else 1
    assert (fwd.launches, bwd.launches) == (5 * L + 4 * L * r, 9 * L)
    with torch.no_grad():
        G.loss_fn(params, cfg, batch)
    assert (fwd.launches, bwd.launches) == (14 * L + 4 * L * r, 9 * L)
    G.ops.lstm_cell = lk.lstm_cell_torch
    want_loss, _ = G.loss_fn(params, cfg, batch)
    want = torch.autograd.grad(want_loss, leaves)
    assert loss.item() == pytest.approx(want_loss.item(), abs=1e-6)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_cli_runs_on_cpu(capsys):
    assert cli.main(["--device", "cpu", "--steps", "3", "--batch", "4",
                     "--max-len", "12"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("padding waste: bucketized=")
    assert out[1] == "host shard sizes: [16, 16, 16, 16]"
    assert out[2].startswith("batch 0: len=")
    assert out[-1].startswith("done {'batch': 2, 'len': ")
    assert "'fwd_launches': 0, 'bwd_launches': 0" in out[-1]


def test_cli_data_equals_the_example_stream():
    """The CLI's sentences are the example's (``max_len`` 39, seed 0)."""
    rng = np.random.default_rng(0)
    want = [np.asarray(rng.integers(1, 512, rng.integers(4, 40)), np.int32)
            for _ in range(128)]
    got = cli.synthetic_sentences(512, 128, 39)
    assert len(got) == 128
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and np.array_equal(a, b)


def test_cli_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.init_gnmt(G.GNMT_TINY)


# --------------------------------------------------------------------------- #
# On the card (skipped without one).
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", LENGTHS, ids=str)
def test_cuda_loss_and_gradients_match_cpu(cuda_device, lengths):
    """fp32 GNMT_TINY through the kernels on the card against the plain
    path on the CPU: loss within 1e-4, every gradient within 1e-3 of its
    largest entry, and the launch counts of the formula (encoder 3 layers
    here, decoder 2 cells a step, recomputed when it chunks)."""
    jcfg, cfg = _cfgs()
    tree = _jax_params(jcfg)
    nb = _batch(cfg.vocab, 3, *lengths)
    out = {}
    before = (lk.lstm_cell_fwd_cuda.launches, lk.lstm_cell_bwd_cuda.launches)
    for dev in ("cpu", cuda_device):
        params = G.params_from_numpy(tree, device=dev)
        leaves = tree_leaves(params)
        for w in leaves:
            w.requires_grad_(True)
        batch = {k: v.to(dev) for k, v in _to_torch(nb).items()}
        loss, _ = G.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        out[str(dev)] = (loss.item(), [g.cpu() for g in grads])
    Ss, St = lengths
    enc_chunks = Ss // scan_utils._largest_divisor_leq(Ss, 64)
    r = 2 if St // scan_utils._largest_divisor_leq(St, 32) > 1 else 1
    enc_fwd = 3 * Ss * (2 if enc_chunks > 1 else 1)
    assert (lk.lstm_cell_fwd_cuda.launches - before[0],
            lk.lstm_cell_bwd_cuda.launches - before[1]) == (
        enc_fwd + 2 * St * r, 3 * Ss + 2 * St)
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda_device)]
    assert abs(lc - lg) < 1e-4
    for a, b in zip(gc, gg):
        scale = max(a.abs().max().item(), 1e-12)
        torch.testing.assert_close(b / scale, a / scale, rtol=0, atol=1e-3)
