"""jamba-1.5-large's training path in the port against the JAX reference
on the same numpy inputs: the plain backward of the selective scan
against ``jax.vjp`` of ``repro.kernels.ops._mamba_scan_jnp``, the
chunked autograd route (``kernels.mamba.MambaScan``) against autograd
through the plain scan, ``apply_mamba``'s gradients, ``A`` and ``D``
under the train step's cast, reduced jamba's train step (fp32, and with
bf16 gradients and moments over 2 microbatches), three ``Trainer.fit``
steps with an async checkpoint and a bitwise resume, and the CLI. The
kernels themselves are held against these plain versions on the card
(``tests/test_torch_mamba_cuda.py``, ``chip_smoke.py``).

Tolerances: the scan's gradients rtol 1e-4 / atol 1e-5 as the forward's
(both fp32, sums in other orders), du with bf16 u one bf16 ulp beyond
that (both round an fp32 du once); the chunked route against plain
autograd rtol 1e-5 / atol 1e-6 (the same recurrence, other sum orders);
``apply_mamba`` rtol 1e-4 with atol 1e-5 of each leaf's largest
gradient; the train step as ``tests/test_torch_archs.py`` (loss rtol
1e-5, fp32 gradients rtol 1e-4 / atol 1e-6) and
``tests/test_torch_moe_train.py`` (bf16 within 2^-6 relative plus 2^-6
of the leaf's largest entry); ``A`` under the cast bit for bit."""
import dataclasses
import itertools
import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import Rules, split_tree  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.launch.mesh import single_device_mesh  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.optim import adam as jax_adam  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim.precision import compute_cast as jax_compute_cast  # noqa: E402
from repro.train import steps as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.data.pipeline import synthetic_lm_batches  # noqa: E402
from repro_torch.kernels import mamba as mk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adam, compute_cast, constant  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import steps as T  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_archs import (  # noqa: E402
    assert_grads_match,
    cfgs,
    flat_jax_grads,
    ref_tree,
    train_step_both,
)
from test_torch_moe_train import assert_bf16_close  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on the machine's cores, and oversubscribed torch threads
    slowed these tests several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "jamba-1.5-large-398b"
LR = 1e-3
NAMES = ("du", "ddt", "dA", "dB", "dC", "dD")


def _scan_inputs(Bt, S, Di, N, seed=0):
    """tests/test_kernels.py's recipe, from numpy: u ~ 0.5 N, dt = 0.1
    softplus(N), A = -|N|, B, C ~ 0.3 N, D ~ 0.1 N, and cotangents dy
    ~ N for y and dh ~ N for the final state (all fp32)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (0.5 * n(Bt, S, Di), 0.1 * np.logaddexp(n(Bt, S, Di), 0),
            -np.abs(n(Di, N)), 0.3 * n(Bt, S, N), 0.3 * n(Bt, S, N),
            0.1 * n(Di)), (n(Bt, S, Di), n(Bt, Di, N))


def _bf16(x):
    """x rounded to bf16 as JAX rounds it, back in fp32 numpy."""
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _ulp(x):
    """One bf16 ulp at each value of x (8 significant bits)."""
    _, e = np.frexp(x)
    return np.ldexp(np.ones_like(x), e - 8)


# ---- the plain backward against jax.vjp of the reference's scan ----------- #
@pytest.mark.parametrize("with_dh", [False, True], ids=["dy", "dy+dh"])
@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 1, 12, 16), (2, 37, 24, 16),
                                   (1, 40, 20, 5)], ids=str)
def test_plain_backward_matches_vjp_of_reference_scan(shape, u_dtype,
                                                      with_dh):
    """All six gradients of ``_mamba_scan_jnp`` (the reference's CPU scan,
    a chunked, checkpointed ``lax.scan``) for cotangents on y alone and
    on y and the final state, against ``mamba_scan_bwd_torch`` from the
    boundary states ``mamba_scan_torch`` saved every 16 steps (S 1 saves
    none; S 37 ends in a short chunk)."""
    (u, dt, A, B, C, D), (dy, dh) = _scan_inputs(*shape, seed=sum(shape))
    if not with_dh:
        dh = np.zeros_like(dh)
    jdt = jnp.bfloat16 if u_dtype == "bfloat16" else jnp.float32
    if u_dtype == "bfloat16":
        u, dy = _bf16(u), _bf16(dy)
    ju = jnp.asarray(u, jdt)
    (want_y, _), vjp = jax.vjp(jax_ops._mamba_scan_jnp, ju,
                               *map(jnp.asarray, (dt, A, B, C, D)))
    want = vjp((jnp.asarray(dy, jdt), jnp.asarray(dh)))
    tdt = getattr(torch, u_dtype)
    args = [torch.from_numpy(u).to(tdt)] + [torch.from_numpy(a) for a in
                                             (dt, A, B, C, D)]
    y, _, hs = mk.mamba_scan_torch(*args, state_every=16)
    assert hs.shape == (shape[0], (shape[1] - 1) // 16, shape[2], shape[3])
    got = mk.mamba_scan_bwd_torch(
        *args, hs, torch.from_numpy(dy).to(tdt),
        torch.from_numpy(dh) if with_dh else None, state_every=16)
    assert y.dtype == tdt and got[0].dtype == tdt
    assert all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(NAMES, got, want):
        g = g.float().numpy()
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert g.shape == w.shape, name
        if name == "du" and u_dtype == "bfloat16":
            # both round an fp32 du held to the fp32 tolerance to bf16 once
            assert (np.abs(g - w) <= _ulp(w) + 1e-5 + 1e-4 * np.abs(w)).all()
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


# ---- the chunked autograd route against autograd of the plain scan -------- #
@pytest.mark.parametrize("K", [1, 16, 37, 10], ids=lambda k: f"K{k}")
def test_chunked_route_equals_autograd_through_plain_scan(K):
    """``ops.mamba_scan`` where autograd records goes through
    ``MambaScan``: its forward is the plain scan (y and h bitwise), its
    backward rebuilds each K-step chunk from the saved boundary states
    in reverse chunk order (K 37 = S: one chunk; K 10 leaves a last chunk
    of 7). Its gradients equal autograd's through ``mamba_scan_torch``,
    B and C reaching ``x_dbl`` through their column views."""
    (u, dt, A, B, C, D), (dy, dh) = _scan_inputs(2, 37, 12, 5, seed=3)

    def leaves():
        x = torch.from_numpy(np.concatenate([B, C], -1)).requires_grad_()
        rest = [torch.from_numpy(a).requires_grad_()
                for a in (u, dt, A, D)]
        return x, rest

    loss = lambda y, h: (y * torch.from_numpy(dy)).sum() + (  # noqa: E731
        h * torch.from_numpy(dh)).sum()
    N = A.shape[1]
    outs = {}
    for route in ("plain", "chunked"):
        x, (tu, tdt, tA, tD) = leaves()
        Bv, Cv = x[..., :N], x[..., N:]
        fn = (mk.mamba_scan_torch if route == "plain"
              else lambda *a: ops.mamba_scan(*a, state_every=K))
        y, h = fn(tu, tdt, tA, Bv, Cv, tD)
        grads = torch.autograd.grad(loss(y, h), [tu, tdt, tA, x, tD])
        outs[route] = (y.detach(), h.detach(), grads)
    assert torch.equal(outs["plain"][0], outs["chunked"][0])
    assert torch.equal(outs["plain"][1], outs["chunked"][1])
    for a, b in zip(outs["plain"][2], outs["chunked"][2]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_ops_routes_through_mamba_scan_only_when_autograd_records(
        monkeypatch):
    """Serving (no gradient) takes the forward alone; a recording forward
    takes ``MambaScan``, which saves boundary states every
    ``STATE_EVERY`` steps; on CPU tensors both are the plain versions."""
    (u, dt, A, B, C, D), _ = _scan_inputs(1, 40, 8, 4, seed=5)
    args = [torch.from_numpy(a) for a in (u, dt, A, B, C, D)]
    seen = []
    real = mk.mamba_scan_torch

    def spy(*a, **kw):
        seen.append(kw.get("state_every"))
        return real(*a, **kw)

    monkeypatch.setattr(mk, "mamba_scan_torch", spy)
    with torch.no_grad():
        ops.mamba_scan(*args)
    ops.mamba_scan(*args)  # nothing requires a gradient
    args[0].requires_grad_()
    y, _ = ops.mamba_scan(*args)
    assert seen == [None, None, mk.STATE_EVERY] and y.requires_grad
    before = mk.mamba_scan_bwd_cuda.launches
    y.sum().backward()
    assert args[0].grad is not None
    assert mk.mamba_scan_bwd_cuda.launches == before


def test_backward_wrapper_refuses_cpu_tensors():
    """The CUDA backward's wrapper raises on CPU tensors (the plain
    version is ``mamba_scan_bwd_torch``) and counts nothing."""
    (u, dt, A, B, C, D), (dy, _) = _scan_inputs(1, 20, 8, 4)
    args = [torch.from_numpy(a) for a in (u, dt, A, B, C, D)]
    _, _, hs = mk.mamba_scan_torch(*args, state_every=16)
    before = mk.mamba_scan_bwd_cuda.launches
    with pytest.raises(ValueError, match="mamba_scan_bwd_torch"):
        mk.mamba_scan_bwd_cuda(*args, hs, torch.from_numpy(dy),
                               state_every=16)
    with pytest.raises(ValueError, match="CUDA"):
        mk.mamba_scan_cuda(*args, state_every=16)
    assert mk.mamba_scan_bwd_cuda.launches == before


# ---- the mixer: gradients, and A and D under the train step's cast -------- #
@pytest.fixture(scope="module")
def mixer():
    """One reduced jamba Mamba mixer's reference weights (fp32, with
    ``dt_bias``, ``conv_b`` and ``D`` perturbed so that each gradient is
    generic) and an input of 2 x 37 (a last chunk of 5 steps)."""
    ref_cfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    vals, _ = split_tree(jax_layers.init_mamba(ref_cfg,
                                               jax.random.PRNGKey(5)))
    vals = {k: np.array(v) for k, v in vals.items()}
    rng = np.random.default_rng(6)
    for k in ("dt_bias", "conv_b", "D"):
        vals[k] = (vals[k] + 0.3 * rng.standard_normal(vals[k].shape)
                   ).astype(np.float32)
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    w_out = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    w_ssm = rng.standard_normal((2, 2 * cfg.d_model, 16)).astype(np.float32)
    return ref_cfg, cfg, vals, x, w_out, w_ssm


def test_apply_mamba_gradients_match_reference(mixer):
    """The gradient of ``sum(out * w_out) + sum(ssm * w_ssm)`` as to x and
    every leaf of the mixer: ``jax.grad`` of the reference's
    ``apply_mamba`` against the port's autograd (its scan through
    ``MambaScan``)."""
    ref_cfg, cfg, vals, x, w_out, w_ssm = mixer

    def ref_loss(prm, xx):
        out, cache = jax_layers.apply_mamba(prm, xx, ref_cfg)
        return jnp.sum(out * w_out) + jnp.sum(cache["ssm"] * w_ssm)

    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in vals.items()}, jnp.asarray(x))
    prm = {k: torch.from_numpy(v.copy()).requires_grad_()
           for k, v in vals.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, cache = L.apply_mamba(prm, tx, cfg)
    loss = (out * torch.from_numpy(w_out)).sum() + (
        cache["ssm"] * torch.from_numpy(w_ssm)).sum()
    names = sorted(prm)
    got = torch.autograd.grad(loss, [tx] + [prm[k] for k in names])
    for name, g, w in zip(["x"] + names, got,
                          [want_x] + [want_p[k] for k in names]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def _cast_pair(seed=7):
    """The reference's and the port's compute copies of reduced jamba
    (two blocks, bf16 compute) from the same fp32 masters."""
    P = len(get_config(ARCH).reduced().block_pattern)
    jcfg, cfg = cfgs(ARCH, dtype="bfloat16", n_layers=2 * P)
    tree = ref_tree(jcfg, seed)
    _, axes = JT.init_params_and_axes(jcfg, jax.random.PRNGKey(0))
    rules = Rules(single_device_mesh(), jcfg.param_sharding,
                  seq_parallel=jcfg.seq_parallel)
    want = jax_compute_cast(jax.tree_util.tree_map(jnp.asarray, tree), axes,
                            rules, "bfloat16")
    masters = lm.params_from_numpy(tree, cfg, device="cpu",
                                   dtype=torch.float32)
    return cfg, tree, want, masters


def test_a_under_the_train_cast_is_the_reference_bf16_exp():
    """Under the train step's cast ``A_log`` is bf16 on both sides and the
    reference forms ``A = -exp(A_log)`` in bf16 (``layers.py:663``): the
    port's A (widened for the scan) equals it bit for bit in every Mamba
    layer. Serving keeps ``A_log`` fp32 and A is ``-exp`` in fp32, as it
    was."""
    cfg, tree, want, masters = _cast_pair()
    got = compute_cast(masters, "bfloat16")
    flat = flat_jax_grads(want, cfg.n_layers)
    u = torch.zeros((1, 1, 2 * cfg.d_model), dtype=torch.bfloat16)
    served = lm.params_from_numpy(tree, dataclasses.replace(
        cfg, dtype="bfloat16"), device="cpu")
    n = 0
    for i, spec in enumerate(cfg.block_pattern * 2):
        if spec.mixer != "mamba":
            continue
        ref_alog = flat["layers"][i]["mixer"]["A_log"]
        assert ref_alog.dtype == jnp.bfloat16
        want_a = np.asarray((-jnp.exp(ref_alog)).astype(jnp.float32))
        prm = got["layers"][i]["mixer"]
        assert prm["A_log"].dtype == torch.bfloat16
        _, A, _, _, _ = L._mamba_ssm_inputs(prm, u, cfg)
        assert A.dtype == torch.float32
        np.testing.assert_array_equal(A.numpy(), want_a)
        sp = served["layers"][i]["mixer"]
        assert sp["A_log"].dtype == torch.float32
        _, A_serve, _, _, _ = L._mamba_ssm_inputs(sp, u, cfg)
        assert torch.equal(A_serve, -torch.exp(sp["A_log"].float()))
        assert not torch.equal(A_serve, A)  # the cast does round
        n += 1
    assert n == 4


def test_d_reaches_the_scan_in_fp32_under_the_train_cast(monkeypatch):
    """The cast makes ``D`` (and ``dt_bias``) bf16, stacked over blocks in
    the reference; the CUDA scan takes fp32 only, so the mixer widens
    them: every operand but u reaches ``ops.mamba_scan`` in fp32, and D's
    gradient reaches the bf16 leaf."""
    cfg, _, _, masters = _cast_pair(seed=8)
    prm = compute_cast(masters, "bfloat16")["layers"][0]["mixer"]
    assert prm["D"].dtype == prm["dt_bias"].dtype == torch.bfloat16
    seen = []
    real = ops.mamba_scan

    def spy(*a):
        seen.append([t.dtype for t in a])
        return real(*a)

    monkeypatch.setattr(ops, "mamba_scan", spy)
    for t in prm.values():
        t.requires_grad_()
    x = torch.randn((1, 5, cfg.d_model),
                    generator=torch.Generator().manual_seed(0)).bfloat16()
    out, _ = L.apply_mamba(prm, x, cfg)
    assert seen == [[torch.bfloat16] + [torch.float32] * 5]
    (gD,) = torch.autograd.grad(out.float().sum(), [prm["D"]])
    assert gD.dtype == torch.bfloat16 and gD.abs().max() > 0


# ---- the train step ------------------------------------------------------- #
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_loss_and_every_gradient_match_reference(remat):
    """Reduced jamba (a Mamba + dense, a Mamba + MoE and an attention +
    dense layer) in fp32: the reference's ``make_train_step`` (with its
    rules and axes, so ``compute_cast`` runs) against the port's, on the
    same weights and batch; with ``remat`` each layer recomputes its
    scan in the backward pass."""
    jcfg, cfg = cfgs(ARCH, remat=remat)
    tree = ref_tree(jcfg, seed=9)
    tokens = data._zipf_tokens(np.random.default_rng(10), (2, 40),
                               cfg.vocab)
    (wstate, wm), (state, m) = train_step_both(jcfg, cfg, tree, tokens)
    np.testing.assert_allclose(m["loss"].item(), float(wm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["nll"].item(), float(wm["nll"]), rtol=1e-5)
    assert m["loss"].item() > m["nll"].item()  # the MoE aux term
    assert_grads_match(wstate["opt"], state["opt"], cfg.n_layers)


def test_gradient_is_the_masters_bitwise():
    """The train step takes the gradient at the compute copy's leaves and
    folds it into the microbatch sum leaf by leaf; that is bitwise
    autograd's gradient at the fp32 masters through the cast, in bf16 as
    in fp32."""
    jcfg, cfg = cfgs(ARCH, dtype="bfloat16", grad_dtype="bfloat16")
    tree = ref_tree(jcfg, seed=11)
    batch = {"tokens": torch.from_numpy(data._zipf_tokens(
        np.random.default_rng(12), (2, 24), cfg.vocab))}
    for gdt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, grad_dtype=gdt)
        params = lm.params_from_numpy(tree, c, device="cpu",
                                      dtype=torch.float32)
        acc = [None] * len(tree_leaves(params))
        T._value_and_grad(c, params, batch, acc)
        leaves = tree_leaves(params)
        for w in leaves:
            w.requires_grad_(True)
        loss, _ = lm.loss_fn(compute_cast(params, c.dtype), c, batch)
        want = [g.to(getattr(torch, gdt))
                for g in torch.autograd.grad(loss, leaves)]
        for a, b in zip(acc, want, strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_microbatched_bf16_adam_step_matches_reference():
    """2 microbatches, gradients summed in bf16 in microbatch order and
    halved in bf16, Adam with bf16 moments (jamba's published
    ``grad_dtype`` and ``moment_dtype``): the gradient the optimizer gets,
    then one Adam step's moments and weights."""
    jcfg, cfg = cfgs(ARCH, grad_dtype="bfloat16", microbatches=2)
    assert (cfg.moment_dtype, cfg.grad_dtype) == ("bfloat16",) * 2
    tree = ref_tree(jcfg, seed=13)
    tokens = data._zipf_tokens(np.random.default_rng(14), (4, 24), cfg.vocab)
    (wstate, wm), (state, m) = train_step_both(jcfg, cfg, tree, tokens)
    np.testing.assert_allclose(m["loss"].item(), float(wm["loss"]),
                               rtol=1e-5)
    want = jax.tree_util.tree_leaves(flat_jax_grads(wstate["opt"],
                                                    cfg.n_layers))
    assert len(state["opt"]) == len(want)
    for g, w in zip(state["opt"], want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert_bf16_close(g, w)

    jopt = jax_adam(jax_constant(LR), b1=0.9, b2=0.95, eps=1e-8,
                    moment_dtype="bfloat16")
    opt = adam(constant(LR), b1=0.9, b2=0.95, eps=1e-8,
               moment_dtype="bfloat16")
    (wstate, _), (state, _) = train_step_both(jcfg, cfg, tree, tokens,
                                              jopt, opt)
    n = cfg.n_layers
    for name in ("m", "v"):
        got = tree_leaves(state["opt"][name])
        ref = jax.tree_util.tree_leaves(flat_jax_grads(
            wstate["opt"][name], n))
        for g, w in zip(got, ref, strict=True):
            assert g.dtype == torch.bfloat16
            assert_bf16_close(g, w)
    # Adam's first step moves each weight by about lr * sign(g): a weight
    # whose bf16 gradient is near 0 may move differently, no other.
    got = tree_leaves(state["params"])
    ref = jax.tree_util.tree_leaves(flat_jax_grads(wstate["params"], n))
    moved = off = 0
    for g, w in zip(got, ref, strict=True):
        d = np.abs(g.detach().numpy() - np.asarray(w))
        moved += d.size
        off += int((d > 1e-3 * LR).sum())
        assert d.max() <= 2.01 * LR
    assert off <= 1e-3 * moved


def test_adam_slices_change_no_value(monkeypatch):
    """The update runs a slice of ``SLICE`` elements at a time; with tiny
    slices every weight and moment is bitwise the whole-leaf update's."""
    import importlib

    adam_mod = importlib.import_module("repro_torch.optim.adam")
    gen = torch.Generator().manual_seed(15)
    params = {"w": torch.randn((7, 33), generator=gen),
              "b": torch.randn((5,), generator=gen)}
    grads = {"w": torch.randn((7, 33), generator=gen).bfloat16(),
             "b": torch.randn((5,), generator=gen).bfloat16()}
    out = []
    for sl in (adam_mod.SLICE, 10):
        monkeypatch.setattr(adam_mod, "SLICE", sl)
        opt = adam(constant(LR), b1=0.9, b2=0.95, eps=1e-8,
                   moment_dtype="bfloat16")
        p = {k: v.clone() for k, v in params.items()}
        st = opt.init(p)
        for _ in range(2):
            p, st = opt.update(grads, st, p)
        out.append(tree_leaves(p) + tree_leaves(st["m"])
                   + tree_leaves(st["v"]))
    assert all(torch.equal(a, b) for a, b in zip(*out, strict=True))


def test_trainer_fits_and_resumes_bitwise_from_an_async_checkpoint(
        tmp_path):
    """Reduced jamba with its published 8 microbatches, bf16 gradients
    and moments: 3 ``Trainer.fit`` steps with finite losses and an async
    checkpoint at step 2 (Mamba leaves and bf16 moments included); a
    fresh trainer resumed from it takes step 3 to the same loss and
    state, bitwise."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), microbatches=8)
    assert (cfg.grad_dtype, cfg.moment_dtype) == ("bfloat16",) * 2

    def run(resume=None, every=2):
        tr = Trainer(cfg, TrainerConfig(
            total_steps=3, log_every=0, checkpoint_every=every,
            checkpoint_dir=str(tmp_path / "run"), async_checkpoint=True),
            device="cpu")
        start = tr.resume(resume) if resume else 0
        return tr, tr.fit(itertools.islice(
            synthetic_lm_batches(cfg, batch=8, seq=16, steps=3), start,
            None))

    full, hist = run()
    losses = [r["loss"] for r in hist]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert sorted(os.listdir(str(tmp_path / "run"))) == ["step_2", "step_3"]
    names = open(str(tmp_path / "run" / "step_2" / "manifest.json")).read()
    assert "A_log" in names and "bfloat16" in names

    def parts(tr):
        from repro_torch.train import checkpoint as ckpt
        from repro_torch.utils import Stacked
        return [p.detach().clone()
                for leaf in ckpt._flatten_with_names(tr.checkpoint_tree())[1]
                for p in (leaf.parts if isinstance(leaf, Stacked)
                          else [leaf])]

    want = parts(full)
    cont, tail = run(resume=str(tmp_path / "run" / "step_2"), every=0)
    assert [r["loss"] for r in tail] == losses[2:]
    assert all(torch.equal(a, b) for a, b in zip(parts(cont), want,
                                                 strict=True))


def test_cli_trains_reduced_jamba_on_cpu(capsys):
    assert cli.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                     "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [x.split(":")[0] for x in out[:2]] == ["step 1", "step 2"]
    for line in out[:2]:
        loss = float(line.split("loss=")[1].split()[0])
        assert math.isfinite(loss)
    assert out[-1].startswith("done {'step': 2, 'loss': ")
