"""The port's MLPerf Transformer (``repro_torch.models.transformer_mlperf``)
against the JAX reference (``repro.models.transformer_mlperf``):
``TRANSFORMER_TINY`` (2 + 2 layers, d 128, 4 heads of 32, ReLU FFN 256,
vocab 512, tied embedding), its weights from the reference's
``init_transformer`` through ``encdec.params_from_numpy`` with perturbed
norm scales and biases, token batches from a numpy seed, fp32 compute on
both sides unless a test says otherwise.

Held: the configs; the published parameter count from shapes; the
bridge's tree; the bf16 embedding scale rounded as JAX rounds its
weak-typed scalar; the encoder output and the logits; the loss and every
gradient with padded targets and with targets that are all padding;
remat on and off equal; the tied embedding's gradient in bf16 compute,
which must be the fp32 sum of its three uses' cotangents (a single bf16
copy used three times sums them in bf16); 3 steps of ``adam(constant(1e-3))`` through
``launch/mlperf.py`` against fig9's jitted step; the CLI on the CPU,
twice.

Tolerances: fp32 activations and logits rtol 1e-4 / atol 1e-5, fp32
gradients rtol 1e-4 / atol 1e-6, the loss rtol 1e-5 (sums in other
orders); the Adam steps' losses atol 1e-5 and the weights after them
atol 1e-4 (Adam divides each gradient element by its own magnitude, so
an element whose gradient is near 0 moves by up to the learning rate on
rounding; one of 32,768 moved 1.8e-5); the bf16 embedding gradient within 1e-5 of its largest
entry from the fp32 sum of its uses' cotangents, and within 2e-2 of the
reference's (bf16 activations of two frameworks)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.dist import split_tree  # noqa: E402
from repro.models import transformer_mlperf as JTM  # noqa: E402
from repro.optim import adam as jax_adam  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import mlperf as cli  # noqa: E402
from repro_torch.models import encdec, lm  # noqa: E402
from repro_torch.models import transformer_mlperf as TM  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

FP32 = dict(dtype="float32")


def cfgs(**kw):
    kw = {**FP32, **kw}
    return (dataclasses.replace(JTM.TRANSFORMER_TINY, **kw),
            dataclasses.replace(TM.TRANSFORMER_TINY, **kw))


def ref_tree(jcfg, seed=0):
    vals = jax.jit(lambda k: split_tree(JTM.init_transformer(jcfg, k))[0])(
        jax.random.PRNGKey(seed))
    return lm.perturb_norms(jax.tree_util.tree_map(np.asarray, vals),
                            seed + 100)


def bridge(tree, cfg):
    return encdec.params_from_numpy(tree, cfg, device="cpu",
                                    dtype=torch.float32)


def tokens(cfg, seed, B=2, Ss=14, St=12, pad=4):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, cfg.vocab, (B, Ss)).astype(np.int32)
    tgt = rng.integers(1, cfg.vocab, (B, St)).astype(np.int32)
    if pad:
        tgt[:, -pad:] = 0
    return {"src": src, "tgt": tgt}


def per_layer(g, cfg):
    """The reference's tree (blocks stacked over layers) in the port's
    layout: one dict a layer."""
    def split(stacked, n):
        return [jax.tree_util.tree_map(lambda a, i=i: np.asarray(a)[i],
                                       stacked) for i in range(n)]
    out = {k: v for k, v in g.items() if k not in ("enc_blocks",
                                                    "dec_blocks")}
    out["enc_blocks"] = split(g["enc_blocks"], cfg.n_enc_layers)
    out["dec_blocks"] = split(g["dec_blocks"], cfg.n_layers)
    return out


def close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def port_grads(params, cfg, batch):
    for w in tree_leaves(params):
        w.requires_grad_(True)
        w.grad = None
    loss, m = TM.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    loss.backward()
    return loss, m, tree_leaves(tree_map(lambda w: w.grad, params))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on the machine's cores, and oversubscribed ones made the
    small convolutions here ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = cfgs()
    tree = ref_tree(jcfg)
    return jcfg, cfg, tree


@pytest.fixture(scope="module")
def reference_grads(model):
    """The reference's loss and gradient at the padded batch and at an
    all-padding one, computed once."""
    jcfg, cfg, tree = model
    vg = jax.jit(jax.value_and_grad(JTM.loss_fn, has_aux=True),
                 static_argnums=1)
    out = {}
    for name, batch in (("padded", tokens(cfg, 3)),
                        ("all_pad", tokens(cfg, 3, pad=12))):
        (loss, m), g = vg(tree, jcfg, batch)
        out[name] = (batch, float(loss), float(m["nll"]),
                     jax.tree_util.tree_leaves(per_layer(g, cfg)))
    return out


# --------------------------------------------------------------------------- #
def test_configs_match_reference():
    """Every field of the port's ModelConfig equals the reference's in
    both configs, the distribution fields ``param_sharding`` ("wus") and
    ``seq_parallel`` among them."""
    for ref, cfg in ((JTM.TRANSFORMER_BIG, TM.TRANSFORMER_BIG),
                     (JTM.TRANSFORMER_TINY, TM.TRANSFORMER_TINY)):
        for f in dataclasses.fields(ModelConfig):
            assert getattr(cfg, f.name) == getattr(ref, f.name) or \
                f.name == "block_pattern", f.name
        assert cfg.param_sharding == "wus"
    big = TM.TRANSFORMER_BIG
    assert (big.n_enc_layers, big.n_layers, big.d_model, big.n_heads,
            big.head_dim, big.d_ff, big.vocab, big.remat) == \
        (6, 6, 1024, 16, 64, 4096, 33708, True)


@pytest.mark.parametrize("name", ["big", "tiny"])
def test_param_count_from_shapes(name):
    """210,743,296 for the big config (norms included), as
    ``jax.eval_shape`` of the reference's init counts it."""
    jcfg, cfg = {"big": (JTM.TRANSFORMER_BIG, TM.TRANSFORMER_BIG),
                 "tiny": (JTM.TRANSFORMER_TINY, TM.TRANSFORMER_TINY)}[name]
    shapes = jax.eval_shape(lambda k: split_tree(JTM.init_transformer(
        jcfg, k))[0], jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))
    assert TM.param_count(cfg) == want
    if name == "big":
        assert want == 210_743_296


def test_init_and_bridge_trees(model):
    """``init_transformer`` and the bridge give the enc-dec tree with a
    tied head: the same names and shapes, fp32, no ``head``; the init's
    scales are the reference's (embedding d^-0.5, q d^-0.5, FFN down
    d_ff^-0.5; norms ones and zeros)."""
    jcfg, cfg, tree = model
    params = bridge(tree, cfg)
    mine = TM.init_transformer(cfg, seed=0, device="cpu")
    assert sorted(params) == sorted(mine) == [
        "dec_blocks", "dec_norm", "embed", "enc_blocks", "enc_norm"]
    shape = lambda t: tree_map(lambda w: (tuple(w.shape), w.dtype), t)  # noqa: E731
    assert shape(params) == shape(mine)
    assert all(w.dtype == torch.float32 for w in tree_leaves(mine))
    d, f = cfg.d_model, cfg.d_ff
    assert abs(mine["embed"].std().item() - d ** -0.5) < 0.05 * d ** -0.5
    blk = mine["dec_blocks"][0]
    assert abs(blk["cross_attn"]["wq"].std().item() - d ** -0.5) < \
        0.05 * d ** -0.5
    assert abs(blk["ffn"]["wd"].std().item() - f ** -0.5) < 0.05 * f ** -0.5
    assert torch.equal(blk["norm_x"]["scale"], torch.ones(d))
    assert torch.equal(blk["norm_x"]["bias"], torch.zeros(d))
    assert np.array_equal(params["embed"].numpy(), tree["embed"])


def test_encode_and_logits_match_reference(model):
    jcfg, cfg, tree = model
    params = bridge(tree, cfg)
    b = tokens(cfg, 1)
    want_enc = JTM.encode(tree, jcfg, b["src"])
    want = JTM.forward(tree, jcfg, b["src"], b["tgt"])
    with torch.no_grad():
        enc = TM.encode(params, cfg, torch.from_numpy(b["src"]))
        got = TM.forward(params, cfg, torch.from_numpy(b["src"]),
                         torch.from_numpy(b["tgt"]))
    close(enc, want_enc)
    assert got.shape == (2, 12, cfg.vocab) and got.dtype == torch.float32
    close(got, want)


def test_embedding_scale_rounds_as_jax_in_bf16():
    """``take(embed, ids).astype(bf16) * d_model ** 0.5`` in JAX rounds
    the weak-typed scalar to bf16 first (11.3137 -> 11.3125 at d 128):
    the port's scaled embedding is bitwise that (a product with the
    unrounded scalar differs)."""
    jcfg, cfg = cfgs(dtype="bfloat16")
    tree = ref_tree(jcfg, seed=1)
    ids = np.random.default_rng(1).integers(1, cfg.vocab, (2, 16))
    want = np.asarray((jnp.take(tree["embed"], ids, axis=0).astype(
        jnp.bfloat16) * cfg.d_model ** 0.5).astype(jnp.float32))
    vals = TM.use_values(bridge(tree, cfg), cfg)
    got = TM._scaled_embedding(vals, cfg, torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    unrounded = lm._embed(vals, torch.from_numpy(ids)).to(torch.bfloat16) \
        * cfg.d_model ** 0.5
    assert not np.array_equal(unrounded.float().numpy(), want)


@pytest.mark.parametrize("case", ["padded", "all_pad"])
def test_loss_and_every_gradient_match_reference(model, reference_grads,
                                                 case):
    """With the last 4 targets padding, and with every target padding
    (the loss 0 over a floored count of 1, finite, every gradient 0)."""
    jcfg, cfg, tree = model
    batch, want_loss, want_nll, want = reference_grads[case]
    params = bridge(tree, cfg)
    loss, m, got = port_grads(params, cfg, batch)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(m["nll"].item(), want_nll, rtol=1e-5,
                               atol=1e-7)
    # embed, 2 LayerNorms of 2 leaves; an encoder layer's 4 norm + 4
    # attention + 2 FFN leaves; a decoder layer's 6 + 8 + 2
    assert len(got) == len(want) == 5 + 10 * cfg.n_enc_layers + \
        16 * cfg.n_layers
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    if case == "all_pad":
        assert np.isfinite(loss.item()) and loss.item() == 0.0
        assert all(not g.any() for g in got)


def test_remat_on_and_off_equal(model):
    """``cfg.remat`` runs each layer under ``torch.utils.checkpoint``:
    the same loss and the same gradients, bitwise."""
    _, cfg, tree = model
    batch = tokens(cfg, 5)
    runs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _, grads = port_grads(bridge(tree, c), c, batch)
        runs.append((loss.item(), grads))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def _three_uses(tree, cfg, tb, monkeypatch):
    """The embedding's fp32 cotangents from its three uses, one forward:
    the gathers read a detached table into leaves of their own, so the
    table's gradient is the head's alone."""
    params = bridge(tree, cfg)
    table = params["embed"].requires_grad_(True)
    gathered = []

    def embed(p, toks):
        rows = p["embed"].detach()[toks.long()].requires_grad_(True)
        gathered.append((toks, rows))
        return rows

    monkeypatch.setattr(lm, "_embed", embed)
    loss, _ = TM.loss_fn(params, cfg, tb)
    monkeypatch.undo()
    head, *rows = torch.autograd.grad(loss, [table] + [r for _, r in
                                                       gathered])
    return head, [(t, g) for (t, _), g in zip(gathered, rows)]


def _single_copy(tree, cfg, tb, monkeypatch):
    """The gradient when the forward reads one bf16 copy of the
    embedding at all three uses (what ``compute_cast`` or ``use_cast``
    alone would give): the cotangents summed in bf16."""
    params = bridge(tree, cfg)
    vals = lm.use_cast(params, cfg)
    table = params["embed"].requires_grad_(True)
    vals["embed"] = table.to(torch.bfloat16)
    monkeypatch.setattr(TM, "use_values", lambda p, c: vals)
    loss, _ = TM.loss_fn(params, cfg, tb)
    monkeypatch.undo()
    return torch.autograd.grad(loss, table)[0]


def test_tied_embedding_gradient_is_fp32_sum_of_three_uses(monkeypatch):
    """bf16 compute over fp32 masters, as fig9 trains: the reference
    casts the fp32 embedding at each of its uses (source gather, target
    gather, head), so its gradient is the fp32 sum of three cotangents,
    the gathers' transposes in fp32. The port's gradient is that sum
    within 1e-5 of its largest entry (sums in another order); one bf16
    copy used three times misses it by more than 1e-3 (bf16 sums), a gap
    the two frameworks' bf16 activations would hide in a direct
    comparison, which holds only within 2e-2."""
    jcfg, cfg = cfgs(dtype="bfloat16")
    tree = ref_tree(jcfg, seed=4)
    rng = np.random.default_rng(4)
    # ids from a handful, so that each row sums many cotangents
    batch = {"src": rng.integers(1, 9, (4, 32)).astype(np.int32),
             "tgt": rng.integers(1, 9, (4, 32)).astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = bridge(tree, cfg)
    port_grads(params, cfg, batch)
    got = params["embed"].grad
    assert got.dtype == torch.float32
    head, uses = _three_uses(tree, cfg, tb, monkeypatch)
    want = head.clone()
    for toks, g in uses:
        assert g.dtype == torch.float32
        want.index_add_(0, toks.reshape(-1).long(),
                        g.reshape(-1, cfg.d_model))
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() < 1e-5 * scale
    single = _single_copy(tree, cfg, tb, monkeypatch)
    assert (single - want).abs().max().item() > 1e-3 * scale
    ref = np.asarray(jax.jit(jax.grad(lambda p: JTM.loss_fn(
        p, jcfg, batch)[0]))(tree)["embed"])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())


# ---- the train step and the CLI --------------------------------------------- #
def test_three_adam_steps_match_fig9_step(model):
    """fig9's step (``jax.value_and_grad`` of ``loss_fn`` on the fp32
    tree, then ``adam(constant(1e-3))``) three times against
    ``launch/mlperf.py``'s ``make_train_step``: the losses and the
    weights after the third step."""
    jcfg, cfg, tree = model
    batch = tokens(cfg, 8, pad=2)
    opt = jax_adam(jax_constant(1e-3))

    @jax.jit
    def step(vals, st):
        (l, _), g = jax.value_and_grad(
            lambda p: JTM.loss_fn(p, jcfg, batch), has_aux=True)(vals)
        vals, st = opt.update(g, st, vals)
        return vals, st, l

    vals, st, want = tree, opt.init(tree), []
    for _ in range(3):
        vals, st, l = step(vals, st)
        want.append(float(l))
    params = bridge(tree, cfg)
    from repro_torch.optim import adam, constant
    topt = adam(constant(1e-3))
    tst = topt.init(params)
    tstep = cli.make_train_step(cli.loss_of("transformer", cfg), topt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = []
    for _ in range(3):
        params, tst, loss = tstep(params, tst, tb)
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[-1] < got[0]
    for g, w in zip(tree_leaves(params),
                    jax.tree_util.tree_leaves(per_layer(vals, cfg))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-4)


def test_cli_on_cpu_repeats(capsys):
    """``launch/mlperf.py --model transformer --device cpu`` (the tiny
    config, bf16 compute, batch 2 x 97): 3 finite, falling losses, the
    same in a second run."""
    runs = []
    for _ in range(2):
        assert cli.main(["--model", "transformer", "--device", "cpu"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert [ln.split(":")[0] for ln in lines[:3]] == \
            ["step 1", "step 2", "step 3"] and lines[3].startswith("done")
        runs.append([float(ln.split("loss=")[1].split()[0])
                     for ln in lines[:3]])
    assert all(np.isfinite(runs[0])) and runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]
    batch = cli.synthetic_batch("transformer", TM.TRANSFORMER_TINY, 2,
                                np.random.default_rng(0))
    assert batch["src"].shape == batch["tgt"].shape == (2, 97)
    assert batch["src"].min() >= 1 and batch["tgt"].max() < 512
