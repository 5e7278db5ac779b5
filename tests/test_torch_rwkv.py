"""rwkv6-3b, the attention-free RWKV-6 ("Finch") model, in the port
against the JAX reference on the same numpy weights (the reference's
init through the bridge, norms perturbed), reduced, fp32 on both sides:
the config copy and parameter count; the time mix's init (names,
shapes, constants); ``relu2``; ``apply_rwkv6`` (from zeros and from a
token shift) and ``apply_rwkv6_step``; step-by-step decode against the
full scan; the chunked, checkpointed scan against the plain loop; the
mixer's fp32 leaves, whose ``wk``/``wv``/``wo`` share attention's names;
a train step's loss and every gradient, the Trainer's 3 Adam steps with
eval and its checkpoint names; a resumed run; and the slab engine's
greedy tokens against the reference engine's.

Tolerances: fp32 outputs, logits and states rtol 1e-4 / atol 1e-5, the
loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6, Trainer losses rtol
1e-4 (both sides fp32, sums in other orders); bf16 prefill logits (the
mix in fp32 from fp32 leaves, the rest bf16) within 2e-2 of the largest;
the chunked scan bitwise the plain loop; greedy tokens exactly."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.launch.mesh import single_device_mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import run_offline as jax_run_offline  # noqa: E402
from repro.serve.engine import synthetic_requests as jax_requests  # noqa: E402
from repro.train import Trainer as JaxTrainer  # noqa: E402
from repro.train import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    LayerSpec,
    ModelConfig,
    RWKV6Config,
)
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.scan_utils import _scan  # noqa: E402
from repro_torch.optim import compute_cast  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.serve.scenarios import run_offline  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from test_torch_archs import (  # noqa: E402
    _plain,
    assert_grads_match,
    cfgs,
    ref_tree,
    train_step_both,
)

ARCH = "rwkv6-3b"
MIX = ("mu", "u", "w0", "w1", "w2", "wg", "wk", "wo", "wr", "wv",
       "ln_scale")


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = cfgs(ARCH)
    tree = ref_tree(jcfg, seed=2)
    return jcfg, cfg, tree, lm.params_from_numpy(tree, cfg, device="cpu")


def _mixer_tree(tree, seed):
    """Layer 0's time-mix leaves of a reference tree, with ``w0``,
    ``mu`` and ``ln_scale`` drawn away from their constants."""
    rng = np.random.default_rng(seed)
    mix = {k: np.array(v[0]) for k, v in tree["blocks"][0]["mixer"].items()}
    mix["w0"] = mix["w0"] + rng.standard_normal(mix["w0"].shape).astype(
        np.float32)
    mix["mu"] = rng.random(mix["mu"].shape).astype(np.float32)
    mix["ln_scale"] = (1 + 0.1 * rng.standard_normal(mix["ln_scale"].shape)
                       ).astype(np.float32)
    return mix


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_and_param_count_match_reference(reduced):
    ref, cfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    for f in dataclasses.fields(ModelConfig):
        assert _plain(getattr(cfg, f.name)) == _plain(getattr(ref, f.name)), \
            f.name
    assert cfg.block_pattern == (LayerSpec("rwkv6", "dense"),)
    assert cfg.param_count() == ref.param_count()
    if not reduced:
        assert cfg.param_count() == 2_653_388_800
    else:
        assert (cfg.rwkv6.head_dim, cfg.rwkv6.decay_lora_dim) == (32, 16)


def test_init_names_shapes_and_constants(model):
    """``init_lm``'s time mix has the reference's names and shapes, every
    leaf fp32 in a bf16 model, with ``w0`` -5, ``mu`` 0.5, ``ln_scale``
    ones, ``u`` ~ 0.5 N and the projections at d^-0.5; the channel mix
    (squared ReLU, no gate) is bf16."""
    jcfg, _, tree, _ = model
    cfg = get_config(ARCH).reduced()
    d = cfg.d_model
    params = lm.init_lm(cfg, seed=0, device="cpu")
    mix = params["layers"][0]["mixer"]
    want = {k: np.asarray(v).shape[1:]
            for k, v in tree["blocks"][0]["mixer"].items()}
    assert {k: tuple(v.shape) for k, v in mix.items()} == want
    assert sorted(mix) == sorted(MIX)
    assert all(v.dtype == torch.float32 for v in mix.values())
    assert torch.equal(mix["w0"], torch.full((d,), -5.0))
    assert torch.equal(mix["mu"], torch.full((5, d), 0.5))
    assert torch.equal(mix["ln_scale"], torch.ones(d))
    assert abs(mix["u"].std().item() - 0.5) < 0.1
    assert abs(mix["wr"].std().item() * d ** 0.5 - 1) < 0.05
    ffn = params["layers"][0]["ffn"]
    assert sorted(ffn) == ["wd", "wu"]
    assert all(v.dtype == torch.bfloat16 for v in ffn.values())


def test_relu2_is_the_references():
    x = np.linspace(-3, 3, 61).astype(np.float32)
    got = L._ACT["relu2"](torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.square(jax.nn.relu(jnp.asarray(x))))
    np.testing.assert_array_equal(got, want)


def test_time_mix_and_its_step_match_reference(model):
    """``apply_rwkv6`` from a zero shift and from a given one, and one
    ``apply_rwkv6_step`` from a nonzero wkv state: outputs and caches
    against the reference's layer functions."""
    jcfg, cfg, tree, _ = model
    mix = _mixer_tree(tree, 3)
    prm = {k: torch.from_numpy(v) for k, v in mix.items()}
    jprm = {k: jnp.asarray(v) for k, v in mix.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    shift = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    for cache in (None, {"shift": shift}):
        want, wc = JL.apply_rwkv6(jprm, jnp.asarray(x), jcfg, cache=None
                                  if cache is None else
                                  {"shift": jnp.asarray(shift)})
        got, gc = L.apply_rwkv6(prm, torch.from_numpy(x), cfg, cache=None
                                if cache is None else
                                {"shift": torch.from_numpy(shift)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(gc["shift"].numpy(),
                                      np.asarray(wc["shift"]))
        np.testing.assert_allclose(gc["wkv"].numpy(), np.asarray(wc["wkv"]),
                                   rtol=1e-4, atol=1e-5)
    state = {"shift": torch.from_numpy(shift), "wkv": gc["wkv"]}
    jstate = {"shift": jnp.asarray(shift), "wkv": jnp.asarray(gc["wkv"])}
    want, wc = JL.apply_rwkv6_step(jprm, jnp.asarray(x[:, :1]), jcfg, jstate)
    got, gc = L.apply_rwkv6_step(prm, torch.from_numpy(x[:, :1]), cfg, state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gc["wkv"].numpy(), np.asarray(wc["wkv"]),
                               rtol=1e-4, atol=1e-5)
    assert gc["shift"].shape == (2, cfg.d_model)


def test_step_by_step_decode_equals_the_full_scan(model):
    _, cfg, tree, _ = model
    prm = {k: torch.from_numpy(v) for k, v in _mixer_tree(tree, 5).items()}
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    full, fc = L.apply_rwkv6(prm, x, cfg)
    state = L.init_rwkv6_cache(cfg, 2, device="cpu")
    outs = []
    for t in range(x.shape[1]):
        y, state = L.apply_rwkv6_step(prm, x[:, t:t + 1], cfg, state)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(state["wkv"], fc["wkv"], rtol=1e-4, atol=1e-5)
    assert torch.equal(state["shift"], fc["shift"])


def test_chunked_scan_is_the_plain_loop_bitwise():
    """At S 192 the wkv scan runs 3 checkpointed chunks of 64: its output,
    final state and the gradients of r, k, v, w and u equal those of one
    plain loop over the 192 steps, bitwise."""
    B, S, H, dh = 2, 192, 2, 8
    g = torch.Generator().manual_seed(7)
    r, k, v = (torch.randn((B, S, H * dh), generator=g) for _ in range(3))
    w = torch.rand((B, S, H * dh), generator=g)
    u = torch.randn((H * dh,), generator=g)
    dy = torch.randn((B, S, H * dh), generator=g)
    runs = []
    for chunked in (True, False):
        ins = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
        if chunked:
            y, Sf = L._rwkv_wkv_scan(*ins, H, dh)
        else:
            xs = torch.stack([a.reshape(B, S, H, dh) for a in ins[:4]])
            S0 = torch.zeros((B, H, dh, dh))
            Sf, ys = _scan(L._rwkv6_step(ins[4].reshape(H, dh)), S0,
                           xs.permute(2, 0, 1, 3, 4))
            y = ys.permute(1, 0, 2, 3).reshape(B, S, H * dh)
        grads = torch.autograd.grad((y * dy).sum() + Sf.sum(), ins)
        runs.append([y, Sf, *grads])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_time_mix_leaves_stay_fp32_by_mixer_not_by_name():
    """In a bf16 model with an attention and an RWKV-6 layer, the mix's
    ``wk``/``wv``/``wo`` (and every other mix leaf) stay fp32 in
    ``init_lm``, the weight bridge and ``use_cast``, while the attention
    layer's ``wk``/``wv``/``wo`` and both FFNs are bf16; the train step's
    ``compute_cast`` rounds every layer leaf, the mix's included, to
    bf16, as the reference's cast over its stacked leaves does."""
    cfg = ModelConfig("h", n_layers=2, d_model=64, d_ff=96, vocab=50,
                      n_heads=2, n_kv_heads=2,
                      block_pattern=(LayerSpec("attn"), LayerSpec("rwkv6")),
                      rwkv6=RWKV6Config(head_dim=32, decay_lora_dim=8))
    masters = lm.init_lm(cfg, seed=1, device="cpu", dtype=torch.float32)
    tree = jax.tree_util.tree_map(
        lambda t: t.numpy() if torch.is_tensor(t) else np.stack(
            [p.numpy() for p in t.parts]),
        lm.reference_tree(masters, cfg),
        is_leaf=lambda t: not isinstance(t, (dict, tuple)))
    for params in (lm.init_lm(cfg, seed=1, device="cpu"),
                   lm.params_from_numpy(tree, cfg, device="cpu"),
                   lm.use_cast(masters, cfg)):
        attn, rwkv = params["layers"]
        assert all(v.dtype == torch.float32 for v in rwkv["mixer"].values())
        for name in ("wk", "wv", "wo"):
            assert attn["mixer"][name].dtype == torch.bfloat16
        for lp in (attn, rwkv):
            assert lp["ffn"]["wu"].dtype == torch.bfloat16
            assert lp["norm1"]["scale"].dtype == torch.float32
    cast = compute_cast(masters, cfg.dtype)["layers"]
    assert all(v.dtype == torch.bfloat16 for lp in cast
               for part in lp.values() for v in part.values())
    assert lm.use_cast(masters, cfg)["layers"][1]["mixer"]["wk"] is \
        masters["layers"][1]["mixer"]["wk"]


def test_bf16_prefill_reads_the_mix_in_fp32_as_the_reference():
    """Served in bf16 (fp32 masters on the reference's side, read through
    ``astype(float32)`` in the mix; the bridge's stored dtypes on the
    port's): prefill logits within 2e-2 of the largest."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    tree = ref_tree(jcfg, seed=8)
    toks = data._zipf_tokens(np.random.default_rng(9), (2, 11), cfg.vocab)
    want, _ = jax_lm.prefill(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                             jnp.asarray(toks))
    params = lm.params_from_numpy(tree, cfg, device="cpu")
    with torch.no_grad():
        got, cache = lm.prefill(params, cfg, torch.from_numpy(toks))
    want = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(
        want).max()
    assert cache[0]["shift"].dtype == torch.bfloat16
    assert cache[0]["wkv"].dtype == torch.float32


def test_train_step_loss_and_every_gradient_match_reference(model):
    """The reference's ``make_train_step`` (rules and axes given, so
    ``compute_cast`` runs) against the port's, on the same weights and a
    96-token batch, whose scan runs in 2 checkpointed chunks of 48."""
    jcfg, cfg, tree, _ = model
    tokens = data._zipf_tokens(np.random.default_rng(10), (2, 96), cfg.vocab)
    (wstate, wm), (state, m) = train_step_both(jcfg, cfg, tree, tokens)
    np.testing.assert_allclose(m["loss"].item(), float(wm["loss"]),
                               rtol=1e-5)
    assert_grads_match(wstate["opt"], state["opt"], cfg.n_layers)


def test_trainer_adam_steps_eval_and_checkpoint_names_match_reference():
    """3 ``Trainer.fit`` steps of the default Adam with an eval at step 3,
    from the reference trainer's initial weights: losses and eval nll;
    the checkpoint names are the reference's state names."""
    jcfg, cfg = cfgs(ARCH)
    jtr = JaxTrainer(jcfg, single_device_mesh(),
                     JaxTrainerConfig(total_steps=3, eval_every=3,
                                      log_every=0))
    tree = jax.tree_util.tree_map(np.asarray, jtr.state["params"])
    kw = dict(batch=2, seq=24, steps=3, seed=0)
    ev = dict(batch=2, seq=24)
    want = jtr.fit(jax_data.synthetic_lm_batches(jcfg, **kw),
                   jax_data.synthetic_eval_set(jcfg, **ev))
    tr = Trainer(cfg, TrainerConfig(total_steps=3, eval_every=3, log_every=0),
                 device="cpu", params=lm.params_from_numpy(
                     tree, cfg, device="cpu", dtype=torch.float32))
    got = tr.fit(data.synthetic_lm_batches(cfg, **kw),
                 data.synthetic_eval_set(cfg, **ev))
    for key in ("loss", "nll"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4)
    np.testing.assert_allclose(got[-1]["eval_nll"], want[-1]["eval_nll"],
                               rtol=1e-4)
    names, _ = ckpt._flatten_with_names(tr.checkpoint_tree())
    flat, _ = jax.tree_util.tree_flatten_with_path(jtr.state)
    assert names == [jax.tree_util.keystr(p) for p, _ in flat]
    assert "['params']['blocks'][0]['mixer']['w0']" in names


def test_cli_resume_equals_uninterrupted_run(tmp_path, capsys):
    """Checkpoints at step 2 write the time mix's leaves; a run resumed
    from one repeats steps 3 and 4 of the uninterrupted run."""
    base = ["--arch", ARCH, "--device", "cpu", "--steps", "4", "--batch",
            "2", "--seq", "16"]
    assert train_cli.main(base + ["--checkpoint-every", "2",
                                  "--checkpoint-dir",
                                  str(tmp_path / "a")]) == 0
    full = capsys.readouterr().out.splitlines()
    manifest = (tmp_path / "a" / "step_2" / "manifest.json").read_text()
    assert "['mixer']['ln_scale']" in manifest
    assert train_cli.main(base + ["--resume", str(tmp_path / "a" / "step_2"),
                                  "--checkpoint-dir",
                                  str(tmp_path / "b")]) == 0
    cont = capsys.readouterr().out.splitlines()
    strip = lambda ln: ln.split(" (")[0]  # noqa: E731 — drop the wall time
    assert cont[0].startswith("step 3: loss=")
    assert [strip(x) for x in cont[:2]] == [strip(x) for x in full[2:4]]


def test_slab_engine_tokens_equal_the_references(model):
    """Both engines serve the reference's requests from the slab (the
    ``auto`` layout of a recurrent stack), each prompt prefilled at its
    exact length: greedy tokens exactly."""
    jcfg, cfg, tree, params = model
    work = dict(n=4, tokens=5, prompt_len=12, seed=3,
                prompt_lens=(3, 12, 7, 10))
    knobs = dict(max_batch=2, max_len=24, prefill_len=12)
    jreqs = jax_requests(jcfg, **work)
    want = jax_run_offline(JaxEngine(jcfg, tree, None,
                                     JaxServeConfig(**knobs)), jreqs)
    eng = Engine(cfg, params, ServeConfig(**knobs), device="cpu")
    got = run_offline(eng, [Request(prompt=list(r.prompt),
                                    max_new_tokens=r.max_new_tokens, id=r.id)
                            for r in jreqs])
    assert eng.layout == "slab"

    def toks(report):
        return [list(r.tokens) for r in sorted(report.requests,
                                               key=lambda r: r.id)]

    assert toks(got) == toks(want)
    assert all(len(t) == work["tokens"] for t in toks(got))
    with pytest.raises(ValueError, match="recurrent mixer"):
        Engine(cfg, params, ServeConfig(kv_layout="paged"), device="cpu")
