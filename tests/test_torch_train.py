"""The port's train path against the JAX reference on the same weights
and batches: loss and every parameter gradient of reduced gemma-7b,
the schedule and one Adam update, the synthetic data, a 3-step
``Trainer.fit`` trajectory with eval (one and two microbatches), the
CLI on the CPU, and the device rules."""
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.launch.mesh import single_device_mesh  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.optim import adam as jax_adam  # noqa: E402
from repro.optim import cosine_warmup as jax_cosine  # noqa: E402
from repro.train import Trainer as JaxTrainer  # noqa: E402
from repro.train import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro.train.steps import ModelAPI  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adam, compute_cast, cosine_warmup  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.tracker import DictSink  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

FP32 = dict(dtype="float32", n_layers=2)


def _cfgs(**kw):
    """The same reduced gemma-7b on both sides, fp32, two layers."""
    kw = {**FP32, **kw}
    return (dataclasses.replace(jax_get_config("gemma-7b").reduced(), **kw),
            dataclasses.replace(get_config("gemma-7b").reduced(), **kw))


def _jax_params(cfg, seed=0):
    tree = split_tree(ModelAPI(cfg).init(cfg, jax.random.PRNGKey(seed)))[0]
    return jax.tree_util.tree_map(np.asarray, tree)


def _bridge(tree, cfg):
    return lm.params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)


def _flat_jax_grads(g, cfg):
    """The reference's gradient tree in the port's layout: one dict per
    layer instead of arrays stacked over layers."""
    (stacked,) = g["blocks"]
    return {"embed": g["embed"], "final_norm": g["final_norm"],
            "layers": [jax.tree_util.tree_map(lambda a, i=i: np.asarray(a)[i],
                                              stacked)
                       for i in range(cfg.n_layers)]}


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_reference(remat):
    jcfg, cfg = _cfgs(remat=remat)
    tree = _jax_params(jcfg)
    tokens = data._zipf_tokens(np.random.default_rng(3), (2, 40), cfg.vocab)
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
        jax_lm.loss_fn, has_aux=True), static_argnums=1)(
            tree, jcfg, {"tokens": tokens})
    params = _bridge(tree, cfg)
    for w in tree_leaves(params):
        w.requires_grad_(True)
    loss, m = lm.loss_fn(params, cfg, {"tokens": torch.from_numpy(tokens)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(m["nll"].item(), float(want_m["nll"]),
                               rtol=1e-5)
    want = tree_leaves(_flat_jax_grads(want_g, cfg))
    got = tree_leaves(tree_map(lambda w: w.grad, params))
    assert len(got) == len(want) == 2 + 9 * cfg.n_layers
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_forward_logits_match_reference():
    jcfg, cfg = _cfgs()
    tree = _jax_params(jcfg, seed=1)
    tokens = data._zipf_tokens(np.random.default_rng(4), (2, 33), cfg.vocab)
    want, _ = jax_lm.forward(tree, jcfg, tokens)
    with torch.no_grad():
        got = lm.forward(_bridge(tree, cfg), cfg, torch.from_numpy(tokens))
    assert got.shape == (2, 33, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_cosine_warmup_and_one_adam_update_match_reference():
    f, jf = cosine_warmup(3e-4, 10, 100), jax_cosine(3e-4, 10, 100)
    for step in (0, 3, 9, 10, 57, 99, 150):
        np.testing.assert_allclose(f(step).item(), float(jf(step)),
                                   rtol=1e-6)
        np.testing.assert_allclose(f(torch.tensor(step)).item(),
                                   float(jf(step)), rtol=1e-6)
    rng = np.random.RandomState(0)
    w = {"a": rng.standard_normal((4, 3)),
         "b": [rng.standard_normal(5), rng.standard_normal((2, 2, 2))]}
    w = tree_map(lambda a: np.asarray(a, np.float32), w)
    g = tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), w)
    m = tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), w)
    v = tree_map(lambda a: rng.random(a.shape).astype(np.float32), w)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8)
    ref = jax_adam(jax_cosine(3e-4, 10, 100), **kw)
    want_w, want_s = ref.update(g, {"m": m, "v": v, "step": jnp.int32(7)}, w)
    opt = adam(cosine_warmup(3e-4, 10, 100), **kw)
    t = lambda tree: tree_map(lambda a: torch.tensor(a), tree)  # noqa: E731
    got_w, got_s = opt.update(t(g), {"m": t(m), "v": t(v),
                                     "step": torch.tensor(7)}, t(w))
    for got, want in ((got_w, want_w), (got_s["m"], want_s["m"]),
                      (got_s["v"], want_s["v"])):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    assert int(got_s["step"]) == 8


def test_compute_cast_keeps_1d_params_fp32():
    params = {"w": torch.ones(3, 4), "scale": torch.ones(4),
              "layers": [{"wd": torch.ones(2, 2)}]}
    out = compute_cast(params, "bfloat16")
    assert out["w"].dtype == out["layers"][0]["wd"].dtype == torch.bfloat16
    assert out["scale"].dtype == torch.float32


def test_synthetic_data_byte_identical_to_reference():
    jcfg, cfg = _cfgs()
    mine = list(data.synthetic_lm_batches(cfg, batch=3, seq=17, steps=3,
                                          seed=5))
    theirs = list(jax_data.synthetic_lm_batches(jcfg, batch=3, seq=17,
                                                steps=3, seed=5))
    for a, b in zip(mine, theirs, strict=True):
        assert a["tokens"].dtype == b["tokens"].dtype
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    mine = list(data.synthetic_eval_set(cfg, batch=4, seq=9)())
    theirs = list(jax_data.synthetic_eval_set(jcfg, batch=4, seq=9)())
    for (a, ma), (b, mb) in zip(mine, theirs, strict=True):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(ma, mb)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_trajectory_and_eval_match_reference(microbatches):
    """3 steps of ``Trainer.fit`` with eval at step 3, from the same
    weights and batches: losses, nlls and eval_nll within rtol 1e-4
    (fp32 on both sides; sums are taken in other orders)."""
    jcfg, cfg = _cfgs(microbatches=microbatches)
    jtr = JaxTrainer(jcfg, single_device_mesh(),
                     JaxTrainerConfig(total_steps=3, eval_every=3,
                                      log_every=0))
    tree = jax.tree_util.tree_map(np.asarray, jtr.state["params"])
    kw = dict(batch=4, seq=24, steps=3, seed=0)
    ev = dict(batch=4, seq=24)
    want = jtr.fit(jax_data.synthetic_lm_batches(jcfg, **kw),
                   jax_data.synthetic_eval_set(jcfg, **ev))
    tr = Trainer(cfg, TrainerConfig(total_steps=3, eval_every=3, log_every=0),
                 device="cpu", params=_bridge(tree, cfg))
    got = tr.fit(data.synthetic_lm_batches(cfg, **kw),
                 data.synthetic_eval_set(cfg, **ev))
    assert [r["step"] for r in got] == [1, 2, 3]
    for key in ("loss", "nll"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4)
    np.testing.assert_allclose(got[-1]["eval_nll"], want[-1]["eval_nll"],
                               rtol=1e-4)
    assert set(got[0]) >= {"step", "loss", "nll", "step_ms", "data_wait_ms",
                           "ckpt_block_ms"}
    assert all(np.isfinite(r["loss"]) for r in got)


def test_sinks_and_refused_options(tmp_path):
    _, cfg = _cfgs()
    path = tmp_path / "metrics.jsonl"
    dict_sink = DictSink()
    tr = Trainer(cfg, TrainerConfig(total_steps=2, log_every=0,
                                    metrics=("grad_norm",),
                                    metrics_out=str(path)), device="cpu")
    hooks = tr.default_hooks()
    hooks[0].sinks.append(dict_sink)
    hist = tr.fit(data.synthetic_lm_batches(cfg, batch=2, seq=8, steps=2),
                  hooks=hooks)
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2] and dict_sink.finished
    assert dict_sink.logged[-1]["grad_norm"] == hist[-1]["grad_norm"] > 0
    for opts in (dict(checkpoint_every=1), dict(async_checkpoint=True),
                 dict(double_buffer=True)):  # ported: accepted now
        Trainer(cfg, TrainerConfig(**opts), device="cpu")
    with pytest.raises(ValueError, match="no step_<N> checkpoints"):
        tr.resume(str(tmp_path))  # an empty directory has nothing to resume


def test_cli_runs_on_cpu(capsys, tmp_path):
    assert cli.main(["--arch", "gemma-7b", "--device", "cpu", "--steps", "3",
                     "--batch", "2", "--seq", "16", "--eval-every", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [x.split(":")[0] for x in out[:3]] == ["step 1", "step 2",
                                                  "step 3"]
    assert out[3].startswith("  eval @ 3: nll=")
    assert out[-1].startswith("done {'step': 3, 'loss': ")
    with pytest.raises(ValueError, match="no step_<N> checkpoints"):
        cli.main(["--arch", "gemma-7b", "--device", "cpu", "--steps", "1",
                  "--resume", str(tmp_path)])  # ported: a real lookup now


def test_train_entry_points_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--arch", "gemma-7b", "--steps", "1"])


def test_init_paged_kv_cache_needs_a_device():
    _, cfg = _cfgs()
    with pytest.raises(TypeError):
        L.init_paged_kv_cache(cfg, 4, 2)
    pools = L.init_paged_kv_cache(cfg, 4, 2, device="cpu")
    assert pools["kp"].device.type == "cpu"


def test_serving_weights_stay_in_the_compute_dtype():
    cfg = get_config("gemma-7b").reduced()
    assert lm.init_lm(cfg, device="cpu")["embed"].dtype == torch.bfloat16
    assert (lm.init_lm(cfg, device="cpu", dtype=torch.float32)["embed"].dtype
            == torch.float32)
