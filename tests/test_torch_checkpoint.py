"""The port's checkpoints (``repro_torch.train.checkpoint``), the
checkpoint hook and resume, against ``repro.train``: the counterparts of
tests/test_train.py's checkpoint tests and of the checkpoint and hook
tests of tests/test_train_async.py, a resume bit-exact against an
uninterrupted run (through the ``Trainer`` and through the CLI), and
checkpoints that each package writes and the other restores. Ordering
and bytes are pinned; wall-clock bounds are not."""
import dataclasses
import itertools
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import synthetic_lm_batches as jax_batches  # noqa: E402
from repro.launch.mesh import single_device_mesh  # noqa: E402
from repro.train import Trainer as JaxTrainer  # noqa: E402
from repro.train import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import Pipeline, SyntheticShardSource  # noqa: E402
from repro_torch.data.pipeline import synthetic_lm_batches  # noqa: E402
from repro_torch.launch import train as cli  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.hooks import CheckpointHook, Hook, MetricsLogger  # noqa: E402
from repro_torch.utils import Stacked, tree_leaves  # noqa: E402

FP32 = dict(dtype="float32", n_layers=2)
CFG = dataclasses.replace(get_config("gemma-7b").reduced(), **FP32)
BATCH, SEQ = 2, 16


def _tiny_trainer(**kw):
    tcfg = TrainerConfig(**{"total_steps": 3, "log_every": 0, **kw})
    tr = Trainer(CFG, tcfg, device="cpu")
    return tr, synthetic_lm_batches(CFG, batch=BATCH, seq=SEQ,
                                    steps=tcfg.total_steps)


def _batches(lo, hi):
    return itertools.islice(
        synthetic_lm_batches(CFG, batch=BATCH, seq=SEQ, steps=hi), lo, hi)


def _parts(tree):
    return [p for leaf in ckpt._flatten_with_names(tree)[1]
            for p in (leaf.parts if isinstance(leaf, Stacked) else [leaf])]


def _state_arrays(tr):
    """Every tensor of the trainer's state, copied, in checkpoint order."""
    return [p.detach().clone() for p in _parts(tr.checkpoint_tree())]


def _assert_equal_state(tr, want):
    for g, w in zip(_parts(tr.checkpoint_tree()), want):
        assert torch.equal(g, w)


# --------------------------------------------------------------------------- #
# Save and restore.
# --------------------------------------------------------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    tr, batches = _tiny_trainer(total_steps=2)
    tr.fit(batches)
    path = str(tmp_path / "step_2")
    ckpt.save_checkpoint(path, tr.checkpoint_tree(), step=2)
    restored = ckpt.restore_checkpoint(path, tr.checkpoint_tree())
    got = _parts(restored)
    assert len(got) == len(tree_leaves(tr.state))
    for a, b in zip(got, _parts(tr.checkpoint_tree())):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert ckpt.manifest_step(path) == 2


def test_checkpoint_structure_mismatch_raises(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), {"a": torch.ones(2)})
    with pytest.raises(AssertionError):
        ckpt.restore_checkpoint(str(tmp_path), {"b": torch.ones(2)})
    with pytest.raises(ValueError, match="float32"):
        ckpt.restore_checkpoint(str(tmp_path), {"a": torch.ones(3)})


def test_async_save_equals_sync_save(tmp_path):
    tr, batches = _tiny_trainer()
    tr.fit(batches)
    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    ckpt.save_checkpoint(sync_dir, tr.checkpoint_tree(), step=3)
    ac = ckpt.AsyncCheckpointer()
    ac.save(async_dir, tr.checkpoint_tree(), step=3)
    assert ac.in_flight == async_dir
    ac.wait()
    assert ac.in_flight is None
    a = np.load(os.path.join(sync_dir, "arrays.npz"))
    b = np.load(os.path.join(async_dir, "arrays.npz"))
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    ma = json.load(open(os.path.join(sync_dir, "manifest.json")))
    assert ma == json.load(open(os.path.join(async_dir, "manifest.json")))


def test_async_snapshot_survives_later_in_place_updates(tmp_path):
    """The optimizer updates the masters in place; a save queued before
    more steps holds the state at save time."""
    tr, _ = _tiny_trainer(total_steps=4)
    tr.fit(_batches(0, 2))
    want = [a.numpy() for a in _state_arrays(tr)]
    ac = ckpt.AsyncCheckpointer()
    ac.save(str(tmp_path / "snap"), tr.checkpoint_tree(), step=2)
    tr.start_step = 2
    tr.fit(_batches(2, 4))
    ac.wait()
    data = np.load(str(tmp_path / "snap" / "arrays.npz"))
    flat = [data[f"a{i}"] for i in range(len(data.files))]
    got = [a[b] for a, leaf in zip(flat, ckpt._flatten_with_names(
        tr.checkpoint_tree())[1])
        for b in (range(len(leaf.parts)) if isinstance(leaf, Stacked)
                  else [...])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not all(np.array_equal(g, a.numpy())
                   for g, a in zip(got, _state_arrays(tr)))


def test_crash_between_tensors_and_manifest_keeps_previous(tmp_path):
    root = str(tmp_path)
    tr, _ = _tiny_trainer(total_steps=4)
    tr.fit(_batches(0, 2))
    ckpt.save_checkpoint(os.path.join(root, "step_2"), tr.checkpoint_tree(),
                         step=2)
    state_at_2 = _state_arrays(tr)
    tr.start_step = 2
    tr.fit(_batches(2, 4))
    ac = ckpt.AsyncCheckpointer()
    ac._crash_after_tensors = True
    ac.save(os.path.join(root, "step_4"), tr.checkpoint_tree(), step=4)
    with pytest.raises(ckpt._InjectedCrash):
        ac.wait()
    assert not os.path.exists(os.path.join(root, "step_4"))
    assert not [d for d in os.listdir(root) if d.startswith(".tmp_")]
    assert ckpt.latest_step(root) == 2
    resumed, _ = _tiny_trainer(total_steps=4)
    assert resumed.resume(root) == 2
    _assert_equal_state(resumed, state_at_2)


def test_latest_step_ignores_manifestless_dirs(tmp_path):
    os.makedirs(str(tmp_path / "step_5"))  # torn: no manifest
    os.makedirs(str(tmp_path / ".tmp_step_9.123"))
    assert ckpt.latest_step(str(tmp_path)) is None
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    tr, batches = _tiny_trainer(total_steps=1)
    tr.fit(batches)
    ckpt.save_checkpoint(str(tmp_path / "step_3"), tr.checkpoint_tree(),
                         step=3)
    assert ckpt.latest_step(str(tmp_path)) == 3
    with pytest.raises(ValueError, match="no step_<N>"):
        tr.resume(str(tmp_path / "step_5"))


def test_async_writer_failure_surfaces_in_wait(tmp_path):
    tr, batches = _tiny_trainer(total_steps=1)
    tr.fit(batches)
    open(str(tmp_path / "blocked"), "w").close()  # the parent is a file
    ac = ckpt.AsyncCheckpointer()
    ac.save(str(tmp_path / "blocked" / "ckpt"), tr.checkpoint_tree(), step=1)
    with pytest.raises(OSError):
        ac.wait()
    ac.wait()  # the error is consumed, not raised forever


# --------------------------------------------------------------------------- #
# CheckpointHook.
# --------------------------------------------------------------------------- #
def _ckpt_events(tr, batches, hooks):
    events = []

    class Spy(Hook):
        def on_checkpoint(self, trainer, step, path):
            events.append((step, os.path.basename(path)))

    tr.fit(batches, hooks=[MetricsLogger(0), *hooks, Spy()])
    return events


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_hook_flushes_final_partial_step(tmp_path, async_save):
    """total_steps 5, every 2: saves at 2 and 4, then the final flush of
    step 5 at the end of the fit, its in-flight save drained."""
    tr, batches = _tiny_trainer(total_steps=5)
    events = _ckpt_events(tr, batches, [
        CheckpointHook(2, str(tmp_path), async_save=async_save)])
    assert events == [(2, "step_2"), (4, "step_4"), (5, "step_5")]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.manifest_step(str(tmp_path / "step_4")) == 4


def test_checkpoint_hook_skips_redundant_resume_save(tmp_path):
    tr, batches = _tiny_trainer(total_steps=2, checkpoint_every=2,
                                checkpoint_dir=str(tmp_path))
    tr.fit(batches)
    resumed, _ = _tiny_trainer(total_steps=2)
    assert resumed.resume(str(tmp_path)) == 2
    mtime = os.path.getmtime(str(tmp_path / "step_2" / "manifest.json"))
    events = _ckpt_events(resumed, iter(()), [CheckpointHook(2, str(tmp_path))])
    assert events == []  # no step advanced: nothing saved
    assert os.path.getmtime(
        str(tmp_path / "step_2" / "manifest.json")) == mtime
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_fit_records_step_time_breakdown():
    tr, batches = _tiny_trainer(total_steps=3)
    for r in tr.fit(batches):
        assert r["step_ms"] > 0.0 and r["data_wait_ms"] >= 0.0
        assert r["ckpt_block_ms"] == 0.0  # no CheckpointHook attached


@pytest.mark.parametrize("async_save", [False, True])
def test_ckpt_block_recorded_on_save_steps(tmp_path, async_save):
    tr, batches = _tiny_trainer(total_steps=4, checkpoint_every=2,
                                checkpoint_dir=str(tmp_path),
                                async_checkpoint=async_save)
    blocked = {r["step"]: r["ckpt_block_ms"] for r in tr.fit(batches)}
    assert blocked[2] > 0.0 and blocked[4] > 0.0
    assert blocked[1] == 0.0 and blocked[3] == 0.0
    assert sorted(os.listdir(str(tmp_path))) == ["step_2", "step_4"]


# --------------------------------------------------------------------------- #
# Resume is bit-exact.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("async_save", [False, True])
def test_resume_equals_uninterrupted_run(tmp_path, async_save):
    """6 straight steps against 3 steps, a checkpoint, a fresh trainer
    resumed from it and 3 more, all fed by the streaming pipeline (the
    resumed one seeking to batch 3) with the double buffer on."""
    src = SyntheticShardSource(CFG, batch=BATCH, seq=SEQ, n_batches=6,
                               shard_size=2)
    cache = str(tmp_path / "cache")

    def run(start=0, resume=None, every=3):
        tr, _ = _tiny_trainer(total_steps=6, checkpoint_every=every,
                              checkpoint_dir=str(tmp_path / "run"),
                              async_checkpoint=async_save,
                              double_buffer=True)
        if resume:
            assert tr.resume(resume) == start
        with Pipeline(src, cache_dir=cache, start_batch=start) as pipe:
            return tr, tr.fit(pipe)

    full, hist = run()
    assert ckpt.latest_step(str(tmp_path / "run")) == 6
    want = _state_arrays(full)
    cont, tail = run(start=3, resume=str(tmp_path / "run" / "step_3"),
                     every=0)
    assert [r["step"] for r in tail] == [4, 5, 6]
    assert [r["loss"] for r in tail] == [r["loss"] for r in hist[3:]]
    _assert_equal_state(cont, want)
    on_disk = ckpt.restore_checkpoint(str(tmp_path / "run" / "step_6"),
                                      cont.checkpoint_tree())
    for a, b in zip(_parts(on_disk), want):
        assert torch.equal(a, b)


def test_cli_resume_equals_uninterrupted_run(tmp_path, capsys):
    base = ["--arch", "gemma-7b", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "16"]
    assert cli.main(base + ["--checkpoint-every", "2", "--checkpoint-dir",
                            str(tmp_path / "a")]) == 0
    full = capsys.readouterr().out.splitlines()
    assert sorted(os.listdir(str(tmp_path / "a"))) == ["step_2", "step_4"]
    assert cli.main(base + ["--resume", str(tmp_path / "a" / "step_2"),
                            "--checkpoint-dir", str(tmp_path / "b")]) == 0
    cont = capsys.readouterr().out.splitlines()
    strip = lambda ln: ln.split(" (")[0]  # noqa: E731 — drop the wall time
    assert [strip(x) for x in cont[:2]] == [strip(x) for x in full[2:4]]
    assert cont[0].startswith("step 3: loss=")
    last = lambda out: out[-1].split(", 'step_ms'")[0]  # noqa: E731
    assert last(cont) == last(full)


@pytest.mark.parametrize("async_save", [False, True])
def test_resume_with_bf16_state(tmp_path, async_save):
    """Reduced grok-1-314b keeps its Adam moments in bfloat16 (and 4
    microbatches of bf16 gradients, as the full config): checkpoints
    every 2 steps name them ``bfloat16``, and a fresh trainer resumed
    from step 2 takes steps 3-4 to the uninterrupted run's losses and
    state, bitwise."""
    cfg = dataclasses.replace(get_config("grok-1-314b").reduced(),
                              microbatches=4)
    assert cfg.moment_dtype == "bfloat16" and cfg.grad_dtype == "bfloat16"

    def run(resume=None, every=2):
        tr = Trainer(cfg, TrainerConfig(
            total_steps=4, log_every=0, checkpoint_every=every,
            checkpoint_dir=str(tmp_path / "run"),
            async_checkpoint=async_save), device="cpu")
        start = tr.resume(resume) if resume else 0
        return tr, tr.fit(itertools.islice(
            synthetic_lm_batches(cfg, batch=4, seq=16, steps=4), start, None))

    full, hist = run()
    assert sorted(os.listdir(str(tmp_path / "run"))) == ["step_2", "step_4"]
    dtypes = json.load(open(str(tmp_path / "run" / "step_2" /
                                "manifest.json")))["dtypes"]
    assert "bfloat16" in dtypes
    want = _state_arrays(full)
    assert any(w.dtype == torch.bfloat16 for w in want)
    cont, tail = run(resume=str(tmp_path / "run" / "step_2"), every=0)
    assert [r["loss"] for r in tail] == [r["loss"] for r in hist[2:]]
    _assert_equal_state(cont, want)


def test_bf16_leaves_in_the_reference_format(tmp_path):
    """A bfloat16 leaf written by the reference restores into the port
    bitwise, and the port writes the same manifest and array bytes."""
    bits = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    ref = {"m": jax.numpy.asarray(bits, dtype=jax.numpy.bfloat16),
           "w": jax.numpy.asarray(bits)}
    jax_ckpt.save_checkpoint(str(tmp_path / "ref"), ref, step=1)
    got = ckpt.restore_checkpoint(
        str(tmp_path / "ref"),
        {"m": torch.empty(3, 5, dtype=torch.bfloat16), "w": torch.empty(3, 5)})
    assert got["m"].dtype == torch.bfloat16
    assert torch.equal(got["m"].view(torch.int16), torch.from_numpy(
        np.asarray(ref["m"]).view(np.int16)))
    assert torch.equal(got["w"], torch.from_numpy(bits))
    ckpt.save_checkpoint(str(tmp_path / "port"), got, step=1)
    for name in ("ref", "port"):
        with np.load(str(tmp_path / name / "arrays.npz")) as data:
            assert data["a0"].dtype == np.dtype("V2")
            assert data["a0"].tobytes() == np.asarray(ref["m"]).tobytes()
    manifest = lambda n: json.load(open(  # noqa: E731
        str(tmp_path / n / "manifest.json")))
    for key in ("names", "dtypes", "shapes"):
        assert manifest("port")[key] == manifest("ref")[key]


# --------------------------------------------------------------------------- #
# The reference's format: names, and checkpoints crossing packages.
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference trainer on the same reduced config, fitted 2 steps,
    and its checkpoint."""
    ref_cfg = dataclasses.replace(jax_get_config("gemma-7b").reduced(),
                                  **FP32)
    tr = JaxTrainer(ref_cfg, single_device_mesh(),
                    JaxTrainerConfig(total_steps=4, log_every=0))
    tr.fit(jax_batches(ref_cfg, batch=BATCH, seq=SEQ, steps=2))
    path = str(tmp_path_factory.mktemp("ref") / "step_2")
    jax_ckpt.save_checkpoint(path, tr.state, step=2, pspecs=tr.state_specs)
    return tr, path


def test_manifest_names_are_the_reference_keystr(reference_run, tmp_path):
    ref_tr, ref_path = reference_run
    names, _ = ckpt._flatten_with_names(_tiny_trainer()[0].checkpoint_tree())
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_tr.state)
    assert names == [jax.tree_util.keystr(p) for p, _ in flat]
    assert "['opt']['m']['blocks'][0]['mixer']['wq']" in names
    ckpt.save_checkpoint(str(tmp_path), _tiny_trainer()[0].checkpoint_tree(),
                         step=0)
    mine = json.load(open(str(tmp_path / "manifest.json")))
    ref = json.load(open(os.path.join(ref_path, "manifest.json")))
    for key in ("names", "dtypes", "shapes"):
        assert mine[key] == ref[key]


def test_reference_checkpoint_restores_into_the_port(reference_run):
    ref_tr, ref_path = reference_run
    tr, _ = _tiny_trainer(total_steps=4)
    assert tr.resume(ref_path) == 2
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref_tr.state)]
    got = [ckpt._flatten_with_names(tr.checkpoint_tree())[1][i]
           for i in range(len(want))]
    for g, w in zip(got, want):
        g = (torch.stack(g.parts) if isinstance(g, Stacked) else g)
        g = g.detach().numpy()
        np.testing.assert_array_equal(g, w)
    # and it trains on from there as the reference does
    ref_cfg = dataclasses.replace(jax_get_config("gemma-7b").reduced(),
                                  **FP32)
    ref_next = JaxTrainer(ref_cfg, single_device_mesh(),
                          JaxTrainerConfig(total_steps=3, log_every=0))
    ref_next.resume(ref_path)
    ref_loss = ref_next.fit(itertools.islice(
        jax_batches(ref_cfg, batch=BATCH, seq=SEQ, steps=3), 2, 3))
    tr.tcfg.total_steps = 3
    loss = tr.fit(_batches(2, 3))
    np.testing.assert_allclose(loss[0]["loss"], ref_loss[0]["loss"],
                               rtol=1e-5)


def test_port_checkpoint_restores_into_the_reference(reference_run,
                                                      tmp_path):
    ref_tr, _ = reference_run
    tr, batches = _tiny_trainer(total_steps=2)
    tr.fit(batches)
    path = str(tmp_path / "step_2")
    ac = ckpt.AsyncCheckpointer()
    ac.save(path, tr.checkpoint_tree(), step=2)
    ac.wait()
    restored = jax_ckpt.restore_checkpoint(path, ref_tr.state)
    got = [np.asarray(x) for x in jax.tree_util.tree_leaves(restored)]
    want = [(torch.stack(leaf.parts) if isinstance(leaf, Stacked)
             else leaf).detach().numpy()
            for leaf in ckpt._flatten_with_names(tr.checkpoint_tree())[1]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert jax_ckpt.manifest_step(path) == 2
    assert jax_ckpt.latest_step(str(tmp_path)) == 2


# --------------------------------------------------------------------------- #
# On the card (skipped without one).
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the async writer's CUDA "
                    "streams and pinned staging have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_async_save_on_the_card_equals_sync(cuda_device, tmp_path,
                                            monkeypatch):
    """The async writer's staged copy (chunks shrunk so that the buffer
    takes many, with a short tail) writes what the sync save writes, and
    holds the state as queued, not as updated after the save."""
    monkeypatch.setattr(ckpt, "_CHUNK", 4096 + 64)
    gen = torch.Generator(cuda_device).manual_seed(0)
    state = {"w": Stacked([torch.randn(33, 17, generator=gen,
                                       device=cuda_device)
                           for _ in range(3)]),
             "b": torch.randn(1001, generator=gen, device=cuda_device),
             "step": torch.tensor(7, dtype=torch.int32, device=cuda_device)}
    ckpt.save_checkpoint(str(tmp_path / "sync"), state, step=7)
    ac = ckpt.AsyncCheckpointer()
    ac.save(str(tmp_path / "async"), state, step=7)
    for p in state["w"].parts:  # queued after the snapshot on the stream
        p.add_(1.0)
    ac.wait()
    a = np.load(str(tmp_path / "sync" / "arrays.npz"))
    b = np.load(str(tmp_path / "async" / "arrays.npz"))
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    ac.release()
