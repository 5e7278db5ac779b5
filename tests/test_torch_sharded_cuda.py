"""The sharded trainer on the card only (marked ``cuda``, skipped
without one): ``Trainer(..., mesh=)`` on a 1 x 1 ("data", "model") NCCL
mesh of one rank against the one-device ``Trainer``, from the same
seed's weights and batches. Reduced yi-9b widened to 8/2 heads of 64 (d
512), fp32, ``wus`` with ``seq_parallel``, 3 Adam steps through the
flash kernels: every collective over one rank is a copy and the mesh
path runs the same arithmetic in the same order, so the losses and
every weight must be bitwise equal, the grad norms (summed in another
order) within 1e-6 relative. ``chip_smoke.py``'s ``dist-train`` phase
runs yi-9b at full width.

With four cards (skipped with fewer), four NCCL ranks (spawned, one a
card) train the same model on a (2, 2) ("data", "model") mesh in
``wus`` with ``seq_parallel``, ``fsdp`` without it and ``replicated``
with it: 2 of the 4 rows and 4/1 of the 8/2 heads a rank, real
collectives over NVLink. Each is held against the one-device trainer on
card 0 as the CPU's 8-rank test holds its cases (Adam at eps 1e-3; the
loss, nll and grad norm to 1e-5 relative, every leaf to 1e-5 of its
largest magnitude, replicated blocks equal on every rank). Then yi-9b at
full width cut to 8 layers trains 3 steps of batch 4 x 2048 on a (4, 1)
mesh in its own mode (``wus``: one row a rank, the moments a quarter a
rank) beside the one-device trainer on card 0: each rank's step time
and peak memory are printed (``-s``), the losses held to 1e-3 relative
(bf16 compute, the batch's rows summed in another order).

This file imports no JAX, so it runs on a card where JAX is missing."""
import dataclasses
import os
import pickle
import tempfile
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.optim import adam, constant
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.hooks import Hook
from repro_torch.utils import tree_leaves

STEPS = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mesh_trainer_on_one_card_matches_one_device(cuda_device):
    import torch.distributed as dist

    from repro_torch.launch.mesh import single_device_mesh

    cfg = dataclasses.replace(
        get_config("yi-9b").reduced(), d_model=512, n_heads=8, n_kv_heads=2,
        head_dim=64, dtype="float32", param_sharding="wus",
        seq_parallel=True)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab, (4, 64))}
               for _ in range(STEPS)]
    runs = []
    mesh = single_device_mesh("cuda")
    try:
        for m in (None, mesh):
            fa.flash_attention_fwd_cuda.launches = 0
            tr = Trainer(cfg, TrainerConfig(total_steps=STEPS, log_every=0,
                                            metrics=("grad_norm",)),
                         adam(constant(1e-2)), device=cuda_device, mesh=m)
            hist = tr.fit(batches, hooks=[])
            runs.append(([r["loss"] for r in hist],
                         [r["grad_norm"] for r in hist],
                         [w.detach().cpu() for w in
                          tree_leaves(tr.state["params"])],
                         fa.flash_attention_fwd_cuda.launches))
    finally:
        dist.destroy_process_group()
    (loss0, gn0, w0, n0), (loss1, gn1, w1, n1) = runs
    assert n0 == n1 == cfg.n_layers * STEPS  # no remat in reduced()
    assert loss0 == loss1, (loss0, loss1)
    for a, b in zip(gn0, gn1):
        assert abs(a - b) <= 1e-6 * abs(a), (gn0, gn1)
    assert all(torch.equal(a, b) for a, b in zip(w0, w1))


# --------------------------------------------------------------------------- #
# Four cards.
# --------------------------------------------------------------------------- #
WORLD4 = 4
FOUR_CASES = {"wus_sp1": ("wus", True), "fsdp_sp0": ("fsdp", False),
              "replicated_sp1": ("replicated", True)}
FULL_LAYERS, FULL_BATCH, FULL_SEQ = 8, 4, 2048


def small_config(mode="wus", sp=True):
    return dataclasses.replace(
        get_config("yi-9b").reduced(), d_model=512, n_heads=8, n_kv_heads=2,
        head_dim=64, dtype="float32", param_sharding=mode, seq_parallel=sp)


def full_config():
    return dataclasses.replace(get_config("yi-9b"), n_layers=FULL_LAYERS)


def small_batches(cfg):
    rng = np.random.default_rng(1)
    return [{"tokens": rng.integers(0, cfg.vocab, (4, 64))}
            for _ in range(STEPS)]


def small_run(cfg, device, mesh=None):
    """(metrics a step, the trainer) of 3 Adam steps from seed 3."""
    from repro_torch.models import lm

    params = lm.init_lm(cfg, 3, device=device, dtype=torch.float32)
    tr = Trainer(cfg, TrainerConfig(total_steps=STEPS, log_every=0,
                                    metrics=("grad_norm",)),
                 adam(constant(1e-2), eps=1e-3), device=device,
                 params=params, mesh=mesh)
    hist = tr.fit(small_batches(cfg), hooks=[])
    return [{k: r[k] for k in ("loss", "nll", "grad_norm")}
            for r in hist], tr


class SyncEveryStep(Hook):
    """``fit`` waits for the card after each step, so ``step_ms`` is the
    step's time on the card."""
    needs_sync = True


def full_run(device, mesh=None):
    """yi-9b cut to 8 layers, seed 0's weights, 3 steps of batch 4 x
    2048: (losses, step ms, peak GiB of this rank's card)."""
    from repro_torch.data.pipeline import synthetic_lm_batches

    cfg = full_config()
    torch.cuda.reset_peak_memory_stats(device)
    tr = Trainer(cfg, TrainerConfig(total_steps=STEPS, log_every=0),
                 device=device, mesh=mesh)
    hist = tr.fit(synthetic_lm_batches(cfg, batch=FULL_BATCH, seq=FULL_SEQ,
                                       steps=STEPS, seed=0),
                  hooks=[SyncEveryStep()])
    out = ([r["loss"] for r in hist], [r["step_ms"] for r in hist],
           torch.cuda.max_memory_allocated(device) / 2**30)
    del tr
    torch.cuda.empty_cache()
    return out


def four_rank_main(rank, store, out_dir, device_type="cuda", full=True):
    """One rank of the four: the small cases on (2, 2), then (``full``)
    the full-width timing on (4, 1); its blocks and readings pickled."""
    import torch.distributed as dist

    from repro_torch.dist import spmd
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.models import lm

    torch.set_num_threads(1)
    init_process_group(device=device_type, rank=rank, world_size=WORLD4,
                       store_path=store)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    out = {}
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device=device_type)
        for name, (mode, sp) in FOUR_CASES.items():
            try:
                hist, tr = small_run(small_config(mode, sp), dev, mesh)
                whole = lm.init_lm(tr.cfg, 3, device="cpu",
                                   dtype=torch.float32)
                specs = spmd.leaf_list(whole, tr.plan.pspecs)
                out[name] = {"hist": hist, "blocks": [
                    (spmd.block_slices(s, f.shape, mesh),
                     w.detach().cpu().numpy())
                    for f, s, w in zip(tree_leaves(whole), specs,
                                       tree_leaves(tr.state["params"]))]}
                del tr
            except Exception:  # recorded; the test fails with it
                out[name] = {"error": traceback.format_exc()}
        if full:
            mesh4 = make_mesh((WORLD4, 1), ("data", "model"),
                              device=device_type)
            try:
                out["full"] = full_run(dev, mesh4)
            except Exception:
                out["full"] = {"error": traceback.format_exc()}
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()


def launch_four(out_dir, device_type="cuda", full=True, timeout=420):
    """The four ranks as spawned processes; returns their results."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=four_rank_main,
                         args=(r, store, out_dir, device_type, full))
             for r in range(WORLD4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD4, f"rank exit codes {codes}"
    out = []
    for r in range(WORLD4):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def hold_four(got, hist, leaves, name):
    """A case's ranks against the one-device run; returns the worst leaf
    error over the leaf's largest magnitude."""
    for r, g in enumerate(got):
        assert "error" not in g, f"rank {r}, {name}:\n{g['error']}"
        for step, (a, b) in enumerate(zip(g["hist"], hist)):
            for k in ("loss", "nll", "grad_norm"):
                assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (name, step, k)
    full = [np.full(w.shape, np.nan, np.float32) for w in leaves]
    for g in got:
        for i, (sl, blk) in enumerate(g["blocks"]):
            seen = ~np.isnan(full[i][sl])
            assert np.array_equal(full[i][sl][seen], blk[seen]), (name, i)
            full[i][sl] = blk
    return max(float(np.abs(f - w).max() / np.abs(w).max())
               for f, w in zip(full, leaves))


@pytest.mark.cuda
def test_mesh_trainer_on_four_cards_matches_one_device(cuda_device):
    if torch.cuda.device_count() < WORLD4:
        pytest.skip(f"needs {WORLD4} cards; this machine has "
                    f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        out = launch_four(tmp)
    hist, tr = small_run(small_config(), cuda_device)
    leaves = [w.detach().cpu().numpy() for w in
              tree_leaves(tr.state["params"])]
    del tr
    for name in FOUR_CASES:
        worst = hold_four([o[name] for o in out], hist, leaves, name)
        print(f"four cards, {name}: worst leaf error {worst:.3g}")
        assert worst <= 1e-5, (name, worst)
    for r, o in enumerate(out):
        assert "error" not in o["full"], o["full"]["error"]
    one = full_run(cuda_device)
    print(f"yi-9b {FULL_LAYERS} layers, batch {FULL_BATCH} x {FULL_SEQ}: one "
          f"card losses {one[0]}, step ms {one[1]}, peak {one[2]:.2f} GiB")
    for r, o in enumerate(out):
        loss, ms, peak = o["full"]
        print(f"  rank {r} of a (4, 1) wus mesh: losses {loss}, step ms "
              f"{ms}, peak {peak:.2f} GiB")
    # the first step's loss, before any update: the same rows in bf16,
    # summed over ranks in another order
    first = [o["full"][0][0] for o in out]
    assert len(set(first)) == 1, first
    assert abs(first[0] - one[0][0]) <= 1e-3 * abs(one[0][0]), (first, one)
