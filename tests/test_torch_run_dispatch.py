"""The port's dispatcher (``repro_torch.run.dispatch.run_spec``) against
the reference's (``repro.run.dispatch.run_spec``) on the committed spec
files, reduced and in fp32 (``--set model.dtype=float32``), on the CPU
and on the reference's weights: the reference's dispatcher draws them
from ``jax.random.PRNGKey(spec.seed)``; the port takes the same tree
through ``params=`` (the weight bridge).

- ``runs/serve_prefix.toml`` and ``runs/serve_paged.toml`` (``tp2d`` on
  the 1 x 1 mesh: a one-rank gloo group the dispatcher opens and
  destroys): every request's greedy tokens bitwise, the printed request
  lines equal.
- ``runs/serve_fleet.toml`` (two replicas, a kill at step 6): every id
  completes once, the tokens bitwise, the fleet's counts equal.
- ``runs/gemma_7b_train.json`` with ``trainer.total_steps=3``: per-step
  losses, nlls and grad norms, and ``--mode eval``'s nll, within rtol
  1e-4 (``tests/test_torch_train.py``'s tolerance).
- ``runs/rwkv6_3b_server.toml`` serves its four requests (port only).
- ``--mode bench``, ``trainer.bench_out`` and ``dryrun.bench_out``
  raise ``NotImplementedError`` naming ROADMAP.md item 6.5; the CLI exits
  2.
- The dry run on reduced configs: one (arch, shape) through ``run_spec``
  and the CLI (its JSON written, whatever ``--device`` says), and
  ``dryrun.all`` over reduced yi-9b, mixtral-8x7b and whisper-medium: 12
  rows, yi's and mixtral's 4 results each (mixtral's MoE split over
  ``model``), whisper's 3 results (the enc-dec on 16 x 16), whisper's
  ``long_500k`` skipped, exit code 0; an open process group makes it
  raise.
- The k8s manifests equal the reference's but for the container's
  command and its GPU limit.
- The spec-table rows of reduced yi-9b and mixtral-8x7b on 16 x 16, in
  every mode, map to the reference's ``spec_table`` rows.
- The launcher shims equal the run CLI; ``--profile`` writes its JSON;
  ``core.distributed_eval.train_and_eval_loop`` gives the reference's
  history on a toy step.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.run import dispatch as JD  # noqa: E402
from repro.run import apply_assignments as japply  # noqa: E402
from repro.run import load_spec_file as jload  # noqa: E402
from repro.train.steps import ModelAPI as JaxModelAPI  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.run import apply_assignments, load_spec_file  # noqa: E402
from repro_torch.run import cli  # noqa: E402
from repro_torch.run import dispatch as PD  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
RUNS = os.path.join(ROOT, "runs")
FP32 = ["model.dtype=float32", "model.kv_cache_dtype=float32"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs (the suite runs several
    workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def specs(name, *sets):
    """(port spec, reference spec) of a committed file with ``sets``."""
    path = os.path.join(RUNS, name)
    return (apply_assignments(load_spec_file(path), list(sets)),
            japply(jload(path), list(sets)))


def serve_params(jspec):
    """The tree the reference's ``_run_serve`` draws, as numpy."""
    cfg = JD.resolve_config(jspec)
    vals, _ = split_tree(JaxModelAPI(cfg).init(
        cfg, jax.random.PRNGKey(jspec.seed)))
    return jax.tree_util.tree_map(np.asarray, vals)


def req_lines(out):
    """The printed request lines, without the ids (each process numbers
    its requests from a counter of its own)."""
    return [ln.split(":", 1)[1] for ln in out.splitlines()
            if ln.startswith("  req ")]


def tokens(report):
    """Each request's tokens, in id order."""
    return [list(r.tokens) for r in sorted(report.requests,
                                           key=lambda r: r.id)]


# --------------------------------------------------------------------------- #
# serve and fleet
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["serve_prefix.toml", "serve_paged.toml"])
def test_serve_spec_tokens_equal_the_references(capsys, name):
    spec, jspec = specs(name, *FP32)
    want = JD.run_spec(jspec)
    want_out = capsys.readouterr().out
    got = PD.run_spec(spec, device="cpu", params=serve_params(jspec))
    out = capsys.readouterr().out
    assert not torch.distributed.is_initialized()  # its group is gone
    assert tokens(got["report"]) == tokens(want["report"])
    assert len(tokens(got["report"])) == spec.serve.batch
    assert req_lines(out) == req_lines(want_out)
    assert out.startswith(f"gemma-7b [server, mode=tp2d, device=cpu, "
                          f"slots={spec.serve.max_batch}, kv=paged")
    r, w = got["report"], want["report"]
    assert (r.prefix_hit_rate, r.pages_shared, r.prefill_tokens_skipped) \
        == (w.prefix_hit_rate, w.pages_shared, w.prefill_tokens_skipped)
    assert got["engine"].rules.mode == "tp2d"


def test_serve_fleet_spec_equals_the_references(capsys):
    spec, jspec = specs("serve_fleet.toml", *FP32)
    assert (spec.fleet.n_replicas, spec.fleet.chaos,
            spec.fleet.chaos_step) == (2, "kill", 6)
    want = JD.run_spec(jspec)
    want_out = capsys.readouterr().out
    got = PD.run_spec(spec, device="cpu", params=serve_params(jspec))
    out = capsys.readouterr().out
    g, w = got["report"], want["report"]
    ids = sorted(r.id for r in g.merged.requests)
    assert len(set(ids)) == len(ids) == spec.serve.batch  # every id once
    assert tokens(g.merged) == tokens(w.merged)
    assert req_lines(out) == req_lines(want_out)
    assert (g.kills, g.stalls, g.reroutes, g.lost_tokens) == \
        (w.kills, w.stalls, w.reroutes, w.lost_tokens)
    assert g.replica_states == w.replica_states and g.kills == 1
    assert out.startswith("gemma-7b [fleet x2, routing=prefix, chaos=kill, "
                          "slots=3/replica, kv=paged")


def test_rwkv6_server_spec_serves_its_requests(capsys):
    spec = load_spec_file(os.path.join(RUNS, "rwkv6_3b_server.toml"))
    got = PD.run_spec(spec, device="cpu")
    out = capsys.readouterr().out
    report = got["report"]
    assert len({r.id for r in report.requests}) == spec.serve.batch
    assert all(len(t) == spec.serve.tokens for t in tokens(report))
    vocab = get_config("rwkv6-3b").reduced().vocab
    assert all(0 <= x < vocab for t in tokens(report) for x in t)
    assert got["engine"].layout == "slab"
    assert out.startswith("rwkv6-3b [server, device=cpu, slots=2, kv=slab]")
    assert len(req_lines(out)) == spec.serve.batch


# --------------------------------------------------------------------------- #
# train and eval
# --------------------------------------------------------------------------- #
def train_params(jspec):
    """The reference trainer's initial weights (its own init), as numpy."""
    tr = JD._make_trainer(jspec)
    return jax.tree_util.tree_map(np.asarray, tr.state["params"])


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_train_spec_matches_the_references(capsys, mode):
    spec, jspec = specs("gemma_7b_train.json", *FP32,
                        "trainer.total_steps=3", f"mode={mode}")
    params = train_params(jspec)
    want = JD.run_spec(jspec)
    want_out = capsys.readouterr().out
    got = PD.run_spec(spec, device="cpu", params=params)
    out = capsys.readouterr().out
    if mode == "eval":
        np.testing.assert_allclose(got["eval"]["eval_nll"],
                                   want["eval"]["eval_nll"], rtol=1e-4)
        assert out.startswith("eval gemma-7b-smoke: nll=")
        assert want_out.startswith("eval gemma-7b-smoke: nll=")
        return
    hist, ref = got["history"], want["history"]
    assert [r["step"] for r in hist] == [r["step"] for r in ref] == [1, 2, 3]
    for key in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in hist],
                                   [r[key] for r in ref], rtol=1e-4)
    assert out.splitlines()[-1].startswith("done {'step': 3, ")


def test_train_shim_equals_the_run_cli(capsys):
    """``launch.train`` is a shim: the same lines and history as
    ``python -m repro_torch run --mode train`` with the same knobs."""
    from repro_torch.launch import train as train_cli

    strip = lambda s: re.sub(  # noqa: E731 — drop the wall times
        r"\(\d+\.\d+s\)|'(step_ms|data_wait_ms|ckpt_block_ms)': [0-9.e-]+",
        "X", s)
    assert train_cli.main(["--arch", "gemma-7b", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "16"]) \
        == 0
    shim = capsys.readouterr().out
    hist = PD.LAST_RESULT["history"]
    assert cli.main(["run", "--arch", "gemma-7b", "--mode", "train",
                     "--device", "cpu", "--set", "trainer.total_steps=2",
                     "--set", "trainer.batch=2", "--set", "trainer.seq=16",
                     "--set", "trainer.log_every=1"]) == 0
    assert strip(capsys.readouterr().out) == strip(shim)
    assert [r["loss"] for r in PD.LAST_RESULT["history"]] == \
        [r["loss"] for r in hist]


@pytest.mark.parametrize("trace", [False, True])
def test_profile_writes_launches_and_the_trace(tmp_path, capsys, trace):
    path = tmp_path / "profile.json"
    assert cli.main(["run", "--spec", os.path.join(RUNS, "serve_paged.toml"),
                     "--device", "cpu", "--set", "serve.tokens=2",
                     "--profile", str(path)] + ["--trace"] * trace) == 0
    rec = json.loads(path.read_text())
    report = PD.LAST_RESULT["report"]
    assert rec["chunk_steps"] == len(report.steps) > 0
    assert rec["summary"] == json.loads(json.dumps(report.summary()))
    assert rec["launches"]["paged_attention"] == 0  # the CPU's plain path
    assert set(rec["launches"]) >= {"paged_attention", "flash_attention_fwd",
                                    "flash_attention_bwd", "mamba_scan"}
    assert rec["wall_ms"] > 0
    assert ("kernels" in rec) == trace
    if trace:  # no device: no kernel has device time
        assert rec["kernels"] == [] and rec["busy_ms"] == 0
    assert len(req_lines(capsys.readouterr().out)) == 5
    with pytest.raises(SystemExit):
        cli.main(["run", "--trace"])


# --------------------------------------------------------------------------- #
# what the port does not run yet
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sets,item", [
    (["mode=bench", "bench.smoke=true"], "6.5"),
    (["trainer.bench_out=/tmp/b.json"], "6.5"),
    (["mode=dryrun", "dryrun.bench_out=/tmp/b.json"], "6.5"),
])
def test_unported_modes_raise_naming_their_item(capsys, sets, item):
    from repro_torch.run import RunSpec

    spec = apply_assignments(RunSpec(), sets)
    with pytest.raises(NotImplementedError,
                       match=rf"\(ROADMAP.md item {item}\)"):
        PD.run_spec(spec, device="cpu")
    argv = [a for s in sets for a in ("--set", s)]
    assert cli.main(["run", *argv, "--device", "cpu"]) == 2
    assert f"ROADMAP.md item {item}" in capsys.readouterr().err
    if item == "6.5" and spec.mode == "bench":
        assert load_spec_file(os.path.join(RUNS, "bench_smoke.json")).mode \
            == "bench"


# --------------------------------------------------------------------------- #
# the dry run (launch.dryrun.dryrun_one over a fake world of this process)
# --------------------------------------------------------------------------- #
REDUCED = ("yi-9b", "mixtral-8x7b", "whisper-medium")


@pytest.fixture
def reduced_archs(monkeypatch):
    """``dryrun_one`` on the reduced configs, ``list_archs`` the three."""
    import repro_torch.configs as configs
    from repro_torch.launch import dryrun as D

    monkeypatch.setattr(D, "get_config",
                        lambda arch: get_config(arch).reduced())
    monkeypatch.setattr(configs, "list_archs", lambda: list(REDUCED))


ROW_KEYS = {"arch", "shape", "multi_pod", "devices", "mode",
            "flops_per_device", "collective_bytes_per_device",
            "collective_counts", "argument_bytes_per_device",
            "output_bytes_per_device", "temp_bytes_per_device",
            "peak_bytes_per_device", "trace_s"}


@pytest.mark.parametrize("via", ["run_spec", "cli"])
def test_dryrun_one_shape(tmp_path, capsys, reduced_archs, via):
    out = tmp_path / "dry.json"
    sets = ["mode=dryrun", "arch=yi-9b", "dryrun.shape=decode_32k",
            "mesh=multipod", f"dryrun.json_out={out}"]
    if via == "cli":
        argv = [a for s in sets for a in ("--set", s)]
        assert cli.main(["run", *argv, "--device", "cuda"]) == 0
        rows = PD.LAST_RESULT["results"]
    else:
        rows = PD.run_spec(apply_assignments(PD.RunSpec(), sets),
                           device="cuda")["results"]
    text = capsys.readouterr().out
    assert "== yi-9b x decode_32k (2-pod, 512 devices) ==" in text
    assert "1/1 dry-runs succeeded" in text
    assert json.loads(out.read_text()) == rows
    (row,) = rows
    assert set(row) == ROW_KEYS
    assert row["devices"] == 512 and row["multi_pod"] is True
    assert row["flops_per_device"] > 0
    assert 0 < row["argument_bytes_per_device"] <= row["peak_bytes_per_device"]


def test_dryrun_all_rows_errors_and_skip(tmp_path, capsys, reduced_archs):
    from repro_torch.run import RunSpec

    spec = apply_assignments(RunSpec(), ["mode=dryrun", "dryrun.all=true"])
    res = PD.run_spec(spec, device="cpu")
    rows = res["results"]
    assert res["exit_code"] == 0
    assert [(r["arch"], r["shape"]) for r in rows] == [
        (a, s) for a in REDUCED for s in ("train_4k", "prefill_32k",
                                          "decode_32k", "long_500k")]
    by = {(r["arch"], r["shape"]): r for r in rows}
    for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert set(by["yi-9b", s]) == ROW_KEYS
        assert set(by["mixtral-8x7b", s]) == ROW_KEYS  # MoE over model 16
    for s in ("train_4k", "prefill_32k", "decode_32k"):  # enc-dec on 16 x 16
        assert set(by["whisper-medium", s]) == ROW_KEYS
    assert "skipped" in by["whisper-medium", "long_500k"]
    assert "12/12 dry-runs succeeded" in capsys.readouterr().out


def test_dryrun_must_own_the_process():
    import torch.distributed as dist

    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.run import RunSpec

    single_device_mesh("cpu")
    try:
        with pytest.raises(RuntimeError, match="must own the process"):
            PD.run_spec(apply_assignments(
                RunSpec(), ["mode=dryrun", "dryrun.shape=decode_32k"]),
                device="cpu")
        assert dist.is_initialized()  # the caller's group is left up
    finally:
        dist.destroy_process_group()


def test_module_entry_point_runs(tmp_path):
    """``python -m repro_torch`` is the run CLI: a spec error exits 2 with
    the reference's message, and a fleet spec renders in dryrun mode."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", "--set",
         "trainer.total_stepz=5"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120)
    assert out.returncode == 2
    assert "did you mean 'total_steps'" in out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", "--spec",
         "runs/serve_fleet.toml", "--mode", "dryrun", "--device", "cpu",
         "--set", f"fleet.k8s_out={tmp_path / 'fleet.yaml'}"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "k8s manifests (2 replica(s))" in out.stdout
    text = (tmp_path / "fleet.yaml").read_text()
    assert "nvidia.com/gpu: 1" in text and '- "repro_torch"' in text


# --------------------------------------------------------------------------- #
# k8s manifests
# --------------------------------------------------------------------------- #
def with_port_differences(manifests):
    """The reference's manifests with the port's two differences: the
    container's command and its GPU limit (after its ports)."""
    out = json.loads(json.dumps(manifests))
    (c,) = out[1]["spec"]["template"]["spec"]["containers"]
    assert c["command"][:3] == ["python", "-m", "repro"]
    c["command"][2] = "repro_torch"
    keys = list(c)
    at = keys.index("ports") + 1
    items = list(c.items())
    items.insert(at, ("resources", {"limits": {"nvidia.com/gpu": 1}}))
    c.clear()
    c.update(items)
    return out


@pytest.mark.parametrize("sets", [
    [], ["fleet.n_replicas=3", "fleet.image=registry/x:1", "fleet.port=9000",
         "arch=Yi_9B"],
    ["mode=dryrun", "fleet.k8s_out=/tmp/out.yaml", "fleet.chaos=stall"],
])
def test_k8s_manifests_equal_the_references_but_command_and_gpu(sets):
    from repro.launch import k8s as jk8s
    from repro_torch.launch import k8s

    spec, jspec = specs("serve_fleet.toml", *sets)
    want = with_port_differences(jk8s.render_manifests(jspec))
    got = k8s.render_manifests(spec)
    assert got == want
    assert json.dumps(got) == json.dumps(want)  # key order too
    assert k8s.render(spec) == jk8s.to_yaml(want)
    assert k8s.app_name(spec) == jk8s.app_name(jspec)
    bad, jbad = specs("serve_prefix.toml")
    with pytest.raises(ValueError) as e:
        k8s.render_manifests(bad)
    with pytest.raises(ValueError) as je:
        jk8s.render_manifests(jbad)
    assert str(e.value) == str(je.value)


def test_fleet_dryrun_renders_through_the_dispatcher(tmp_path, capsys):
    from repro.launch import k8s as jk8s

    out = tmp_path / "m.yaml"
    spec, jspec = specs("serve_fleet.toml", "mode=dryrun",
                        f"fleet.k8s_out={out}")
    got = PD.run_spec(spec, device="cpu")
    assert out.read_text() == got["yaml"]
    assert got["yaml"] == jk8s.to_yaml(
        with_port_differences(jk8s.render_manifests(jspec)))
    assert capsys.readouterr().out == \
        f"k8s manifests (2 replica(s)) -> {out}\n"


# --------------------------------------------------------------------------- #
# spec tables
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun`` imported with the process's XLA_FLAGS kept
    (the module sets them for its own process at import)."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun

    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


def entries(spec: str):
    """A printed ``PartitionSpec(...)`` as the tuple of its entries."""
    return eval(spec, {"PartitionSpec": lambda *e: e})


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x7b"])
@pytest.mark.parametrize("mode", ["replicated", "fsdp", "wus", "tp2d"])
def test_spec_table_rows_map_to_the_references(monkeypatch, ref_dryrun,
                                               capsys, arch, mode):
    """Reduced configs on 16 x 16 (the reference's side on an abstract
    mesh): each port row (one a layer) is the reference's row of its
    pattern position with the leading ``layer`` dim and spec entry
    dropped, and every reference row is met."""
    from repro_torch.launch import dryrun as PDry

    monkeypatch.setattr(ref_dryrun, "get_config",
                        lambda a: jax_get_config(a).reduced())
    monkeypatch.setattr(ref_dryrun, "make_production_mesh",
                        lambda multi_pod=False: AbstractMesh(
                            (16, 16), ("data", "model")))
    monkeypatch.setattr(PDry, "get_config", lambda a: get_config(a).reduced())
    jmeta, jrows = ref_dryrun.spec_table(arch, mode=mode)
    meta, rows = PDry.print_spec_table(arch, mode=mode)
    assert meta == jmeta
    assert f"== spec table: {arch} (mode={mode}" in capsys.readouterr().out
    want = {r["param"]: r for r in jrows}
    P = len(get_config(arch).reduced().block_pattern)
    met = set()
    for r in rows:
        m = re.match(r"\['layers'\]\[(\d+)\](.*)", r["param"])
        if m is None:
            w = want[r["param"]]
            assert r == {**w, "shape": tuple(w["shape"])}
            met.add(r["param"])
            continue
        key = f"['blocks'][{int(m.group(1)) % P}]{m.group(2)}"
        w = want[key]
        assert tuple(w["shape"][1:]) == r["shape"]
        assert w["axes"] == ("layer",) + r["axes"]
        for k in ("param_spec", "opt_spec"):
            assert entries(w[k]) == (None,) + entries(r[k])
        met.add(key)
    assert met == set(want)


# --------------------------------------------------------------------------- #
# C4's host loop
# --------------------------------------------------------------------------- #
def test_train_and_eval_loop_history_equals_the_references():
    from repro.core import distributed_eval as jde
    from repro_torch.core import distributed_eval as pde

    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 5)).astype(np.float32)
    y = (x @ rng.standard_normal((5, 3))).argmax(-1).astype(np.int32)
    ev, mask = pde.pad_eval_dataset({"x": x[:13], "y": y[:13]}, 4)

    def run(lib, arr, top1):
        def train_step(w, b):
            p = lib.exp(arr(b["x"]) @ w)
            p = p / p.sum(-1)[:, None]
            onehot = arr(np.eye(3, dtype=np.float32)[b["y"]])
            grad = arr(b["x"]).T @ (p - onehot) / b["x"].shape[0]
            return w - 0.5 * grad, {"loss": -(lib.log(p) * onehot).sum()
                                    / b["x"].shape[0]}

        def eval_step(w, b, m):
            return top1(arr(b["x"]) @ w, arr(b["y"]), arr(m))

        def eval_batches():
            for i in range(0, 16, 4):
                yield {k: v[i:i + 4] for k, v in ev.items()}, mask[i:i + 4]

        batches = ({"x": x[i:i + 8], "y": y[i:i + 8]} for i in range(0, 40, 8))
        return (jde if lib is jnp else pde).train_and_eval_loop(
            train_step=train_step, eval_step=eval_step,
            train_state=arr(np.zeros((5, 3), np.float32)),
            train_batches=batches, eval_batches=eval_batches, eval_every=2)

    w, hist = run(torch, torch.from_numpy, pde.masked_top1)
    jw, jhist = run(jnp, jnp.asarray, jde.masked_top1)
    assert [r["step"] for r in hist] == [r["step"] for r in jhist] == [2, 4]
    for a, b in zip(hist, jhist):
        assert a["eval_metric"] == b["eval_metric"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
