"""Spec dispatcher of the port: resolve a :class:`RunSpec` to config,
mesh and subsystem, and run it (``repro.run.dispatch``).

    run_spec(spec, *, device="cuda", params=None) -> result dict
    (always carries "exit_code")

One runner per mode:

  * ``train`` — the hook-based :class:`repro_torch.train.Trainer` over
    synthetic LM batches (the inline stream, or the streaming
    ``Pipeline`` with ``trainer.data.pipeline=async``), optionally
    resuming from a checkpoint;
  * ``eval``  — the distributed eval (C4) alone, on fresh or resumed
    parameters;
  * ``serve`` — the continuous-batching ``serve.Engine`` in an MLPerf-
    Inference scenario, optionally with SLO classes; with
    ``fleet.n_replicas >= 1`` a :class:`repro_torch.fleet.Fleet` of that
    many engines behind the prefix router, with the spec's seeded chaos;
  * ``dryrun`` — a fleet spec renders its Kubernetes manifests
    (``launch.k8s``); otherwise ``launch.dryrun.dryrun_one`` sizes one
    rank's step of one (arch, ``dryrun.shape``), or of every (arch x
    shape) with ``dryrun.all``, on the ``pod`` or ``multipod`` mesh in a
    fake world of this process (an error is a row, and the exit code 1);
    ``dryrun.specs`` prints the sharding-spec tables instead. The dry
    run builds fake CPU tensors whatever ``device`` says and must own
    the process (an open default process group raises).

The ``bench`` mode, ``trainer.bench_out`` and ``dryrun.bench_out`` raise
``NotImplementedError`` naming ROADMAP.md item 6.5.

``device`` (default ``"cuda"``, which raises where no card is) is where
the run happens. ``params`` starts train, eval and serve from a numpy
tree in the reference's names and layout (through the weight bridge,
``lm.params_from_numpy`` or ``encdec.params_from_numpy``) instead of the
family's init from ``spec.seed``, so two dispatchers can run on the same
weights. Meshes: ``single`` is one device, or with a ``serve.serve_mode``
the 1 x 1 mesh of this process; ``pod`` and ``multipod`` are the 16 x 16
and 2 x 16 x 16 meshes, one process a rank over the default process
group (one already up, or one started from the launcher's ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``); rank 0 prints. A
process group that ``run_spec`` started is destroyed before it returns.

``profile`` (a path; ``--profile`` on the CLI) measures the run's
measured part (the scenario after its warm-up, the fleet's run, the fit,
the eval sweep): the kernel wrappers' launch counts, zeroed at its
start, its wall time and, with ``trace`` (``--trace``), a
``torch.profiler`` trace of it, written to the path as one JSON
object.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import time
from typing import Any, Dict, Optional

from repro_torch.run.spec import RunSpec

# Result of the most recent run_spec() in this process — lets in-process
# callers of a CLI entry point (tests, notebooks) reach the structured
# result (history, reports) behind the printed output.
LAST_RESULT: Optional[Dict[str, Any]] = None


def resolve_config(spec: RunSpec):
    """arch -> ModelConfig, after ``reduced()`` and model overrides (in
    that order, so a spec override beats the smoke-variant defaults)."""
    from repro_torch.configs import base as config_base
    from repro_torch.configs import get_config

    cfg = get_config(spec.arch)
    if spec.reduced:
        cfg = cfg.reduced()
    if spec.model:
        cfg = config_base.apply_overrides(cfg, spec.model)
    return cfg


def build_mesh(spec: RunSpec, device="cuda"):
    """The spec's mesh: the 1 x 1 mesh of this process for ``single``,
    else the production mesh over the default process group (started
    from the launcher's environment when none is up); a world size that
    is not the mesh's raises ``ValueError`` before any work."""
    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device
    from repro_torch.launch.mesh import (
        BACKENDS,
        make_mesh,
        production_mesh_shape,
        single_device_mesh,
    )

    if spec.mesh == "single":
        return single_device_mesh(device)
    shape, names = production_mesh_shape(multi_pod=spec.mesh == "multipod")
    need = math.prod(shape)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != need:
        raise ValueError(
            f"--mesh {spec.mesh} is a {' x '.join(map(str, shape))} mesh "
            f"over {names}: it needs {need} ranks, one process each; this "
            f"run has {world}")
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[dev.type], init_method="env://")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return make_mesh(shape, names, device=dev)


def _mesh_of(spec: RunSpec, device):
    """The mesh a run uses, or None for one device (``single`` without a
    serve mode)."""
    serve_mode = spec.mode == "serve" and spec.serve.serve_mode
    if spec.mesh == "single" and not serve_mode:
        return None
    return build_mesh(spec, device)


def _lead(mesh) -> bool:
    return mesh is None or mesh.device_mesh.get_rank() == 0


def _bridge(cfg, params, device, dtype=None):
    """A numpy tree in the reference's layout as the port's parameters
    (the weight bridge of the config's family)."""
    from repro_torch.models import encdec, lm

    bridge = encdec if cfg.is_encdec else lm
    return bridge.params_from_numpy(params, cfg, device=device, dtype=dtype)


def run_spec(spec: RunSpec, *, device="cuda", params=None,
             profile: Optional[str] = None, trace: bool = False
             ) -> Dict[str, Any]:
    global LAST_RESULT
    import torch.distributed as dist

    from repro_torch import resolve_device

    LAST_RESULT = None  # release the previous run's state (Trainer/Engine
    #                     trees are large) before this one allocates
    runner = {
        "train": _run_train,
        "eval": _run_eval,
        "serve": _run_serve,
        "bench": _run_bench,
        "dryrun": _run_dryrun,
    }[spec.mode]
    # the dry run touches no device (fake CPU tensors in a fake world)
    dev = None if spec.mode == "dryrun" else resolve_device(device)
    had_group = dist.is_available() and dist.is_initialized()
    try:
        result = runner(spec, dev, params,
                        functools.partial(_measured, profile, dev, trace))
    finally:
        if not had_group and dist.is_available() and dist.is_initialized():
            # a NCCL group left up hangs the process at exit
            dist.destroy_process_group()
    result.setdefault("exit_code", 0)
    LAST_RESULT = result
    return result


# --------------------------------------------------------------------------- #
# measurement (``profile``)
# --------------------------------------------------------------------------- #
def _kernel_modules():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba as mk
    from repro_torch.kernels import paged_attention as pa

    return pa, fa, mk


def _launch_counts() -> Dict[str, Any]:
    """The launch counts of the language models' kernel wrappers."""
    pa, fa, mk = _kernel_modules()
    return {
        "paged_attention": pa.paged_attention_cuda.launches,
        "paged_attention_by_kind": dict(
            pa.paged_attention_cuda.launches_by_kind),
        "flash_attention_fwd": fa.flash_attention_fwd_cuda.launches,
        "flash_attention_bwd": fa.flash_attention_bwd_cuda.launches,
        "mamba_scan": mk.mamba_scan_cuda.launches,
        "mamba_scan_bwd": mk.mamba_scan_bwd_cuda.launches,
    }


@contextlib.contextmanager
def _measured(profile: Optional[str], device, trace: bool = False):
    """With a ``profile`` path: zero the launch counts, run the block
    (under ``torch.profiler`` with ``trace``), then write {"launches",
    "wall_ms"; with ``trace`` "kernels" (name, count, device ms) and
    "busy_ms"} and what the block put in the yielded dict to the path.
    Without one: nothing."""
    rec: Dict[str, Any] = {}
    if not profile:
        yield rec
        return
    import torch
    from torch.profiler import ProfilerActivity, profile as tracer

    for m in _kernel_modules():
        m.reset_launches()
    cuda = device.type == "cuda"
    prof = (tracer(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])
            if trace else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        yield rec
        if cuda:
            torch.cuda.synchronize()
        rec["wall_ms"] = (time.perf_counter() - t0) * 1e3
    rec["launches"] = _launch_counts()
    if trace:
        kernels = sorted(
            ({"name": e.key, "count": e.count,
              "device_ms": e.self_device_time_total / 1e3}
             for e in prof.key_averages() if e.self_device_time_total > 0),
            key=lambda k: -k["device_ms"])
        rec.update(kernels=kernels,
                   busy_ms=sum(k["device_ms"] for k in kernels))
    with open(profile, "w") as f:
        json.dump(rec, f)


# --------------------------------------------------------------------------- #
# train / eval
# --------------------------------------------------------------------------- #
def _make_trainer(spec: RunSpec, device, params, mesh):
    import torch

    from repro_torch.train import Trainer, TrainerConfig

    t = spec.trainer
    cfg = resolve_config(spec)
    tcfg = TrainerConfig(
        total_steps=t.total_steps,
        eval_every=t.eval_every,
        checkpoint_every=t.checkpoint_every,
        checkpoint_dir=t.checkpoint_dir,
        log_every=t.log_every if _lead(mesh) else 0,
        seed=spec.seed,
        metrics=t.metrics,
        async_checkpoint=t.async_checkpoint,
        double_buffer=t.data.pipeline == "async",
        metrics_out=t.metrics_out,
    )
    if params is not None:  # else the family's init from spec.seed
        params = _bridge(cfg, params, device,
                         getattr(torch, cfg.param_dtype))
    return Trainer(cfg, tcfg, device=device, params=params, mesh=mesh)


def _run_train(spec: RunSpec, device, params, measure) -> Dict[str, Any]:
    import itertools

    from repro_torch.data.pipeline import (
        synthetic_eval_set,
        synthetic_lm_batches,
    )

    t = spec.trainer
    if t.bench_out:
        raise NotImplementedError(
            "trainer.bench_out: the port writes no BENCH_*.json of a "
            "training run yet (ROADMAP.md item 6.5)")
    mesh = _mesh_of(spec, device)
    trainer = _make_trainer(spec, device, params, mesh)
    start = trainer.resume(t.resume) if t.resume else 0
    pipeline = None
    if t.data.pipeline == "async":
        # Streaming pipeline: shard-addressed source (per-shard RNG, so
        # the resume seek below is O(1)) -> optional checksum-verified
        # cache -> background prefetch. A resumed run starts at the
        # stream position its checkpointed steps had consumed, so
        # interrupted + resumed == uninterrupted, step for step.
        from repro_torch.data import Pipeline, SyntheticShardSource

        source = SyntheticShardSource(
            trainer.cfg, batch=t.batch, seq=t.seq,
            n_batches=t.total_steps, shard_size=t.data.shard_size,
            seed=spec.seed,
        )
        pipeline = Pipeline(
            source, cache_dir=t.data.cache_dir or None,
            prefetch_depth=t.data.prefetch_depth, start_batch=start,
            verify_cache=t.data.verify_cache,
        )
        batches = pipeline
    else:
        # One deterministic stream for the whole run: a resumed run skips
        # the batches the checkpointed steps already consumed.
        batches = synthetic_lm_batches(
            trainer.cfg, batch=t.batch, seq=t.seq, steps=t.total_steps,
            seed=spec.seed,
        )
        if start:
            batches = itertools.islice(batches, start, None)
    eval_fn = None
    if t.eval_every:
        eval_fn = synthetic_eval_set(trainer.cfg, batch=t.batch, seq=t.seq)
    hooks = trainer.default_hooks(eval_fn)
    try:
        with measure() as rec:
            history = trainer.fit(batches, eval_fn, hooks=hooks)
            rec["steps"] = len(history)
    finally:
        if pipeline is not None:
            pipeline.close()
    if _lead(mesh):
        print("done", history[-1] if history else "")
    return {"history": history, "trainer": trainer}


def _run_eval(spec: RunSpec, device, params, measure) -> Dict[str, Any]:
    from repro_torch.data.pipeline import synthetic_eval_set

    t = spec.trainer
    mesh = _mesh_of(spec, device)
    trainer = _make_trainer(spec, device, params, mesh)
    if t.resume:
        trainer.resume(t.resume)
    eval_fn = synthetic_eval_set(trainer.cfg, batch=t.batch, seq=t.seq)
    with measure():
        record = trainer.evaluate(eval_fn)
    if _lead(mesh):
        print(f"eval {trainer.cfg.name}"
              f"{' @ step ' + str(trainer.start_step) if t.resume else ''}: "
              f"nll={record['eval_nll']:.4f}")
    return {"eval": record, "trainer": trainer}


# --------------------------------------------------------------------------- #
# serve
# --------------------------------------------------------------------------- #
def serve_config(spec: RunSpec, cfg):
    """The engine's ``ServeConfig`` for a serve spec (a vision
    frontend's media take positions ahead of each prompt)."""
    from repro_torch.serve.engine import ServeConfig

    s, kv = spec.serve, spec.serve.kv
    n_media = cfg.n_media_tokens if cfg.frontend == "vision_patches" else 0
    return ServeConfig(
        max_batch=s.batch if s.max_batch is None else s.max_batch,
        max_len=n_media + s.prompt_len + s.tokens,
        prefill_len=s.prompt_len,
        temperature=s.temperature,
        seed=spec.seed,
        kv_layout=kv.layout,
        page_size=kv.page_size,
        prefill_chunk=kv.prefill_chunk,
        n_pages=kv.n_pages,
        prefix_cache=kv.prefix_cache,
        kv_dtype=kv.dtype,
        spec_decode=kv.spec_decode,
        draft_len=kv.draft_len,
    )


def serve_trace(spec: RunSpec, cfg):
    """The spec's workload: its scenario's seeded trace."""
    from repro_torch.serve.scenarios import make_trace

    s = spec.serve
    return make_trace(
        cfg, scenario=spec.scenario or "offline", n=s.batch,
        tokens=s.tokens, prompt_len=s.prompt_len, seed=spec.seed,
        rate=s.arrival_rate, pattern=s.arrival_pattern,
        query_size=s.query_size, query_interval=s.query_interval,
        slo_classes=s.slo_classes, shared_prefix_len=s.shared_prefix_len,
        n_templates=s.n_templates)


def _run_serve(spec: RunSpec, device, params, measure) -> Dict[str, Any]:
    from repro_torch.dist.sharding import Rules
    from repro_torch.serve.engine import Engine, synthetic_requests
    from repro_torch.serve.scenarios import scenario_driver
    from repro_torch.train.steps import ModelAPI

    s = spec.serve
    scenario = spec.scenario or "offline"
    cfg = resolve_config(spec)
    mesh = _mesh_of(spec, device)
    mode = rules = None
    if mesh is not None:
        mode = s.serve_mode or cfg.param_sharding
        rules = Rules(mesh, mode)
    if params is None:
        params = ModelAPI(cfg).init(cfg, spec.seed, device=device)
    else:
        params = _bridge(cfg, params, device)
    scfg = serve_config(spec, cfg)
    reqs = serve_trace(spec, cfg)
    engines = [Engine(cfg, params, scfg, rules=rules, device=device)
               for _ in range(max(1, spec.fleet.n_replicas))]
    if s.warmup:
        for engine in engines:
            # loads the kernels outside the reported metrics
            scenario_driver("offline")(engine, synthetic_requests(
                cfg, n=min(2, scfg.max_batch), tokens=2,
                prompt_len=s.prompt_len, scenario="offline",
                seed=spec.seed + 1))
    engine = engines[0]
    kv_dtype = engine.cfg.kv_cache_dtype
    kv = engine.layout + (f"/{kv_dtype}" if s.kv.dtype
                          or kv_dtype != cfg.dtype else "")
    if spec.fleet.n_replicas >= 1:
        return _run_fleet(spec, engines, reqs, kv, _lead(mesh), measure)

    with measure() as rec:
        report = scenario_driver(scenario)(engine, reqs)
        rec.update(chunk_steps=len(report.steps), summary=report.summary())
    if not _lead(mesh):
        return {"report": report, "engine": engine}
    on = "" if mode is None else f"mode={mode}, "
    print(f"{spec.arch} [{scenario}, {on}device={device}, "
          f"slots={scfg.max_batch}, kv={kv}]: {report.format()}")
    if report.prefix_hit_rate is not None:
        print(f"  prefix cache: hit_rate {report.prefix_hit_rate:.3f}, "
              f"{report.pages_shared} pages shared, "
              f"{report.prefill_tokens_skipped} prefill tokens skipped, "
              f"{report.cow_copies} cow copies")
    if report.spec_accept_rate is not None:
        print(f"  speculative: accept_rate {report.spec_accept_rate:.3f}, "
              f"{report.draft_tokens} draft tokens proposed")
    if s.slo_classes:
        print(f"  slo: goodput {report.slo_goodput:.3f}, "
              f"{report.slo_violations} violation(s)")
        for name, m in sorted(report.per_class().items()):
            print(f"    {name}: n={m['requests']} p99 {m['p99_ms']:.1f}ms "
                  f"ttft_p99 {m['ttft_p99_ms']:.1f}ms violations "
                  f"{m['violations']} goodput {m['goodput']:.3f}")
    for req in sorted(report.requests, key=lambda r: r.id):
        print(f"  req {req.id}: prompt {req.prompt_len} -> "
              f"{len(req.tokens)} tokens {req.tokens}")
    return {"report": report, "engine": engine}


def _run_fleet(spec: RunSpec, engines, reqs, kv: str, lead: bool,
               measure) -> Dict[str, Any]:
    """The serve workload over ``fleet.n_replicas`` engines behind the
    prefix router (arrivals on the fleet's step clock), with the spec's
    seeded chaos plan, if any, injected mid-run."""
    from repro_torch.fleet import ChaosPlan, Fleet, FleetConfig

    f = spec.fleet
    chaos = ChaosPlan.from_spec(
        f.chaos, chaos_step=f.chaos_step, stall_steps=f.stall_steps,
        seed=spec.seed)
    fleet = Fleet(engines, FleetConfig(
        routing=f.routing, heartbeat_timeout=f.heartbeat_timeout), chaos)
    with measure() as rec:
        report = fleet.run(reqs)
        rec.update(chunk_steps=sum(len(r.steps) for r in
                                   report.replica_reports.values()),
                   summary=report.summary())
    if not lead:
        return {"report": report, "fleet": fleet}
    print(f"{spec.arch} [fleet x{f.n_replicas}, routing={f.routing}"
          f"{', chaos=' + f.chaos if f.chaos else ''}, "
          f"slots={engines[0].scfg.max_batch}/replica, kv={kv}]: "
          f"{report.format()}")
    if spec.serve.slo_classes:
        for name, m in sorted(report.per_class().items()):
            print(f"    {name}: n={m['requests']} p99 {m['p99_ms']:.1f}ms "
                  f"violations {m['violations']} goodput {m['goodput']:.3f}")
    for req in sorted(report.merged.requests, key=lambda r: r.id):
        print(f"  req {req.id}: prompt {req.prompt_len} -> "
              f"{len(req.tokens)} tokens {req.tokens}")
    return {"report": report, "fleet": fleet}


# --------------------------------------------------------------------------- #
# bench / dryrun
# --------------------------------------------------------------------------- #
def _run_bench(spec: RunSpec, device, params, measure) -> Dict[str, Any]:
    raise NotImplementedError(
        "--mode bench: the port has no benchmark suite yet "
        "(ROADMAP.md item 6.5)")


def _run_dryrun(spec: RunSpec, device, params, measure) -> Dict[str, Any]:
    if spec.fleet.n_replicas >= 1:
        # A fleet dryrun renders Kubernetes manifests (pure dicts, no
        # cluster): the deploy-side twin of the serve-mode fleet.
        from repro_torch.launch import k8s

        text = k8s.render(spec)
        if spec.fleet.k8s_out:
            with open(spec.fleet.k8s_out, "w") as fh:
                fh.write(text)
            print(f"k8s manifests ({spec.fleet.n_replicas} replica(s)) "
                  f"-> {spec.fleet.k8s_out}")
        else:
            print(text, end="")
        return {"manifests": k8s.render_manifests(spec), "yaml": text}

    from repro_torch.configs import INPUT_SHAPES, list_archs
    from repro_torch.launch import dryrun as D

    d = spec.dryrun
    if d.bench_out:
        raise NotImplementedError(
            "dryrun.bench_out: the port writes no BENCH_*.json of a dry run "
            "yet (ROADMAP.md item 6.5)")
    multi_pod = spec.mesh == "multipod"
    archs = list_archs() if d.all else [spec.arch]
    if d.specs:
        tables = []
        for arch in archs:
            meta, rows = D.print_spec_table(
                arch, multi_pod=multi_pod,
                mode=os.environ.get("REPRO_SERVE_MODE"))
            tables.append({**meta, "rows": [
                {**r, "shape": list(r["shape"]), "axes": list(r["axes"])}
                for r in rows
            ]})
            print()
        if d.json_out:
            with open(d.json_out, "w") as f:
                json.dump(tables, f, indent=1)
        return {"tables": tables}

    results = []
    if d.all:
        for arch in archs:
            for shape in INPUT_SHAPES:
                try:
                    results.append(
                        D.dryrun_one(arch, shape, multi_pod=multi_pod))
                except Exception as e:  # noqa: BLE001 (a row, not a crash)
                    print(f"FAILED {arch} x {shape}: {type(e).__name__}: {e}")
                    results.append({"arch": arch, "shape": shape,
                                    "multi_pod": multi_pod,
                                    "error": str(e)[:500]})
    else:
        results.append(D.dryrun_one(spec.arch, d.shape, multi_pod=multi_pod))
    if d.json_out:
        with open(d.json_out, "w") as f:
            json.dump(results, f, indent=1)
    ok = sum(1 for r in results if "error" not in r)
    print(f"\n{ok}/{len(results)} dry-runs succeeded")
    return {"results": results, "exit_code": 0 if ok == len(results) else 1}
