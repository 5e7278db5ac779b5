"""Declarative run specification: one frozen dataclass per experiment
(the port's copy of ``repro.run.spec``; ``to_dict`` gives the
reference's dict for the same spec, key for key).

A :class:`RunSpec` is the single description every entry point resolves
through (``python -m repro_torch run``, the launcher shims, spec files
under ``runs/``): *which* architecture, *which* mode
(``train|eval|serve|bench|dryrun``), *which* mesh, plus nested
per-subsystem sections. Specs are data — ``to_dict``/``from_dict``
round-trip losslessly, so a run is reproducible from a committed JSON or
TOML file plus ``--set`` overrides (see ``run.overrides``).

``model`` holds *pending* ``ModelConfig`` overrides as a dotted-key dict
(``{"param_sharding": "wus"}``); they are validated/coerced against the
config dataclass at spec-build time and applied at dispatch time, after
``reduced()``, so a spec override always wins over the smoke-variant
defaults. The spec has no device: that is an argument of
``run.dispatch.run_spec`` (``--device`` on the CLI).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, Optional, Tuple

from repro_torch.configs import base as config_base
from repro_torch.run.overrides import (
    SpecError,
    coerce_value,
    did_you_mean,
    normalize_model_overrides,
)

MODES = ("train", "eval", "serve", "bench", "dryrun")
MESHES = ("single", "pod", "multipod")
# The four MLPerf-Inference scenarios; mirrors serve.scenarios.SCENARIOS.
# The tuples below that mirror other modules are kept literal so spec
# parsing imports no torch; tests/test_torch_run.py asserts they agree.
SCENARIOS = ("", "offline", "server", "single_stream", "multi_stream")
# Mirrors serve.scenarios.ARRIVAL_PATTERNS / serve.slo.CLASSES keys.
ARRIVAL_PATTERNS = ("poisson", "bursty", "diurnal")
SLO_CLASSES = ("interactive", "standard", "batch")
# Mirrors train.steps.EXTRA_METRICS.
TRAIN_METRICS = ("grad_norm", "param_norm")
PIPELINES = ("sync", "async")


@dataclass(frozen=True)
class DataSection:
    """The ``trainer.data`` sub-section: input-pipeline mode and shard
    geometry (``--set trainer.data.pipeline=async``).

    ``sync`` (default) keeps the inline generator feed; ``async`` runs
    the streaming :class:`repro_torch.data.Pipeline` — shard-addressed
    source, optional checksum-verified on-disk cache, background prefetch,
    and the trainer's double buffer so the step never waits on H2D.
    """

    pipeline: str = "sync"      # sync | async
    prefetch_depth: int = 2     # async: batches buffered ahead of the step
    shard_size: int = 8         # async: batches per source shard
    cache_dir: str = ""         # async: on-disk shard cache ('' = off)
    verify_cache: bool = True   # async: checksum-verify the cache ledger

    def __post_init__(self):
        if self.pipeline not in PIPELINES:
            raise SpecError(
                f"trainer.data.pipeline must be one of {PIPELINES}, got "
                f"{self.pipeline!r}"
                + did_you_mean(self.pipeline, PIPELINES))
        if self.prefetch_depth < 1:
            raise SpecError("trainer.data.prefetch_depth must be >= 1")
        if self.shard_size < 1:
            raise SpecError("trainer.data.shard_size must be >= 1")


@dataclass(frozen=True)
class TrainerSection:
    """Train/eval-mode knobs (mirrors ``train.TrainerConfig`` + data)."""

    total_steps: int = 30
    batch: int = 8
    seq: int = 64
    eval_every: int = 0
    checkpoint_every: int = 0
    checkpoint_dir: str = "/tmp/repro_ckpt"
    log_every: int = 10
    resume: str = ""            # checkpoint dir (root or step_N) to resume
    metrics: Tuple[str, ...] = ()  # extra per-step metrics, e.g. grad_norm
    bench_out: str = ""         # write a BENCH_*.json of this training run
    async_checkpoint: bool = False  # non-blocking background ckpt writer
    metrics_out: str = ""       # stream every fit record to this JSONL file
    data: DataSection = field(default_factory=DataSection)

    def __post_init__(self):
        for m in self.metrics:
            if m not in TRAIN_METRICS:
                raise SpecError(
                    f"trainer.metrics: unknown metric {m!r}; known: "
                    f"{TRAIN_METRICS}" + did_you_mean(m, TRAIN_METRICS)
                )


KV_LAYOUTS = ("auto", "slab", "paged")  # mirrors serve.engine.KV_LAYOUTS
# Mirrors serve.engine.ServeConfig ('' -> inherit the model config dtype).
KV_DTYPES = ("", "bfloat16", "float32", "int8", "int4")
SPEC_DECODE_MODES = ("off", "ngram")  # mirrors serve.speculative.get_drafter


@dataclass(frozen=True)
class KVCacheSpec:
    """The ``serve.kv`` sub-section: KV-cache geometry, storage dtype and
    speculative decoding, as one typed unit (``--set serve.kv.page_size=32``).

    Folds the flat serve keys the KV subsystem had accreted
    (``serve.kv_layout``, ``serve.page_size``, ...) into a nested
    dataclass; the old flat spellings still load through deprecation
    shims (:attr:`ServeSection.LEGACY_KEYS`) that warn and forward.
    """

    layout: str = "auto"        # auto | slab | paged (auto: paged when the
    #                             stack is attention-only, slab otherwise)
    page_size: int = 16         # paged: tokens per KV page
    prefill_chunk: int = 8      # paged: prompt tokens fed per chunk step
    n_pages: Optional[int] = None  # paged pool size; None -> slab parity
    prefix_cache: bool = False  # paged: cross-request KV prefix sharing
    dtype: str = ""             # '' -> model cfg dtype; bfloat16|float32|
    #                             int8|int4 (quantized paged pools)
    spec_decode: str = "off"    # off | ngram (self-speculative drafting)
    draft_len: int = 4          # spec decode: draft tokens proposed per row

    def __post_init__(self):
        if self.layout not in KV_LAYOUTS:
            raise SpecError(
                f"serve.kv.layout must be one of {KV_LAYOUTS}, got "
                f"{self.layout!r}" + did_you_mean(self.layout, KV_LAYOUTS))
        if self.page_size < 1 or self.prefill_chunk < 1:
            raise SpecError(
                "serve.kv.page_size and serve.kv.prefill_chunk must be >= 1")
        if self.n_pages is not None and self.n_pages < 1:
            raise SpecError("serve.kv.n_pages must be >= 1")
        if self.prefix_cache and self.layout == "slab":
            raise SpecError(
                "serve.kv.prefix_cache shares paged-pool pages; it cannot "
                "run with serve.kv.layout='slab'")
        if self.dtype not in KV_DTYPES:
            raise SpecError(
                f"serve.kv.dtype must be one of {KV_DTYPES}, got "
                f"{self.dtype!r}" + did_you_mean(self.dtype, KV_DTYPES))
        if self.spec_decode not in SPEC_DECODE_MODES:
            raise SpecError(
                f"serve.kv.spec_decode must be one of {SPEC_DECODE_MODES}, "
                f"got {self.spec_decode!r}"
                + did_you_mean(self.spec_decode, SPEC_DECODE_MODES))
        if self.draft_len < 1:
            raise SpecError("serve.kv.draft_len must be >= 1")
        if self.spec_decode != "off" and self.draft_len >= self.prefill_chunk:
            raise SpecError(
                "serve.kv.draft_len + 1 verified tokens must fit one chunk "
                f"step: need draft_len < prefill_chunk, got "
                f"{self.draft_len} >= {self.prefill_chunk}")


@dataclass(frozen=True)
class ServeSection:
    """Serve-mode knobs (mirrors the ``serve.Engine`` workload surface)."""

    # Old flat KV keys -> their home in the nested ``kv`` sub-section.
    # from_dict and --set accept them with a DeprecationWarning; to_dict
    # always emits the nested form.
    LEGACY_KEYS: ClassVar[Dict[str, str]] = {
        "kv_layout": "kv.layout",
        "page_size": "kv.page_size",
        "prefill_chunk": "kv.prefill_chunk",
        "n_pages": "kv.n_pages",
        "prefix_cache": "kv.prefix_cache",
        "kv_dtype": "kv.dtype",
        "spec_decode": "kv.spec_decode",
        "draft_len": "kv.draft_len",
    }

    tokens: int = 16
    batch: int = 4
    max_batch: Optional[int] = None  # None -> batch (one slot per request)
    prompt_len: int = 16
    temperature: float = 0.0
    serve_mode: str = ""        # '' -> cfg.param_sharding; tp2d|fsdp|wus|...
    warmup: bool = True         # a short run first, so metrics exclude
    #                             the kernels' first load
    kv: KVCacheSpec = field(default_factory=KVCacheSpec)
    shared_prefix_len: int = 0  # workload: template prefix tokens (0 off)
    n_templates: int = 1        # workload: distinct shared templates
    arrival_rate: float = 0.5   # server: mean requests per engine step
    arrival_pattern: str = "poisson"  # server: poisson|bursty|diurnal
    query_size: int = 2         # multi_stream: requests per query burst
    query_interval: int = 8     # multi_stream: steps between query bursts
    slo_classes: Tuple[str, ...] = ()  # cycle requests through SLO classes

    def __post_init__(self):
        if self.arrival_rate <= 0:
            raise SpecError("serve.arrival_rate must be > 0")
        if self.arrival_pattern not in ARRIVAL_PATTERNS:
            raise SpecError(
                f"serve.arrival_pattern must be one of {ARRIVAL_PATTERNS}, "
                f"got {self.arrival_pattern!r}"
                + did_you_mean(self.arrival_pattern, ARRIVAL_PATTERNS))
        if self.query_size < 1 or self.query_interval < 1:
            raise SpecError(
                "serve.query_size and serve.query_interval must be >= 1")
        for c in self.slo_classes:
            if c not in SLO_CLASSES:
                raise SpecError(
                    f"serve.slo_classes: unknown class {c!r}; known: "
                    f"{SLO_CLASSES}" + did_you_mean(c, SLO_CLASSES))
        if self.shared_prefix_len < 0 or self.n_templates < 1:
            raise SpecError(
                "serve.shared_prefix_len must be >= 0 and "
                "serve.n_templates >= 1")


# Mirrors fleet.router.ROUTING_POLICIES / fleet.chaos.CHAOS_MODES.
ROUTING_POLICIES = ("prefix", "least_loaded")
CHAOS_MODES = ("", "kill", "stall")


@dataclass(frozen=True)
class FleetSection:
    """Multi-replica serving knobs (``repro_torch.fleet``; ``--set fleet.*``).

    ``n_replicas=0`` keeps the single-engine serve path; ``>= 1`` runs
    the workload through a :class:`repro_torch.fleet.Fleet` of that many
    identical engines behind the prefix-affinity router. ``chaos``
    injects one seeded fault mid-run (the chaos-failover conformance
    knob). In ``dryrun`` mode a fleet spec renders Kubernetes manifests
    (``launch.k8s``).
    """

    n_replicas: int = 0          # 0 = fleet layer off (single engine)
    routing: str = "prefix"      # prefix | least_loaded
    chaos: str = ""              # '' | kill | stall (one seeded fault)
    chaos_step: int = 8          # fleet step at which the fault fires
    stall_steps: int = 12        # stall: fleet steps the victim freezes
    heartbeat_timeout: int = 4   # missed beats before a replica is dead
    k8s_out: str = ""            # dryrun: write rendered manifests here
    image: str = "repro:latest"  # k8s: container image for serve pods
    port: int = 8000             # k8s: router service port

    def __post_init__(self):
        if self.n_replicas < 0:
            raise SpecError("fleet.n_replicas must be >= 0")
        if self.routing not in ROUTING_POLICIES:
            raise SpecError(
                f"fleet.routing must be one of {ROUTING_POLICIES}, got "
                f"{self.routing!r}"
                + did_you_mean(self.routing, ROUTING_POLICIES))
        if self.chaos not in CHAOS_MODES:
            raise SpecError(
                f"fleet.chaos must be one of {CHAOS_MODES}, got "
                f"{self.chaos!r}" + did_you_mean(self.chaos, CHAOS_MODES))
        if self.chaos_step < 0:
            raise SpecError("fleet.chaos_step must be >= 0")
        if self.stall_steps < 1 or self.heartbeat_timeout < 1:
            raise SpecError(
                "fleet.stall_steps and fleet.heartbeat_timeout must be >= 1")
        if not 1 <= self.port <= 65535:
            raise SpecError("fleet.port must be in [1, 65535]")


@dataclass(frozen=True)
class BenchSection:
    """Bench-mode knobs (mirrors ``repro.bench.run``; the port's bench
    mode is ROADMAP.md item 6.5)."""

    smoke: bool = False
    only: Tuple[str, ...] = ()
    out: str = ""               # '' -> BENCH_<tag>.json
    tag: str = "run"
    warmup: Optional[int] = None  # None -> profile default
    iters: Optional[int] = None
    quiet: bool = False


@dataclass(frozen=True)
class DryrunSection:
    """Dryrun-mode knobs (mirrors ``repro.launch.dryrun``)."""

    shape: str = "train_4k"
    all: bool = False           # every (arch x shape) instead of one
    specs: bool = False         # print sharding-spec tables, no trace
    json_out: str = ""
    bench_out: str = ""
    bench_tag: str = "dryrun"


@dataclass(frozen=True)
class RunSpec:
    arch: str = "gemma-7b"
    mode: str = "train"
    mesh: str = "single"
    scenario: str = ""          # serve: offline|server|single_stream|
    #                             multi_stream ('' -> offline)
    reduced: bool = True
    seed: int = 0
    model: Dict[str, Any] = field(default_factory=dict)
    trainer: TrainerSection = field(default_factory=TrainerSection)
    serve: ServeSection = field(default_factory=ServeSection)
    fleet: FleetSection = field(default_factory=FleetSection)
    bench: BenchSection = field(default_factory=BenchSection)
    dryrun: DryrunSection = field(default_factory=DryrunSection)

    def __post_init__(self):
        if self.mode not in MODES:
            raise SpecError(
                f"mode must be one of {MODES}, got {self.mode!r}"
                + did_you_mean(self.mode, MODES)
            )
        if self.mode == "dryrun" and self.mesh == "single":
            # The dry-run only exists on the production meshes; normalize
            # here so a spec's to_dict() faithfully records the pod mesh
            # the run will actually use.
            object.__setattr__(self, "mesh", "pod")
        if self.mesh not in MESHES:
            raise SpecError(
                f"mesh must be one of {MESHES}, got {self.mesh!r}"
                + did_you_mean(self.mesh, MESHES)
            )
        if self.scenario not in SCENARIOS:
            raise SpecError(
                f"scenario must be one of {SCENARIOS[1:]}, got "
                f"{self.scenario!r}" + did_you_mean(self.scenario, SCENARIOS)
            )

    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict[str, Any]:
        """JSON-serializable dict (tuples become lists)."""
        def conv(v):
            if dataclasses.is_dataclass(v) and not isinstance(v, type):
                return {f.name: conv(getattr(v, f.name))
                        for f in dataclasses.fields(v)}
            if isinstance(v, tuple):
                return [conv(x) for x in v]
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            return v

        return conv(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunSpec":
        """Build a spec from a dict, rejecting unknown keys with
        did-you-mean suggestions and coercing values to field types."""
        if not isinstance(d, dict):
            raise SpecError(f"run spec must be an object, got {type(d).__name__}")
        fields = config_base.resolved_field_types(cls)
        kwargs: Dict[str, Any] = {}
        for key, value in d.items():
            if key not in fields:
                raise SpecError(
                    f"run spec has no field {key!r}"
                    + did_you_mean(key, fields)
                )
            typ = fields[key]
            if key == "model":
                if not isinstance(value, dict):
                    raise SpecError("model must be an object of overrides")
                kwargs[key] = normalize_model_overrides(value)
            elif dataclasses.is_dataclass(typ):
                kwargs[key] = _section_from_dict(typ, value, where=key)
            else:
                kwargs[key] = coerce_value(value, typ, where=key)
        return cls(**kwargs)


def _section_from_dict(section_cls, d, *, where: str):
    if not isinstance(d, dict):
        raise SpecError(f"{where} must be an object")
    fields = config_base.resolved_field_types(section_cls)
    legacy = getattr(section_cls, "LEGACY_KEYS", {})
    d = dict(d)
    for key in [k for k in d if k in legacy]:
        target = legacy[key]
        warnings.warn(
            f"{where}.{key} is deprecated; use {where}.{target}",
            DeprecationWarning, stacklevel=3)
        sub, _, leaf = target.partition(".")
        value = d.pop(key)
        nested = d.get(sub, {})
        if not isinstance(nested, dict):
            raise SpecError(f"{where}.{sub} must be an object")
        nested = dict(nested)
        # an explicit nested key beats its deprecated flat spelling
        nested.setdefault(leaf, value)
        d[sub] = nested
    kwargs = {}
    for key, value in d.items():
        if key not in fields:
            raise SpecError(
                f"{where} has no field {key!r}" + did_you_mean(key, fields)
            )
        typ = fields[key]
        if dataclasses.is_dataclass(typ):
            kwargs[key] = _section_from_dict(typ, value, where=f"{where}.{key}")
        else:
            kwargs[key] = coerce_value(value, typ, where=f"{where}.{key}")
    return section_cls(**kwargs)
