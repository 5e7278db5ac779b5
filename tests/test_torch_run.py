"""The port's run layer (``repro_torch.run``) against the reference's
(``repro.run``), as pure Python, no model run: every committed spec file
under ``runs/`` loads to the reference's ``RunSpec.to_dict()`` and
round-trips; the ``--set`` grammar, the spec sections' validation, the
legacy flat kv keys and the spec-file parsers accept and reject what the
reference's do, with its messages word for word (the cases of
``tests/test_run.py``); model overrides resolve, after ``reduced()``, to
the reference's config fields for every arch; the CLI builds the
reference's spec from the same arguments and exits with its codes; and
the literal tuples the spec mirrors agree with the port's modules.
"""
import dataclasses
import json
import os
import warnings

import pytest

pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro import run as J  # noqa: E402
from repro.run import cli as jcli  # noqa: E402
from repro.run import dispatch as jdispatch  # noqa: E402
from repro.run import spec as jspec  # noqa: E402
from repro.run import specfile as jspecfile  # noqa: E402
from repro_torch import run as P  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.run import cli as pcli  # noqa: E402
from repro_torch.run import dispatch as pdispatch  # noqa: E402
from repro_torch.run import spec as pspec  # noqa: E402
from repro_torch.run import specfile as pspecfile  # noqa: E402

RUNS_DIR = os.path.join(os.path.dirname(__file__), "..", "runs")
SPEC_FILES = sorted(os.listdir(RUNS_DIR))


def same_error(port_fn, ref_fn, exc=None):
    """Both raise, the port's error of the reference's type name (or
    ``exc``) and with its message; returns the message."""
    with pytest.raises(Exception) as want:
        ref_fn()
    with pytest.raises(Exception) as got:
        port_fn()
    assert type(got.value).__name__ == type(want.value).__name__
    if exc is not None:
        assert isinstance(got.value, exc)
    assert str(got.value) == str(want.value)
    return str(got.value)


def both(fn):
    """fn(package) for the port and the reference: (port's, reference's)."""
    return fn(P), fn(J)


# --------------------------------------------------------------------------- #
# Spec files and round-trips.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", SPEC_FILES)
def test_committed_spec_loads_to_the_references_dict(name):
    path = os.path.join(RUNS_DIR, name)
    got, want = both(lambda pkg: pkg.load_spec_file(path))
    assert got.to_dict() == want.to_dict()
    assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    assert P.RunSpec.from_dict(got.to_dict()) == got
    assert P.RunSpec.from_dict(json.loads(json.dumps(got.to_dict()))) == got
    assert dataclasses.asdict(P.resolve_config(got)) == \
        dataclasses.asdict(J.resolve_config(want))


@pytest.mark.parametrize("i,arch", list(enumerate(list_archs())))
def test_roundtrip_all_archs(i, arch):
    """from_dict(to_dict(spec)) is the identity, and the dict is the
    reference's, with non-default nested sections and model overrides."""
    def make(pkg):
        return pkg.RunSpec(
            arch=arch,
            mode=("train", "serve", "eval", "bench", "dryrun")[i % 5],
            mesh=("single", "pod", "multipod")[i % 3],
            seed=i,
            model={"param_sharding": "wus", "microbatches": 2},
            trainer=pkg.TrainerSection(total_steps=10 + i,
                                       metrics=("grad_norm",)),
            serve=pkg.ServeSection(max_batch=2 + i, temperature=0.5),
        )

    got, want = both(make)
    assert got.to_dict() == want.to_dict()
    assert P.RunSpec.from_dict(got.to_dict()) == got
    assert P.RunSpec.from_dict(json.loads(json.dumps(got.to_dict()))) == got
    d = P.RunSpec(trainer=P.TrainerSection(metrics=("grad_norm",))).to_dict()
    assert d["trainer"]["metrics"] == ["grad_norm"]
    assert isinstance(d["reduced"], bool)


@pytest.mark.parametrize("bad", [
    {"trianer": {}},
    {"trainer": {"total_stepz": 5}},
    {"trainer": {"total_steps": "many"}},
    {"mode": "trian"},
    {"model": {"param_shard": "wus"}},
    {"serve": []},
    {"model": []},
    {"mesh": "pdo"},
    {"scenario": "sever"},
    {"trainer": {"data": {"pipeline": "asnyc"}}},
    {"fleet": {"routing": "random"}},
    {"serve": {"kv": 3}},
    {"serve": {"page_size": 4, "kv": []}},
    [],
])
def test_from_dict_rejects_bad_keys_and_values(bad):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        same_error(lambda: P.RunSpec.from_dict(bad),
                   lambda: J.RunSpec.from_dict(bad), P.SpecError)


# --------------------------------------------------------------------------- #
# --set grammar.
# --------------------------------------------------------------------------- #
def test_set_grammar_typed_coercion():
    sets = ["trainer.total_steps=50", "serve.max_batch=8",
            "serve.temperature=0.75", "model.param_sharding=wus",
            "model.sliding_window=none",
            "trainer.metrics=grad_norm, param_norm",
            "bench.only= gradsum_2d ,roofline", "reduced=false", "seed=3",
            "serve.kv.layout=paged", "serve.kv.page_size=4",
            "serve.kv.n_pages=12", "serve.kv.dtype=int8",
            "serve.kv.spec_decode=ngram", "serve.kv.draft_len=3",
            "trainer.data.pipeline=async", "fleet.n_replicas=2",
            "model.moe.top_k=1", "dryrun.specs=yes"]
    got, want = both(lambda pkg: pkg.apply_assignments(pkg.RunSpec(), sets))
    assert got.to_dict() == want.to_dict()
    assert got.model == {"param_sharding": "wus", "sliding_window": None,
                         "moe.top_k": 1}
    assert got.trainer.metrics == ("grad_norm", "param_norm")
    assert P.RunSpec.from_dict(got.to_dict()) == got


@pytest.mark.parametrize("assignment", [
    "trainer.total_steps=abc",
    "trainer.total_steps=true",
    "reduced=maybe",
    "serve.temperature=hot",
    "trianer.total_steps=5",
    "trainer.total_stepz=5",
    "model.param_shard=wus",
    "model=wus",
    "trainer=5",
    "seed.x=1",
    "no_equals",
    "=5",
    "serve.kv=paged",
    "serve.kv.laout=paged",
    "serve.kv.page_size=zz",
    "serve.kv.page_size.x=1",
    "serve.kv.dtype=fp8",
    "serve.kv.spec_decode=medusa",
    "serve.kv_layout.x=1",
    "trainer.metrics=grad_nrm",
    "serve.slo_classes=interactiv",
    "mode=trian",
    "fleet.chaos=boom",
    "fleet.port=0",
    "serve.arrival_rate=0",
    "serve.temperature=true",
])
def test_set_grammar_rejects(assignment):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        same_error(lambda: P.apply_assignments(P.RunSpec(), [assignment]),
                   lambda: J.apply_assignments(J.RunSpec(), [assignment]),
                   P.SpecError)


@pytest.mark.parametrize("flat", sorted(pspec.ServeSection.LEGACY_KEYS))
def test_legacy_flat_kv_keys_warn_and_forward(flat):
    """A flat serve key warns as the reference's does and lands on its
    nested field, through --set and through a spec file's dict."""
    value = {"kv_layout": "paged", "page_size": "4", "prefill_chunk": "6",
             "n_pages": "8", "prefix_cache": "true", "kv_dtype": "int8",
             "spec_decode": "ngram", "draft_len": "3"}[flat]
    out = []
    for pkg in (P, J):
        with pytest.warns(DeprecationWarning) as rec:
            a = pkg.apply_assignments(pkg.RunSpec(mode="serve"),
                                      [f"serve.{flat}={value}"])
        with pytest.warns(DeprecationWarning) as rec2:
            b = pkg.RunSpec.from_dict({"mode": "serve",
                                       "serve": {flat: value}})
        out.append((a.to_dict(), b.to_dict(),
                    [str(w.message) for w in rec],
                    [str(w.message) for w in rec2]))
    assert out[0] == out[1]
    assert pspec.ServeSection.LEGACY_KEYS == jspec.ServeSection.LEGACY_KEYS
    # an explicit nested key beats its deprecated flat twin
    with pytest.warns(DeprecationWarning):
        s = P.RunSpec.from_dict({"mode": "serve", "serve": {
            "page_size": 4, "kv": {"page_size": 16}}})
    assert s.serve.kv.page_size == 16
    assert not set(pspec.ServeSection.LEGACY_KEYS) & set(
        P.RunSpec(mode="serve").to_dict()["serve"])


@pytest.mark.parametrize("section,kwargs", [
    ("KVCacheSpec", dict(layout="ragged")),
    ("KVCacheSpec", dict(draft_len=0)),
    ("KVCacheSpec", dict(spec_decode="ngram", draft_len=8, prefill_chunk=8)),
    ("KVCacheSpec", dict(n_pages=0)),
    ("KVCacheSpec", dict(page_size=0)),
    ("KVCacheSpec", dict(prefix_cache=True, layout="slab")),
    ("DataSection", dict(pipeline="stream")),
    ("DataSection", dict(prefetch_depth=0)),
    ("DataSection", dict(shard_size=0)),
    ("TrainerSection", dict(metrics=("lr",))),
    ("ServeSection", dict(arrival_pattern="burst")),
    ("ServeSection", dict(query_size=0)),
    ("ServeSection", dict(shared_prefix_len=-1)),
    ("FleetSection", dict(n_replicas=-1)),
    ("FleetSection", dict(chaos_step=-1)),
    ("FleetSection", dict(stall_steps=0)),
    ("FleetSection", dict(port=70000)),
    ("RunSpec", dict(mesh="pods")),
    ("RunSpec", dict(scenario="batch")),
])
def test_section_validation(section, kwargs):
    same_error(lambda: getattr(pspec, section)(**kwargs),
               lambda: getattr(jspec, section)(**kwargs), P.SpecError)


def test_dryrun_spec_normalizes_single_mesh_to_pod():
    assert P.RunSpec(mode="dryrun").mesh == "pod"
    assert P.RunSpec(mode="dryrun", mesh="multipod").mesh == "multipod"
    assert P.RunSpec(mode="dryrun").to_dict() == \
        J.RunSpec(mode="dryrun").to_dict()


def test_mirrored_literals_match_the_ports_modules():
    """The spec keeps literal copies (so parsing imports no torch); they
    must equal the port's modules and the reference's spec."""
    from repro_torch.fleet import CHAOS_MODES, ROUTING_POLICIES
    from repro_torch.serve import engine, scenarios, slo, speculative
    from repro_torch.train.steps import EXTRA_METRICS

    assert pspec.SCENARIOS == ("",) + scenarios.SCENARIOS
    assert pspec.ARRIVAL_PATTERNS == scenarios.ARRIVAL_PATTERNS
    assert pspec.SLO_CLASSES == tuple(slo.CLASSES)
    assert pspec.TRAIN_METRICS == EXTRA_METRICS
    assert pspec.KV_LAYOUTS == engine.KV_LAYOUTS
    assert pspec.KV_DTYPES == engine.KV_DTYPES
    assert [speculative.get_drafter(m) is not None
            for m in pspec.SPEC_DECODE_MODES] == [False, True]
    with pytest.raises(ValueError):
        speculative.get_drafter("medusa")
    assert pspec.ROUTING_POLICIES == ROUTING_POLICIES
    assert pspec.CHAOS_MODES == CHAOS_MODES
    for name in ("MODES", "MESHES", "SCENARIOS", "ARRIVAL_PATTERNS",
                 "SLO_CLASSES", "TRAIN_METRICS", "PIPELINES", "KV_LAYOUTS",
                 "KV_DTYPES", "SPEC_DECODE_MODES", "ROUTING_POLICIES",
                 "CHAOS_MODES"):
        assert getattr(pspec, name) == getattr(jspec, name), name


# --------------------------------------------------------------------------- #
# Model overrides (applied after reduced()).
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,sets", [
    ("gemma-7b", ["model.param_sharding=wus"]),
    ("gemma-7b", ["model.n_heads=2"]),
    ("gemma-7b", ["model.d_model=128"]),
    ("gemma-7b", ["model.n_heads=2", "model.head_dim=32"]),
    ("gemma-7b", ["reduced=false", "model.n_heads=8"]),
    ("gemma-7b", ["reduced=false", "model.n_layers=8"]),
    ("gemma-7b", ["model.dtype=float32", "model.kv_cache_dtype=float32"]),
    ("mixtral-8x7b", ["model.moe.top_k=1"]),
    ("yi-9b", ["model.seq_parallel=false", "model.param_sharding=fsdp"]),
    ("jamba-1.5-large-398b", ["model.n_layers=4"]),
    ("gemma-7b", ["model.moe.top_k=1"]),
    ("rwkv6-3b", ["model.rwkv6.head_dim=16"]),
])
def test_model_overrides_resolve_to_the_references_config(arch, sets):
    def resolve(pkg):
        return lambda: pkg.resolve_config(pkg.apply_assignments(
            pkg.RunSpec(arch=arch), sets))

    try:
        want = resolve(J)()
    except ValueError:
        same_error(resolve(P), resolve(J), ValueError)
        return
    got = resolve(P)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if sets == ["model.param_sharding=wus"]:
        assert got.name == "gemma-7b-smoke" and got.param_sharding == "wus"


@pytest.mark.parametrize("arch", list_archs())
def test_apply_overrides_gives_the_references_fields(arch):
    """``configs.base.apply_overrides`` on every arch, full and reduced:
    the reference's fields, and its errors."""
    from repro.configs import base as jbase

    assert pbase.override_paths(type(get_config(arch))) == \
        jbase.override_paths(type(jax_get_config(arch)))
    cases = [{"n_heads": 2}, {"d_model": 128},
             {"param_sharding": "wus", "microbatches": 2,
              "seq_parallel": False},
             {"n_layers": 2 * len(get_config(arch).block_pattern)},
             {"moe.top_k": 1}, {"mamba.d_state": 8}, {"nope": 1}]
    for reduce in (False, True):
        for ov in cases:
            cfg, jcfg = get_config(arch), jax_get_config(arch)
            if reduce:
                cfg, jcfg = cfg.reduced(), jcfg.reduced()
            try:
                want = jbase.apply_overrides(jcfg, ov)
            except ValueError:
                same_error(lambda: pbase.apply_overrides(cfg, ov),
                           lambda: jbase.apply_overrides(jcfg, ov),
                           ValueError)
                continue
            got = pbase.apply_overrides(cfg, ov)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (arch, reduce, ov)


def test_input_shapes_are_the_references():
    from repro.configs import INPUT_SHAPES, get_shape
    from repro_torch import configs

    assert {k: dataclasses.asdict(v) for k, v in
            configs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()}
    assert dataclasses.asdict(configs.get_shape("train_4k")) == \
        dataclasses.asdict(get_shape("train_4k"))


# --------------------------------------------------------------------------- #
# Spec files: JSON and TOML, the errors, the minimal TOML parser.
# --------------------------------------------------------------------------- #
TOML_TEXTS = {
    "ok": 'arch = "rwkv6-3b"  # comment\nmode = "serve"\n'
          'scenario = "server"\n\n[serve]\ntokens = 4\ntemperature = 0.5\n'
          'slo_classes = ["interactive", "batch"]\n\n[serve.kv]\n'
          "layout = 'paged'\nprefix_cache = true\n\n[model]\n"
          'param_sharding = "replicated"\nsliding_window = 64\n',
    "hash_in_string": 'arch = "gemma-7b"\n[fleet]\nimage = "r#1:latest"\n',
    "empty_array": '[trainer]\nmetrics = []\n',
    "bare_string": 'arch = gemma\n',
    "bad_line": '[serve]\ntokens\n',
    "collision": 'serve = 3\n[serve.kv]\nlayout = "paged"\n',
    "bad_key": '[serve]\ntokenz = 4\n',
}


@pytest.mark.parametrize("name", sorted(TOML_TEXTS))
def test_spec_file_toml_parsers_agree(tmp_path, name):
    text = TOML_TEXTS[name]
    path = tmp_path / "s.toml"
    path.write_text(text)
    for parse in ("_parse_toml_minimal", "_load_toml"):
        try:
            want = getattr(jspecfile, parse)(text, str(path))
        except J.SpecError:
            same_error(lambda: getattr(pspecfile, parse)(text, str(path)),
                       lambda: getattr(jspecfile, parse)(text, str(path)))
        else:
            assert getattr(pspecfile, parse)(text, str(path)) == want
    try:
        want = J.load_spec_file(str(path))
    except J.SpecError:
        same_error(lambda: P.load_spec_file(str(path)),
                   lambda: J.load_spec_file(str(path)), P.SpecError)
    else:
        assert P.load_spec_file(str(path)).to_dict() == want.to_dict()


@pytest.mark.parametrize("case", ["bad_key", "missing", "yaml", "bad_json",
                                  "not_object", "json_toml_agree"])
def test_spec_file_errors(tmp_path, case):
    path = tmp_path / {"yaml": "s.yaml", "missing": "none.json"}.get(
        case, "s.json")
    text = {"bad_key": '{"trianer": {}}', "yaml": "arch: gemma-7b",
            "bad_json": '{"arch": ', "not_object": "[1, 2]",
            "json_toml_agree": json.dumps({
                "arch": "rwkv6-3b", "mode": "serve", "scenario": "server",
                "serve": {"tokens": 4, "temperature": 0.5},
                "model": {"param_sharding": "replicated"}})}.get(case)
    if text is not None:
        path.write_text(text)
    if case == "json_toml_agree":
        tpath = tmp_path / "s.toml"
        tpath.write_text(
            'arch = "rwkv6-3b"\nmode = "serve"\nscenario = "server"\n'
            '[serve]\ntokens = 4\ntemperature = 0.5\n'
            '[model]\nparam_sharding = "replicated"\n')
        assert P.load_spec_file(str(path)) == P.load_spec_file(str(tpath))
        assert P.load_spec_file(str(path)).to_dict() == \
            J.load_spec_file(str(path)).to_dict()
        return
    same_error(lambda: P.load_spec_file(str(path)),
               lambda: J.load_spec_file(str(path)), P.SpecError)


# --------------------------------------------------------------------------- #
# The CLI: the same spec from the same arguments, the same exit codes.
# --------------------------------------------------------------------------- #
CLI_ARGS = [
    ["--spec", "runs/gemma_7b_train.json", "--set", "trainer.total_steps=3"],
    ["--spec", "runs/serve_fleet.toml", "--scenario", "offline", "--seed",
     "4", "--set", "fleet.chaos=stall", "--set", "serve.kv.page_size=8"],
    ["--arch", "yi-9b", "--mode", "serve", "--mesh", "multipod", "--full",
     "--set", "serve.page_size=4"],
    ["--spec", "runs/train_async.toml", "--reduced", "--metrics-out",
     "/tmp/m.jsonl", "--set", "model.param_sharding=wus"],
    ["--spec", "runs/serve_prefix.toml", "--mode", "eval", "--arch",
     "gemma_7b", "--set", "trainer.metrics=grad_norm"],
    ["--spec", "runs/serve_fleet.toml", "--mode", "dryrun", "--set",
     "fleet.n_replicas=3"],
]


@pytest.mark.parametrize("args", CLI_ARGS)
def test_cli_builds_the_references_spec(monkeypatch, args):
    """``python -m repro_torch run`` and ``python -m repro run`` resolve
    the same RunSpec from the same arguments (the spec file, then the
    flags, then --set)."""
    monkeypatch.chdir(os.path.join(RUNS_DIR, ".."))
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    seen = {}
    monkeypatch.setattr(jdispatch, "run_spec",
                        lambda spec: seen.setdefault("ref", spec) and {})
    monkeypatch.setattr(pdispatch, "run_spec",
                        lambda spec, **kw: seen.setdefault("port", (spec, kw))
                        and {})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert jcli.main(["run", *args]) == 0
        assert pcli.main(["run", *args, "--device", "cpu"]) == 0
    spec, kw = seen["port"]
    assert spec.to_dict() == seen["ref"].to_dict()
    assert kw == {"device": "cpu", "profile": None, "trace": False}


@pytest.mark.parametrize("argv", [
    [], ["serve"], ["run", "--set", "trainer.total_stepz=5"],
    ["run", "--set", "no_equals"], ["run", "--spec", "runs/missing.json"],
    ["run", "--set", "mode=bench"],
])
def test_cli_exit_codes_are_the_references(capsys, argv):
    ref = jcli.main(list(argv)) if argv != ["run", "--set", "mode=bench"] \
        else None
    ref_err = capsys.readouterr().err
    got = pcli.main(list(argv) + (["--device", "cpu"] if argv[:1] == ["run"]
                                  else []))
    err = capsys.readouterr().err
    assert got == 2
    if ref is None:  # the port runs no benchmark suite yet
        assert "ROADMAP.md item 6.5" in err
        return
    assert ref == 2
    assert err.splitlines()[-1] == ref_err.splitlines()[-1]
