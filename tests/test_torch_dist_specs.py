"""The sharded trainer's layouts against the reference's, leaf by leaf,
with no ranks: for every arch of the zoo, at its published widths and
reduced, the port's weight, moment, batch and cache specs
(``train/steps.py``: ``train_state_specs``, ``param_specs_serving``,
``batch_pspecs``, ``cache_pspecs``) against the reference's
(``repro.train.steps``), in every mode of ``dist.rules.MODES``, with
``seq_parallel`` on and off, on (16, 16), (2, 16, 16), (4, 2) and
(2, 2, 2) meshes.

The reference's side is shapes only (``jax.eval_shape``,
``jax.sharding.AbstractMesh``); the port's shapes come from its own
inits under ``FakeTensorMode`` (nothing is allocated) and its rules from
a shape-only mesh stand-in. The port keeps one tree a layer where the
reference stacks a pattern position's layers along a leading ``layer``
dim: port layer i is the reference's pattern position i % P (an enc-dec
stack's layer i, its stack), and the reference's spec of a stacked leaf
is ``(None,)`` (``layer`` maps to no mesh axis) followed by the port's.
The reference writes a single mesh axis as its bare name, the port as a
one-name tuple. Also: each config's ``param_sharding`` and
``seq_parallel``, and the port's axes trees against the reference's
tagged init (``split_tree(api.init(...))[1]``, via
``init_params_and_axes``).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import Rules as JRules  # noqa: E402
from repro.train import steps as JT  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.dist.rules import MODES  # noqa: E402
from repro_torch.dist.sharding import Rules  # noqa: E402
from repro_torch.dist.tagging import Axes  # noqa: E402
from repro_torch.train import steps as T  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
BATCHES = (256, 6)     # rows every mesh divides, and rows none does
CACHE = (4, 64)        # (slots, length) of the slab caches


class FakeMesh:
    """Shape-only stand-in: ``shape`` and ``axis_names``."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


def norm(spec):
    """A reference PartitionSpec in the port's form."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def leaves_with_paths(tree, path=()):
    """(path, leaf) of a port tree (dicts and lists; a spec, a tuple, is
    a leaf), sorted keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from leaves_with_paths(t, path + (i,))
    else:
        yield path, tree


def ref_at(tree, path, cfg, stacks):
    """The reference's entry for a port path: a layer index maps to the
    pattern position (``blocks``) or drops (enc-dec stacks); returns
    (entry, whether it is stacked)."""
    head, rest = path[0], path[1:]
    if head == "layers":
        t, rest = tree["blocks"][rest[0] % len(cfg.block_pattern)], rest[1:]
    elif head in stacks:
        t, rest = tree[head], rest[1:]
    else:
        return _walk(tree[head], rest), False
    return _walk(t, rest), True


def _walk(t, path):
    for k in path:
        t = t[k]
    return t


def unstack(spec, stacked):
    spec = norm(spec)
    if stacked:
        assert spec[0] is None, spec
        return spec[1:]
    return spec


def hold(port_specs, ref_specs, cfg, stacks, what):
    n = 0
    for path, got in leaves_with_paths(port_specs):
        want, stacked = ref_at(ref_specs, path, cfg, stacks)
        assert got == unstack(want, stacked), (what, path, got, want)
        n += 1
    return n


def port_shapes(cfg):
    """(state, cache) of the port's own inits, as fake tensors."""
    api = T.ModelAPI(cfg)
    with FakeTensorMode():
        params = api.init(cfg, 0, device="cpu", dtype=torch.float32)
        state = {"params": params,
                 "opt": T.make_optimizer(cfg).init(params)}
        cache = api.init_cache(CACHE[0], CACHE[1], device="cpu")
    return state, cache


def ref_shapes(jcfg):
    state, axes = JT.init_train_state(jcfg, JT.make_optimizer(jcfg),
                                      jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: JT.ModelAPI(jcfg).init_cache(*CACHE))
    return state, axes, cache


def batch_shapes(cfg, rows):
    b = {"tokens": np.zeros((rows, 32), np.int32)}
    if cfg.is_encdec:
        b["media"] = np.zeros((rows, cfg.enc_source_len, cfg.d_model),
                              np.float32)
    elif cfg.n_media_tokens:
        b["media"] = np.zeros((rows, cfg.n_media_tokens, cfg.d_model),
                              np.float32)
    return b


ARCHS = list_archs()


@pytest.mark.parametrize("mesh, ranks", [("pod", 256), ("multipod", 512)])
def test_launch_train_names_the_ranks_a_mesh_needs(monkeypatch, mesh, ranks):
    """``--mesh pod|multipod`` on one process fails before any work,
    naming the ranks the production mesh needs."""
    from repro_torch.launch import train as cli

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=f"it needs {ranks} ranks"):
        cli.main(["--arch", "yi-9b", "--mesh", mesh, "--device", "cpu"])


def test_tagging_is_the_references():
    """``p``, ``split_tree``, ``retag_tree`` and ``stack_axes`` on one
    tree with tagged and untagged leaves, in both packages."""
    from repro.dist import tagging as JTag
    from repro_torch.dist import tagging as PTag

    w, v = np.ones((2, 3), np.float32), np.ones((4,), np.float32)
    out = []
    for Tag, arr in ((JTag, jnp.asarray), (PTag, torch.from_numpy)):
        tree = {"a": Tag.p(arr(w), "fsdp", "mlp"), "b": [Tag.p(arr(v)),
                                                         arr(v)]}
        vals, axes = Tag.split_tree(tree)
        again, _ = Tag.split_tree(Tag.retag_tree(vals, axes))
        assert np.array_equal(np.asarray(again["a"]), w)
        stacked = Tag.stack_axes(axes)
        out.append([axes["a"].names, axes["b"][0].names, axes["b"][1].names,
                    stacked["a"].names, stacked["b"][1].names])
    assert out[0] == out[1] == [("fsdp", "mlp"), (), (None,),
                                ("layer", "fsdp", "mlp"), ("layer", None)]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_distribution_fields_are_the_references(arch):
    for reduce in (False, True):
        ref, cfg = jax_get_config(arch), get_config(arch)
        if reduce:
            ref, cfg = ref.reduced(), cfg.reduced()
        assert (cfg.param_sharding, cfg.seq_parallel) == \
            (ref.param_sharding, ref.seq_parallel), (arch, reduce)


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_is_the_references(arch):
    """Every leaf's logical axes, the reference's from its tagged init
    (stacked leaves lead with ``layer``), and one port leaf for each."""
    for reduce in (False, True):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        _, ref_axes = JT.init_params_and_axes(jcfg, jax.random.PRNGKey(0))
        port = T.ModelAPI(cfg).param_axes()
        stacks = ("enc_blocks", "dec_blocks")
        n = 0
        for path, got in leaves_with_paths(port):
            assert isinstance(got, Axes), path
            want, stacked = ref_at(ref_axes, path, cfg, stacks)
            want = tuple(want.names)
            if stacked:
                assert want[0] == "layer", (path, want)
                want = want[1:]
            assert got.names == want, (arch, reduce, path, got, want)
            n += 1
        state, _ = port_shapes(cfg)
        assert n == len(list(leaves_with_paths(state["params"])))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_are_the_references(arch):
    """Weights, moments (``opt_state_specs``: the C1 upgrade in wus), the
    optimizer's step, serving weights, batches and caches, leaf by leaf,
    for every mode, ``seq_parallel`` setting and mesh."""
    stacks = ("enc_blocks", "dec_blocks", "self", "cross")
    for reduce in (False, True):
        jbase, base = jax_get_config(arch), get_config(arch)
        if reduce:
            jbase, base = jbase.reduced(), base.reduced()
        rstate, raxes, rcache = ref_shapes(jbase)
        pstate, pcache = port_shapes(base)
        paxes = T.ModelAPI(base).param_axes()
        counted = 0
        for shape, names in MESHES:
            jmesh, fake = AbstractMesh(shape, names), FakeMesh(shape, names)
            for mode in MODES:
                for sp in (False, True):
                    jcfg = dataclasses.replace(jbase, param_sharding=mode,
                                               seq_parallel=sp)
                    cfg = dataclasses.replace(base, param_sharding=mode,
                                              seq_parallel=sp)
                    jr, pr = JRules(jmesh, mode, sp), Rules(fake, mode, sp)
                    want = JT.train_state_specs(jcfg, rstate, raxes, jr)
                    got = T.train_state_specs(cfg, pstate, paxes, pr)
                    counted += hold(got["params"], want["params"], cfg,
                                    stacks, "params")
                    for k in ("m", "v"):
                        counted += hold(got["opt"][k], want["opt"][k], cfg,
                                        stacks, k)
                    assert got["opt"]["step"] == norm(want["opt"]["step"])
                    hold(T.param_specs_serving(cfg, pstate["params"], paxes,
                                               pr),
                         JT.param_specs_serving(jcfg, rstate["params"],
                                                raxes, jr),
                         cfg, stacks, "serving")
                    for rows in BATCHES:
                        b = batch_shapes(cfg, rows)
                        got_b = T.batch_pspecs(b, pr)
                        want_b = JT.batch_pspecs(
                            jax.tree_util.tree_map(
                                lambda a: jax.ShapeDtypeStruct(
                                    a.shape, jnp.dtype(a.dtype)), b), jr)
                        assert {k: v for k, v in got_b.items()} == \
                            {k: norm(v) for k, v in want_b.items()}
                    got_c = T.cache_pspecs(cfg, pcache, pr)
                    want_c = JT.cache_pspecs(jcfg, rcache, jr)
                    if cfg.is_encdec:
                        hold(got_c, want_c, cfg, stacks, "cache")
                    else:
                        for i, entry in enumerate(got_c):
                            want_i = want_c[i % len(cfg.block_pattern)]
                            for k, spec in entry.items():
                                assert spec == unstack(want_i[k], True), \
                                    (arch, i, k, spec, want_i[k])
        assert counted > 0
