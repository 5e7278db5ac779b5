"""Derived sharding-spec tables on the production meshes (the port's
``repro.launch.dryrun.spec_table`` / ``print_spec_table``).

Every parameter's logical axes and the specs ``dist.sharding.Rules``
derives for its master weight and its optimizer moments, on the 16 x 16
(``multi_pod=False``) or 2 x 16 x 16 mesh. Nothing is allocated and no
process group is needed: the shapes come from the family's init under
``FakeTensorMode`` and the rules from a shape-only mesh. Specs print in
the reference's ``PartitionSpec(...)`` form. The rows are in the port's
layout, one tree a layer (``['layers'][i]...``), where the reference
stacks a pattern position's layers under a leading ``layer`` dim.

    python -m repro_torch run --arch gemma-7b --mode dryrun \
        --set dryrun.specs=true [--mesh multipod]

The reference's AOT compile of every (arch x input shape)
(``dryrun_one``) is ROADMAP.md item 6.4's next step.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from repro_torch.configs import get_config


class ShapeMesh:
    """Shape-only mesh: ``shape`` (axis name -> size) and ``axis_names``,
    all ``Rules`` reads."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


def partition_spec_str(spec) -> str:
    """A port spec (one tuple of mesh axes or None a dim) as the
    reference prints its ``PartitionSpec``: the tuple of its entries, a
    single axis by its bare name."""
    return "PartitionSpec" + repr(tuple(
        e if e is None else e[0] if len(e) == 1 else tuple(e)
        for e in spec))


def _leaves(tree, path=""):
    """(keystr path, leaf) of a dict/list tree, keys sorted, as
    ``jax.tree_util.keystr`` writes the path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "names"):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}[{i}]")
    else:
        yield path, tree


def spec_table(arch: str, *, multi_pod: bool = False, mode: str = None
               ) -> Tuple[Dict, List[Dict]]:
    """Rows of (param, shape, logical axes, param spec, opt spec)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.train.steps import ModelAPI

    cfg = get_config(arch)
    mesh = ShapeMesh(*production_mesh_shape(multi_pod=multi_pod))
    mode = mode or cfg.param_sharding
    rules = Rules(mesh, mode, seq_parallel=cfg.seq_parallel)
    api = ModelAPI(cfg)
    with FakeTensorMode():
        params = api.init(cfg, 0, device="cpu", dtype=torch.float32)
    shapes = dict(_leaves(params))
    rows = []
    for path, a in _leaves(api.param_axes()):
        shape = tuple(shapes[path].shape)
        rows.append({
            "param": path,
            "shape": shape,
            "axes": tuple(a.names),
            "param_spec": partition_spec_str(rules.param_spec(a.names,
                                                              shape)),
            "opt_spec": partition_spec_str(rules.opt_spec(a.names, shape)),
        })
    meta = {
        "arch": arch,
        "mode": mode,
        "seq_parallel": cfg.seq_parallel,
        "mesh": {a: int(mesh.shape[a]) for a in mesh.axis_names},
    }
    return meta, rows


def print_spec_table(arch: str, *, multi_pod: bool = False,
                     mode: str = None):
    meta, rows = spec_table(arch, multi_pod=multi_pod, mode=mode)
    mesh_desc = ",".join(f"{a}={n}" for a, n in meta["mesh"].items())
    print(f"== spec table: {arch} (mode={meta['mode']}, "
          f"seq_parallel={meta['seq_parallel']}, mesh {mesh_desc}) ==")
    hdr = f"{'param':44s} {'shape':22s} {'axes':28s} {'param_spec':26s} opt_spec"
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['param']:44s} {str(r['shape']):22s} "
              f"{str(r['axes']):28s} {r['param_spec']:26s} {r['opt_spec']}")
    sys.stdout.flush()
    return meta, rows
