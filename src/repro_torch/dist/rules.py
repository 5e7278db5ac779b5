"""Logical-axis -> mesh-axis tables: the sharding *policy* in one place
(the port's copy of ``repro.dist.rules``).

Every paper technique is a row in these tables:

  * C1 weight-update sharding: mode ``"wus"`` keeps parameters replicated
    across ``data`` while optimizer moments take the ``data`` axis (the
    reduce-scatter / sharded-update / all-gather schedule of Fig. 4);
  * C2 2-D gradient summation: ``batch`` spans ``("pod", "data")`` on
    multipod meshes, so gradient reduction factorizes into an in-pod
    reduce-scatter and a cross-pod all-reduce;
  * C5 model parallelism: ``heads``/``mlp``/``vocab``/``expert`` map to the
    ``model`` axis; ``seq_parallel`` additionally puts the residual-stream
    sequence dimension on ``model`` (Megatron-SP).

Logical axes used by the model zoo:

  parameters   fsdp, heads, kv_heads, mlp, vocab, expert
  activations  batch, seq_res, act_heads, act_mlp, act_expert, kv_seq
  structural   layer (scan-stacked leading dim; never sharded)

Modes (``ModelConfig.param_sharding`` / ``--serve-mode``):

  replicated  pure data parallelism: weights replicated everywhere
  fsdp        weights sharded on their ``fsdp`` dim across ``data``
  wus         paper C1: params replicated across ``data``, optimizer
              moments (and the update computation) sharded across it
  tp2d        serving: weight-stationary 2-D tensor parallelism — both
              mesh axes live on the weights, batch is not split across
              ``data`` (activations move to the weights)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

MODES = ("replicated", "fsdp", "wus", "tp2d")

PARAM_AXES = ("fsdp", "heads", "kv_heads", "mlp", "vocab", "expert")
ACTIVATION_AXES = (
    "batch", "seq_res", "act_heads", "act_mlp", "act_expert", "kv_seq"
)
LAYER_AXIS = "layer"  # leading axis of scan-stacked per-layer parameters

Table = Dict[str, Tuple[str, ...]]


def build_table(mesh_axes: Tuple[str, ...], mode: str,
                seq_parallel: bool) -> Table:
    """Full logical->mesh table for one (mesh, mode, seq_parallel).

    Values are tuples of mesh-axis names; ``()`` means replicated. The
    returned table is the *optimizer-state / activation* view — parameter
    mode differences (wus keeping params off ``data``) are applied on top
    by ``Rules.param_spec``.
    """
    if mode not in MODES:
        raise ValueError(f"unknown sharding mode {mode!r}; known: {MODES}")

    def has(a):
        return a in mesh_axes

    data = ("data",) if has("data") else ()
    model = ("model",) if has("model") else ()
    pod = ("pod",) if has("pod") else ()

    table: Table = {
        # Activations (all modes): batch over the data-parallel axes —
        # spanning both pod and data on multipod meshes (C2) — attention
        # heads / FFN hidden / expert dim over model, sequence over model
        # only under sequence parallelism.
        "batch": pod if mode == "tp2d" else pod + data,
        "seq_res": model if seq_parallel else (),
        "act_heads": model,
        "act_mlp": model,
        "act_expert": model,
        "kv_seq": model,
    }
    if mode == "replicated":
        for name in PARAM_AXES:
            table[name] = ()
    else:
        table["fsdp"] = data
        for name in ("heads", "kv_heads", "mlp", "vocab", "expert"):
            table[name] = model
    return table


def lookup(table: Table, name: Optional[str]) -> Tuple[str, ...]:
    """Mesh axes for one logical name (``None``/unknown -> replicated)."""
    if name is None:
        return ()
    return table.get(name, ())
