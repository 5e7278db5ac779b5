"""Mesh-context scoping (the port's ``repro.dist.context``).

``use_rules(rules)`` installs a :class:`~repro_torch.dist.sharding.Rules`
for the dynamic extent of a block and ``current_rules()`` reads it: the
port's train and eval steps run under it, as the reference's do. The
port's layers take their mesh context explicitly (a
:class:`repro_torch.dist.spmd.Placement` argument): a checkpointed
layer is recomputed inside the backward, which autograd runs on its own
thread for CUDA tensors, where a context variable set by the caller is
not seen. So no port module reads ``current_rules()`` yet.

The reference's third function, ``constrain(x, *names)``, is a layout
hint to GSPMD (``with_sharding_constraint``), which explicit SPMD does
not have: each rank holds its block and moves data only where a
collective says so. Each reference call site where the layout changes
is one named collective of the port's layers, at the same point (the
methods of ``spmd.Placement``; m is the ``model`` axis):

  reference call site                     port, at the same point
  lm.py:94   _embed, table ("vocab", None)  ``gather_leaf`` of ``embed``
                                            over data and model, at use
  lm.py:102,105 _head_weight ("vocab")      ``gather_leaf`` of ``head`` (or
                                            the tied ``embed``), once a step
  lm.py:110,264 logits ("batch", None,      none: the rank's rows over the
             "act_mlp")                     whole vocabulary (the vocab-
                                            parallel head is not ported)
  lm.py:199  x ("batch", "seq_res", None)   ``seq_block``: the rank's
             after the embedding            sequence block (seq_parallel)
  layers.py:145-147 q/k/v ("batch", None,   ``enter``: all-gather of the
             "act_heads", None)             sequence over m (seq_parallel;
                                            backward reduce-scatter) or
                                            ``pvary`` (backward psum); the
                                            heads are the rank's blocks
  layers.py:149 out ("act_heads")           none: the rank's heads
  lm.py:169,181 x + y ("batch", "seq_res")  ``exit``: reduce-scatter of
                                            the row-parallel partial sum
                                            over m (seq_parallel) or the
                                            invariant all-reduce
  layers.py:537 FFN h ("act_mlp")           ``enter`` / ``exit`` around
                                            the FFN, its ``mlp`` blocks
  layers.py:588-600 MoE, :673 Mamba         ``enter`` / ``exit`` around
                                            the layer, its experts, units
                                            or channels the rank's blocks
                                            (``Placement.layout``)
  encdec.py:94-148 x ("batch", "seq_res")   one ``Placement`` a stream,
                                            the encoder's and the
                                            decoder's; the cross K/V's
                                            source ``enter_source``: whole
                                            over its sequence

Outside any scope (or under ``use_rules(None)``) ``current_rules()`` is
None and the models run their one-device path.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from repro_torch.dist.sharding import Rules

_ACTIVE_RULES: contextvars.ContextVar[Optional[Rules]] = \
    contextvars.ContextVar("repro_torch_dist_active_rules", default=None)


def current_rules() -> Optional[Rules]:
    """The ``Rules`` installed by the innermost ``use_rules``, or None."""
    return _ACTIVE_RULES.get()


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    """Scope :func:`current_rules` to ``rules`` (None: no mesh)."""
    token = _ACTIVE_RULES.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE_RULES.reset(token)
