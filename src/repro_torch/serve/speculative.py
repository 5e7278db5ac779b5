"""Speculative-decoding drafters of the paged engine
(``repro.serve.speculative``).

A drafter proposes up to ``draft_len`` tokens for a decode row; the
engine verifies the whole proposal in one pass of its chunk program
(a decode row feeds ``[last_tok, d_1..d_k]``) with the head over every
fed position, accepts the run of drafts that match the greedy targets,
and emits that run plus the model's own next token, so greedy outputs
stay those of plain decoding.

  * :class:`NgramDrafter`: self-speculative n-gram lookup over the
    row's own context (prompt + generated so far);
  * :class:`DraftModelDrafter`: wraps any ``propose(context, k) ->
    tokens`` callable (a small draft model, or a replay of known
    tokens).

Drafters run on the host between steps and may return fewer than ``k``
tokens, or none (the row then decodes plainly).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence


class NgramDrafter:
    """Longest-suffix n-gram proposer over the row's own token history.

    For ``n = max_n .. 1``: if the last ``n`` tokens occurred earlier in
    the context, propose the ``k`` tokens that followed the *most
    recent* earlier occurrence. Returns [] when no suffix repeats.
    """

    def __init__(self, max_n: int = 3):
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        self.max_n = max_n

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context)
        L = len(ctx)
        if k <= 0 or L < 2:
            return []
        for n in range(min(self.max_n, L - 1), 0, -1):
            suffix = ctx[-n:]
            # most recent earlier occurrence wins (locality beats age)
            for i in range(L - n - 1, -1, -1):
                if ctx[i:i + n] == suffix:
                    cont = ctx[i + n:i + n + k]
                    if cont:
                        return cont
                    break  # suffix only recurs at the very end
        return []


class DraftModelDrafter:
    """Hook for model-based drafting: wraps any propose-callable.

    ``fn(context, k) -> tokens`` — typically a greedy decode loop over a
    small-config model from the same family (same tokenizer/vocab), but
    any proposal source fits. The engine treats it exactly like the
    n-gram drafter: proposals are verified by the target model, so a
    bad drafter costs acceptance rate, never correctness.
    """

    def __init__(self, fn: Callable[[Sequence[int], int], Sequence[int]]):
        self.fn = fn

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        return list(self.fn(context, k))[:k]


def get_drafter(spec_decode: str) -> Optional[NgramDrafter]:
    """'off' -> None, 'ngram' -> NgramDrafter(). Model-based drafting is
    constructed explicitly (needs params) and passed to the Engine."""
    if spec_decode in ("", "off"):
        return None
    if spec_decode == "ngram":
        return NgramDrafter()
    raise ValueError(
        f"unknown spec_decode mode {spec_decode!r}; expected 'off' or "
        "'ngram' (pass a DraftModelDrafter instance for model drafting)")
