"""Continuous-batching engine (``repro.serve.engine``): two KV layouts
behind one surface (submit / step / run).

**paged** (the default for attention-only stacks): KV lives in a shared
:class:`~repro_torch.serve.cache.PagePool`; one chunk program
(``lm.decode_chunk``) advances every slot each round.
Decode rows feed one token; admitted prompts stream through the same
(B, C) batch as ``prefill_chunk``-sized slices. Admission is by
free-page budget (:class:`~repro_torch.serve.scheduler.PagedScheduler`);
when decode growth exhausts the pool the engine preempts the slot with
the most SLO slack (youngest first among untagged requests), which
re-queues at the front and later re-prefills from prompt + tokens so
far, token-identical under greedy sampling.

The pool holds bf16, fp32, int8 or int4 K/V (``kv_dtype``; the
quantized pools carry fp32 per-row scales and run through the paged
kernel's int8/int4 branches). With ``prefix_cache=True`` every full
page a slot writes is registered in a radix prefix index
(:class:`~repro_torch.serve.prefix.PrefixIndex`), and admission maps
the stream's longest cached page-aligned prefix straight into the new
slot (refcounted), charges the budget only for new pages and starts
prefill at the first uncached token; a stream whose every page is
cached copy-on-writes its last page and re-feeds its last token. With a
drafter (``spec_decode="ngram"``, or a ``DraftModelDrafter`` passed in)
decode rows feed ``[last_tok, d_1..d_k]`` and the head over every fed
position verifies the drafts in the same chunk step. Under pool
pressure the engine sheds drafts first, then evicts LRU index entries,
then preempts. Greedy outputs equal those of the plain engine.

**slab** (stacks with a recurrent mixer, such as jamba's Mamba or
rwkv6's RWKV-6 layers, a vision frontend, whose media the decoder reads
ahead of each prompt (qwen2-vl), or ``kv_layout="slab"``): the dense
per-slot decode cache
(``serve.cache.init_slab``) and two programs: ``prefill`` of one
admitted request (``lm.prefill``, written into its slot by
``serve.cache.write_slot``) and ``decode`` of one token for every slot
(``lm.decode_step`` with a per-slot position vector; idle slots compute
garbage in their own rows, which admission overwrites). A recurrent
mixer carries prompt state, so such stacks prefill at the exact prompt
length; attention-only stacks pad prompts to ``prefill_len`` and mask
the padding (``serve.cache.invalidate_beyond``). Greedy tokens are the
same in both layouts.

An enc-dec model (whisper) serves paged, as in the reference: each
request carries ``media``, its encoder frames. Admission runs the
encoder and every decoder layer's cross K/V once (``encode_cross``),
written into the slot's dense cross slab beside the pools; the chunk
program reads it, preemption and defrag leave it as it is, and the
prefix index keys its pages by a digest of the media as well as the
tokens. On the slab layout the prefill takes the media too.

With ``temperature > 0`` every token is drawn from its own key,
``fold_in(fold_in(prng_key(seed), request id), position)``
(:mod:`repro_torch.random`, bit for bit the reference's ``jax.random``
keys), by Gumbel-max over ``logits / temperature``: a draw depends on
the request and the position alone, not on the slot or the batch.
Speculative decoding stays greedy-only.

On a mesh (``mesh=``, or ``rules=`` bound to one) every rank runs this
host loop on the same requests and holds its block of the weights and
caches; the programs run under the mode's placement
(:mod:`repro_torch.dist.serving`): ``tp2d`` keeps the weights on both
mesh axes and the batch whole over ``data``; ``fsdp``, ``wus`` and
``replicated`` gather weights at use and split the slots over the
batch axes, the emitted tokens gathered. Every rank takes the tokens
from the same logits, so the host state stays the same on every rank.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import itertools
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.random import fold_in, prng_key, sample
from repro_torch.serve import cache as pool_ops
from repro_torch.serve import slo
from repro_torch.serve.metrics import ServeReport, StepTrace
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import PagedScheduler, Scheduler
from repro_torch.serve.speculative import get_drafter
from repro_torch.train.steps import (
    ModelAPI,
    make_serve_decode_step,
    make_serve_prefill_step,
)

KV_DTYPES = ("", "bfloat16", "float32", "int8", "int4")
KV_LAYOUTS = ("auto", "slab", "paged")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs. ``max_len`` is the per-request token budget (prompt
    + generation). ``prefill_len`` is the slab layout's padded prompt
    length for attention-only stacks (recurrent stacks prefill at the
    exact prompt length; the paged layout ignores it). ``page_size`` /
    ``n_pages`` size the pool; ``n_pages`` defaults to ``max_batch *
    ceil(max_len / page_size)``. ``kv_dtype`` ('' inherits the model
    config's ``kv_cache_dtype``) picks the cache; ``spec_decode`` 'ngram'
    drafts ``draft_len`` tokens a row. ``temperature > 0`` samples with
    keys from ``seed``."""

    max_batch: int = 4
    max_len: int = 128
    prefill_len: int = 32
    temperature: float = 0.0
    seed: int = 0                # sampling key (temperature > 0)
    eos_id: Optional[int] = None
    kv_layout: str = "auto"      # auto | slab | paged
    page_size: int = 16
    prefill_chunk: int = 8
    n_pages: Optional[int] = None
    prefix_cache: bool = False   # cross-request KV sharing
    kv_dtype: str = ""           # '' | bfloat16 | float32 | int8 | int4
    spec_decode: str = "off"     # off | ngram (greedy only)
    draft_len: int = 4           # tokens proposed per row per step

    def __post_init__(self):
        if self.kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, got "
                             f"{self.kv_layout!r}")
        # The reference raises for 'auto' too; here the paged layout,
        # which never pads, is never asked to size a knob it ignores.
        if self.kv_layout == "slab" and self.prefill_len > self.max_len:
            raise ValueError("prefill_len exceeds max_len")
        if self.page_size < 1 or self.prefill_chunk < 1:
            raise ValueError("page_size and prefill_chunk must be >= 1")
        if self.n_pages is not None and self.n_pages < 1:
            raise ValueError("n_pages must be >= 1")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                             f"{self.kv_dtype!r}")
        if self.spec_decode not in ("off", "ngram"):
            raise ValueError(
                f"spec_decode must be 'off' or 'ngram', got "
                f"{self.spec_decode!r} (model-based drafting passes a "
                f"DraftModelDrafter to the Engine)")
        if self.draft_len < 1:
            raise ValueError("draft_len must be >= 1")

    @property
    def max_pages(self) -> int:
        """Page-table width: pages a single request can map."""
        return -(-self.max_len // self.page_size)

    @property
    def pool_pages(self) -> int:
        return self.n_pages or self.max_batch * self.max_pages


class Engine:
    """Continuous-batching engine on ``device`` (default CUDA), with
    ``params`` from the family's init or weight bridge (``lm.init_lm``,
    ``lm.params_from_numpy``, ``encdec.init_encdec``, ...);
    ``drafter`` (optional, paged only) is any object with
    ``propose(context, k)``. ``layout`` is the KV layout in use.

    ``mesh`` (a ``launch.mesh.Mesh``) and ``rules`` (a
    ``dist.sharding.Rules``; default: the config's ``param_sharding``
    mode on ``mesh``) serve on a mesh, on the mesh's device: ``params``
    is the whole tree, of which the engine keeps the rank's blocks.
    ``check_ranks`` (debug) raises when any rank's tokens of a step
    differ from rank 0's."""

    def __init__(self, cfg: ModelConfig, params,
                 serve: Optional[ServeConfig] = None, *, rules=None,
                 mesh=None, drafter=None, device="cuda",
                 check_ranks: bool = False):
        self.scfg = serve or ServeConfig()
        if self.scfg.kv_dtype:
            cfg = dataclasses.replace(cfg, kv_cache_dtype=self.scfg.kv_dtype)
        # Recurrent mixers carry prompt state: exact-length prefill, slab.
        # A vision frontend's media feed the decoder: slab too.
        self._exact = any(s.mixer != "attn" for s in cfg.block_pattern)
        paged_ok = not self._exact and cfg.frontend != "vision_patches"
        layout = self.scfg.kv_layout
        if layout == "auto":
            layout = "paged" if paged_ok else "slab"
        elif layout == "paged" and not paged_ok:
            raise ValueError(
                f"kv_layout='paged' needs an attention-only, token-frontend "
                f"stack; {cfg.name} has "
                f"{'a recurrent mixer' if self._exact else 'a vision frontend'}"
                f" — use kv_layout='slab'")
        if self.scfg.prefix_cache and layout != "paged":
            raise ValueError(
                "prefix_cache shares pages of the paged KV pool; the slab "
                "layout has no pages to share — use kv_layout='paged' "
                "(or drop prefix_cache for this arch)")
        # Unsupported dtype / layout combos fail here, not mid-step.
        if cfg.kv_cache_dtype == "int4":
            if layout != "paged":
                raise ValueError(
                    "kv_dtype='int4' packs pool pages two-dims-per-byte; "
                    "only the paged layout supports it — use "
                    "kv_layout='paged' or kv_dtype='int8'")
            if cfg.head_dim % 2:
                raise ValueError(
                    f"kv_dtype='int4' needs an even head_dim; {cfg.name} "
                    f"has head_dim={cfg.head_dim}")
        self._drafter = drafter
        if self._drafter is None:
            self._drafter = get_drafter(self.scfg.spec_decode)
        if self._drafter is not None:
            if layout != "paged":
                raise ValueError(
                    "speculative decoding verifies drafts through the "
                    "paged chunk program; use kv_layout='paged'")
            if self.scfg.temperature > 0.0:
                raise ValueError(
                    "speculative decoding is greedy-only (acceptance "
                    "compares against argmax); set temperature=0")
            if self.scfg.draft_len + 1 > self.scfg.prefill_chunk:
                raise ValueError(
                    f"draft_len+1 ({self.scfg.draft_len + 1}) tokens must "
                    f"fit one chunk; raise prefill_chunk "
                    f"({self.scfg.prefill_chunk}) or lower draft_len")
        if (layout == "slab" and not self._exact
                and self.scfg.prefill_len > self.scfg.max_len):
            raise ValueError("prefill_len exceeds max_len")
        self.layout = layout
        self.cfg = cfg
        self.api = ModelAPI(cfg)
        self.plan = None
        if rules is not None and mesh is None:
            mesh = rules.mesh
        if mesh is not None:
            from repro_torch.dist.serving import ServePlan
            from repro_torch.dist.sharding import Rules

            self.plan = ServePlan(
                cfg, rules or Rules(mesh, cfg.param_sharding), params,
                max_batch=self.scfg.max_batch, layout=layout,
                check_ranks=check_ranks)
            params, device = self.plan.params, self.plan.device
        self.rules = None if self.plan is None else self.plan.rules
        self.params = params
        self.device = resolve_device(device)
        self._key = prng_key(self.scfg.seed, self.device)
        if layout == "slab":
            self._prefill = make_serve_prefill_step(
                cfg, cache_len=self.scfg.max_len)
            self._decode = make_serve_decode_step(cfg)
        self.reset()

    def reset(self) -> None:
        """Fresh scheduler, pool, index and trace state."""
        B = self.scfg.max_batch
        self._tok = np.zeros((B,), np.int32)
        self._pos = np.zeros((B,), np.int32)
        self._rid = np.zeros((B,), np.int64)  # each slot's request id
        self._arrivals: list = []
        self._arrival_seq = itertools.count()
        self._finished: List[Request] = []
        self._trace: List[StepTrace] = []
        self._step_idx = 0
        self._preempted = 0
        # Prefix-cache state (None / zeros when the cache is off).
        self._prefix: Optional[PrefixIndex] = None
        self._ns: dict = {}                         # slot -> trie namespace
        self._start: dict = {}                      # slot -> prefill offset
        self._n_indexed = np.zeros((B,), np.int32)  # full pages registered
        self._prefill_total = 0
        self._prefill_skipped = 0
        self._pages_shared = 0
        self._cow = 0
        self._draft_total = 0     # draft tokens proposed
        self._draft_accepted = 0  # draft tokens accepted by verification
        if self.layout == "slab":
            self.sched = Scheduler(B)
            self._slab = (
                pool_ops.init_slab(self.cfg, B, self.scfg.max_len,
                                   device=self.device)
                if self.plan is None
                else self.plan.init_slab(B, self.scfg.max_len))
            return
        self._pool = pool_ops.PagePool(self.scfg.pool_pages,
                                       self.scfg.page_size)
        if self.scfg.prefix_cache:
            self._prefix = PrefixIndex(self._pool, self.scfg.page_size)
            self.sched = PagedScheduler(
                B, self._pool, acquire=self._acquire_paged,
                on_shortfall=self._admission_preempt)
        else:
            self.sched = PagedScheduler(
                B, self._pool, self._admission_pages,
                on_shortfall=self._admission_preempt)
        self._cache = (
            self.api.init_paged_cache(B, self.scfg.pool_pages,
                                      self.scfg.page_size, device=self.device)
            if self.plan is None
            else self.plan.init_paged_cache(self.scfg.pool_pages,
                                            self.scfg.page_size))
        self._ptab = np.full((B, self.scfg.max_pages), -1, np.int32)
        self._stream = {}
        self._admit_seq = np.zeros((B,), np.int64)
        self._admit_counter = itertools.count(1)

    # ------------------------------------------------------------------ #
    def _admission_pages(self, req: Request) -> int:
        """Pages the pending prefill stream needs (prompt + any tokens
        generated before a preemption)."""
        return self._pool.pages_for(len(req.prompt) + len(req.tokens))

    def _media_ns(self, req: Request):
        """Prefix-index namespace: an enc-dec request's decoder K/V
        depend on its encoder input, so only requests with bitwise
        identical media share pages (the sha1 of the media bytes; None
        for token-only requests)."""
        if req.media is None:
            return None
        return hashlib.sha1(np.ascontiguousarray(
            np.asarray(req.media)).tobytes()).digest()

    def _acquire_paged(self, slot: int, req: Request) -> bool:
        """Prefix-cache admission: map the stream's longest cached
        page-aligned prefix into ``slot`` (refcounted ``pool.share``),
        charge the budget only for the uncached tail (evicting LRU index
        entries if short), and stage the prefill offset. A stream whose
        every page is cached copy-on-writes its final page and re-feeds
        its last token. All-or-nothing: on a shortfall every mapping is
        rolled back and admission falls back to the cache-off
        allocation, so the cache never admits less than the cache-off
        engine would."""
        stream = list(req.prompt) + list(req.tokens)
        S = len(stream)
        ps = self.scfg.page_size
        need_total = self._pool.pages_for(S)
        cached = self._prefix.lookup(stream, self._media_ns(req))
        k = len(cached)
        full_match = k > 0 and k * ps == S
        need_new = 1 if full_match else need_total - k
        if k:
            self._pool.share(slot, cached)  # pins them against evict
        if self._pool.free_pages < need_new:
            self._prefix.evict(need_new - self._pool.free_pages)
        ok = self._pool.free_pages >= need_new
        if ok and full_match:
            src, dst = self._pool.cow(slot, k - 1)
            pool_ops.copy_pages(self._cache, [src], [dst])
            self._cow += 1
        elif ok and need_new:
            self._pool.alloc(slot, need_new)
        if not ok:
            self._pool.free_slot(slot)
            if not self._pool.alloc(slot, need_total):
                return False
            k = full_match = 0
        start = S - 1 if full_match else k * ps
        self._start[slot] = start
        self._prefill_total += S
        self._prefill_skipped += start
        self._pages_shared += k
        return True

    def _register(self, slot: int, req: Request) -> None:
        """Index every complete page ``slot`` has written (fed tokens are
        always ``(prompt + tokens)[:pos]``); first writer wins."""
        ps = self.scfg.page_size
        full = int(self._pos[slot]) // ps
        if full <= int(self._n_indexed[slot]):
            return
        seq = (list(req.prompt) + list(req.tokens))[:full * ps]
        self._prefix.insert(seq, self._pool.slot_pages(slot)[:full],
                            self._ns.get(slot))
        self._n_indexed[slot] = full

    def submit(self, req: Request) -> None:
        """Register a request; it enters the queue at ``req.arrival_step``.
        An enc-dec arch requires ``media``; the paged layout refuses
        decoder-side media (a token-only stack's)."""
        if self.cfg.is_encdec and req.media is None:
            raise ValueError(
                f"request {req.id}: enc-dec arch {self.cfg.name} requires "
                f"media (encoder frames of shape (enc_source_len, d_model))")
        n_media = self._n_media(req)
        if n_media + req.prompt_len + req.max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"request {req.id}: media+prompt+generation "
                f"({n_media}+{req.prompt_len}+{req.max_new_tokens}) "
                f"exceeds max_len={self.scfg.max_len}")
        if self.layout == "paged":
            if req.media is not None and not self.cfg.is_encdec:
                raise ValueError(
                    f"request {req.id}: the paged layout feeds token ids "
                    f"only; decoder-side media needs kv_layout='slab'")
            need = self._pool.pages_for(req.prompt_len + req.max_new_tokens)
            if need > self.scfg.pool_pages:
                raise ValueError(
                    f"request {req.id}: needs {need} pages but the pool has "
                    f"{self.scfg.pool_pages}; raise n_pages or shrink the "
                    f"request")
        else:
            if not self._exact and req.prompt_len > self.scfg.prefill_len:
                raise ValueError(
                    f"request {req.id}: prompt_len {req.prompt_len} exceeds "
                    f"prefill_len={self.scfg.prefill_len}")
            pad_to = req.prompt_len if self._exact else self.scfg.prefill_len
            if n_media + pad_to > self.scfg.max_len:
                raise ValueError(
                    f"request {req.id}: media+padded prompt "
                    f"({n_media}+{pad_to}) exceeds "
                    f"max_len={self.scfg.max_len}")
        heapq.heappush(
            self._arrivals, (req.arrival_step, next(self._arrival_seq), req))

    def run(self) -> ServeReport:
        """Step until every submitted request has finished; the engine is
        reset on return, so a reused engine reports each workload apart."""
        t0 = time.perf_counter()
        self.drain()
        return self.finalize(t0)

    @property
    def current_step(self) -> int:
        """The step index the next :meth:`step` runs as."""
        return self._step_idx

    @property
    def finished(self) -> List[Request]:
        """Requests retired so far in the current run (cleared by
        :meth:`finalize` and :meth:`reset`): drivers that step the engine
        themselves, such as a fleet replica, read it between steps."""
        return self._finished

    def drain(self) -> None:
        """Step until no submitted request remains unfinished, without
        building a report (issue-on-completion drivers drain per
        request and call :meth:`finalize` once)."""
        while self._arrivals or self.sched.has_work:
            self.step()

    def finalize(self, t0: float) -> ServeReport:
        """Build the run's report (elapsed since ``t0``) and reset."""
        report = ServeReport(
            requests=list(self._finished),
            steps=list(self._trace),
            elapsed_s=time.perf_counter() - t0,
            preemptions=self._preempted,
            prefix_hit_rate=(
                self._prefill_skipped / max(self._prefill_total, 1)
                if self._prefix is not None else None),
            pages_shared=self._pages_shared,
            prefill_tokens_skipped=self._prefill_skipped,
            cow_copies=self._cow,
            spec_accept_rate=(
                self._draft_accepted / max(self._draft_total, 1)
                if self._drafter is not None else None),
            draft_tokens=self._draft_total,
            draft_accepted=self._draft_accepted,
        )
        self.reset()
        return report

    def step(self) -> None:
        """One scheduling round: arrivals -> admissions -> batched step
        (a chunk step on the paged layout, a decode step on the slab)."""
        while self._arrivals and self._arrivals[0][0] <= self._step_idx:
            _, _, req = heapq.heappop(self._arrivals)
            if req.t_arrival is None:
                req.t_arrival = time.perf_counter()
                req.s_arrival = self._step_idx
            self.sched.submit(req)
        paged = self.layout == "paged"
        for slot, req in self.sched.admit():
            (self._admit_paged if paged else self._admit_slab)(slot, req)
        if self.sched.n_active:
            (self._chunk_once if paged else self._decode_once)()
        self._step_idx += 1

    def defrag(self) -> None:
        """Compact the page pool; page tables (and the prefix index) are
        rewritten and decode output is unchanged."""
        if self.layout != "paged":
            raise ValueError("defrag is a paged-layout operation")
        perm = self._pool.defrag()
        pool_ops.apply_defrag(self._cache, perm)
        if self._prefix is not None:
            self._prefix.remap(pool_ops.PagePool.remap_from_perm(perm))
        for slot in range(self.scfg.max_batch):
            self._ptab[slot] = self._pool.table_row(slot, self.scfg.max_pages)

    # ------------------------------------------------------------------ #
    def _n_media(self, req: Request) -> int:
        """Positions the media occupy in the decoder stream: none for an
        enc-dec arch, whose media feed the encoder."""
        if req.media is None or self.cfg.is_encdec:
            return 0
        return int(np.asarray(req.media).shape[0])

    def _preempt_slot(self, victim: int) -> None:
        """Evict ``victim`` to its band's queue front; the scheduler frees
        its pages. With the prefix cache on, the victim later resumes
        through the index and rediscovers its own surviving pages."""
        self.sched.preempt(victim)
        self._ptab[victim] = -1
        self._stream.pop(victim, None)
        self._ns.pop(victim, None)
        self._n_indexed[victim] = 0
        self._preempted += 1

    def _admission_preempt(self, req: Request) -> bool:
        """SLO-aware admission hook: evict one staged running request of
        a strictly lower class with more slack, if any."""
        staged = [(s, r) for s, r in self.sched.running()
                  if self._ptab[s, 0] >= 0]
        victim = slo.admission_victim(
            req, staged, self._step_idx,
            {s: int(self._admit_seq[s]) for s, _ in staged})
        if victim is None:
            return False
        self._preempt_slot(victim)
        return True

    def _admit_paged(self, slot: int, req: Request) -> None:
        """Stage the prefill stream from its first uncached token; the
        scheduler reserved (or shared) its pages. An enc-dec request's
        encoder and cross K/V run here, into the slot's cross slab,
        traced as an ``"encode"`` step."""
        stream = list(req.prompt) + list(req.tokens)
        start = self._start.pop(slot, 0)
        self._stream[slot] = stream[start:]
        self._pos[slot] = start
        self._rid[slot] = req.id
        self._admit_seq[slot] = next(self._admit_counter)
        self._ptab[slot] = self._pool.table_row(slot, self.scfg.max_pages)
        if self._prefix is not None:
            self._ns[slot] = self._media_ns(req)
            self._n_indexed[slot] = start // self.scfg.page_size
        if self.cfg.is_encdec:
            t0 = time.perf_counter()
            with torch.inference_mode():
                frames = torch.tensor(np.asarray(req.media))[None]
                place, _ = self._place(rows=False)
                kv = self.api.encode_cross(self.params,
                                           frames.to(self.device), place)
                if self.plan is None:
                    pool_ops.write_slot(self._cache["cross"], kv, slot)
                else:
                    self.plan.write_cross(self._cache["cross"], kv, slot)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self._trace.append(StepTrace(
                "encode", time.perf_counter() - t0, 0,
                pool_util=self._pool.utilization()))

    def _draft(self, active) -> dict:
        """Up to ``draft_len`` proposed tokens for each decode row, capped
        so the fed group fits the chunk and full acceptance plus the
        model's own token never outgrows the request's budget. Rows still
        prefilling, and rows the drafter has nothing for, decode plainly."""
        drafts = {}
        k_max = min(self.scfg.draft_len, self.scfg.prefill_chunk - 1)
        for slot in sorted(active):
            if self._stream.get(slot):
                continue
            req = active[slot]
            k = min(k_max, req.max_new_tokens - len(req.tokens) - 1)
            if k <= 0:
                continue
            ctx = list(req.prompt) + list(req.tokens)
            d = list(self._drafter.propose(ctx, k))[:k]
            if d:
                drafts[slot] = [int(t) for t in d]
        return drafts

    def _chunk_once(self) -> None:
        """One mixed dispatch: decode rows advance one token (plus any
        verified drafts), prefilling rows up to ``prefill_chunk`` prompt
        tokens."""
        C = self.scfg.prefill_chunk
        B = self.scfg.max_batch
        active = dict(self.sched.running())
        spec = self._drafter is not None
        drafts = self._draft(active) if spec else {}

        # Lazy decode growth; when the pool runs dry, shed drafts first,
        # then drop cold prefix-cache entries, then preempt.
        while active:
            growth = {}
            for slot in active:
                if self._stream.get(slot):
                    continue  # prefill pages were reserved at admission
                want = int(self._pos[slot]) + 1 + len(drafts.get(slot, ()))
                need = (self._pool.pages_for(want)
                        - len(self._pool.slot_pages(slot)))
                if need > 0:
                    growth[slot] = need
            shortfall = sum(growth.values()) - self._pool.free_pages
            if shortfall <= 0:
                for slot in growth:
                    self._pool.ensure(
                        slot,
                        int(self._pos[slot]) + 1 + len(drafts.get(slot, ())))
                break
            if drafts:
                drafts.pop(sorted(drafts)[0])  # degrade, deterministically
                continue
            if self._prefix is not None and self._prefix.evict(shortfall):
                continue
            victim = slo.choose_victim(
                active, self._step_idx,
                {s: int(self._admit_seq[s]) for s in active})
            self._preempt_slot(victim)
            active.pop(victim)
            drafts.pop(victim, None)
        if not active:
            return

        # Idle rows feed n_valid=1 against an all -1 page-table row.
        toks = np.zeros((B, C), np.int32)
        nv = np.ones((B,), np.int32)
        posb = np.zeros((B,), np.int32)
        prefilling = False
        for slot in active:
            posb[slot] = self._pos[slot]
            stream = self._stream.get(slot)
            if stream:
                n = min(C, len(stream))
                toks[slot, :n] = stream[:n]
                nv[slot] = n
                prefilling = True
            else:
                toks[slot, 0] = self._tok[slot]
                d = drafts.get(slot)
                if d:
                    toks[slot, 1:1 + len(d)] = d
                    nv[slot] = 1 + len(d)
            self._ptab[slot] = self._pool.table_row(slot, self.scfg.max_pages)

        t0 = time.perf_counter()
        dev = self.device
        with torch.inference_mode():
            pos_d = torch.from_numpy(posb).to(dev)
            nv_d = torch.from_numpy(nv).to(dev)
            rid_d = self._rows(self._rid)
            place, r = self._place(rows=True)
            logits, self._cache = self.api.decode_chunk(
                self.params, torch.from_numpy(toks).to(dev),
                self._cache, torch.from_numpy(self._ptab).to(dev),
                pos_d, nv_d, full_logits=spec, place=place)
            # spec: (B, C) greedy targets, the model's next token after
            # each fed position; plain: (B,), the token drawn after the
            # last fed one, at position posb + nv.
            if spec:
                nxt = torch.argmax(logits, dim=-1)
            else:
                nxt = self._sample(logits, _cut(rid_d, r), pos_d[r], nv_d[r])
            nxt = self._emit(nxt).cpu().numpy()
        dt = time.perf_counter() - t0

        produced = 0
        for slot, req in active.items():
            n = int(nv[slot])
            stream = self._stream.get(slot)
            d = drafts.get(slot)
            if stream or not d:
                self._pos[slot] += n
                if self._prefix is not None:
                    self._register(slot, req)
                if stream:
                    self._stream[slot] = stream[n:]
                    if self._stream[slot]:
                        continue  # mid-prompt: logits not sampled yet
                emit = [int(nxt[slot, n - 1] if spec else nxt[slot])]
            else:
                k = len(d)
                a = 0
                while a < k and d[a] == int(nxt[slot, a]):
                    a += 1
                emit = [int(nxt[slot, i]) for i in range(a + 1)]
                self._draft_total += k
                self._draft_accepted += a
                # Rejected positions hold stale draft K/V past the new
                # n_valid limit; attention never reads them, and the real
                # tokens overwrite them when those positions are fed.
                self._pos[slot] += a + 1
            alive = True
            for tok in emit:
                req.tokens.append(tok)
                produced += 1
                if req.t_first_token is None:
                    req.t_first_token = time.perf_counter()
                    req.s_first_token = self._step_idx
                self._tok[slot] = tok
                if req.done or tok == self.scfg.eos_id:
                    self._retire_paged(slot, req)
                    alive = False
                    break
            if d and not stream and alive and self._prefix is not None:
                # after the accepted tokens joined req.tokens: every
                # position below _pos is now a verified token
                self._register(slot, req)
        self._trace.append(StepTrace(
            "mixed" if prefilling else "decode", dt, produced,
            pool_util=self._pool.utilization()))

    def _retire_paged(self, slot: int, req: Request) -> None:
        self.sched.retire(slot)  # frees the slot's pages too
        self._ptab[slot] = -1
        self._stream.pop(slot, None)
        self._ns.pop(slot, None)
        self._n_indexed[slot] = 0
        req.t_done = time.perf_counter()
        req.s_done = self._step_idx
        self._finished.append(req)

    # ---- slab layout --------------------------------------------------- #
    def _admit_slab(self, slot: int, req: Request) -> None:
        """Prefill ``req`` (padded to ``prefill_len`` unless the stack is
        recurrent; an enc-dec request's media encoded) into ``slot``;
        samples its first token."""
        P = req.prompt_len
        end = self._n_media(req) + P
        pad_to = P if self._exact else self.scfg.prefill_len
        toks = np.zeros((1, pad_to), np.int64)
        toks[0, :P] = req.prompt
        dev = self.device
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if req.media is not None:
            batch["media"] = torch.tensor(np.asarray(req.media))[None].to(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            place, _ = self._place(rows=False)
            logits, cache = self._prefill(
                self.params, batch,
                torch.full((1,), end - 1, dtype=torch.long, device=dev),
                place)
            pool_ops.invalidate_beyond(cache,
                                       torch.full((1,), end, device=dev))
            if self.plan is None:
                pool_ops.write_slot(self._slab, cache, slot)
            else:
                self.plan.write_slot(self._slab, cache, slot)
            tok = int(self._emit(self._sample(logits, req.id, end),
                                 rows=False)[0])
        dt = time.perf_counter() - t0

        req.tokens.append(tok)
        req.t_first_token = time.perf_counter()
        req.s_first_token = self._step_idx
        self._trace.append(StepTrace("prefill", dt, 1))
        if req.done or tok == self.scfg.eos_id:
            self._retire_slab(slot, req)
        else:
            self._tok[slot] = tok
            self._pos[slot] = end
            self._rid[slot] = req.id

    def _decode_once(self) -> None:
        """Advance every occupied slot by one token (one decode step over
        all slots; idle ones compute garbage in their own rows)."""
        dev = self.device
        t0 = time.perf_counter()
        with torch.inference_mode():
            pos_d = torch.from_numpy(self._pos).to(dev)
            rid_d = self._rows(self._rid)
            place, r = self._place(rows=True)
            logits, self._slab = self._decode(
                self.params, torch.from_numpy(self._tok[:, None]).to(dev),
                self._slab, pos_d, place)
            # the fed token sits at _pos; the drawn one at _pos + 1
            next_tok = self._emit(self._sample(
                logits, _cut(rid_d, r), pos_d[r], 1)).cpu().numpy()
        dt = time.perf_counter() - t0

        running = self.sched.running()
        for slot, req in running:
            tok = int(next_tok[slot])
            req.tokens.append(tok)
            self._tok[slot] = tok
            self._pos[slot] += 1
            if req.done or tok == self.scfg.eos_id:
                self._retire_slab(slot, req)
        self._trace.append(StepTrace("decode", dt, len(running)))

    def _retire_slab(self, slot: int, req: Request) -> None:
        self.sched.retire(slot)
        req.t_done = time.perf_counter()
        req.s_done = self._step_idx
        self._finished.append(req)

    # ------------------------------------------------------------------ #
    def _place(self, *, rows: bool):
        """(the program's placement on the mesh, the slots this rank
        computes): (None, every slot) on one device."""
        if self.plan is None:
            return None, slice(None)
        place = self.plan.placement(rows=rows)
        return place, (place.rows if place.rows is not None
                       else slice(None))

    def _emit(self, tok, rows: bool = True):
        """A step's tokens of every slot from this rank's (on a mesh;
        ``rows`` False: a prefill's, which every rank computes)."""
        return tok if self.plan is None else self.plan.emit(tok, rows)

    def _rows(self, ids: np.ndarray):
        """Per-slot request ids on the device when sampling (uploaded
        before the step's kernels are queued), else None."""
        if self.scfg.temperature <= 0.0:
            return None
        return torch.from_numpy(ids).to(self.device)

    def _sample(self, logits, rid, pos, ahead=0):
        """Greedy at ``temperature <= 0``; else one draw a row from the
        key ``fold_in(fold_in(key, rid), pos + ahead)``, the drawn token's
        position (the reference's ``Engine._sample``). ``rid``, ``pos``
        and ``ahead`` are ints (prefill, one row) or (B,) tensors on the
        logits' device, so the keys are made there and the draw adds no
        host sync."""
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        B = logits.shape[0]

        def rows(x):
            if torch.is_tensor(x):
                return x.to(torch.int64).expand(B)
            return torch.full((B,), int(x), dtype=torch.int64,
                              device=logits.device)

        keys = fold_in(fold_in(self._key, rows(rid)), rows(pos) + rows(ahead))
        return sample(keys, logits, self.scfg.temperature)


def _cut(t, rows):
    return None if t is None else t[rows]


def synthetic_requests(cfg, *, n: int, tokens: int, prompt_len: int,
                       scenario: str = "offline", seed: int = 0,
                       arrival_rate: float = 0.5,
                       prompt_lens: Optional[Sequence[int]] = None,
                       shared_prefix_len: int = 0, n_templates: int = 1,
                       suffix_spread: Optional[Sequence[int]] = None,
                       ) -> List[Request]:
    """Synthetic workload, byte-identical to the reference's
    ``synthetic_requests`` for a token-only arch, ids from
    ``np.random.RandomState(seed)``. An enc-dec arch's requests carry
    media, (enc_source_len, d_model) fp32 standard-normal frames a
    request, a vision arch's (n_media_tokens, d_model) patch embeddings;
    one array per template when ``shared_prefix_len > 0``
    (same-template requests share it, so the prefix cache can match
    them). The reference draws them with ``jax.random.normal`` from key
    ``seed + i``; here they come from ``np.random.default_rng((seed,
    i))``, so the values differ (parity tests give both engines the
    reference's media).

    ``prompt_lens`` cycles explicit lengths, else each length is drawn
    from ``[prompt_len // 2, prompt_len]``. ``shared_prefix_len > 0``
    opens request ``i`` with template ``i % n_templates`` (a fixed
    prefix of that many tokens, also the request's ``template`` key)
    followed by a private suffix of ``suffix_spread`` cycled lengths, or
    ``max(1, prompt_len - shared_prefix_len)`` tokens. Any scenario but
    offline stamps Poisson arrivals at ``arrival_rate`` requests a step,
    drawn after every prompt, so prompts do not depend on the scenario.
    """
    if shared_prefix_len < 0 or n_templates < 1:
        raise ValueError("shared_prefix_len >= 0 and n_templates >= 1")
    rng = np.random.RandomState(seed)
    templates = [rng.randint(0, cfg.vocab, size=shared_prefix_len).tolist()
                 for _ in range(n_templates)] if shared_prefix_len else []
    reqs = []
    for i in range(n):
        if shared_prefix_len:
            if suffix_spread:
                s_len = max(1, int(suffix_spread[i % len(suffix_spread)]))
            else:
                s_len = max(1, prompt_len - shared_prefix_len)
            prompt = (templates[i % n_templates]
                      + rng.randint(0, cfg.vocab, size=s_len).tolist())
            template = tuple(templates[i % n_templates])
        else:
            template = None
            if prompt_lens:
                p_len = max(1, int(prompt_lens[i % len(prompt_lens)]))
            else:
                lo = max(1, min(prompt_len // 2, prompt_len))
                p_len = int(rng.randint(lo, max(lo + 1, prompt_len + 1)))
            prompt = rng.randint(0, cfg.vocab, size=p_len).tolist()
        req = Request(prompt=prompt, max_new_tokens=tokens,
                      template=template)
        n_media = (cfg.enc_source_len if cfg.is_encdec else
                   cfg.n_media_tokens if cfg.frontend == "vision_patches"
                   else 0)
        if n_media:
            media_key = i % n_templates if shared_prefix_len else i
            req.media = np.random.default_rng((seed, media_key)).standard_normal(
                (n_media, cfg.d_model)).astype(np.float32)
        reqs.append(req)
    if scenario != "offline":
        from repro_torch.serve.scenarios import poisson_arrivals

        for r, a in zip(reqs, poisson_arrivals(rng, n, arrival_rate)):
            r.arrival_step = int(a)
    return reqs
