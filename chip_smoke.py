#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repository root, one NVIDIA card

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. card and build: prints the card's name and power limit, builds every
   CUDA kernel of the port from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
2. kernels: holds each kernel against its plain PyTorch version on the
   card at the shapes its path gives it (paged attention at the serving
   chunk's, from bf16/fp32 pools and through its int8 and int4
   branches, and at the edges of its key splits, each rerun bitwise
   equal; flash attention forward and backward at the train step's and
   at edge cases of its tiles, the backward rerun bitwise equal; the
   LSTM cell forward (with and without its saved gates) and backward
   (dgates, dc_prev, dx, db; reruns bitwise) at GNMT's shape and at edge
   cases, the two LARS kernels in both rules at ResNet-50's largest leaf
   and at edge cases, zero norms among them, and each kernel's one
   launch over ResNet-50's 54 kernel leaves (bitwise equal to one-leaf
   launches), the Mamba selective scan at jamba's prefill shape and at
   S 2048 with bf16 and fp32 inputs (the reference's tolerance), at odd
   shapes, N = 64, odd N, S = 1 and strided B/C, and at jamba's train
   shape (1 x 2048 x 16384 x 16) with its boundary states every 16
   steps, the scan's backward kernel there and at edge cases (S 1, 33,
   2047, N 5, 64, Bt 3, fp32 u, contiguous B/C, a last block partly
   filled, a zero and a nonzero final-state cotangent, reruns bitwise;
   its registers, blocks an SM and waves printed), the
   flash forward at jamba's attention shape and forward and backward at
   its train step's (B 1, S 2048, 64/8 heads of 128), the paged
   kernel at the serving shapes of yi-9b, qwen1.5-32b (int8 pool),
   command-r-35b, mixtral-8x7b and grok-1-314b, and the flash forward
   and backward at the train step's shape with 32/4 and 48/8 heads of
   128), and times the kernel, the plain version, one PyTorch library
   call computing the same function where there is one, and the least
   time the card could take (its bound); for the paged kernel and the
   flash backward also the device time of each launch they make
   (profiler), and for the paged wrapper its host enqueue time and
   key-split count;
3. checks: reduced gemma-7b in fp32 on the card against the CPU's
   plain path, serving (logits and greedy tokens; and from int8 and
   int4 pools with the prefix cache and speculative decoding, which
   must also equal the card's tokens with both off) and training (the
   loss of 3 steps from the same weights and batches); reduced GNMT in
   fp32, card against CPU: loss, every gradient, 3 Adam steps; reduced
   ResNet (stride-2 stem and max pool at 32 x 32) in fp32, card against
   CPU: loss, every gradient, 3 LARS steps of each rule; reduced
   jamba-1.5-large in fp32 from the same ``params_from_numpy`` weights,
   card against CPU: prefill logits and a slab engine's greedy tokens,
   then training: the loss, every gradient and 3 Adam steps;
4. serve: full-width gemma-7b (28 layers, random bf16 weights from a
   seed) serves 8 ragged requests offline through the port's engine;
   the kernel's launch counter, zeroed just before, must show it ran
   in every layer of every chunk step, and a second run must give the
   same tokens. Then the same model serves a server-scenario stream of
   shared-prefix requests from an int8 pool with the prefix cache and
   n-gram speculative decoding (the int8 branch must run in every layer
   of every chunk step, the cache must hit, drafts must be proposed, a
   second run must repeat, a replay drafter must get drafts accepted),
   beside the same stream from a bf16 pool for comparison, and then
   offline from an int4 pool (the int4 branch in every layer of every
   chunk step). Then jamba-1.5-large at full width cut to 3 layers (a
   Mamba + dense, a Mamba + MoE and an attention + dense layer; 12.9 B
   random bf16 parameters) serves the same 8 ragged requests from the
   slot slab: the counters, zeroed just before, must show mamba_scan in
   both Mamba layers of every prefill (16) and the flash forward once a
   prefill (8); a second run must give the same tokens; one prefill and
   one decode step are traced. Then (``serve-sample``) the 28-layer
   model serves the 8 ragged requests at temperature 0.8 and greedy:
   the port's threefry on the card gives the published known answers
   and the key words JAX gives, keys and draws bitwise equal to the
   CPU's; the paged kernel runs in every layer of every sampled chunk
   step, a second sampled run repeats the tokens, 65,536 keys at one
   position draw from fp32 logits within a total variation of 0.02 of
   softmax over 32 bins of equal mass, where a greedy, a uniform and a
   temperature-blind sampler each read more than that, and the
   sampler's device time and kernels a call are read;
5. train: full-width gemma-7b cut to 8 layers (fp32 masters, gradients
   and Adam moments, bf16 compute, remat) takes 4 steps of batch 4 x
   2048 tokens through ``Trainer.fit`` and one eval; the flash kernels'
   counters, zeroed just before, must show every layer's attention went
   through them (forward twice per layer per step, with the remat
   recompute, and once per layer per eval batch; backward once per
   layer per step), and a second run from the same seed must give the
   same losses. Then (``train-resume``) the same model cut to 1 layer
   (two checkpoints of 12.7 GB in the temporary directory) takes 6
   steps from the streaming pipeline through the
   double buffer with async checkpoints at steps 3 and 6, and a fresh
   trainer resumed from step 3 takes steps 4-6: its losses and final
   state must equal the first run's bitwise, both checkpoints and a sync
   save must read back equal to the state, and the flash counters must
   show the resumed steps went through the kernels;
6. train GNMT: full width (F 1024, 4 + 4 layers, vocab 32000, bf16
   compute, random weights from seed 0) takes 6 steps of batch 128 of
   bucketized copy-task sentences (4-50 tokens, window 6) through
   ``repro_torch.launch.gnmt.train``; the LSTM kernels' counters, zeroed
   just before, must show 5L + 4L*r forward and 9L backward launches in
   each step of padded length L (r = 2 when the decoder's scan chunks
   and recomputes); one step traced; then, reported and not gated, the
   encoder's forward hoisted against in-loop (C9) at batch 2 and 128,
   and one LSTM layer against cuDNN's ``torch.nn.LSTM``;
7. train ResNet-50: full width (224 x 224, 1000 classes, bf16 compute,
   fp32 masters, random weights from seed 0) takes 6 steps of batch 128
   under scaled LARS and 2 under unscaled LARS through
   ``repro_torch.launch.resnet.train``, then sweeps a padded eval set;
   the LARS kernels' counters, zeroed just before, must show one norms
   launch and one update launch over the 54 kernel leaves in every
   step; one step traced; a second run must repeat the losses bitwise;
8. serve the new archs (``serve-archs``): yi-9b, qwen1.5-32b,
   command-r-35b, mixtral-8x7b and grok-1-314b reduced in fp32, card
   against CPU (the same greedy tokens from the same numpy weights),
   then each at every published width, as deep as free memory holds
   (bf16 weights from seed 0), serving the 8 ragged requests offline
   from its config's pool (qwen's int8): the paged kernel's counter,
   zeroed just before, must show one launch per layer per chunk step,
   a second run must repeat the tokens, and one 8 x 8 chunk step is
   timed and traced; the card is freed between archs;
9. train the new archs (``train-archs``): each at full width cut in
   depth (yi 8, qwen 2, command-r 1, mixtral 2, grok 1 layer, grok also
   to 4 of its 8 experts, with its 4 microbatches and bf16 gradients and
   moments) takes 4 steps of batch 4 x 2048 through ``Trainer.fit``:
   the flash counters must show forward twice and backward once per
   layer per step and microbatch, and a second run from the same seed
   must repeat the losses bitwise;
10. train jamba-1.5-large (``train-jamba``): every published width, cut
   to a Mamba + dense, a Mamba + MoE (4 of 16 experts) and an attention
   + dense layer as far as free memory holds (the reckoning is printed),
   takes 4 steps of batch 8 x 2048 in its 8 microbatches (bf16 gradient
   sums and moments, fp32 masters, remat) through ``Trainer.fit``: the
   counters, zeroed just before, must show per step mamba_scan forward
   32 and backward 16, flash forward 16 and backward 8, and a second run
   from the same seed must repeat the losses bitwise;
11. whisper-medium, the encoder-decoder (``kernels-whisper``,
   ``check-whisper``, ``serve-whisper``, ``train-whisper``): the flash
   forward and backward at its encoder's (1500 x 1500 non-causal, B 1
   and 8), cross-attention's (448 x 1500) and decoder's (448 causal)
   shapes, 16/16 heads of 64, and the paged kernel at D 64, G 1 from
   bf16 and int8 pools, each against its plain version and timed; the
   reduced model card against CPU (logits, loss, every gradient, the
   paged, int8 and slab engines' tokens); then every published width
   and depth (24 + 24 layers, 0.81 B random bf16 parameters) serves
   stream (a), each request with its own frames (the flash counter must
   show the encoder once per layer per admission at B 1, the paged
   counter once per decoder layer per chunk step), and stream (b) from
   bf16 and int8 pools with the prefix cache and n-gram drafts, each
   repeated with the same tokens, one chunk step traced; and trains 4
   steps of batch 8 x (1500 frames, 448 tokens) through
   ``Trainer.fit`` (flash forward 2 x 24 and backward 24 per step at
   each of the three shapes), a second run's losses bitwise equal;
12. qwen2-vl-7b, the VLM, and rwkv6-3b, RWKV-6 (``kernels-vlm``,
   ``check-vlm``, ``check-rwkv``, ``serve-vlm``, ``serve-rwkv``,
   ``train-vlm``, ``train-rwkv``): the flash forward and backward at the
   VLM's 28/4 heads of 128 (G 7), causal, at its prefill (B 1, 1024
   media + 128 prompt positions) and train step (B 4 x 2048, half of it
   media) in bf16, and at B 2, S 200 in fp32, each against its plain
   version and timed; both reduced models card against CPU (prefill
   logits with media, loss, every gradient, the slab engine's tokens, 3
   Adam steps); then every published width and depth serving stream (a)
   from the slab, each VLM request with its own 1024 x 3584 media (the
   flash forward 28 times an admission asserted), a second run equal,
   one prefill and one decode step traced; and training 4 steps of
   batch 4 x 2048 through ``Trainer.fit``, the VLM cut to 8 layers (2
   flash forwards and 1 backward a layer a step asserted), rwkv6 to 4
   (its wkv loop is plain PyTorch, host-bound), a second run's losses
   bitwise equal (2 steps; rwkv6's 1);
13. the MLPerf Transformer, SSD and Mask R-CNN (``kernels-transformer``,
   ``check-mlperf``, ``train-transformer``, ``train-ssd``,
   ``train-maskrcnn``), through ``repro_torch.launch.mlperf`` (fig9's
   step: the gradient, then Adam at 1e-3): the flash forward and
   backward at the Transformer's 16/16 heads of 64, B 32, bf16, at S 97
   (the paper's truncation) and 256, the encoder's and cross-attention's
   non-causal shape and the decoder's causal one, each against its plain
   version and timed; the cross-attention over a shorter source and fp32
   at S 97 held; the three tiny configs in fp32 card against CPU (loss,
   every gradient, 3 Adam steps; TF32 off); then each published config
   uncut (fp32 masters and moments, bf16 compute): the Transformer 4
   steps of batch 32 at S 97 and at 256 (flash forward 2 x 6 and
   backward 6 a step at each attention's shape asserted), SSD at 300 x
   300, batch 32, Mask R-CNN at 128 x 128, batch 16, each 4 steps with
   cuDNN deterministic, one step traced, a second run's losses bitwise
   equal;
14. the paper's distribution techniques (``dist``) on a 1 x 1
   ("data", "model") mesh over a one-rank NCCL group, full width:
   ResNet-50 with ``bn_group_size=2`` and ``spatial_partition=True``
   (224 x 224, batch 128) through ``loss_fn(mesh=...)``, its gradient, the
   2-D gradient summation (bitwise its input) and
   ``lars_sharded_update`` (one norms and one update launch, counters and
   profiler; bitwise ``optim.lars`` on the same gradients), against the
   one-device step (the loss, the gradient to twice the floor of a 1e-3
   perturbation of the images, the weights after the step), and the two
   LARS kernels over the leaves the rank owns held against their plain
   versions and timed; SSD 300 x 300 batch
   32 spatially partitioned and Mask R-CNN 128 x 128 batch 16 (stage 2
   through ``run_partitioned``) against ``mesh=None``; weight-update-
   sharded Adam over the MLPerf Transformer's 210.7 M parameters, 2
   steps, against ``optim.adam``; ``seq_parallel_swa`` at mixtral-8x7b's
   attention (S 8192, 32/8 heads of 128, window 4096: one flash forward
   launch at k_offset -4096 over a zero halo) against ``ops.attention``
   without the halo, the kernel against its plain version at the halo'd
   shape, timed beside SDPA's memory-efficient backend;
15. the sharded trainer (``dist-train``): yi-9b at full width cut to 8
   layers (1.9 B parameters) in its own mode (``wus``, ``seq_parallel``
   on), batch 4 x 2048, 3 steps, first through the one-device
   ``Trainer`` (losses, grad norms and a few leaves kept on the host, the
   trainer freed), then through ``Trainer(..., mesh=)`` on a 1 x 1
   ("data", "model") mesh over its own one-rank NCCL group, from the same
   seed's weights and the same batches: the losses and leaves bitwise
   equal, the grad norms within 1e-6 relative (summed in another order),
   the flash counters, zeroed just before, at forward twice and backward
   once a layer a step; each trainer's step time, the mesh path's
   overhead and both peak memories printed. The group is destroyed in a
   ``finally``. Then the dry run of that step (``dryrun_step`` on a fake
   1 x 1 world): its argument bytes equal the trainer's rank state plus
   one batch byte for byte, the steps' real peak is at most 1.10 x its
   predicted peak, and the analytic flops over the median step time are
   printed as a share of 989 TFLOP/s;
16. sharded serving (``serve-tp2d``, run after phase 4's serving, on its
   28-layer weights): stream (a) through the one-device engine, then
   through ``Engine(..., rules=Rules(mesh, mode))`` in ``tp2d`` and in
   ``fsdp`` on a 1 x 1 NCCL mesh (destroyed in a ``finally``): greedy
   tokens bitwise the one-device engine's, the paged counter, zeroed
   just before, at 28 a chunk step on every path and the profiler's
   count of its split launches within 1% of it (one device, tp2d; a long
   trace may lose records); tokens/s,
   peak memory and (traced) busy share printed; the paged kernel timed
   at the rank's 16/16 heads (row 1-m);
17. the fleet (``serve-fleet``): two replicas on the one card, sharing
   the weights, serve stream (b) behind the prefix router without
   chaos, with a seeded kill at fleet step 8 and with a stall of 12
   steps (heartbeat timeout 4), then least-loaded (both replicas
   serving): every request id finishes once with a
   one-engine run's greedy tokens, the paged counter shows 28 launches
   a replica chunk step; fleet tokens/s, goodput, routing hit rate,
   kills and evictions printed; the paged kernel timed at a replica's
   chunk shape;
18. the run layer (``run-cli``): ``python -m repro_torch run --full`` in
   subprocesses, as a user types it, at gemma-7b's full width:
   ``runs/serve_prefix.toml`` (``tp2d`` on a 1 x 1 NCCL mesh, prefix
   cache, page 4) with ``--profile --trace`` (the paged counter exactly
   28 a chunk step, the profiler's split count within 1% of it) and
   ``runs/serve_fleet.toml`` (two replicas, a kill at fleet step 6: every
   id once, 28 launches a replica chunk step), each request's tokens
   equal to an in-process one-device engine's on the same spec and seed;
   a ``--mode dryrun`` render of the fleet's manifests; the paged kernel
   timed at serve_prefix's chunk; then ``runs/gemma_7b_train.json`` cut
   to 8 layers, batch 4 x 2048, 3 steps with an eval: the flash
   counters at 2 forwards and 1 backward a layer a step plus a forward a
   layer an eval batch, the losses finite and, with eval_nll, bitwise
   an in-process ``Trainer``'s;
19. the dry run (``dryrun``): ``python -m repro_torch run --mode
   dryrun`` in subprocesses (fake worlds, fake tensors, no card): gemma-7b
   ``train_4k`` on 16 x 16 and yi-9b ``long_500k`` on 2 x 16 x 16, each
   with flops and a peak and no error, printed beside its roofline with
   the H100's constants (``analysis``); the card's ``total_memory``;
   mixtral-8x7b ``train_4k`` on 16 x 16 (the MoE split over its hidden
   units) and jamba-1.5-large ``decode_32k`` on 2 x 16 x 16 (the Mamba
   decode step and the MoE split over its experts) and whisper-medium
   ``train_4k`` on 16 x 16 (the enc-dec on a mesh), all five at once;
20. layers split over ``model`` (``dist-layers``, after phase 4's jamba
   serving, on its weights): the mamba_scan forward (boundary states
   every 16 steps) and backward at jamba's block of one rank of a 16-wide
   ``model`` axis (Bt 1, S 2048, Di 1024, N 16, bf16 u; rows 3-m and
   3b-m), held against their plain versions and timed beside their
   bounds, the grid's blocks printed; then the 3-layer jamba cut serves
   phase 4's workload through ``Engine(..., rules=Rules(mesh, "tp2d"))``
   on a 1 x 1 NCCL mesh (destroyed in a ``finally``): greedy tokens
   bitwise the one-device engine's, the mamba_scan counter, zeroed just
   before, at 2 launches a prefill;
21. the enc-dec on a mesh (``dist-whisper``, after phase 11, held to its
   runs): whisper-medium at every published width and depth on a 1 x 1
   NCCL mesh (destroyed in a ``finally``) trains 2 steps of batch 8 x
   (1500 frames, 448 tokens) in its ``wus`` mode with ``seq_parallel``
   through ``Trainer(cfg, tcfg, mesh=)``: losses bitwise phase 11's
   second run, the flash counters at forward 2 x 24 and backward 24 a
   step at each of the encoder's, cross-attention's and decoder's
   shapes; then serves stream (a) through ``Engine(rules=Rules(mesh,
   "tp2d"))``: greedy tokens bitwise phase 11's, the paged counter at 24
   a chunk step and the encoder's flash at B 1 at 24 an admission; step
   ms, tokens/s and peaks printed beside the one-device runs' (kernel
   rows 2f-wm, 2b-wm, 1-wm).

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``. ``--only mamba,serve-jamba`` (any of
the names in ``PHASES``) runs the named phases alone after the build
and prints no result line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    synthetic_eval_set,
    synthetic_lm_batches,
)
from repro_torch.data import Pipeline, SyntheticShardSource  # noqa: E402
from repro_torch.core import gradient_summation as GS  # noqa: E402
from repro_torch.core import spatial_partitioning as SP  # noqa: E402
from repro_torch.core import weight_update_sharding as WUS  # noqa: E402
from repro_torch.data.bucketization import bucketized_batches  # noqa: E402
from repro_torch.data.pipeline import prefetch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import lars as lk_lars  # noqa: E402
from repro_torch.kernels import lstm_cell as lk  # noqa: E402
from repro_torch.kernels import mamba as mk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.launch import gnmt as gnmt_cli  # noqa: E402
from repro_torch.launch import mlperf as mlperf_cli  # noqa: E402
from repro_torch.launch import resnet as resnet_cli  # noqa: E402
from repro_torch.launch.mesh import single_device_mesh  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import gnmt  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import maskrcnn as maskrcnn_model  # noqa: E402
from repro_torch.models import resnet  # noqa: E402
from repro_torch.models import ssd as ssd_model  # noqa: E402
from repro_torch.models.scan_utils import _largest_divisor_leq  # noqa: E402
from repro_torch.optim import adam, constant, lars, polynomial_warmup  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.configs import InputShape, get_shape  # noqa: E402
from repro_torch.launch.dryrun import dryrun_step, tree_bytes  # noqa: E402
from repro_torch.run import apply_assignments, load_spec_file  # noqa: E402
from repro_torch.run import dispatch as run_dispatch  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine,
    ServeConfig,
    synthetic_requests,
)
from repro_torch.serve import cache as slab_ops  # noqa: E402
from repro_torch.serve.scenarios import run_offline, run_server  # noqa: E402
from repro_torch.serve.speculative import DraftModelDrafter  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.hooks import Hook  # noqa: E402
from repro_torch.utils import (  # noqa: E402
    Stacked,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

# H100 SXM data sheet: HBM rate and dense peaks by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # abs and rel
PROMPT_LENS = (5, 128, 17, 96, 33, 64, 120, 9)  # ragged, in 5..128
NEW_TOKENS = 32
# The quantized serving stream: 2 templates of 96 tokens (6 pages of
# 16), private suffixes of 32, Poisson arrivals at 0.5 a step.
SHARED, SUFFIX, RATE = 96, 32, 0.5
INT4_TOKENS = 16
TRAIN_LAYERS = 8  # 16 B/param of state: 28 layers need 137 GB, 8 take 48
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4
TRAIN_BATCH_JAMBA = 8  # jamba's 8 microbatches, each 1 x 2048
# GNMT: bucketized copy-task sentences of 4-50 tokens, window 6.
GNMT_BATCH, GNMT_MAX_LEN, GNMT_WINDOW, GNMT_STEPS = 128, 50, 6, 6


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


# --------------------------------------------------------------------------- #
# Phase 2: kernel vs plain at the serving shapes.
# --------------------------------------------------------------------------- #
def paged_case(seed, *, B, C, H, K, D, page, npg, dtype, lens, nvs, holes=()):
    """Page tables as the engine builds them (contiguous from page 0,
    -1 past a row's length), plus optional unmapped holes; the last
    row is idle (n_valid 1, nothing mapped)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    P = B * npg
    q = torch.randn((B, C, H, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((P + 1, page, K, D), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((P + 1, page, K, D), generator=gen, device="cuda").to(dtype)
    rng = np.random.RandomState(seed)
    free = list(rng.permutation(P))
    pt = np.full((B, npg), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    for b, (n_tok, nv) in enumerate(zip(lens, nvs)):
        n_pages = -(-n_tok // page)
        pt[b, :n_pages] = [free.pop() for _ in range(n_pages)]
        pos[b] = max(0, n_tok - nv)
    for b, p in holes:
        pt[b, p] = -1
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return dict(q=q, kp=kp, vp=vp, page_table=t(pt), pos=t(pos),
                n_valid=t(np.asarray(nvs, np.int32)))


def work(case, window):
    """Bytes the function must move and the operations it must do on
    these inputs: each K/V row some valid query sees, read once; q, the
    tables and the output once; 4*D flops per visible query-key pair."""
    q, kp = case["q"], case["kp"]
    B, C, H, D = q.shape
    page, K = kp.shape[1], kp.shape[2]
    pt = case["page_table"].cpu().numpy()
    pos = case["pos"].cpu().numpy()
    nv = case["n_valid"].cpu().numpy()
    kv_rows = pairs = 0
    for b in range(B):
        keys = np.arange(pt.shape[1] * page)
        mapped = pt[b, keys // page] >= 0
        qpos = pos[b] + np.arange(min(C, nv[b]))
        vis = mapped[None] & (keys[None] <= qpos[:, None])
        if window is not None:
            vis &= keys[None] > qpos[:, None] - window
        pairs += int(vis.sum()) * H
        kv_rows += int(vis.any(0).sum())
    elt = q.element_size()
    # a K or V row: its stored bytes (D/2 for int4), plus a quantized
    # pool's fp32 scale
    row = kp.shape[-1] * kp.element_size() + (4 if "kp_scale" in case else 0)
    nbytes = (2 * kv_rows * K * row + 2 * q.numel() * elt
              + sum(case[k].numel() * 4 for k in ("page_table", "pos", "n_valid")))
    return nbytes, 4 * D * pairs


def time_ms(fn, iters=30):
    """Mean ms per call from CUDA events, each call after a write of
    128 MB that evicts the 50 MB L2 (in the engine each layer's
    attention follows ~0.6 GB of weight reads). A GPU-side sleep first
    lets the host queue every call before the card starts, so host
    delays do not land inside the timed intervals."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of GPU clock cycles
    ev = []
    for _ in range(iters):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        ev.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def enqueue_us(fn, iters=500):
    """Mean host microseconds to enqueue one call of ``fn`` while a
    GPU-side sleep keeps the card busy, so no call waits on the card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)  # ~0.25 s of GPU clock cycles
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def kernel_split_ms(fn, reps=10):
    """Device ms a call of ``fn`` spends in each kernel it launches (name
    -> ms), from the profiler over ``reps`` back-to-back calls (L2 warm)."""
    fn()
    torch.cuda.synchronize()
    _, _, kernels = trace_busy(lambda: [fn() for _ in range(reps)])
    return {e.key: e.self_device_time_total / 1e3 / reps for e in kernels}


def kernel_name(key):
    """A profiler kernel key cut to its function's name."""
    key = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return key.split("<")[0].split("(")[0]


def split_line(parts):
    """'name ms, ...' with each kernel's name cut to its function name."""
    return ", ".join(f"{kernel_name(name)} {ms:.4f}"
                     for name, ms in parts.items())


def sdpa_inputs(case, window):
    """Dense gathered K/V (dequantized to q's dtype for an int8/int4
    pool) and a float mask for one ``scaled_dot_product_attention`` call
    (the library yardstick)."""
    q, kp, vp, pt = case["q"], case["kp"], case["vp"], case["page_table"]
    B, C, H, D = q.shape
    page, K = kp.shape[1], kp.shape[2]
    npg = pt.shape[1]
    safe = pt.long().clamp(0, kp.shape[0] - 1)
    k, v = kp[safe], vp[safe]
    if "kp_scale" in case:  # pre-dequantized: SDPA times no dequant
        k = quant.dequantize(k, case["kp_scale"][safe], D).to(q.dtype)
        v = quant.dequantize(v, case["vp_scale"][safe], D).to(q.dtype)
    k = k.reshape(B, npg * page, K, D).transpose(1, 2)
    v = v.reshape(B, npg * page, K, D).transpose(1, 2)
    keys = torch.arange(npg * page, device="cuda")
    qpos = case["pos"].long()[:, None] + torch.arange(C, device="cuda")
    lim = (case["pos"] + case["n_valid"]).long()
    ok = ((pt.long() >= 0).repeat_interleave(page, 1)[:, None, :]
          & (keys < lim[:, None, None]) & (keys <= qpos[:, :, None]))
    if window is not None:
        ok &= keys > qpos[:, :, None] - window
    mask = torch.zeros(ok.shape, dtype=q.dtype, device="cuda")
    mask.masked_fill_(~ok, -1e30)
    return (q.transpose(1, 2).contiguous(), k.contiguous(), v.contiguous(),
            mask[:, None])


def quant_case(seed, kind, dtype, **shape):
    """``paged_case`` with q in ``dtype`` and its K/V pools quantized by
    ``quant`` (int8, or int4 packed over D/2) beside their fp32 scales."""
    case = paged_case(seed, dtype=torch.float32, **shape)
    qz = quant.quantize_int8 if kind == "int8" else quant.quantize_int4
    case["kp"], case["kp_scale"] = qz(case["kp"])
    case["vp"], case["vp_scale"] = qz(case["vp"])
    case["q"] = case["q"].to(dtype)
    return case


def hold_paged(case, window, label, tol):
    """The paged kernel on ``case`` against its plain version: valid
    queries within ``tol``, queries past n_valid and the idle last row
    0, finite, a rerun bitwise equal. Returns the largest |difference|."""
    got = pa.paged_attention_cuda(**case, window=window)
    torch.cuda.synchronize()
    want = pa.paged_attention_torch(**case, window=window)
    err = 0.0
    nv = case["n_valid"].cpu().tolist()
    for b in range(len(nv) - 1):  # the last row is idle: no keys
        g, w = got[b, :nv[b]].float(), want[b, :nv[b]].float()
        err = max(err, (g - w).abs().max().item())
        if not torch.allclose(g, w, rtol=tol, atol=tol):
            raise AssertionError(
                f"paged_attention {label}: kernel != plain, max |diff| "
                f"{err} > {tol} (row {b})")
    for b in range(len(nv)):  # queries past n_valid, idle row
        if not (got[b, nv[b]:] == 0).all() or (
                b == len(nv) - 1 and not (got[b] == 0).all()):
            raise AssertionError(
                f"paged_attention {label}: row {b} past n_valid (or idle) "
                f"not 0")
    if not torch.isfinite(got).all():
        raise AssertionError(f"paged_attention {label}: non-finite output")
    again = pa.paged_attention_cuda(**case, window=window)
    if not torch.equal(again, got):
        raise AssertionError(f"paged_attention {label}: a rerun differs")
    return err


def check_kernel():
    """The paged kernel against its plain version on the same inputs, for
    bf16/fp32 pools and through its int8 and int4 branches (the plain
    version dequantizes with ``quant.dequantize``), at the engine's chunk
    shape and at edge cases; then each pool kind timed at gemma-7b's
    shape. Returns the three records."""
    phase("kernels: paged_attention (bf16/fp32 pools, int8 and int4 "
          "branches) vs plain PyTorch on the card")
    main = dict(B=8, H=16, K=16, D=256, page=16, npg=10,
                lens=[160, 5, 37, 128, 64, 99, 16, 0])
    ragged = [1, 5, 8, 1, 8, 3, 1, 1]
    # Split edges (64 keys a split, 4 pages of 16) over a 12-page table:
    # ranges ending on a split boundary, rows spanning every split, a
    # split of unmapped pages, a window dropping leading splits, GQA 8
    # (C x G = 64 rows), 128 query rows (two row passes), decode at 190.
    wide = dict(main, npg=12)
    edge_lens = [64, 128, 192, 190, 63, 65, 127, 0]
    hole = [(b, p) for b in (1, 2) for p in range(4, 8)]
    edges = (
        ("split_edge", dict(wide, C=4, lens=edge_lens,
                            nvs=[1, 4, 3, 2, 1, 1, 4, 1]), None),
        ("hole_split", dict(wide, C=4, lens=edge_lens,
                            nvs=[4, 1, 4, 1, 2, 1, 3, 1], holes=hole), None),
        ("window40", dict(wide, C=4, lens=[190, 150, 66, 160, 5, 37, 99, 0],
                          nvs=[1, 4, 2, 4, 1, 3, 2, 1]), 40),
        ("gqa8", dict(wide, H=16, K=2, D=128, C=8, lens=edge_lens,
                      nvs=[8, 8, 3, 1, 5, 8, 2, 1]), None),
        ("rows128", dict(wide, H=16, K=2, D=64, C=16, lens=edge_lens,
                         nvs=[16, 9, 16, 1, 5, 16, 2, 1]), None),
        ("decode190", dict(wide, C=1, lens=edge_lens, nvs=[1] * 8), None),
    )
    recs = []
    for kind in ("", "int8", "int4"):
        def make(seed, dtype, kind=kind, **shape):
            if kind:
                return quant_case(seed, kind, dtype, **shape)
            return paged_case(seed, dtype=dtype, **shape)

        main_err = 0.0
        for i, (name, shape, window, dtype) in enumerate(
                (name, shape, window, dtype)
                for dtype in (torch.bfloat16, torch.float32)
                for name, shape, window in (
                    ("main_C1", dict(main, C=1, nvs=[1] * 8), None),
                    ("main_C8", dict(main, C=8, nvs=ragged, holes=[(3, 2)]),
                     None),
                    ("window64", dict(main, C=8, nvs=ragged), 64),
                    ("D64_gqa", dict(main, H=8, K=2, D=64, C=8, nvs=ragged),
                     None),
                    ("D128_gqa", dict(main, K=4, D=128, C=8, nvs=ragged),
                     None)) + edges):
            case = make(i, dtype, **shape)
            tol = TOL[dtype]
            err = hold_paged(case, window, f"{kind} {name} {dtype}", tol)
            if dtype == torch.bfloat16 and name.startswith("main"):
                main_err = max(main_err, err)
            print(f"  {kind or 'bf16/fp32 pool':14s} {name:10s} "
                  f"{str(dtype):15s} max|kernel-plain| {err:.3e} (tol "
                  f"{tol:g}), rerun bitwise equal, ok", flush=True)

        # Timing at the engine's chunk shape: B 8, C 8, bf16 q, page 16.
        case = make(99, torch.bfloat16, C=8, nvs=ragged, **main)
        nbytes, flops = work(case, None)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        qs, ks, vs, mask = sdpa_inputs(case, None)
        rec = dict(
            name="paged_attention" + (f"_{kind}" if kind else ""),
            route="cuda",
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:186",
            max_abs_err=main_err,
            ms=time_ms(lambda: pa.paged_attention_cuda(**case)),
            plain_ms=time_ms(lambda: pa.paged_attention_torch(**case)),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask)),
        )
        sdpa_note = (" (on pre-gathered K/V dequantized to bf16 beforehand: "
                     "attention without the dequant)" if kind else "")
        enq = enqueue_us(lambda: pa.paged_attention_cuda(**case))
        parts = split_line(kernel_split_ms(
            lambda: pa.paged_attention_cuda(**case)))
        print(f"  timing {kind or 'bf16 pool'} B8 C8 H16 D256 page16 bf16 q: "
              f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
              f"sdpa {rec['library_ms']:.4f} ms{sdpa_note}, kernel/sdpa "
              f"{rec['ms'] / rec['library_ms']:.3f}, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes} B, "
              f"{flops} flop); {pa.key_splits(main['page'], main['npg'])} "
              f"key splits of {pa.SPLIT_KEYS}; wrapper enqueue "
              f"{enq:.1f} us a call; by kernel (ms a call, L2 warm): "
              f"{parts}", flush=True)
        recs.append(rec)
    return recs


# --------------------------------------------------------------------------- #
# Phase 2b: flash attention forward and backward vs plain.
# --------------------------------------------------------------------------- #
FLASH_CASES = [  # name, B, Sq, Sk, H, K, D, causal, window, q_off, k_off
    ("train", 2, 2048, 2048, 16, 16, 256, True, None, 0, 0),
    ("ragged", 2, 300, 437, 4, 4, 128, True, None, 137, 0),
    ("bidir", 1, 300, 437, 4, 4, 128, False, None, 0, 0),
    ("window64", 1, 512, 512, 8, 8, 64, True, 64, 0, 0),
    ("koff-37", 1, 128, 165, 2, 2, 64, True, 40, 0, -37),
    ("gqa8/2", 2, 256, 256, 8, 2, 128, True, None, 0, 0),
    # edges of the bf16 backward's 64-row tiles at D 256
    ("s63", 2, 63, 63, 2, 2, 256, True, None, 0, 0),
    ("s127/129", 2, 127, 129, 2, 2, 256, True, None, 2, 0),
    ("gqa16/2", 2, 128, 128, 16, 2, 256, True, None, 0, 0),
    ("unseen", 2, 64, 256, 2, 2, 256, True, None, 0, 0),
    ("win-k90", 2, 200, 200, 2, 2, 256, True, 20, 0, 90),
    # whisper-medium (16/16 heads of 64): the encoder at one admission
    # and at the train batch (non-causal, 1500 frames: no tile multiple),
    # the cross-attention (448 target tokens over 1500 frames) and the
    # decoder's causal self-attention at the train batch
    ("w-enc-B1", 1, 1500, 1500, 16, 16, 64, False, None, 0, 0),
    ("w-enc", 8, 1500, 1500, 16, 16, 64, False, None, 0, 0),
    ("w-cross", 8, 448, 1500, 16, 16, 64, False, None, 0, 0),
    ("w-dec", 8, 448, 448, 16, 16, 64, True, None, 0, 0),
]


def flash_inputs(seed, B, Sq, Sk, H, K, D, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return randn(B, Sq, H, D), randn(B, Sk, K, D), randn(B, Sk, K, D), \
        randn(B, Sq, H, D)


def flash_work(B, Sq, Sk, H, D, opts):
    """Operations of one forward and one backward on these inputs: 4 * D
    flops per visible query-key pair and head forward (two products),
    10 * D backward (S recomputed, dP, dV, dK, dQ)."""
    pairs = int(fa.visible_mask(Sq, Sk, **opts).sum())
    return 4 * D * pairs * B * H, 10 * D * pairs * B * H


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_flash():
    phase("kernels: flash_attention forward and backward vs plain PyTorch")
    errs = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[dtype]
        for i, (name, B, Sq, Sk, H, K, D, causal, window, qo, ko) in \
                enumerate(FLASH_CASES):
            opts = dict(causal=causal, window=window, q_offset=qo,
                        k_offset=ko)
            q, k, v, do = flash_inputs(i, B, Sq, Sk, H, K, D, dtype)
            out, lse = fa.flash_attention_fwd_cuda(q, k, v, **opts)
            dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                     **opts)
            torch.cuda.synchronize()
            qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
            want = fa.flash_attention_torch(qp, kp, vp, **opts)
            want.backward(do)
            rows = fa.visible_mask(Sq, Sk, device="cuda", **opts).any(1)
            line = []
            for label, got, ref in (("out", out[:, rows], want[:, rows]),
                                    ("dq", dq[:, rows], qp.grad[:, rows]),
                                    ("dk", dk, kp.grad), ("dv", dv, vp.grad)):
                g, w = got.float(), ref.float()
                err = (g - w).abs().max().item()
                if not (torch.isfinite(g).all()
                        and torch.allclose(g, w, rtol=tol, atol=tol)):
                    raise AssertionError(
                        f"flash_attention {name} {dtype} {label}: kernel != "
                        f"plain, max |diff| {err} > {tol}")
                if name == "train" and dtype == torch.bfloat16:
                    key = "fwd" if label == "out" else "bwd"
                    errs[key] = max(errs[key], err)
                line.append(f"{label} {err:.2e}")
            if not (out[:, ~rows] == 0).all():
                raise AssertionError(f"flash_attention {name}: rows with no "
                                     f"visible key are not 0")
            again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **opts)
            if not all(torch.equal(a, b) for a, b in zip(again,
                                                         (dq, dk, dv))):
                raise AssertionError(f"flash_attention {name} {dtype}: a "
                                     f"rerun of the backward differs")
            del again
            print(f"  {name:9s} {str(dtype):15s} max|kernel-plain| "
                  f"{', '.join(line)} (tol {tol:g}), backward rerun bitwise "
                  f"equal, ok", flush=True)
            del q, k, v, do, out, lse, dq, dk, dv, qp, kp, vp, want
    torch.cuda.empty_cache()

    # Timing at the train step's shape: B 4, S 2048, 16 heads of 256.
    q, k, v, do = flash_inputs(99, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 16, 16,
                               256, torch.bfloat16)
    recs = flash_records(q, k, v, do, "", (errs["fwd"], errs["bwd"]))
    del q, k, v, do
    torch.cuda.empty_cache()
    return recs


def flash_records(q, k, v, do, suffix, errs, causal=True):
    """The flash kernels' forward and backward records at (q, k, v, do),
    bf16, causal or not (q and k of any lengths): kernel, plain and SDPA
    times (SDPA flash, K/V expanded to the query heads beforehand) beside
    the bounds; prints them with SDPA forward+backward and the
    backward's time by kernel. ``errs``: the (forward, backward) max
    |kernel - plain| the records carry."""
    B, S, H, D = q.shape
    Sk, K, dtype = k.shape[1], k.shape[2], q.dtype
    opts = dict(causal=causal, window=None, q_offset=0, k_offset=0)
    kw = dict(causal=causal)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    fwd_flops, bwd_flops = flash_work(B, S, Sk, H, D, opts)
    # Each input read once, each output written once. Forward: q, k, v
    # in; out and the fp32 lse out. Backward: q, k, v, out, dout and lse
    # in; dq, dk, dv out.
    elt = q.element_size()
    fwd_bytes = (2 * q.numel() + 2 * k.numel()) * elt + B * H * S * 4
    bwd_bytes = (4 * q.numel() + 4 * k.numel()) * elt + B * H * S * 4
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    plain_out = fa.flash_attention_torch(qp, kp, vp, **kw)
    qs = q.detach().transpose(1, 2).requires_grad_()
    ks, vs = (t.detach().repeat_interleave(H // K, dim=2).transpose(1, 2)
              .requires_grad_() for t in (k, v))
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal)

    sdpa_out = sdpa()
    do_s = do.transpose(1, 2)
    times = dict(
        fwd=time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, **kw)),
        bwd=time_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse,
                                                        do, **kw)),
        plain_fwd=time_ms(lambda: fa.flash_attention_torch(q, k, v, **kw),
                          10),
        plain_bwd=time_ms(lambda: torch.autograd.grad(
            plain_out, (qp, kp, vp), do, retain_graph=True), 10),
        sdpa_fwd=time_ms(lambda: sdpa().detach()),
        sdpa_bwd=time_ms(lambda: torch.autograd.grad(
            sdpa_out, (qs, ks, vs), do_s, retain_graph=True)),
    )
    times["sdpa_fwd_bwd"] = time_ms(lambda: torch.autograd.grad(
        sdpa(), (qs, ks, vs), do_s))
    bwd_parts = kernel_split_ms(
        lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw),
        reps=5)
    fwd_b, fwd_by = bound(fwd_flops, fwd_bytes, dtype)
    bwd_b, bwd_by = bound(bwd_flops, bwd_bytes, dtype)
    common = dict(route="cuda",
                  source="src/repro_torch/kernels/csrc/flash_attention.cu",
                  replaces="src/repro/kernels/flash_attention.py:102")
    recs = [
        dict(name=f"flash_attention_fwd{suffix}", max_abs_err=errs[0],
             ms=times["fwd"], plain_ms=times["plain_fwd"], bound_ms=fwd_b,
             bound_by=fwd_by, library_ms=times["sdpa_fwd"], **common),
        dict(name=f"flash_attention_bwd{suffix}", max_abs_err=errs[1],
             ms=times["bwd"], plain_ms=times["plain_bwd"], bound_ms=bwd_b,
             bound_by=bwd_by, library_ms=times["sdpa_bwd"], **common),
    ]
    shape = f"S{S}" if S == Sk else f"Sq{S} Sk{Sk}"
    print(f"  timing B{B} {shape} H{H} K{K} D{D} {dtype} "
          f"{'causal' if causal else 'non-causal'}: forward kernel "
          f"{times['fwd']:.4f} ms (bound {fwd_b:.4f}, {fwd_by}: "
          f"{fwd_flops} flop, {fwd_bytes} B), plain {times['plain_fwd']:.4f}"
          f" ms, sdpa {times['sdpa_fwd']:.4f} ms, kernel/sdpa "
          f"{times['fwd'] / times['sdpa_fwd']:.3f}; backward kernels "
          f"{times['bwd']:.4f} ms (bound {bwd_b:.4f}, {bwd_by}: {bwd_flops} "
          f"flop, {bwd_bytes} B), plain {times['plain_bwd']:.4f} ms, sdpa "
          f"{times['sdpa_bwd']:.4f} ms, kernel/sdpa "
          f"{times['bwd'] / times['sdpa_bwd']:.3f}; sdpa forward+backward "
          f"{times['sdpa_fwd_bwd']:.4f} ms (sdpa on K/V expanded to {H} "
          f"heads); backward by kernel (ms a call, L2 warm): "
          f"{split_line(bwd_parts)}", flush=True)
    del out, lse, qp, kp, vp, plain_out, qs, ks, vs, sdpa_out
    torch.cuda.empty_cache()
    return recs


# --------------------------------------------------------------------------- #
# Phase 2c: the LSTM cell forward and backward vs plain.
# --------------------------------------------------------------------------- #
LSTM_CASES = [  # name, B, F, dtype
    ("gnmt", 128, 1024, torch.bfloat16),     # GNMT's train step
    ("ragged", 200, 1024, torch.bfloat16),   # a ragged batch tile
    ("small", 5, 64, torch.float32),
    ("tiny", 48, 96, torch.bfloat16),
    ("f40", 128, 40, torch.bfloat16),        # 5 backward blocks of 8 units
]


def lstm_inputs(seed, B, F, dtype):
    """x_proj, h, w_h in ``dtype``; c, b fp32; dh in ``dtype``; dc fp32.
    W_h at GNMT's init scale F^-0.5."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dt)

    return dict(x_proj=randn(B, 4 * F, dt=dtype), h_prev=randn(B, F, dt=dtype),
                c_prev=randn(B, F), w_h=randn(F, 4 * F, scale=F ** -0.5,
                                              dt=dtype),
                b=randn(4 * F, scale=0.1)), randn(B, F, dt=dtype), randn(B, F)


def plain_gates(x_proj, h_prev, c_prev, w_h, b):
    pre = x_proj.float() + h_prev.float() @ w_h.float() + b
    i, f, g, o = pre.chunk(4, dim=-1)
    return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o)], dim=-1)


def check_lstm():
    """Both LSTM cell kernels against their plain versions at the shapes
    of GNMT's path and at edge cases (forward with and without the saved
    gates, backward from the kernel's own gates), then timed at GNMT's
    shape (B 128, F 1024, bf16) beside the plain versions and one
    library call each: ``torch.matmul`` + ``aten._thnn_fused_lstm_cell``
    forward, ``aten._thnn_fused_lstm_cell_backward_impl`` backward."""
    phase("kernels: lstm_cell forward and backward vs plain PyTorch")
    errs = {"fwd": 0.0, "bwd": 0.0}
    for i, (name, B, F, dtype) in enumerate(LSTM_CASES):
        tol = TOL[dtype]
        x, dh, dc = lstm_inputs(i, B, F, dtype)
        h0, c0, none = lk.lstm_cell_fwd_cuda(**x)
        h, c, gates = lk.lstm_cell_fwd_cuda(**x, save_gates=True)
        dg, dcp, dx, db = lk.lstm_cell_bwd_cuda(gates, x["c_prev"], c, dh, dc)
        again = lk.lstm_cell_bwd_cuda(gates, x["c_prev"], c, dh, dc)
        torch.cuda.synchronize()
        if none is not None or not (torch.equal(h0, h) and torch.equal(c0, c)):
            raise AssertionError(f"lstm_cell {name}: saving the gates changed "
                                 f"the forward")
        if not all(torch.equal(a, b) for a, b in zip((dg, dcp, dx, db),
                                                     again)):
            raise AssertionError(f"lstm_cell {name}: a backward rerun is not "
                                 f"bitwise equal")
        want_h, want_c = lk.lstm_cell_torch(**x)
        want_g = plain_gates(**x)
        want_dg, want_dcp, want_dx, want_db = lk.lstm_cell_bwd_torch(
            want_g, x["c_prev"], want_c, dh, dc)
        line = []
        # db sums B rows of dgates: its tolerance is dgates' times sqrt(B)
        for label, key, got, ref, t in (
                ("h", "fwd", h, want_h, tol), ("c", "fwd", c, want_c, tol),
                ("gates", "fwd", gates, want_g, tol),
                ("dgates", "bwd", dg, want_dg, tol),
                ("dc_prev", "bwd", dcp, want_dcp, tol),
                ("dx", "bwd", dx, want_dx, tol),
                ("db", "bwd", db, want_db, tol * B ** 0.5)):
            g, w = got.float(), ref.float()
            err = (g - w).abs().max().item()
            if not (torch.isfinite(g).all()
                    and torch.allclose(g, w, rtol=t, atol=t)):
                raise AssertionError(
                    f"lstm_cell {name} {dtype} {label}: kernel != plain, max "
                    f"|diff| {err} > {t}")
            if name == "gnmt":
                errs[key] = max(errs[key], err)
            line.append(f"{label} {err:.2e}")
        print(f"  {name:7s} B{B} F{F} {str(dtype):15s} max|kernel-plain| "
              f"{', '.join(line)} (tol {tol:g}, db {tol * B ** 0.5:g}) ok, "
              f"backward rerun bitwise equal", flush=True)

    # Timing at GNMT's shape.
    name, B, F, dtype = LSTM_CASES[0]
    x, dh, dc = lstm_inputs(99, B, F, dtype)
    h, c, gates = lk.lstm_cell_fwd_cuda(**x, save_gates=True)
    elt = x["x_proj"].element_size()
    # Each input read once, each output written once. Forward: x_proj, h,
    # W_h in dtype, c and b fp32 in; h' in dtype, c' and the gates fp32 out.
    fwd_bytes = (B * 4 * F + B * F + F * 4 * F + B * F) * elt + (
        B * F + 4 * F + B * F + B * 4 * F) * 4
    nogates_bytes = fwd_bytes - B * 4 * F * 4
    fwd_flops = 2 * B * F * 4 * F
    # Backward: gates, c_prev, c', dc' fp32 and dh in dtype in; dgates,
    # dc_prev and db fp32 and dx in dtype out; ~20 flops per (row, unit)
    # in fp32, and 4 adds for db.
    bwd_bytes = (B * 4 * F + 3 * B * F) * 4 + B * F * elt + (
        B * 4 * F + B * F + 4 * F) * 4 + B * 4 * F * elt
    bwd_flops = 24 * B * F
    fwd_b, fwd_by = bound(fwd_flops, fwd_bytes, dtype)
    ng_b, _ = bound(fwd_flops, nogates_bytes, dtype)
    t_ops = bwd_flops / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = bwd_bytes / HBM_BYTES_PER_S * 1e3
    bwd_b, bwd_by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                           else "bytes")
    # The library yardsticks take one dtype for all operands (bf16 c and b
    # forward, fp32 dh backward) and both biases or none (b, and zeros).
    c_lib, b_lib = x["c_prev"].to(dtype), x["b"].to(dtype)
    fused = torch.ops.aten._thnn_fused_lstm_cell
    fused_bwd = torch.ops.aten._thnn_fused_lstm_cell_backward_impl
    dh32 = dh.float()
    _, cy32, ws32 = fused(x["x_proj"].float(), x["h_prev"].float()
                          @ x["w_h"].float(), x["c_prev"], x["b"],
                          torch.zeros_like(x["b"]))
    times = dict(
        fwd=time_ms(lambda: lk.lstm_cell_fwd_cuda(**x, save_gates=True)),
        fwd_nogates=time_ms(lambda: lk.lstm_cell_fwd_cuda(**x)),
        plain_fwd=time_ms(lambda: lk.lstm_cell_torch(**x)),
        lib_fwd=time_ms(lambda: fused(x["x_proj"], x["h_prev"] @ x["w_h"],
                                      c_lib, b_lib, torch.zeros_like(b_lib))),
        bwd=time_ms(lambda: lk.lstm_cell_bwd_cuda(gates, x["c_prev"], c, dh,
                                                  dc)),
        plain_bwd=time_ms(lambda: lk.lstm_cell_bwd_torch(
            gates, x["c_prev"], c, dh, dc)),
        lib_bwd=time_ms(lambda: fused_bwd(dh32, dc, x["c_prev"], cy32, ws32,
                                          True)),
    )
    # GNMT's step is host-bound: the forward wrapper's host cost per call
    # (checks, allocation, two tensor-map encodes, the launch).
    fwd_enqueue = enqueue_us(lambda: lk.lstm_cell_fwd_cuda(**x,
                                                           save_gates=True))
    bwd_enqueue = enqueue_us(lambda: lk.lstm_cell_bwd_cuda(
        gates, x["c_prev"], c, dh, dc))
    src = "src/repro_torch/kernels/csrc/lstm_cell.cu"
    recs = [
        dict(name="lstm_cell_fwd", route="cuda", source=src,
             replaces="src/repro/kernels/lstm_cell.py:51",
             max_abs_err=errs["fwd"], ms=times["fwd"],
             plain_ms=times["plain_fwd"], bound_ms=fwd_b, bound_by=fwd_by,
             library_ms=times["lib_fwd"]),
        dict(name="lstm_cell_bwd", route="cuda", source=src,
             replaces="src/repro/kernels/lstm_cell.py:51",
             max_abs_err=errs["bwd"], ms=times["bwd"],
             plain_ms=times["plain_bwd"], bound_ms=bwd_b, bound_by=bwd_by,
             library_ms=times["lib_bwd"]),
    ]
    print(f"  timing B{B} F{F} bf16: forward kernel {times['fwd']:.4f} ms with "
          f"gates (bound {fwd_b:.4f}, {fwd_by}: {fwd_bytes} B, {fwd_flops} "
          f"flop), {times['fwd_nogates']:.4f} ms without (bound {ng_b:.4f}: "
          f"{nogates_bytes} B), plain {times['plain_fwd']:.4f} ms, matmul + "
          f"_thnn_fused_lstm_cell {times['lib_fwd']:.4f} ms, kernel/library "
          f"{times['fwd'] / times['lib_fwd']:.3f}; backward kernel "
          f"{times['bwd']:.4f} ms (bound {bwd_b:.4f}, {bwd_by}: {bwd_bytes} "
          f"B), plain {times['plain_bwd']:.4f} ms, "
          f"_thnn_fused_lstm_cell_backward_impl (fp32 dh) "
          f"{times['lib_bwd']:.4f} ms, kernel/library "
          f"{times['bwd'] / times['lib_bwd']:.3f}; host enqueue of the forward "
          f"wrapper {fwd_enqueue:.1f} us a call, of the backward wrapper "
          f"{bwd_enqueue:.1f} us a call", flush=True)
    del x, dh, dc, h, c, gates, cy32, ws32
    torch.cuda.empty_cache()
    return recs


# --------------------------------------------------------------------------- #
# Phase 2d: the LARS kernels vs plain.
# --------------------------------------------------------------------------- #
LARS_HYPER = dict(weight_decay=1e-4, momentum=0.9, eta=0.001, eps=1e-9)
TRUST_KW = dict(weight_decay=1e-4, eta=0.001, eps=1e-9)
APPLY_KW = dict(weight_decay=1e-4, momentum=0.9)
LARS_LR = 0.25
LARGEST_LEAF = 3 * 3 * 512 * 512  # ResNet-50's s3b*.conv2
LARS_CASES = [  # name, n, what is zero, offset in floats (4: not 16 B aligned)
    ("s3b0.conv2", LARGEST_LEAF, None, 0),
    ("odd", 1_000_003, None, 0),
    ("min_size", 1024, None, 0),
    ("unaligned", 1_000_003, None, 1),
    ("zero_w", 65_536, "w", 0),
    ("zero_g", 65_536, "g", 0),
]


def lars_inputs(seed, n, zero=None, offset=0):
    """w, g, m of n fp32 values at ResNet-like scales (weights ~0.02,
    gradients and momenta ~1e-3); ``offset`` floats into a larger buffer,
    so that a nonzero offset breaks 16-byte alignment."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(scale):
        return at_offset(torch.randn(n, generator=gen, device="cuda") * scale,
                         offset)

    w, g, m = randn(0.02), randn(1e-3), randn(1e-3)
    if zero:
        {"w": w, "g": g}[zero].zero_()
    return w, g, m


def at_offset(x, offset):
    """A copy of the 1-D ``x`` that starts ``offset`` floats into a fresh
    buffer."""
    buf = torch.empty(x.numel() + offset, device=x.device)
    return buf[offset:].copy_(x)


def lars_work(n):
    """Bytes each phase must move for one leaf of n fp32 elements: the
    norms read w and g and yield 2 sums; the update reads w, g, m, the
    sums and lr and writes w and m. Flops an element: 4 for the norms
    (two FMAs), 6 for the update (three)."""
    return dict(norms=(8 * n + 8, 4 * n), update=(20 * n + 12, 6 * n))


def fused_sgd(ws, gs, ms, lr):
    """``torch._fused_sgd_`` (the ``tensor_lr`` overload): w -= lr * (mu*m
    + g + wd*w), the scaled rule when lr = lr * trust."""
    torch._fused_sgd_(ws, gs, ms, weight_decay=LARS_HYPER["weight_decay"],
                      momentum=LARS_HYPER["momentum"], lr=lr, dampening=0.0,
                      nesterov=False, maximize=False, is_first_step=False)


def check_lars():
    """Both LARS kernels against the plain version (``lars_update_torch``)
    in both rules, at ResNet-50's largest leaf, an odd size, the 1024
    minimum, an unaligned view (the scalar path) and zero w / zero g
    (trust exactly 1), within rtol 1e-5, atol 1e-6 on w' and m' (fp32;
    sums in another order); a rerun must be bitwise equal. Then each
    kernel timed at the largest leaf beside the plain version and one
    library call (``_foreach_norm``; ``_fused_sgd_`` where it matches),
    and both over ResNet-50's 54 kernel leaves as the optimizer runs them
    (``lars_sweep``: one norms launch and one update launch). Returns the
    records, both from the sweep."""
    phase("kernels: lars_update norms and update vs plain PyTorch")
    lr = torch.full((), LARS_LR, device="cuda")
    for i, (name, n, zero, offset) in enumerate(LARS_CASES):
        for scaled in (True, False):
            kw = dict(LARS_HYPER, lr=lr, scaled_momentum=scaled)
            w, g, m = lars_inputs(i, n, zero, offset)
            want_w, want_m = lk_lars.lars_update_torch(w, g, m, **kw)
            want_t = lk_lars.lars_trust_torch(w, g, **TRUST_KW)
            outs = []
            for _ in range(2):  # the second run must repeat bitwise
                wk, mk = at_offset(w, offset), at_offset(m, offset)
                t = torch.empty(1, device="cuda")
                lk_lars.lars_update_cuda(wk, g, mk, **kw, trust_out=t)
                outs.append((wk, mk, t))
            torch.cuda.synchronize()
            (wk, mk, t), again = outs
            if not all(torch.equal(a, b) for a, b in zip(outs[0], again)):
                raise AssertionError(f"lars {name}: a rerun is not bitwise "
                                     f"equal")
            errs = []
            for label, got, ref in (("w", wk, want_w), ("m", mk, want_m)):
                errs.append((got - ref).abs().max().item())
                if not (torch.isfinite(got).all() and torch.allclose(
                        got, ref, rtol=1e-5, atol=1e-6)):
                    raise AssertionError(
                        f"lars {name} scaled={scaled} {label}: kernel != "
                        f"plain, max |diff| {errs[-1]}")
            trust, want_trust = t.item(), want_t.item()
            if zero and trust != 1.0:
                raise AssertionError(f"lars {name}: trust {trust}, must be "
                                     f"exactly 1 at a zero norm")
            if abs(trust - want_trust) > 1e-5 * abs(want_trust):
                raise AssertionError(f"lars {name}: trust {trust} vs plain "
                                     f"{want_trust}")
            print(f"  {name:10s} n {n:9d} {'scaled' if scaled else 'unscaled':8s}"
                  f" trust {trust:.6e} (plain {want_trust:.6e}) max|kernel-"
                  f"plain| w {errs[0]:.2e}, m {errs[1]:.2e} (rtol 1e-5, atol "
                  f"1e-6) ok, rerun bitwise equal", flush=True)

    # Timing at the largest leaf alone, scaled rule; the records are taken
    # over the 54 leaves (lars_sweep).
    n = LARGEST_LEAF
    w, g, m = lars_inputs(99, n)
    w2, m2 = w.clone(), m.clone()
    partial = lk_lars.lars_norms_cuda(w, g)
    trust = lk_lars.lars_trust_torch(w, g, **TRUST_KW)
    # The library's fused SGD at lr * trust computes the scaled rule; it
    # is the yardstick only if it matches the plain version.
    want_w, want_m = lk_lars.lars_update_torch(w, g, m, lr=lr, **LARS_HYPER)
    ws, gs, ms = [w.clone()], [g.clone()], [m.clone()]
    fused_sgd(ws, gs, ms, lr * trust)
    sgd_matches = (torch.allclose(ws[0], want_w, rtol=1e-5, atol=1e-6)
                   and torch.allclose(ms[0], want_m, rtol=1e-5, atol=1e-6))
    times = dict(
        norms=time_ms(lambda: lk_lars.lars_norms_cuda(w, g)),
        update=time_ms(lambda: lk_lars.lars_apply_cuda(
            w2, g, m2, partial, lr=lr, **LARS_HYPER)),
        plain_norms=time_ms(lambda: lk_lars.lars_partials_torch(w, g)),
        plain_update=time_ms(lambda: lk_lars.lars_apply_torch(
            w, g, m, trust, lr=lr, **APPLY_KW)),
        lib_norms=time_ms(lambda: torch._foreach_norm([w, g])),
        lib_update=time_ms(lambda: fused_sgd(ws, gs, ms, lr * trust)),
    )
    libs = {"norms": "_foreach_norm([w, g])",
            "update": "_fused_sgd_ at lr*trust, " + (
                "matches the plain version" if sgd_matches else
                "does NOT match the plain version: recorded as none")}
    src = "src/repro_torch/kernels/csrc/lars.cu"
    for key in ("norms", "update"):
        nbytes, flops = lars_work(n)[key]
        b, by = bound(flops, nbytes, torch.float32)
        print(f"  timing n {n} fp32 {key}: kernel {times[key]:.4f} ms (bound "
              f"{b:.4f}, {by}: {nbytes} B, {flops} flop), plain "
              f"{times[f'plain_{key}']:.4f} ms, library "
              f"{times[f'lib_{key}']:.4f} ms ({libs[key]})", flush=True)
    del w, g, m, w2, m2, ws, gs, ms
    return lars_sweep(src)


def resnet50_lars_leaves(seed=5):
    """ResNet-50's 54 kernel leaves (weights from seed 0), with gradients
    and momenta ~N(0, 1e-3) from ``seed``, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(w, torch.randn(w.shape, generator=gen, device="cuda") * 1e-3,
             torch.randn(w.shape, generator=gen, device="cuda") * 1e-3)
            for w in tree_leaves(resnet.init_resnet(resnet.RESNET50, 0))
            if w.dim() > 1]


def check_norms_multi(name, ws, gs, launches):
    """The multi-leaf norms launch over ``ws``/``gs``: ``launches`` kernel
    launches, a rerun bitwise equal, every leaf's rows bitwise equal to
    its one-leaf call and within rtol 1e-5 of the plain chunk sums (fp32
    sums of <= 9216 squares in two orders). Returns the largest |kernel -
    plain|."""
    before = lk_lars.lars_norms_multi_cuda.launches
    cat, parts = lk_lars.lars_norms_multi_cuda(ws, gs)
    again, _ = lk_lars.lars_norms_multi_cuda(ws, gs)
    ones = [lk_lars.lars_norms_cuda(w, g) for w, g in zip(ws, gs)]
    plain = [lk_lars.lars_partials_torch(w, g) for w, g in zip(ws, gs)]
    torch.cuda.synchronize()
    made = (lk_lars.lars_norms_multi_cuda.launches - before) // 2
    if made != launches or not torch.equal(cat, again):
        raise AssertionError(f"lars norms {name}: {made} launches (expected "
                             f"{launches}) or a rerun not bitwise equal")
    err = 0.0
    for i, (part, one, ref) in enumerate(zip(parts, ones, plain)):
        if not torch.equal(part, one):
            raise AssertionError(f"lars norms {name}: leaf {i}'s partials "
                                 f"differ from its one-leaf launch")
        err = max(err, (part - ref).abs().max().item())
        if not torch.allclose(part, ref, rtol=1e-5, atol=0):
            raise AssertionError(f"lars norms {name}: leaf {i} != plain, max "
                                 f"|diff| {(part - ref).abs().max().item()}")
    print(f"  norms {name}: {len(ws)} leaves, {cat.shape[0]} chunks, "
          f"{launches} launch(es), rerun bitwise equal, every leaf bitwise "
          f"equal to its one-leaf launch, max|kernel-plain| {err:.2e} (rtol "
          f"1e-5) ok", flush=True)
    return err


def check_update_multi(name, ws, gs, ms, launches, lr, scaled=True):
    """The multi-leaf update launch over ``ws``/``gs``/``ms`` (on copies of
    w and m) from the multi-leaf norms: ``launches`` kernel launches, a
    rerun bitwise equal, every leaf's w', m' and trust bitwise equal to its
    one-leaf launch and within rtol 1e-5, atol 1e-6 of the plain version.
    Returns the largest |kernel - plain| of w' and m'."""
    kw = dict(LARS_HYPER, lr=lr, scaled_momentum=scaled)
    _, parts = lk_lars.lars_norms_multi_cuda(ws, gs)
    outs = []
    before = lk_lars.lars_apply_multi_cuda.launches
    for _ in range(2):
        wk, mk = [w.clone() for w in ws], [m.clone() for m in ms]
        t = torch.empty(len(ws), device="cuda")
        lk_lars.lars_apply_multi_cuda(wk, gs, mk, parts, **kw, trust_out=t)
        outs.append((wk, mk, t))
    torch.cuda.synchronize()
    made = (lk_lars.lars_apply_multi_cuda.launches - before) // 2
    (wk, mk, t), (w2, m2, t2) = outs
    if made != launches or not (torch.equal(t, t2) and all(
            torch.equal(a, b) for a, b in zip(wk + mk, w2 + m2))):
        raise AssertionError(f"lars update {name}: {made} launches (expected "
                             f"{launches}) or a rerun not bitwise equal")
    err = 0.0
    for i, (w, g, m, p) in enumerate(zip(ws, gs, ms, parts)):
        w1, m1, t1 = w.clone(), m.clone(), torch.empty(1, device="cuda")
        lk_lars.lars_apply_cuda(w1, g, m1, p, **kw, trust_out=t1)
        if not (torch.equal(wk[i], w1) and torch.equal(mk[i], m1)
                and torch.equal(t[i:i + 1], t1)):
            raise AssertionError(f"lars update {name}: leaf {i}'s w', m' or "
                                 f"trust differ from its one-leaf launch")
        want_w, want_m = lk_lars.lars_update_torch(w, g, m, **kw)
        for got, ref in ((wk[i], want_w), (mk[i], want_m)):
            err = max(err, (got - ref).abs().max().item())
            if not torch.allclose(got, ref, rtol=1e-5, atol=1e-6):
                raise AssertionError(f"lars update {name}: leaf {i} != "
                                     f"plain, max |diff| {err}")
    print(f"  update {name} ({'scaled' if scaled else 'unscaled'}): "
          f"{len(ws)} leaves, {launches} launch(es), rerun bitwise equal, "
          f"every leaf's w', m' and trust bitwise equal to its one-leaf "
          f"launch, max|kernel-plain| {err:.2e} (rtol 1e-5, atol 1e-6) ok",
          flush=True)
    return err


def lars_timings(ws, gs, ms, lr, label):
    """Both multi-leaf kernels over ``ws``/``gs``/``ms`` (updated in place
    while timed) in turns against a library call over the same tensors:
    the norms against the multi-tensor ``_foreach_norm`` over the w and g
    tensors, the update against ``_fused_sgd_`` over the leaves (the same
    bytes and per-element arithmetic at one lr: no PyTorch call takes a
    trust a leaf); beside the plain versions, with the update's host
    enqueue time. Prints them; returns (ms by key, bounds by kernel)."""
    n = sum(w.numel() for w in ws)
    _, parts = lk_lars.lars_norms_multi_cuda(ws, gs)
    trusts = [lk_lars.lars_trust_torch(w, g, **TRUST_KW)
              for w, g in zip(ws, gs)]

    def norms():
        lk_lars.lars_norms_multi_cuda(ws, gs)

    def update():
        lk_lars.lars_apply_multi_cuda(ws, gs, ms, parts, lr=lr, **LARS_HYPER)

    def plain_norms():
        for w, g in zip(ws, gs):
            lk_lars.lars_partials_torch(w, g)

    def plain_update():
        for w, g, m, t in zip(ws, gs, ms, trusts):
            lk_lars.lars_apply_torch(w, g, m, t, lr=lr, **APPLY_KW)

    flat = [t for w, g in zip(ws, gs) for t in (w, g)]
    turns = {}
    order = [("norms", norms), ("lib_norms", lambda: torch._foreach_norm(flat)),
             ("update", update), ("lib_update",
                                  lambda: fused_sgd(ws, gs, ms, lr))]
    for key, fn in order + order[::-1]:  # kernel, library, library, kernel
        turns.setdefault(key, []).append(time_ms(fn, 10))
    t = {k: float(np.mean(v)) for k, v in turns.items()}
    t.update({k: time_ms(f, 10) for k, f in (
        ("plain_norms", plain_norms), ("plain_update", plain_update))})
    update_enqueue_us = enqueue_us(update, 200)
    work = dict(norms=(8 * n + 8 * len(ws), 4 * n),  # w and g read, a pair out
                update=(20 * n + 8 * sum(p.shape[0] for p in parts) + 4,
                        6 * n))  # w, g, m read, w, m written; pairs, lr
    bounds = {k: bound(f, b, torch.float32) for k, (b, f) in work.items()}
    for key, lib in (("norms", f"_foreach_norm over {len(flat)} tensors"),
                     ("update", f"_fused_sgd_ over {len(ws)} leaves, one "
                                f"lr")):
        b, by = bounds[key]
        print(f"  {label} over {len(ws)} kernel leaves ({n} "
              f"elements): {key}, one launch, in turns with {lib}: "
              f"{' / '.join(f'{x:.4f}' for x in turns[key])} (kernel) and "
              f"{' / '.join(f'{x:.4f}' for x in turns['lib_' + key])} "
              f"(library) ms; kernel {t[key]:.4f} ms (bound {b:.4f}, {by}: "
              f"{work[key][0]} B, {100 * b / t[key]:.1f}% of it; "
              f"kernel/library {t[key] / t['lib_' + key]:.3f}; plain "
              f"{t['plain_' + key]:.4f})", flush=True)
    print(f"  update launch host enqueue {update_enqueue_us:.1f} us for the "
          f"{len(ws)} leaves", flush=True)
    print(f"  lars {label} " + json.dumps(dict(n=n, leaves=len(ws), **{
        f"{k}_ms": v for k, v in t.items()}, turns_ms=turns,
        update_enqueue_us=update_enqueue_us)), flush=True)
    return t, bounds


def lars_sweep(src):
    """Both kernels as the optimizer runs them: one launch each over all 54
    kernel leaves of ResNet-50, held bitwise against the one-leaf launches
    (and at the edges: odd, unaligned and 1024-element leaves, and past
    one launch's 64-leaf table), and ``ops.lars_update_leaves`` over the
    54 leaves against the plain version in both rules (1 norms and 1
    update launch). Then each timed in turns against a library call over
    the same tensors: the norms against the multi-tensor
    ``_foreach_norm`` over the 108 tensors, the update against
    ``_fused_sgd_`` over the 54 leaves (the same bytes and per-element
    arithmetic at one lr: no PyTorch call takes a trust a leaf); beside
    the plain versions. Returns the two kernels' records."""
    leaves = resnet50_lars_leaves()
    ws, gs, ms = ([x[i] for x in leaves] for i in range(3))
    lr = torch.full((), LARS_LR, device="cuda")
    err = check_norms_multi("resnet50", ws, gs, 1)
    gen = torch.Generator(device="cuda").manual_seed(6)
    extra = [torch.randn(k, generator=gen, device="cuda")
             for k in (1_000_003, 1024, 1_000_003, 4097)]
    extra[2] = at_offset(extra[2], 1)  # not 16-byte aligned
    extra_g = [x.flip(0).contiguous() for x in extra]
    check_norms_multi("edges", extra + ws[:3], extra_g + gs[:3], 1)
    check_norms_multi("past the table", ws * 2 + [extra[1]] * 12,
                      gs * 2 + [extra[0][:1024]] * 12, 2)
    err_update = 0.0
    for scaled in (True, False):
        err_update = max(err_update, check_update_multi(
            "resnet50", ws, gs, ms, 1, lr, scaled))
    extra_m = [at_offset(x * 1e-2, 1 if i == 2 else 0)
               for i, x in enumerate(extra)]
    check_update_multi("edges", extra + ws[:3], extra_g + gs[:3],
                       extra_m + ms[:3], 1, lr)
    many = [w.clone() for w in ws] + [w.clone() for w in ws] + [
        torch.randn(1024, generator=gen, device="cuda") for _ in range(12)]
    check_update_multi("past the table", many,
                       gs * 2 + [extra[0][:1024]] * 12,
                       [m.clone() for m in ms * 2] + [x * 1e-2 for x in
                                                      many[-12:]], 2, lr)
    del many
    for scaled in (True, False):
        kw = dict(LARS_HYPER, lr=lr, scaled_momentum=scaled)
        wk, mk = [w.clone() for w in ws], [m.clone() for m in ms]
        before = (lk_lars.lars_norms_multi_cuda.launches,
                  lk_lars.lars_apply_multi_cuda.launches,
                  lk_lars.lars_apply_cuda.launches)
        ops.lars_update_leaves(wk, gs, mk, **kw)
        torch.cuda.synchronize()
        made = (lk_lars.lars_norms_multi_cuda.launches - before[0],
                lk_lars.lars_apply_multi_cuda.launches - before[1]
                + lk_lars.lars_apply_cuda.launches - before[2])
        worst = 0.0
        for w, g, m, a, c in zip(ws, gs, ms, wk, mk):
            want_w, want_m = lk_lars.lars_update_torch(w, g, m, **kw)
            for got, ref in ((a, want_w), (c, want_m)):
                worst = max(worst, (got - ref).abs().max().item())
                if not torch.allclose(got, ref, rtol=1e-5, atol=1e-6):
                    raise AssertionError(f"lars_update_leaves != plain, max "
                                         f"|diff| {worst}")
        if made != (1, 1):
            raise AssertionError(f"lars_update_leaves made {made} launches, "
                                 f"expected (1, 1)")
        print(f"  lars_update_leaves over the 54 leaves "
              f"({'scaled' if scaled else 'unscaled'}): launches norms "
              f"{made[0]}, update {made[1]}; max|kernel-plain| w, m "
              f"{worst:.2e} (rtol 1e-5, atol 1e-6) ok", flush=True)
        del wk, mk

    t, bounds = lars_timings(ws, gs, ms, lr, "sweep")
    del leaves, ws, gs, ms, extra, extra_g, extra_m
    torch.cuda.empty_cache()
    recs = {}
    for key, name, line, e in (("norms", "lars_norms", 62, err),
                               ("update", "lars_update", 80, err_update)):
        b, by = bounds[key]
        recs[key] = dict(name=name, route="cuda", source=src,
                         replaces=f"src/repro/kernels/lars.py:{line}",
                         max_abs_err=e, ms=t[key], plain_ms=t["plain_" + key],
                         bound_ms=b, bound_by=by, library_ms=t["lib_" + key])
    return recs["norms"], recs["update"]


# --------------------------------------------------------------------------- #
# Phase 2e: the mamba_scan kernel vs plain; flash at jamba's prefill shape.
# --------------------------------------------------------------------------- #
JAMBA = "jamba-1.5-large-398b"
MAMBA_SHAPE = (1, 256, 16384, 16)  # jamba's prefill: Bt 1, S 256, Di, N
MAMBA_CASES = [  # name, (Bt, S, Di, N), u's dtype, B and C as views
    ("prefill", MAMBA_SHAPE, torch.bfloat16, True),
    ("prefill", MAMBA_SHAPE, torch.float32, True),
    ("S2048", (1, 2048, 16384, 16), torch.bfloat16, True),  # a prompt of
    ("S2048", (1, 2048, 16384, 16), torch.float32, True),   # the train length
    ("odd", (2, 17, 33, 4), torch.float32, True),
    ("odd", (2, 17, 33, 4), torch.bfloat16, False),
    ("S1", (3, 1, 100, 16), torch.float32, True),
    ("contiguous", (1, 64, 2048, 16), torch.float32, False),
    ("N64", (2, 70, 1000, 64), torch.float32, True),   # the wrapper's most
    ("N64", (1, 45, 520, 64), torch.bfloat16, False),
    ("oddN", (2, 77, 300, 13), torch.bfloat16, True),  # S no whole chunk
    ("oddN", (1, 100, 260, 33), torch.float32, True),
]
MAMBA_PROMPT = (1, 128, 16384, 16)  # the smoke's longest jamba prompt
SFU_EXP_PER_CLOCK = 16  # exponentials a clock on one SM's special-function units
N_SMS = 132


def mamba_inputs(seed, Bt, S, Di, N, u_dtype, views):
    """tests/test_kernels.py's recipe: u ~ 0.5 N, dt = 0.1 softplus(N),
    A = -|N|, B, C ~ 0.3 N, D ~ 0.1 N; with ``views`` B and C are column
    slices of one (Bt, S, 8 + 2N) tensor, as ``apply_mamba`` passes them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u = (0.5 * randn(Bt, S, Di)).to(u_dtype)
    dt = 0.1 * torch.nn.functional.softplus(randn(Bt, S, Di))
    A = -randn(Di, N).abs()
    D = 0.1 * randn(Di)
    if views:
        x_dbl = 0.3 * randn(Bt, S, 8 + 2 * N)
        B, C = x_dbl[..., 8:8 + N], x_dbl[..., 8 + N:]
    else:
        B, C = 0.3 * randn(Bt, S, N), 0.3 * randn(Bt, S, N)
    return u, dt, A, B, C, D


def bf16_ulp(x):
    """One bf16 ulp at each value of x: 2^(e - 8) for |x| in
    [2^(e-1), 2^e) (8 significant bits)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def mamba_work(Bt, S, Di, N, u_dtype):
    """(bytes, exponentials) of one scan: u and y in u's dtype, dt, A, B,
    C, D and the final h in fp32, each read or written once; one
    exponential per (row, step, channel, state)."""
    e = torch.finfo(u_dtype).bits // 8
    nbytes = (2 * Bt * S * Di * e + 4 * (Bt * S * Di + Di * N + 2 * Bt * S * N
                                         + Di + Bt * Di * N))
    return nbytes, Bt * S * Di * N


def sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def check_mamba():
    """The kernel against its plain version on the card (y to rtol 1e-4,
    atol 1e-5 with fp32 u; with bf16 u, where both round their fp32 y to
    bf16 once, to one bf16 ulp beyond that tolerance; h to rtol 1e-4,
    atol 1e-5), two launches a case bitwise equal; then timed at
    jamba's prefill shape (S 256) and at the smoke's longest prompt (S
    128) beside its bound. Returns the S 256 record."""
    phase("kernels: mamba_scan vs plain PyTorch")
    err, failed = 0.0, []
    for i, (name, shape, u_dtype, views) in enumerate(MAMBA_CASES):
        n_failed = len(failed)
        args = mamba_inputs(i, *shape, u_dtype, views)
        before = mk.mamba_scan_cuda.launches
        y, h = mk.mamba_scan_cuda(*args)
        y2, h2 = mk.mamba_scan_cuda(*args)
        torch.cuda.synchronize()
        if mk.mamba_scan_cuda.launches - before != 2:
            raise AssertionError("mamba_scan: not one launch a call")
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            raise AssertionError(f"mamba_scan {name}: a rerun differs")
        want_y, want_h = mk.mamba_scan_torch(*args)
        h_err = (h - want_h).abs().max().item()
        y_err = (y.float() - want_y.float()).abs().max().item()
        if not (torch.isfinite(y.float()).all()
                and torch.allclose(h, want_h, rtol=1e-4, atol=1e-5)):
            failed.append(f"{name} {shape} {u_dtype} h")
        if u_dtype == torch.float32:
            ok = torch.allclose(y, want_y, rtol=1e-4, atol=1e-5)
            tol = "rtol 1e-4, atol 1e-5"
        else:
            # both round an fp32 y held to rtol 1e-4, atol 1e-5 to bf16
            # once: they may differ by that plus one bf16 ulp
            want = want_y.float()
            diff = (y.float() - want).abs()
            ok = bool((diff <= bf16_ulp(want) + 1e-5
                       + 1e-4 * want.abs()).all())
            over = diff > bf16_ulp(want)
            tol = (f"one bf16 ulp + rtol 1e-4, atol 1e-5; {int(over.sum())} "
                   f"of {diff.numel()} values beyond one ulp")
        if not ok:
            failed.append(f"{name} {shape} {u_dtype} y")
        if name == "prefill" and u_dtype == torch.bfloat16:
            err = y_err
        print(f"  {name:10s} {str(shape):22s} u {str(u_dtype):14s} "
              f"{'views' if views else 'contiguous'}: max|kernel-plain| y "
              f"{y_err:.2e} ({tol}), h {h_err:.2e} (rtol 1e-4, atol 1e-5); "
              f"rerun bitwise equal{'; FAILS' if failed[n_failed:] else ''}",
              flush=True)
        del args, y, h, y2, h2, want_y, want_h
        torch.cuda.empty_cache()
    # steps with dt = 0 and u = 0 leave h bitwise as it was (decay 1)
    args = list(mamba_inputs(40, 1, 48, 520, 16, torch.bfloat16, True))
    args[0][:, 16:] = 0
    args[1][:, 16:] = 0
    _, h48 = mk.mamba_scan_cuda(*args)
    _, h16 = mk.mamba_scan_cuda(*(t[:, :16] if t.dim() == 3 else t
                                  for t in args))
    torch.cuda.synchronize()
    if not torch.equal(h48, h16):
        failed.append("zero steps moved h")
    print(f"  32 steps of dt = 0, u = 0 after 16: h bitwise unchanged "
          f"{torch.equal(h48, h16)}", flush=True)
    if failed:
        raise AssertionError(f"mamba_scan != plain: {failed}")

    clock = sm_clock_hz()
    readings = []
    for shape in (MAMBA_SHAPE, MAMBA_PROMPT):
        args = mamba_inputs(99, *shape, torch.bfloat16, True)
        ms = time_ms(lambda: mk.mamba_scan_cuda(*args))
        plain_ms = time_ms(lambda: mk.mamba_scan_torch(*args), 5)
        nbytes, n_exp = mamba_work(*shape, torch.bfloat16)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_exp / (SFU_EXP_PER_CLOCK * N_SMS * clock) * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"  timing {shape} bf16 u: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}% of it): bytes {nbytes} B = "
              f"{t_bytes:.4f} ms at 3.35 TB/s, exponentials {n_exp} at "
              f"{SFU_EXP_PER_CLOCK}/clock/SM x {N_SMS} SMs x "
              f"{clock / 1e9:.3f} GHz = {t_ops:.4f} ms", flush=True)
        readings.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by))
        del args
    print("  library_ms null: no single PyTorch call computes a selective "
          "scan", flush=True)
    torch.cuda.empty_cache()
    return dict(name="mamba_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/mamba_scan.cu",
                replaces="src/repro/kernels/mamba.py:58", max_abs_err=err,
                library_ms=None, **readings[0])


MAMBA_TRAIN = (1, 2048, 16384, 16)  # a train-step microbatch: Bt 1, S 2048
MAMBA_BWD_CASES = [  # name, (Bt, S, Di, N), u's dtype, B/C views, dh, K
    ("train", MAMBA_TRAIN, torch.bfloat16, True, False, mk.STATE_EVERY),
    ("train", MAMBA_TRAIN, torch.bfloat16, True, True, mk.STATE_EVERY),
    ("S1", (1, 1, 300, 16), torch.bfloat16, True, True, 16),
    ("S33", (2, 33, 520, 16), torch.float32, True, True, 16),
    ("S2047", (1, 2047, 1024, 16), torch.bfloat16, True, True, 16),
    ("N5", (3, 50, 260, 5), torch.float32, False, True, 16),
    ("N64", (2, 70, 1000, 64), torch.float32, True, True, 16),
    ("Bt3", (3, 100, 2048, 16), torch.bfloat16, False, False, 16),
    ("K48", (2, 150, 700, 16), torch.float32, True, True, 48),  # re-walks
    # two rows, the last block holding 16 of its 64 channels
    ("ragged", (2, 2048, 16400, 16), torch.bfloat16, True, True, 16),
]
BWD_NAMES = ("du", "ddt", "dA", "dB", "dC", "dD")


def mamba_bwd_work(Bt, S, Di, N, u_dtype, K):
    """(bytes, exponentials) of one backward: u, dy and du in u's dtype;
    dt, ddt, A, dA, B, C, dB, dC, D, dD, dh and the (S - 1) // K boundary
    states in fp32, each read or written once; one exponential per (row,
    step, channel, state), the decay the reverse recurrence needs."""
    e = torch.finfo(u_dtype).bits // 8
    nbytes = (3 * Bt * S * Di * e
              + 4 * (2 * Bt * S * Di + 2 * Di * N + 4 * Bt * S * N + 2 * Di
                     + Bt * Di * N
                     + Bt * mk.n_saved_states(S, K) * Di * N))
    return nbytes, Bt * S * Di * N


def mamba_bound(nbytes, n_exp, clock):
    """(bound ms, what bounds it, bytes ms, exponentials ms) at 3.35 TB/s
    and 16 exponentials a clock on each of the 132 SMs."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_exp / (SFU_EXP_PER_CLOCK * N_SMS * clock) * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes
            else "bytes", t_bytes, t_ops)


def scan_close(got, want, extra=None):
    """(ok, max |got - want|, that over max |want|): |got - want| <= 1e-4
    |want| + 1e-4 max |want| (plus ``extra``) everywhere. Both are fp32
    and differ in the order of their sums (over channels, states and
    rows) and in FFMA against separate products and sums, which the
    reverse recurrence carries over up to 2048 steps; a near-zero
    gradient entry is the sum of terms that cancel."""
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        return False, float("inf"), float("inf")
    if not w.numel():
        return True, 0.0, 0.0
    diff = (g - w).abs()
    top = w.abs().max()
    tol = 1e-4 * w.abs() + 1e-4 * top
    if extra is not None:
        tol = tol + extra
    err = diff.max().item()
    return (bool(torch.isfinite(g).all() and (diff <= tol).all()), err,
            err / max(top.item(), 1e-30))


def hold_mamba_bwd(got, want, u_dtype):
    """Each of the six gradients against the plain version's by
    ``scan_close`` (du with bf16 u, which both round once, one bf16 ulp
    beyond it). Returns ({name: (max |diff|, over max |plain|)}, the
    names that failed)."""
    errs, bad = {}, []
    for n, g, w in zip(BWD_NAMES, got, want):
        extra = (bf16_ulp(w) if n == "du" and u_dtype == torch.bfloat16
                 else None)
        ok, err, rel = scan_close(g, w, extra)
        errs[n] = (err, rel)
        if not ok:
            bad.append(n)
    return errs, bad


def check_mamba_bwd_cases():
    """The backward kernel against the plain backward from the same
    states (``hold_mamba_bwd``) at every ``MAMBA_BWD_CASES`` shape, each
    rerun bitwise equal. Returns (the cases that failed, the largest
    |kernel - plain| at the train shape)."""
    failed, train_err = [], 0.0
    for i, (name, shape, u_dtype, views, with_dh, K) in enumerate(
            MAMBA_BWD_CASES):
        Bt, S, Di, N = shape
        args = mamba_inputs(60 + i, *shape, u_dtype, views)
        gen = torch.Generator(device="cuda").manual_seed(80 + i)
        dy = torch.randn((Bt, S, Di), generator=gen, device="cuda").to(
            u_dtype)
        dh = (torch.randn((Bt, Di, N), generator=gen, device="cuda")
              if with_dh else None)
        _, _, hs = mk.mamba_scan_cuda(*args, state_every=K)
        before = mk.mamba_scan_bwd_cuda.launches
        got = mk.mamba_scan_bwd_cuda(*args, hs, dy, dh, state_every=K)
        again = mk.mamba_scan_bwd_cuda(*args, hs, dy, dh, state_every=K)
        torch.cuda.synchronize()
        if mk.mamba_scan_bwd_cuda.launches - before != 2:
            raise AssertionError("mamba_scan_bwd: not one count a call")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"mamba_scan_bwd {name}: a rerun differs")
        want = mk.mamba_scan_bwd_torch(*args, hs, dy, dh, state_every=K)
        errs, bad = hold_mamba_bwd(got, want, u_dtype)
        failed += [f"backward {name} {shape} {u_dtype} {n}" for n in bad]
        if name == "train":
            train_err = max([train_err] + [e for e, _ in errs.values()])
        print(f"  backward {name:6s} {str(shape):22s} u "
              f"{str(u_dtype):14s} {'views' if views else 'contiguous'}, "
              f"dh {'given' if with_dh else 'none'}, K {K}: max|kernel-plain| "
              + ", ".join(f"{n} {e:.2e} ({r:.1e})"
                          for n, (e, r) in errs.items())
              + f"; rerun bitwise equal{'; FAILS ' + str(bad) if bad else ''}",
              flush=True)
        del args, dy, dh, hs, got, again, want
        torch.cuda.empty_cache()
    return failed, train_err


def bwd_info_line(Di, N, u_dtype=torch.bfloat16):
    info = mk.bwd_kernel_info(Di, N, u_dtype)
    return (f"{info['regs']} registers a thread, {info['threads']} threads "
            f"and {info['smem_bytes']} B of shared memory a block, "
            f"{info['blocks_per_sm']} blocks an SM, {info['blocks']} blocks "
            f"(dB/dC partials) in {info['waves']} wave(s)")


def check_mamba_train():
    """The scan's training path on the card: the forward at the train
    step's shape (Bt 1, S 2048, Di 16384, N 16, bf16 u) with its boundary
    states every 16 steps, which equal the plain scan's states at those
    steps (rtol 1e-4, atol 1e-5, as y and h) while y and h stay bitwise
    those of the launch without states; then the backward kernel against
    the plain backward from the same states (``check_mamba_bwd_cases``)
    at that shape, with a zero and a nonzero final-state cotangent, and
    at S 1, 33, 2047, N 5 and 64, Bt 3, fp32 u, contiguous B/C, K 48 and
    a last block half filled at Bt 2; then both timed beside their
    bounds, with the backward's registers, blocks an SM and waves.
    Returns the (forward, backward) records at the train shape."""
    phase("kernels: mamba_scan forward with boundary states and its "
          "backward at jamba's train shape vs plain PyTorch")
    args = mamba_inputs(50, *MAMBA_TRAIN, torch.bfloat16, True)
    y0, h0 = mk.mamba_scan_cuda(*args)
    y1, h1, hs = mk.mamba_scan_cuda(*args, state_every=mk.STATE_EVERY)
    torch.cuda.synchronize()
    if not (torch.equal(y0, y1) and torch.equal(h0, h1)):
        raise AssertionError("mamba_scan: y or h moved with the boundary "
                             "states on")
    _, _, want_hs = mk.mamba_scan_torch(*args, state_every=mk.STATE_EVERY)
    ok = torch.allclose(hs, want_hs, rtol=1e-4, atol=1e-5)
    hs_err = (hs - want_hs).abs().max().item()
    failed = [] if ok else ["boundary states"]
    print(f"  forward {MAMBA_TRAIN} bf16 u, states every {mk.STATE_EVERY}: "
          f"{tuple(hs.shape)} boundary states, max|kernel-plain| "
          f"{hs_err:.2e} ({'ok' if ok else 'FAILS'}: rtol 1e-4, atol 1e-5); "
          f"y and h bitwise equal to the launch without states", flush=True)
    del y0, h0, y1, h1, hs, want_hs, args
    torch.cuda.empty_cache()

    bad, train_err = check_mamba_bwd_cases()
    failed += bad
    if failed:
        raise AssertionError(f"mamba_scan training path != plain: {failed}")

    clock = sm_clock_hz()
    args = mamba_inputs(99, *MAMBA_TRAIN, torch.bfloat16, True)
    K = mk.STATE_EVERY
    Bt, S, Di, N = MAMBA_TRAIN
    _, _, hs = mk.mamba_scan_cuda(*args, state_every=K)
    dy = (0.1 * torch.randn((Bt, S, Di), device="cuda")).to(torch.bfloat16)
    fwd_ms = time_ms(lambda: mk.mamba_scan_cuda(*args, state_every=K))
    bare_ms = time_ms(lambda: mk.mamba_scan_cuda(*args))
    bwd_ms = time_ms(lambda: mk.mamba_scan_bwd_cuda(*args, hs, dy,
                                                    state_every=K))
    fwd_plain = time_ms(lambda: mk.mamba_scan_torch(*args, state_every=K), 2)
    bwd_plain = time_ms(lambda: mk.mamba_scan_bwd_torch(
        *args, hs, dy, state_every=K), 2)
    fb, fe = mamba_work(*MAMBA_TRAIN, torch.bfloat16)
    fb += 4 * hs.numel()  # the boundary states written
    f_bound, f_by, f_tb, f_te = mamba_bound(fb, fe, clock)
    bb, be = mamba_bwd_work(*MAMBA_TRAIN, torch.bfloat16, K)
    b_bound, b_by, b_tb, b_te = mamba_bound(bb, be, clock)
    info = bwd_info_line(Di, N)
    print(f"  timing {MAMBA_TRAIN} bf16 u: forward with states {fwd_ms:.4f} "
          f"ms (without {bare_ms:.4f}), plain {fwd_plain:.2f} ms; bound "
          f"{f_bound:.4f} ms ({f_by}: {fb} B = {f_tb:.4f} ms, {fe} "
          f"exponentials = {f_te:.4f} ms at {clock / 1e9:.3f} GHz; "
          f"{100 * f_bound / fwd_ms:.1f}% of it); backward {bwd_ms:.4f} ms, "
          f"plain {bwd_plain:.2f} ms; bound {b_bound:.4f} ms ({b_by}: {bb} "
          f"B = {b_tb:.4f} ms, {be} exponentials = {b_te:.4f} ms; "
          f"{100 * b_bound / bwd_ms:.1f}% of it); backward kernel: {info}; "
          f"library_ms null: no PyTorch call computes a selective scan or "
          f"its gradient", flush=True)
    del args, hs, dy
    torch.cuda.empty_cache()
    common = dict(route="cuda",
                  source="src/repro_torch/kernels/csrc/mamba_scan.cu",
                  replaces="src/repro/kernels/mamba.py:58", library_ms=None)
    return (dict(name="mamba_scan_train", max_abs_err=hs_err, ms=fwd_ms,
                 plain_ms=fwd_plain, bound_ms=f_bound, bound_by=f_by,
                 **common),
            dict(name="mamba_scan_bwd", max_abs_err=train_err, ms=bwd_ms,
                 plain_ms=bwd_plain, bound_ms=b_bound, bound_by=b_by,
                 **common))


def check_flash_jamba():
    """The flash forward at jamba's attention layer (64 heads, 8 KV heads
    of 128, no positions, batch 1, causal, bf16) against its plain
    version at S 128 and 17, timed at S 128; then forward and backward at
    its train step's shape (B 1, S 2048: one of 8 microbatches), as
    ``check_flash_case`` holds and times them. Returns (the prefill
    record, the train shape's forward and backward records)."""
    phase("kernels: flash_attention at jamba's prefill and train shapes vs "
          "plain PyTorch")
    H, K, D, dtype = 64, 8, 128, torch.bfloat16
    tol = TOL[dtype]
    for S in (128, 17):
        q, k, v, _ = flash_inputs(S, 1, S, S, H, K, D, dtype)
        out, _ = fa.flash_attention_fwd_cuda(q, k, v)
        want = fa.flash_attention_torch(q, k, v)
        err = (out.float() - want.float()).abs().max().item()
        if not (torch.isfinite(out.float()).all() and torch.allclose(
                out.float(), want.float(), rtol=tol, atol=tol)):
            raise AssertionError(f"flash at jamba's shape, S {S}: kernel != "
                                 f"plain, max |diff| {err}")
        print(f"  B1 S{S} H{H} K{K} D{D} bf16 causal: max|kernel-plain| "
              f"{err:.2e} (tol {tol:g}) ok", flush=True)
        if S == 128:
            max_err = err
    S = 128
    q, k, v, _ = flash_inputs(7, 1, S, S, H, K, D, dtype)
    opts = dict(causal=True, window=None, q_offset=0, k_offset=0)
    flops, _ = flash_work(1, S, S, H, D, opts)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + H * S * 4
    qs = q.transpose(1, 2)
    ks, vs = (t.repeat_interleave(H // K, dim=2).transpose(1, 2)
              for t in (k, v))
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True)

    ms = time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v))
    plain_ms = time_ms(lambda: fa.flash_attention_torch(q, k, v))
    sdpa_ms = time_ms(sdpa)
    b, by = bound(flops, nbytes, dtype)
    print(f"  timing B1 S{S} H{H} K{K} D{D}: kernel {ms:.4f} ms (bound "
          f"{b:.4f}, {by}: {flops} flop, {nbytes} B), plain {plain_ms:.4f} "
          f"ms, sdpa {sdpa_ms:.4f} ms (on K/V expanded to {H} heads "
          f"beforehand), kernel/sdpa {ms / sdpa_ms:.3f}", flush=True)
    prefill = dict(name="flash_attention_fwd_jamba", route="cuda",
                   source="src/repro_torch/kernels/csrc/flash_attention.cu",
                   replaces="src/repro/kernels/flash_attention.py:102",
                   max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                   bound_by=by, library_ms=sdpa_ms)
    del q, k, v, qs, ks, vs
    train_fwd, train_bwd = check_flash_case(
        320, JAMBA, TRAIN_BATCH_JAMBA // get_config(JAMBA).microbatches,
        TRAIN_SEQ, H, K, D, dtype, tol, "_jamba_train")
    return prefill, train_fwd, train_bwd


# --------------------------------------------------------------------------- #
# Phase 4: serve.
# --------------------------------------------------------------------------- #
def tokens_of(report):
    return [r.tokens for r in sorted(report.requests, key=lambda r: r.id)]


def full_serve_params():
    """Random bf16 weights of full-width gemma-7b from seed 0."""
    cfg = get_config("gemma-7b")
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{sum(p.numel() for p in tree_leaves(params)) / 1e9:.2f} B "
          f"params in {time.perf_counter() - t0:.1f} s", flush=True)
    return params


def serve_full(params):
    phase("serve: gemma-7b full width, 28 layers, bf16, offline")
    return serve_stream(get_config("gemma-7b"), params, trace="run")


def serve_stream(cfg, params, *, trace, **extra):
    """Full-width ``cfg`` serves stream (a), the 8 ragged requests,
    greedy and offline from its config's pool: the paged kernel's
    counter, zeroed just before, must show one launch (of the pool's
    branch) per layer per chunk step, every request must get its tokens
    from the vocabulary, and a second run must repeat them. Then one
    chunk step of 8 rows x 8 tokens against a fresh pool must give
    finite logits. ``trace`` picks what is traced: the second run
    (``"run"``: device busy share of the stream) or the chunk step
    (``"chunk"``: timed, then traced). ``extra`` joins the printed
    summary. Returns the paged launches."""
    scfg = ServeConfig(max_batch=8, max_len=max(PROMPT_LENS) + NEW_TOKENS,
                       page_size=16, prefill_chunk=8)
    engine = Engine(cfg, params, scfg, device="cuda")
    if engine.layout != "paged":
        raise AssertionError(f"{cfg.name} served from {engine.layout}")
    run_offline(engine, synthetic_requests(cfg, n=2, tokens=2, prompt_len=8,
                                           seed=1))  # warm-up

    def workload():
        return synthetic_requests(cfg, n=8, tokens=NEW_TOKENS,
                                  prompt_len=max(PROMPT_LENS), seed=0,
                                  prompt_lens=PROMPT_LENS)

    torch.cuda.reset_peak_memory_stats()
    pa.reset_launches()
    t0 = time.perf_counter()
    report = run_offline(engine, workload())
    kind = cfg.kv_cache_dtype
    launches = pa.paged_attention_cuda.launches_by_kind[kind]
    steps = len(report.steps)
    s = report.summary()
    s.update(extra, n_layers=cfg.n_layers, kv=kind, launches=launches,
             chunk_steps=steps,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"  {report.format()}", flush=True)
    print(f"  chunk steps {steps}, paged_attention launches {launches} "
          f"({kind} branch; expected {cfg.n_layers} x {steps}), peak "
          f"memory {s['peak_mem_gib']:.2f} GiB", flush=True)
    if launches != cfg.n_layers * steps or steps == 0 or \
            pa.paged_attention_cuda.launches != launches:
        raise AssertionError(
            f"{cfg.name}: paged_attention launches "
            f"{pa.paged_attention_cuda.launches_by_kind} in {steps} chunk "
            f"steps; expected {cfg.n_layers} {kind} launches a step")
    got = tokens_of(report)
    if len(got) != 8 or any(len(t) != NEW_TOKENS for t in got):
        raise AssertionError(f"{cfg.name}: not every request got "
                             f"{NEW_TOKENS} tokens")
    if any(not 0 <= tok < cfg.vocab for t in got for tok in t):
        raise AssertionError(f"{cfg.name}: token id out of the vocabulary")
    if trace == "run":
        # where the device time goes, and how busy the card is (the
        # trace slows the host side, not the kernels)
        again, busy_ms, kernels = trace_busy(
            lambda: tokens_of(run_offline(engine, workload())))
        n_kernels = sum(e.count for e in kernels)
        print(f"  traced second run: {n_kernels} kernels "
              f"({n_kernels / steps:.0f} per step), device busy "
              f"{busy_ms:.1f} ms = "
              f"{100 * busy_ms / (report.elapsed_s * 1e3):.1f}% of the "
              f"untraced run's {report.elapsed_s * 1e3:.1f} ms; top kernels:",
              flush=True)
        for e in kernels[:10]:
            print(f"    {e.self_device_time_total / 1e3:9.2f} ms "
                  f"{e.count:6d}x {e.key[:100]}")
        s.update(device_busy_ms=busy_ms, kernels_per_step=n_kernels / steps)
    else:
        again = tokens_of(run_offline(engine, workload()))
    if again != got:
        raise AssertionError(f"{cfg.name}: a second run of the same "
                             f"workload differs")
    print("  a second run gives the same greedy tokens", flush=True)

    # One chunk step at 8 rows x 8 tokens (a mixed prefill step) against
    # a fresh 16-page pool: finite logits of the right shape.
    B, C = 8, scfg.prefill_chunk
    cache = lm.init_paged_cache(cfg, 16, 16, device="cuda")
    pt = torch.full((B, 2), -1, dtype=torch.int32, device="cuda")
    pt[:, 0] = torch.arange(B, dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab, (B, C), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(3))
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")
    nv = torch.full((B,), C, dtype=torch.int32, device="cuda")

    def chunk():
        with torch.inference_mode():
            return lm.decode_chunk(params, cfg, toks, cache, pt, zero, nv)[0]

    logits = chunk()
    if tuple(logits.shape) != (B, cfg.vocab) or \
            not torch.isfinite(logits.float()).all():
        raise AssertionError(f"{cfg.name}: chunk logits "
                             f"{tuple(logits.shape)} not finite / not "
                             f"(B, vocab)")
    if trace == "chunk":
        ms, busy, kernels = timed_and_traced(chunk)
        print(f"  one chunk step (8 x 8 tokens): {ms:.2f} ms (median of 3, "
              f"to the card's end); traced: {sum(e.count for e in kernels)}"
              f" kernels, device busy {busy:.2f} ms = {100 * busy / ms:.1f}%"
              f"; top kernels:", flush=True)
        for e in kernels[:6]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:5d}x {e.key[:100]}")
        s.update(chunk_ms=ms, chunk_busy_ms=busy, chunk_busy_share=busy / ms)
    s["wall_s"] = time.perf_counter() - t0
    print(f"  serve summary {json.dumps(s)}", flush=True)
    del engine, cache, report, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# The paged kernel's launches (the split kernel and the merge), by name.
PAGED_KERNELS = ("paged_split_mma_kernel", "paged_split_f32_kernel",
                 "paged_combine_kernel")


def trace_busy(fn):
    """Run ``fn`` under the profiler; (its result, device-busy ms, the
    kernels sorted by device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    return out, sum(e.self_device_time_total for e in kernels) / 1e3, kernels


def pool_bytes(engine):
    """(bytes of the engine's KV pools and scales, bytes of a bf16 pool
    of the same pages)."""
    cache = engine._cache
    have = sum(t.numel() * t.element_size() for t in cache.values())
    cfg = engine.cfg
    rows = cache["kp"].shape[:-1].numel()
    return have, 2 * rows * cfg.head_dim * 2


def replay_drafter(report):
    """Proposes each request's next tokens from ``report``'s run."""
    runs = [(list(r.prompt), list(r.tokens)) for r in report.requests]

    def fn(ctx, k):
        for prompt, toks in runs:
            if ctx[:len(prompt)] == prompt:
                return toks[len(ctx) - len(prompt):][:k]
        return []
    return DraftModelDrafter(fn)


def same_share(a, b):
    """Share of positions where two runs' tokens agree."""
    pairs = [(x, y) for ta, tb in zip(tokens_of(a), tokens_of(b))
             for x, y in zip(ta, tb)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def serve_quant(params):
    """Full-width gemma-7b serves a server-scenario stream of
    shared-prefix requests with the prefix cache and n-gram speculation,
    from a bf16 pool (for comparison) and from an int8 pool (the main
    path of the quantized branch); then offline from an int4 pool."""
    phase("serve: gemma-7b full width, 28 layers, bf16 weights, server "
          "scenario, prefix cache, n-gram speculation (draft 3); bf16 and "
          "int8 pools")
    cfg = get_config("gemma-7b")
    base = dict(max_batch=8, max_len=SHARED + SUFFIX + NEW_TOKENS,
                page_size=16, prefill_chunk=8, prefix_cache=True)
    spec = dict(spec_decode="ngram", draft_len=3)

    def workload(tokens=NEW_TOKENS, scenario="server"):
        return synthetic_requests(
            cfg, n=8, tokens=tokens, prompt_len=SHARED + SUFFIX,
            scenario=scenario, seed=0, arrival_rate=RATE,
            shared_prefix_len=SHARED, n_templates=2)

    out = {}
    for kv in ("bfloat16", "int8"):
        engine = Engine(cfg, params, ServeConfig(kv_dtype=kv, **base, **spec),
                        device="cuda")
        run_offline(engine, synthetic_requests(cfg, n=2, tokens=2,
                                               prompt_len=8, seed=1))
        torch.cuda.reset_peak_memory_stats()
        pa.reset_launches()
        report = run_server(engine, workload())
        launches = dict(pa.paged_attention_cuda.launches_by_kind)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = len(report.steps)
        have, bf16 = pool_bytes(engine)
        again, busy_ms, kernels = trace_busy(
            lambda: run_server(engine, workload()))
        paged_ms = sum(e.self_device_time_total for e in kernels
                       if kernel_name(e.key) in PAGED_KERNELS) / 1e3
        per_step = sum(e.count for e in kernels) / len(again.steps)
        s = report.summary()
        s.update(peak_mem_gib=peak, chunk_steps=steps, launches=launches,
                 draft_accepted=report.draft_accepted, pool_bytes=have,
                 bf16_pool_bytes=bf16, device_busy_ms=busy_ms,
                 busy_share=busy_ms / (report.elapsed_s * 1e3),
                 paged_attention_device_ms=paged_ms,
                 kernels_per_step=per_step,
                 traced_run_elapsed_s=again.elapsed_s)
        print(f"  {kv} pool: {report.format()}", flush=True)
        print(f"  {kv} pool: prefix_hit_rate {report.prefix_hit_rate:.4f}, "
              f"draft_tokens {report.draft_tokens} (accepted "
              f"{report.draft_accepted}, spec_accept_rate "
              f"{report.spec_accept_rate:.4f}), preemptions "
              f"{report.preemptions}; chunk steps {steps}, paged_attention "
              f"launches {launches}; pool {have} B vs {bf16} B as bf16 "
              f"({have / bf16:.3f}x); peak memory {peak:.2f} GiB", flush=True)
        print(f"  {kv} pool, traced run: {per_step:.0f} kernels per chunk "
              f"step, device busy {busy_ms:.1f} ms = "
              f"{100 * busy_ms / (report.elapsed_s * 1e3):.1f}% of the "
              f"untraced run's {report.elapsed_s * 1e3:.1f} ms; "
              f"paged_attention {paged_ms:.2f} ms of device time", flush=True)
        if tokens_of(again) != tokens_of(report):
            raise AssertionError(f"{kv}: a second run of the stream differs")
        if launches[kv] != cfg.n_layers * steps or steps == 0 or \
                sum(launches.values()) != launches[kv]:
            raise AssertionError(
                f"{kv}: paged_attention launches {launches} in {steps} chunk "
                f"steps; expected {cfg.n_layers} per step, all of kind {kv}")
        if not report.prefix_hit_rate or report.draft_tokens == 0:
            raise AssertionError(f"{kv}: prefix_hit_rate "
                                 f"{report.prefix_hit_rate}, draft_tokens "
                                 f"{report.draft_tokens}; both must be > 0")
        got = tokens_of(report)
        if any(len(t) != NEW_TOKENS or not all(0 <= x < cfg.vocab for x in t)
               for t in got) or len(got) != 8:
            raise AssertionError(f"{kv}: not 8 x {NEW_TOKENS} tokens in the "
                                 f"vocabulary")
        out[kv] = (engine, report, s)

    # The int8 stream without speculation, and with a drafter that
    # replays that run's tokens.
    engine = out["int8"][0]
    plain_eng = Engine(cfg, params, ServeConfig(kv_dtype="int8", **base),
                       device="cuda")
    plain = run_server(plain_eng, workload())
    replay = run_server(
        Engine(cfg, params, ServeConfig(kv_dtype="int8", **base, **spec),
               drafter=replay_drafter(plain), device="cuda"), workload())
    s = out["int8"][2]
    s.update(ngram_same_as_plain=same_share(out["int8"][1], plain),
             replay_same_as_plain=same_share(replay, plain),
             replay_draft_tokens=replay.draft_tokens,
             replay_accepted=replay.draft_accepted,
             replay_tokens_per_s=replay.tokens_per_s,
             plain_tokens_per_s=plain.tokens_per_s)
    print(f"  int8 pool, speculation off: {plain.format()}", flush=True)
    print(f"  int8 pool, replay drafter: {replay.format()}; draft_tokens "
          f"{replay.draft_tokens}, accepted {replay.draft_accepted}", flush=True)
    print(f"  tokens equal to the speculation-off run: n-gram "
          f"{100 * s['ngram_same_as_plain']:.1f}%, replay "
          f"{100 * s['replay_same_as_plain']:.1f}% (not gated: a bf16 "
          f"near-tie may flip between a C-token and a 1-token pass)",
          flush=True)
    if replay.draft_accepted == 0:
        raise AssertionError("replay drafter: no draft accepted")
    for kv in ("bfloat16", "int8"):
        print(f"  serve {kv} summary {json.dumps(out[kv][2])}", flush=True)
    int8_launches = out["int8"][2]["launches"]["int8"]
    del out, engine, plain_eng
    torch.cuda.empty_cache()

    phase("serve: gemma-7b full width, int4 pool, offline, prefix cache, "
          "n-gram speculation")
    engine = Engine(cfg, params, ServeConfig(kv_dtype="int4", **base, **spec),
                    device="cuda")
    run_offline(engine, synthetic_requests(cfg, n=2, tokens=2, prompt_len=8,
                                           seed=1))
    pa.reset_launches()
    report = run_offline(engine, workload(INT4_TOKENS, "offline"))
    launches = dict(pa.paged_attention_cuda.launches_by_kind)
    steps = len(report.steps)
    have, bf16 = pool_bytes(engine)
    print(f"  int4 pool: {report.format()}", flush=True)
    print(f"  int4 pool: prefix_hit_rate {report.prefix_hit_rate:.4f}, "
          f"draft_tokens {report.draft_tokens} (accepted "
          f"{report.draft_accepted}); chunk steps {steps}, paged_attention "
          f"launches {launches}; pool {have} B vs {bf16} B as bf16 "
          f"({have / bf16:.3f}x)", flush=True)
    if launches["int4"] != cfg.n_layers * steps or steps == 0 or \
            sum(launches.values()) != launches["int4"]:
        raise AssertionError(
            f"int4: paged_attention launches {launches} in {steps} chunk "
            f"steps; expected {cfg.n_layers} per step, all int4")
    got = tokens_of(report)
    if len(got) != 8 or any(len(t) != INT4_TOKENS for t in got):
        raise AssertionError(f"int4: not 8 x {INT4_TOKENS} tokens")
    s = report.summary()
    s.update(chunk_steps=steps, launches=launches, pool_bytes=have,
             bf16_pool_bytes=bf16)
    print(f"  serve int4 summary {json.dumps(s)}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return int8_launches, launches["int4"]


def reduced_vs_cpu():
    """Reduced gemma-7b in fp32: the card's path (kernel) against the
    CPU's (plain attention) on the same weights: logits of one mixed
    chunk step, then the greedy tokens of a ragged offline workload."""
    phase("check: reduced gemma-7b, card vs CPU plain path, fp32")
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(),
                              dtype="float32", kv_cache_dtype="float32",
                              n_layers=2)
    cpu = lm.init_lm(cfg, 0, device="cpu")
    gpu = tree_map(lambda t: t.to("cuda"), cpu)
    toks = torch.randint(0, cfg.vocab, (3, 4),
                         generator=torch.Generator().manual_seed(0))
    pt = torch.tensor([[7, -1, -1, -1], [2, 9, -1, -1], [-1, -1, -1, -1]],
                      dtype=torch.int32)
    pos = torch.tensor([0, 5, 0], dtype=torch.int32)
    nv = torch.tensor([4, 1, 1], dtype=torch.int32)
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        cache = lm.init_paged_cache(cfg, 12, 4, device=dev)
        g = torch.Generator().manual_seed(1)
        for name in ("kp", "vp"):
            cache[name].copy_(torch.randn(cache[name].shape, generator=g))
        with torch.inference_mode():
            logits, _ = lm.decode_chunk(params, cfg, toks.to(dev), cache,
                                        pt.to(dev), pos.to(dev), nv.to(dev))
        out[dev] = logits[:2].float().cpu()
    err = (out["cpu"] - out["cuda"]).abs().max().item()
    print(f"  decode_chunk logits max|card-cpu| {err:.3e} (tol 1e-3)")
    if not torch.allclose(out["cpu"], out["cuda"], rtol=1e-3, atol=1e-3):
        raise AssertionError(f"reduced logits differ card vs CPU: {err}")
    scfg = ServeConfig(max_batch=3, max_len=32, page_size=4, prefill_chunk=4)
    toks = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        reqs = synthetic_requests(cfg, n=5, tokens=6, prompt_len=14, seed=7,
                                  prompt_lens=(3, 9, 14, 5, 11))
        toks[dev] = tokens_of(run_offline(
            Engine(cfg, params, scfg, device=dev), reqs))
    if toks["cpu"] != toks["cuda"]:
        raise AssertionError("reduced greedy tokens differ card vs CPU")
    print("  greedy tokens identical card vs CPU (5 ragged requests)")


def reference_layout(params, cfg):
    """The port's parameters as the JAX package lays them out, in numpy:
    ``blocks`` one tree per pattern position, each leaf stacked over the
    blocks (what ``lm.params_from_numpy`` takes)."""
    P = len(cfg.block_pattern)
    layers = params["layers"]

    def stack(*xs):
        return np.stack([x.float().cpu().numpy() for x in xs])

    blocks = tuple(tree_map(stack, *layers[j::P]) for j in range(P))
    tree = {k: tree_map(lambda t: t.float().cpu().numpy(), v)
            for k, v in params.items() if k != "layers"}
    return {**tree, "blocks": blocks}


def reduced_jamba_vs_cpu():
    """Reduced jamba-1.5-large (a Mamba + dense, a Mamba + MoE and an
    attention + dense layer) in fp32 from the same ``params_from_numpy``
    weights: the card's path (mamba_scan and flash kernels) against the
    CPU's plain path: prefill logits to 1e-4 of their largest entry, then
    the greedy tokens of a 4-request slab engine."""
    phase("check: reduced jamba-1.5-large, card vs CPU plain path, fp32")
    cfg = dataclasses.replace(get_config(JAMBA).reduced(), dtype="float32",
                              kv_cache_dtype="float32")
    tree = reference_layout(lm.init_lm(cfg, 0, device="cpu"), cfg)
    params = {dev: lm.params_from_numpy(tree, cfg, device=dev)
              for dev in ("cpu", "cuda")}
    toks = torch.randint(0, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(0))
    out = {}
    mk.reset_launches()
    for dev in ("cpu", "cuda"):
        with torch.inference_mode():
            logits, _ = lm.prefill(params[dev], cfg, toks.to(dev))
        out[dev] = logits.float().cpu()
    if mk.mamba_scan_cuda.launches != 2:
        raise AssertionError(f"the card's prefill launched mamba_scan "
                             f"{mk.mamba_scan_cuda.launches} times, not 2")
    err = (out["cpu"] - out["cuda"]).abs().max().item()
    rel = err / out["cpu"].abs().max().item()
    print(f"  prefill logits max|card-cpu| {err:.3e} = {rel:.2e} of the "
          f"largest (tol 1e-4)", flush=True)
    if rel > 1e-4:
        raise AssertionError(f"reduced jamba logits differ card vs CPU: {rel}")
    scfg = ServeConfig(max_batch=4, max_len=40)
    toks = {}
    for dev in ("cpu", "cuda"):
        reqs = synthetic_requests(cfg, n=4, tokens=8, prompt_len=24, seed=3,
                                  prompt_lens=(5, 24, 11, 17))
        eng = Engine(cfg, params[dev], scfg, device=dev)
        if eng.layout != "slab":
            raise AssertionError(f"jamba served from {eng.layout}")
        toks[dev] = tokens_of(run_offline(eng, reqs))
    if toks["cpu"] != toks["cuda"]:
        raise AssertionError("reduced jamba greedy tokens differ card vs CPU")
    print("  greedy tokens identical card vs CPU (4 requests, slab engine)",
          flush=True)


def reduced_jamba_train_vs_cpu():
    """Reduced jamba-1.5-large in fp32 (fp32 gradients and Adam moments)
    from the same ``params_from_numpy`` weights, norm scales perturbed:
    the card's path (the mamba_scan forward and backward kernels, the
    flash kernels, cuBLAS) against the CPU's plain path. The loss to
    rtol 1e-4 and every gradient to 1e-3 of its leaf's largest entry
    (GNMT's check: both sides compute in fp32 and differ in the order of
    their sums), then the losses of 3 Adam steps through ``Trainer.fit``
    to rtol 1e-4."""
    phase("check: reduced jamba-1.5-large training, card vs CPU plain path, "
          "fp32")
    cfg = dataclasses.replace(get_config(JAMBA).reduced(), dtype="float32",
                              kv_cache_dtype="float32", grad_dtype="float32",
                              moment_dtype="float32")
    tree = lm.perturb_norms(reference_layout(
        lm.init_lm(cfg, 1, device="cpu", dtype=torch.float32), cfg), 1)
    toks = torch.randint(0, cfg.vocab, (4, 40),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    mk.reset_launches()
    for dev in ("cpu", "cuda"):
        params = lm.params_from_numpy(tree, cfg, device=dev,
                                      dtype=torch.float32)
        leaves = tree_leaves(params)
        for w in leaves:
            w.requires_grad_(True)
        loss, _ = lm.loss_fn(params, cfg, {"tokens": toks.to(dev)})
        out[dev] = (loss.item(), [g.cpu() for g in
                                  torch.autograd.grad(loss, leaves)])
    n_mamba = sum(s.mixer == "mamba" for s in cfg.block_pattern)
    got = (mk.mamba_scan_cuda.launches, mk.mamba_scan_bwd_cuda.launches)
    if got != (n_mamba, n_mamba):
        raise AssertionError(f"reduced jamba's card step launched mamba_scan "
                             f"forward, backward {got}, not {n_mamba} each")
    (lc, gc_), (lg, gg) = out["cpu"], out["cuda"]
    err = max(((a - b).abs().max() / max(a.abs().max().item(), 1e-12)).item()
              for a, b in zip(gc_, gg))
    print(f"  loss cpu {lc:.6f} card {lg:.6f}; gradients max |card-cpu| / "
          f"max|cpu| {err:.2e} over {len(gc_)} leaves (tol 1e-3); mamba_scan "
          f"launches forward {got[0]}, backward {got[1]}", flush=True)
    if abs(lc - lg) > 1e-4 * abs(lc) or err > 1e-3:
        raise AssertionError(f"reduced jamba training differs card vs CPU: "
                             f"loss {lc} vs {lg}, gradient {err}")
    losses = {}
    for dev in ("cpu", "cuda"):
        params = lm.params_from_numpy(tree, cfg, device=dev,
                                      dtype=torch.float32)
        tr = Trainer(cfg, TrainerConfig(total_steps=3, log_every=0),
                     device=dev, params=params)
        hist = tr.fit(synthetic_lm_batches(cfg, batch=4, seq=40, steps=3))
        losses[dev] = [r["loss"] for r in hist]
    print(f"  3 Adam steps: losses cpu {losses['cpu']}, card "
          f"{losses['cuda']}", flush=True)
    if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4, atol=0):
        raise AssertionError(f"reduced jamba train losses differ card vs "
                             f"CPU: {losses}")


def reduced_quant_vs_cpu():
    """Reduced gemma-7b in fp32 from int8 and int4 pools, with the prefix
    cache and n-gram speculative decoding, on a shared-prefix server
    stream under pool pressure: the card's greedy tokens (kernel
    branches) equal the CPU's (plain path), and equal the card's with
    prefix cache and speculation off; drafts are proposed and the cache
    hits."""
    phase("check: reduced gemma-7b, int8/int4 pools, prefix cache + "
          "speculative decoding, card vs CPU plain path, fp32")
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(),
                              dtype="float32", kv_cache_dtype="float32",
                              n_layers=2)
    cpu = lm.init_lm(cfg, 0, device="cpu")
    gpu = tree_map(lambda t: t.to("cuda"), cpu)
    knobs = dict(max_batch=3, max_len=32, page_size=4, prefill_chunk=6,
                 n_pages=12)

    def workload():
        return synthetic_requests(cfg, n=6, tokens=8, prompt_len=16,
                                  scenario="server", seed=9,
                                  shared_prefix_len=8, n_templates=2)

    for kv in ("int8", "int4"):
        on = ServeConfig(kv_dtype=kv, prefix_cache=True, spec_decode="ngram",
                         draft_len=3, **knobs)
        reps = {dev: run_server(Engine(cfg, params, on, device=dev),
                                workload())
                for dev, params in (("cpu", cpu), ("cuda", gpu))}
        off = run_server(Engine(cfg, gpu, ServeConfig(kv_dtype=kv, **knobs),
                                device="cuda"), workload())
        card = reps["cuda"]
        print(f"  {kv}: drafts {card.draft_tokens} (accepted "
              f"{card.draft_accepted}; cpu {reps['cpu'].draft_tokens}), "
              f"prefix_hit_rate {card.prefix_hit_rate:.3f}, preemptions "
              f"{card.preemptions}", flush=True)
        if tokens_of(card) != tokens_of(reps["cpu"]):
            raise AssertionError(f"reduced {kv} greedy tokens differ card vs "
                                 f"CPU")
        if tokens_of(card) != tokens_of(off):
            raise AssertionError(f"reduced {kv}: prefix cache + speculation "
                                 f"changed the card's greedy tokens")
        if card.draft_tokens == 0 or not card.prefix_hit_rate:
            raise AssertionError(f"reduced {kv}: no draft proposed or no "
                                 f"prefix hit")
        print(f"  {kv}: greedy tokens identical card vs CPU, and with prefix "
              f"cache + speculation off", flush=True)


def reduced_train_vs_cpu():
    """Reduced gemma-7b in fp32: 3 train steps on the card (flash
    kernels, cuBLAS) and on the CPU (plain attention) from the same
    weights and batches. The losses agree within rtol 1e-4: both sides
    compute in fp32, and differ only in the order of their sums (the
    kernels' online softmax, cuBLAS against the CPU's BLAS)."""
    phase("check: reduced gemma-7b training, card vs CPU plain path, fp32")
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(),
                              dtype="float32", n_layers=2)
    init = lm.init_lm(cfg, 0, device="cpu", dtype=torch.float32)
    losses = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), init)
        tr = Trainer(cfg, TrainerConfig(total_steps=3, log_every=0),
                     device=dev, params=params)
        hist = tr.fit(synthetic_lm_batches(cfg, batch=4, seq=64, steps=3))
        losses[dev] = [r["loss"] for r in hist]
    print(f"  losses cpu {losses['cpu']}\n  losses card {losses['cuda']}")
    if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4, atol=0):
        raise AssertionError(f"reduced train losses differ card vs CPU: "
                             f"{losses}")


def gnmt_grads(params, cfg, batch):
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    loss, _ = gnmt.loss_fn(params, cfg, batch)
    return loss.item(), [g.cpu() for g in torch.autograd.grad(loss, leaves)]


def reduced_gnmt_vs_cpu():
    """GNMT_TINY in fp32 on the card (the LSTM kernels, cuBLAS) against
    the CPU's plain path on the same weights: loss and every gradient at
    lengths that make the scans chunk (encoder 70 = 2 x 35, decoder 40 =
    2 x 20), then the losses of 3 Adam steps on the copy task. Both sides
    compute in fp32 and differ only in the order of their sums."""
    phase("check: reduced GNMT (GNMT_TINY), card vs CPU plain path, fp32")
    cfg = dataclasses.replace(gnmt.GNMT_TINY, dtype="float32")
    init = gnmt.init_gnmt(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(1, cfg.vocab, (3, 70)))
    tgt = torch.from_numpy(rng.integers(1, cfg.vocab, (3, 40)))
    mask = torch.ones(3, 40)
    mask[1, 25:] = 0
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), init)
        out[dev] = gnmt_grads(params, cfg, {"src": src.to(dev),
                                            "tgt": tgt.to(dev),
                                            "tgt_mask": mask.to(dev)})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    err = max(((a - b).abs().max() / max(a.abs().max().item(), 1e-12)).item()
              for a, b in zip(gc, gg))
    print(f"  loss cpu {lc:.6f} card {lg:.6f}; gradients max |card-cpu| / "
          f"max|cpu| {err:.2e} over {len(gc)} leaves (tol 1e-3)", flush=True)
    if abs(lc - lg) > 1e-4 * abs(lc) or err > 1e-3:
        raise AssertionError(f"reduced GNMT differs card vs CPU: loss {lc} vs "
                             f"{lg}, gradient {err}")
    copy = torch.from_numpy(rng.integers(1, cfg.vocab, (4, 10)))
    batch = {"src": copy, "tgt": torch.cat([copy[:, :1], copy[:, :-1]], 1)}
    losses = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), init)
        opt = adam(constant(3e-3))
        st = opt.init(params)
        step = gnmt_cli.make_train_step(cfg, opt)
        b = {k: v.to(dev) for k, v in batch.items()}
        losses[dev] = []
        for _ in range(3):
            params, st, loss = step(params, st, b)
            losses[dev].append(loss.item())
    print(f"  3 Adam steps: losses cpu {losses['cpu']}, card "
          f"{losses['cuda']}", flush=True)
    if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4, atol=0):
        raise AssertionError(f"reduced GNMT train losses differ card vs CPU: "
                             f"{losses}")


class SyncEveryStep(Hook):
    """Makes ``fit`` wait for the card after each step, so that
    ``step_ms`` is the step's time on the card."""

    needs_sync = True


def jamba_cut():
    """Full-width jamba-1.5-large cut to 3 layers: positions 0, 1 and 4 of
    its 8-layer pattern, (mamba, dense), (mamba, moe), (attn, dense),
    the three kinds its reduced() keeps; every width published."""
    cfg = get_config(JAMBA)
    pat = cfg.block_pattern
    return dataclasses.replace(cfg, n_layers=3,
                               block_pattern=(pat[0], pat[1], pat[4]))


def timed_and_traced(fn, reps=3):
    """(median host ms of ``fn`` to the card's end over ``reps`` runs,
    device-busy ms of one traced run, its kernels by device time)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    _, busy, kernels = trace_busy(fn)
    return float(np.median(times)), busy, kernels


def jamba_workload(cfg):
    """Phase 4's 8 ragged requests of ``NEW_TOKENS`` tokens."""
    return synthetic_requests(cfg, n=8, tokens=NEW_TOKENS,
                              prompt_len=max(PROMPT_LENS), seed=0,
                              prompt_lens=PROMPT_LENS)


def jamba_scfg():
    return ServeConfig(max_batch=8, max_len=max(PROMPT_LENS) + NEW_TOKENS,
                       kv_layout="slab")


def jamba_params():
    """The 3-layer cut's random bf16 weights from seed 0, on the card."""
    gc.collect()  # earlier phases' reference cycles still hold memory
    torch.cuda.empty_cache()
    return lm.init_lm(jamba_cut(), seed=0, device="cuda")


def serve_jamba_full(params=None):
    """Full-width jamba (the 3-layer cut, random bf16 weights from seed
    0, made here unless given) serves 8 ragged requests offline through
    the slab engine: each prefill runs both Mamba layers through
    mamba_scan and the attention layer through the flash forward
    (asserted by the counters, zeroed just before), a second run repeats
    the tokens, and one decode step and one prefill are traced. Returns
    (mamba_scan launches, flash launches, the greedy tokens)."""
    cfg = jamba_cut()
    phase("serve: jamba-1.5-large full width, 3-layer cut (mamba+dense, "
          "mamba+moe, attn+dense), bf16, slab, offline")
    n = cfg.param_count()
    print(f"  {n} parameters ({n * 2 / 2**30:.1f} GiB in bf16); d_model "
          f"{cfg.d_model}, Di {cfg.mamba.expand * cfg.d_model}, "
          f"{cfg.moe.n_experts} experts of d_ff {cfg.d_ff} top-"
          f"{cfg.moe.top_k}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab}", flush=True)
    gc.collect()  # earlier phases' reference cycles still hold memory
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if params is None:
        held = torch.cuda.memory_allocated() / 2**30
        params = jamba_params()
        torch.cuda.synchronize()
        made = torch.cuda.memory_allocated() / 2**30 - held
    else:
        made = sum(t.numel() * t.element_size()
                   for t in tree_leaves(params)) / 2**30
        held = torch.cuda.memory_allocated() / 2**30 - made
    print(f"  init in {time.perf_counter() - t0:.1f} s, {made:.2f} GiB of "
          f"weights ({held:.2f} GiB held by the process before the phase)",
          flush=True)
    scfg = jamba_scfg()
    engine = Engine(cfg, params, scfg, device="cuda")
    run_offline(engine, synthetic_requests(cfg, n=2, tokens=2, prompt_len=8,
                                           seed=1))  # warm-up

    def workload():
        return jamba_workload(cfg)

    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    fa.flash_attention_fwd_cuda.launches = 0
    report = run_offline(engine, workload())
    launches = mk.mamba_scan_cuda.launches
    flash = fa.flash_attention_fwd_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    s = report.summary()
    print(f"  {report.format()}", flush=True)
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.block_pattern)
    print(f"  mamba_scan launches {launches} (expected {n_mamba} x 8), "
          f"flash forward launches {flash} (expected 8, one a prefill), "
          f"peak memory {peak:.2f} GiB ({held:.2f} GiB held before the "
          f"phase)", flush=True)
    if launches != n_mamba * 8 or flash != 8:
        raise AssertionError(f"launches: mamba_scan {launches}, flash {flash}")
    got = tokens_of(report)
    if len(got) != 8 or any(len(t) != NEW_TOKENS for t in got):
        raise AssertionError(f"not every request got {NEW_TOKENS} tokens")
    if any(not 0 <= tok < cfg.vocab for t in got for tok in t):
        raise AssertionError("token id out of the vocabulary")
    again = tokens_of(run_offline(engine, workload()))
    if again != got:
        raise AssertionError("a second run of the same workload differs")
    print("  a second run gives the same greedy tokens", flush=True)

    # One prefill of a 128-token prompt, and one decode step over 8 slots
    # that each hold that prompt, timed and traced.
    B, S = scfg.max_batch, max(PROMPT_LENS)
    prompt = torch.randint(0, cfg.vocab, (1, S), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(2))
    last = torch.full((1,), S - 1, dtype=torch.long, device="cuda")
    slab = slab_ops.init_slab(cfg, B, scfg.max_len, device="cuda")
    with torch.inference_mode():
        _, cache = lm.prefill(params, cfg, prompt, cache_len=scfg.max_len,
                              last_pos=last)
        for slot in range(B):
            slab_ops.write_slot(slab, cache, slot)
    tok = torch.zeros((B, 1), dtype=torch.long, device="cuda")
    pos = torch.full((B,), S, dtype=torch.long, device="cuda")

    def decode():
        with torch.inference_mode():
            lm.decode_step(params, cfg, tok, slab, pos)

    def prefill():
        with torch.inference_mode():
            lm.prefill(params, cfg, prompt, cache_len=scfg.max_len,
                       last_pos=last)

    readings = {}
    for name, fn in (("decode step", decode), ("prefill", prefill)):
        ms, busy, kernels = timed_and_traced(fn)
        scan_ms = sum(e.self_device_time_total for e in kernels
                      if "mamba_scan" in e.key) / 1e3
        readings[name] = dict(ms=ms, busy_ms=busy, mamba_scan_ms=scan_ms)
        print(f"  {name}: {ms:.2f} ms (median of 3, to the card's end); "
              f"traced: {sum(e.count for e in kernels)} kernels, device "
              f"busy {busy:.2f} ms = {100 * busy / ms:.1f}%, mamba_scan "
              f"{scan_ms:.3f} ms = {100 * scan_ms / max(busy, 1e-9):.2f}% of "
              f"device time; top kernels:", flush=True)
        for e in kernels[:8]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:5d}x {e.key[:100]}")
    s.update(peak_mem_gib=peak, held_before_gib=held,
             mamba_scan_launches=launches,
             flash_launches=flash, readings=readings, n_params=n)
    print(f"  jamba serve summary {json.dumps(s)}", flush=True)
    del engine, params, slab, cache, report
    gc.collect()
    torch.cuda.empty_cache()
    return launches, flash, got


def full_train_config():
    return dataclasses.replace(get_config("gemma-7b"),
                               n_layers=TRAIN_LAYERS)


def run_trainer(cfg, steps, batch=TRAIN_BATCH):
    """A fresh trainer (weights from seed 0) fitted for ``steps`` steps of
    ``synthetic_lm_batches(seed=0)``; returns (trainer, history)."""
    tr = Trainer(cfg, TrainerConfig(total_steps=steps, log_every=1),
                 device="cuda")
    hist = tr.fit(synthetic_lm_batches(cfg, batch=batch,
                                       seq=TRAIN_SEQ, steps=steps, seed=0),
                  hooks=tr.default_hooks() + [SyncEveryStep()])
    return tr, hist


def kernel_kind(name: str) -> str:
    """Coarse class of a kernel, from its name."""
    for kind, marks in (("flash", ("flash_",)),
                        ("gemm", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
                        ("copy/cast", ("direct_copy", "copy_kernel")),
                        ("reduction", ("reduce_kernel", "softmax", "logsumexp")),
                        ("elementwise", ("elementwise",))):
        if any(m in name for m in marks):
            return kind
    return "other"


def train_full():
    phase(f"train: gemma-7b full width, {TRAIN_LAYERS} layers, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, fp32 masters, bf16 compute, remat")
    cfg = full_train_config()
    if not cfg.remat:
        raise AssertionError("the full config trains with remat")
    eval_fn = synthetic_eval_set(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    n_eval = sum(1 for _ in eval_fn())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fa.flash_attention_fwd_cuda.launches = 0
    fa.flash_attention_bwd_cuda.launches = 0
    tr, hist = run_trainer(cfg, TRAIN_STEPS)
    ev = tr.evaluate(eval_fn)
    torch.cuda.synchronize()
    launches = (fa.flash_attention_fwd_cuda.launches,
                fa.flash_attention_bwd_cuda.launches)
    wall = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(tr.state["params"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in hist]
    print(f"  {n_params / 1e9:.3f} B params; {TRAIN_STEPS} steps + eval "
          f"({n_eval} batches) in {wall:.1f} s; losses {losses}; eval_nll "
          f"{ev['eval_nll']:.4f}; peak memory {peak:.2f} GiB", flush=True)
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)) \
            or not np.isfinite(ev["eval_nll"]):
        raise AssertionError(f"non-finite or missing losses: {hist}, {ev}")
    want = (2 * cfg.n_layers * TRAIN_STEPS + cfg.n_layers * n_eval,
            cfg.n_layers * TRAIN_STEPS)
    print(f"  flash launches: forward {launches[0]}, backward {launches[1]} "
          f"(expected {want[0]}, {want[1]})", flush=True)
    if launches != want:
        raise AssertionError(f"flash kernel launches {launches} != {want}")
    step_ms = float(np.median([r["step_ms"] for r in hist[1:]]))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    print(f"  step {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}: "
          f"{[round(r['step_ms'], 1) for r in hist]}), {tok_s:.0f} tokens/s",
          flush=True)

    # One more step, traced: where the card's time goes.
    from torch.profiler import ProfilerActivity, profile

    batch = {"tokens": torch.from_numpy(next(iter(synthetic_lm_batches(
        cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=1, seed=7)))["tokens"]
    ).cuda()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.state, _ = tr._train_step(tr.state, batch)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    flash_ms = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key) / 1e3
    print(f"  traced step: {sum(e.count for e in kernels)} kernels, device "
          f"busy {busy_ms:.1f} ms = {100 * busy_ms / step_ms:.1f}% of the "
          f"untraced step's {step_ms:.1f} ms; flash kernels {flash_ms:.1f} "
          f"ms = {100 * flash_ms / busy_ms:.1f}% of device time; top "
          f"kernels:", flush=True)
    for e in kernels[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
              f"{e.key[:100]}")
    by_kind = {}
    for e in kernels:
        kind = kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    print("  device time by kind: " + ", ".join(
        f"{k} {v:.1f} ms ({100 * v / busy_ms:.1f}%)"
        for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])),
        flush=True)
    summary = dict(step_ms=step_ms, tokens_per_s=tok_s, peak_mem_gib=peak,
                   losses=losses, eval_nll=ev["eval_nll"],
                   device_busy_ms=busy_ms, flash_ms=flash_ms,
                   by_kind_ms=by_kind, n_params=n_params)
    print(f"  train summary {json.dumps(summary)}", flush=True)
    del tr, batch, prof
    torch.cuda.empty_cache()

    # The same seed again, 2 steps: the same losses.
    tr, again = run_trainer(cfg, 2)
    again = [r["loss"] for r in again]
    del tr
    torch.cuda.empty_cache()
    same = again == losses[:2]
    print(f"  second run, 2 steps: losses {again} "
          f"({'bitwise equal' if same else 'not bitwise equal'})", flush=True)
    if not np.allclose(again, losses[:2], rtol=1e-5, atol=0):
        raise AssertionError(f"a second run differs: {again} vs {losses[:2]}")
    return launches


def gnmt_launches(L):
    """LSTM kernel launches of one GNMT train step on src = tgt of padded
    length L: forward 5L encoder cells (the bidirectional layer's two
    directions and three uni layers; one scan chunk for L <= 64) plus 4L
    decoder cells, run twice when the decoder's scan has more than one
    chunk (the checkpointed chunks recompute); backward once per cell."""
    if L // _largest_divisor_leq(L, 64) > 1:
        raise ValueError(f"L {L}: the encoder's scan would chunk")
    r = 2 if L // _largest_divisor_leq(L, 32) > 1 else 1
    return 5 * L + 4 * L * r, 9 * L


def gnmt_stream(cfg, seed=0):
    """The smoke's bucketized copy-task batches, prefetched: 16 batches'
    worth of sentences of 4-50 tokens, window 6."""
    examples = gnmt_cli.synthetic_sentences(
        cfg.vocab, GNMT_BATCH * 16, GNMT_MAX_LEN, seed=seed)
    return prefetch(bucketized_batches(examples, GNMT_BATCH,
                                       window=GNMT_WINDOW), size=2)


def train_gnmt_full():
    """Full-width GNMT (GNMTConfig(): F 1024, 4 + 4 layers, vocab 32000,
    bf16 compute, fp32 masters, random weights from seed 0) takes 6 steps
    of batch 128 through ``launch.gnmt.train``; the LSTM kernels'
    counters, zeroed just before, must match ``gnmt_launches`` in every
    step. Then one step traced (device busy share), and the C9 and cuDNN
    readings."""
    cfg = gnmt.GNMTConfig()
    phase(f"train: GNMT full width (F {cfg.d_model}, {cfg.n_enc_layers} + "
          f"{cfg.n_dec_layers} layers, vocab {cfg.vocab}, {cfg.dtype}), batch "
          f"{GNMT_BATCH}, bucketized sentences of 4-{GNMT_MAX_LEN} tokens, "
          f"window {GNMT_WINDOW}, {GNMT_STEPS} steps")
    gc.collect()  # earlier phases' reference cycles still hold memory
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    params = gnmt.init_gnmt(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    # Warm-up: one loss and gradient at the longest length, no update, so
    # that the allocator and cuBLAS have met the largest shapes before the
    # timed steps.
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, (GNMT_BATCH, GNMT_MAX_LEN))).cuda()
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    torch.autograd.grad(gnmt.loss_fn(params, cfg, {"src": toks,
                                                   "tgt": toks})[0], leaves)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stream = gnmt_stream(cfg)
    lk.lstm_cell_fwd_cuda.launches = 0
    lk.lstm_cell_bwd_cuda.launches = 0
    try:
        hist = gnmt_cli.train(cfg, params, stream, steps=GNMT_STEPS,
                              device="cuda")
    finally:
        stream.close()
    torch.cuda.synchronize()
    launches = (lk.lstm_cell_fwd_cuda.launches,
                lk.lstm_cell_bwd_cuda.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in hist]
    print(f"  {n_params} params; lengths {[r['len'] for r in hist]}; losses "
          f"{losses}; peak memory {peak:.2f} GiB ({held:.2f} GiB held by "
          f"the process before the phase)", flush=True)
    if len(hist) != GNMT_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite or missing losses: {hist}")
    lnv = float(np.log(cfg.vocab))
    if not 0.5 * lnv < losses[0] < 2 * lnv:
        raise AssertionError(f"first loss {losses[0]} far from ln(vocab) "
                             f"{lnv}: random weights should predict ~uniformly")
    for r in hist:
        want = gnmt_launches(r["len"])
        print(f"  step {r['batch']}: L {r['len']}, {r['tokens']} target "
              f"tokens, {r['step_ms']:.1f} ms, lstm launches forward "
              f"{r['fwd_launches']}, backward {r['bwd_launches']} (expected "
              f"{want[0]}, {want[1]})", flush=True)
        if (r["fwd_launches"], r["bwd_launches"]) != want:
            raise AssertionError(f"step {r['batch']}: lstm launches "
                                 f"{(r['fwd_launches'], r['bwd_launches'])} "
                                 f"!= {want}")
    if launches != tuple(map(sum, zip(*(gnmt_launches(r["len"])
                                        for r in hist)))):
        raise AssertionError(f"lstm launches {launches} in the run do not "
                             f"add up")
    steady = hist[1:]
    step_ms = float(np.median([r["step_ms"] for r in steady]))
    tok_s = (sum(r["tokens"] for r in steady)
             / (sum(r["step_ms"] for r in steady) / 1e3))
    print(f"  step {step_ms:.1f} ms (median of steps 2-{GNMT_STEPS}), "
          f"{tok_s:.0f} target tokens/s (steps 2-{GNMT_STEPS}); lstm launches "
          f"forward {launches[0]}, backward {launches[1]}", flush=True)

    # One step at the longest length, untimed-then-timed-then-traced.
    opt = adam(constant(2e-3))
    st = opt.init(params)
    step = gnmt_cli.make_train_step(cfg, opt)
    L = GNMT_MAX_LEN
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab, (GNMT_BATCH, L))).cuda()
    batch = {"src": toks, "tgt": toks,
             "tgt_mask": torch.ones(toks.shape, device="cuda")}
    step(params, st, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, st, batch)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    _, busy_ms, kernels = trace_busy(lambda: step(params, st, batch))
    lstm_ms = {k: sum(e.self_device_time_total for e in kernels
                      if k in e.key) / 1e3
               for k in ("lstm_fwd_kernel", "lstm_bwd_kernel")}
    n_k = sum(e.count for e in kernels)
    print(f"  traced step at L {L}: {n_k} kernels, device busy {busy_ms:.1f} "
          f"ms = {100 * busy_ms / one_ms:.1f}% of the same step untraced "
          f"({one_ms:.1f} ms); lstm_fwd_kernel {lstm_ms['lstm_fwd_kernel']:.1f}"
          f" ms, lstm_bwd_kernel {lstm_ms['lstm_bwd_kernel']:.1f} ms of device "
          f"time; top kernels:", flush=True)
    for e in kernels[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
              f"{e.key[:100]}")
    summary = dict(step_ms=step_ms, target_tokens_per_s=tok_s,
                   peak_mem_gib=peak, held_before_gib=held, losses=losses,
                   lengths=[r["len"] for r in hist],
                   step_ms_all=[r["step_ms"] for r in hist],
                   l50_step_ms=one_ms, l50_device_busy_ms=busy_ms,
                   l50_busy_share=busy_ms / one_ms, l50_kernels=n_k,
                   l50_lstm_device_ms=lstm_ms, n_params=n_params)
    print(f"  gnmt train summary {json.dumps(summary)}", flush=True)
    del st, step
    gnmt_readings(cfg, params)
    del params
    torch.cuda.empty_cache()
    return launches


def host_ms(fn, reps=5):
    """Median host ms of ``fn`` to a synchronised card, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def gnmt_readings(cfg, params):
    """Reported, not gated: the encoder's forward hoisted against in-loop
    (C9, as benchmarks/gnmt_hoist.py) at batch 2 and 128, L 50; and one
    uni LSTM layer (B 128, L 50, F 1024) through the port against cuDNN's
    ``torch.nn.LSTM`` (fp16: PyTorch sends bf16 RNNs to its own loop,
    not cuDNN), forward and forward + backward."""
    phase("readings: GNMT encoder hoisted vs in-loop (C9); one LSTM layer vs "
          "cuDNN")
    L, F = GNMT_MAX_LEN, cfg.d_model
    rng = np.random.default_rng(3)
    out = {}
    for B in (2, GNMT_BATCH):
        src = torch.from_numpy(rng.integers(1, cfg.vocab, (B, L))).cuda()
        for hoist in (True, False):
            c = dataclasses.replace(cfg, hoist_input_projection=hoist)
            with torch.no_grad():
                out[(B, hoist)] = host_ms(lambda: gnmt.encode(params, c, src))
        print(f"  encoder forward B {B} L {L}: hoisted {out[(B, True)]:.2f} "
              f"ms, in-loop {out[(B, False)]:.2f} ms (speedup "
              f"{out[(B, False)] / out[(B, True)]:.2f}x)", flush=True)
    B = GNMT_BATCH
    x = torch.randn(B, L, F, device="cuda").to(torch.bfloat16)
    prm = params["enc2"]
    lstm = torch.nn.LSTM(F, F, batch_first=True).cuda().half()
    xh = x.half()
    with torch.no_grad():
        port_f = host_ms(lambda: gnmt.lstm_layer(prm, x, cfg))
        cudnn_f = host_ms(lambda: lstm(xh))
    xg, xhg = x.clone().requires_grad_(), xh.clone().requires_grad_()
    port_fb = host_ms(lambda: gnmt.lstm_layer(prm, xg, cfg).float().sum()
                      .backward())
    cudnn_fb = host_ms(lambda: lstm(xhg)[0].float().sum().backward())
    print(f"  one uni LSTM layer B {B} L {L} F {F}: port (bf16, hoisted, lstm "
          f"kernels) forward {port_f:.2f} ms, forward+backward {port_fb:.2f} "
          f"ms; cuDNN torch.nn.LSTM (fp16) forward {cudnn_f:.2f} ms, "
          f"forward+backward {cudnn_fb:.2f} ms", flush=True)
    print("  gnmt readings " + json.dumps(dict(
        encoder_fwd_ms={f"B{b}_{'hoisted' if h else 'inloop'}": v
                        for (b, h), v in out.items()},
        layer_port_fwd_ms=port_f, layer_port_fwd_bwd_ms=port_fb,
        layer_cudnn_fwd_ms=cudnn_f, layer_cudnn_fwd_bwd_ms=cudnn_fb)),
        flush=True)
    for w in tree_leaves(params):
        w.grad = None
    del lstm, x, xh, xg, xhg


# --------------------------------------------------------------------------- #
# ResNet-50 + LARS.
# --------------------------------------------------------------------------- #
RESNET_BATCH, RESNET_SIZE = 128, 224
RESNET_STEPS, RESNET_UNSCALED_STEPS = 6, 2


def resnet_grads(params, cfg, batch):
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    loss, _ = resnet.loss_fn(params, cfg, batch)
    return loss.item(), [g.cpu() for g in torch.autograd.grad(loss, leaves)]


def reduced_resnet_vs_cpu():
    """RESNET_TINY widths in fp32 with the stride-2 stem and its max pool
    at 32 x 32 (so the asymmetric SAME pads run), on the card (cuDNN with
    TF32 off, the LARS kernels for leaves of >= 1024 elements) against the
    CPU's plain path on the same weights: the loss within rtol 1e-5, every
    gradient within 1e-3 of its largest entry, then 3 LARS steps of each
    rule, losses within rtol 1e-4. Both sides compute in fp32 and differ
    only in the order of their sums."""
    phase("check: reduced ResNet (RESNET_TINY widths, stride-2 stem + pool, "
          "32 x 32), card vs CPU plain path, fp32")
    cfg = dataclasses.replace(resnet.RESNET_TINY, dtype="float32",
                              stem_stride=2, stem_pool=True)
    init = resnet.init_resnet(cfg, seed=0, device="cpu")
    imgs, labels = resnet_cli.synthetic_images(
        8, 32, cfg.num_classes, np.random.default_rng(0))
    batch = {"images": torch.from_numpy(imgs),
             "labels": torch.from_numpy(labels)}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            params = tree_map(lambda t: t.to(dev, copy=True), init)
            out[dev] = resnet_grads(params, cfg, {k: v.to(dev)
                                                  for k, v in batch.items()})
        (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
        err = max(((a - b).abs().max() / max(a.abs().max().item(), 1e-12)
                   ).item() for a, b in zip(gc, gg))
        print(f"  loss cpu {lc:.7f} card {lg:.7f}; gradients max |card-cpu| "
              f"/ max|cpu| {err:.2e} over {len(gc)} leaves (tol 1e-3)",
              flush=True)
        if abs(lc - lg) > 1e-5 * abs(lc) or err > 1e-3:
            raise AssertionError(f"reduced ResNet differs card vs CPU: loss "
                                 f"{lc} vs {lg}, gradient {err}")
        kernel_leaves = sum(w.dim() > 1 and w.numel() >= 1024
                            for w in tree_leaves(init))
        for scaled in (True, False):
            losses = {}
            for dev in ("cpu", "cuda"):
                params = tree_map(lambda t: t.to(dev, copy=True), init)
                b = {k: v.to(dev) for k, v in batch.items()}
                lk_lars.reset_launches()
                hist = resnet_cli.train(
                    cfg, params, lars(polynomial_warmup(0.5, 2, 30),
                                      scaled_momentum=scaled),
                    b, steps=3, device=dev, log=lambda _: None)
                losses[dev] = [r["loss"] for r in hist]
                launches = [(r["norm_launches"], r["update_launches"])
                            for r in hist]
            want = (int(kernel_leaves > 0),) * 2  # one of each, <= 64 leaves
            print(f"  3 LARS steps ({'scaled' if scaled else 'unscaled'}): "
                  f"losses cpu {losses['cpu']}, card {losses['cuda']}; card "
                  f"launches a step {launches[0]} (expected norms "
                  f"{want[0]}, update {want[1]})", flush=True)
            if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4,
                               atol=0):
                raise AssertionError(f"reduced ResNet LARS losses differ card "
                                     f"vs CPU: {losses}")
            if launches != [want] * 3:
                raise AssertionError(f"lars launches {launches}, expected "
                                     f"{want} a step")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def resnet_run(cfg, batch, eval_set):
    """Weights from seed 0, then RESNET_STEPS steps of scaled LARS and
    RESNET_UNSCALED_STEPS of unscaled LARS, both under
    ``polynomial_warmup(0.25, 2, 8)``, then one sweep of the padded eval
    set. Returns (params, history, (top-1, count))."""
    params = resnet.init_resnet(cfg, seed=0, device="cuda")
    total = RESNET_STEPS + RESNET_UNSCALED_STEPS
    hist = []
    for scaled, steps in ((True, RESNET_STEPS),
                          (False, RESNET_UNSCALED_STEPS)):
        opt = lars(polynomial_warmup(resnet_cli.BASE_LR, 2, total),
                   scaled_momentum=scaled)
        hist += resnet_cli.train(cfg, params, opt, batch, steps=steps,
                                 device="cuda", log=lambda _: None)
    return params, hist, resnet_cli.evaluate(cfg, params, eval_set)


def train_resnet_full():
    """Full-width ResNet-50 v1.5 (RESNET50: 224 x 224, 1000 classes, bf16
    compute, fp32 masters, gradients and momenta) takes 6 steps of batch
    128 under scaled LARS and 2 under unscaled LARS, then one sweep of
    the padded eval set, through ``launch.resnet.train``; the LARS
    kernels' counters, zeroed just before, must show 1 norms launch and 1
    update launch (each over the 54 kernel leaves) in every step (every
    kernel leaf of ResNet-50 is at least 4096 elements). Then one step
    traced, and a second run of the
    same steps must repeat the losses bitwise (cuDNN held to its
    deterministic algorithms for the phase)."""
    cfg = resnet.RESNET50
    phase(f"train: ResNet-50 v1.5 full width, {RESNET_SIZE} x {RESNET_SIZE}, "
          f"batch {RESNET_BATCH}, bf16 compute, fp32 masters, LARS scaled "
          f"{RESNET_STEPS} steps + unscaled {RESNET_UNSCALED_STEPS}, padded "
          f"eval")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    rng = np.random.default_rng(0)
    imgs, labels = resnet_cli.synthetic_images(RESNET_BATCH, RESNET_SIZE,
                                               cfg.num_classes, rng)
    batch = {"images": torch.from_numpy(imgs).cuda(),
             "labels": torch.from_numpy(labels).cuda()}
    eval_set = resnet_cli.padded_eval_set(cfg, RESNET_SIZE, rng, "cuda")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.reset_peak_memory_stats()
        lk_lars.reset_launches()
        params, hist, (top1, count) = resnet_run(cfg, batch, eval_set)
        torch.cuda.synchronize()
        launches = (lk_lars.lars_norms_cuda.launches
                    + lk_lars.lars_norms_multi_cuda.launches,
                    lk_lars.lars_apply_cuda.launches
                    + lk_lars.lars_apply_multi_cuda.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        leaves = tree_leaves(params)
        kernel_leaves = sum(w.dim() > 1 for w in leaves)
        n_params = sum(w.numel() for w in leaves)
        losses = [r["loss"] for r in hist]
        for r in hist:
            print(f"  step {r['step']}: loss {r['loss']:.6f}, acc "
                  f"{r['acc']:.4f}, {r['step_ms']:.1f} ms, lars launches norms "
                  f"{r['norm_launches']}, update {r['update_launches']} "
                  f"(expected 1 and 1)", flush=True)
        print(f"  {n_params} params, {kernel_leaves} kernel leaves; eval "
              f"top-1 {top1:.4f} over {count} real examples (padded to "
              f"{resnet_cli.EVAL_BATCH * len(eval_set)}); lars launches in "
              f"the run: norms {launches[0]}, update {launches[1]}; peak "
              f"memory {peak:.2f} GiB ({held:.2f} GiB held before the phase)",
              flush=True)
        if n_params != 25_557_032 or kernel_leaves != 54:
            raise AssertionError(f"ResNet-50 has {n_params} params in "
                                 f"{kernel_leaves} kernel leaves")
        if not all(np.isfinite(losses)) or count != resnet_cli.EVAL_IMAGES:
            raise AssertionError(f"non-finite losses or eval count: {hist}")
        lnc = float(np.log(cfg.num_classes))
        if not 0.5 * lnc < losses[0] < 2 * lnc:
            raise AssertionError(f"first loss {losses[0]} far from ln(1000)")
        bad = [r for r in hist if (r["norm_launches"], r["update_launches"])
               != (1, 1)]
        if bad or launches != (len(hist), len(hist)):
            raise AssertionError(f"lars launches per step not 1 norms and 1 "
                                 f"update: {bad}, run total {launches}")
        step_ms = float(np.median([r["step_ms"]
                                   for r in hist[1:RESNET_STEPS]]))
        img_s = RESNET_BATCH / (step_ms / 1e3)
        print(f"  step {step_ms:.1f} ms (median of steps 2-{RESNET_STEPS}), "
              f"{img_s:.0f} images/s", flush=True)

        # One more step, untimed, timed, then traced; and the optimizer's
        # update alone: host enqueue time against its time to the card.
        opt = lars(polynomial_warmup(resnet_cli.BASE_LR, 2, 8))
        st = opt.init(params)
        step = resnet_cli.make_train_step(cfg, opt)
        step(params, st, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, st, batch)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t0) * 1e3
        _, busy_ms, kernels = trace_busy(lambda: step(params, st, batch))
        lars_ms = sum(e.self_device_time_total for e in kernels
                      if "lars_" in e.key) / 1e3
        n_k = sum(e.count for e in kernels)
        print(f"  traced step: {n_k} kernels, device busy {busy_ms:.1f} ms = "
              f"{100 * busy_ms / one_ms:.1f}% of the same step untraced "
              f"({one_ms:.1f} ms); lars kernels {lars_ms:.3f} ms = "
              f"{100 * lars_ms / busy_ms:.2f}% of device time; top kernels:",
              flush=True)
        for e in kernels[:12]:
            print(f"    {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
                  f"{e.key[:100]}")
        by_kind = {}
        for e in kernels:
            kind = kernel_kind(e.key)
            by_kind[kind] = (by_kind.get(kind, 0.0)
                             + e.self_device_time_total / 1e3)
        print("  device time by kind: " + ", ".join(
            f"{k} {v:.1f} ms ({100 * v / busy_ms:.1f}%)"
            for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])),
            flush=True)
        grads = [torch.zeros_like(w) for w in leaves]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.update(grads, st, params)
        enq_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        upd_ms = (time.perf_counter() - t0) * 1e3
        # ... and its 54 kernel leaves alone, as the optimizer calls them
        lr = torch.full((), resnet_cli.BASE_LR, device="cuda")
        triples = [(w, g, m) for w, g, m in zip(
            leaves, grads, tree_leaves(st["m"])) if w.dim() > 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.lars_update_leaves(*map(list, zip(*triples)), lr=lr, **LARS_HYPER)
        lars_enq_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        lars_host_ms = (time.perf_counter() - t0) * 1e3
        print(f"  optimizer update alone: host enqueue {enq_ms:.2f} ms, to "
              f"the card's end {upd_ms:.2f} ms; its {len(triples)} kernel "
              f"leaves alone (2 lars launches): host enqueue "
              f"{lars_enq_ms:.2f} ms ({1e3 * lars_enq_ms / len(triples):.1f} "
              f"us a leaf), to the card's end {lars_host_ms:.2f} ms, against "
              f"{lars_ms:.3f} ms of lars device time in the traced step",
              flush=True)
        summary = dict(step_ms=step_ms, images_per_s=img_s, peak_mem_gib=peak,
                       held_before_gib=held, losses=losses,
                       step_ms_all=[r["step_ms"] for r in hist],
                       eval_top1=top1, launches=launches,
                       traced_step_ms=one_ms, device_busy_ms=busy_ms,
                       busy_share=busy_ms / one_ms, kernels_per_step=n_k,
                       lars_device_ms=lars_ms, by_kind_ms=by_kind,
                       update_enqueue_ms=enq_ms, update_ms=upd_ms,
                       lars_leaves_enqueue_ms=lars_enq_ms,
                       lars_leaves_ms=lars_host_ms,
                       n_params=n_params)
        print(f"  resnet train summary {json.dumps(summary)}", flush=True)
        del params, leaves, st, step, grads, kernels, triples
        gc.collect()
        torch.cuda.empty_cache()

        _, again, _ = resnet_run(cfg, batch, eval_set)
        again = [r["loss"] for r in again]
        print(f"  second run: losses {again} ("
              f"{'bitwise equal' if again == losses else 'NOT bitwise equal'})",
              flush=True)
        if again != losses:
            raise AssertionError(f"a second run differs: {again} vs {losses}")
    finally:
        torch.backends.cudnn.deterministic = det
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# Phase 4b: temperature sampling at full width.
# --------------------------------------------------------------------------- #
SAMPLE_T = 0.8
# Random123's kat_vectors for threefry2x32_20: (key, counter) -> out.
THREEFRY_KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                 (0x1CB996FC, 0xBB002BE7)),
                ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                 (0xC4923A9C, 0x483DF7A0))]
# fold_in(fold_in(PRNGKey(seed), rid), pos), from jax.random.key_data
# (the same table as tests/test_torch_random.py:KEY_WORDS).
KEY_WORDS = {(0, 0, 0): (0xF84E8312, 0x2FEF64F3),
             (0, 100, 133): (0xAC830C4B, 0x2A29DA69),
             (0, 107, 160): (0x44563976, 0x804B3348),
             (2**31 - 1, 7, 159): (0x9FDCBB65, 0x8241141D),
             (1, 2**32 - 1, 131071): (0x7FBA2311, 0xFCFBF4D7)}
FREQ_KEYS, FREQ_ROWS, FREQ_BINS, FREQ_TV = 65536, 1024, 32, 0.02


def check_sampler_bits():
    """The port's threefry on the card: the published known answers, the
    key words JAX gives, and keys and uniform bits bitwise equal to the
    CPU's for the same (seed, rid, pos)."""
    dev = "cuda"
    for (k0, k1), (x0, x1), want in THREEFRY_KAT:
        got = rnd.threefry2x32(*(torch.tensor(v, device=dev)
                                 for v in (k0, k1, x0, x1)))
        if tuple(int(v) for v in got) != want:
            raise AssertionError(f"threefry known answer {want}: got "
                                 f"{[hex(int(v)) for v in got]}")
    for (seed, rid, pos), want in KEY_WORDS.items():
        got = rnd.fold_in(rnd.fold_in(rnd.prng_key(seed, dev), rid), pos)
        if tuple(got.tolist()) != want:
            raise AssertionError(f"key words of {(seed, rid, pos)}: "
                                 f"{got.tolist()} != {want}")
    rids = torch.arange(100, 108)
    pos = torch.tensor([133, 160, 21, 129, 65, 96, 152, 41])
    for seed in (0, 1, 2**31 - 1):
        keys = {d: rnd.fold_in(rnd.fold_in(rnd.prng_key(seed, d),
                                           rids.to(d)), pos.to(d))
                for d in ("cpu", dev)}
        if not torch.equal(keys["cpu"], keys[dev].cpu()):
            raise AssertionError(f"seed {seed}: card keys differ from CPU")
        for width in (8, 32):
            a = rnd.random_bits(keys[dev], width, (get_config("gemma-7b")
                                                  .vocab,))
            b = rnd.random_bits(keys["cpu"], width, (a.shape[-1],))
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{width}-bit draws differ card/CPU")
        for dt in (torch.bfloat16, torch.float32):
            a = rnd.uniform(keys[dev], (4096,), dt)
            b = rnd.uniform(keys["cpu"], (4096,), dt)
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{dt} uniforms differ card/CPU")
    print(f"  threefry: {len(THREEFRY_KAT)} known answers, "
          f"{len(KEY_WORDS)} JAX key words, keys and 8/32-bit draws and "
          f"bf16/fp32 uniforms (8 rows x 256,000) bitwise equal card/CPU",
          flush=True)


def sampler_cost(engine, logits):
    """The engine's draw at (B, V): device ms of one call (the sum of its
    kernels' times, profiler), its kernels, and the wall ms a call over
    10 back-to-back calls, which the host's enqueue of those kernels
    sets (a GPU-side sleep cannot hold them all: the launch queue
    fills)."""
    from torch.profiler import ProfilerActivity, profile

    B = logits.shape[0]
    rid = torch.arange(100, 100 + B, device="cuda")
    pos = torch.full((B,), 133, device="cuda")

    def draw():
        return engine._sample(logits, rid, pos)

    for _ in range(3):
        draw()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        draw()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 10 * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        draw()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    n = sum(e.count for e in kernels)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return dict(device_ms=busy, launches=n, wall_ms=wall_ms)


def _binned(x, bins):
    return torch.zeros(FREQ_BINS, dtype=torch.float64,
                       device=x.device).scatter_add_(0, bins, x.double())


def sample_frequencies(key, logits_row):
    """Token frequencies of FREQ_KEYS draws at one position against
    p = softmax(logits / t), as the total variation over FREQ_BINS bins
    of equal mass under p (tokens sorted by p, cut at every 1/FREQ_BINS
    of cumulative mass), so that no bin can hide the sampler's errors.

    Returns the reading, the expected reading of a right sampler from
    the draws' noise alone, and three controls at the same bins (exact,
    without noise): a greedy sampler, a uniform one and one that
    ignores the temperature; and the mass of the 31 likeliest tokens.
    The draw is in the logits' dtype; with bf16 logits the uniforms
    have 7 random bits (as in JAX), which biases Gumbel-max, so the
    gate reads the fp32 draw."""
    V = logits_row.shape[-1]
    keys = rnd.fold_in(rnd.fold_in(key, torch.arange(FREQ_KEYS,
                                                     device="cuda")), 160)
    counts = torch.zeros(V, dtype=torch.int64, device="cuda")
    t = torch.tensor(SAMPLE_T, dtype=logits_row.dtype, device="cuda")
    scaled = logits_row / t
    for i in range(0, FREQ_KEYS, FREQ_ROWS):
        draws = rnd.categorical(keys[i:i + FREQ_ROWS],
                                scaled.expand(FREQ_ROWS, V))
        counts += torch.bincount(draws, minlength=V)
    p = torch.softmax(scaled.double(), dim=-1)
    order = torch.argsort(p, descending=True)
    before = torch.cumsum(p[order], 0) - p[order]
    bins = torch.empty_like(order)
    bins[order] = (before * FREQ_BINS).floor().long().clamp(max=FREQ_BINS - 1)
    pb = _binned(p, bins)

    def tv_of(fb):
        return 0.5 * (fb - pb).abs().sum().item()

    noise = 0.5 * torch.sqrt(2 * pb * (1 - pb) / (torch.pi * FREQ_KEYS))
    return dict(
        tv=tv_of(_binned(counts, bins) / FREQ_KEYS),
        noise_tv=noise.sum().item(),
        max_bin_mass=pb.max().item(),
        greedy_tv=1 - pb[bins[int(torch.argmax(p))]].item(),
        uniform_tv=tv_of(_binned(torch.ones(V, device="cuda"), bins) / V),
        untempered_tv=tv_of(_binned(torch.softmax(logits_row.double(), -1),
                                 bins)),
        top31_mass=p[order[:31]].sum().item())


def serve_sample(params):
    """Full-width gemma-7b serves stream (a) at temperature 0.8: the
    sampler's bits against the CPU and JAX's constants, the stream
    through the paged kernel twice (same tokens), beside greedy on the
    same stream, token frequencies at one position against softmax, and
    the sampler's cost at B 8 x V 256,000."""
    phase(f"serve-sample: gemma-7b full width, 28 layers, bf16, offline, "
          f"temperature {SAMPLE_T}")
    check_sampler_bits()
    cfg = get_config("gemma-7b")
    base = dict(max_batch=8, max_len=max(PROMPT_LENS) + NEW_TOKENS,
                page_size=16, prefill_chunk=8)

    def workload():
        reqs = synthetic_requests(cfg, n=8, tokens=NEW_TOKENS,
                                  prompt_len=max(PROMPT_LENS), seed=0,
                                  prompt_lens=PROMPT_LENS)
        for i, r in enumerate(reqs):
            r.id = 100 + i  # the keys depend on the id: pin it
        return reqs

    engines = {t: Engine(cfg, params, ServeConfig(temperature=t, seed=0,
                                                  **base), device="cuda")
               for t in (0.0, SAMPLE_T)}
    for engine in engines.values():  # warm-up
        run_offline(engine, synthetic_requests(cfg, n=2, tokens=2,
                                               prompt_len=8, seed=1))
    reports = {}
    for t in (0.0, SAMPLE_T):
        pa.reset_launches()
        reports[t] = run_offline(engines[t], workload())
        launches = pa.paged_attention_cuda.launches
        steps = len(reports[t].steps)
        print(f"  temperature {t}: {reports[t].format()}; {steps} chunk "
              f"steps, paged_attention launches {launches}", flush=True)
        if launches < cfg.n_layers * steps or steps == 0:
            raise AssertionError(
                f"paged_attention ran {launches} times in {steps} chunk "
                f"steps at temperature {t}")
    got = tokens_of(reports[SAMPLE_T])
    if len(got) != 8 or any(len(x) != NEW_TOKENS for x in got) or \
            any(not 0 <= tok < cfg.vocab for x in got for tok in x):
        raise AssertionError("sampled stream: wrong counts or ids")
    again = tokens_of(run_offline(engines[SAMPLE_T], workload()))
    if again != got:
        raise AssertionError("a second sampled run of the stream differs")
    if got == tokens_of(reports[0.0]):
        raise AssertionError("temperature 0.8 drew the greedy tokens")
    print(f"  second sampled run: same tokens; differs from greedy in "
          f"{sum(a != b for x, y in zip(got, tokens_of(reports[0.0])) for a, b in zip(x, y))}"
          f" of {8 * NEW_TOKENS} tokens", flush=True)

    # logits of one chunk step at full width (B 8 rows, bf16)
    B, C = 8, base["prefill_chunk"]
    cache = lm.init_paged_cache(cfg, 16, 16, device="cuda")
    pt = torch.full((B, 2), -1, dtype=torch.int32, device="cuda")
    pt[:, 0] = torch.arange(B, dtype=torch.int32)
    with torch.inference_mode():
        logits, _ = lm.decode_chunk(
            params, cfg, torch.randint(0, cfg.vocab, (B, C), device="cuda",
                                       generator=torch.Generator("cuda")
                                       .manual_seed(0)),
            cache, pt, torch.zeros(B, dtype=torch.int32, device="cuda"),
            torch.full((B,), C, dtype=torch.int32, device="cuda"))
        key = engines[SAMPLE_T]._key
        freq = sample_frequencies(key, logits[0].float())
        freq["bf16_tv"] = sample_frequencies(key, logits[0])["tv"]
        cost = sampler_cost(engines[SAMPLE_T], logits)
    controls = {k: freq[k] for k in ("greedy_tv", "uniform_tv",
                                     "untempered_tv")}
    print(f"  frequencies of {FREQ_KEYS} keys at one position, over "
          f"{FREQ_BINS} bins of equal softmax mass (largest bin "
          f"{freq['max_bin_mass']:.4f}; top 31 tokens hold "
          f"{freq['top31_mass']:.4f}): total variation {freq['tv']:.5f} "
          f"from fp32 logits (bound {FREQ_TV}; {freq['noise_tv']:.5f} "
          f"expected from the draws' noise); controls: greedy "
          f"{controls['greedy_tv']:.4f}, uniform {controls['uniform_tv']:.4f},"
          f" temperature ignored {controls['untempered_tv']:.4f}; "
          f"{freq['bf16_tv']:.5f} from the bf16 logits the engine draws "
          f"from (recorded)", flush=True)
    if not freq["tv"] < FREQ_TV:
        raise AssertionError(f"sampled frequencies off softmax: {freq}")
    if not min(controls.values()) > FREQ_TV:
        raise AssertionError(f"the frequency gate cannot tell a wrong "
                             f"sampler at this position: {freq}")
    step_ms = 1e3 * reports[SAMPLE_T].elapsed_s / len(reports[SAMPLE_T].steps)
    print(f"  sampler at B {B} x V {cfg.vocab}: {cost['device_ms']:.4f} ms "
          f"of device time and {cost['launches']} kernels a call, "
          f"{cost['wall_ms']:.3f} ms wall a call back to back; a sampled "
          f"chunk step {step_ms:.1f} ms", flush=True)
    s = {str(t): reports[t].summary() for t in reports}
    s["sampler"] = cost
    s["frequencies"] = freq
    print(f"  serve-sample summary {json.dumps(s)}", flush=True)
    del engines, cache, logits
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# Phase 5b: checkpoints and resume at full width (1-layer cut: the
# phase's checkpoint I/O is the script's largest, and the depth is the
# lever that keeps the whole run inside its time limit).
# --------------------------------------------------------------------------- #
RESUME_LAYERS, RESUME_STEPS, RESUME_EVERY = 1, 6, 3


def state_parts(tr):
    leaves = ckpt._flatten_with_names(tr.checkpoint_tree())[1]
    return [p for leaf in leaves
            for p in (leaf.parts if isinstance(leaf, Stacked) else [leaf])]


def equal_to_checkpoint(path, tr):
    """Every array of the checkpoint at ``path`` against the trainer's
    live state, bitwise, one array at a time; returns the bytes read."""
    names, leaves = ckpt._flatten_with_names(tr.checkpoint_tree())
    with open(os.path.join(path, "manifest.json")) as f:
        if json.load(f)["names"] != names:
            raise AssertionError(f"{path}: names differ from the state")
    nbytes = 0
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, leaf in enumerate(leaves):
            a = torch.from_numpy(data[f"a{i}"])
            nbytes += a.numel() * a.element_size()
            parts = leaf.parts if isinstance(leaf, Stacked) else [leaf]
            for b, part in enumerate(parts):
                want = a[b] if isinstance(leaf, Stacked) else a
                if not torch.equal(part.detach().cpu(), want):
                    raise AssertionError(f"{path}: {names[i]} differs")
    return nbytes


def resume_pipeline(cfg, cache_dir, start):
    src = SyntheticShardSource(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                               n_batches=RESUME_STEPS, shard_size=2, seed=0)
    return Pipeline(src, cache_dir=cache_dir, prefetch_depth=2,
                    start_batch=start)


def train_resume():
    """Run A: 6 steps with async checkpoints at 3 and 6, fed by the
    streaming pipeline through the double buffer. Run B: a fresh trainer
    resumed from step_3 takes steps 4-6 from the pipeline at batch 3.
    B's losses and final state must equal A's bitwise, both async
    checkpoints and a sync save of A's state must read back equal to it,
    and the flash kernels must carry the resumed steps."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    free = shutil.disk_usage(root).free
    n_layers = RESUME_LAYERS
    phase(f"train-resume: gemma-7b full width, {n_layers} layers, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {RESUME_STEPS} steps, async "
          f"checkpoints every {RESUME_EVERY}, resume from step "
          f"{RESUME_EVERY}, streaming pipeline + double buffer")
    print(f"  {root}: {free / 1e9:.1f} GB free", flush=True)
    cfg = dataclasses.replace(get_config("gemma-7b"), n_layers=n_layers)
    cache_dir = os.path.join(root, "data_cache")
    run_dir = os.path.join(root, "run_a")
    try:
        def trainer(every):
            return Trainer(cfg, TrainerConfig(
                total_steps=RESUME_STEPS, log_every=1,
                checkpoint_every=every, checkpoint_dir=run_dir,
                async_checkpoint=True, double_buffer=True), device="cuda")

        fa.flash_attention_fwd_cuda.launches = 0
        fa.flash_attention_bwd_cuda.launches = 0
        tr_a = trainer(RESUME_EVERY)
        n_params = sum(p.numel() for p in tree_leaves(tr_a.state["params"]))
        with resume_pipeline(cfg, cache_dir, 0) as pipe:
            hist_a = tr_a.fit(pipe, hooks=tr_a.default_hooks()
                              + [SyncEveryStep()])
        torch.cuda.synchronize()
        launches_a = (fa.flash_attention_fwd_cuda.launches,
                      fa.flash_attention_bwd_cuda.launches)
        for h in tr_a._hooks:  # free the snapshot buffers
            if getattr(h, "checkpointer", None) is not None:
                h.checkpointer.release()
        torch.cuda.empty_cache()
        saved = sorted(d for d in os.listdir(run_dir)
                       if not d.startswith("."))
        if saved != ["step_3", "step_6"]:
            raise AssertionError(f"run A saved {saved}")
        t0 = time.perf_counter()
        nbytes = equal_to_checkpoint(os.path.join(run_dir, "step_6"), tr_a)
        check_s = time.perf_counter() - t0
        print(f"  run A: {n_params / 1e9:.3f} B params, checkpoints of "
              f"{nbytes / 1e9:.2f} GB; losses {[r['loss'] for r in hist_a]};"
              f" async step_6 reads back bitwise equal to the state "
              f"({nbytes / 1e9 / check_s:.2f} GB/s read and compared)",
              flush=True)

        # the sync twin of step_6, with step_6 removed: two on disk
        shutil.rmtree(os.path.join(run_dir, "step_6"))
        sync_path = os.path.join(root, "sync_6")
        t0 = time.perf_counter()
        ckpt.save_checkpoint(sync_path, tr_a.checkpoint_tree(),
                             step=RESUME_STEPS)
        sync_ms = (time.perf_counter() - t0) * 1e3
        equal_to_checkpoint(sync_path, tr_a)
        async_ms = [r["ckpt_block_ms"] for r in hist_a
                    if r["ckpt_block_ms"] > 0]
        print(f"  ckpt_block_ms: async {[round(x, 3) for x in async_ms]} "
              f"(steps {RESUME_EVERY}, {RESUME_STEPS}), sync "
              f"{sync_ms:.1f} ({nbytes / 1e6 / sync_ms:.2f} GB/s written); "
              f"the sync save reads back equal to the state", flush=True)

        tr_b = trainer(0)
        t0 = time.perf_counter()
        start = tr_b.resume(os.path.join(run_dir, f"step_{RESUME_EVERY}"))
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        fa.flash_attention_fwd_cuda.launches = 0
        fa.flash_attention_bwd_cuda.launches = 0
        with resume_pipeline(cfg, cache_dir, start) as pipe:
            hist_b = tr_b.fit(pipe, hooks=tr_b.default_hooks()
                              + [SyncEveryStep()])
        torch.cuda.synchronize()
        launches_b = (fa.flash_attention_fwd_cuda.launches,
                      fa.flash_attention_bwd_cuda.launches)
        losses_a = [r["loss"] for r in hist_a[start:]]
        losses_b = [r["loss"] for r in hist_b]
        print(f"  run B: resumed at step {start} ({nbytes / 1e9 / read_s:.2f}"
              f" GB/s read); steps {[r['step'] for r in hist_b]}, losses "
              f"{losses_b} (run A: {losses_a})", flush=True)
        if [r["step"] for r in hist_b] != list(range(start + 1,
                                                     RESUME_STEPS + 1)):
            raise AssertionError("run B did not take steps 4-6")
        if losses_b != losses_a:
            raise AssertionError("resumed losses differ from run A's")
        for a, b in zip(state_parts(tr_a), state_parts(tr_b)):
            if not torch.equal(a, b):
                raise AssertionError("run B's final state differs from A's")
        equal_to_checkpoint(sync_path, tr_b)
        L = cfg.n_layers
        want_b = (2 * L * (RESUME_STEPS - start), L * (RESUME_STEPS - start))
        print(f"  final params and moments bitwise equal A's (and step_6 "
              f"read back); flash launches A {launches_a}, B {launches_b} "
              f"(expected {want_b} for B)", flush=True)
        if launches_b != want_b or launches_a != (2 * L * RESUME_STEPS,
                                                  L * RESUME_STEPS):
            raise AssertionError(f"flash launches {launches_a}, "
                                 f"{launches_b}")
        waits = [round(r["data_wait_ms"], 3) for r in hist_a + hist_b]
        steps_ms = [round(r["step_ms"], 1) for r in hist_a + hist_b]
        summary = dict(n_layers=n_layers, n_params=n_params,
                       ckpt_bytes=nbytes, async_block_ms=async_ms,
                       sync_block_ms=sync_ms,
                       write_gb_s=nbytes / 1e6 / sync_ms,
                       read_gb_s=nbytes / 1e9 / read_s,
                       data_wait_ms=waits, step_ms=steps_ms,
                       losses=[r["loss"] for r in hist_a])
        print(f"  train-resume summary {json.dumps(summary)}", flush=True)
        del tr_a, tr_b
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches_b


# --------------------------------------------------------------------------- #
# The dense variants and MoE models (attention-only stacks): kernels at their
# shapes, reduced card vs CPU, full-width serving and training.
# --------------------------------------------------------------------------- #
ARCHS = ("yi-9b", "qwen1.5-32b", "command-r-35b", "mixtral-8x7b",
         "grok-1-314b")
FLASH_ARCHS = ("yi-9b", "grok-1-314b")  # 32/4 and 48/8 heads of 128
# Full-width training depths (fp32 masters, Adam, bf16 compute, remat):
# ~18 B a parameter of state with fp32 moments, ~12 B with grok's bf16
# ones; grok keeps 4 of its 8 experts (one full layer needs ~78 GB).
TRAIN_ARCH_LAYERS = {"yi-9b": 8, "qwen1.5-32b": 2, "command-r-35b": 1,
                     "mixtral-8x7b": 2, "grok-1-314b": 1}
GROK_TRAIN_EXPERTS = 4
# Room left beside a served model's bf16 weights: the pool, the chunk
# step's activations and logits, the allocator's slack.
SERVE_HEADROOM = 6 << 30


def gqa_sdpa_inputs(case, window=None):
    """``sdpa_inputs`` with K/V expanded to the query heads beforehand
    (the library call then does no GQA)."""
    qs, ks, vs, mask = sdpa_inputs(case, window)
    g = qs.shape[1] // ks.shape[1]
    return (qs, ks.repeat_interleave(g, dim=1).contiguous(),
            vs.repeat_interleave(g, dim=1).contiguous(), mask)


def check_paged_archs():
    """The paged kernel at each new arch's serving shape (B 8, C 8, page
    16, ragged rows, its heads of 128, bf16 q): yi 32/4 (G 8), command-r
    64/8 (G 8), mixtral 32/8 (G 4) and grok 48/8 (G 6) from bf16 pools,
    qwen 40/40 from its int8 pool; each held against the plain version,
    rerun bitwise, then timed beside its bound and SDPA. Returns one
    record an arch."""
    phase("kernels: paged_attention at the new archs' shapes (heads of "
          "128; G 8, 8, 4, 6 bf16; qwen 40/40 int8) vs plain PyTorch")
    main = dict(B=8, C=8, page=16, npg=10, lens=[160, 5, 37, 128, 64, 99,
                                                 16, 0],
                nvs=[1, 5, 8, 1, 8, 3, 1, 1])
    recs = {}
    for j, arch in enumerate(ARCHS):
        cfg = get_config(arch)
        H, K, D, kind = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                         cfg.kv_cache_dtype)
        shape = dict(main, H=H, K=K, D=D)
        if kind == "int8":
            case = quant_case(200 + j, "int8", torch.bfloat16, **shape)
        else:
            case = paged_case(200 + j, dtype=torch.bfloat16, **shape)
        tol = TOL[torch.bfloat16]
        err = hold_paged(case, None, f"{arch} {H}/{K} {kind}", tol)
        nbytes, flops = work(case, None)
        b_ms, by = bound(flops, nbytes, torch.bfloat16)
        qs, ks, vs, mask = gqa_sdpa_inputs(case)
        rec = dict(
            name=f"paged_attention{'_int8' if kind == 'int8' else ''}_{arch}",
            route="cuda",
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:186",
            max_abs_err=err,
            ms=time_ms(lambda: pa.paged_attention_cuda(**case)),
            plain_ms=time_ms(lambda: pa.paged_attention_torch(**case)),
            bound_ms=b_ms, bound_by=by,
            library_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask)))
        print(f"  {arch:14s} {H}/{K} (G {H // K}) D{D} {kind} pool: "
              f"max|kernel-plain| {err:.3e} (tol {tol:g}), rerun bitwise "
              f"equal; kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f}"
              f" ms, sdpa {rec['library_ms']:.4f} ms (K/V gathered"
              f"{', dequantized' if kind == 'int8' else ''} and expanded to "
              f"{H} heads beforehand), kernel/sdpa "
              f"{rec['ms'] / rec['library_ms']:.3f}, bound {b_ms:.4f} ms "
              f"({by}: {nbytes} B, {flops} flop)", flush=True)
        recs[arch] = rec
        del case, qs, ks, vs, mask
    torch.cuda.empty_cache()
    return recs


def check_flash_archs():
    """The flash forward and backward at S 2048, causal, bf16 with yi's
    32/4 and grok's 48/8 heads of 128, at B 4 and at the batch each
    microbatch of its train step has (4 // microbatches: grok's 1): held
    against the plain version, the backward rerun bitwise, then timed
    beside the bounds and SDPA. Returns {arch: (forward record, backward
    record)} at the train step's shape; the other shapes are printed."""
    phase("kernels: flash_attention forward and backward at S 2048, D 128, "
          "32/4 and 48/8 heads, the train step's batch and B 4, vs plain "
          "PyTorch")
    S, D, dtype = TRAIN_SEQ, 128, torch.bfloat16
    tol = TOL[dtype]
    recs = {}
    for i, arch in enumerate(FLASH_ARCHS):
        cfg = train_arch_config(arch)
        H, K = cfg.n_heads, cfg.n_kv_heads
        path_b = TRAIN_BATCH // cfg.microbatches
        for B in sorted({TRAIN_BATCH, path_b}):
            recs_b = check_flash_case(300 + i, arch, B, S, H, K, D, dtype,
                                      tol, f"_{arch}" if B == path_b
                                      else f"_{arch}_B{B}")
            if B == path_b:
                recs[arch] = recs_b
    return recs


def hold_flash_case(seed, arch, B, S, H, K, D, dtype, tol, *, Sk=None,
                    causal=True):
    """The flash forward and backward at one shape against the plain
    version within ``tol``, the backward rerun bitwise; prints the
    errors. Returns (q, k, v, do, {"out", "dq", "dk", "dv": max
    |kernel - plain|})."""
    Sk = Sk or S
    kw = dict(causal=causal)
    q, k, v, do = flash_inputs(seed, B, S, Sk, H, K, D, dtype)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    want = fa.flash_attention_torch(qp, kp, vp, **kw)
    want.backward(do)
    errs = {}
    for label, got, ref in (("out", out, want), ("dq", dq, qp.grad),
                            ("dk", dk, kp.grad), ("dv", dv, vp.grad)):
        g, w = got.float(), ref.float()
        errs[label] = (g - w).abs().max().item()
        if not (torch.isfinite(g).all()
                and torch.allclose(g, w, rtol=tol, atol=tol)):
            raise AssertionError(
                f"flash_attention {arch} B{B} {H}/{K} {label}: kernel != "
                f"plain, max |diff| {errs[label]} > {tol}")
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    if not all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))):
        raise AssertionError(f"flash_attention {arch} B{B}: a rerun of the "
                             f"backward differs")
    shape = f"S{S}" if S == Sk else f"Sq{S} Sk{Sk}"
    print(f"  {arch} B{B} {shape} {H}/{K} (G {H // K}) D{D} "
          f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} "
          f"{'causal' if causal else 'non-causal'}: "
          f"max|kernel-plain| " + ", ".join(
              f"{n} {e:.2e}" for n, e in errs.items()) +
          f" (tol {tol:g}), backward rerun bitwise equal", flush=True)
    del again, want, out, lse, dq, dk, dv, qp, kp, vp
    torch.cuda.empty_cache()
    return q, k, v, do, errs


def check_flash_case(seed, arch, B, S, H, K, D, dtype, tol, suffix, *,
                     Sk=None, causal=True):
    """One shape of ``check_flash_archs`` (or of whisper's: ``Sk`` keys,
    default S, and ``causal``): held (:func:`hold_flash_case`), then
    timed; its (forward, backward) records."""
    q, k, v, do, errs = hold_flash_case(seed, arch, B, S, H, K, D, dtype,
                                        tol, Sk=Sk, causal=causal)
    recs = tuple(flash_records(
        q, k, v, do, suffix,
        (errs["out"], max(errs["dq"], errs["dk"], errs["dv"])),
        causal=causal))
    del q, k, v, do
    torch.cuda.empty_cache()
    return recs


def reduced_archs_vs_cpu():
    """Each new arch reduced, in fp32 (qwen from its int8 pool), bridged
    from the same numpy weights on both devices: the card's paged engine
    (the paged kernel) gives the CPU's (plain path) greedy tokens."""
    phase("check: reduced yi-9b, qwen1.5-32b (int8 pool), command-r-35b, "
          "mixtral-8x7b, grok-1-314b, card vs CPU plain path, fp32")
    scfg = ServeConfig(max_batch=3, max_len=40, page_size=4, prefill_chunk=8)
    for i, arch in enumerate(ARCHS):
        base = get_config(arch).reduced()
        kv = base.kv_cache_dtype if base.kv_cache_dtype == "int8" else \
            "float32"
        cfg = dataclasses.replace(base, dtype="float32", kv_cache_dtype=kv)
        tree = lm.perturb_norms(reference_layout(
            lm.init_lm(cfg, 40 + i, device="cpu"), cfg), 40 + i)
        toks = {}
        pa.reset_launches()
        for dev in ("cpu", "cuda"):
            params = lm.params_from_numpy(tree, cfg, device=dev)
            reqs = synthetic_requests(cfg, n=5, tokens=6, prompt_len=24,
                                      seed=7, prompt_lens=(3, 17, 24, 5, 11))
            toks[dev] = tokens_of(run_offline(
                Engine(cfg, params, scfg, device=dev), reqs))
        launches = pa.paged_attention_cuda.launches_by_kind[kv]
        if toks["cpu"] != toks["cuda"]:
            raise AssertionError(f"reduced {arch}: greedy tokens differ card "
                                 f"vs CPU")
        if launches == 0 or launches != pa.paged_attention_cuda.launches:
            raise AssertionError(f"reduced {arch}: paged kernel launches "
                                 f"{pa.paged_attention_cuda.launches_by_kind}")
        print(f"  {arch}: greedy tokens identical card vs CPU (5 ragged "
              f"requests, {kv} pool, {launches} paged kernel launches)",
              flush=True)


def layer_bytes(cfg):
    """(bf16 bytes of one layer, of the embedding and head) of ``cfg``,
    from the reference's parameter count."""
    one = dataclasses.replace(cfg, n_layers=1).param_count()
    fixed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return 2 * (one - fixed), 2 * fixed


def serve_depth(cfg, free):
    """The deepest cut of ``cfg`` whose bf16 weights fit in ``free``
    bytes beside ``SERVE_HEADROOM`` and ``init_lm``'s largest fp32
    temporary (the embedding, or one MoE layer's ``wu``)."""
    per_layer, fixed = layer_bytes(cfg)
    temp = 4 * max(cfg.vocab * cfg.d_model, (cfg.moe.n_experts if cfg.moe
                                              else 1) * cfg.d_model * cfg.d_ff)
    room = free - SERVE_HEADROOM - temp - fixed
    return max(1, min(cfg.n_layers, int(room // per_layer)))


def serve_arch(arch):
    """Full-width ``arch`` at the deepest cut one card holds serves
    stream (a) greedy from its config's pool; returns the paged
    launches."""
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=serve_depth(full, free))
    n = cfg.param_count()
    cut = ("all layers" if cfg.n_layers == full.n_layers else
           f"cut to {cfg.n_layers} of {full.n_layers} layers by memory")
    phase(f"serve: {arch} full width, {cfg.n_layers} layers ({cut}), bf16 "
          f"weights, {cfg.kv_cache_dtype} pool, offline")
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  {n / 1e9:.2f} B params ({2 * n / 1e9:.1f} GB bf16; "
          f"{free / 2**30:.1f} GiB free before), d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}"
          + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}"
             if cfg.moe else "")
          + f"; init in {time.perf_counter() - t0:.1f} s", flush=True)
    launches = serve_stream(cfg, params, trace="chunk", arch=arch, n_params=n)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_archs():
    """The reduced archs card vs CPU, then each arch at full width in
    turn, the card freed between them. Returns {arch: paged launches}."""
    t0 = time.perf_counter()
    reduced_archs_vs_cpu()
    launches = {arch: serve_arch(arch) for arch in ARCHS}
    print(f"  serve-archs wall {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def train_arch_config(arch):
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=TRAIN_ARCH_LAYERS[arch])
    if arch == "grok-1-314b":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=GROK_TRAIN_EXPERTS))
    return cfg


def train_arch(arch):
    """Full-width ``arch`` cut to ``TRAIN_ARCH_LAYERS`` (grok also to 4
    experts) takes 4 steps of batch 4 x 2048 through ``Trainer.fit``;
    the flash counters must show forward twice and backward once per
    layer per step (per microbatch), and a second run from the same seed
    must repeat the losses bitwise. Returns the flash launches."""
    cfg = train_arch_config(arch)
    full = get_config(arch)
    cuts = [f"{cfg.n_layers} of {full.n_layers} layers"]
    if cfg.moe and cfg.moe.n_experts != full.moe.n_experts:
        cuts.append(f"{cfg.moe.n_experts} of {full.moe.n_experts} experts")
    phase(f"train: {arch} full width, {' and '.join(cuts)} (memory), batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {cfg.microbatches} microbatch(es), "
          f"fp32 masters, {cfg.grad_dtype} gradients, {cfg.moment_dtype} "
          f"moments, bf16 compute, remat")
    if not cfg.remat:
        raise AssertionError("the full config trains with remat")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd_cuda.launches = 0
    fa.flash_attention_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    tr, hist = run_trainer(cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fa.flash_attention_fwd_cuda.launches,
                fa.flash_attention_bwd_cuda.launches)
    n_params = sum(p.numel() for p in tree_leaves(tr.state["params"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in hist]
    nlls = [r["nll"] for r in hist]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    M = cfg.microbatches
    want = (2 * cfg.n_layers * M * TRAIN_STEPS, cfg.n_layers * M * TRAIN_STEPS)
    step_ms = float(np.median([r["step_ms"] for r in hist[1:]]))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    aux = [a - b for a, b in zip(losses, nlls)] if cfg.uses_moe else None
    print(f"  {n_params / 1e9:.3f} B params; {TRAIN_STEPS} steps in "
          f"{wall:.1f} s; losses {losses}"
          + (f"; aux term (loss - nll = {cfg.moe.aux_loss_weight} x aux) "
             f"{aux}" if aux else "")
          + f"; step {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}: "
          f"{[round(r['step_ms'], 1) for r in hist]}), {tok_s:.0f} "
          f"tokens/s; peak memory {peak:.2f} GiB; flash launches forward "
          f"{launches[0]}, backward {launches[1]} (expected {want[0]}, "
          f"{want[1]})", flush=True)
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{arch}: non-finite or missing losses {hist}")
    if launches != want:
        raise AssertionError(f"{arch}: flash launches {launches} != {want}")
    tr, again = run_trainer(cfg, 2)
    again = [r["loss"] for r in again]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  second run, 2 steps: losses {again}", flush=True)
    if again != losses[:2]:
        raise AssertionError(f"{arch}: a second run's losses differ: "
                             f"{again} vs {losses[:2]}")
    print("  bitwise equal to the first run's", flush=True)
    summary = dict(arch=arch, n_layers=cfg.n_layers,
                   n_experts=cfg.moe.n_experts if cfg.moe else None,
                   n_params=n_params, step_ms=step_ms, tokens_per_s=tok_s,
                   peak_mem_gib=peak, losses=losses, aux_term=aux,
                   flash_launches=launches, wall_s=wall)
    print(f"  train summary {json.dumps(summary)}", flush=True)
    return launches


def train_archs():
    t0 = time.perf_counter()
    launches = {arch: train_arch(arch) for arch in ARCHS}
    print(f"  train-archs wall {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# What one parameter of the jamba train cut holds on the card: an fp32
# master, a bf16 compute copy, a bf16 gradient sum and two bf16 moments.
JAMBA_STATE_BYTES = 12
# Room for the activations of one remat'ed layer at 1 x 2048 and the
# allocator's slack.
JAMBA_ACT_BYTES = 4 << 30


def jamba_train_config(free):
    """The train cut of jamba-1.5-large at every published width:
    ``jamba_cut()``'s three layers with 4 of 16 experts when the reckoned
    peak fits in ``free`` bytes; else without its attention + dense layer;
    else that with 2 experts. The peak is the backward's: 12 B a parameter
    plus ``JAMBA_ACT_BYTES`` (Adam's, after it, holds 10 B a parameter and
    the temporaries of one ``optim.adam.SLICE``). Prints the reckoning;
    returns (cfg, what was cut)."""
    base = jamba_cut()
    pat = base.block_pattern
    two = dataclasses.replace(base, n_layers=2, block_pattern=pat[:2])

    def experts(cfg, E):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=E))

    for cut, cfg in (("3 layers, 4 of 16 experts", experts(base, 4)),
                     ("2 layers (attention + dense dropped), 4 of 16 "
                      "experts", experts(two, 4)),
                     ("2 layers (attention + dense dropped), 2 of 16 "
                      "experts", experts(two, 2))):
        n = cfg.param_count()
        peak = JAMBA_STATE_BYTES * n + JAMBA_ACT_BYTES
        fits = peak <= free
        print(f"  reckoning {cut}: {n / 1e9:.3f} B params x "
              f"{JAMBA_STATE_BYTES} B = {JAMBA_STATE_BYTES * n / 2**30:.1f} "
              f"GiB of state; peak ~{peak / 2**30:.1f} GiB against "
              f"{free / 2**30:.1f} GiB free: {'fits' if fits else 'no'}",
              flush=True)
        if fits:
            return cfg, cut
    raise AssertionError("no jamba train cut fits on this card")


def train_jamba():
    """Full-width jamba-1.5-large cut by ``jamba_train_config`` takes 4
    steps of batch 8 x 2048 (its 8 microbatches of 1 x 2048, bf16
    gradient sums and moments, fp32 masters, remat) through
    ``Trainer.fit``. The counters, zeroed just before, must show per step
    and Mamba layer mamba_scan forward 2 x 8 (with the remat recompute)
    and backward 8, per attention layer flash forward 2 x 8 and backward
    8; a second run from the same seed must repeat the losses bitwise.
    Returns the launches (mamba forward, mamba backward, flash forward,
    flash backward)."""
    gc.collect()
    torch.cuda.empty_cache()
    phase("train: jamba-1.5-large full width, reckoning the cut")
    free = torch.cuda.mem_get_info()[0]
    cfg, cut = jamba_train_config(free)
    M = cfg.microbatches
    phase(f"train: jamba-1.5-large full width, {cut} (memory), batch "
          f"{TRAIN_BATCH_JAMBA} x {TRAIN_SEQ}, {M} microbatches, fp32 "
          f"masters, {cfg.grad_dtype} gradients, {cfg.moment_dtype} moments, "
          f"bf16 compute, remat")
    if not cfg.remat or TRAIN_BATCH_JAMBA // M != 1:
        raise AssertionError("the full config trains with remat, one row a "
                             "microbatch")
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    fa.flash_attention_fwd_cuda.launches = 0
    fa.flash_attention_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    tr, hist = run_trainer(cfg, TRAIN_STEPS, batch=TRAIN_BATCH_JAMBA)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (mk.mamba_scan_cuda.launches, mk.mamba_scan_bwd_cuda.launches,
                fa.flash_attention_fwd_cuda.launches,
                fa.flash_attention_bwd_cuda.launches)
    n_params = sum(p.numel() for p in tree_leaves(tr.state["params"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in hist]
    nlls = [r["nll"] for r in hist]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    n_mamba = sum(s.mixer == "mamba" for s in cfg.block_pattern)
    n_attn = cfg.n_layers - n_mamba
    per_step = (2 * n_mamba * M, n_mamba * M, 2 * n_attn * M, n_attn * M)
    want = tuple(TRAIN_STEPS * n for n in per_step)
    step_ms = float(np.median([r["step_ms"] for r in hist[1:]]))
    tok_s = TRAIN_BATCH_JAMBA * TRAIN_SEQ / (step_ms / 1e3)
    aux = [a - b for a, b in zip(losses, nlls)]
    print(f"  {n_params / 1e9:.3f} B params; {TRAIN_STEPS} steps in "
          f"{wall:.1f} s; losses {losses}; aux term (loss - nll = "
          f"{cfg.moe.aux_loss_weight} x aux) {aux}; step {step_ms:.1f} ms "
          f"(median of steps 2-{TRAIN_STEPS}: "
          f"{[round(r['step_ms'], 1) for r in hist]}), {tok_s:.0f} tokens/s; "
          f"peak memory {peak:.2f} GiB; launches mamba_scan forward "
          f"{launches[0]}, backward {launches[1]}, flash forward "
          f"{launches[2]}, backward {launches[3]} (expected {want}: per step "
          f"{per_step})", flush=True)
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"jamba: non-finite or missing losses {hist}")
    if launches != want:
        raise AssertionError(f"jamba: launches {launches} != {want}")
    tr, again = run_trainer(cfg, 2, batch=TRAIN_BATCH_JAMBA)
    again = [r["loss"] for r in again]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  second run, 2 steps: losses {again}", flush=True)
    if again != losses[:2]:
        raise AssertionError(f"jamba: a second run's losses differ: {again} "
                             f"vs {losses[:2]}")
    print("  bitwise equal to the first run's", flush=True)
    summary = dict(arch=JAMBA, cut=cut, n_layers=cfg.n_layers,
                   n_experts=cfg.moe.n_experts, n_params=n_params,
                   step_ms=step_ms, tokens_per_s=tok_s, peak_mem_gib=peak,
                   losses=losses, aux_term=aux, launches=launches,
                   wall_s=wall)
    print(f"  train summary {json.dumps(summary)}", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# whisper-medium (encoder-decoder): the flash kernels at its encoder, cross
# and decoder shapes and the paged kernel at D 64, G 1; reduced card vs CPU;
# every published width and depth serving both streams, then training.
# --------------------------------------------------------------------------- #
WHISPER = "whisper-medium"
# (record suffix, B, Sq, Sk, causal): the encoder at one admission (the
# serving path encodes each request alone) and at the train batch, the
# cross-attention and the decoder's self-attention at the train batch.
WHISPER_FLASH = (("enc_B1", 1, 1500, 1500, False),
                 ("enc", 8, 1500, 1500, False),
                 ("cross", 8, 448, 1500, False),
                 ("dec", 8, 448, 448, True))
# Whisper's 30 s window (1500 frames) and text context (448 tokens).
WHISPER_BATCH, WHISPER_SEQ = 8, 448


def whisper_shape(suffix):
    """The flash launch-count key (B, Sq, Sk, H, K, D, causal) of a
    ``WHISPER_FLASH`` entry."""
    cfg = get_config(WHISPER)
    _, B, Sq, Sk, causal = next(c for c in WHISPER_FLASH if c[0] == suffix)
    return (B, Sq, Sk, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, causal)


def check_whisper_kernels():
    """The flash forward and backward at whisper's four shapes and the
    paged kernel at its serving chunk (B 8, C 8, page 16, 16/16 heads of
    64, bf16 q; bf16 and int8 pools): each held against its plain
    version, rerun bitwise, then timed beside its bound and SDPA.
    Returns ({suffix: (forward record, backward record)}, {pool kind:
    paged record})."""
    phase("kernels: whisper-medium's shapes (16/16 heads of 64): flash "
          "forward and backward (encoder 1500 x 1500 non-causal at B 1 and "
          "8, cross 448 x 1500, decoder 448 causal) and paged_attention "
          "(G 1, bf16 and int8 pools) vs plain PyTorch")
    cfg = get_config(WHISPER)
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tol = TOL[torch.bfloat16]
    flash = {}
    for i, (suffix, B, Sq, Sk, causal) in enumerate(WHISPER_FLASH):
        flash[suffix] = check_flash_case(
            500 + i, WHISPER, B, Sq, H, K, D, torch.bfloat16, tol,
            f"_whisper_{suffix}", Sk=Sk, causal=causal)
    main = dict(B=8, C=8, H=H, K=K, D=D, page=16, npg=10,
                lens=[160, 5, 37, 128, 64, 99, 16, 0],
                nvs=[1, 5, 8, 1, 8, 3, 1, 1])
    paged = {}
    for j, kind in enumerate(("bfloat16", "int8")):
        if kind == "int8":
            case = quant_case(510 + j, "int8", torch.bfloat16, **main)
        else:
            case = paged_case(510 + j, dtype=torch.bfloat16, **main)
        err = hold_paged(case, None, f"whisper {H}/{K} D{D} {kind}", tol)
        nbytes, flops = work(case, None)
        b_ms, by = bound(flops, nbytes, torch.bfloat16)
        qs, ks, vs, mask = gqa_sdpa_inputs(case)
        rec = dict(
            name=f"paged_attention{'_int8' if kind == 'int8' else ''}"
                 f"_{WHISPER}",
            route="cuda",
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:186",
            max_abs_err=err,
            ms=time_ms(lambda: pa.paged_attention_cuda(**case)),
            plain_ms=time_ms(lambda: pa.paged_attention_torch(**case)),
            bound_ms=b_ms, bound_by=by,
            library_ms=time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask)))
        print(f"  whisper {H}/{K} (G 1) D{D} {kind} pool: max|kernel-plain| "
              f"{err:.3e} (tol {tol:g}), rerun bitwise equal; kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, sdpa "
              f"{rec['library_ms']:.4f} ms (K/V gathered"
              f"{', dequantized' if kind == 'int8' else ''} beforehand), "
              f"kernel/sdpa {rec['ms'] / rec['library_ms']:.3f}, bound "
              f"{b_ms:.4f} ms ({by}: {nbytes} B, {flops} flop)", flush=True)
        paged[kind] = rec
        del case, qs, ks, vs, mask
    torch.cuda.empty_cache()
    return flash, paged


def reduced_whisper_vs_cpu():
    """Reduced whisper-medium (2 encoder layers over 64 frames, 1 decoder
    layer, heads of 64) in fp32 from the same weights on both devices:
    the card's path (flash and paged kernels, cuBLAS) against the CPU's
    plain path. Forward logits to 1e-4 of their largest entry; the loss
    to rtol 1e-4 and every gradient to 1e-3 of (its leaf's largest entry
    + 1e-3);
    the greedy tokens of the paged engine (bf16/fp32 and int8 pools) and
    of the slab engine equal."""
    phase("check: reduced whisper-medium, card vs CPU plain path, fp32")
    cfg = dataclasses.replace(get_config(WHISPER).reduced(), dtype="float32",
                              kv_cache_dtype="float32")
    cpu = encdec.init_encdec(cfg, 2, device="cpu", dtype=torch.float32)
    params = {"cpu": cpu, "cuda": tree_map(lambda t: t.to("cuda"), cpu)}
    g = torch.Generator().manual_seed(2)
    frames = torch.randn((2, cfg.enc_source_len, cfg.d_model), generator=g)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g)
    fa.reset_launches()
    out = {}
    for dev in ("cpu", "cuda"):
        leaves = tree_leaves(params[dev])
        for w in leaves:
            w.requires_grad_(True)
        batch = {"media": frames.to(dev), "tokens": toks.to(dev)}
        logits = encdec.forward(params[dev], cfg, batch["media"],
                                batch["tokens"])
        loss, _ = encdec.loss_fn(params[dev], cfg, batch)
        out[dev] = (logits.detach().cpu(), loss.item(),
                    [x.cpu() for x in torch.autograd.grad(loss, leaves)])
        for w in leaves:
            w.requires_grad_(False)
    launches = (fa.flash_attention_fwd_cuda.launches,
                fa.flash_attention_bwd_cuda.launches)
    want = (2 * (cfg.n_enc_layers + 2 * cfg.n_layers),
            cfg.n_enc_layers + 2 * cfg.n_layers)
    (lc, nc, gc_), (lg, ng, gg) = out["cpu"], out["cuda"]
    rel = ((lc - lg).abs().max() / lc.abs().max()).item()
    # a key bias shifts every logit of a row alike: its gradient is 0 up
    # to rounding on both devices; the 1e-3 beside the largest entry puts
    # a floor of 1e-6 under the 1e-3 tolerance (the CPU tests' atol)
    err = max(((a - b).abs().max() / (a.abs().max() + 1e-3)).item()
              for a, b in zip(gc_, gg))
    print(f"  logits max|card-cpu| {rel:.2e} of the largest (tol 1e-4); loss "
          f"cpu {nc:.6f} card {ng:.6f}; gradients max |card-cpu| / (max|cpu|"
          f" + 1e-3) {err:.2e} over {len(gc_)} leaves (tol 1e-3); flash "
          f"launches forward {launches[0]}, backward {launches[1]} "
          f"(expected {want})", flush=True)
    if rel > 1e-4 or abs(nc - ng) > 1e-4 * abs(nc) or err > 1e-3:
        raise AssertionError(f"reduced whisper differs card vs CPU: logits "
                             f"{rel}, loss {nc} vs {ng}, gradient {err}")
    if launches != want:
        raise AssertionError(f"reduced whisper flash launches {launches} != "
                             f"{want}")
    paged = dict(max_batch=3, max_len=40, page_size=4, prefill_chunk=8)
    toks = {}
    for name, knobs in (("paged", paged),
                        ("paged int8", dict(paged, kv_dtype="int8")),
                        ("slab", dict(max_batch=3, max_len=40,
                                      prefill_len=24, kv_layout="slab"))):
        pa.reset_launches()
        for dev in ("cpu", "cuda"):
            reqs = synthetic_requests(cfg, n=5, tokens=6, prompt_len=24,
                                      seed=7, prompt_lens=(3, 17, 24, 5, 11))
            toks[name, dev] = tokens_of(run_offline(
                Engine(cfg, params[dev], ServeConfig(**knobs), device=dev),
                reqs))
        n = pa.paged_attention_cuda.launches
        if toks[name, "cpu"] != toks[name, "cuda"]:
            raise AssertionError(f"reduced whisper {name}: greedy tokens "
                                 f"differ card vs CPU")
        if (n == 0) == (name != "slab"):
            raise AssertionError(f"reduced whisper {name}: {n} paged "
                                 f"kernel launches")
        print(f"  {name}: greedy tokens identical card vs CPU (5 ragged "
              f"requests, {n} paged kernel launches)", flush=True)
    if toks["slab", "cuda"] != toks["paged", "cuda"]:
        raise AssertionError("reduced whisper: slab and paged tokens differ")
    print("  slab tokens equal the paged engine's", flush=True)


def whisper_stream(engine, cfg, workload, run, label):
    """One stream through ``engine`` (``run``: run_offline or run_server)
    with the paged and flash counters zeroed just before: the paged
    kernel (of the pool's branch) once per decoder layer per chunk step,
    the flash forward once per encoder layer per admission at the
    encoder's B 1 shape, nothing else; every request its tokens; a second
    run the same tokens. Returns (report, summary dict)."""
    kind = engine.cfg.kv_cache_dtype
    reqs = workload()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launches()
    fa.reset_launches()
    report = run(engine, reqs)
    paged = dict(pa.paged_attention_cuda.launches_by_kind)
    flash = dict(fa.flash_attention_fwd_cuda.launches_by_shape)
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunks = [st for st in report.steps if st.kind != "encode"]
    encodes = [st.wall_s * 1e3 for st in report.steps if st.kind == "encode"]
    s = report.summary()
    s.update(kv=kind, chunk_steps=len(chunks), encodes=len(encodes),
             encode_ms_p50=float(np.median(encodes)),
             paged_launches=paged[kind],
             flash_launches=sum(flash.values()), peak_mem_gib=peak)
    print(f"  {label}: {report.format()}", flush=True)
    print(f"  {label}: {len(chunks)} chunk steps, {len(encodes)} encodes "
          f"(p50 {s['encode_ms_p50']:.2f} ms, encoder + 24 layers' cross "
          f"K/V), paged launches {paged} (expected {cfg.n_layers} x "
          f"{len(chunks)} {kind}), flash forward {flash} (expected "
          f"{cfg.n_enc_layers} x {len(encodes)} at the encoder's B 1 "
          f"shape), backward {fa.flash_attention_bwd_cuda.launches}; peak "
          f"memory {peak:.2f} GiB", flush=True)
    if (paged[kind] != cfg.n_layers * len(chunks) or not chunks
            or sum(paged.values()) != paged[kind]):
        raise AssertionError(f"{label}: paged launches {paged} in "
                             f"{len(chunks)} chunk steps")
    if (flash != {whisper_shape("enc_B1"): cfg.n_enc_layers * len(encodes)}
            or len(encodes) < len(reqs)
            or fa.flash_attention_bwd_cuda.launches):
        raise AssertionError(f"{label}: flash launches {flash} for "
                             f"{len(encodes)} encodes")
    got = tokens_of(report)
    if len(got) != len(reqs) or any(
            len(t) != NEW_TOKENS or not all(0 <= x < cfg.vocab for x in t)
            for t in got):
        raise AssertionError(f"{label}: not {len(reqs)} x {NEW_TOKENS} "
                             f"tokens in the vocabulary")
    if tokens_of(run(engine, workload())) != got:
        raise AssertionError(f"{label}: a second run of the stream differs")
    print(f"  {label}: a second run gives the same greedy tokens", flush=True)
    return report, s


def whisper_stream_a(cfg):
    """Stream (a) for whisper: the 8 ragged requests, each with its own
    frames."""
    return synthetic_requests(cfg, n=8, tokens=NEW_TOKENS,
                              prompt_len=max(PROMPT_LENS), seed=0,
                              prompt_lens=PROMPT_LENS)


def whisper_scfg():
    """The serving config of whisper's stream (a)."""
    return ServeConfig(max_batch=8, max_len=max(PROMPT_LENS) + NEW_TOKENS,
                       page_size=16, prefill_chunk=8)


def serve_whisper():
    """whisper-medium at every published width and depth (24 + 24
    layers, random bf16 weights from seed 0) serves stream (a), the 8
    ragged requests offline, each with its own 1500 x 1024 frames, then
    stream (b), two 96-token templates with 32-token suffixes (same
    template, same media) in the server scenario with the prefix cache
    and n-gram drafts of 3, from a bf16 and from an int8 pool; one chunk
    step of 8 x 8 tokens traced. Returns the launches (encoder flash at
    B 1 in stream (a), paged bf16 in stream (a), paged int8 in stream
    (b)), stream (a)'s greedy tokens and its summary."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(WHISPER)
    phase(f"serve: {WHISPER} every published width and depth "
          f"({cfg.n_enc_layers} + {cfg.n_layers} layers), bf16 weights, "
          f"stream (a): 8 ragged requests, own media each, offline")
    t0 = time.perf_counter()
    params = encdec.init_encdec(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = cfg.param_count()
    print(f"  {n / 1e9:.3f} B params ({2 * n / 1e9:.2f} GB bf16), d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.enc_source_len} frames; init in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    scfg = whisper_scfg()
    engine = Engine(cfg, params, scfg, device="cuda")
    if engine.layout != "paged":
        raise AssertionError(f"{WHISPER} served from {engine.layout}")
    run_offline(engine, synthetic_requests(cfg, n=2, tokens=2, prompt_len=8,
                                           seed=1))  # warm-up

    def stream_a():
        return whisper_stream_a(cfg)

    report_a, sa = whisper_stream(engine, cfg, stream_a, run_offline,
                                  "stream (a)")
    launches = (sa["flash_launches"], sa["paged_launches"])

    # one mixed chunk step, 8 rows x 8 tokens, against a fresh pool whose
    # 8 cross slots hold one request's encoder K/V
    B, C = 8, scfg.prefill_chunk
    cache = encdec.init_paged_cache(cfg, B, 16, 16, device="cuda")
    with torch.inference_mode():
        frames = torch.tensor(stream_a()[0].media)[None].cuda()
        kv = encdec.encode_cross(params, cfg, frames)
        for slot in range(B):
            slab_ops.write_slot(cache["cross"], kv, slot)
    pt = torch.full((B, 2), -1, dtype=torch.int32, device="cuda")
    pt[:, 0] = torch.arange(B, dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab, (B, C), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(3))
    zero = torch.zeros(B, dtype=torch.int32, device="cuda")
    nv = torch.full((B,), C, dtype=torch.int32, device="cuda")

    def chunk():
        with torch.inference_mode():
            return encdec.decode_chunk(params, cfg, toks, cache, pt, zero,
                                       nv)[0]

    logits = chunk()
    if tuple(logits.shape) != (B, cfg.vocab) or \
            not torch.isfinite(logits.float()).all():
        raise AssertionError(f"{WHISPER}: chunk logits not finite (B, vocab)")
    ms, busy, kernels = timed_and_traced(chunk)
    print(f"  one chunk step (8 x 8 tokens): {ms:.2f} ms (median of 3, to "
          f"the card's end); traced: {sum(e.count for e in kernels)} kernels,"
          f" device busy {busy:.2f} ms = {100 * busy / ms:.1f}%; top "
          f"kernels:", flush=True)
    for e in kernels[:6]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:5d}x {e.key[:100]}")
    sa.update(chunk_ms=ms, chunk_busy_ms=busy, chunk_busy_share=busy / ms)
    print(f"  serve stream (a) summary {json.dumps(sa)}", flush=True)
    del engine, cache, kv, logits
    gc.collect()
    torch.cuda.empty_cache()

    def stream_b():
        return synthetic_requests(
            cfg, n=8, tokens=NEW_TOKENS, prompt_len=SHARED + SUFFIX,
            scenario="server", seed=0, arrival_rate=RATE,
            shared_prefix_len=SHARED, n_templates=2)

    for kv_dtype in ("bfloat16", "int8"):
        phase(f"serve: {WHISPER} stream (b): 2 templates of {SHARED} tokens "
              f"+ {SUFFIX}-token suffixes, same-template media shared, "
              f"server scenario, prefix cache, n-gram drafts of 3, "
              f"{kv_dtype} pool")
        engine = Engine(cfg, params, ServeConfig(
            max_batch=8, max_len=SHARED + SUFFIX + NEW_TOKENS, page_size=16,
            prefill_chunk=8, prefix_cache=True, spec_decode="ngram",
            draft_len=3, kv_dtype=kv_dtype), device="cuda")
        run_offline(engine, synthetic_requests(cfg, n=2, tokens=2,
                                               prompt_len=8, seed=1))
        report, sb = whisper_stream(engine, cfg, stream_b, run_server,
                                    f"stream (b) {kv_dtype}")
        print(f"  stream (b) {kv_dtype}: prefix_hit_rate "
              f"{report.prefix_hit_rate:.4f}, pages shared "
              f"{report.pages_shared}, draft_tokens {report.draft_tokens} "
              f"(accepted {report.draft_accepted}, spec_accept_rate "
              f"{report.spec_accept_rate:.4f}), preemptions "
              f"{report.preemptions}", flush=True)
        if not report.prefix_hit_rate or report.draft_tokens == 0:
            raise AssertionError(f"stream (b) {kv_dtype}: prefix_hit_rate "
                                 f"{report.prefix_hit_rate}, draft_tokens "
                                 f"{report.draft_tokens}; both must be > 0")
        sb.update(draft_accepted=report.draft_accepted)
        print(f"  serve stream (b) {kv_dtype} summary {json.dumps(sb)}",
              flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return (*launches, sb["paged_launches"], tokens_of(report_a), sa)


def run_whisper_trainer(cfg, steps, mesh=None):
    """A fresh trainer (weights from seed 0; on ``mesh`` when given)
    fitted for ``steps`` steps of ``synthetic_lm_batches(seed=0)``: 8
    examples of 1500 frames and 448 target tokens; returns (trainer,
    history)."""
    tr = Trainer(cfg, TrainerConfig(total_steps=steps, log_every=1),
                 device="cuda", mesh=mesh)
    hist = tr.fit(synthetic_lm_batches(cfg, batch=WHISPER_BATCH,
                                       seq=WHISPER_SEQ, steps=steps, seed=0),
                  hooks=tr.default_hooks() + [SyncEveryStep()])
    return tr, hist


def train_whisper():
    """whisper-medium at every published width and depth (fp32 masters,
    gradients and Adam moments, bf16 compute, remat, one microbatch)
    takes 4 steps of batch 8 x (1500 frames, 448 tokens) through
    ``Trainer.fit``: the flash counters, zeroed just before, must show
    per step forward 2 x 24 (with the remat recompute) and backward 24
    at each of the encoder's, the cross-attention's and the decoder's
    shapes, and a second run from the same seed must repeat the losses
    bitwise. Returns ({suffix: (forward launches, backward launches)},
    the run's summary: losses, step ms, target tokens/s, peak GiB)."""
    cfg = get_config(WHISPER)
    phase(f"train: {WHISPER} every published width and depth "
          f"({cfg.n_enc_layers} + {cfg.n_layers} layers), batch "
          f"{WHISPER_BATCH} x ({cfg.enc_source_len} frames, {WHISPER_SEQ} "
          f"tokens), one microbatch, fp32 masters, gradients and moments, "
          f"bf16 compute, remat")
    if not cfg.remat or cfg.microbatches != 1:
        raise AssertionError("the full config trains with remat, unsplit")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    tr, hist = run_whisper_trainer(cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd = dict(fa.flash_attention_fwd_cuda.launches_by_shape)
    bwd = dict(fa.flash_attention_bwd_cuda.launches_by_shape)
    n_params = sum(p.numel() for p in tree_leaves(tr.state["params"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in hist]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    per = {"enc": cfg.n_enc_layers, "cross": cfg.n_layers,
           "dec": cfg.n_layers}
    want_f = {whisper_shape(k): 2 * n * TRAIN_STEPS for k, n in per.items()}
    want_b = {whisper_shape(k): n * TRAIN_STEPS for k, n in per.items()}
    step_ms = float(np.median([r["step_ms"] for r in hist[1:]]))
    tok_s = WHISPER_BATCH * WHISPER_SEQ / (step_ms / 1e3)
    print(f"  {n_params / 1e9:.3f} B params; {TRAIN_STEPS} steps in "
          f"{wall:.1f} s; losses {losses}; step {step_ms:.1f} ms (median of "
          f"steps 2-{TRAIN_STEPS}: {[round(r['step_ms'], 1) for r in hist]}),"
          f" {tok_s:.0f} target tokens/s; peak memory {peak:.2f} GiB; flash "
          f"launches forward {fwd}, backward {bwd}", flush=True)
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{WHISPER}: non-finite or missing losses "
                             f"{hist}")
    if fwd != want_f or bwd != want_b:
        raise AssertionError(f"{WHISPER}: flash launches {fwd}, {bwd} != "
                             f"{want_f}, {want_b}")
    tr, again = run_whisper_trainer(cfg, 2)
    again = [r["loss"] for r in again]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  second run, 2 steps: losses {again}", flush=True)
    if again != losses[:2]:
        raise AssertionError(f"{WHISPER}: a second run's losses differ: "
                             f"{again} vs {losses[:2]}")
    print("  bitwise equal to the first run's", flush=True)
    summary = dict(arch=WHISPER, n_params=n_params, step_ms=step_ms,
                   target_tokens_per_s=tok_s, peak_mem_gib=peak,
                   losses=losses, wall_s=wall)
    print(f"  train summary {json.dumps(summary)}", flush=True)
    return ({k: (want_f[whisper_shape(k)], want_b[whisper_shape(k)])
             for k in per}, summary)


def whisper_phases():
    """The whisper phases in turn, their wall printed, then
    ``dist-whisper`` against their one-device runs. Returns the kernel
    records, with their launches on the serve and train paths, and those
    of the mesh's call sites."""
    t0 = time.perf_counter()
    flash, paged = check_whisper_kernels()
    reduced_whisper_vs_cpu()
    enc1, paged_bf16, paged_int8, tokens, served = serve_whisper()
    flash["enc_B1"][0]["launches"] = enc1
    paged["bfloat16"]["launches"] = paged_bf16
    paged["int8"]["launches"] = paged_int8
    launches, trained = train_whisper()
    for suffix, (f, b) in launches.items():
        flash[suffix][0]["launches"], flash[suffix][1]["launches"] = f, b
    print(f"  whisper phases wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    mesh = dist_whisper(dict(trained, tokens=tokens, served=served))
    return [paged["bfloat16"], paged["int8"], flash["enc_B1"][0],
            *(r for k in ("enc", "cross", "dec") for r in flash[k]),
            *mesh_records(flash, paged, mesh)]


DIST_WHISPER_STEPS = 2  # train-whisper's second run


def dist_whisper(one=None):
    """whisper-medium on a 1 x 1 ("data", "model") NCCL mesh (phase 21,
    ``dist-whisper``), destroyed in a ``finally``: with one rank every
    collective is a copy and the mesh path runs the one-device arithmetic
    in the same order. Training: every published width and depth in its
    config's ``wus`` mode with ``seq_parallel``, 2 steps of batch 8 x
    (1500 frames, 448 tokens) from seed 0 through ``Trainer(cfg, tcfg,
    mesh=)``: the losses bitwise train-whisper's second run, the flash
    counters, zeroed just before, at forward 2 x 24 and backward 24 a
    step at each of the encoder's, the cross-attention's and the
    decoder's shapes. Serving: stream (a) through ``Engine(rules=
    Rules(mesh, "tp2d"))`` from bf16 weights of seed 0: greedy tokens
    bitwise serve-whisper's, the paged counter at 24 a chunk step, the
    encoder's flash at B 1 at 24 an admission (``whisper_stream``, which
    repeats the stream). ``one`` holds the one-device runs' losses, step
    ms, tokens/s, peak and stream (a)'s tokens and summary (made here
    when None). Returns the mesh runs' launches: {"fwd": {suffix: n},
    "bwd": {suffix: n}, "enc_B1": n, "paged": n}."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import Rules

    cfg = get_config(WHISPER)
    if (cfg.param_sharding, cfg.seq_parallel) != ("wus", True):
        raise AssertionError(f"{WHISPER}'s mode {cfg.param_sharding}, "
                             f"seq_parallel {cfg.seq_parallel}")
    t0 = time.perf_counter()
    if one is None:
        one = whisper_one_device(cfg)
    phase(f"dist-whisper: {WHISPER} every published width and depth on a "
          f"1 x 1 NCCL mesh: {DIST_WHISPER_STEPS} train steps in "
          f"{cfg.param_sharding} with seq_parallel, then stream (a) in tp2d")
    mesh = single_device_mesh("cuda")
    try:
        print(f"  mesh {mesh.shape} over {dist.get_world_size()} rank(s), "
              f"backend {dist.get_backend()}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        tr, hist = run_whisper_trainer(cfg, DIST_WHISPER_STEPS, mesh)
        torch.cuda.synchronize()
        fwd = dict(fa.flash_attention_fwd_cuda.launches_by_shape)
        bwd = dict(fa.flash_attention_bwd_cuda.launches_by_shape)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        params = encdec.init_encdec(cfg, seed=0, device="cuda")
        engine = Engine(cfg, params, whisper_scfg(), rules=Rules(mesh,
                                                                 "tp2d"))
        run_offline(engine, synthetic_requests(cfg, n=2, tokens=2,
                                               prompt_len=8, seed=1))
        report, sa = whisper_stream(engine, cfg,
                                    lambda: whisper_stream_a(cfg),
                                    run_offline, "tp2d stream (a)")
        del engine, params
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in hist]
    step_ms = float(np.median([r["step_ms"] for r in hist[1:]]))
    tok_s = WHISPER_BATCH * WHISPER_SEQ / (step_ms / 1e3)
    per = {"enc": cfg.n_enc_layers, "cross": cfg.n_layers,
           "dec": cfg.n_layers}
    want_f = {whisper_shape(k): 2 * n * DIST_WHISPER_STEPS
              for k, n in per.items()}
    want_b = {whisper_shape(k): n * DIST_WHISPER_STEPS
              for k, n in per.items()}
    print(f"  train on the mesh: losses {losses} (one device "
          f"{one['losses'][:DIST_WHISPER_STEPS]}); step {step_ms:.1f} ms "
          f"(step 2; one device {one['step_ms']:.1f}, the median of its "
          f"steps after the first), {tok_s:.0f} target tokens/s (one device "
          f"{one['target_tokens_per_s']:.0f}); peak memory {peak:.2f} GiB "
          f"(one device {one['peak_mem_gib']:.2f}); flash launches forward "
          f"{fwd}, backward {bwd}", flush=True)
    if losses != one["losses"][:DIST_WHISPER_STEPS]:
        raise AssertionError(f"dist-whisper: the mesh trainer's losses "
                             f"{losses} differ from one device's")
    if fwd != want_f or bwd != want_b:
        raise AssertionError(f"dist-whisper: flash launches {fwd}, {bwd} "
                             f"!= {want_f}, {want_b}")
    served = one["served"]
    print(f"  serve in tp2d: {sa['tokens_per_s']:.1f} tokens/s (one device "
          f"{served['tokens_per_s']:.1f}); peak memory "
          f"{sa['peak_mem_gib']:.2f} GiB (one device "
          f"{served['peak_mem_gib']:.2f}); paged launches "
          f"{sa['paged_launches']} in {sa['chunk_steps']} chunk steps, "
          f"encoder flash {sa['flash_launches']} in {sa['encodes']} "
          f"admissions", flush=True)
    if tokens_of(report) != one["tokens"]:
        raise AssertionError("dist-whisper: tp2d's greedy tokens differ from "
                             "the one-device engine's")
    summary = dict(train_step_ms=step_ms, train_tokens_per_s=tok_s,
                   train_peak_gib=peak, one_step_ms=one["step_ms"],
                   one_tokens_per_s=one["target_tokens_per_s"],
                   one_peak_gib=one["peak_mem_gib"],
                   serve_tokens_per_s=sa["tokens_per_s"],
                   serve_peak_gib=sa["peak_mem_gib"],
                   one_serve_tokens_per_s=served["tokens_per_s"],
                   one_serve_peak_gib=served["peak_mem_gib"],
                   wall_s=time.perf_counter() - t0)
    print(f"  losses and greedy tokens bitwise the one-device runs'; "
          f"dist-whisper summary {json.dumps(summary)}", flush=True)
    return {"fwd": {k: want_f[whisper_shape(k)] for k in per},
            "bwd": {k: want_b[whisper_shape(k)] for k in per},
            "enc_B1": sa["flash_launches"], "paged": sa["paged_launches"]}


def whisper_one_device(cfg):
    """The one-device runs ``dist_whisper`` is held to, when the phase
    runs alone: 2 train steps (train-whisper's second run) and stream (a)
    from seed 0's bf16 weights."""
    phase(f"dist-whisper: the one-device runs ({DIST_WHISPER_STEPS} train "
          f"steps, stream (a))")
    torch.cuda.reset_peak_memory_stats()
    tr, hist = run_whisper_trainer(cfg, DIST_WHISPER_STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = float(np.median([r["step_ms"] for r in hist[1:]]))
    params = encdec.init_encdec(cfg, seed=0, device="cuda")
    engine = Engine(cfg, params, whisper_scfg(), device="cuda")
    run_offline(engine, synthetic_requests(cfg, n=2, tokens=2, prompt_len=8,
                                           seed=1))
    report, sa = whisper_stream(engine, cfg, lambda: whisper_stream_a(cfg),
                                run_offline, "one device stream (a)")
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=[r["loss"] for r in hist], step_ms=step_ms,
                target_tokens_per_s=WHISPER_BATCH * WHISPER_SEQ
                / (step_ms / 1e3), peak_mem_gib=peak,
                tokens=tokens_of(report), served=sa)


def mesh_records(flash, paged, launches):
    """The kernel records of the mesh's call sites (rows 2f-wm, 2b-wm,
    1-wm): on a 1 x 1 mesh the rank's shapes are one device's, so each
    is the record phase 2 timed at that shape this run, under its own
    name, with the mesh run's launches."""
    out = [dict(flash["enc_B1"][0], name=flash["enc_B1"][0]["name"]
                + "_mesh", launches=launches["enc_B1"]),
           dict(paged["bfloat16"], name=paged["bfloat16"]["name"] + "_mesh",
                launches=launches["paged"])]
    for k in ("enc", "cross", "dec"):
        for rec, key in zip(flash[k], ("fwd", "bwd")):
            out.append(dict(rec, name=rec["name"] + "_mesh",
                            launches=launches[key][k]))
    return out


# --------------------------------------------------------------------------- #
# qwen2-vl-7b (M-RoPE over a 1024-token media prefix, 28/4 heads of 128: G 7)
# and rwkv6-3b (the RWKV-6 time mix, plain PyTorch on both devices: the
# reference has no kernel for it): the flash kernels at the VLM's prefill and
# train shapes; both reduced, card vs CPU; every published width serving
# from the slab; training cut in depth.
# --------------------------------------------------------------------------- #
VLM, RWKV = "qwen2-vl-7b", "rwkv6-3b"
VLM_PREFILL_LEN = max(PROMPT_LENS)  # each prompt padded to it after the media
# Train cuts in depth at full width: qwen2-vl as yi-9b (train_depth checks
# that free memory holds it); rwkv6 as deep as keeps its phase near two
# minutes: its wkv loop launches several kernels a token a layer, with
# the remat and chunk recomputes ~75,000 a layer a step, host-bound (8
# layers took 38.5 s a step on an H100 host).
VLM_TRAIN_LAYERS, RWKV_TRAIN_LAYERS = 8, 4
# What one parameter of a train cut holds on the card (fp32 master,
# gradient and Adam moments, a bf16 compute copy, slack), and the room for
# one remat'ed layer's activations at 4 x 2048 and the allocator.
TRAIN_PARAM_BYTES, TRAIN_ACT_BYTES = 18, 10 << 30


def vlm_flash_shape(kind):
    """The flash launch-count key (B, Sq, Sk, H, K, D, causal) of the
    VLM's prefill at admission (B 1, the media and ``VLM_PREFILL_LEN``
    prompt positions) or of its train step (``TRAIN_BATCH`` x
    ``TRAIN_SEQ``, half of it media)."""
    cfg = get_config(VLM)
    B, S = ((1, cfg.n_media_tokens + VLM_PREFILL_LEN) if kind == "prefill"
            else (TRAIN_BATCH, TRAIN_SEQ))
    return (B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True)


def hold_flash_fp32(seed, B, S, H, K, D, *, Sk=None, causal=True):
    """The fp32 flash kernels, forward and backward (causal unless told;
    ``Sk`` keys, default S), against the plain version at (B, S, H, K, D)
    within 1e-4; the backward rerun bitwise. Returns the max |kernel -
    plain|."""
    tol = TOL[torch.float32]
    kw = dict(causal=causal)
    q, k, v, do = flash_inputs(seed, B, S, Sk or S, H, K, D, torch.float32)
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, **kw)
    grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    want = fa.flash_attention_torch(qp, kp, vp, **kw)
    want.backward(do)
    err = 0.0
    for got, ref in zip((out, *grads), (want, qp.grad, kp.grad, vp.grad)):
        err = max(err, (got - ref).abs().max().item())
        if not (torch.isfinite(got).all()
                and torch.allclose(got, ref, rtol=tol, atol=tol)):
            raise AssertionError(f"flash_attention fp32 B{B} S{S} {H}/{K}: "
                                 f"kernel != plain, max |diff| {err}")
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    if not all(torch.equal(a, b) for a, b in zip(again, grads)):
        raise AssertionError("flash_attention fp32: a rerun of the backward "
                             "differs")
    return err


def check_vlm_kernels():
    """The flash forward and backward at qwen2-vl-7b's 28/4 heads of 128
    (G 7), causal, bf16, at its prefill (B 1, 1024 media + 128 prompt
    positions) and its train step (B 4, S 2048, 1024 of them media):
    held against the plain version, the backward rerun bitwise, timed
    beside the bounds and SDPA on K/V expanded to 28 heads; then fp32 at
    B 2, S 200. Returns (the prefill's forward record, the train step's
    (forward, backward) records)."""
    cfg = get_config(VLM)
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S_pre = vlm_flash_shape("prefill")[1]
    phase(f"kernels: {VLM}'s shapes ({H}/{K} heads of {D}, G {H // K}, "
          f"causal): flash forward and backward at its prefill (B 1, S "
          f"{S_pre}) and train step (B {TRAIN_BATCH}, S {TRAIN_SEQ}) in "
          f"bf16, and in fp32 at B 2, S 200, vs plain PyTorch")
    t0 = time.perf_counter()
    tol = TOL[torch.bfloat16]
    pre = check_flash_case(600, VLM, 1, S_pre, H, K, D, torch.bfloat16, tol,
                           f"_{VLM}_prefill")
    train = check_flash_case(601, VLM, TRAIN_BATCH, TRAIN_SEQ, H, K, D,
                             torch.bfloat16, tol, f"_{VLM}")
    err = hold_flash_fp32(602, 2, 200, H, K, D)
    print(f"  {VLM} B2 S200 {H}/{K} (G {H // K}) D{D} fp32 causal: max"
          f"|kernel-plain| {err:.2e} (tol {TOL[torch.float32]:g}), backward "
          f"rerun bitwise equal", flush=True)
    print(f"  kernels-vlm wall {time.perf_counter() - t0:.1f} s", flush=True)
    return pre[0], train


def n_attn_layers(cfg):
    return sum(s.mixer == "attn" for s in cfg.block_pattern) * cfg.n_blocks


def reduced_slab_vs_cpu(arch, seed):
    """Reduced ``arch`` (qwen2-vl-7b with its 16 media tokens, or
    rwkv6-3b) in fp32, fp32 gradients and Adam moments, from the same
    ``params_from_numpy`` weights, norms perturbed: the card's path (the
    flash kernels for the VLM's attention, cuBLAS; RWKV-6's plain wkv
    loop) against the CPU's plain path. Prefill logits (media prepended)
    to 1e-4 of their largest entry; the loss to rtol 1e-4 and every
    gradient to 1e-3 of (its leaf's largest entry + 1e-3); the slab
    engine's greedy tokens (4 ragged requests, each with its own media
    for the VLM) equal; the losses of 3 Adam steps through
    ``Trainer.fit`` to rtol 1e-4."""
    phase(f"check: reduced {arch}, card vs CPU plain path, fp32: prefill "
          f"logits, loss, gradients, slab engine tokens, 3 Adam steps")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              kv_cache_dtype="float32", grad_dtype="float32",
                              moment_dtype="float32")
    tree = lm.perturb_norms(reference_layout(
        lm.init_lm(cfg, seed, device="cpu", dtype=torch.float32), cfg), seed)
    n_media = (cfg.n_media_tokens if cfg.frontend == "vision_patches"
               else 0)
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g)
    media = (torch.randn((2, n_media, cfg.d_model), generator=g)
             if n_media else None)
    fa.reset_launches()
    out = {}
    for dev in ("cpu", "cuda"):
        batch = {"tokens": toks.to(dev)}
        if media is not None:
            batch["media"] = media.to(dev)
        params = lm.params_from_numpy(tree, cfg, device=dev)
        with torch.inference_mode():
            logits, _ = lm.prefill(params, cfg, batch["tokens"],
                                   media=batch.get("media"))
        leaves = tree_leaves(params)
        for w in leaves:
            w.requires_grad_(True)
        loss, _ = lm.loss_fn(params, cfg, batch)
        out[dev] = (logits.float().cpu(), loss.item(),
                    [x.cpu() for x in torch.autograd.grad(loss, leaves)])
    launches = (fa.flash_attention_fwd_cuda.launches,
                fa.flash_attention_bwd_cuda.launches)
    n_attn = n_attn_layers(cfg)
    want = (2 * n_attn, n_attn)  # prefill and loss forward, loss backward
    (lc, nc, gc_), (lg, ng, gg) = out["cpu"], out["cuda"]
    rel = ((lc - lg).abs().max() / lc.abs().max()).item()
    err = max(((a - b).abs().max() / (a.abs().max() + 1e-3)).item()
              for a, b in zip(gc_, gg))
    print(f"  prefill logits max|card-cpu| {rel:.2e} of the largest (tol "
          f"1e-4); loss cpu {nc:.6f} card {ng:.6f}; gradients max "
          f"|card-cpu| / (max|cpu| + 1e-3) {err:.2e} over {len(gc_)} leaves "
          f"(tol 1e-3); flash launches forward {launches[0]}, backward "
          f"{launches[1]} (expected {want})", flush=True)
    if rel > 1e-4 or abs(nc - ng) > 1e-4 * abs(nc) or err > 1e-3:
        raise AssertionError(f"reduced {arch} differs card vs CPU: logits "
                             f"{rel}, loss {nc} vs {ng}, gradient {err}")
    if launches != want:
        raise AssertionError(f"reduced {arch}: flash launches {launches} != "
                             f"{want}")
    scfg = ServeConfig(max_batch=4, max_len=n_media + 24 + 8, prefill_len=24)
    toks = {}
    for dev in ("cpu", "cuda"):
        reqs = synthetic_requests(cfg, n=4, tokens=8, prompt_len=24, seed=3,
                                  prompt_lens=(5, 24, 11, 17))
        eng = Engine(cfg, lm.params_from_numpy(tree, cfg, device=dev), scfg,
                     device=dev)
        if eng.layout != "slab":
            raise AssertionError(f"reduced {arch} served from {eng.layout}")
        toks[dev] = tokens_of(run_offline(eng, reqs))
    if toks["cpu"] != toks["cuda"]:
        raise AssertionError(f"reduced {arch}: greedy tokens differ card vs "
                             f"CPU")
    print(f"  greedy tokens identical card vs CPU (4 ragged requests, slab "
          f"engine{', own media each' if n_media else ''})", flush=True)
    losses = {}
    for dev in ("cpu", "cuda"):
        tr = Trainer(cfg, TrainerConfig(total_steps=3, log_every=0),
                     device=dev, params=lm.params_from_numpy(
                         tree, cfg, device=dev, dtype=torch.float32))
        hist = tr.fit(synthetic_lm_batches(cfg, batch=4, seq=40, steps=3))
        losses[dev] = [r["loss"] for r in hist]
    print(f"  3 Adam steps: losses cpu {losses['cpu']}, card "
          f"{losses['cuda']}", flush=True)
    if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4, atol=0):
        raise AssertionError(f"reduced {arch} train losses differ card vs "
                             f"CPU: {losses}")
    print(f"  check-{'vlm' if n_media else 'rwkv'} wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def serve_slab_full(arch):
    """``arch`` at every published width and depth (random bf16 weights
    from seed 0; rwkv6's time-mix leaves fp32, as the reference reads
    them) serves stream (a), the 8 ragged requests with 32 new tokens,
    offline from the slab, each VLM request with its own 1024 x 3584
    media: the flash counter, zeroed just before, must show one forward
    per attention layer per admission at the prefill's shape (the VLM's
    28; none for rwkv6), and no backward; every request its tokens; a
    second run the same tokens. Then one prefill of the longest prompt
    and one decode step over 8 slots that hold it are timed and traced.
    Returns the flash forward launches."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    n_media = (cfg.n_media_tokens if cfg.frontend == "vision_patches"
               else 0)
    P = max(PROMPT_LENS)
    phase(f"serve: {arch} every published width and depth ({cfg.n_layers} "
          f"layers), bf16 weights, slab, stream (a): 8 ragged requests"
          + (f", own {n_media} x {cfg.d_model} media each" if n_media
             else "") + ", offline")
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = cfg.param_count()
    held = torch.cuda.memory_allocated()
    print(f"  {n / 1e9:.3f} B params (the reference's count), "
          f"{held / 2**30:.2f} GiB of weights on the card, d_model "
          f"{cfg.d_model}, "
          + (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
             f"M-RoPE, " if cfg.n_heads else
             f"RWKV-6 heads of {cfg.rwkv6.head_dim}, decay rank "
             f"{cfg.rwkv6.decay_lora_dim}, ")
          + f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; init in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    scfg = ServeConfig(max_batch=8, max_len=n_media + P + NEW_TOKENS,
                       prefill_len=P)
    engine = Engine(cfg, params, scfg, device="cuda")
    if engine.layout != "slab":
        raise AssertionError(f"{arch} served from {engine.layout}")
    run_offline(engine, synthetic_requests(cfg, n=2, tokens=2, prompt_len=8,
                                           seed=1))  # warm-up

    def workload():
        return synthetic_requests(cfg, n=8, tokens=NEW_TOKENS, prompt_len=P,
                                  seed=0, prompt_lens=PROMPT_LENS)

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    report = run_offline(engine, workload())
    flash = dict(fa.flash_attention_fwd_cuda.launches_by_shape)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prefills = sum(st.kind == "prefill" for st in report.steps)
    n_attn = n_attn_layers(cfg)
    want = ({vlm_flash_shape("prefill"): n_attn * prefills} if n_attn
            else {})
    s = report.summary()
    print(f"  {report.format()}", flush=True)
    print(f"  {prefills} prefills, "
          f"{sum(st.kind == 'decode' for st in report.steps)} decode steps; "
          f"flash forward {flash} (expected {want}: {n_attn} a prefill), "
          f"backward {fa.flash_attention_bwd_cuda.launches}; peak memory "
          f"{peak:.2f} GiB", flush=True)
    if flash != want or prefills != 8 or fa.flash_attention_bwd_cuda.launches:
        raise AssertionError(f"{arch}: flash launches {flash} in {prefills} "
                             f"prefills; expected {want}")
    got = tokens_of(report)
    if len(got) != 8 or any(len(t) != NEW_TOKENS or not all(
            0 <= x < cfg.vocab for x in t) for t in got):
        raise AssertionError(f"{arch}: not 8 x {NEW_TOKENS} tokens in the "
                             f"vocabulary")
    if tokens_of(run_offline(engine, workload())) != got:
        raise AssertionError(f"{arch}: a second run of the stream differs")
    print("  a second run gives the same greedy tokens", flush=True)

    # One prefill of the longest prompt (after its media), and one decode
    # step over 8 slots that each hold it, timed and traced.
    B = scfg.max_batch
    gen = torch.Generator("cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (1, P), device="cuda", generator=gen)
    media = (torch.randn((1, n_media, cfg.d_model), device="cuda",
                         generator=gen) if n_media else None)
    last = torch.full((1,), n_media + P - 1, dtype=torch.long, device="cuda")
    slab = slab_ops.init_slab(cfg, B, scfg.max_len, device="cuda")
    with torch.inference_mode():
        _, cache = lm.prefill(params, cfg, prompt, media=media,
                              cache_len=scfg.max_len, last_pos=last)
        for slot in range(B):
            slab_ops.write_slot(slab, cache, slot)
    tok = torch.zeros((B, 1), dtype=torch.long, device="cuda")
    pos = torch.full((B,), n_media + P, dtype=torch.long, device="cuda")

    def decode():
        with torch.inference_mode():
            lm.decode_step(params, cfg, tok, slab, pos)

    def prefill():
        with torch.inference_mode():
            lm.prefill(params, cfg, prompt, media=media,
                       cache_len=scfg.max_len, last_pos=last)

    readings = {}
    for name, fn in (("decode step", decode), ("prefill", prefill)):
        ms, busy, kernels = timed_and_traced(fn)
        n_kernels = sum(e.count for e in kernels)
        flash_ms = sum(e.self_device_time_total for e in kernels
                       if "flash_" in e.key) / 1e3
        readings[name] = dict(ms=ms, busy_ms=busy, kernels=n_kernels,
                              flash_ms=flash_ms)
        print(f"  {name} (8 slots)" if name == "decode step" else
              f"  {name} ({n_media} media + {P} prompt positions)", end="")
        print(f": {ms:.2f} ms (median of 3, to the card's end); traced: "
              f"{n_kernels} kernel launches, device busy {busy:.2f} ms = "
              f"{100 * busy / ms:.1f}%, flash {flash_ms:.3f} ms; top "
              f"kernels:", flush=True)
        for e in kernels[:6]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x {e.key[:100]}")
    s.update(arch=arch, n_params=n, weights_gib=held / 2**30,
             peak_mem_gib=peak, flash_launches=sum(flash.values()),
             readings=readings, wall_s=time.perf_counter() - t0)
    print(f"  serve summary {json.dumps(s)}", flush=True)
    del engine, params, slab, cache, report
    gc.collect()
    torch.cuda.empty_cache()
    return sum(flash.values())


def train_depth(cfg, want, free):
    """``want`` layers of full-width ``cfg``, or as many as ``free`` bytes
    hold at ``TRAIN_PARAM_BYTES`` a parameter beside
    ``TRAIN_ACT_BYTES`` (printed)."""
    per_layer, fixed = layer_bytes(cfg)  # bf16 bytes: 2 a parameter
    fits = int((free - TRAIN_ACT_BYTES - fixed // 2 * TRAIN_PARAM_BYTES)
               // (per_layer // 2 * TRAIN_PARAM_BYTES))
    depth = max(1, min(want, fits))
    print(f"  depth: {free / 2**30:.1f} GiB free hold {fits} layers of "
          f"{per_layer / 2 / 1e6:.0f} M params at {TRAIN_PARAM_BYTES} B a "
          f"parameter beside the embedding and head ({fixed / 2 / 1e9:.2f} "
          f"B params) and {TRAIN_ACT_BYTES >> 30} GiB of activations; "
          f"training {depth} of {cfg.n_layers}", flush=True)
    return depth


def train_cut(arch, want_layers, again=2):
    """Full-width ``arch`` cut to ``want_layers`` (fewer when free memory
    holds fewer, for the VLM) takes 4 steps of batch 4 x 2048 (for the
    VLM 1024 media + 1024 text positions a row) through ``Trainer.fit``
    (fp32 masters, gradients and moments, bf16 compute, remat): the
    flash counters, zeroed just before, must show per attention layer
    per step 2 forward launches (with the remat recompute) and 1
    backward at the train shape (none for rwkv6), and a second run from
    the same seed must repeat the first ``again`` losses bitwise.
    Returns the flash launches (forward, backward)."""
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(arch)
    vlm = full.frontend == "vision_patches"
    phase(f"train: {arch} full width, batch {TRAIN_BATCH} x {TRAIN_SEQ}"
          + (f" ({full.n_media_tokens} media + "
             f"{TRAIN_SEQ - full.n_media_tokens} text positions a row)"
             if vlm else "")
          + ", fp32 masters, gradients and moments, bf16 compute, remat")
    depth = (train_depth(full, want_layers, torch.cuda.mem_get_info()[0])
             if vlm else want_layers)
    cfg = dataclasses.replace(full, n_layers=depth)
    if not vlm:
        print(f"  depth: {depth} of {full.n_layers} layers (the plain wkv "
              f"loop sets the phase's time)", flush=True)
    if not cfg.remat or cfg.microbatches != 1:
        raise AssertionError("the full config trains with remat, unsplit")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    tr, hist = run_trainer(cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd = dict(fa.flash_attention_fwd_cuda.launches_by_shape)
    bwd = dict(fa.flash_attention_bwd_cuda.launches_by_shape)
    n_params = sum(p.numel() for p in tree_leaves(tr.state["params"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [r["loss"] for r in hist]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    n_attn = n_attn_layers(cfg)
    shape = vlm_flash_shape("train")
    want_f = {shape: 2 * n_attn * TRAIN_STEPS} if n_attn else {}
    want_b = {shape: n_attn * TRAIN_STEPS} if n_attn else {}
    step_ms = float(np.median([r["step_ms"] for r in hist[1:]]))
    pos_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    text = TRAIN_SEQ - (min(full.n_media_tokens, TRAIN_SEQ // 2) if vlm
                        else 0)
    print(f"  {depth} layers, {n_params / 1e9:.3f} B params; {TRAIN_STEPS} "
          f"steps in {wall:.1f} s; losses {losses}; step {step_ms:.1f} ms "
          f"(median of steps 2-{TRAIN_STEPS}: "
          f"{[round(r['step_ms'], 1) for r in hist]}), {pos_s:.0f} positions"
          f"/s ({TRAIN_BATCH * text / (step_ms / 1e3):.0f} text tokens/s); "
          f"peak memory {peak:.2f} GiB; flash launches forward {fwd}, "
          f"backward {bwd} (expected {want_f}, {want_b})", flush=True)
    if len(hist) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{arch}: non-finite or missing losses {hist}")
    if fwd != want_f or bwd != want_b:
        raise AssertionError(f"{arch}: flash launches {fwd}, {bwd} != "
                             f"{want_f}, {want_b}")
    tr, hist2 = run_trainer(cfg, again)
    losses2 = [r["loss"] for r in hist2]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  second run, {again} step(s): losses {losses2}", flush=True)
    if losses2 != losses[:again]:
        raise AssertionError(f"{arch}: a second run's losses differ: "
                             f"{losses2} vs {losses[:again]}")
    print("  bitwise equal to the first run's", flush=True)
    summary = dict(arch=arch, n_layers=depth, n_params=n_params,
                   step_ms=step_ms, positions_per_s=pos_s,
                   text_tokens_per_s=TRAIN_BATCH * text / (step_ms / 1e3),
                   peak_mem_gib=peak, losses=losses, wall_s=wall,
                   phase_wall_s=time.perf_counter() - t0)
    print(f"  train summary {json.dumps(summary)}", flush=True)
    return sum(fwd.values()), sum(bwd.values())


def vlm_rwkv_phases():
    """The qwen2-vl-7b and rwkv6-3b phases in turn, their wall printed.
    Returns the VLM's flash records with their launches on the serve and
    train paths."""
    t0 = time.perf_counter()
    pre, (fwd, bwd) = check_vlm_kernels()
    reduced_slab_vs_cpu(VLM, 3)
    reduced_slab_vs_cpu(RWKV, 4)
    pre["launches"] = serve_slab_full(VLM)
    serve_slab_full(RWKV)
    fwd["launches"], bwd["launches"] = train_cut(VLM, VLM_TRAIN_LAYERS)
    train_cut(RWKV, RWKV_TRAIN_LAYERS, again=1)
    print(f"  qwen2-vl and rwkv6 phases wall {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    return [pre, fwd, bwd]


# --------------------------------------------------------------------------- #
# The other MLPerf-0.6 models (launch/mlperf.py, fig9's step): the
# Transformer through the flash kernels at 16/16 heads of 64, at the
# paper's 97 and at 256; SSD and Mask R-CNN (plain convolutions, as
# ResNet-50's; roi_align and the resizes plain). The tiny configs card vs
# CPU; the published configs uncut.
# --------------------------------------------------------------------------- #
MLPERF_SEQS = (97, 256)  # the paper's truncation to the longest eval sentence
TRANSFORMER_BATCH, SSD_BATCH, MASKRCNN_BATCH = 32, 32, 16
MLPERF_STEPS = 4


def transformer_shapes(S):
    """{role: the flash launch-count key (B, Sq, Sk, H, K, D, causal)} of
    the full Transformer's train step at length S (source and target both
    S, as fig9 draws them: the cross-attention shares the encoder's
    key)."""
    cfg = mlperf_cli.configs("transformer", True)
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = TRANSFORMER_BATCH
    return {"enc": (B, S, S, H, K, D, False), "dec": (B, S, S, H, K, D, True),
            "cross": (B, S, S, H, K, D, False)}


def check_transformer_kernels():
    """The flash forward and backward at the full Transformer's train
    shapes (B 32, 16/16 heads of 64, bf16) at S 97 and 256: the encoder's
    (non-causal; the cross-attention's too, the source being as long as
    the target) and the decoder's (causal), each held against the plain
    version, rerun bitwise and timed beside its bound and SDPA; the
    cross-attention over a shorter source (Sq 97, Sk 71; Sq 256, Sk 200)
    held; fp32 at B 2, S 97 (off every tile), causal and a cross shape,
    held. Returns {(S, "enc" | "dec"): (forward record, backward
    record)}."""
    cfg = mlperf_cli.configs("transformer", True)
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = TRANSFORMER_BATCH
    phase(f"kernels: the MLPerf Transformer's shapes ({H}/{K} heads of {D}):"
          f" flash forward and backward at B {B}, S {MLPERF_SEQS} (encoder "
          f"and cross non-causal, decoder causal) vs plain PyTorch")
    t0 = time.perf_counter()
    tol = TOL[torch.bfloat16]
    recs = {}
    for i, S in enumerate(MLPERF_SEQS):
        for j, (role, causal) in enumerate((("enc", False), ("dec", True))):
            recs[(S, role)] = check_flash_case(
                700 + 2 * i + j, "transformer", B, S, H, K, D,
                torch.bfloat16, tol, f"_transformer_{role}{S}",
                causal=causal)
    for i, (Sq, Sk) in enumerate(((97, 71), (256, 200))):
        hold_flash_case(710 + i, "transformer", B, Sq, H, K, D,
                        torch.bfloat16, tol, Sk=Sk, causal=False)
    for i, (Sk, causal) in enumerate(((97, True), (71, False))):
        err = hold_flash_fp32(720 + i, 2, 97, H, K, D, Sk=Sk, causal=causal)
        print(f"  transformer B2 Sq97 Sk{Sk} {H}/{K} D{D} fp32 "
              f"{'causal' if causal else 'non-causal'}: max|kernel-plain| "
              f"{err:.2e} (tol {TOL[torch.float32]:g}), backward rerun "
              f"bitwise equal", flush=True)
    print(f"  kernels-transformer wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    return recs


def mlperf_tiny_fp32(model):
    cfg = mlperf_cli.configs(model)
    if model == "transformer":
        return dataclasses.replace(cfg, dtype="float32")
    return dataclasses.replace(cfg, dtype="float32", backbone=dataclasses.
                               replace(cfg.backbone, dtype="float32"))


def mlperf_grads(model, cfg, params, batch):
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    loss, _ = mlperf_cli.loss_of(model, cfg)(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.item(), [torch.zeros_like(w).cpu() if g is None else g.cpu()
                         for w, g in zip(leaves, grads)]


def reduced_mlperf_vs_cpu():
    """The three tiny configs in fp32 from the same weights (the port's
    init, seed 0) on both devices: the card's path (the flash kernels for
    the Transformer's attention, cuDNN and cuBLAS with TF32 off) against
    the CPU's plain path. The loss within rtol 1e-5, every gradient within
    1e-3 of its leaf's largest entry, then 3 steps of adam(1e-3) through
    ``launch/mlperf.train``, losses within rtol 1e-4; the Transformer's
    flash counters must show every attention of every step through the
    kernels (6 forward and 6 backward: 2 encoder, 2 x 2 decoder)."""
    phase("check: the tiny MLPerf Transformer, SSD and Mask R-CNN, card vs "
          "CPU plain path, fp32: loss, gradients, 3 Adam steps")
    t0 = time.perf_counter()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for model in mlperf_cli.MODELS:
            cfg = mlperf_tiny_fp32(model)
            init = mlperf_cli.init_params(model, cfg, 0, device="cpu")
            batch = mlperf_cli.synthetic_batch(
                model, cfg, mlperf_cli.DEFAULT_BATCH[model],
                np.random.default_rng(0))
            out, losses = {}, {}
            fa.reset_launches()
            for dev in ("cpu", "cuda"):
                params = tree_map(lambda w: w.to(dev, copy=True), init)
                b = mlperf_cli.to_device(batch, dev)
                out[dev] = mlperf_grads(model, cfg, params, b)
                params = tree_map(lambda w: w.to(dev, copy=True), init)
                hist = mlperf_cli.train(mlperf_cli.loss_of(model, cfg),
                                        params, b, steps=3, device=dev,
                                        log=lambda _: None)
                losses[dev] = [r["loss"] for r in hist]
            launches = [(r["flash_fwd"], r["flash_bwd"]) for r in hist]
            (lc, gc_), (lg, gg) = out["cpu"], out["cuda"]
            err = max(((a - b).abs().max() / (a.abs().max() + 1e-12)).item()
                      for a, b in zip(gc_, gg))
            n_attn = (cfg.n_enc_layers + 2 * cfg.n_layers
                      if model == "transformer" else 0)
            print(f"  {model}: loss cpu {lc:.7f} card {lg:.7f}; gradients "
                  f"max|card-cpu| / max|cpu| {err:.2e} over {len(gc_)} "
                  f"leaves (tol 1e-3); 3 Adam steps: losses cpu "
                  f"{losses['cpu']}, card {losses['cuda']}; flash launches a "
                  f"step {launches} (expected {n_attn} each)", flush=True)
            if abs(lc - lg) > 1e-5 * abs(lc) or err > 1e-3:
                raise AssertionError(f"tiny {model} differs card vs CPU: loss "
                                     f"{lc} vs {lg}, gradient {err}")
            if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4,
                               atol=0):
                raise AssertionError(f"tiny {model}: Adam losses differ card "
                                     f"vs CPU: {losses}")
            if launches != [(n_attn, n_attn)] * 3:
                raise AssertionError(f"tiny {model}: flash launches "
                                     f"{launches}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"  check-mlperf wall {time.perf_counter() - t0:.1f} s", flush=True)


def mlperf_run(model, cfg, batch, steps):
    """Weights from seed 0, then ``steps`` steps of adam(1e-3) on
    ``batch`` through ``launch/mlperf.train``, each timed to the loss on
    the host. Returns (params, history)."""
    params = mlperf_cli.init_params(model, cfg, 0, device="cuda")
    hist = mlperf_cli.train(mlperf_cli.loss_of(model, cfg), params, batch,
                            steps=steps, device="cuda", log=lambda _: None)
    return params, hist


def train_mlperf_full(model, B, *, seq=None):
    """``model`` at its published config, uncut (fp32 masters and Adam
    moments, bf16 compute), takes ``MLPERF_STEPS`` steps of batch ``B``
    (the Transformer at source and target length ``seq``) through
    ``launch/mlperf.train``, cuDNN held to its deterministic algorithms:
    finite losses; the Transformer's flash counters, zeroed just before,
    must show in every step 2 x 6 forward (with the remat recompute) and
    6 backward launches at each of its three attentions' shapes; a second
    run's losses bitwise equal; one more step traced (busy share). Prints
    step ms, throughput and peak memory. Returns (summary, the flash
    launches by shape in the first run)."""
    cfg = mlperf_cli.configs(model, True)
    what = (f"S {seq} (source and target), {B * seq} target tokens a step"
            if model == "transformer" else
            f"{cfg.image_size} x {cfg.image_size} images")
    phase(f"train: {cfg.name} published config, uncut, batch {B}, {what}, "
          f"fp32 masters and Adam moments, bf16 compute")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batch = mlperf_cli.to_device(mlperf_cli.synthetic_batch(
        model, cfg, B, np.random.default_rng(0), seq=seq or 97), "cuda")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        params, hist = mlperf_run(model, cfg, batch, MLPERF_STEPS)
        torch.cuda.synchronize()
        fwd = dict(fa.flash_attention_fwd_cuda.launches_by_shape)
        bwd = dict(fa.flash_attention_bwd_cuda.launches_by_shape)
        peak = torch.cuda.max_memory_allocated() / 2**30
        leaves = tree_leaves(params)
        n_params = sum(w.numel() for w in leaves)
        losses = [r["loss"] for r in hist]
        want_f, want_b = {}, {}
        if model == "transformer":
            n = {"enc": cfg.n_enc_layers, "dec": cfg.n_layers,
                 "cross": cfg.n_layers}
            for role, key in transformer_shapes(seq).items():
                want_f[key] = want_f.get(key, 0) + 2 * n[role] * MLPERF_STEPS
                want_b[key] = want_b.get(key, 0) + n[role] * MLPERF_STEPS
        per_step = [(r["flash_fwd"], r["flash_bwd"]) for r in hist]
        step_ms = float(np.median([r["step_ms"] for r in hist[1:]]))
        unit = "target tokens" if model == "transformer" else "images"
        per_s = (B * seq if model == "transformer" else B) / (step_ms / 1e3)
        print(f"  {n_params} params ({n_params / 1e6:.2f} M); losses "
              f"{losses}; step ms {[round(r['step_ms'], 2) for r in hist]}, "
              f"median of steps 2-{MLPERF_STEPS} {step_ms:.2f} ms, "
              f"{per_s:.0f} {unit}/s; peak memory {peak:.2f} GiB; flash "
              f"launches a step {per_step}, forward {fwd}, backward {bwd}",
              flush=True)
        if len(hist) != MLPERF_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"{model}: non-finite or missing losses "
                                 f"{hist}")
        if fwd != want_f or bwd != want_b:
            raise AssertionError(f"{model}: flash launches {fwd}, {bwd} != "
                                 f"{want_f}, {want_b}")

        # One more step, untimed, timed, then traced.
        opt = adam(constant(mlperf_cli.LR))
        st = opt.init(params)
        step = mlperf_cli.make_train_step(mlperf_cli.loss_of(model, cfg), opt)
        step(params, st, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(params, st, batch)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t1) * 1e3
        _, busy_ms, kernels = trace_busy(lambda: step(params, st, batch))
        n_k = sum(e.count for e in kernels)
        flash_ms = sum(e.self_device_time_total for e in kernels
                       if "flash_" in e.key) / 1e3
        by_kind = {}
        for e in kernels:
            kind = kernel_kind(e.key)
            by_kind[kind] = (by_kind.get(kind, 0.0)
                             + e.self_device_time_total / 1e3)
        print(f"  traced step: {n_k} kernels, device busy {busy_ms:.2f} ms = "
              f"{100 * busy_ms / one_ms:.1f}% of the same step untraced "
              f"({one_ms:.2f} ms); flash {flash_ms:.3f} ms; by kind: "
              + ", ".join(f"{k} {v:.2f} ms ({100 * v / busy_ms:.1f}%)"
                          for k, v in sorted(by_kind.items(),
                                             key=lambda kv: -kv[1])),
              flush=True)
        for e in kernels[:8]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x {e.key[:100]}")
        del params, leaves, st, step, kernels
        gc.collect()
        torch.cuda.empty_cache()

        _, again = mlperf_run(model, cfg, batch, 2)
        again = [r["loss"] for r in again]
        print(f"  second run, 2 steps: losses {again} ("
              f"{'bitwise equal' if again == losses[:2] else 'DIFFERENT'})",
              flush=True)
        if again != losses[:2]:
            raise AssertionError(f"{model}: a second run's losses differ: "
                                 f"{again} vs {losses[:2]}")
    finally:
        torch.backends.cudnn.deterministic = det
    gc.collect()
    torch.cuda.empty_cache()
    summary = dict(model=cfg.name, batch=B, seq=seq, n_params=n_params,
                   step_ms=step_ms, per_s=per_s, unit=unit,
                   peak_mem_gib=peak, losses=losses, traced_step_ms=one_ms,
                   device_busy_ms=busy_ms, busy_share=busy_ms / one_ms,
                   kernels_per_step=n_k, flash_device_ms=flash_ms,
                   by_kind_ms=by_kind,
                   phase_wall_s=time.perf_counter() - t0)
    print(f"  train summary {json.dumps(summary)}", flush=True)
    return summary, fwd, bwd


def train_transformer():
    """``train_mlperf_full`` for the Transformer at each of
    ``MLPERF_SEQS``: fig9's 256-against-97 comparison on the card.
    Returns {(S, "enc" | "dec"): (forward, backward launches)}."""
    out, ms = {}, {}
    for S in MLPERF_SEQS:
        summary, fwd, bwd = train_mlperf_full("transformer", TRANSFORMER_BATCH,
                                              seq=S)
        ms[S] = summary["step_ms"]
        shapes = transformer_shapes(S)
        for role in ("enc", "dec"):
            key = shapes[role]
            out[(S, role)] = (fwd[key], bwd[key])
    print(f"  step at S {MLPERF_SEQS[1]} / step at S {MLPERF_SEQS[0]}: "
          f"{ms[MLPERF_SEQS[1]] / ms[MLPERF_SEQS[0]]:.3f} (tokens "
          f"{MLPERF_SEQS[1] / MLPERF_SEQS[0]:.3f}x)", flush=True)
    return out


def mlperf_phases():
    """The MLPerf Transformer, SSD and Mask R-CNN phases in turn, their
    wall printed. Returns the Transformer's flash records with their
    launches on the train path."""
    t0 = time.perf_counter()
    recs = check_transformer_kernels()
    reduced_mlperf_vs_cpu()
    for key, (f, b) in train_transformer().items():
        recs[key][0]["launches"], recs[key][1]["launches"] = f, b
    train_mlperf_full("ssd", SSD_BATCH)
    train_mlperf_full("maskrcnn", MASKRCNN_BATCH)
    print(f"  mlperf phases wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    return [r for key in sorted(recs) for r in recs[key]]


# --------------------------------------------------------------------------- #
# Phase 14: the paper's distribution techniques on a 1 x 1 NCCL mesh.
# --------------------------------------------------------------------------- #
# mixtral-8x7b's attention (configs/mixtral_8x7b.py: 32/8 heads of 128,
# sliding window 4096) over one rank's 8192-token shard.
SWA_B, SWA_S, SWA_H, SWA_K, SWA_D, SWA_WINDOW = 1, 8192, 32, 8, 128, 4096
# The kernel rounds P to bf16 before its P @ V products, so on the first
# rows, where a few keys carry the weight, its error follows |v| (~1), not
# the output, which may cancel to ~0: no elementwise atol both holds those
# rows and binds the bulk (this phase's readings on an NVIDIA H100 80GB
# HBM3 at 700 W: rtol 2e-2 with atol 1e-3 fails the sound kernel). The
# kernel is held by its largest |error| over the output's RMS and by its
# relative L2 error, each set between the readings of the sound kernel
# (0.300, 2.17e-3) and of a plain output whose window is one key short
# (1.008, 5.58e-3), which each run prints and which must fail either.
SWA_MAX_TOL, SWA_L2_TOL = 0.6, 3.5e-3
# ResNet-50's mesh step is held in fp32 (TF32 off) against a one-device
# step that computes the same function: the plain model with the
# distributed batch norm's one-pass variance (the reference's formula).
# At random init the first step's gradient is fixed only to a few percent
# by fp32 arithmetic: the same one-device step on the batch in another
# order (the same function, its sums in another order) moves a leaf by
# up to ~7e-2 of the leaf's largest magnitude, with the one-pass variance
# or the two-pass one alike, while a planted fault moves some leaf by 1.0
# or more (this phase's readings on an NVIDIA H100 80GB HBM3 at 700 W).
# So each leaf's gradient, and each leaf's LARS step, is held within
# DIST_GRAD_TOL of the leaf's largest magnitude, between those readings;
# this run's sound readings (the batch reordered) must pass it, and its
# planted faults (a zero gradient, the previous batch's gradient) must
# fail it. The mesh
# gradient's semantics are held to 2e-5 over 8 ranks on the CPU
# (tests/test_torch_dist.py). The loss also against launch/resnet.py's
# one-device bf16 step, within the smoke's bf16 tolerance.
DIST_LOSS_RTOL = 2e-2
DIST_LOSS32_RTOL = 1e-5
DIST_GRAD_TOL = 0.25


def leaf_err(a, b):
    """max |a - b| / max |b| (0 when both are 0)."""
    scale = b.abs().max().item()
    diff = (a - b).abs().max().item()
    return diff / scale if scale else diff


def leaf_names(tree, prefix=""):
    """Dotted key paths of a tree of dicts, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def one_pass_batch_norm(x, scale, bias, *, eps: float = 1e-5):
    """``batch_norm`` with ``distributed_batch_norm``'s one-pass variance
    over this device's batch: the one-device reference of the mesh path."""
    red = tuple(range(x.dim() - 1))
    x32 = x.float()
    cnt = x32.numel() // x32.shape[-1]
    sums = torch.stack([x32.sum(red), (x32 ** 2).sum(red)])
    mu = sums[0] / cnt
    var = sums[1] / cnt - mu ** 2
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype), \
        mu, var


def dist_resnet(mesh):
    """ResNet-50 v1.5 at full width (224 x 224, batch 128) with
    ``bn_group_size=2`` and ``spatial_partition=True`` on the mesh, in
    fp32 with TF32 off: ``loss_fn(mesh=...)``, its gradient, the 2-D
    gradient summation (bitwise its input on one rank), then
    ``lars_sharded_update`` under the profiler (each LARS kernel launched
    once, the counters zeroed before the step agree), held bitwise
    against ``optim.lars`` on the same gradients. Against the one-device
    step with the one-pass variance (cuDNN deterministic): the loss, every
    leaf's gradient and every leaf's step, each within DIST_GRAD_TOL; the
    one-device step on the reordered batch must pass it, the planted
    faults must fail it. The loss also against
    ``launch/resnet.py``'s bf16 one-device step. Then the two kernels over
    the 54 leaves the rank owns, with this step's gradients and momenta:
    held against their plain versions (and bitwise against one-leaf
    launches) and timed. Returns the records 4a-w and 4b-w."""
    phase(f"dist: ResNet-50 v1.5 on the mesh, bn_group_size 2, spatial "
          f"partition, {RESNET_SIZE} x {RESNET_SIZE}, batch {RESNET_BATCH}, "
          f"fp32, then lars_sharded_update")
    plain = dataclasses.replace(resnet.RESNET50, dtype="float32")
    cfg = dataclasses.replace(plain, bn_group_size=2, spatial_partition=True)
    rng = np.random.default_rng(0)

    def make_batch():
        imgs, labels = resnet_cli.synthetic_images(
            RESNET_BATCH, RESNET_SIZE, cfg.num_classes, rng)
        return {"images": torch.from_numpy(imgs).cuda(),
                "labels": torch.from_numpy(labels).cuda()}

    other, batch = make_batch(), make_batch()  # the previous batch first
    order = torch.from_numpy(np.random.default_rng(7).permutation(
        RESNET_BATCH)).cuda()
    schedule = polynomial_warmup(resnet_cli.BASE_LR, 2, 8)
    params = resnet.init_resnet(cfg, seed=0, device="cuda")
    w0 = tree_map(torch.clone, params)
    one = tree_map(torch.clone, params)
    opt = lars(schedule)
    _, _, met = resnet_cli.make_train_step(resnet.RESNET50, opt)(
        one, opt.init(one), batch)
    loss_bf16 = met["loss"].item()
    del one

    def grads(p, c, b, m=None):
        leaves = tree_leaves(p)
        for w in leaves:
            w.requires_grad_(True)
        loss, _ = resnet.loss_fn(p, c, b, mesh=m)
        g = torch.autograd.grad(loss, leaves)
        for w in leaves:
            w.requires_grad_(False)
        return loss.item(), tree_unflatten(p, g)

    def one_pass(fn):
        real = resnet.batch_norm
        resnet.batch_norm = one_pass_batch_norm
        try:
            return fn()
        finally:
            resnet.batch_norm = real

    def worst(a, b):
        """(largest leaf error, its leaf's index, smallest leaf error)."""
        errs = [leaf_err(x, y) for x, y in zip(tree_leaves(a),
                                               tree_leaves(b))]
        i = int(np.argmax(errs))
        return errs[i], i, min(errs)

    names = leaf_names(w0)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss_ref, g_ref = one_pass(lambda: grads(w0, plain, batch))
        reordered = {k: v[order] for k, v in batch.items()}
        sound = {"one-pass": (one_pass(
            lambda: grads(w0, plain, reordered))[1], g_ref),
            "two-pass": (grads(w0, plain, reordered)[1],
                         grads(w0, plain, batch)[1])}
        faults = {"zero": tree_map(torch.zeros_like, g_ref),
                  "the previous batch's": one_pass(
                      lambda: grads(w0, plain, other))[1]}
        lk_lars.reset_launches()
        marks = [time.perf_counter()]
        loss_mesh, grads_mesh = grads(params, cfg, batch, mesh)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        summed = GS.gradient_allreduce_2d(grads_mesh, mesh)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        init, update = WUS.lars_sharded_update(schedule, mesh)
        st = init(params)
        _, _, kernels = trace_busy(lambda: update(summed, st, params))
        marks.append(time.perf_counter())
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    launches = (lk_lars.lars_norms_multi_cuda.launches,
                lk_lars.lars_apply_multi_cuda.launches)
    traced = {kernel_name(e.key): e.count for e in kernels
              if "lars_" in e.key}
    bitwise_sum = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(summed), tree_leaves(grads_mesh)))
    grad_err, grad_at, _ = worst(grads_mesh, g_ref)
    readings = {k: worst(g, g_ref) for k, g in faults.items()}
    sound = {k: worst(a, b) for k, (a, b) in sound.items()}
    sound_err = max(r[0] for r in sound.values())
    del faults

    ref = tree_map(torch.clone, w0)
    lars(schedule).update(g_ref, lars(schedule).init(ref), ref)
    same = tree_map(torch.clone, w0)
    lars(schedule).update(summed, lars(schedule).init(same), same)
    bitwise_opt = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(params), tree_leaves(same)))
    opt_err = max(leaf_err(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(same)))
    step_err, step_at, _ = worst(
        [a - w for a, w in zip(tree_leaves(params), tree_leaves(w0))],
        [b - w for b, w in zip(tree_leaves(ref), tree_leaves(w0))])
    print(f"  loss on the mesh {loss_mesh:.7f}, one-device one-pass "
          f"{loss_ref:.7f} (rtol {DIST_LOSS32_RTOL:g}), launch/resnet.py's "
          f"bf16 step {loss_bf16:.6f} (rtol {DIST_LOSS_RTOL:g}); mesh "
          f"forward + backward {step_ms[0]:.1f} ms, 2-D summation "
          f"{step_ms[1]:.1f} ms, profiled update {step_ms[2]:.1f} ms (first "
          f"calls)", flush=True)
    print(f"  gradient vs the one-device one-pass one, worst leaf "
          f"{grad_err:.3e} ({names[grad_at]}; tol {DIST_GRAD_TOL:g} of each "
          f"leaf's largest |g|); LARS step vs its step: worst leaf "
          f"{step_err:.3e} ({names[step_at]}); planted faults, worst / best "
          f"leaf: " + "; ".join(f"{k} {a:.3e} ({names[i]}) / {c:.3e}"
                                for k, (a, i, c) in readings.items())
          + "; sound, the one-device step on the batch reordered, worst / "
          "best leaf: " + "; ".join(f"{k} {a:.3e} ({names[i]}) / {c:.3e}"
                                   for k, (a, i, c) in sound.items()),
          flush=True)
    print(f"  2-D gradient summation "
          f"{'bitwise equal to' if bitwise_sum else 'DIFFERS from'} its "
          f"input; lars_sharded_update vs optim.lars on the same gradients: "
          f"{'bitwise equal' if bitwise_opt else f'max rel {opt_err:.2e}'};"
          f" lars launches (counters) norms {launches[0]}, update "
          f"{launches[1]}; profiler {traced}", flush=True)
    if not np.isfinite(loss_mesh) or abs(loss_mesh - loss_ref) > \
            DIST_LOSS32_RTOL * abs(loss_ref) or abs(
                loss_mesh - loss_bf16) > DIST_LOSS_RTOL * abs(loss_bf16):
        raise AssertionError(f"ResNet-50 loss on the mesh {loss_mesh} vs "
                             f"one device {loss_ref} (bf16 {loss_bf16})")
    if (not bitwise_sum or opt_err > 1e-6 or grad_err > DIST_GRAD_TOL
            or step_err > DIST_GRAD_TOL):
        raise AssertionError(f"ResNet-50 on the mesh: summation bitwise "
                             f"{bitwise_sum}, optimizer {opt_err}, gradient "
                             f"{grad_err}, step {step_err}")
    caught = {k: r[0] > DIST_GRAD_TOL for k, r in readings.items()}
    if not all(caught.values()) or sound_err > DIST_GRAD_TOL:
        raise AssertionError(f"the gradient check does not separate: "
                             f"planted faults caught {caught}, sound "
                             f"reading {sound_err}")
    if launches != (1, 1) or sorted(traced.values()) != [1, 1]:
        raise AssertionError(f"lars_sharded_update launches {launches}, "
                             f"profiler {traced}; expected 1 norms and 1 "
                             f"update")

    lr = schedule(st["step"].cpu()).cuda()
    triples = [(w.clone(), g.clone(), m.clone()) for w, g, m in zip(
        tree_leaves(params), tree_leaves(summed), tree_leaves(st["m"]))
        if w.dim() > 1]
    ws, gs, ms = map(list, zip(*triples))
    errs = (check_norms_multi("wus owned leaves", ws, gs, 1),
            check_update_multi("wus owned leaves", ws, gs, ms, 1, lr))
    t, bounds = lars_timings(ws, gs, ms, lr, "wus owned leaves")
    del triples, ws, gs, ms, params, w0, ref, same, grads_mesh, g_ref
    del summed, st, batch, other
    gc.collect()
    torch.cuda.empty_cache()
    src = "src/repro_torch/kernels/csrc/lars.cu"
    recs = []
    for key, name, line, n, err in (
            ("norms", "lars_norms_wus", 62, launches[0], errs[0]),
            ("update", "lars_update_wus", 80, launches[1], errs[1])):
        b, by = bounds[key]
        recs.append(dict(name=name, route="cuda", source=src,
                         replaces=f"src/repro/kernels/lars.py:{line}",
                         launches=n, max_abs_err=err, ms=t[key],
                         plain_ms=t["plain_" + key], bound_ms=b, bound_by=by,
                         library_ms=t["lib_" + key]))
    return recs


def dist_detectors(mesh):
    """SSD (300 x 300, batch 32) with ``spatial_partition=True``: its loss
    on the mesh against ``mesh=None``; Mask R-CNN (128 x 128, batch 16):
    stage 2's branches through ``run_partitioned`` on the mesh against
    them in order (outputs and loss), both bf16 compute, no gradient."""
    phase("dist: SSD with spatial partitioning and Mask R-CNN's "
          "partitioned stage 2 on the mesh")
    for model, B in (("ssd", SSD_BATCH), ("maskrcnn", MASKRCNN_BATCH)):
        cfg = mlperf_cli.configs(model, True)
        if model == "ssd":
            cfg = dataclasses.replace(cfg, spatial_partition=True)
        params = mlperf_cli.init_params(model, cfg, 0, device="cuda")
        batch = mlperf_cli.to_device(mlperf_cli.synthetic_batch(
            model, cfg, B, np.random.default_rng(0)), "cuda")
        mod = ssd_model if model == "ssd" else maskrcnn_model
        with torch.no_grad():
            t0 = time.perf_counter()
            got = mod.loss_fn(params, cfg, batch, mesh=mesh)[0].item()
            torch.cuda.synchronize()
            mesh_ms = (time.perf_counter() - t0) * 1e3
            want = mod.loss_fn(params, cfg, batch)[0].item()
            line = ""
            if model == "maskrcnn":
                im = batch["images"]
                a = maskrcnn_model.forward(params, cfg, im, mesh=mesh)
                b = maskrcnn_model.forward(params, cfg, im)
                same = all(torch.equal(a[k], b[k]) for k in
                           ("cls_logits", "box_preds", "masks"))
                line = (f"; stage 2 outputs "
                        f"{'bitwise equal' if same else 'DIFFER'}")
                if not same:
                    raise AssertionError("Mask R-CNN stage 2 on the mesh "
                                         "differs from its branches in order")
        print(f"  {cfg.name} batch {B}: loss on the mesh {got:.6f} "
              f"({mesh_ms:.1f} ms), without {want:.6f}"
              f"{' (bitwise equal)' if got == want else ''}{line}",
              flush=True)
        if not np.isfinite(got) or abs(got - want) > DIST_LOSS_RTOL * abs(
                want):
            raise AssertionError(f"{model}: loss on the mesh {got} vs "
                                 f"{want}")
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()


def dist_wus_adam(mesh):
    """Weight-update-sharded Adam (``sharded_update``) over the MLPerf
    Transformer's 210.7 M fp32 parameters, two steps of random gradients
    (N(0, 1e-3) from a seed), against ``optim.adam`` on the same
    gradients: weights within rtol 1e-6 (the same elementwise arithmetic
    on the flat shard; bitwise expected)."""
    cfg = mlperf_cli.configs("transformer", True)
    phase(f"dist: weight-update-sharded Adam over {cfg.name}'s parameters")
    params = mlperf_cli.init_params("transformer", cfg, 0, device="cuda")
    n = sum(w.numel() for w in tree_leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(3)
    grads = tree_map(lambda w: torch.randn(w.shape, generator=gen,
                                           device="cuda") * 1e-3, params)
    opt = adam(constant(mlperf_cli.LR))
    ref = tree_map(torch.clone, params)
    ref_st = opt.init(ref)
    init, update = WUS.sharded_update(opt, constant(mlperf_cli.LR), mesh)
    st, mine = init(params), params
    ms = []
    for _ in range(2):
        _, ref_st = opt.update(grads, ref_st, ref)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mine, st = update(grads, st, mine)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    err = max(leaf_err(a, b) for a, b in zip(tree_leaves(mine),
                                             tree_leaves(ref)))
    bitwise = all(torch.equal(a, b) for a, b in zip(tree_leaves(mine),
                                                    tree_leaves(ref)))
    print(f"  {n} params ({n / 1e6:.1f} M), moment shards {st['m'].numel()} "
          f"+ {st['v'].numel()}; 2 steps: "
          f"{'bitwise equal to' if bitwise else f'max rel {err:.2e} from'} "
          f"optim.adam; sharded update {ms[0]:.1f} / {ms[1]:.1f} ms "
          f"(host clock)", flush=True)
    if not (200e6 < n < 220e6) or err > 1e-6:
        raise AssertionError(f"WUS Adam over {n} params: max rel {err}")
    del params, grads, ref, ref_st, mine, st
    gc.collect()
    torch.cuda.empty_cache()


def dist_swa(mesh):
    """``seq_parallel_swa`` at mixtral-8x7b's attention (B 1, 8192 positions
    on the rank, 32/8 heads of 128, window 4096, bf16): one flash forward
    launch (counter zeroed just before) at k_offset -4096 over K/V with a
    4096-row zero halo, within the bf16 tolerance of ``ops.attention(...,
    window=4096)`` without the halo (the flash kernel too); the kernel at
    the halo'd shape against its plain version (in groups of 4 query heads
    over their KV head, so the fp32 scores stay 1.6 GB), then timed (the
    first timing after the build dropped) beside the plain version and
    SDPA's memory-efficient backend with the boolean window mask on K/V
    expanded to 32 heads. Held to SWA_MAX_TOL and SWA_L2_TOL; a plain
    output whose window is one key short must fail that. Returns the
    record 2f-s."""
    phase(f"dist: seq_parallel_swa, B {SWA_B}, S {SWA_S}, {SWA_H}/{SWA_K} "
          f"heads of {SWA_D}, window {SWA_WINDOW}, bf16")
    dtype = torch.bfloat16

    def diff(a, b):
        """(passes, max |a - b|, that over b's RMS, relative L2 error)."""
        a, b = a.float(), b.float()
        d = (a - b).abs().max().item()
        rms = b.square().mean().sqrt().item()
        l2 = ((a - b).norm() / b.norm()).item()
        return d / rms <= SWA_MAX_TOL and l2 <= SWA_L2_TOL, d, d / rms, l2
    q, k, v, _ = flash_inputs(41, SWA_B, SWA_S, SWA_S, SWA_H, SWA_K, SWA_D,
                              dtype)
    fa.reset_launches()
    with torch.no_grad():
        out = SP.seq_parallel_swa(q, k, v, window=SWA_WINDOW, mesh=mesh)
        torch.cuda.synchronize()
        launches = fa.flash_attention_fwd_cuda.launches
        want = ops.attention(q, k, v, causal=True, window=SWA_WINDOW)
    swa_ok, swa_err, swa_rel, swa_l2 = diff(out, want)
    halo = torch.zeros((SWA_B, SWA_WINDOW, SWA_K, SWA_D), dtype=dtype,
                       device="cuda")
    kx, vx = torch.cat([halo, k], 1), torch.cat([halo, v], 1)
    opts = dict(causal=True, window=SWA_WINDOW, q_offset=0,
                k_offset=-SWA_WINDOW)
    got, _ = fa.flash_attention_fwd_cuda(q, kx, vx, **opts)
    G = SWA_H // SWA_K

    def plain(window=SWA_WINDOW):
        return torch.cat([fa.flash_attention_torch(
            q[:, :, G * j:G * (j + 1)], kx[:, :, j:j + 1],
            vx[:, :, j:j + 1], **dict(opts, window=window))
            for j in range(SWA_K)], 2)

    with torch.no_grad():
        ref = plain()
        short = diff(plain(SWA_WINDOW - 1), ref)
    ok, err, rel_err, l2 = diff(got, ref)
    print(f"  one flash forward launch: {launches} (expected 1); "
          f"seq_parallel_swa vs ops.attention without the halo: max |diff| "
          f"{swa_err:.3e} ({swa_rel:.3e} of its RMS, rel L2 {swa_l2:.3e}); "
          f"kernel vs plain at Sk {SWA_S + SWA_WINDOW}, k_offset "
          f"{-SWA_WINDOW}: max |diff| {err:.3e} ({rel_err:.3e} of its RMS, "
          f"tol {SWA_MAX_TOL:g}; rel L2 {l2:.3e}, tol {SWA_L2_TOL:g}); "
          f"planted: the plain version with the window one key short "
          f"{short[1]:.3e} ({short[2]:.3e} of its RMS, rel L2 "
          f"{short[3]:.3e}), {'passes' if short[0] else 'fails'}",
          flush=True)
    if launches != 1 or not (torch.isfinite(out).all() and swa_ok and ok):
        raise AssertionError(f"seq_parallel_swa: launches {launches}, vs "
                             f"unsharded {swa_err}, kernel vs plain {err}")
    if short[2] <= SWA_MAX_TOL or short[3] <= SWA_L2_TOL:
        raise AssertionError("a window one key short passes a check")
    del ref, want
    mask = fa.visible_mask(SWA_S, SWA_S + SWA_WINDOW, device="cuda", **opts)
    pairs = int(mask.sum())
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qs = q.transpose(1, 2)
    ks, vs = (t.repeat_interleave(G, dim=2).transpose(1, 2)
              for t in (kx, vx))

    def sdpa():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask)

    lib_err = (sdpa().transpose(1, 2).float() - got.float()).abs().max(
    ).item()

    def kernel():
        return fa.flash_attention_fwd_cuda(q, kx, vx, **opts)

    first = time_ms(kernel)
    turns = {"kernel": [], "sdpa": []}
    for key, fn in (("kernel", kernel), ("sdpa", sdpa), ("sdpa", sdpa),
                    ("kernel", kernel)):
        turns[key].append(time_ms(fn))
    t_k, t_lib = float(np.mean(turns["kernel"])), float(np.mean(turns["sdpa"]))
    t_plain = time_ms(plain, 3)
    t_swa = time_ms(lambda: SP.seq_parallel_swa(q, k, v, window=SWA_WINDOW,
                                                mesh=mesh))
    flops = 4 * SWA_D * pairs * SWA_B * SWA_H
    elt = q.element_size()
    nbytes = ((2 * q.numel() + 2 * kx.numel()) * elt
              + SWA_B * SWA_H * SWA_S * 4)
    b, by = bound(flops, nbytes, dtype)
    print(f"  timing: kernel {t_k:.4f} ms (turns {turns['kernel']}, the "
          f"first after the build {first:.4f} dropped; bound {b:.4f}, {by}: "
          f"{pairs} visible pairs, {flops} flop, {nbytes} B; "
          f"{100 * b / t_k:.1f}% of it), SDPA efficient backend "
          f"{t_lib:.4f} ms (turns {turns['sdpa']}, kernel/sdpa "
          f"{t_k / t_lib:.3f}, max |sdpa - kernel| {lib_err:.2e}), plain "
          f"(8 head groups) {t_plain:.4f} ms; seq_parallel_swa with its "
          f"halo {t_swa:.4f} ms", flush=True)
    del q, k, v, kx, vx, ks, vs, qs, out, got, mask, halo
    torch.cuda.empty_cache()
    return dict(name="flash_attention_fwd_swa", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:102",
                launches=launches, max_abs_err=err, ms=t_k,
                plain_ms=t_plain, bound_ms=b, bound_by=by, library_ms=t_lib)


def dist_phase():
    """The paper's distribution techniques through the port's mesh path on
    one card: world 1, NCCL, a 1 x 1 ("data", "model") mesh, full width.
    Returns the records 4a-w, 4b-w and 2f-s."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    mesh = single_device_mesh("cuda")
    print(f"  mesh {mesh.shape} over {dist.get_world_size()} rank(s), "
          f"backend {dist.get_backend()}", flush=True)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        recs = dist_resnet(mesh)
        dist_detectors(mesh)
        dist_wus_adam(mesh)
        recs.append(dist_swa(mesh))
    finally:
        torch.backends.cudnn.deterministic = det
        dist.destroy_process_group()
    print(f"  dist phase wall {time.perf_counter() - t0:.1f} s", flush=True)
    return recs


DIST_TRAIN_LAYERS, DIST_TRAIN_STEPS = 8, 3
DIST_TRAIN_LEAVES = (("embed", 0), ("layers", 0, "mixer", "wq"),
                     ("layers", 7, "ffn", "wd"), ("final_norm", "scale"))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def dist_train_run(cfg, batches, mesh):
    """One trainer (``mesh`` None: one device) from seed 0's weights over
    ``batches``: (losses, grad norms, step ms, peak GiB, flash launches,
    the leaves of ``DIST_TRAIN_LEAVES`` on the host, the steps' own peak
    bytes (reset after the trainer is built), the bytes of the trainer's
    state)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, TrainerConfig(total_steps=DIST_TRAIN_STEPS,
                                    log_every=0, metrics=("grad_norm",)),
                 device="cuda", mesh=mesh)
    built = torch.cuda.max_memory_allocated()
    state_bytes = tree_bytes(tr.state)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd_cuda.launches = 0
    fa.flash_attention_bwd_cuda.launches = 0
    hist = tr.fit(iter(batches), hooks=[SyncEveryStep()])
    torch.cuda.synchronize()
    launches = (fa.flash_attention_fwd_cuda.launches,
                fa.flash_attention_bwd_cuda.launches)
    leaves = [_at(tr.state["params"], p).detach().cpu().clone()
              for p in DIST_TRAIN_LEAVES]
    steps_peak = torch.cuda.max_memory_allocated()
    out = ([r["loss"] for r in hist], [r["grad_norm"] for r in hist],
           [r["step_ms"] for r in hist],
           max(built, steps_peak) / 2**30, launches, leaves, steps_peak,
           state_bytes)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_train():
    """The sharded trainer at full width on a 1 x 1 NCCL mesh against the
    one-device trainer (phase 15). With one rank every collective is a
    copy and the mesh path runs the same arithmetic in the same order,
    so the losses and weights must be bitwise the one-device ones."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("yi-9b"),
                              n_layers=DIST_TRAIN_LAYERS)
    if (cfg.param_sharding, cfg.seq_parallel) != ("wus", True):
        raise AssertionError(f"yi-9b's mode {cfg.param_sharding}, "
                             f"seq_parallel {cfg.seq_parallel}")
    phase(f"dist-train: yi-9b full width, {DIST_TRAIN_LAYERS} of 48 layers, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, {DIST_TRAIN_STEPS} steps, "
          f"one device, then the sharded trainer ({cfg.param_sharding}, "
          f"seq_parallel) on a 1 x 1 NCCL mesh")
    batches = list(synthetic_lm_batches(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                        steps=DIST_TRAIN_STEPS, seed=0))
    one = dist_train_run(cfg, batches, None)
    mesh = single_device_mesh("cuda")
    try:
        print(f"  mesh {mesh.shape} over {dist.get_world_size()} rank(s), "
              f"backend {dist.get_backend()}", flush=True)
        sharded = dist_train_run(cfg, batches, mesh)
    finally:
        dist.destroy_process_group()
    names = ("one device", "mesh")
    for name, (loss, gn, ms, peak, launches, *_) in zip(names,
                                                         (one, sharded)):
        print(f"  {name}: losses {loss}; grad norms {gn}; step ms "
              f"{[round(m, 1) for m in ms]} (median of steps 2-"
              f"{DIST_TRAIN_STEPS}: {float(np.median(ms[1:])):.1f}); peak "
              f"memory {peak:.2f} GiB; flash launches forward {launches[0]}, "
              f"backward {launches[1]}", flush=True)
    step = [float(np.median(r[2][1:])) for r in (one, sharded)]
    gn_err = max(abs(a - b) / abs(b) for a, b in zip(sharded[1], one[1]))
    leaf_eq = [torch.equal(a, b) for a, b in zip(sharded[5], one[5])]
    print(f"  mesh path overhead {step[1] - step[0]:.1f} ms a step "
          f"({(step[1] / step[0] - 1) * 100:.2f}%); losses "
          f"{'bitwise equal' if sharded[0] == one[0] else 'DIFFER'}; grad "
          f"norm max rel {gn_err:.2e}; leaves {list(DIST_TRAIN_LEAVES)} "
          f"bitwise {leaf_eq}", flush=True)
    want = (2 * cfg.n_layers * DIST_TRAIN_STEPS,
            cfg.n_layers * DIST_TRAIN_STEPS)
    if sharded[4] != want:
        raise AssertionError(f"mesh trainer flash launches {sharded[4]} "
                             f"!= {want}")
    if sharded[0] != one[0] or not all(leaf_eq) or gn_err > 1e-6:
        raise AssertionError("the mesh trainer on one rank differs from "
                             "the one-device trainer")
    if not all(np.isfinite(one[0])):
        raise AssertionError(f"non-finite losses {one[0]}")
    dryrun_vs_mesh_trainer(cfg, batches[0], sharded, step[1])
    print(f"  dist-train phase wall {time.perf_counter() - t0:.1f} s",
          flush=True)


def dryrun_vs_mesh_trainer(cfg, batch, run, step_ms):
    """The card's check of the dry run: ``dryrun_step`` on a fake 1 x 1
    world for the mesh trainer's config, batch shape and mode (its NCCL
    group already destroyed). Its argument bytes must equal the trainer's
    rank state plus one batch, byte for byte, and the steps' real peak
    (``max_memory_allocated`` from after the trainer was built) must be
    at most ``DRYRUN_PEAK_RATIO`` x the predicted peak. The analytic
    flops of the step (block-skip attention) over the median step time
    give its share of the card's bf16 peak."""
    shape = InputShape("dist_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    got = dryrun_step(cfg, shape, {"data": 1, "model": 1},
                      cfg.param_sharding)
    wall = time.perf_counter() - t0
    steps_peak, state_bytes = run[6], run[7]
    real_args = state_bytes + sum(v.nbytes for v in batch.values())
    ratio = steps_peak / got["peak_bytes_per_device"]
    fl = analysis.analytic_flops(cfg, shape)["total_flops"]
    print(f"  dry run of the mesh trainer's step ({got['mode']}, 1 x 1 "
          f"fake world, {wall:.1f} s): args {got['argument_bytes_per_device']}"
          f" B (trainer state {state_bytes} B + batch "
          f"{real_args - state_bytes} B = {real_args} B), predicted peak "
          f"{got['peak_bytes_per_device'] / 2**30:.2f} GiB (temp "
          f"{got['temp_bytes_per_device'] / 2**30:.2f} GiB), real steps' "
          f"peak {steps_peak / 2**30:.2f} GiB, real / predicted "
          f"{ratio:.3f}; traced flops {got['flops_per_device']:.4e}, "
          f"analytic (block-skip) {fl:.4e}: {fl / (step_ms * 1e-3) / 1e12:.1f}"
          f" TFLOP/s at the median step {step_ms:.1f} ms, "
          f"{100 * fl / (step_ms * 1e-3) / analysis.HW['peak_flops']:.1f}% "
          f"of 989 TFLOP/s; collectives {got['collective_counts']}",
          flush=True)
    if got["argument_bytes_per_device"] != real_args:
        raise AssertionError(f"dry-run argument bytes "
                             f"{got['argument_bytes_per_device']} != the "
                             f"trainer's {real_args}")
    if ratio > DRYRUN_PEAK_RATIO:
        raise AssertionError(f"the real peak is {ratio:.3f} x the dry "
                             f"run's predicted peak (limit "
                             f"{DRYRUN_PEAK_RATIO})")


# --------------------------------------------------------------------------- #
# Phase 19: the dry run, ``python -m repro_torch run --mode dryrun``.
# --------------------------------------------------------------------------- #
DRYRUN_PEAK_RATIO = 1.10
DRYRUN_CLI = (("gemma-7b", "train_4k", "pod"),
              ("yi-9b", "long_500k", "multipod"),
              ("mixtral-8x7b", "train_4k", "pod"),
              ("jamba-1.5-large-398b", "decode_32k", "multipod"),
              ("whisper-medium", "train_4k", "pod"))


def dryrun_cli():
    """``python -m repro_torch run --mode dryrun`` in five subprocesses
    started together, as a user types it: gemma-7b's train step on the 16
    x 16 mesh, yi-9b's 500k-token decode (B 1, replicated over the batch
    axes) on 2 x 16 x 16, mixtral-8x7b's train step on 16 x 16 (8 experts
    that 16 does not divide: each rank holds every expert's 896 hidden
    units), jamba-1.5-large's 32k decode step on 2 x 16 x 16 (the Mamba
    step on 1024 channels a rank, 16 experts, one a rank) and
    whisper-medium's train step on 16 x 16 (the enc-dec: its 1500-frame
    encoder stream whole, its decoder's split over ``model``). Each
    result must carry flops and a peak and no error; its roofline with
    the H100's constants is printed."""
    phase("dryrun: python -m repro_torch run --mode dryrun (fake worlds "
          "of 256 and 512 ranks, no card)")
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"  card total_memory {total} B ({total / 2**30:.2f} GiB); "
          f"analysis.HW hbm_cap {analysis.HW['hbm_cap']} B", flush=True)
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="repro_torch_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = []
    for arch, shape, mesh in DRYRUN_CLI:  # every process at once
        out_json = os.path.join(workdir, f"dryrun_{arch}_{shape}.json")
        cmd = [sys.executable, "-m", "repro_torch", "run", "--mode",
               "dryrun", "--arch", arch, "--mesh", mesh, "--set",
               f"dryrun.shape={shape}", "--set", f"dryrun.json_out={out_json}"]
        print(f"  $ PYTHONPATH=src python -m repro_torch run "
              f"{' '.join(cmd[4:])}", flush=True)
        runs.append((arch, shape, mesh, out_json, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    for arch, shape, mesh, out_json, proc in runs:
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"dryrun {arch} x {shape}: exit "
                                 f"{proc.returncode}\n{stdout[-2000:]}\n"
                                 f"{stderr[-4000:]}")
        print("\n".join(f"  | {ln}" for ln in stdout.splitlines()),
              flush=True)
        with open(out_json) as f:
            (r,) = json.load(f)
        if "error" in r or r["flops_per_device"] <= 0 or \
                r["peak_bytes_per_device"] <= 0:
            raise AssertionError(f"dryrun {arch} x {shape}: {r}")
        roof = analysis.roofline(get_config(arch), get_shape(shape), r,
                                 multi_pod=mesh == "multipod")
        print(f"  {arch} x {shape} on {roof['mesh']} ({r['devices']} ranks, "
              f"{r['mode']}; done at {wall:.1f} s, trace {r['trace_s']} s): "
              f"traced {r['flops_per_device']:.4e} FLOPs/dev, analytic "
              f"{roof['analytic_flops_per_device']:.4e}; collectives "
              f"{r['collective_bytes_per_device']} B; peak "
              f"{r['peak_bytes_per_device'] / 2**30:.2f} GiB; roofline "
              f"compute {roof['compute_s'] * 1e3:.3f} ms, memory "
              f"{roof['memory_s'] * 1e3:.3f} ms, collective "
              f"{roof['collective_s'] * 1e3:.3f} ms ({roof['dominant']}); "
              f"budget {roof['mem_budget_GiB']:.2f} GiB, fits_80GB "
              f"{roof['fits_80GB']}", flush=True)
    shutil.rmtree(workdir, ignore_errors=True)
    print(f"  dryrun phase wall {time.perf_counter() - t0:.1f} s",
          flush=True)


# --------------------------------------------------------------------------- #
# Phase 20: layers split over ``model``.
# --------------------------------------------------------------------------- #
# jamba's Mamba block of one rank of a 16-wide model axis: Di 16384 / 16
MAMBA_POD_RANK = (1, 2048, 1024, 16)


def scan_grid_blocks(Bt, Di, N):
    """The forward kernel's blocks: 128 threads, kLanes (4 at N <= 16,
    else 8) a channel (csrc/mamba_scan.cu ``launch``)."""
    return -(-Di // (128 // (4 if N <= 16 else 8))) * Bt


def check_mamba_pod_rank():
    """Rows 3-m and 3b-m: the mamba_scan forward with its boundary states
    every 16 steps and its backward at ``MAMBA_POD_RANK`` (bf16 u, B/C
    views), each rerun bitwise equal: y to one bf16 ulp beyond rtol 1e-4,
    atol 1e-5, h and the boundary states to rtol 1e-4, atol 1e-5
    (``MAMBA_CASES``' tolerances), the six gradients by
    ``hold_mamba_bwd`` (the backward's, as ``MAMBA_BWD_CASES``); then
    both timed beside their plain versions and bounds, with the grids'
    blocks on the card's SMs. Returns the two records (launches set by
    the caller)."""
    phase("dist-layers: mamba_scan forward and backward at jamba's block "
          "of one rank of model 16 (Bt 1, S 2048, Di 1024, N 16) vs plain")
    t0 = time.perf_counter()
    K, shape, u_dtype = mk.STATE_EVERY, MAMBA_POD_RANK, torch.bfloat16
    Bt, S, Di, N = shape
    args = mamba_inputs(120, *shape, u_dtype, True)
    before = mk.mamba_scan_cuda.launches
    got = mk.mamba_scan_cuda(*args, state_every=K)
    again = mk.mamba_scan_cuda(*args, state_every=K)
    torch.cuda.synchronize()
    if mk.mamba_scan_cuda.launches - before != 2:
        raise AssertionError("mamba_scan: not one launch a call")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("mamba_scan at the pod-rank block: a rerun "
                             "differs")
    y, h, hs = got
    want_y, want_h, want_hs = mk.mamba_scan_torch(*args, state_every=K)
    wy = want_y.float()
    diff = (y.float() - wy).abs()
    errs = {"y": diff.max().item(),
            "h": (h - want_h).abs().max().item(),
            "states": (hs - want_hs).abs().max().item()}
    ok = {"y": bool(torch.isfinite(y.float()).all() and (
              diff <= bf16_ulp(wy) + 1e-5 + 1e-4 * wy.abs()).all()),
          "h": torch.allclose(h, want_h, rtol=1e-4, atol=1e-5),
          "states": torch.allclose(hs, want_hs, rtol=1e-4, atol=1e-5)}
    failed = [f"forward {n}" for n, v in ok.items() if not v]
    print(f"  forward {shape} bf16 u, states every {K} "
          f"({tuple(hs.shape)}): max|kernel-plain| "
          + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + " (y: one bf16 ulp + rtol 1e-4, atol 1e-5; h, states: rtol "
          f"1e-4, atol 1e-5); rerun bitwise equal"
          f"{'; FAILS ' + str(failed) if failed else ''}", flush=True)
    fwd_err = max(errs.values())
    del again, want_y, want_h, want_hs, wy, diff, y, h

    gen = torch.Generator(device="cuda").manual_seed(121)
    dy = torch.randn((Bt, S, Di), generator=gen, device="cuda").to(u_dtype)
    dh = torch.randn((Bt, Di, N), generator=gen, device="cuda")
    before = mk.mamba_scan_bwd_cuda.launches
    grads = mk.mamba_scan_bwd_cuda(*args, hs, dy, dh, state_every=K)
    again = mk.mamba_scan_bwd_cuda(*args, hs, dy, dh, state_every=K)
    torch.cuda.synchronize()
    if mk.mamba_scan_bwd_cuda.launches - before != 2:
        raise AssertionError("mamba_scan_bwd: not one count a call")
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError("mamba_scan_bwd at the pod-rank block: a rerun "
                             "differs")
    want = mk.mamba_scan_bwd_torch(*args, hs, dy, dh, state_every=K)
    berrs, bad = hold_mamba_bwd(grads, want, u_dtype)
    failed += [f"backward {n}" for n in bad]
    print(f"  backward {shape} bf16 u, dh given, K {K}: max|kernel-plain| "
          + ", ".join(f"{n} {e:.2e} ({r:.1e})" for n, (e, r) in berrs.items())
          + f"; rerun bitwise equal{'; FAILS ' + str(bad) if bad else ''}",
          flush=True)
    bwd_err = max(e for e, _ in berrs.values())
    del grads, again, want
    if failed:
        raise AssertionError(f"mamba_scan at the pod-rank block != plain: "
                             f"{failed}")

    clock = sm_clock_hz()
    fwd_ms = time_ms(lambda: mk.mamba_scan_cuda(*args, state_every=K))
    fwd_plain = time_ms(lambda: mk.mamba_scan_torch(*args, state_every=K), 2)
    bwd_ms = time_ms(lambda: mk.mamba_scan_bwd_cuda(*args, hs, dy,
                                                    state_every=K))
    bwd_plain = time_ms(lambda: mk.mamba_scan_bwd_torch(
        *args, hs, dy, state_every=K), 2)
    fb, fe = mamba_work(*shape, u_dtype)
    fb += 4 * hs.numel()  # the boundary states written
    f_bound, f_by, f_tb, f_te = mamba_bound(fb, fe, clock)
    bb, be = mamba_bwd_work(*shape, u_dtype, K)
    b_bound, b_by, b_tb, b_te = mamba_bound(bb, be, clock)
    print(f"  timing (row 3-m) forward with states {fwd_ms:.4f} ms, plain "
          f"{fwd_plain:.2f} ms; bound {f_bound:.4f} ms ({f_by}: {fb} B = "
          f"{f_tb:.4f} ms, {fe} exponentials = {f_te:.4f} ms at "
          f"{clock / 1e9:.3f} GHz; {100 * f_bound / fwd_ms:.1f}% of it); "
          f"grid {scan_grid_blocks(Bt, Di, N)} blocks of 128 threads on "
          f"{N_SMS} SMs", flush=True)
    print(f"  timing (row 3b-m) backward {bwd_ms:.4f} ms, plain "
          f"{bwd_plain:.2f} ms; bound {b_bound:.4f} ms ({b_by}: {bb} B = "
          f"{b_tb:.4f} ms, {be} exponentials = {b_te:.4f} ms; "
          f"{100 * b_bound / bwd_ms:.1f}% of it); backward kernel: "
          f"{bwd_info_line(Di, N)}; library_ms null: no PyTorch call "
          f"computes a selective scan or its gradient", flush=True)
    del args, hs, dy, dh
    torch.cuda.empty_cache()
    print(f"  dist-layers kernels wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    common = dict(route="cuda",
                  source="src/repro_torch/kernels/csrc/mamba_scan.cu",
                  replaces="src/repro/kernels/mamba.py:58", library_ms=None)
    return (dict(name="mamba_scan_pod_rank", max_abs_err=fwd_err, ms=fwd_ms,
                 plain_ms=fwd_plain, bound_ms=f_bound, bound_by=f_by,
                 **common),
            dict(name="mamba_scan_bwd_pod_rank", max_abs_err=bwd_err,
                 ms=bwd_ms, plain_ms=bwd_plain, bound_ms=b_bound,
                 bound_by=b_by, **common))


def dist_layers(params=None, want=None):
    """Phase 20: rows 3-m and 3b-m (``check_mamba_pod_rank``), then the
    3-layer jamba cut (``params``: phase 4's weights, made here when
    None) serves phase 4's workload through ``Engine(..., rules=
    Rules(mesh, "tp2d"))`` on a 1 x 1 NCCL mesh, destroyed in a
    ``finally``: with one rank every collective is a copy, so the greedy
    tokens must be bitwise the one-device engine's (``want``, phase 4's;
    run here when None), with the mamba_scan counter, zeroed just
    before, at 2 launches a prefill (its two Mamba layers). Returns the
    records of rows 3-m (launches: this run's) and 3b-m."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import Rules

    fwd, bwd = check_mamba_pod_rank()
    cfg = jamba_cut()
    phase("dist-layers: jamba-1.5-large 3-layer cut, bf16, slab, through "
          "Engine(rules=Rules(mesh, 'tp2d')) on a 1 x 1 NCCL mesh")
    t0 = time.perf_counter()
    if params is None:
        params = jamba_params()
    scfg = jamba_scfg()
    if want is None:
        one = Engine(cfg, params, scfg, device="cuda")
        want = tokens_of(run_offline(one, jamba_workload(cfg)))
        del one
    mesh = single_device_mesh("cuda")
    try:
        engine = Engine(cfg, params, scfg, rules=Rules(mesh, "tp2d"))
        run_offline(engine, synthetic_requests(cfg, n=2, tokens=2,
                                               prompt_len=8, seed=1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mk.reset_launches()
        report = run_offline(engine, jamba_workload(cfg))
        launches = mk.mamba_scan_cuda.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        del engine
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    n_mamba = sum(sp.mixer == "mamba" for sp in cfg.block_pattern)
    prefills = len(want)
    print(f"  tp2d on {mesh.shape}: {report.format()}; mamba_scan launches "
          f"{launches} (expected {n_mamba} x {prefills} prefills); peak "
          f"memory {peak:.2f} GiB", flush=True)
    if launches != n_mamba * prefills:
        raise AssertionError(f"dist-layers: mamba_scan launches {launches}")
    if tokens_of(report) != want:
        raise AssertionError("dist-layers: tp2d's greedy tokens differ from "
                             "the one-device engine's")
    print(f"  greedy tokens bitwise the one-device engine's; dist-layers "
          f"serve wall {time.perf_counter() - t0:.1f} s", flush=True)
    fwd["launches"] = launches
    return fwd, bwd


# --------------------------------------------------------------------------- #
# Phase 16: sharded serving on a 1 x 1 NCCL mesh; phase 17: the fleet.
# --------------------------------------------------------------------------- #
SERVE_MODES = ("tp2d", "fsdp")
FLEET_REPLICAS, FLEET_CHAOS_STEP, FLEET_STALL, FLEET_TIMEOUT = 2, 8, 12, 4
# The paged split kernels, one a wrapper call (the merge follows each).
PAGED_SPLITS = ("paged_split_mma_kernel", "paged_split_f32_kernel")


def paged_site_record(name, seed, label, page=16, **shape):
    """The paged kernel at a call site's shape (bf16 pool and q, gemma's
    16/16 heads of 256, ``page`` tokens a page) held against its plain
    version, rerun bitwise, and timed beside its bound and SDPA on the
    gathered K/V, as row 1 is."""
    case = paged_case(seed, dtype=torch.bfloat16, H=16, K=16, D=256,
                      page=page, **shape)
    err = hold_paged(case, None, label, TOL[torch.bfloat16])
    nbytes, flops = work(case, None)
    b_ms, by = bound(flops, nbytes, torch.bfloat16)
    qs, ks, vs, mask = sdpa_inputs(case, None)
    rec = dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:186",
        max_abs_err=err,
        ms=time_ms(lambda: pa.paged_attention_cuda(**case)),
        plain_ms=time_ms(lambda: pa.paged_attention_torch(**case)),
        bound_ms=b_ms, bound_by=by,
        library_ms=time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask)))
    print(f"  {label}: B{shape['B']} C{shape['C']} H16 D256 page{page} bf16: "
          f"max|kernel-plain| {err:.3e}, rerun bitwise equal; kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, sdpa "
          f"{rec['library_ms']:.4f} ms (K/V gathered beforehand), "
          f"kernel/sdpa {rec['ms'] / rec['library_ms']:.3f}, bound "
          f"{b_ms:.4f} ms ({by}: {nbytes} B, {flops} flop)", flush=True)
    del case, qs, ks, vs, mask
    torch.cuda.empty_cache()
    return rec


def paged_splits(kernels):
    """Paged kernel calls in a profiler trace (its split launches)."""
    return sum(e.count for e in kernels if kernel_name(e.key) in PAGED_SPLITS)


def serve_mode_run(engine, cfg, workload, trace=True):
    """Stream (a) through ``engine`` after a warm-up: the paged counter,
    zeroed just before, read just after; then a second run, traced
    (``trace``: the profiler's count of paged calls and the busy share;
    reading a trace of the stream's ~120,000 kernels takes ~20 s)."""
    t0 = time.perf_counter()
    run_offline(engine, synthetic_requests(cfg, n=2, tokens=2, prompt_len=8,
                                           seed=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launches()
    t1 = time.perf_counter()
    report = run_offline(engine, workload())
    launches = pa.paged_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    t2 = time.perf_counter()
    if trace:
        again, busy, kernels = trace_busy(lambda: run_offline(engine,
                                                              workload()))
        traced = paged_splits(kernels)
    else:
        again, busy, traced = run_offline(engine, workload()), None, None
    print(f"  (warm-up {t1 - t0:.1f} s, run {t2 - t1:.1f} s, second run"
          f"{' traced, and its reading' if trace else ''} "
          f"{time.perf_counter() - t2:.1f} s)", flush=True)
    return dict(report=report, launches=launches, peak=peak, busy_ms=busy,
                traced=traced, again=again)


def serve_tp2d(params):
    """Full-width gemma-7b serves stream (a) on one device, then through
    ``Engine(rules=Rules(mesh, mode))`` in ``tp2d`` and in ``fsdp`` on a
    1 x 1 NCCL mesh (destroyed in a ``finally``). With one rank every
    collective is a copy and the programs run the one-device arithmetic,
    so the greedy tokens must be bitwise the one-device engine's, with
    the same paged launches (the counter; on one device and in tp2d also
    the profiler's count of split launches, from a traced second run, at
    most the counter and within 1% of it: the profiler can lose records of
    a ~120,000-kernel trace). Returns the record of row 1-m."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import Rules

    phase("serve-tp2d: gemma-7b full width, 28 layers, bf16, stream (a): "
          "one device, then tp2d and fsdp on a 1 x 1 NCCL mesh")
    t0 = time.perf_counter()
    cfg = get_config("gemma-7b")
    scfg = ServeConfig(max_batch=8, max_len=max(PROMPT_LENS) + NEW_TOKENS,
                       page_size=16, prefill_chunk=8)

    def workload():
        return synthetic_requests(cfg, n=8, tokens=NEW_TOKENS,
                                  prompt_len=max(PROMPT_LENS), seed=0,
                                  prompt_lens=PROMPT_LENS)

    one = Engine(cfg, params, scfg, device="cuda")
    runs = {"one device": serve_mode_run(one, cfg, workload)}
    mesh = single_device_mesh("cuda")
    try:
        print(f"  mesh {mesh.shape} over {dist.get_world_size()} rank(s), "
              f"backend {dist.get_backend()}", flush=True)
        for mode in SERVE_MODES:
            engine = Engine(cfg, params, scfg, rules=Rules(mesh, mode))
            runs[mode] = serve_mode_run(engine, cfg, workload,
                                        trace=mode == "tp2d")
            del engine
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    # the one-device engine again, after the mesh runs (its tokens/s
    # beside the first run's: what the card's host drifts by)
    again = run_offline(one, workload())
    print(f"  one device, run again after the mesh runs: {again.format()}",
          flush=True)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    base = runs["one device"]
    want = tokens_of(base["report"])
    steps = len(base["report"].steps)
    summary = {}
    for name, r in runs.items():
        rep, ms = r["report"], r["report"].elapsed_s * 1e3
        busy = (f"(profiler, traced run: {r['traced']}); device busy "
                f"{r['busy_ms']:.1f} ms = {100 * r['busy_ms'] / ms:.1f}% of "
                f"the untraced run's {ms:.1f} ms" if r["traced"] is not None
                else "(second run untraced)")
        print(f"  {name}: {rep.format()}; paged_attention launches "
              f"{r['launches']} {busy}; peak memory {r['peak']:.2f} GiB",
              flush=True)
        summary[name] = dict(tokens_per_s=rep.tokens_per_s,
                             launches=r["launches"], traced=r["traced"],
                             busy_share=(None if r["busy_ms"] is None
                                         else r["busy_ms"] / ms),
                             peak_gib=r["peak"])
        if tokens_of(rep) != want or tokens_of(r["again"]) != want or \
                tokens_of(again) != want:
            raise AssertionError(f"serve-tp2d: {name}'s greedy tokens differ "
                                 f"from the one-device engine's")
        # the counter is exact; the profiler may lose a few of a long
        # trace's records (run 1 of this phase: 1314 of 1316), but a path
        # that left the kernel would show far fewer
        if r["launches"] != cfg.n_layers * steps or (
                r["traced"] is not None and not
                0.99 * r["launches"] <= r["traced"] <= r["launches"]):
            raise AssertionError(
                f"serve-tp2d: {name}: paged launches {r['launches']} "
                f"(profiler {r['traced']}); expected {cfg.n_layers} x "
                f"{steps}")
    print(f"  greedy tokens bitwise equal on every path, {steps} chunk "
          f"steps each; serve-tp2d summary {json.dumps(summary)}",
          flush=True)
    rec = paged_site_record("paged_attention_tp2d", 310, "row 1-m (tp2d, "
                            "one rank's 16/16 heads)", B=8, C=8, npg=10,
                            lens=[160, 5, 37, 128, 64, 99, 16, 0],
                            nvs=[1, 5, 8, 1, 8, 3, 1, 1])
    rec["launches"] = runs["tp2d"]["launches"]
    print(f"  serve-tp2d phase wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rec


def serve_fleet(params):
    """Two replicas of full-width gemma-7b on the one card, one params
    tree between them, serve stream (b) (2 templates of 96 tokens + 32-
    token suffixes at 0.5 a step, prefix cache, n-gram drafts of 3)
    behind the prefix router: without chaos, with a seeded kill at fleet
    step 8, and with a stall of 12 steps (heartbeat timeout 4); then
    least-loaded, which spreads the requests over both replicas. In every
    run every request id finishes exactly once, with a one-engine run's
    greedy tokens, and the paged counter, zeroed just before, shows one
    launch a layer of every replica's chunk step. Returns the record of
    the fleet's row."""
    from repro_torch.fleet import ChaosPlan, Fleet, FleetConfig

    phase(f"serve-fleet: gemma-7b full width, {FLEET_REPLICAS} replicas on "
          f"one card, stream (b), prefix routing; no chaos, kill at step "
          f"{FLEET_CHAOS_STEP}, stall of {FLEET_STALL} (timeout "
          f"{FLEET_TIMEOUT}); least-loaded routing")
    t0 = time.perf_counter()
    cfg = get_config("gemma-7b")
    scfg = ServeConfig(max_batch=8, max_len=SHARED + SUFFIX + NEW_TOKENS,
                       page_size=16, prefill_chunk=8, prefix_cache=True,
                       spec_decode="ngram", draft_len=3)

    def workload():
        return synthetic_requests(
            cfg, n=8, tokens=NEW_TOKENS, prompt_len=SHARED + SUFFIX,
            scenario="server", seed=0, arrival_rate=RATE,
            shared_prefix_len=SHARED, n_templates=2)

    engines = [Engine(cfg, params, scfg, device="cuda")
               for _ in range(FLEET_REPLICAS)]
    for e in engines:  # warm-up
        run_offline(e, synthetic_requests(cfg, n=2, tokens=2, prompt_len=8,
                                          seed=1))
    one = Fleet(engines[:1]).run(workload())
    want = tokens_of(one.merged)
    print(f"  one engine: {one.format()}", flush=True)
    summary, launches = {}, 0
    for routing, chaos in (("prefix", ""), ("prefix", "kill"),
                           ("prefix", "stall"), ("least_loaded", "")):
        plan = ChaosPlan.from_spec(chaos, chaos_step=FLEET_CHAOS_STEP,
                                   stall_steps=FLEET_STALL, seed=0)
        reqs = workload()
        pa.reset_launches()
        report = Fleet(engines, FleetConfig(
            routing=routing, heartbeat_timeout=FLEET_TIMEOUT), plan).run(reqs)
        n = pa.paged_attention_cuda.launches
        steps = sum(len(r.steps) for r in report.replica_reports.values())
        dead = sorted(i for i, s in report.replica_states.items()
                      if s == "dead")
        served = {i: len(r.requests) for i, r in
                  report.replica_reports.items()}
        name = chaos or ("none" if routing == "prefix" else routing)
        s = report.summary()
        s.update(evicted=dead, launches=n, chunk_steps=steps, served=served)
        summary[name] = s
        print(f"  {name}: {report.format()}; tokens/s "
              f"{report.tokens_per_s:.2f}, kills {report.kills}, evicted "
              f"{dead}, lost tokens {report.lost_tokens}, requests served a "
              f"replica {served}, paged_attention launches {n} over {steps} "
              f"replica chunk steps", flush=True)
        ids = sorted(r.id for r in report.merged.requests)
        if ids != sorted(r.id for r in reqs):
            raise AssertionError(f"serve-fleet {name}: request ids {ids}")
        if tokens_of(report.merged) != want:
            raise AssertionError(f"serve-fleet {name}: greedy tokens differ "
                                 f"from one engine's")
        if n != cfg.n_layers * steps or steps == 0:
            raise AssertionError(f"serve-fleet {name}: paged launches {n}; "
                                 f"expected {cfg.n_layers} x {steps}")
        if (report.kills, len(dead)) != ((1, 1) if chaos else (0, 0)):
            raise AssertionError(f"serve-fleet {name}: kills {report.kills}, "
                                 f"dead {dead}")
        if name == "none":
            launches = n
    print(f"  every id once, one engine's tokens in every run; serve-fleet "
          f"summary {json.dumps(summary)}", flush=True)
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    rec = paged_site_record("paged_attention_fleet", 320, "fleet row (one "
                            "replica's chunk, stream (b))", B=8, C=8, npg=10,
                            lens=[160, 136, 128, 104, 96, 150, 129, 0],
                            nvs=[1, 4, 8, 1, 8, 1, 2, 1])
    rec["launches"] = launches
    print(f"  serve-fleet phase wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rec


# --------------------------------------------------------------------------- #
# Phase 18: the run layer, ``python -m repro_torch run``, in subprocesses.
# --------------------------------------------------------------------------- #
RUN_CLI_TRAIN = ("--spec", "runs/gemma_7b_train.json", "--full",
                 "--set", "model.n_layers=8", "--set", "trainer.batch=4",
                 "--set", "trainer.seq=2048", "--set", "trainer.total_steps=3",
                 "--set", "trainer.eval_every=3")


def run_cli(args, workdir, tag, trace=False):
    """``python -m repro_torch run ARGS --profile FILE [--trace]`` from
    the root of the checkout, as a user types it (``PYTHONPATH=src``);
    its stdout, the profile's JSON and its wall seconds. A non-zero exit
    raises."""
    prof = os.path.join(workdir, f"{tag}.json")
    cmd = [sys.executable, "-m", "repro_torch", "run", *args, "--profile",
           prof] + ["--trace"] * trace
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    print(f"  $ PYTHONPATH=src python -m repro_torch run "
          f"{' '.join(cmd[4:])}", flush=True)
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"run-cli {tag}: exit {out.returncode}\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    lines = [ln for ln in out.stdout.splitlines()
             if not ln.startswith("USDT")]  # the profiler's own lines
    print("\n".join(f"  | {ln}" for ln in lines[:3]), flush=True)
    with open(prof) as f:
        return out.stdout, json.load(f), wall


def cli_tokens(stdout):
    """{request id: tokens} from the CLI's ``  req N: ...`` lines."""
    out = {}
    for ln in stdout.splitlines():
        if ln.startswith("  req "):
            rid = int(ln.split(":")[0].split()[1])
            if rid in out:
                raise AssertionError(f"run-cli: request {rid} printed twice")
            out[rid] = json.loads(ln[ln.index("["):])
    return out


def in_order(tokens):
    return [tokens[k] for k in sorted(tokens)]


def engine_tokens(spec, cfg, params):
    """The spec's workload through an in-process one-device ``Engine``
    on ``params``, warmed up as the dispatcher warms its engine."""
    from repro_torch.serve.scenarios import scenario_driver

    engine = Engine(cfg, params, run_dispatch.serve_config(spec, cfg),
                    device="cuda")
    run_offline(engine, synthetic_requests(
        cfg, n=min(2, engine.scfg.max_batch), tokens=2,
        prompt_len=spec.serve.prompt_len, seed=spec.seed + 1))
    report = scenario_driver(spec.scenario)(
        engine, run_dispatch.serve_trace(spec, cfg))
    del engine
    return in_order({r.id: list(r.tokens) for r in report.requests})


def run_cli_paged(spec_file, params, workdir, trace):
    """One serve spec through the CLI at full width: its paged launches
    (the counter exactly 28 a chunk step; with ``trace`` the profiler's
    split count within 1% of it), every id once, tokens against an
    in-process engine. Returns (stdout, profile, wall s, the spec)."""
    spec = apply_assignments(load_spec_file(os.path.join(ROOT, spec_file)),
                             ["reduced=false"])
    cfg = run_dispatch.resolve_config(spec)
    tag = os.path.splitext(os.path.basename(spec_file))[0]
    stdout, prof, wall = run_cli(["--spec", spec_file, "--full"], workdir,
                                 tag, trace)
    n, steps = prof["launches"]["paged_attention"], prof["chunk_steps"]
    traced = n
    busy = "untraced"
    if trace:
        traced = sum(k["count"] for k in prof["kernels"]
                     if kernel_name(k["name"]) in PAGED_SPLITS)
        busy = (f"profiler {traced}; device busy {prof['busy_ms']:.1f} ms = "
                f"{100 * prof['busy_ms'] / prof['wall_ms']:.1f}% of the "
                f"traced run")
    toks = cli_tokens(stdout)
    s = prof["summary"]
    print(f"  {tag}: {len(toks)} requests, chunk steps {steps}, "
          f"paged_attention launches {n} (bf16 "
          f"{prof['launches']['paged_attention_by_kind']['bfloat16']}; "
          f"{busy}), measured run {prof['wall_ms']:.1f} ms, tokens/s "
          f"{s['tokens_per_s']}, command wall {wall:.1f} s", flush=True)
    if n != cfg.n_layers * steps or steps == 0 or \
            prof["launches"]["paged_attention_by_kind"]["bfloat16"] != n:
        raise AssertionError(f"run-cli {tag}: paged launches "
                             f"{prof['launches']}; expected {cfg.n_layers} "
                             f"bf16 launches x {steps} chunk steps")
    if not 0.99 * n <= traced <= n:
        raise AssertionError(f"run-cli {tag}: the profiler saw {traced} "
                             f"paged calls of {n}")
    if len(toks) != spec.serve.batch or any(
            len(t) != spec.serve.tokens or not all(0 <= x < cfg.vocab
                                                   for x in t)
            for t in toks.values()):
        raise AssertionError(f"run-cli {tag}: requests {toks}")
    want = engine_tokens(spec, cfg, params)
    if in_order(toks) != want:
        raise AssertionError(f"run-cli {tag}: the CLI's greedy tokens "
                             f"differ from an in-process engine's")
    print(f"  {tag}: every id once, greedy tokens equal an in-process "
          f"one-device engine's on the same spec and seed", flush=True)
    return stdout, prof, wall, spec


def run_cli_serve(params):
    """Phase 18a: ``runs/serve_prefix.toml`` (tp2d on the 1 x 1 NCCL
    mesh, prefix cache, page 4) and ``runs/serve_fleet.toml`` (two
    replicas, a kill at fleet step 6) through the CLI at gemma-7b's full
    width, then one ``--mode dryrun`` render of the fleet's manifests.
    Returns the paged record of the call site."""
    import shutil
    import tempfile

    phase("run-cli: python -m repro_torch run --full, gemma-7b 28 layers: "
          "runs/serve_prefix.toml, runs/serve_fleet.toml, a k8s render")
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="run_cli_")
    try:
        _, prof, _, spec = run_cli_paged("runs/serve_prefix.toml", params,
                                         workdir, trace=True)
        launches = prof["launches"]["paged_attention"]
        stdout, fprof, _, _ = run_cli_paged("runs/serve_fleet.toml", params,
                                            workdir, trace=False)
        if fprof["summary"]["kills"] != 1:
            raise AssertionError(f"run-cli fleet: {fprof['summary']}")
        print("  serve_fleet: " + next(
            ln for ln in stdout.splitlines() if ln.startswith("gemma-7b [")),
            flush=True)
        yaml = subprocess.run(
            [sys.executable, "-m", "repro_torch", "run", "--spec",
             "runs/serve_fleet.toml", "--mode", "dryrun"], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            capture_output=True, text=True, timeout=300, check=True).stdout
        if yaml.count("\n---\n") != 2 or "nvidia.com/gpu: 1" not in yaml \
                or '- "repro_torch"' not in yaml or "replicas: 2" not in yaml:
            raise AssertionError(f"run-cli render:\n{yaml}")
        print(f"  dryrun render: 3 manifests, {len(yaml)} B, replicas 2, "
              f"nvidia.com/gpu 1", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    n_pages = -(-(spec.serve.prompt_len + spec.serve.tokens)
                // spec.serve.kv.page_size)
    rec = paged_site_record("paged_attention_run_cli", 330, "run-cli row "
                            "(serve_prefix's chunk: 3 slots, chunk 4, page "
                            "4)", page=spec.serve.kv.page_size, B=3, C=4,
                            npg=n_pages, lens=[22, 13, 0], nvs=[1, 4, 1])
    rec["launches"] = launches
    print(f"  run-cli serve wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rec


def run_cli_train():
    """Phase 18b: ``runs/gemma_7b_train.json --full`` cut to 8 layers,
    batch 4 x 2048, 3 steps and an eval, through the CLI: the flash
    forward and backward launch as the step and the eval sweep need,
    the losses are finite and bitwise those of an in-process Trainer on
    the same spec and seed. Returns the (forward, backward) launches."""
    import shutil
    import tempfile

    phase("run-cli: python -m repro_torch run " + " ".join(RUN_CLI_TRAIN))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spec = load_spec_file(os.path.join(ROOT, RUN_CLI_TRAIN[1]))
    spec = apply_assignments(spec, ["reduced=false"] + list(
        RUN_CLI_TRAIN[4::2]))
    cfg = run_dispatch.resolve_config(spec)
    t = spec.trainer
    workdir = tempfile.mkdtemp(prefix="run_cli_")
    try:
        metrics = os.path.join(workdir, "metrics.jsonl")
        stdout, prof, wall = run_cli(
            list(RUN_CLI_TRAIN) + ["--metrics-out", metrics], workdir,
            "train")
        with open(metrics) as f:
            records = [json.loads(ln) for ln in f]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    losses = [r["loss"] for r in records]
    eval_fn = synthetic_eval_set(cfg, batch=t.batch, seq=t.seq)
    n_eval = sum(1 for _ in eval_fn())
    want = (2 * cfg.n_layers * t.total_steps + cfg.n_layers * n_eval,
            cfg.n_layers * t.total_steps)
    got = (prof["launches"]["flash_attention_fwd"],
           prof["launches"]["flash_attention_bwd"])
    step_ms = [r["step_ms"] for r in records]
    print(f"  {len(records)} steps: losses {losses}; eval_nll "
          f"{records[-1].get('eval_nll')}; step ms "
          f"{[round(m, 1) for m in step_ms]}; flash launches forward "
          f"{got[0]}, backward {got[1]} (expected {want[0]}, {want[1]}); "
          f"fit {prof['wall_ms']:.1f} ms; command wall {wall:.1f} s",
          flush=True)
    if got != want:
        raise AssertionError(f"run-cli train: flash launches {got} != {want}")
    if len(losses) != t.total_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"run-cli train: losses {losses}")
    tr = Trainer(cfg, TrainerConfig(
        total_steps=t.total_steps, eval_every=t.eval_every,
        log_every=0, seed=spec.seed, metrics=t.metrics), device="cuda")
    hist = tr.fit(synthetic_lm_batches(cfg, batch=t.batch, seq=t.seq,
                                       steps=t.total_steps, seed=spec.seed),
                  eval_fn)
    mine = [r["loss"] for r in hist]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    if mine != losses or hist[-1].get("eval_nll") != \
            records[-1].get("eval_nll"):
        raise AssertionError(f"run-cli train: the CLI's losses {losses} "
                             f"differ from an in-process Trainer's {mine}")
    print("  losses and eval_nll bitwise those of an in-process Trainer",
          flush=True)
    print(f"  run-cli train wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    return got


PHASES = {  # --only names: the phases a short run may pick
    "paged": lambda: (check_kernel(), check_paged_archs()),
    "flash": lambda: (check_flash(), check_flash_archs()),
    "lstm": check_lstm,
    "lars": check_lars,
    "mamba": lambda: (check_mamba(), check_mamba_train()),
    "flash-jamba": check_flash_jamba,
    "check-jamba": lambda: (reduced_jamba_vs_cpu(),
                            reduced_jamba_train_vs_cpu()),
    "serve-jamba": serve_jamba_full, "train-jamba": train_jamba,
    "dist-layers": dist_layers,
    "train-gnmt": train_gnmt_full,
    "train-resnet": train_resnet_full,
    "serve-sample": lambda: serve_sample(full_serve_params()),
    "train-resume": train_resume,
    "serve-archs": serve_archs, "train-archs": train_archs,
    "kernels-whisper": check_whisper_kernels,
    "check-whisper": reduced_whisper_vs_cpu,
    "serve-whisper": serve_whisper, "train-whisper": train_whisper,
    "dist-whisper": dist_whisper,
    "kernels-vlm": check_vlm_kernels,
    "check-vlm": lambda: reduced_slab_vs_cpu(VLM, 3),
    "check-rwkv": lambda: reduced_slab_vs_cpu(RWKV, 4),
    "serve-vlm": lambda: serve_slab_full(VLM),
    "serve-rwkv": lambda: serve_slab_full(RWKV),
    "train-vlm": lambda: train_cut(VLM, VLM_TRAIN_LAYERS),
    "train-rwkv": lambda: train_cut(RWKV, RWKV_TRAIN_LAYERS, again=1),
    "kernels-transformer": check_transformer_kernels,
    "check-mlperf": reduced_mlperf_vs_cpu,
    "train-transformer": train_transformer,
    "train-ssd": lambda: train_mlperf_full("ssd", SSD_BATCH),
    "train-maskrcnn": lambda: train_mlperf_full("maskrcnn", MASKRCNN_BATCH),
    "dist": dist_phase,
    "dist-train": dist_train,
    "serve-tp2d": lambda: serve_tp2d(full_serve_params()),
    "serve-fleet": lambda: serve_fleet(full_serve_params()),
    "run-cli": lambda: (run_cli_serve(full_serve_params()), run_cli_train()),
    "dryrun": dryrun_cli,
}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run after the build "
                         f"({', '.join(PHASES)}); prints no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    phase("card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 checks in full fp32
    t0 = time.perf_counter()
    reports = build.build()
    for name, log in reports.items():
        for line in log.splitlines():
            if any(w in line for w in ("properties for", "registers",
                                       "spill", "warning")):
                print(f"  {name}: {line.strip()}")
    print(f"  built {sorted(build.sources())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.only:
        for name in args.only.split(","):
            PHASES[name]()
        print(smi)
        print(f"  wall {time.perf_counter() - t0:.1f} s", flush=True)
        return 0

    paged, int8, int4 = check_kernel()
    paged_archs = check_paged_archs()
    flash_fwd, flash_bwd = check_flash()
    flash_archs = check_flash_archs()
    lstm_fwd, lstm_bwd = check_lstm()
    lars_norms, lars_update = check_lars()
    mamba = check_mamba()
    mamba_train, mamba_bwd = check_mamba_train()
    flash_jamba, flash_jamba_fwd, flash_jamba_bwd = check_flash_jamba()
    reduced_vs_cpu()
    reduced_quant_vs_cpu()
    reduced_jamba_vs_cpu()
    reduced_jamba_train_vs_cpu()
    reduced_train_vs_cpu()
    reduced_gnmt_vs_cpu()
    reduced_resnet_vs_cpu()
    phase("serve: full-width gemma-7b weights")
    params = full_serve_params()
    paged["launches"] = serve_full(params)
    int8["launches"], int4["launches"] = serve_quant(params)
    serve_sample(params)
    serve_recs = [serve_tp2d(params), serve_fleet(params),
                  run_cli_serve(params)]
    del params
    torch.cuda.empty_cache()
    jamba_weights = jamba_params()
    mamba["launches"], flash_jamba["launches"], jamba_tokens = \
        serve_jamba_full(jamba_weights)
    mamba_rank, mamba_rank_bwd = dist_layers(jamba_weights, jamba_tokens)
    del jamba_weights
    flash_fwd["launches"], flash_bwd["launches"] = train_full()
    train_resume()
    lstm_fwd["launches"], lstm_bwd["launches"] = train_gnmt_full()
    lars_norms["launches"], lars_update["launches"] = train_resnet_full()
    for arch, n in serve_archs().items():
        paged_archs[arch]["launches"] = n
    for arch, (fwd, bwd) in train_archs().items():
        if arch in flash_archs:
            flash_archs[arch][0]["launches"] = fwd
            flash_archs[arch][1]["launches"] = bwd
    (mamba_train["launches"], mamba_bwd["launches"],
     flash_jamba_fwd["launches"], flash_jamba_bwd["launches"]) = train_jamba()
    # the backward kernel at the pod-rank block runs on no one-card path:
    # its launches are the kernel's on the path that runs it (train-jamba)
    mamba_rank_bwd["launches"] = mamba_bwd["launches"]
    whisper = whisper_phases()
    vlm = vlm_rwkv_phases()
    mlperf = mlperf_phases()
    dist_recs = dist_phase()
    dist_train()
    dryrun_cli()
    # the flash kernels at the dispatcher's train shape, B 4, S 2048, 16
    # heads of 256: the shape phase 2 timed (rows 2f/2b)
    cli_fwd, cli_bwd = run_cli_train()
    run_cli_recs = [
        dict(flash_fwd, name="flash_attention_fwd_run_cli", launches=cli_fwd),
        dict(flash_bwd, name="flash_attention_bwd_run_cli", launches=cli_bwd)]
    recs = [paged, int8, int4, flash_fwd, flash_bwd, flash_jamba, mamba,
            mamba_train, mamba_bwd, lstm_fwd, lstm_bwd, lars_norms,
            lars_update, *paged_archs.values(),
            *(r for pair in flash_archs.values() for r in pair),
            flash_jamba_fwd, flash_jamba_bwd, *whisper, *vlm, *mlperf,
            *dist_recs, *serve_recs, *run_cli_recs, mamba_rank,
            mamba_rank_bwd]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"  whole smoke wall {time.perf_counter() - t0:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
