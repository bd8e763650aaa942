#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is then non-zero and the last
line is not printed):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. the build: every CUDA source of ``src/repro_torch/kernels/csrc`` compiled
   in parallel into ``build/torch_kernels/`` (seconds, registers, spills),
   the chunk ``KC`` of the limb matmuls' tensor-core order, the chunk ``C``
   (table columns) of the paged attention kernels and flash attention's
   query rows per block at the serving shapes;
3. each kernel against its plain PyTorch version on the card, at the serving
   path's shapes and formats plus M23/M36 (and more) for the matmul kernels;
   the decompose kernel bitwise, the pre-limbed matmul bitwise against the
   fused matmul on the raw weight, the fused projection's outputs without
   an epilogue bitwise the fused matmul with each weight, each decode case
   (M <= 16 rows: the decode tile) of the fused, pre-limbed and mixed-lane
   matmuls and of the fused projection bitwise against the same rows of an
   M = 70 launch (the prefill tile; the mixed kernel's extra rows at
   PAD_LANE), each row (slot) of the two mixed-lane kernels bitwise
   against the homogeneous kernel at its own format, each slot of the two
   paged kernels bitwise the same slot launched alone (B = 1, the table cut
   to its own width), paged cases at the chunk's edges, with the largest
   logit in a slot's first, last or every column and with a table far
   wider than the slots, each head of each flash case bitwise the same
   head launched alone (B = H = 1), a flash case with rows' largest logits
   in the last column of a kv tile, flash at ``[arch]``'s head dims 192
   (MLA), 80 and 96, and each prefill case within
   tests/test_kernels.py's error model of its float64 golden; on every
   2-D matmul case the fused kernel's partials epilogue (each order's
   plane against its plain version, ``combine_partials`` of the stack
   bitwise the fused kernel, decode rows bitwise an M = 70 launch's), and
   two timed partials cases at ``[dist]``'s K-sharded prefill shapes;
3b. ``[modes]``: the paper's six modes through ``repro_torch.mp`` (the
   quickstart's surface): every built-in format and a run-time M30 on f32
   operands at the model's prefill shapes, M36 / M52 on two-float (DD)
   operands at the same shapes and M52 once at the ``lm_head`` shape, AUTO
   on integer and on float data; launch counts and host reads exact, the
   five DD launches on the both-prelimbed TMA tile (5 ``tma`` + 0
   ``mma``); the both-prelimbed kernel against its plain version (a ragged
   200x333x77 DD stack no tensor map reads on ``mma`` too), bitwise the
   fused kernel on limb stacks cut from f32 operands, the DD results below
   ``8 * 2^-24 * sqrt(K)`` of the float64 golden, AUTO on integers M8 and
   exact;
4. the static path: ``ServeEngine.generate`` of the full-width
   ``paper-mpfp-100m`` (random weights from seed 0, raw decode weights) on 8
   prompts of 64..256 tokens, 32 new tokens each, under ``serve_default``;
   launch counts must be what the config implies, and the prefill logits
   must agree with the same engine on the ``ref`` backend;
4b. the scheduler path: ``ContinuousScheduler`` over a pre-limbed engine
   (8 slots, a 160-block pool of 16 positions) serving 16 requests of
   64..256 prompt tokens and 32 new tokens, arriving two ticks apart; launch
   counts must be what the scheduler's own counters imply, two streams must
   equal their solo runs bit for bit, and one paged prefill's logits must
   agree with the ``ref`` backend; then a decode-only tick probe;
4c. mixed traffic: a fresh pre-limbed engine under the same scheduler
   serving the same 16 requests with modes M8 / M16 / M23 / a custom 2-limb
   format in turn; one decode launch per tick, the mixed-lane and
   homogeneous kernels' launches what the counts of mixed and bucket decode
   launches imply, two requests of different modes equal to their solo runs
   bit for bit; then a mixed decode-tick probe (8 slots, two per mode) timed
   against the one-launch-per-policy plan on the same slots, tokens equal;
4d. ``[auto]``: ``ServeEngine.generate`` under ``PrecisionPolicy.auto()``
   (paper mode 1 on every matmul but ``lm_head``) on 4 prompts of 64..256
   tokens, 16 new tokens each: launches and host reads exact, the
   selections counted, prefill and decode step timed, device busy from the
   profiler, prefill logits against the ``ref`` backend;
4e. ``[auto-sched]``: 12 requests at M8 / M16 / M23 / AUTO in turn through
   the scheduler: two decode launches on every tick where static-format and
   AUTO requests are both live (one mixed launch, one AUTO bucket), launch
   counts exact, the AUTO requests' tokens equal to their solo AUTO
   ``generate`` bit for bit;
4f. ``[train]``: ``Trainer.run`` of the full-width ``paper-mpfp-100m``
   (params from seed 0) for 5 steps of batch 8 x 128 under
   ``train_default`` with remat, a checkpoint under ``chiprun_out/`` (it
   must restore the state bitwise; then it is removed): launches per step
   exactly ``train_launches``, no plain-version call, losses and
   parameters finite; step 1's loss and every gradient leaf against the
   ``ref`` backend on the card (1e-5 relative; 5e-4 of the leaf's max),
   remat off giving remat's bits, one step taken twice giving the same
   bits; step ms on the host clock, busy ms from the profiler, the idle
   share, tokens/s, peak memory; each weight gradient's plain product
   (``ref.mp_wgrad_ref``) timed beside ``fused_matmul_kernel`` on the same
   contraction.  Phase 3 holds the kernels at the step's shapes: dgrad
   through a transposed weight view bitwise the launch on a contiguous
   copy (both timed), the attention backward's batched products with each
   entry bitwise launched alone, the projections with gate "none" at 1024
   rows, flash M16/M16 at (8, 128, 12, 64), each against its float64
   golden;
4g. ``[train-auto]``: one step of the full-width model at 8 x 128 under
   ``PrecisionPolicy.auto()`` with remat: launches and AUTO's host reads
   exactly ``auto_train_launches`` / ``auto_train_reads`` (the forward's
   AUTO matmuls, again in remat's recompute, which must select what the
   forward selected), remat on == off bitwise, the loss and gradients
   against the ``ref`` backend at ``[train]``'s bounds; step ms, busy ms,
   idle share, host reads a step;
4h. ``[train-more]``: ``train_fast`` (the M8 attention backward; held
   against the ``ref`` backend at M8's bound 2^-6 on the loss and each
   leaf's norm) and ``full_fp32`` (escalation's policy, ``[train]``'s
   bounds) value-and-grad at full depth, microbatch accumulation (equal to
   the full batch and to the ``ref`` backend) and a NaN rollback with
   escalation (losses against the ``ref`` backend's run) at depth 2 and
   full widths, each with its launch counts;
4i. ``[fleet]``: 24 requests (modes M8 / M16 / M23 / M36 in turn, prompts
   of 64..256 tokens, 16..32 new, two arrivals a tick) through
   ``make_fleet(engine, 4, n_blocks=64, block_size=16)`` under
   ``mode_affinity``, one interleaved cell (the mixed-lane kernels) and
   ``round_robin``: every stream bitwise ``ContinuousScheduler``'s on the
   same engine and trace, every request done, pools whole, no parked
   handoff, no error on any cell's health record, launches what the
   prefills, decode launches (bucket and mixed) and prelimbs imply; then
   one router tick with 16 slots decoding: host ms, busy ms, idle share;
4j. ``[chaos]``: ``FaultPlan.chaos(seed=0, n_cells=4)`` over 48 such
   requests (four arrivals a tick, so handoffs cross pools) under
   ``least_kv``, with ``benchmarks/chaos_soak.py``'s gates: every event
   fired, no lost request, no leaked block, slot or handoff, untouched
   streams == the no-fault run, each recovered suffix == a resumed solo
   run at its (possibly escalated) mode, the plan twice identical, recovery
   p95 <= 24 ticks; then one ``pool_block_corrupt`` handoff the guardrail
   catches;
4k. ``[dist]``: the sharded backend across ranks, spawned processes (a card
   each over NCCL where the host has two or more, else two ranks sharing
   the card over gloo): full-width ``ServeEngine(matmul_backend="sharded")
   .generate`` on 4's prompts (tokens equal on every rank, prefill logits
   within 4·2^-6 of the cuda engine's, partials launches and all-reduce
   calls and bytes per prefill and decode step exactly the formula), the
   scheduler under ``sharded`` (paged decode sequence-parallel, every
   request done, ranks equal), ``sp_decode_attention`` against the cuda
   route, ``pipeline_forward`` of the 12 layers over the ranks bitwise
   the sequential forward, a depth-2 value-and-grad against the cuda
   backend, [train]'s checkpoint restored onto the ranks' mesh (each
   shard bitwise its slice), then ``[fsdp]`` on the same ranks: three
   ``Trainer.run`` steps of the full-width, full-depth model on the FSDP
   layout of ``make_rules`` on a (data W, model 1) mesh (each rank its
   blocks of params and moments, its rows of [train]'s batches) and a
   checkpoint: losses, grad norms and replicated leaves bitwise equal on
   every rank, each loss and grad norm within 1e-5 (step 1) / 5e-4 of
   [train]'s, the gathered state after the last step within 5e-4 of each
   leaf's max of [train]'s state after the same step (params and both
   moments), launches per kernel and route of the one-rank step's formula (0
   ``strided`` projections), collective calls and bytes of the formula,
   resident state bytes the layout's, the checkpoint restored on one rank
   == the gathered state bitwise; step ms and host ms in the collectives;
   ``hierarchical_psum`` on four ranks; the
   serve launcher under ``torchrun``; a one-rank NCCL group (sharded ==
   cuda engine bitwise); which collectives gloo runs on CUDA tensors
   (``all_to_all`` included), against the set ``dist/collectives.py``
   stages;
4l. ``[arch]`` (before ``[dist]``): every other family's serving path at
   full width, random weights from seed 0, ``serve_default``, pre-limbed
   decode weights: deepseek-v2-lite-16b at depth 6 (1 dense + 5 MoE
   layers), mamba2-130m and zamba2-2.7b at full depth, ``generate`` on
   4's prompts, 32 new; the other seven ids at depth 2 (hubert-xlarge one
   encoder forward of 2 x 256 stub frames; the six decoders ``generate``
   of 2 prompts of 64 tokens, 8 new; llava-next-34b also one prefill
   behind its 576 stub patches): launches per prefill and decode step
   exactly the family's formula, prefill logits and one decode step's
   (both engines from copies of one prefilled cache) within 4·2^-6 of the
   ``ref`` backend, every kernel launch of a prefill and a decode step
   held against its plain version at its shapes, the batched expert
   launch bitwise the per-expert launches, TF32 off; beside each logits
   reading a control at M8 for serve_default's two M16 classes; tokens/s,
   prefill ms, decode ms/step, busy and idle share, peak memory;
4m. ``[train-arch]`` (after ``[arch]``): every family's training at full
   width under ``train_default``: deepseek-v2-lite-16b at depth 3 (1 dense
   + 2 MoE layers) through ``Trainer.run`` (3 steps of 4 x 256, AdamW,
   remat, a checkpoint restoring bitwise): launches per step exactly
   ``arch_train_launches``, step 1's loss, ``moe_aux``, ``moe_zloss`` and
   every gradient leaf against the ``ref`` backend at ``[train]``'s bounds
   with the router's top-k on both counted, every launch shape held
   against its plain version, remat on == off and one step twice bitwise;
   the new launch shapes (batched experts' forward, dgrad, 3-D wgrad;
   flash at Dh 192) timed; step ms, busy, idle share, peak memory; then
   one value-and-grad each of mamba2-130m (full depth), zamba2-2.7b (depth
   12), minicpm3-4b, llava-next-34b (576 stub patches) and hubert-xlarge
   (stub frames) at depth 2 against ``ref``, launches of the formula,
   launch shapes held;
4n. ``[ep]`` (after ``[dist]``): the expert-parallel MoE on four ranks,
   (data 2, model 2) (gloo sharing the card; NCCL with a card each),
   deepseek-v2-lite-16b at depth 2: a value-and-grad (ranks equal; within
   ``[train]``'s bounds of the one-rank all-experts path at a capacity
   factor that drops nothing; ``all_to_all`` calls and bytes exactly
   ``ep_a2a``), the config's capacity factor (finite, dropped share),
   ``ServeEngine(mesh=...)`` (prefill on the split route, decode on the
   replicated route, logits within 4·2^-6 of the one-rank engine,
   launches and exchanges of the formula); one rank over NCCL;
4o. ``[dlayout]`` (on ``[ep]``'s four ranks): full-width, full-depth
   ``paper-mpfp-100m`` serving on the decode layout of ``make_rules``
   (``make_serve_step(layout=specs.decode_layout(...))``) in two cells:
   8 rows over ``data`` with the cache sequence over ``model``, and batch
   1 with it over (``data``, ``model``); 8 decode steps teacher-forced on a
   one-rank step's greedy tokens: logits within 4·2^-6 of the one-rank
   step, equal-row ranks bitwise, the gathered cache against the one-rank
   cache, collectives, launches, routes and resident bytes of
   ``dlayout_formula``, no plain call;
4p. ``[ulysses]`` (three cells on ``[ep]``'s four ranks, one on three of
   its own): the Ulysses layout of ``make_rules``
   (``specs.seq_layout``: the batch over ``data``, the sequence over
   ``model``) of full-width, full-depth ``paper-mpfp-100m`` (heads mode,
   12 heads over 2): 2 ``Trainer.run`` steps of 2 x 1024 (the first
   forward's logits on every rank's row and block bitwise the one-rank
   forward, the loss and every gradient leaf within 1e-5 / 5e-4 of the
   one-rank step, the parameters after the steps within ``adamw_drift``
   of the one-rank state, the ranks of one block bitwise) and a prefill
   of 2 x 2048 into its cache (the last logits and the gathered cache
   bitwise the one-rank prefill's); full-width, full-depth mamba2-130m
   on the same ranks (the SSM's hand-over in rank order, 4 chunks of 256
   a block): a prefill of 2 x 2048 (the last logits and every SSM state
   of the gathered cache bitwise the one-rank prefill's) and a
   value-and-grad on its tokens (the same bounds); deepseek-7b at depth 2,
   full width, on (data 1, model 3) (seq mode: 32 heads over 3): a
   prefill of 3072 (the same bits) and a value-and-grad on its tokens
   (the same bounds);
   collectives, launches, routes and resident bytes of
   ``ulysses_formula``, no plain call; step ms a rank and host ms in each
   collective.  A failed gate of 4g-4p is logged and the phases go on;
   the run fails after them;
5. a ``kernels`` JSON line: per kernel its launches on its main path, its
   device time (CUDA events around calls enqueued behind a sleep kernel, so
   the card runs them back to back; the time of calls issued one after the
   other from the host beside it as ``event_ms``), the plain version's, the
   card's bound and a library call's device time where one PyTorch call
   computes the same function.

The last line is ``{"ok": true, "device": {...}}``.  A report with every
number goes to ``chiprun_out/chip_smoke.json``.  Exits non-zero without a
CUDA device.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
U32 = 2.0 ** -24       # f32 unit roundoff
SOURCES = {
    "mp_fused_matmul": ("src/repro_torch/kernels/csrc/mp_matmul.cu",
                        "src/repro/kernels/mp_matmul.py:76"),
    "mp_fused_proj": ("src/repro_torch/kernels/csrc/mp_matmul.cu",
                      "src/repro/kernels/mp_matmul.py:227"),
    "mp_flash_attention": ("src/repro_torch/kernels/csrc/mp_attention.cu",
                           "src/repro/kernels/mp_attention.py:93"),
    "mp_decompose": ("src/repro_torch/kernels/csrc/mp_matmul.cu",
                     "src/repro/kernels/mp_matmul.py:514"),
    "mp_prelimbed_matmul": ("src/repro_torch/kernels/csrc/mp_matmul.cu",
                            "src/repro/kernels/mp_matmul.py:108"),
    "mp_paged_attention": ("src/repro_torch/kernels/csrc/mp_attention.cu",
                           "src/repro/kernels/mp_attention.py:230"),
    "mp_mixed_prelimbed_matmul": (
        "src/repro_torch/kernels/csrc/mp_matmul.cu",
        "src/repro/kernels/mp_matmul.py:137"),
    "mp_mixed_paged_attention": (
        "src/repro_torch/kernels/csrc/mp_attention.cu",
        "src/repro/kernels/mp_attention.py:346"),
    "mp_both_prelimbed_matmul": (
        "src/repro_torch/kernels/csrc/mp_matmul.cu",
        "src/repro/kernels/mp_matmul.py:182"),
    # replaces no TPU kernel: the JAX package's sharded local step, which
    # XLA computes (ref.mp_matmul_partials inside _sharded_2d)
    "mp_fused_matmul_partials": (
        "src/repro_torch/kernels/csrc/mp_matmul.cu",
        "src/repro/core/dispatch.py:141"),
}
# the files of the routed wrappers' kernels, by route: the kernels line
# names those of the routes its path launched
ROUTE_SOURCES = {"cluster": "src/repro_torch/kernels/csrc/mp_matmul_hopper.cu",
                 "tma": "src/repro_torch/kernels/csrc/mp_matmul_hopper.cu",
                 "strided": "src/repro_torch/kernels/csrc/mp_matmul.cu",
                 "mma": "src/repro_torch/kernels/csrc/mp_matmul.cu"}
# the path whose run gives each kernel's ``launches``: the three kernels of
# slice 1 report the static ``generate`` path, the three of the scheduler
# slice the scheduler path, the two mixed-lane kernels the mixed-traffic path,
# the both-prelimbed kernel the six-mode path (its DD calls)
LAUNCH_PATH = {"mp_decompose": "scheduler", "mp_prelimbed_matmul": "scheduler",
               "mp_paged_attention": "scheduler",
               "mp_mixed_prelimbed_matmul": "mixed",
               "mp_mixed_paged_attention": "mixed",
               "mp_both_prelimbed_matmul": "modes",
               "mp_fused_matmul_partials": "dist"}
# launches of one generate(8 prompts, max_new=32) at 12 layers: prefill
# QKV + SwiGLU per layer; wo, w_down per layer + lm_head; decode adds QK
# and PV per layer
EXPECTED = {"mp_fused_proj": 24 + 32 * 24, "mp_flash_attention": 12,
            "mp_fused_matmul": 25 + 32 * 49, "mp_decompose": 0,
            "mp_prelimbed_matmul": 0, "mp_paged_attention": 0,
            "mp_mixed_prelimbed_matmul": 0, "mp_mixed_paged_attention": 0,
            "mp_both_prelimbed_matmul": 0, "mp_fused_matmul_partials": 0}
# the fused matmul's routes in that generate: the 24 prefill wo / w_down
# and lm_head on the TMA tile, every decode matmul (wo, w_down, QK, PV,
# lm_head at 8 rows, or 1 row per batch entry) on the split decode tile
EXPECTED_ROUTES = {"cluster": 32 * 49, "tma": 25, "strided": 0}
# the projection's: the 24 prefill QKV and SwiGLU launches on the TMA tile,
# the 768 decode ones on the split decode tile
EXPECTED_PROJ_ROUTES = {"cluster": 32 * 24, "tma": 24, "strided": 0}
# the mixed-traffic modes, request i at MODES[i % 4]: the serving builtins
# and a custom format that keeps all four 2-limb products (M16 keeps three)
CUSTOM = dict(name="M16FULL", mantissa_bits=16, n_limbs=2, max_order=2)
MODES = ("M8", "M16", "M23", CUSTOM["name"])
# flash attention's cases: (label, B, S, T, H, Dh, qk, pv, causal, q_offset,
# plant); the first is the main path's prefill, the fifth the scheduler's
# B = 1 prefill (the longest prompt); ``plant`` holds (row, position, gain)
# for every (b, h) (:func:`flash_inputs`), here the largest logit of a row
# in the last column of each of the first three kv tiles
FLASH_CASES = (
    ("prefill (8,256,12,64) causal", 8, 256, 256, 12, 64, "M16", "M8", True,
     0, ()),
    ("(2,37,4,64) q_offset 63 causal", 2, 37, 100, 4, 64, "M23", "M16", True,
     63, ()),
    ("(2,100,4,64) bidirectional", 2, 100, 100, 4, 64, "M8", "M8", False, 0,
     ()),
    ("(1,70,2,64) causal M36/M52", 1, 70, 70, 2, 64, "M36", "M52", True, 0,
     ()),
    ("scheduler prefill (1,256,12,64) causal", 1, 256, 256, 12, 64, "M16",
     "M8", True, 0, ()),
    ("(2,96,4,64) max in a tile's last column", 2, 96, 96, 4, 64, "M16",
     "M8", True, 0, ((31, 31, 8.0), (70, 63, 8.0), (95, 95, 8.0))),
    # [arch]'s prefill attention: MLA's head dim 192 (deepseek-v2-lite at
    # [main]'s prompts), 80 (zamba2's shared block; hubert's encoder,
    # bidirectional), 96 (minicpm3's MLA, [arch]'s short prompts)
    ("prefill (8,256,16,192) causal MLA", 8, 256, 256, 16, 192, "M16", "M8",
     True, 0, ()),
    ("prefill (8,256,32,80) causal", 8, 256, 256, 32, 80, "M16", "M8", True,
     0, ()),
    ("prefill (2,256,16,80) bidirectional", 2, 256, 256, 16, 80, "M16", "M8",
     False, 0, ()),
    ("prefill (2,64,40,96) causal", 2, 64, 64, 40, 96, "M16", "M8", True, 0,
     ()),
)
# AUTO (paper mode 1): per layer the three QKV branches, wo, gate, up,
# w_down and the two attention contractions analyze their operands (one
# host read each) and launch the fused kernel; lm_head stays M23 (fused)
AUTO_PER_PASS = 12 * 9
# the AUTO-traffic modes, request i at AUTO_MODES[i % 4] (None: AUTO policy)
AUTO_MODES = ("M8", "M16", "M23", None)
# the training path: paper-mpfp-100m at the launcher's batch and sequence
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 5


def train_launches(n_layers: int, remat: bool = True) -> dict:
    """Kernel launches of one train_default step (value and gradient):
    per layer the forward's QKV and SwiGLU projections (gate "none" under
    autograd), flash attention, wo and w_down, run twice with remat (the
    recompute); the backward's dgrads (w_down 1, gate/up 2, wo 1, QKV 3)
    and the attention backward's 5 both-batched products; lm_head forward
    and dgrad.  Each weight gradient is one plain product (no kernel)."""
    fwd = 2 if remat else 1
    return {"mp_fused_proj": 2 * fwd * n_layers,
            "mp_flash_attention": fwd * n_layers,
            "mp_fused_matmul": n_layers * (2 * fwd + 12) + 2}


def arch_train_launches(cfg, B: int, S: int, remat: bool = True) -> dict:
    """Kernel launches of one train_default value-and-gradient of any
    family at B x S positions (the VLM's patches included): the forward of
    :func:`arch_forward_launches`, every layer's again in remat's
    recompute (the head's once), then the backward: per contraction the
    activation gradient (dgrad), and the weight gradient too where a
    kernel takes it — a 2-D activation (the router) or a batched weight
    (the experts: dgrad (E,T,F)·(E,F,D) and the 3-D wgrad with x^T
    broadcast as a stride-0 batch); a 3-D activation's weight gradient
    against a 2-D weight is one plain product (no kernel).  Per attention
    block: GQA the QKV group's 3 dgrads and wo; MLA the input group's 3,
    the latent's K / V up-projection 2, ``w_uq`` with a query LoRA, and
    ``w_o``; flash attention's backward 5 products (the chunk-scan 2 a
    product).  Per MLP the gate / up dgrads and w_down; per MoE layer the
    router 2, the three batched expert contractions 2 each, the shared
    experts' MLP 3; per Mamba2 layer 7 within one SSD chunk (the in and
    out projections' dgrads, the scores' and the intra-chunk product's 2
    each, the inter-chunk product's C), 10 over more (the chunk states'
    product 2 and the inter-chunk product's carried state then take
    gradients); the head's dgrad."""
    f = arch_forward_launches(cfg, B, S)
    rep = 2 if remat else 1
    if cfg.mla is not None:
        attn = 3 + 2 + (cfg.mla.q_lora > 0) + 1
    else:
        attn = 3 + 1
    if f["mp_flash_attention"]:
        attn += 5
    else:
        attn += 2 * 2 * (_n_chunks(S, cfg.attn_q_chunk)
                         * _n_chunks(S, cfg.attn_kv_chunk))
    mlp = 3
    ssm = 7 + (3 if cfg.ssm is not None and S > cfg.ssm.chunk else 0)
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm", "audio"):
        bwd = L * (attn + mlp)
    elif cfg.family == "moe":
        k = cfg.first_k_dense
        moe = 2 + 3 * 2 + 3 * (cfg.moe.n_shared > 0)
        bwd = k * (attn + mlp) + (L - k) * (attn + moe)
    elif cfg.family == "ssm":
        bwd = L * ssm
    else:  # hybrid: the shared block once a group, the Mamba2 layers
        bwd = L // cfg.hybrid_attn_every * (attn + mlp) + L * ssm
    return {"mp_fused_matmul": rep * (f["mp_fused_matmul"] - 1) + 1 + bwd
            + 1,
            "mp_fused_proj": rep * f["mp_fused_proj"],
            "mp_flash_attention": rep * f["mp_flash_attention"]}


# the fleet and chaos paths: paper-mpfp-100m behind the router, the modes in
# turn; the chaos trace is twice as long and twice as dense, so that decode
# slots fill and handoffs cross pools (where handoff_transfer_fail fires)
FLEET_MODES = ("M8", "M16", "M23", "M36")
N_CELLS = 4
FLEET_REQUESTS, CHAOS_REQUESTS = 24, 48
FLEET_BLOCKS, CHAOS_BLOCKS, SCHED_BLOCKS = 64, 153, 160
# recovery p95 limit, in ticks (benchmarks/chaos_soak.py --max-recovery-p95)
MAX_RECOVERY_P95 = 24.0
# an injected fault's record on a cell's health (router.py): anything else
# there is a real exception the router caught
INJECTED_ERRORS = (None, "crash", "straggler")


def _n_chunks(n: int, chunk: int) -> int:
    """The chunk-scan's chunk count along a length (models/attention.py
    ``chunked_attention``)."""
    k = max(1, n // chunk)
    return k if n % k == 0 else -(-n // max(1, min(chunk, n)))


def auto_train_launches(cfg, seq: int, remat: bool = True) -> dict:
    """Kernel launches of one step under ``PrecisionPolicy.auto()``: AUTO
    runs each matmul alone on the fused kernel (no projection group, and
    attention on the chunk-scan, a QK and a PV product per pair of query
    and key chunks: one pair at the full config's 1024-token chunks), so
    per layer the forward's 3 QKV branches, wo, gate, up and w_down and 2
    products a pair (run twice with remat) and the backward's dgrads (QKV
    3, wo 1, gate/up 2, w_down 1) plus both operands' gradients of each
    pair's two products (batched, so kernels); lm_head (M23) forward and
    dgrad."""
    pairs = (_n_chunks(seq, cfg.attn_q_chunk)
             * _n_chunks(seq, cfg.attn_kv_chunk))
    fwd = (7 + 2 * pairs) * (2 if remat else 1)
    return {"mp_fused_matmul": cfg.n_layers * (fwd + 7 + 4 * pairs) + 2}


def auto_train_reads(cfg, seq: int, remat: bool = True) -> int:
    """AUTO's host reads of one step: one per AUTO matmul of the forward
    (7 + 2 a chunk pair, a layer), again in remat's recompute; the backward
    runs the selected formats and reads nothing."""
    pairs = (_n_chunks(seq, cfg.attn_q_chunk)
             * _n_chunks(seq, cfg.attn_kv_chunk))
    return (7 + 2 * pairs) * cfg.n_layers * (2 if remat else 1)


def serve_launches(n_layers: int, prefills: int, bucket: int, mixed: int,
                   prelimbs: int) -> dict:
    """Kernel launches of a serving run from its counts: a B = 1 paged
    prefill runs the QKV and SwiGLU projections, flash attention, wo and
    w_down a layer and lm_head; a decode launch 7 pre-limbed matmuls a layer
    and lm_head plus paged attention a layer (a mixed launch the same on the
    mixed-lane kernels); a prelimb decomposes the same 7L + 1 weights."""
    mm = 7 * n_layers + 1
    return {"mp_fused_proj": 2 * n_layers * prefills,
            "mp_flash_attention": n_layers * prefills,
            "mp_fused_matmul": (2 * n_layers + 1) * prefills,
            "mp_decompose": mm * prelimbs,
            "mp_prelimbed_matmul": mm * bucket,
            "mp_paged_attention": n_layers * bucket,
            "mp_mixed_prelimbed_matmul": mm * mixed,
            "mp_mixed_paged_attention": n_layers * mixed,
            "mp_both_prelimbed_matmul": 0, "mp_fused_matmul_partials": 0}


def fleet_trace(vocab: int, n: int, per_tick: int, seed: int = 0):
    """``n`` requests at FLEET_MODES in turn, prompts of 64..256 tokens,
    16..32 new tokens, ``per_tick`` arrivals a tick (fresh objects every
    call: a run writes into its requests)."""
    import numpy as np

    from repro_torch.serve.primitives import ScheduledRequest

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        size, new = int(rng.integers(64, 257)), int(rng.integers(16, 33))
        reqs.append(ScheduledRequest(
            rid=i, prompt=rng.integers(1, vocab, size=size).astype(np.int32),
            max_new=new, mode=FLEET_MODES[i % len(FLEET_MODES)],
            arrival=i // per_tick))
    return reqs


class Failures:
    """The new phases' gates: a failed gate is logged and kept, the phase
    goes on, and :meth:`raise_if_any` fails the run at the end, so one run
    on the card shows every gate."""

    def __init__(self):
        self.items = []

    def check(self, ok, what: str) -> bool:
        if not ok:
            self.items.append(what)
            log(f"[FAIL] {what}")
        return bool(ok)

    def run(self, label: str, fn, *args, **kw):
        import traceback

        try:
            return fn(*args, **kw)
        except Exception as err:  # noqa: BLE001 — kept, raised at the end
            self.items.append(f"{label}: {type(err).__name__}: {err}")
            log(f"[FAIL] {label}: {type(err).__name__}: {err}")
            log(traceback.format_exc())
            return None

    def raise_if_any(self) -> None:
        if self.items:
            raise AssertionError(f"{len(self.items)} gates failed: "
                                 + " | ".join(self.items))


class Counted:
    """Counts the decode step calls by kind, the cross-pool block transfers
    and the handoffs delivered, while it is entered."""

    def __init__(self):
        self.steps = {"mixed": 0, "bucket": 0}
        self.transfers = 0

    def __enter__(self):
        from repro_torch.serve import primitives as prim
        from repro_torch.serve.kv_cache import PagedKVPool

        self._real = (prim.decode_mixed_step, prim.decode_bucket_step,
                      PagedKVPool.transfer_blocks)

        def counted(kind, real):
            def step(*args, **kw):
                self.steps[kind] += 1
                return real(*args, **kw)
            return step

        def transfer(pool, *args, **kw):
            self.transfers += 1
            return self._real[2](pool, *args, **kw)

        prim.decode_mixed_step = counted("mixed", self._real[0])
        prim.decode_bucket_step = counted("bucket", self._real[1])
        PagedKVPool.transfer_blocks = transfer
        return self

    def __exit__(self, *exc):
        from repro_torch.serve import primitives as prim
        from repro_torch.serve.kv_cache import PagedKVPool

        (prim.decode_mixed_step, prim.decode_bucket_step,
         PagedKVPool.transfer_blocks) = self._real
        return False


def grads_vs_ref(fail, tag, loss_fn, params, batch, sync, m8=False):
    """Loss and gradients on the kernels and on the ``ref`` backend, held at
    ``[train]``'s bounds (loss 1e-5 relative; each leaf 5e-4 of its max).
    ``m8``: the policy puts whole op classes at M8, whose products round
    their operands to bf16, and two sum orders of an operand (the kernels'
    and the ref backend's) can round it to neighbouring bf16 values; such a
    step is held at M8's format bound 2^-6, on the loss and on each leaf's
    norm (the CPU tests hold the M8 attention backward against JAX in the
    norm too, tests/test_torch_grad.py)."""
    from repro_torch import tree as tree_lib
    from repro_torch.core import context as context_lib
    from repro_torch.train import trainer as trainer_lib

    (l_k, _), g_k = trainer_lib.value_and_grad(loss_fn, params, batch)
    sync()
    with context_lib.context(backend="ref"):
        (l_r, _), g_r = trainer_lib.value_and_grad(loss_fn, params, batch)
    sync()
    loss_rel = abs(l_k.item() - l_r.item()) / abs(l_r.item())
    leaf = {p: ((a - b).abs().max() / b.abs().max()).item()
            for (p, a), b in zip(tree_lib.items(g_k), tree_lib.leaves(g_r))}
    norm = {p: ((a - b).norm() / b.norm()).item()
            for (p, a), b in zip(tree_lib.items(g_k), tree_lib.leaves(g_r))}
    worst, worst_n = max(leaf, key=leaf.get), max(norm, key=norm.get)
    if m8:
        bound = 2.0 ** -6
        ok = loss_rel <= bound and norm[worst_n] <= bound
        rule = f"M8's bound {bound:.3e} on the loss and each leaf's norm"
    else:
        ok = loss_rel <= 1e-5 and leaf[worst] < 5e-4
        rule = "loss 1e-5, each leaf 5e-4 of its max"
    log(f"[{tag}] against the ref backend: loss {l_k.item():.6f} vs "
        f"{l_r.item():.6f} (rel {loss_rel:.3e}); worst gradient leaf "
        f"{worst} {leaf[worst]:.3e} of its max, worst in the norm "
        f"{worst_n} {norm[worst_n]:.3e} (bounds: {rule})")
    fail.check(ok, f"[{tag}] disagrees with the ref backend")
    return (l_k, g_k), dict(loss_rel=loss_rel, worst_leaf=worst,
                            worst_leaf_err=leaf[worst], worst_norm=worst_n,
                            worst_norm_err=norm[worst_n])


def train_auto_phase(fail, cfg, dev, smi, counts):
    """``[train-auto]``: one step of the model under
    ``PrecisionPolicy.auto()`` at TRAIN_BATCH x TRAIN_SEQ with remat."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch import tree as tree_lib
    from repro_torch.core import auto as auto_lib
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import trainer as trainer_lib

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    policy = PrecisionPolicy.auto()
    trainer = trainer_lib.Trainer(
        cfg, trainer_lib.TrainerConfig(total_steps=TRAIN_STEPS, warmup=2),
        policy=policy, device=str(dev))
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ + 1,
                                  global_batch=TRAIN_BATCH))
    state0 = trainer.init_state(seed=0)
    batch0 = trainer.to_device(pipe.batch(0))
    zero = dict.fromkeys(kernels.KERNELS, 0)

    def value_and_grad(model_cfg):
        kernels.reset_launch_counts()
        out = trainer_lib.value_and_grad(
            trainer_lib.make_loss_fn(model_cfg, policy), state0.params,
            batch0)
        sync()
        return out, counts(), auto_lib.mp_matmul_auto.host_reads

    (on, on_n, on_reads) = value_and_grad(cfg)
    want = {**zero, **auto_train_launches(cfg, TRAIN_SEQ)}
    reads = auto_train_reads(cfg, TRAIN_SEQ)
    log(f"[train-auto] value and grad: launches {on_n}, host reads "
        f"{on_reads} (want {want['mp_fused_matmul']} fused matmuls, "
        f"{reads} reads: {reads // 2} forward AUTO calls and as many in "
        f"remat's recompute)")
    fail.check(on_n == want and on_reads == reads,
               "[train-auto] launches or host reads off the formula")
    (off, off_n, off_reads) = value_and_grad(
        dataclasses.replace(cfg, remat=False))
    fail.check(off_n == {**zero, **auto_train_launches(cfg, TRAIN_SEQ,
                                                       remat=False)}
               and off_reads == auto_train_reads(cfg, TRAIN_SEQ,
                                                 remat=False),
               "[train-auto] launches or host reads without remat")
    same = torch.equal(on[0][0], off[0][0]) and all(
        torch.equal(a, b) for a, b in zip(tree_lib.leaves(on[1]),
                                          tree_lib.leaves(off[1])))
    fail.check(same, "[train-auto] remat's gradients are not bitwise the "
               "gradients without remat")
    log(f"[train-auto] remat on == remat off, loss and every gradient "
        f"{'bitwise' if same else 'DIFFER'}")
    del on, off
    _, vs_ref = grads_vs_ref(fail, "train-auto", trainer_lib.make_loss_fn(
        cfg, policy), state0.params, batch0, sync)
    out = dict(policy="auto", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               launches=on_n, host_reads=on_reads, host_reads_want=reads,
               launches_no_remat=off_n, host_reads_no_remat=off_reads,
               remat_bitwise=same, **vs_ref)
    # one Trainer step: host clock, reads, busy and idle share
    state, step_ms = state0, []
    for i in range(3):
        b = trainer.to_device(pipe.batch(1 + i))
        kernels.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        state, m = trainer._step_fn(state, b)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        fail.check(auto_lib.mp_matmul_auto.host_reads == reads
                   and counts() == want and math.isfinite(m["loss"].item()),
                   f"[train-auto] Trainer step {i}: reads "
                   f"{auto_lib.mp_matmul_auto.host_reads}, launches "
                   f"{counts()}")
    med = float(np.median(step_ms))
    out.update(step_ms=step_ms, step_ms_median=med,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / med * 1e3)
    msg = (f"[train-auto] Trainer step {med:.2f} ms (host clock after "
           f"synchronize, {[round(x, 2) for x in step_ms]}), "
           f"{out['tokens_per_s']:.0f} tokens/s, {reads} host reads a step")
    if on_card:
        b = trainer.to_device(pipe.batch(4))
        busy, by_name = device_busy_ms(lambda: trainer._step_fn(state, b))
        out.update(busy_ms=busy, idle_share=max(0.0, 1 - busy / med),
                   busy_by_name=by_name)
        msg += (f"; busy {busy:.2f} ms, idle share {out['idle_share']:.3f}; "
                f"busy by name {dict(list(by_name.items())[:6])} ({smi})")
    log(msg)
    return out


def train_more_phase(fail, cfg, dev, smi, counts, ck_root):
    """``[train-more]``: the training paths ``[train]`` does not run, each
    with its launch counts and the ref backend: a ``train_fast`` step (the
    M8 attention backward) and a ``full_fp32`` one (escalation's policy) at
    full depth; microbatch accumulation and a NaN rollback at depth 2 (full
    widths: the checkpoints stay small)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch import tree as tree_lib
    from repro_torch.core import context as context_lib
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import trainer as trainer_lib

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    zero = dict.fromkeys(kernels.KERNELS, 0)
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ + 1,
                                  global_batch=TRAIN_BATCH))
    out = {}
    for name in ("train_fast", "full_fp32"):
        policy = getattr(PrecisionPolicy, name)()
        trainer = trainer_lib.Trainer(cfg, trainer_lib.TrainerConfig(),
                                      policy=policy, device=str(dev))
        params = trainer.init_state(seed=0).params
        batch = trainer.to_device(pipe.batch(0))
        kernels.reset_launch_counts()
        loss_fn = trainer_lib.make_loss_fn(cfg, policy)
        trainer_lib.value_and_grad(loss_fn, params, batch)
        sync()
        n = counts()
        want = {**zero, **train_launches(cfg.n_layers)}
        fail.check(n == want, f"[train-more] {name} launches {n} != {want}")
        _, vs_ref = grads_vs_ref(fail, f"train-more {name}", loss_fn, params,
                                 batch, sync, m8=name == "train_fast")
        log(f"[train-more] {name} value and grad, {cfg.n_layers} layers: "
            f"launches {n}")
        out[name] = dict(launches=n, **vs_ref)
        del trainer, params
    # depth 2 from here: two layers of full width
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    want2 = {**zero, **train_launches(2)}
    policy = PrecisionPolicy.full_fp32()
    trainer = trainer_lib.Trainer(cfg2, trainer_lib.TrainerConfig(),
                                  policy=policy, device=str(dev))
    params = trainer.init_state(seed=0).params
    batch = trainer.to_device(pipe.batch(0))
    loss_fn = trainer_lib.make_loss_fn(cfg2, policy)
    (_, _), g_full = trainer_lib.value_and_grad(loss_fn, params, batch)
    micro = TRAIN_BATCH // 2
    kernels.reset_launch_counts()
    g_micro, m = trainer_lib._accum_grads(loss_fn, params, batch, micro)
    sync()
    n = counts()
    err = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(tree_lib.leaves(g_micro),
                              tree_lib.leaves(g_full)))
    fail.check(n == {k: 2 * v for k, v in want2.items()},
               f"[train-more] microbatch launches {n}")
    fail.check(err < 5e-4 and math.isfinite(m["loss"].item()),
               f"[train-more] microbatches vs the full batch {err:.3e}")
    with context_lib.context(backend="ref"):
        g_ref, m_ref = trainer_lib._accum_grads(loss_fn, params, batch, micro)
    sync()
    ref_err = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(tree_lib.leaves(g_micro),
                                  tree_lib.leaves(g_ref)))
    loss_rel = abs(m["loss"].item() - m_ref["loss"].item()) / abs(
        m_ref["loss"].item())
    fail.check(loss_rel <= 1e-5 and ref_err < 5e-4,
               "[train-more] microbatches disagree with the ref backend")
    log(f"[train-more] microbatch {micro} x 2 at depth 2 (full widths), "
        f"full_fp32: launches {n}; the mean of the microbatches' gradients "
        f"vs the full batch's: worst leaf {err:.3e} of its max (bound "
        f"5e-4); vs the ref backend: loss rel {loss_rel:.3e}, worst leaf "
        f"{ref_err:.3e}")
    out["microbatch"] = dict(depth=2, micro=micro, launches=n,
                             vs_full_batch=err, loss_rel_vs_ref=loss_rel,
                             grad_err_vs_ref=ref_err)
    del trainer, params, g_full, g_micro, g_ref
    # NaN rollback at depth 2: step 3's parameters poisoned, rollback to the
    # checkpoint of step 2, the rest at full_fp32 (escalation)
    hist = {}
    for backend in ("", "ref"):
        ck = ck_root / f"rollback{backend}"
        shutil.rmtree(ck, ignore_errors=True)
        trainer = trainer_lib.Trainer(
            cfg2, trainer_lib.TrainerConfig(
                total_steps=4, warmup=2, ckpt_dir=str(ck), ckpt_every=2,
                keep=1, matmul_backend=backend),
            policy=PrecisionPolicy.train_default(), device=str(dev))
        real, calls = trainer._step_fn, {"n": 0}

        def poisoned(state, b, real=real, calls=calls):
            calls["n"] += 1
            new, metrics = real(state, b)
            if calls["n"] == 3:
                bad = tree_lib.map_(lambda x: x * float("nan"), new.params)
                new = trainer_lib.TrainState(bad, new.opt)
                metrics = dict(metrics, params_finite=torch.zeros(()))
            return new, metrics

        trainer._step_fn = poisoned
        kernels.reset_launch_counts()
        state, h = trainer.run(pipe, num_steps=4, log_every=0)
        sync()
        n = counts()
        hist[backend or "cuda"] = h
        if not backend:
            # 3 steps, the rollback, then steps 3 and 4 at full_fp32
            fail.check(n == {k: 5 * v for k, v in want2.items()},
                       f"[train-more] rollback launches {n}")
            fail.check(trainer.rollbacks == 1 and len(h) == 4
                       and all(math.isfinite(x) for x in h)
                       and trainer._escalated_fn is not None
                       and all(torch.isfinite(x).all()
                               for x in tree_lib.leaves(state.params)),
                       f"[train-more] rollback: {trainer.rollbacks} "
                       f"rollbacks, losses {h}")
            roll_launches = n
        shutil.rmtree(ck, ignore_errors=True)
        del trainer, state
    rel = max(abs(a - b) / abs(b) for a, b in zip(hist["cuda"], hist["ref"]))
    fail.check(rel <= 1e-5, f"[train-more] rollback losses vs the ref "
               f"backend rel {rel:.3e}")
    log(f"[train-more] NaN rollback at depth 2 (full widths): step 3 "
        f"poisoned, rolled back to the checkpoint of step 2, steps 3-4 at "
        f"full_fp32: losses {[round(x, 5) for x in hist['cuda']]}, vs the "
        f"ref backend's rel {rel:.3e} (bound 1e-5); launches {roll_launches}"
        f" ({smi})")
    out["rollback"] = dict(depth=2, losses=hist["cuda"],
                           losses_ref=hist["ref"], loss_rel_vs_ref=rel,
                           launches=roll_launches)
    return out


def health_of(router):
    errors = sum(h.errors for h in router.health.values())
    foreign = [h.last_error for h in router.health.values()
               if h.last_error not in INJECTED_ERRORS]
    return errors, foreign


def routed(fail, tag, eng, cells, reqs, counts, sync, **router_kw):
    """One router run under the counters: streams, stats, launches, and the
    gates every fleet run holds (every request done, pools whole, no parked
    handoff, no real error on any cell, launches the formula's)."""
    from repro_torch import kernels
    from repro_torch.serve.fleet import FleetRouter

    router = FleetRouter(cells, **router_kw)
    misses0 = eng.prelimb_cache_misses
    kernels.reset_launch_counts()
    with Counted() as c:
        t0 = time.perf_counter()
        done = router.run(reqs)
        sync()
        run_s = time.perf_counter() - t0
    n = counts()
    stats = router.stats()
    errors, foreign = health_of(router)
    want = serve_launches(eng.cfg.n_layers, stats["prefills"],
                          c.steps["bucket"], c.steps["mixed"],
                          eng.prelimb_cache_misses - misses0)
    decode_launches = sum(cell.decode.decode_launches for cell in cells)
    fail.check(len(done) == len(reqs) and stats["completed"] == len(reqs)
               and all(len(r.out) == r.max_new for r in done),
               f"[{tag}] {stats['completed']} of {len(reqs)} requests done")
    fail.check(all(cell.pool.n_free == cell.pool.n_blocks - 1
                   and cell.decode.n_active == 0
                   and cell.prefill.queue_depth == 0 for cell in cells)
               and stats["pending_handoffs"] == 0,
               f"[{tag}] a block, slot or handoff leaked")
    fail.check(errors == 0 and not foreign,
               f"[{tag}] health errors {errors}, last errors {foreign}")
    fail.check(n == want and decode_launches == sum(c.steps.values()),
               f"[{tag}] launches {n} != {want} (decode launches "
               f"{decode_launches}, step calls {c.steps})")
    return dict(router=router, done=done, outs={r.rid: list(r.out)
                                                for r in done},
                stats=stats, run_s=run_s, launches=n, steps=dict(c.steps),
                transfers=c.transfers, errors=errors)


def fleet_phase(fail, eng, dev, smi, counts):
    """``[fleet]``: FLEET_REQUESTS requests through make_fleet(eng, 4) under
    mode_affinity, against ContinuousScheduler on the same engine and
    trace, an interleaved cell and round_robin; then a router tick's busy
    time."""
    import numpy as np
    import torch

    from repro_torch.serve.fleet import FleetRouter, make_fleet
    from repro_torch.serve.scheduler import ContinuousScheduler

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    vocab = eng.cfg.vocab

    def trace():
        return fleet_trace(vocab, FLEET_REQUESTS, 2)

    sched = ContinuousScheduler(eng, n_blocks=SCHED_BLOCKS, block_size=16)
    want = {r.rid: list(r.out) for r in sched.run(trace())}
    out = {}
    for tag, n_cells, blocks, kw in (
            ("mode_affinity", N_CELLS, FLEET_BLOCKS,
             dict(policy="mode_affinity")),
            ("interleaved", 1, SCHED_BLOCKS, dict()),
            ("round_robin", N_CELLS, FLEET_BLOCKS,
             dict(policy="round_robin"))):
        cells = make_fleet(eng, n_cells, n_blocks=blocks, block_size=16,
                           disaggregate=tag != "interleaved")
        r = routed(fail, f"fleet {tag}", eng, cells, trace(), counts, sync,
                   **kw)
        same = r["outs"] == want
        fail.check(same, f"[fleet {tag}] streams differ from the "
                   "scheduler's")
        if tag == "interleaved":
            fail.check(r["steps"]["mixed"] > 0, "[fleet interleaved] ran no "
                       "mixed-lane launch")
        st = r["stats"]
        log(f"[fleet] {tag}: {n_cells} cells x {blocks} blocks, "
            f"{FLEET_REQUESTS} requests, modes {list(FLEET_MODES)} in turn: "
            f"{r['run_s']:.3f} s, {st['useful_tokens'] / r['run_s']:.1f} "
            f"tokens/s, {st['ticks']} ticks, {st['prefills']} prefills, "
            f"decode launches {r['steps']} (bucket/mixed), "
            f"{st['prefills']} handoffs of which {r['transfers']} cross "
            f"pools, requeues {st['requeues']}; streams == scheduler "
            f"{'bitwise' if same else 'DIFFER'}; launches {r['launches']}")
        out[tag] = dict(cells=n_cells, blocks=blocks, run_s=r["run_s"],
                        tokens_per_s=st["useful_tokens"] / r["run_s"],
                        ticks=st["ticks"], prefills=st["prefills"],
                        transfers=r["transfers"], steps=r["steps"],
                        requeues=st["requeues"], launches=r["launches"],
                        streams_equal_scheduler=same,
                        health_errors=r["errors"],
                        latency={k: v for k, v in st.items()
                                 if k.endswith(("_ms", "_steps"))})
    # one router tick with every cell decoding (4 requests a cell, no
    # admissions): host clock and the card's busy time
    cells = make_fleet(eng, N_CELLS, n_blocks=FLEET_BLOCKS, block_size=16)
    router = FleetRouter(cells, policy="mode_affinity")
    probe = fleet_trace(vocab, 16, 16, seed=1)
    for q in probe:
        q.prompt, q.max_new = q.prompt[:160], 64
        router.submit(q)
    while router._backlog or any(c.prefill.queue_depth for c in cells) \
            or router._pending_handoffs:
        router.step()
    ticks = 8
    sync()
    t0 = time.perf_counter()
    for _ in range(ticks):
        router.step()
    sync()
    tick_ms = (time.perf_counter() - t0) / ticks * 1e3
    active = sum(c.decode.n_active for c in cells)
    fail.check(active == 16, f"[fleet] tick probe: {active} slots decoding")
    msg = (f"[fleet] router tick, 4 cells x 4 slots decoding, no admissions:"
           f" {tick_ms:.3f} ms on the host clock")
    out["tick"] = dict(tick_ms=tick_ms, slots=active)
    if on_card:
        busy, by_name = device_busy_ms(router.step)
        out["tick"].update(busy_ms=busy, idle_share=max(0.0,
                                                        1 - busy / tick_ms),
                           busy_by_name=by_name)
        msg += (f", busy {busy:.3f} ms, idle share "
                f"{out['tick']['idle_share']:.3f} ({smi})")
    log(msg)
    return out


def solo_suffix(eng, req):
    """A recovered request's suffix from a resumed solo run: its prefix in
    ``out`` (re-prefill prompt + out[:-1], feed out[-1]), as the router's
    re-admission ran it (benchmarks/chaos_soak.py ``solo_suffix``)."""
    import numpy as np

    from repro_torch.serve.primitives import ScheduledRequest
    from repro_torch.serve.scheduler import ContinuousScheduler

    k = req.recovery_prefixes[-1]
    solo = ScheduledRequest(rid=0, prompt=np.asarray(req.prompt, np.int32),
                            max_new=req.max_new, mode=req.mode,
                            eos_token=req.eos_token)
    solo.out = list(req.out[:k])
    ContinuousScheduler(eng, n_blocks=SCHED_BLOCKS, block_size=16).run(
        [solo])
    return list(solo.out[k:])


def chaos_phase(fail, eng, dev, smi, counts):
    """``[chaos]``: ``FaultPlan.chaos(seed=0, n_cells=4)`` over
    CHAOS_REQUESTS requests under least_kv, with chaos_soak's gates; then
    one poisoned handoff the guardrail must catch."""
    import torch

    from repro_torch.serve.faults import FaultEvent, FaultPlan
    from repro_torch.serve.fleet import make_fleet

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    vocab = eng.cfg.vocab

    def run(tag, plan):
        cells = make_fleet(eng, N_CELLS, n_blocks=CHAOS_BLOCKS,
                           block_size=16)
        return routed(fail, f"chaos {tag}", eng, cells,
                      fleet_trace(vocab, CHAOS_REQUESTS, 4), counts, sync,
                      policy="least_kv", fault_plan=plan)

    base = run("no-fault", None)
    chaos = run("seed 0", FaultPlan.chaos(seed=0, n_cells=N_CELLS))
    st, router = chaos["stats"], chaos["router"]
    fail.check(st["fault_events_unfired"] == 0,
               f"[chaos] unfired events {router.injector.unfired}")
    fail.check(st["cell_deaths"] == 1 and st["guard_trips"] >= 1,
               f"[chaos] {st['cell_deaths']} deaths, {st['guard_trips']} "
               "guard trips")
    reqs = {r.rid: r for r in chaos["done"]}
    untouched = [r for r in reqs.values()
                 if not r.recovery_prefixes and not r.guard_trips]
    bad = [r.rid for r in untouched
           if chaos["outs"][r.rid] != base["outs"][r.rid]]
    fail.check(not bad, f"[chaos] untouched requests {bad} differ from the "
               "no-fault run")
    recovered = [r for r in reqs.values() if r.recovery_prefixes]
    bad_prefix = [r.rid for r in recovered if r.out[:r.recovery_prefixes[0]]
                  != base["outs"][r.rid][:r.recovery_prefixes[0]]]
    bad_suffix = [r.rid for r in recovered
                  if r.out[r.recovery_prefixes[-1]:] != solo_suffix(eng, r)]
    fail.check(not bad_prefix and not bad_suffix,
               f"[chaos] recovered requests: history changed {bad_prefix}, "
               f"suffix != resumed solo run {bad_suffix}")
    again = run("seed 0 again", FaultPlan.chaos(seed=0, n_cells=N_CELLS))
    same = (again["router"].injector.trace == router.injector.trace
            and again["outs"] == chaos["outs"])
    fail.check(same, "[chaos] the same plan twice: other trace or streams")
    p95 = st["recovery_latency_p95_ticks"]
    fail.check(st["recovered_requests"] >= 1 and p95 <= MAX_RECOVERY_P95,
               f"[chaos] recovery p95 {p95} ticks")
    log(f"[chaos] {CHAOS_REQUESTS} requests, 4 arrivals a tick, 4 cells x "
        f"{CHAOS_BLOCKS} blocks, least_kv, FaultPlan.chaos(seed=0): trace "
        f"{router.injector.trace}; {st['completed']} done, "
        f"{st['cell_deaths']} cell death, {st['recovered_requests']} "
        f"recovered ({[r.rid for r in recovered]}), {st['guard_trips']} "
        f"guard trips, {st['escalations']} escalations, "
        f"{chaos['transfers']} cross-pool transfers, recovery p95 {p95} "
        f"ticks (limit {MAX_RECOVERY_P95}); {len(untouched)} untouched == "
        f"no-fault run, recovered suffixes == resumed solo runs, the plan "
        f"twice {'identical' if same else 'DIFFERS'}; {st['ticks']} ticks in "
        f"{chaos['run_s']:.3f} s (no-fault {base['stats']['ticks']} ticks in "
        f"{base['run_s']:.3f} s); cell states {st['cell_states']}")
    # one poisoned cross-pool handoff: the first transferred block lands as
    # NaN; the receiving slot's guardrail must trip on its next step
    bad_run = run("pool_block_corrupt",
                  FaultPlan(events=[FaultEvent("pool_block_corrupt")]))
    bs = bad_run["stats"]
    fired = [e for e in bad_run["router"].injector.trace
             if e[1] == "pool_block_corrupt"]
    tripped = sorted(r.rid for r in bad_run["done"] if r.guard_trips)
    fail.check(len(fired) == 1 and bs["guard_trips"] >= 1,
               f"[chaos] pool_block_corrupt: fired {fired}, "
               f"{bs['guard_trips']} guard trips")
    log(f"[chaos] pool_block_corrupt: fired at tick "
        f"{fired[0][0] if fired else None}; guard trips {bs['guard_trips']}"
        f" (requests {tripped}, escalated and completed); health errors "
        f"{bad_run['errors']} ({smi})")
    return dict(
        requests=CHAOS_REQUESTS, blocks=CHAOS_BLOCKS,
        trace=[list(t) for t in router.injector.trace],
        completed=st["completed"], cell_deaths=st["cell_deaths"],
        recovered=[r.rid for r in recovered], guard_trips=st["guard_trips"],
        escalations=st["escalations"], transfers=chaos["transfers"],
        recovery_p95_ticks=p95, deterministic=same, ticks=st["ticks"],
        run_s=chaos["run_s"], no_fault_ticks=base["stats"]["ticks"],
        no_fault_run_s=base["run_s"], launches=chaos["launches"],
        corrupt=dict(fired_tick=fired[0][0] if fired else None,
                     guard_trips=bs["guard_trips"], tripped=tripped,
                     health_errors=bad_run["errors"]))


# ---------------------------------------------------------------------------
# A kernel against its plain version (phase 3 and [arch]).
FLASH_TOL = 2e-5   # abs and rel: the same blocking on both sides, only the
                   # f32 summation order differs (tests/test_mp_attention.py)


def routed_call(fn, *args, **kw):
    """``fn(*args, **kw)`` for a wrapper that counts its launches per
    route, and the route that ran."""
    before = dict(fn.routes)
    out = fn(*args, **kw)
    return out, next(k for k, v in fn.routes.items() if v != before[k])


def mm_tol(ref, K):
    """The repo's f32 accumulation floor (tests/test_kernels.py
    _err_bound): two orders of summing the same exact limb products."""
    rms = ref.pow(2).mean().sqrt()
    return 2e-6 * ref.abs() + 8 * U32 * math.sqrt(K) * rms


def proj_tol(a, ws, fmt, ref, gate="none", biases=None, residual=None):
    """:func:`mm_tol` of a projection, propagated through silu(g) * u
    (|silu'| <= 1.1) plus the f32 rounding of the epilogue when gated."""
    from repro_torch.kernels import mp_matmul

    K = a.shape[-1]
    if gate == "none":
        return mm_tol(ref, K)
    g, u = mp_matmul.fused_proj_plain(a, ws, fmt, biases=biases)
    return (1.1 * u.abs() * mm_tol(g, K)
            + (g / (1 + g.neg().exp())).abs() * mm_tol(u, K)
            + 2e-6 * ref.abs())


@contextlib.contextmanager
def plain_held(fail, tag):
    """While entered, the first launch of each kernel wrapper at each shape,
    format and epilogue, as the models reach them (``kernels.ops``' matmul
    wrappers and the flash wrapper), is held against its plain version on
    the same operands right after it returns, at phase 3's tolerance; a
    disagreement fails ``fail``.  Yields the list of cases held.  It
    launches nothing itself: the plain versions are plain PyTorch."""
    import numpy as np
    import torch

    from repro_torch.core.formats import resolve
    from repro_torch.kernels import mp_attention, mp_matmul, ops

    def sig(x):
        if torch.is_tensor(x):
            return tuple(x.shape)
        if isinstance(x, (tuple, list)):
            return tuple(sig(e) for e in x)
        return getattr(x, "name", x)

    def matmul(plain):
        def check(a, b, fmt, **kw):
            ref = plain(a, b, fmt, **kw)
            if plain is mp_matmul.fused_proj_plain:
                return ref, proj_tol(a, b, resolve(fmt), ref, **kw)
            return ref, mm_tol(ref, a.shape[-1])
        return check

    def flash(q, k, v, mode_qk="M16", mode_pv=None, *, causal=True,
              scale=None, q_offset=0):
        if scale is None:   # the wrapper's default
            scale = 1.0 / float(np.sqrt(q.shape[-1]))
        ref = mp_attention.flash_attention_plain(
            q, k, v, resolve(mode_qk),
            resolve(mode_pv if mode_pv is not None else mode_qk),
            causal=causal, scale=scale, q_offset=q_offset)
        return ref, FLASH_TOL + FLASH_TOL * ref.abs()

    wrappers = (
        (ops, "mp_fused_matmul", matmul(mp_matmul.fused_matmul_plain)),
        (ops, "mp_fused_proj", matmul(mp_matmul.fused_proj_plain)),
        (ops, "mp_prelimbed_matmul", matmul(mp_matmul.prelimbed_matmul_plain)),
        (mp_attention, "mp_flash_attention", flash))
    seen, held, real = set(), [], {}

    class Spy:
        """Stands in for a wrapper: calls it, then holds the result; its
        counters are the wrapper's (a wrapper counts through its module's
        global name, which the spy takes while entered)."""

        def __init__(self, launch, name, check):
            object.__setattr__(self, "_real", (launch, name, check))

        def __getattr__(self, attr):
            return getattr(self._real[0], attr)

        def __setattr__(self, attr, value):
            setattr(self._real[0], attr, value)

        def __call__(self, *args, **kw):
            launch, name, check = self._real
            out = launch(*args, **kw)
            key = (name, sig(args), sig(sorted(kw.items())))
            if key not in seen:
                seen.add(key)
                hold(name, check, out, args, kw)
            return out

    def hold(name, check, out, args, kw):
        # the autotuner's launch parameters change no bit, and the plain
        # versions take none
        kw = {k: v for k, v in kw.items() if k not in ("tune", "block_q")}
        with torch.no_grad():
            ref, tol = check(*args, **kw)
            err = (out - ref).abs()
            bad = int((err > tol).sum())
            case = dict(kernel=name, args=sig(args)[:-1], fmt=sig(args)[-1],
                        max_abs_err=err.max().item(),
                        worst_err_over_tol=(err / tol).max().item(),
                        violations=bad)
        held.append(case)
        fail.check(bad == 0 and bool(torch.isfinite(out).all()),
                   f"{tag}: {name} {case['args']} {case['fmt']} "
                   f"disagrees with its plain version: {bad} elements past "
                   f"the tolerance, max abs {case['max_abs_err']:.3e}")

    try:
        for mod, name, check in wrappers:
            real[mod, name] = getattr(mod, name)
            setattr(mod, name, Spy(real[mod, name], name, check))
        yield held
    finally:
        for (mod, name), launch in real.items():
            setattr(mod, name, launch)


# ---------------------------------------------------------------------------
# [arch]: every model family's serving path at full width.  (arch id,
# depth or None for the config's own, prompts: "main" = [main]'s 8 of
# 64..256 tokens, 32 new; "short" = 2 of 64 tokens, 8 new; "encoder" = one
# forward of 2 x 256 stub frame embeddings)
ARCH_RUNS = (
    ("deepseek-v2-lite-16b", 6, "main"),
    ("mamba2-130m", None, "main"),
    ("zamba2-2.7b", None, "main"),
    ("deepseek-v2-236b", 2, "short"),
    ("minicpm3-4b", 2, "short"),
    ("deepseek-7b", 2, "short"),
    ("mistral-large-123b", 2, "short"),
    ("chatglm3-6b", 2, "short"),
    ("llava-next-34b", 2, "short"),
    ("hubert-xlarge", 2, "encoder"),
)
ARCH_SHORT = (2, 64, 8)   # prompts, tokens each, new tokens
ARCH_FRAMES = (2, 256)    # the encoder's rows x stub frames
FUSED_P_MAX = 1 << 24     # models/attention.py FUSED_P_MAX_ELEMENTS


def arch_forward_launches(cfg, B: int, S: int) -> dict:
    """Kernel launches of one forward of S tokens a row on raw weights
    (a prefill, or the encoder's forward): per attention block the input
    projection group (MLA: the input group, the latent's K/V up-projection,
    ``w_uq`` with a query LoRA) and ``wo``; flash attention, or the
    chunk-scan's QK and PV per chunk pair where B·H·S² passes FUSED_P_MAX;
    per MLP the SwiGLU projection and ``w_down``; per MoE layer the router,
    the three batched expert launches and the shared experts' MLP; per
    Mamba2 layer ``in_proj``, the SSD's four batched products and
    ``out_proj``; the head."""
    fm = fp = fl = 0
    if B * cfg.n_heads * S * S > FUSED_P_MAX:   # the chunk-scan
        a_fl = 0
        attn_fm = 2 * (_n_chunks(S, cfg.attn_q_chunk)
                       * _n_chunks(S, cfg.attn_kv_chunk))
    else:
        a_fl, attn_fm = 1, 0
    if cfg.mla is not None:
        a_fm, a_fp = 1 + (cfg.mla.q_lora > 0), 2
    else:
        a_fm, a_fp = 1, 1
    a_fm += attn_fm
    mlp_fm, mlp_fp = 1, 1
    moe_fm = moe_fp = 0
    if cfg.moe is not None:
        moe_fm = 4 + (cfg.moe.n_shared > 0)
        moe_fp = int(cfg.moe.n_shared > 0)
    L = cfg.n_layers
    if cfg.family in ("dense", "vlm", "audio"):
        fm, fp, fl = L * (a_fm + mlp_fm), L * (a_fp + mlp_fp), L * a_fl
    elif cfg.family == "moe":
        k = cfg.first_k_dense
        fm = k * (a_fm + mlp_fm) + (L - k) * (a_fm + moe_fm)
        fp = k * (a_fp + mlp_fp) + (L - k) * (a_fp + moe_fp)
        fl = L * a_fl
    elif cfg.family == "ssm":
        fm = 6 * L
    elif cfg.family == "hybrid":
        G = L // cfg.hybrid_attn_every
        fm, fp, fl = G * (a_fm + mlp_fm) + 6 * L, G * (a_fp + mlp_fp), G * a_fl
    return {"mp_fused_matmul": fm + 1, "mp_fused_proj": fp,
            "mp_flash_attention": fl}


def arch_decode_launches(cfg) -> dict:
    """Kernel launches of one decode step on pre-limbed params: the
    ``attn`` and ``mlp`` weights of ``layers`` / ``dense_layers`` and the
    head run the pre-limbed kernel, one launch a matrix; GQA decode
    attention its QK and PV; MLA the raw input group (and ``w_uq``) and
    ``w_o`` around the f32 absorbed einsums; MoE the router, three batched
    expert launches and the shared MLP, raw; Mamba2 ``in_proj`` and
    ``out_proj``; the hybrid's shared block raw (its LoRA patches wq / wo)."""
    fm = fp = pl = 0
    L = cfg.n_layers
    if cfg.mla is not None:
        a = dict(fm=1 + (cfg.mla.q_lora > 0), fp=1, pl=0)
    else:
        a = dict(fm=2, fp=0, pl=4)           # qkv, wo pre-limbed; QK, PV
    mlp = dict(fm=0, fp=0, pl=3)
    if cfg.family in ("dense", "vlm"):
        fm, fp, pl = (L * (a[k] + mlp[k]) for k in ("fm", "fp", "pl"))
    elif cfg.family == "moe":
        k = cfg.first_k_dense
        n_sh = int(cfg.moe.n_shared > 0)
        fm = k * (a["fm"] + mlp["fm"]) + (L - k) * (a["fm"] + 4 + n_sh)
        fp = k * (a["fp"] + mlp["fp"]) + (L - k) * (a["fp"] + n_sh)
        pl = k * (a["pl"] + mlp["pl"]) + (L - k) * a["pl"]
    elif cfg.family == "ssm":
        fm = 2 * L
    elif cfg.family == "hybrid":
        G = L // cfg.hybrid_attn_every
        # the shared block: wo, QK, PV, w_down; qkv, swiglu
        fm, fp = G * 4 + 2 * L, G * 2
    return {"mp_fused_matmul": fm, "mp_fused_proj": fp,
            "mp_prelimbed_matmul": pl + 1}


def arch_phase(fail, dev, smi, counts, main_prompts):
    """``[arch]``: each family's serving path at full width: ``generate``
    on pre-limbed weights with launches per prefill and decode step exactly
    the formula; the prefill's last logits and one decode step's logits
    (both engines stepping copies of the same prefilled cache with the same
    tokens) within 4·2^-6 of the ``ref`` backend; every kernel launch of a
    prefill and a decode step held against its plain version at its
    shapes (:func:`plain_held`); the encoder's forward; llava's prefill
    behind its stub patches; the batched expert launch bitwise the
    per-expert launches; each model freed before the next.  Beside each
    reading vs ``ref``, a control: the same prefill with serve_default's
    two M16 classes (``attn_logits``, ``lm_head``) one format lower, at M8,
    which is what a kernel at the wrong format would do."""
    import copy
    import gc

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.kernels import mp_matmul
    from repro_torch.models import multimodal
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    policy = PrecisionPolicy.serve_default()
    control = policy.overlay({"attn_logits": "M8", "lm_head": "M8"})
    zero = dict.fromkeys(kernels.KERNELS, 0)
    rel_tol = 4 * 2.0 ** -6
    out = {}

    def rel_of(got, ref):
        a, b = got.double(), ref.double()
        return ((a - b).norm() / b.norm()).item()

    def vs_ref(tag, got, ref):
        rel = rel_of(got, ref)
        fail.check(bool(torch.isfinite(got).all()) and rel <= rel_tol,
                   f"[arch] {tag}: logits {rel:.3e} from the ref backend "
                   f"(tol {rel_tol:.3e})")
        return rel

    def held_note(row, held, what):
        row[f"held_{what}"] = held
        worst = max(c["worst_err_over_tol"] for c in held)
        return (f"{len(held)} {what} launch shapes held against their plain "
                f"versions (worst err/tol {worst:.3f})")

    def timed_ms(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, res

    for arch, depth, kind in ARCH_RUNS:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = T.init_params(cfg, seed=0, device=dev)
        init_s = time.perf_counter() - t0
        row = dict(family=cfg.family, n_layers=cfg.n_layers,
                   params=cfg.param_count(), init_s=init_s)
        rng = np.random.default_rng(0)
        if kind == "encoder":
            B, S = ARCH_FRAMES
            emb = torch.from_numpy(multimodal.audio_frame_embeds_stub(
                rng, B, S, cfg)).to(dev)
            def fwd(pol=policy):
                return T.forward(params, {"embeds": emb}, cfg, pol)[0]

            with torch.no_grad():
                kernels.reset_launch_counts()
                ms, logits = timed_ms(fwd)
                got = counts()
                want = {**zero, **arch_forward_launches(cfg, B, S)}
                fail.check(got == want, f"[arch] {arch} forward launches "
                           f"{got} != {want}")
                fail.check(tuple(logits.shape) == (B, S, cfg.vocab),
                           f"[arch] {arch} logits {tuple(logits.shape)}")
                with mp_ctx("ref"):
                    ref = fwd()
                rel = vs_ref(f"{arch} forward", logits, ref)
                ctl = rel_of(fwd(control), ref)
                with plain_held(fail, f"[arch] {arch} forward") as held:
                    fwd()
                del ref
                ms, _ = timed_ms(fwd)
            row.update(forward_ms=ms, launches=got, logits_rel_vs_ref=rel,
                       control_rel_vs_ref=ctl, frames_per_s=B * S / ms * 1e3)
            msg = (f"[arch] {arch} ({cfg.family}, {cfg.n_layers} layers, "
                   f"d_model {cfg.d_model}): encoder forward {B} x {S} stub "
                   f"frames {ms:.2f} ms, {row['frames_per_s']:.0f} frames/s, "
                   f"launches {nonzero(got)}, logits vs ref {rel:.3e} "
                   f"(control {ctl:.3e}); "
                   + held_note(row, held, "forward"))
            if on_card:
                busy, _ = device_busy_ms(fwd)
                row.update(busy_ms=busy, idle_share=max(0.0, 1 - busy / ms))
                msg += f", busy {busy:.2f} ms, idle {row['idle_share']:.3f}"
        else:
            if kind == "main":
                prompts = main_prompts
                max_new = 32
            else:
                n, ln, max_new = ARCH_SHORT
                prompts = [rng.integers(1, cfg.vocab, size=ln).astype(
                    np.int64) for _ in range(n)]
            B = len(prompts)
            S = max(len(p) for p in prompts)
            eng = ServeEngine(cfg, params, max_batch=B, max_seq=S + max_new
                              + 8, policy=policy, prelimb_weights=True,
                              device=str(dev))
            kernels.reset_launch_counts()
            g_s, outs = timed_ms(lambda: eng.generate(prompts,
                                                      max_new=max_new))
            g_s /= 1e3
            got = counts()
            pre = arch_forward_launches(cfg, B, S)
            step = arch_decode_launches(cfg)
            want = dict(zero)
            for d, n in ((pre, 1), (step, max_new)):
                for k, v in d.items():
                    want[k] += n * v
            fail.check(got == want, f"[arch] {arch} generate launches "
                       f"{nonzero(got)} != prefill {pre} + {max_new} x "
                       f"step {step}")
            fail.check(len(outs) == B and all(
                len(o) == max_new and all(0 <= t < cfg.vocab for t in o)
                for o in outs), f"[arch] {arch} malformed token streams")
            toks = eng.pad_prompts(prompts)
            pre_ms, (logits, cache) = timed_ms(
                lambda: eng.prefill(toks, eng.make_cache()))
            ref_eng = ServeEngine(cfg, params, max_batch=B,
                                  max_seq=S + max_new + 8, policy=policy,
                                  prelimb_weights=False,
                                  matmul_backend="ref", device=str(dev))
            ctl_eng = ServeEngine(cfg, params, max_batch=B,
                                  max_seq=S + max_new + 8, policy=control,
                                  prelimb_weights=False, device=str(dev))
            tok = logits[:, -1].argmax(-1)[:, None]
            with torch.no_grad():
                with route_log() as ref_routes:
                    ref = ref_eng.prefill(toks, ref_eng.make_cache())[0][:, -1]
                rel = vs_ref(f"{arch} prefill", logits[:, -1], ref)
                ctl = rel_of(ctl_eng.prefill(
                    toks, ctl_eng.make_cache())[0][:, -1], ref)
                del ctl_eng, ref
                with route_log() as routes, \
                        plain_held(fail, f"[arch] {arch} prefill") as held_pre:
                    eng.prefill(toks, eng.make_cache())
                # one decode step of each engine from copies of the same
                # prefilled cache, on the same tokens
                with plain_held(fail, f"[arch] {arch} decode step") as held_dec:
                    step_lg = eng.decode(copy.deepcopy(cache), tok)[0]
                ref = ref_eng.decode(copy.deepcopy(cache), tok)[0]
                d_rel = vs_ref(f"{arch} decode step", step_lg[:, -1],
                               ref[:, -1])
                del ref_eng, ref, step_lg
            if ref_routes:
                # the tokens whose top-k experts differ from the ref
                # backend's, per MoE layer (the router's input carries the
                # M8 layers' rounding): what moves a MoE model's logits
                row["route_flips"] = [
                    int((a.sort(-1).values != b.sort(-1).values).any(-1)
                        .sum()) for a, b in zip(routes, ref_routes)]
            probe = eng.decode_throughput_probe(steps=8)
            row.update(prompts=[len(p) for p in prompts], max_new=max_new,
                       generate_s=g_s, tokens_per_s=B * max_new / g_s,
                       prefill_ms=pre_ms,
                       decode_ms_per_step=probe["ms_per_step"],
                       launches=got, launches_prefill=pre,
                       launches_step=step, logits_rel_vs_ref=rel,
                       control_rel_vs_ref=ctl, decode_rel_vs_ref=d_rel)
            if "route_flips" in row:
                msg_flips = (f"; top-{cfg.moe.top_k} experts differ from "
                             f"ref on {row['route_flips']} of {B * S} "
                             "tokens per MoE layer")
            else:
                msg_flips = ""
            msg = (f"[arch] {arch} ({cfg.family}, {cfg.n_layers} layers, "
                   f"d_model {cfg.d_model}): generate {B} prompts "
                   f"{row['prompts'][0]}..{S} x {max_new} new "
                   f"{row['tokens_per_s']:.1f} tokens/s, prefill "
                   f"{pre_ms:.2f} ms, decode {probe['ms_per_step']:.3f} "
                   f"ms/step; launches prefill {pre} + step {step}; "
                   f"logits vs ref: prefill {rel:.3e} (control "
                   f"{ctl:.3e}), decode step {d_rel:.3e}{msg_flips}; "
                   + held_note(row, held_pre, "prefill") + ", "
                   + held_note(row, held_dec, "decode"))
            if on_card:
                busy, by_name = device_busy_ms(lambda: eng.decode(cache, tok))
                row.update(busy_ms=busy, idle_share=max(
                    0.0, 1 - busy / probe["ms_per_step"]),
                    busy_by_name=dict(list(by_name.items())[:6]))
                msg += (f"; decode step busy {busy:.3f} ms, idle share "
                        f"{row['idle_share']:.3f}")
            if cfg.family == "vlm":
                pe = torch.from_numpy(multimodal.vision_patch_embeds_stub(
                    rng, B, cfg)).to(dev)
                inp = {"tokens": torch.as_tensor(toks, device=dev),
                       "patch_embeds": pe}
                fwd = (lambda: T.forward(params, inp, cfg, policy)[0])
                with torch.no_grad():
                    kernels.reset_launch_counts()
                    v_ms, v_logits = timed_ms(fwd)
                    v_got = counts()
                    v_want = {**zero, **arch_forward_launches(
                        cfg, B, S + cfg.n_patches)}
                    fail.check(v_got == v_want, f"[arch] {arch} patch "
                               f"prefill launches {v_got} != {v_want}")
                    with mp_ctx("ref"):
                        v_ref = fwd()[:, -1]
                    v_rel = vs_ref(f"{arch} patch prefill", v_logits[:, -1],
                                   v_ref)
                row.update(patch_prefill_ms=v_ms, patch_launches=v_got,
                           patch_logits_rel_vs_ref=v_rel)
                msg += (f"; prefill behind {cfg.n_patches} stub patches "
                        f"(S {S + cfg.n_patches}) {v_ms:.2f} ms, launches "
                        f"{nonzero(v_got)}, logits vs ref {v_rel:.3e}")
            if cfg.moe is not None and arch == ARCH_RUNS[0][0]:
                row["experts_bitwise"] = experts_gate(
                    fail, arch, params["layers"][0]["moe"], dev)
            del eng, cache, logits
        if on_card:
            sync()
            row["peak_bytes"] = torch.cuda.max_memory_allocated()
            msg += f"; peak {row['peak_bytes'] / 2**30:.2f} GiB ({smi})"
        log(msg)
        out[arch] = row
        del params
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    # the plain f32 products of the path (MLA's absorbed einsums, the gate
    # combine, the SSM decode, the LoRA patch) ran in true f32
    fail.check(not torch.backends.cuda.matmul.allow_tf32
               and torch.get_float32_matmul_precision() == "highest",
               "[arch] TF32 on for f32 matmuls")
    return out


# ---------------------------------------------------------------------------
# [train-arch]: every model family's training at full width.  The main
# case: deepseek-v2-lite-16b (MLA at Dh 192, 64 experts top-6 + 2 shared,
# vocab 102400) at depth 3 (1 dense + 2 MoE layers; all 27 would hold about
# 250 GB of params, gradients and moments) through Trainer.run; then one
# value-and-grad of each other family (depth None: the config's own).
TRAIN_ARCH = ("deepseek-v2-lite-16b", 3)
TRAIN_ARCH_BATCH, TRAIN_ARCH_SEQ, TRAIN_ARCH_STEPS = 4, 256, 3
TRAIN_ARCH_OTHERS = (("mamba2-130m", None), ("zamba2-2.7b", 12),
                     ("minicpm3-4b", 2), ("llava-next-34b", 2),
                     ("hubert-xlarge", 2))
TRAIN_ARCH_SMALL = (2, 128)   # the other families' rows x tokens (frames)


def train_arch_phase(fail, dev, smi, counts):
    """``[train-arch]``: the main case's step 1 (loss, ``moe_aux``,
    ``moe_zloss`` and every gradient leaf) against the ``ref`` backend at
    ``[train]``'s bounds, each router on ``ref`` routed to the experts
    the card's run picked (``RouteLog.pinning``; the tokens whose own
    top-k differs there counted), with every launch shape held against
    its plain version (:func:`plain_held`: the batched experts' forward,
    dgrad and 3-D wgrad, MLA's flash at Dh 192); launches per step exactly
    :func:`arch_train_launches`; remat on == off and one step twice,
    bitwise; ``TRAIN_ARCH_STEPS`` ``Trainer.run`` steps and a checkpoint
    that restores bitwise; step ms, busy, idle share, tokens/s, peak
    memory.  Then each other family's value-and-grad against ``ref`` with
    its launches of the formula and its launch shapes held."""
    import gc

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs.registry import get_config
    from repro_torch.core import context as context_lib
    from repro_torch.core.classify import all_finite
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as trainer_lib

    sync = torch.cuda.synchronize
    policy = PrecisionPolicy.train_default()
    zero = dict.fromkeys(kernels.KERNELS, 0)
    out = {}

    def pipe_of(cfg, batch, seq):
        return SyntheticLM(DataConfig(
            vocab=cfg.vocab, seq_len=seq + 1, global_batch=batch,
            frontend=cfg.frontend, d_model=cfg.d_model,
            n_patches=cfg.n_patches))

    def positions(cfg, seq):
        return seq + (cfg.n_patches if cfg.family == "vlm" else 0)

    def bitwise(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(tree_lib.leaves(a), tree_lib.leaves(b)))

    # ---- the main case ------------------------------------------------------
    arch, depth = TRAIN_ARCH
    B, S = TRAIN_ARCH_BATCH, TRAIN_ARCH_SEQ
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ck_dir = ROOT / "build" / "train_arch_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    tcfg = trainer_lib.TrainerConfig(total_steps=TRAIN_ARCH_STEPS, warmup=2,
                                     ckpt_dir=str(ck_dir),
                                     ckpt_every=TRAIN_ARCH_STEPS, keep=1)
    trainer = trainer_lib.Trainer(cfg, tcfg, policy=policy, device=dev)
    pipe = pipe_of(cfg, B, S)
    # the params alone while the gradients are compared; the moments come
    # with the steps (Trainer.init_state(seed=0)'s numbers)
    params0 = T.init_params(cfg, seed=0, device=dev)
    batch0 = trainer.to_device(pipe.batch(0))
    per_step = {**zero, **arch_train_launches(cfg, B, S)}
    loss_fn = trainer_lib.make_loss_fn(cfg, policy, tcfg)
    row = dict(arch=arch, n_layers=depth, params=cfg.param_count(),
               batch=B, seq=S, launches_per_step=per_step)

    kernels.reset_launch_counts()
    with plain_held(fail, f"[train-arch] {arch} step") as held:
        (l_k, x_k), g_k = trainer_lib.value_and_grad(loss_fn, params0,
                                                     batch0)
        sync()
    got = counts()
    fail.check(got == per_step, f"[train-arch] {arch} value and grad "
               f"launches {nonzero(got)} != {nonzero(per_step)}")
    # remat's recompute gives the forward's bits (the aux values too); the
    # run without remat records its routing for the ref backend's run
    kernels.reset_launch_counts()
    off = dataclasses.replace(cfg, remat=False)
    off_fn = trainer_lib.make_loss_fn(off, policy, tcfg)
    routes = moe_lib.RouteLog()
    with routes.recording():
        (l_n, x_n), g_n = trainer_lib.value_and_grad(off_fn, params0,
                                                     batch0)
        sync()
    want_off = {**zero, **arch_train_launches(off, B, S, remat=False)}
    got_off = counts()
    same = (torch.equal(l_n, l_k) and all(torch.equal(x_n[k], x_k[k])
                                          for k in x_k) and bitwise(g_n, g_k))
    log(f"[train-arch] remat on == remat off (loss, aux and every "
        f"gradient): {'bitwise' if same else 'DIFFER'}; launches without "
        f"remat {nonzero(got_off)}")
    fail.check(same and got_off == want_off,
               f"[train-arch] remat off: bits or launches "
               f"{nonzero(got_off)} != {nonzero(want_off)}")
    del g_k
    # step 1 on the ref backend, each router routed to the experts the
    # card's run picked (a token whose logits' last bits differ can pick
    # another top-6 there: counted)
    with routes.pinning(), context_lib.context(backend="ref"):
        (l_r, x_r), g_r = trainer_lib.value_and_grad(off_fn, params0,
                                                     batch0)
        sync()
    flips = list(routes.flips)
    loss_rel = abs(l_n.item() - l_r.item()) / abs(l_r.item())
    aux_rel = {k: abs(x_n[k].item() - x_r[k].item()) / abs(x_r[k].item())
               for k in ("nll", "moe_aux", "moe_zloss")}
    leaf = {p: ((a - b).abs().max() / b.abs().max()).item()
            for (p, a), b in zip(tree_lib.items(g_n), tree_lib.leaves(g_r))}
    worst = max(leaf, key=leaf.get)
    worst_held = max(c["worst_err_over_tol"] for c in held)
    log(f"[train-arch] {arch} depth {depth} ({cfg.param_count():,} params), "
        f"batch {B} x {S}, step 1 against the ref backend (routed as on the "
        f"card): loss {l_n.item():.6f} vs {l_r.item():.6f} (rel "
        f"{loss_rel:.3e}, bound 1e-5), nll / moe_aux / moe_zloss rel "
        f"{', '.join(f'{v:.3e}' for v in aux_rel.values())} (moe_aux "
        f"{x_n['moe_aux'].item():.6f}, moe_zloss "
        f"{x_n['moe_zloss'].item():.6f}); worst gradient leaf {worst} "
        f"{leaf[worst]:.3e} of its max (bound 5e-4); tokens whose own top-6 "
        f"on ref differs, per MoE layer: {flips} of {B * S}; "
        f"{len(held)} launch shapes held against their plain versions "
        f"(worst err/tol {worst_held:.3f}); launches {nonzero(got)}")
    fail.check(loss_rel <= 1e-5 and max(aux_rel.values()) <= 1e-5
               and leaf[worst] < 5e-4,
               f"[train-arch] {arch} step 1 disagrees with the ref backend")
    row.update(loss=l_n.item(), loss_ref=l_r.item(), loss_rel=loss_rel,
               extras_rel=aux_rel, worst_leaf=worst,
               worst_leaf_err=leaf[worst], router_flips=flips,
               held=held, moe_aux=x_n["moe_aux"].item(),
               moe_zloss=x_n["moe_zloss"].item())
    del g_r, g_n
    state0 = trainer_lib.TrainState(params0, adamw.init(params0, tcfg.opt))
    # the first step's state kept on the host while the second runs
    s1, m1 = trainer._step_fn(state0, batch0)
    s1 = tree_lib.map_(lambda t: t.cpu(), s1)
    l1 = m1["loss"].cpu()
    del m1
    s2, m2 = trainer._step_fn(state0, batch0)
    twice = torch.equal(l1, m2["loss"].cpu()) and all(
        torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))
        for a, b in zip(tree_lib.leaves(s1), tree_lib.leaves(s2)))
    log(f"[train-arch] one step twice from one state and batch: "
        f"{'bitwise' if twice else 'DIFFER'}")
    fail.check(twice, "[train-arch] one step twice is not bitwise")
    del s1, s2, m2
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    # the run holds the only reference to its initial state, so each step
    # frees the state before it
    start = [state0]
    del state0, params0
    t0 = time.perf_counter()
    state, hist = trainer.run(pipe, num_steps=TRAIN_ARCH_STEPS, log_every=0,
                              state=start.pop())
    sync()
    run_s = time.perf_counter() - t0
    launches = counts()
    want = {k: TRAIN_ARCH_STEPS * v for k, v in per_step.items()}
    fail.check(launches == want, f"[train-arch] Trainer.run launches "
               f"{nonzero(launches)} != {nonzero(want)}")
    fail.check(len(hist) == TRAIN_ARCH_STEPS
               and all(math.isfinite(x) for x in hist)
               and bool(all_finite(state.params)),
               "[train-arch] losses or parameters not finite")
    restored = None
    if ckpt_lib.latest_step(str(ck_dir)) == TRAIN_ARCH_STEPS:
        restored, _ = ckpt_lib.restore(str(ck_dir), TRAIN_ARCH_STEPS, state)
    fail.check(restored is not None and bitwise(restored, state),
               "[train-arch] the checkpoint does not restore the state "
               "bitwise")
    del restored
    shutil.rmtree(ck_dir, ignore_errors=True)
    step_ms = []
    for i in range(2):
        b_ = trainer.to_device(pipe.batch(TRAIN_ARCH_STEPS + i))
        sync()
        t0 = time.perf_counter()
        state, _ = trainer._step_fn(state, b_)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    b_ = trainer.to_device(pipe.batch(TRAIN_ARCH_STEPS + 2))
    busy, by_name = device_busy_ms(lambda: trainer._step_fn(state, b_))
    med = float(np.median(step_ms))
    peak = torch.cuda.max_memory_allocated()
    log(f"[train-arch] Trainer.run {TRAIN_ARCH_STEPS} steps under "
        f"train_default: {run_s:.3f} s, losses "
        f"{[round(x, 5) for x in hist]}, step ms "
        f"{[round(t * 1e3, 2) for t in trainer._step_times]}; checkpoint "
        f"restored bitwise; then step {med:.2f} ms (host clock after "
        f"synchronize, {[round(x, 2) for x in step_ms]}), "
        f"{B * S / med * 1e3:.0f} tokens/s, busy {busy:.2f} ms, idle share "
        f"{max(0.0, 1 - busy / med):.3f}, busy by name "
        f"{dict(list(by_name.items())[:8])}; peak {peak / 2**30:.2f} GiB "
        f"({(peak - base) / 2**30:.2f} above the {base / 2**30:.2f} resident "
        f"before); launches {nonzero(launches)} ({smi})")
    row.update(losses=hist, run_s=run_s, launches=launches,
               run_step_ms=[t * 1e3 for t in trainer._step_times],
               step_ms=step_ms, step_ms_median=med,
               tokens_per_s=B * S / med * 1e3, busy_ms=busy,
               idle_share=max(0.0, 1 - busy / med), busy_by_name=by_name,
               peak_bytes=peak, resident_before_bytes=base)
    out[arch] = row
    del trainer, state, hist, batch0
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the step's new launch shapes, timed --------------------------------
    out["times"] = train_arch_times(cfg, policy, B, S, dev)

    # ---- one value-and-grad of each other family ---------------------------
    B, S = TRAIN_ARCH_SMALL
    for arch, depth in TRAIN_ARCH_OTHERS:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg, seed=0, device=dev)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe_of(cfg, B, S).batch(0).items()}
        want = {**zero, **arch_train_launches(cfg, B, positions(cfg, S))}
        fn = trainer_lib.make_loss_fn(cfg, policy)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with plain_held(fail, f"[train-arch] {arch}") as held:
            _, vs = grads_vs_ref(fail, f"train-arch] [{arch}", fn, params,
                                 batch, sync)
        vg_s = time.perf_counter() - t0
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        worst_held = max(c["worst_err_over_tol"] for c in held)
        log(f"[train-arch] {arch} (depth {cfg.n_layers}, "
            f"{cfg.param_count():,} params, {B} x {positions(cfg, S)} "
            f"positions): launches {nonzero(got)}; {len(held)} launch shapes "
            f"held (worst err/tol {worst_held:.3f}); value-and-grad on the "
            f"card and on ref {vg_s:.1f} s, peak {peak / 2**30:.2f} GiB")
        fail.check(got == want, f"[train-arch] {arch} launches "
                   f"{nonzero(got)} != {nonzero(want)}")
        out[arch] = dict(n_layers=cfg.n_layers, params=cfg.param_count(),
                         launches=got, held=held, peak_bytes=peak, **vs)
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
    fail.check(not torch.backends.cuda.matmul.allow_tf32
               and torch.get_float32_matmul_precision() == "highest",
               "[train-arch] TF32 on for f32 matmuls")
    return out


def train_arch_times(cfg, policy, B: int, S: int, dev) -> dict:
    """Device ms of the main case's new launch shapes beside their plain
    versions and bounds: the batched experts' forward (tokens broadcast
    against (E, D, F)), dgrad ((E, T, F) against the (E, F, D) transposed
    view, read through its strides) and 3-D wgrad (x^T copied to row-major,
    then broadcast as a stride-0 batch against (E, T, F)), at
    ``moe_expert``; MLA's flash attention at Dh 192 at the step's
    ``attn_logits`` / ``attn_pv``.  None has one library call that
    computes it (the limb products at M16)."""
    import torch

    from repro_torch.core.formats import resolve
    from repro_torch.kernels import mp_attention, mp_matmul

    E, D, F = cfg.moe.n_experts, cfg.d_model, cfg.moe.expert_ff
    T = B * S
    gen = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn(T, D, generator=gen, device=dev)
    w = torch.randn(E, D, F, generator=gen, device=dev) * D ** -0.5
    g = torch.randn(E, T, F, generator=gen, device=dev)
    fmt = resolve(policy.mode("moe_expert"))
    rows = {}
    for label, a, b in (
            (f"experts forward ({T},{D}) x ({E},{D},{F})", x, w),
            (f"experts dgrad ({E},{T},{F}) x ({E},{D},{F})^T", g,
             w.transpose(-1, -2)),
            (f"experts wgrad ({T},{D})^T x ({E},{T},{F})", x.t(), g)):
        k_ms, k_ahead = device_ms(
            lambda: mp_matmul.mp_fused_matmul(a, b, fmt), torch)
        p_ms, _ = device_ms(
            lambda: mp_matmul.fused_matmul_plain(a, b, fmt), torch)
        M, K = a.shape[-2:]
        N = b.shape[-1]
        b_ms, b_by = bound(2 * E * M * K * N * fmt.n_products,
                           4 * (a.numel() + b.numel() + E * M * N))
        rows[label] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, fmt=fmt.name, host_ahead=k_ahead)
        log(f"[train-arch] time {label} {fmt.name}: {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library none")
    del x, w, g
    m = cfg.mla
    H, Dh = m.n_heads, m.qk_nope_dim + m.qk_rope_dim
    fq, fp = (resolve(policy.mode(c)) for c in ("attn_logits", "attn_pv"))
    q, k, v = (torch.randn(B, S, H, Dh, generator=gen, device=dev)
               for _ in range(3))
    f_ms, _ = device_ms(lambda: mp_attention.mp_flash_attention(
        q, k, v, fq, fp, causal=True), torch)
    p_ms, _ = device_ms(lambda: mp_attention.flash_attention_plain(
        q, k, v, fq, fp, causal=True, scale=Dh ** -0.5), torch)
    pairs = S * (S + 1) // 2
    b_ms, b_by = bound(2 * B * H * pairs * Dh * (fq.n_products
                                                 + fp.n_products),
                       4 * 4 * q.numel())
    label = f"flash ({B},{S},{H},{Dh}) {fq.name}/{fp.name}"
    rows[label] = dict(ms=f_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"[train-arch] time {label}: {f_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), library none")
    return rows


def experts_gate(fail, arch, moe_params, dev):
    """The batched expert launch (256 tokens against one MoE layer's
    stacked (E, D, F) ``w_gate``, and its (E, F, D) ``w_down`` on the
    batched hidden) bitwise the per-expert launches."""
    import torch

    from repro_torch.core.formats import resolve
    from repro_torch.kernels import mp_matmul

    fmt = resolve("M8")
    w_gate, w_down = moe_params["w_gate"], moe_params["w_down"]
    E, D, F = w_gate.shape
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn(256, D, generator=gen, device=dev)
    h = torch.randn(E, 256, F, generator=gen, device=dev)
    same = True
    for a, w in ((x, w_gate), (h, w_down)):
        batched = mp_matmul.mp_fused_matmul(a, w, fmt)
        for e in range(E):
            one = mp_matmul.mp_fused_matmul(a if a.ndim == 2 else a[e], w[e],
                                            fmt)
            same = same and torch.equal(batched[e].view(torch.int32),
                                        one.view(torch.int32))
    fail.check(same, f"[arch] {arch}: the batched expert launch is not "
               "bitwise the per-expert launches")
    log(f"[arch] {arch}: batched expert launches (256 x {D} vs ({E}, {D}, "
        f"{F}) and ({E}, 256, {F}) vs ({E}, {F}, {D}), M8) == the {E} "
        f"per-expert launches, {'bitwise' if same else 'DIFFER'}")
    return same


@contextlib.contextmanager
def route_log():
    """The top-k expert ids of every MoE router call while entered, in
    call order (``models/moe._route`` wrapped)."""
    from repro_torch.models import moe

    real, ids = moe._route, []

    def spy(*args, **kw):
        top_p, top_i, aux = real(*args, **kw)
        ids.append(top_i.clone())
        return top_p, top_i, aux

    moe._route = spy
    try:
        yield ids
    finally:
        moe._route = real


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def mp_ctx(backend):
    from repro_torch.core import context as context_lib

    return context_lib.context(backend=backend)


# [dist]: the sharded backend across ranks.  Each rank is a spawned process
# (one card each over NCCL where the host has two or more, else two ranks
# sharing the card over gloo); every rank runs the same tasks on the same
# inputs and reports back through a queue.
# ---------------------------------------------------------------------------
DIST_TIMEOUT_S = 600.0     # the process group's and each spawn's deadline
DIST_PV_TOL = {"M8": 5e-3}  # sp decode vs the cuda route, by PV format


def _dist_setup():
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


class CollectiveClock:
    """Host milliseconds spent in the named collectives while entered
    (default ``all_reduce``; ``all_gather``, ``reduce_scatter``: the
    flat-tensor calls of ``dist/collectives.py``; ``all_to_all``, ``send``,
    ``recv``, ``broadcast``), each call timed between
    two synchronizes (so the time is the collective's own, not the
    kernels queued before it): ``ms`` / ``calls`` in all, ``by_name``."""

    def __init__(self, *names):
        self.names = names or ("all_reduce",)

    def _target(self, name):
        import torch.distributed as dist

        from repro_torch.dist import collectives

        return {"all_reduce": (dist, "all_reduce"),
                "all_gather": (collectives, "_ALL_GATHER"),
                "reduce_scatter": (collectives, "_REDUCE_SCATTER"),
                "all_to_all": (dist, "all_to_all_single"),
                "send": (dist, "send"), "recv": (dist, "recv"),
                "broadcast": (dist, "broadcast")}[name]

    def __enter__(self):
        import torch

        self.ms, self.calls = 0.0, 0
        self.by_name = {n: {"ms": 0.0, "calls": 0} for n in self.names}
        self._real = {}
        for name in self.names:
            mod, attr = self._target(name)
            real = self._real[name] = getattr(mod, attr)

            def timed(*args, _real=real, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _real(*args, **kw)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                self.ms += ms
                self.calls += 1
                self.by_name[_name]["ms"] += ms
                self.by_name[_name]["calls"] += 1
                return out

            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(*self._target(name), real)
        return False


def _counts():
    from repro_torch import kernels
    from repro_torch.dist import collectives

    return kernels.launch_counts(), collectives.counts()


def _reset():
    from repro_torch import kernels
    from repro_torch.dist import collectives

    kernels.reset_launch_counts()
    collectives.reset_counts()


def dist_generate(prompts, max_new):
    """Full-width sharded generate: counts per prefill, per decode step and
    per generate, the prefill's last logits, timings; rank 0 also runs the
    cuda engine on the same prompts while the other ranks wait."""
    torch = _dist_setup()
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs import paper_mpfp
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    cfg = paper_mpfp.CONFIG
    params = T.init_params(cfg, seed=0, device="cuda")
    policy = PrecisionPolicy.serve_default()
    eng = ServeEngine(cfg, params, max_batch=8, max_seq=512, policy=policy,
                      matmul_backend="sharded", device="cuda")
    toks = eng.pad_prompts(prompts)
    eng.prefill(toks, eng.make_cache())        # warm-up: gloo's buffers
    torch.cuda.synchronize()
    _reset()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(toks, eng.make_cache())
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = _counts()
    cur = logits[:, -1, :].argmax(dim=-1)[:, None]
    _reset()
    eng.decode(cache, cur)
    torch.cuda.synchronize()
    step = _counts()
    _reset()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=max_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    total = _counts()
    routes = kernels.route_counts()
    plain = kernels.plain_call_counts()
    probe = eng.decode_throughput_probe(steps=8)
    with CollectiveClock() as pre_clock:
        eng.prefill(toks, eng.make_cache())
    with CollectiveClock() as step_clock:   # a warm-up step and 4 more
        eng.decode_throughput_probe(steps=4)
    out = dict(
        tokens=outs, logits=logits[:, -1].float().cpu().numpy(),
        prefill=pre, step=step, total=total, routes=routes, plain=plain,
        gen_s=gen_s,
        tokens_per_s=len(prompts) * max_new / gen_s, prefill_ms=prefill_ms,
        decode_ms_per_step=probe["ms_per_step"],
        decode_tokens_per_s=probe["tokens_per_s"],
        coll_ms_prefill=pre_clock.ms, coll_calls_prefill=pre_clock.calls,
        coll_ms_per_step=step_clock.ms / 5,
        coll_calls_per_step=step_clock.calls / 5)
    del eng, cache
    torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        ref = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                          policy=policy, matmul_backend="cuda", device="cuda")
        ref_logits, _ = ref.prefill(toks, ref.make_cache())
        ref.generate(prompts, max_new=max_new)       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_outs = ref.generate(prompts, max_new=max_new)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        out.update(ref_tokens=ref_outs,
                   ref_logits=ref_logits[:, -1].float().cpu().numpy(),
                   ref_tokens_per_s=len(prompts) * max_new / ref_s,
                   ref_decode_ms_per_step=ref.decode_throughput_probe(
                       steps=8)["ms_per_step"])
        del ref
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def dist_scheduler(prompts, max_new, n_blocks):
    """The continuous scheduler over a sharded engine: paged decode goes
    sequence-parallel."""
    torch = _dist_setup()
    from repro_torch.configs import paper_mpfp
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousScheduler, \
        ScheduledRequest

    cfg = paper_mpfp.CONFIG
    params = T.init_params(cfg, seed=0, device="cuda")
    eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                      policy=PrecisionPolicy.serve_default(),
                      matmul_backend="sharded", device="cuda")
    sched = ContinuousScheduler(eng, n_blocks=n_blocks, block_size=16)
    _reset()
    t0 = time.perf_counter()
    done = sched.run([ScheduledRequest(rid=i, prompt=p, max_new=max_new,
                                       arrival=2 * i)
                      for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    stats = sched.stats()
    return dict(out={r.rid: list(r.out) for r in done}, run_s=run_s,
                counts=_counts(), completed=stats["completed"],
                ticks=stats["steps"], blocks_live=stats["blocks_live"],
                useful_tokens=stats["useful_tokens"])


def dist_sp_decode(lengths):
    """sp_decode_attention at the generate path's decode shapes against the
    cuda route's masked_decode_attention on the same (replicated) inputs."""
    torch = _dist_setup()
    from repro_torch.core import dispatch
    from repro_torch.dist import collectives
    from repro_torch.dist.attention import sp_decode_attention
    from repro_torch.kernels import ref as ref_lib

    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(8, 1, 12, 64, generator=g, device="cuda")
    k = torch.randn(8, 512, 12, 64, generator=g, device="cuda")
    v = torch.randn(8, 512, 12, 64, generator=g, device="cuda")
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out = {}
    for qk, pv in (("M16", "M16"), ("M16", "M8")):
        collectives.reset_counts()
        sp = sp_decode_attention(q, k, v, ln, qk, pv,
                                 dot=ref_lib.dot_nt_in_order)
        calls = collectives.counts()["all_reduce"]["calls"]
        local = dispatch.masked_decode_attention(q, k, v, ln, qk, pv,
                                                 backend="cuda")
        torch.cuda.synchronize()
        zero = [i for i, n in enumerate(lengths) if n == 0]
        out[f"{qk}/{pv}"] = dict(
            max_abs_err=(sp - local).abs().max().item(), calls=calls,
            zeros_exact=all(bool((sp[i] == 0).all()) for i in zero),
            sp=sp.cpu().numpy())
    return out


def dist_pipeline(n_micro):
    """pipeline_forward of the full-width model's 12 layers over the ranks
    (stages) against the sequential loop at 8 x 128."""
    torch = _dist_setup()
    import numpy as np

    from repro_torch.configs import paper_mpfp
    from repro_torch.core import context as context_lib
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import collectives, pipeline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import embed

    cfg = paper_mpfp.CONFIG
    params = T.init_params(cfg, seed=0, device="cuda")
    policy = PrecisionPolicy.serve_default()
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, (8, 128))).cuda()
    h = embed(tokens, params["embed"]["table"])
    pos = torch.arange(128, device="cuda")[None, :]

    def layer_fn(lp, x):
        return T._dense_layer_fwd(lp, x, cfg, policy,
                                  pos.expand(x.shape[0], 128), None)[0]

    world = torch.distributed.get_world_size()
    mesh = mesh_lib.make_debug_mesh(data=1, model=world)
    with torch.no_grad():
        seq = h
        for lp in params["layers"]:
            seq = layer_fn(lp, seq)
        collectives.reset_counts()
        with context_lib.context(backend="sharded"):
            out = pipeline.pipeline_forward(layer_fn, params["layers"], h,
                                            mesh, n_micro=n_micro)
        torch.cuda.synchronize()
    return dict(bitwise=bool(torch.equal(out.view(torch.int32),
                                         seq.view(torch.int32))),
                max_abs_err=(out - seq).abs().max().item(),
                scale=seq.abs().max().item(),
                counts=collectives.counts(),
                digest=float(out.double().sum().item()))


def dist_train(seq, batch):
    """One value-and-grad of the depth-2, full-width model under sharded
    and under cuda."""
    torch = _dist_setup()
    import hashlib

    from repro_torch import tree as tree_lib
    from repro_torch.configs import paper_mpfp
    from repro_torch.core import context as context_lib
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.train import trainer as trainer_lib

    cfg = dataclasses.replace(paper_mpfp.CONFIG, n_layers=2)
    params = T.init_params(cfg, seed=0, device="cuda")
    b = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                               global_batch=batch)).batch(0)
    b = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    loss_fn = trainer_lib.make_loss_fn(cfg, PrecisionPolicy.train_default())
    res = {}
    for backend in ("sharded", "cuda"):
        _reset()
        with context_lib.context(backend=backend):
            (loss, _), grads = trainer_lib.value_and_grad(loss_fn, params, b)
        torch.cuda.synchronize()
        res[backend] = (loss, grads, _counts())
    (ls, gs, cs), (lc, gc, _) = res["sharded"], res["cuda"]
    worst = max(((a - c).abs().max() / c.abs().max()).item()
                for a, c in zip(tree_lib.leaves(gs), tree_lib.leaves(gc)))
    digest = hashlib.sha1()
    for g in tree_lib.leaves(gs):
        digest.update(g.contiguous().view(torch.int32).cpu().numpy()
                      .tobytes())
    return dict(loss=ls.item(), loss_cuda=lc.item(),
                loss_rel=abs(ls.item() - lc.item()) / abs(lc.item()),
                worst_leaf=worst, grads_sha1=digest.hexdigest(),
                counts=cs)


def fsdp_collectives(params, W: int, remat: bool = True) -> dict:
    """Collective calls and bytes (each rank's input) of one training step
    on the FSDP layout over W ranks: all_gather one per sharded leaf in the
    forward and one per sharded layer leaf in remat's recompute (the
    rank's block), reduce_scatter one per sharded leaf (the whole
    cotangent), all_reduce one per replicated leaf (its gradient), the
    clipping norm (4 bytes) and the metrics (loss, nll, params_finite: 3
    floats)."""
    from repro_torch import tree as tree_lib

    sharded, reps = [], []
    for p, x in tree_lib.items(params):
        (sharded if x.ndim and x.shape[-1] % W == 0 else reps).append(
            (p, x.numel() * x.element_size()))
    again = [(p, b) for p, b in sharded if remat and p.startswith("layers/")]
    return {
        "all_gather": {"calls": len(sharded) + len(again),
                       "bytes": sum(b // W for _, b in sharded + again)},
        "reduce_scatter": {"calls": len(sharded),
                           "bytes": sum(b for _, b in sharded)},
        "all_reduce": {"calls": len(reps) + 2,
                       "bytes": sum(b for _, b in reps) + 4 + 3 * 4}}


def dist_fsdp(steps, seq, batch, ck_dir, train_dir):
    """[fsdp]: ``Trainer.run`` of the full-width, full-depth model on the
    FSDP layout of ``make_rules`` on a (data W, model 1) mesh: each rank
    holds its blocks of params and moments and trains on its rows of
    [train]'s batches; the losses, grad norms, launches, routes,
    collectives (calls, bytes, host ms) of the run, the state's resident
    bytes, and on rank 0 the gathered state against the one-rank restore
    of its checkpoint (bitwise) and against [train]'s state after the same
    steps (``train_dir``: each leaf's largest difference over its max)."""
    torch = _dist_setup()
    import hashlib

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs import paper_mpfp
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.dist import fsdp
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs
    from repro_torch.train import trainer as trainer_lib

    cfg = paper_mpfp.CONFIG
    W = dist.get_world_size()
    mesh = mesh_lib.make_debug_mesh(data=W, model=1)
    cell = ShapeCell("fsdp", seq, batch, "train")
    layout = specs.fsdp_layout(cfg, cell, specs.make_rules(mesh, cell, cfg))
    if layout is None:
        raise AssertionError("make_rules gives [fsdp]'s cell no FSDP layout")
    rules = layout.rules
    tcfg = trainer_lib.TrainerConfig(total_steps=TRAIN_STEPS, warmup=2,
                                     ckpt_dir=ck_dir, ckpt_every=steps,
                                     keep=1)
    trainer = trainer_lib.Trainer(cfg, tcfg,
                                  policy=PrecisionPolicy.train_default(),
                                  layout=layout)
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                                  global_batch=batch))
    state0 = trainer.init_state(seed=0)
    storages = {x.untyped_storage().data_ptr(): x.untyped_storage().nbytes()
                for x in tree_lib.leaves(state0)}
    resident = sum(storages.values())
    on_card = all(x.is_cuda for x in tree_lib.leaves(state0))
    real_fn, norms, lrs, step_clock = trainer._step_fn, [], [], []
    clock = CollectiveClock("all_gather", "reduce_scatter", "all_reduce")

    def step_fn(state, b):
        before = {k: v["ms"] for k, v in clock.by_name.items()}
        new, metrics = real_fn(state, b)
        norms.append(float(metrics["grad_norm"]))
        lrs.append(float(metrics["lr"]))
        step_clock.append({k: v["ms"] - before[k]
                           for k, v in clock.by_name.items()})
        return new, metrics

    trainer._step_fn = step_fn
    torch.cuda.synchronize()
    _reset()
    with clock:
        t0 = time.perf_counter()
        state, hist = trainer.run(pipe, num_steps=steps, log_every=0,
                                  state=state0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches, coll = _counts()
    routes, plain = kernels.route_counts(), kernels.plain_call_counts()
    shardings = trainer.state_shardings()
    reps = hashlib.sha1()
    for (p, x), (_, s) in zip(tree_lib.items(state),
                              tree_lib.items(shardings)):
        if not fsdp.is_sharded(s):
            reps.update(p.encode() + _bits(x).cpu().numpy().tobytes())
    gathered = fsdp.full_tree(state, shardings)
    ck_equal = vs_train = None
    if dist.get_rank() == 0:
        like = tree_lib.map_(torch.empty_like, gathered)
        restored, _ = ckpt_lib.restore(ck_dir, steps, like)
        ck_equal = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(
            tree_lib.leaves(restored), tree_lib.leaves(gathered)))
        del restored
        ref, _ = ckpt_lib.restore(train_dir, steps, like)
        # per leaf: bitwise, the largest difference, the reference's max
        vs_train = {}
        for (p, a), b in zip(tree_lib.items(gathered), tree_lib.leaves(ref)):
            diff = (a.double() - b.double()).abs().max().item() if a.numel() \
                else 0.0
            vs_train[p] = (bool(torch.equal(_bits(a), _bits(b))), diff,
                           b.double().abs().max().item() if b.numel() else 0.0)
        del ref, like
    del gathered
    dist.barrier()
    return dict(
        W=W, batch_axes=list(rules.batch_axes), losses=hist, norms=norms,
        rollbacks=trainer.rollbacks, run_s=run_s,
        step_ms=[t * 1e3 for t in trainer._step_times],
        launches=launches, routes=routes, plain=plain, collectives=coll,
        clock=clock.by_name, step_clock=step_clock, resident=resident,
        on_card=on_card,
        layout_bytes=sum(x.numel() * x.element_size()
                         for x in tree_lib.leaves(state)),
        replicated_sha1=reps.hexdigest(), checkpoint_equal=ck_equal,
        vs_train=vs_train,
        lrs=lrs, formula=fsdp_collectives(_meta_params(cfg), W, cfg.remat),
        one_rank_bytes=sum(x.numel() * x.element_size()
                           for x in tree_lib.leaves(_meta_state(cfg))))


def _meta_params(cfg):
    from repro_torch.models import transformer as T

    return T.init_params(cfg, device="meta")


def _meta_state(cfg):
    """A one-rank train state's leaves (f32 moments) on ``meta``."""
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as trainer_lib

    params = _meta_params(cfg)
    return trainer_lib.TrainState(params, adamw.init(params,
                                                     adamw.AdamWConfig()))


def _bits(t):
    """A tensor's bit patterns as integers (bitwise comparison, -0 and NaN
    included)."""
    import torch

    t = t.contiguous().reshape(-1)
    by_size = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(by_size[t.element_size()]) if t.is_floating_point() else t


def dist_restore(ck_dir, step):
    """[train]'s checkpoint restored onto this world's mesh under
    param_shardings: each rank's shard against its slice of the array."""
    torch = _dist_setup()
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs import paper_mpfp
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as trainer_lib

    params = T.init_params(paper_mpfp.CONFIG, seed=0, device="cpu")
    like = trainer_lib.TrainState(params,
                                  adamw.init(params, adamw.AdamWConfig()))
    mesh = mesh_lib.make_matmul_mesh()
    rules = sh.AxisRules(mesh, batch_axes=("data",))
    t0 = time.perf_counter()
    placed, extra = ckpt_lib.restore(ck_dir, step, like,
                                     shardings=sh.param_shardings(like,
                                                                  rules))
    restore_s = time.perf_counter() - t0
    full, _ = ckpt_lib.restore(ck_dir, step, like)
    n = mesh.size(0)
    r = mesh.get_local_rank("data")
    n_sharded = n_leaves = 0
    equal = True
    for (path, d), f in zip(tree_lib.items(placed), tree_lib.leaves(full)):
        n_leaves += 1
        local = d.to_local().cpu()
        if f.ndim and f.shape[-1] % n == 0 and f.shape[-1] >= n:
            n_sharded += 1
            w = f.shape[-1] // n
            want = f[..., r * w:(r + 1) * w]
        else:
            want = f
        equal = equal and local.shape == want.shape and torch.equal(
            _bits(local), _bits(want))
    return dict(equal=equal, n_leaves=n_leaves, n_sharded=n_sharded,
                restore_s=restore_s, extra=extra)


def dist_collectives():
    """hierarchical_psum against flat_psum on CUDA tensors over a
    (pod 2, data 2, model 1) mesh, and the compressed variant's error."""
    torch = _dist_setup()
    from repro_torch.dist import collectives
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_debug_mesh(data=2, model=1, pod=2)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(64, 1024, generator=g, device="cuda")
    collectives.reset_counts()
    h = collectives.hierarchical_psum(x, mesh)
    fl = collectives.flat_psum(x, mesh, ("pod", "data"))
    err0 = torch.zeros(x.numel() // 2, device="cuda")
    out, err = collectives.hierarchical_psum_compressed(x, err0, mesh)
    out2, err2 = collectives.hierarchical_psum_compressed(x, err, mesh)
    torch.cuda.synchronize()
    rel = ((h - fl).norm() / fl.norm()).item()
    return dict(h_vs_flat_max_rel=((h - fl).abs() / fl.abs().clamp_min(
        1e-30)).max().item(), h_vs_flat_norm_rel=rel,
        h_vs_4x=((h - 4 * x).abs().max() / (4 * x).abs().max()).item(),
        compressed_rel=((out - fl).norm() / fl.norm()).item(),
        err_max=err.abs().max().item(),
        compressed_rel_step2=((out2 - fl).norm() / fl.norm()).item(),
        counts=collectives.counts())


# ---------------------------------------------------------------------------
# [ep]: the expert-parallel MoE across four ranks on a (data 2, model 2)
# mesh (gloo, sharing one card; NCCL with a card each): deepseek-v2-lite-16b
# at depth 2 (1 dense + 1 MoE layer of 64 experts, 32 a model rank), full
# width.
EP_DEPTH = 2
EP_BATCH, EP_SEQ = 2, 128             # the value-and-grad: one row a data rank
EP_PROMPTS = (2, 64, 8)               # generate: prompts, tokens each, new


def ep_a2a(cfg, tokens: int, m_size: int, d_size: int,
           capacity_factor=None) -> tuple:
    """(calls, bytes) of ``all_to_all`` in one expert-parallel forward of
    ``tokens`` positions on the split route: per MoE layer and token chunk
    one exchange to the experts' ranks and one back, each of
    ``m_size * (E / m_size) * cap * D`` values in the dispatch dtype, where
    ``cap = ceil(Tc * top_k * capacity_factor / E)`` and Tc the tokens of
    a chunk on one model rank."""
    moe = cfg.moe
    cf = moe.capacity_factor if capacity_factor is None else capacity_factor
    n_moe = cfg.n_layers - cfg.first_k_dense
    tc = tokens // d_size // m_size // max(1, moe.n_chunks)
    cap = max(1, math.ceil(tc * moe.top_k * cf / moe.n_experts))
    size = {"float32": 4, "bfloat16": 2, "float16": 2}[moe.dispatch_dtype]
    calls = n_moe * 2 * max(1, moe.n_chunks)
    return calls, calls * moe.n_experts * cap * moe.d_model * size


def ep_launches(cfg, launches: dict, m_size: int, chunks: int) -> dict:
    """A forward's launches (:func:`arch_forward_launches` or
    :func:`arch_decode_launches`) with each MoE layer's three batched
    expert launches replaced by the expert-parallel path's: three a local
    expert, a token chunk (``chunks``: 1 on the decode route)."""
    e_local = cfg.moe.n_experts // m_size
    n_moe = cfg.n_layers - cfg.first_k_dense
    out = dict(launches)
    out["mp_fused_matmul"] += n_moe * 3 * (e_local * chunks - 1)
    return out


def dist_ep_grad(batch, seq):
    """One value-and-grad of the depth-2 model with the mesh, at a
    capacity factor of E / top_k (it drops nothing), against the one-rank
    all-experts path on rank 0; then a forward at the config's own
    capacity factor, with the share of assignments it drops."""
    torch = _dist_setup()
    import hashlib

    import torch.distributed as dist

    from repro_torch import tree as tree_lib
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.train import trainer as trainer_lib

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              n_layers=EP_DEPTH)
    whole = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    params = T.init_params(cfg, seed=0, device="cuda")
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    b = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq + 1,
                               global_batch=batch)).batch(0)
    b = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    policy = PrecisionPolicy.train_default()
    # aux weight 0 for the comparison: with the mesh the load-balance aux
    # is a mean over the ranks' token slices, without it over all tokens
    tcfg = trainer_lib.TrainerConfig(aux_weight=0.0)
    fn = trainer_lib.make_loss_fn(whole, policy, tcfg, mesh=mesh)
    torch.cuda.synchronize()
    _reset()
    t0 = time.perf_counter()
    (loss, extras), grads = trainer_lib.value_and_grad(fn, params, b)
    torch.cuda.synchronize()
    vg_ms = (time.perf_counter() - t0) * 1e3
    launches, coll = _counts()
    digest = hashlib.sha1()
    for g in tree_lib.leaves(grads):
        digest.update(g.contiguous().view(torch.int32).cpu().numpy()
                      .tobytes())
    res = dict(loss=loss.item(), extras={k: v.item() for k, v in
                                         extras.items()},
               grads_sha1=digest.hexdigest(), launches=launches,
               collectives=coll, vg_ms=vg_ms)
    if dist.get_rank() == 0:
        fd = trainer_lib.make_loss_fn(whole, policy, tcfg)
        (l_d, x_d), g_d = trainer_lib.value_and_grad(fd, params, b)
        torch.cuda.synchronize()
        leaf = {p: ((a - c).abs().max() / c.abs().max()).item()
                for (p, a), c in zip(tree_lib.items(grads),
                                     tree_lib.leaves(g_d))}
        worst = max(leaf, key=leaf.get)
        res.update(loss_whole=l_d.item(),
                   loss_rel=abs(loss.item() - l_d.item()) / abs(l_d.item()),
                   extras_rel={k: abs(extras[k].item() - x_d[k].item())
                               / abs(x_d[k].item())
                               for k in ("nll", "moe_zloss")},
                   worst_leaf=worst, worst_leaf_err=leaf[worst])
        del g_d
    del grads
    torch.cuda.empty_cache()
    dist.barrier()
    keeps, real = [], moe._dispatch_chunk

    def spy(*args, **kw):
        send, keep, buf_idx = real(*args, **kw)
        keeps.append(keep)
        return send, keep, buf_idx

    moe._dispatch_chunk = spy
    try:
        _reset()
        with torch.no_grad():
            logits, aux, _ = T.forward(params, {"tokens": b["tokens"]}, cfg,
                                       policy, mesh=mesh)
        torch.cuda.synchronize()
    finally:
        moe._dispatch_chunk = real
    kept = sum(int(k.sum()) for k in keeps)
    total = sum(k.numel() for k in keeps)
    res.update(dropped_share=1 - kept / total, assignments=total,
               finite=bool(torch.isfinite(logits).all())
               and all(math.isfinite(v.item()) for v in aux.values()),
               own_cf_collectives=_counts()[1])
    return res


def dist_ep_generate(prompts, max_new):
    """ServeEngine(mesh=...).generate at full width at a capacity factor of
    E / top_k (it drops nothing): the prefill on the split route, a decode
    step on the replicated route (counts, last logits), then generate;
    one prefill at the config's own capacity factor (its last logits and
    the share of assignments it drops); rank 0 also runs the one-rank
    engine from the same params on the same tokens while the others
    wait."""
    torch = _dist_setup()
    import numpy as np
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              n_layers=EP_DEPTH)
    whole = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    params = T.init_params(cfg, seed=0, device="cuda")
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    policy = PrecisionPolicy.serve_default()
    max_seq = max(len(p) for p in prompts) + max_new
    out = {}

    def engine(c, m):
        return ServeEngine(c, params, max_batch=len(prompts),
                           max_seq=max_seq, policy=policy, mesh=m,
                           device="cuda")

    def run(eng):
        toks = eng.pad_prompts(prompts)
        eng.prefill(toks, eng.make_cache())     # warm-up: gloo's buffers
        torch.cuda.synchronize()
        _reset()
        t0 = time.perf_counter()
        logits, cache = eng.prefill(toks, eng.make_cache())
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pre = _counts()
        cur = torch.as_tensor(np.asarray([[7], [11]])[:len(prompts)],
                              device="cuda")
        _reset()
        t0 = time.perf_counter()
        step_logits, _ = eng.decode(cache, cur)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        step = _counts()
        _reset()
        t0 = time.perf_counter()
        outs = eng.generate(prompts, max_new=max_new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        return dict(
            tokens=outs, logits=logits[:, -1].float().cpu().numpy(),
            step_logits=step_logits[:, -1].float().cpu().numpy(),
            prefill=pre, step=step, total=_counts(),
            plain=kernels.plain_call_counts(), prefill_ms=prefill_ms,
            step_ms=step_ms, gen_s=gen_s,
            tokens_per_s=len(prompts) * max_new / gen_s)

    out["ep"] = run(engine(whole, mesh))
    torch.cuda.empty_cache()
    keeps, real = [], moe._dispatch_chunk

    def spy(*args, **kw):
        send, keep, buf_idx = real(*args, **kw)
        keeps.append(keep)
        return send, keep, buf_idx

    own = engine(cfg, mesh)
    moe._dispatch_chunk = spy
    try:
        logits, _ = own.prefill(own.pad_prompts(prompts), own.make_cache())
        torch.cuda.synchronize()
    finally:
        moe._dispatch_chunk = real
    out["own_cf"] = dict(
        logits=logits[:, -1].float().cpu().numpy(),
        dropped_share=1 - sum(int(k.sum()) for k in keeps)
        / sum(k.numel() for k in keeps))
    del own
    torch.cuda.empty_cache()
    if dist.get_rank() == 0:
        out["one"] = run(engine(cfg, None))
        torch.cuda.empty_cache()
    dist.barrier()
    return out


# [dlayout]: the decode layout (dist/decode_layout.py) on [ep]'s four ranks
DLAYOUT_STEPS = 8
# task: (batch, cache length, prompt tokens); rows: 8 rows over data, the
# cache's 512 positions over model (blocks of 256: positions 252-259
# cross the boundary); context: batch 1, 2048 positions over (data, model)
# (blocks of 512: block 3 holds no valid position until step 7)
DLAYOUT_CELLS = {"dlayout_rows": (8, 512, 252),
                 "dlayout_context": (1, 2048, 1530)}


def dlayout_formula(cfg, B: int, S: int, W: int = 4) -> dict:
    """A decode step on the layout of ``make_rules`` on a (data 2, model 2)
    mesh, per rank: ``all_gather`` one per parameter leaf whose trailing
    dim divides the batch group (the rank's block; none at batch 1, where
    the parameters are whole), ``all_reduce`` 3 per attention layer (the
    B_loc x H row maxima and exp-sums, the B_loc x H x Dh partial P.V, f32);
    launches of the one-rank step on raw weights (per layer the QKV and
    SwiGLU projections, QK, PV, ``wo``, ``w_down``; the head), every one
    on the cluster route (M <= 16); the resident cache and parameter
    bytes."""
    from repro_torch import tree as tree_lib
    from repro_torch.models import transformer as T

    rows = 2 if B > 1 else 1
    seq = W // rows
    b_loc, L = B // rows, cfg.n_layers
    params = T.init_params(cfg, device="meta")
    shard = [x.numel() * x.element_size() // rows for x in
             tree_lib.leaves(params)
             if rows > 1 and x.ndim and x.shape[-1] % rows == 0]
    whole = [x.numel() * x.element_size() for x in tree_lib.leaves(params)
             if not (rows > 1 and x.ndim and x.shape[-1] % rows == 0)]
    per_layer = 4 * b_loc * cfg.n_heads * (2 + cfg.resolved_head_dim)
    kv = 2 * L * b_loc * (S // seq) * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 2
    return {"all_gather": (len(shard), sum(shard)),
            "all_reduce": (3 * L, L * per_layer),
            "launches": {"mp_fused_matmul": 4 * L + 1,
                         "mp_fused_proj": 2 * L},
            "cache_bytes": kv, "params_bytes": sum(shard) + sum(whole)}


def dist_dlayout(B, S, prompt, steps):
    """[dlayout]: full-width, full-depth paper-mpfp-100m (random weights,
    seed 0) serving on the decode layout of ``make_rules`` on a (data 2,
    model 2) mesh.  Every rank prefills the whole cache on ``cuda`` (the
    same bits on each); rank 0 runs ``steps`` one-rank
    ``make_serve_step`` decode steps on it, greedy, and hands their tokens
    to every rank; then each rank cuts the cache (``shard_cache``), takes
    its parameter blocks, and runs the same steps teacher-forced on
    ``make_serve_step(layout=...)``: its rows' logits, launches, routes,
    plain calls, collectives and host ms in them a step, step ms, its
    resident bytes; rank 0 also the gathered cache against the one-rank
    cache."""
    torch = _dist_setup()
    import numpy as np
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch import tree as tree_lib
    from repro_torch.configs import paper_mpfp
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import decode_layout as dl
    from repro_torch.dist import fsdp
    from repro_torch.dist import sharding as sh_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import make_prefill_step, make_serve_step

    cfg = paper_mpfp.CONFIG
    mesh = mesh_lib.make_debug_mesh(data=2, model=2)
    cell = ShapeCell("dlayout", S, B, "decode")
    rules = specs.make_rules(mesh, cell, cfg)
    layout = specs.decode_layout(cfg, cell, rules)
    if layout is None:
        raise AssertionError("make_rules gives [dlayout]'s cell no layout")
    policy = PrecisionPolicy.serve_default()
    params = T.init_params(cfg, seed=0, device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        1, cfg.vocab, (B, prompt)), device="cuda")
    with torch.no_grad():
        last, cache = make_prefill_step(cfg, policy)(
            params, {"tokens": tokens}, T.make_cache(cfg, B, S,
                                                     device="cuda"))
    toks = torch.zeros((steps, B, 1), dtype=torch.long, device="cuda")
    out = {"coord": tuple(mesh.get_coordinate()),
           "batch_axes": [a for a in rules.batch_axes if a],
           "seq": layout.seq, "seq_block": layout.seq_block}
    one_cache = None
    if dist.get_rank() == 0:
        one_cache = sh_lib.map_cache(lambda n, x: x.clone(), cache)
        one = make_serve_step(cfg, policy)
        cur, one_logits, one_launches = last[:, -1].argmax(-1), [], None
        with torch.no_grad():
            for i in range(steps):
                toks[i, :, 0] = cur
                _reset()
                lg, one_cache = one(params, one_cache, toks[i])
                torch.cuda.synchronize()
                if one_launches is None:
                    one_launches = (nonzero(kernels.launch_counts()),
                                    kernels.route_counts())
                one_logits.append(lg[:, -1].float().cpu().numpy())
                cur = lg[:, -1].argmax(-1)
        out.update(one_logits=np.stack(one_logits),
                   one_launches=one_launches)
    dist.broadcast(toks, 0)
    rows = layout.rows(B)
    lp = (fsdp.shard_tree(params, layout.fsdp.params)
          if layout.fsdp is not None else params)
    local = dl.shard_cache(cache, layout)
    del cache, params
    torch.cuda.empty_cache()
    kv = [x for c in local.attn for x in (c.k, c.v)]
    out["resident"] = {
        "params": sum(x.untyped_storage().nbytes()
                      for x in tree_lib.leaves(lp)),
        "cache": sum(x.untyped_storage().nbytes() for x in kv)}
    out["on_card"] = all(x.is_cuda for x in tree_lib.leaves(lp) + kv)
    step = make_serve_step(cfg, policy, layout=layout)
    warm = sh_lib.map_cache(lambda n, x: x.clone(), local)
    step(lp, warm, toks[0][rows])       # warm-up: gloo's buffers
    del warm
    torch.cuda.synchronize()
    dist.barrier()
    logits, per_step = [], []
    clock = CollectiveClock("all_gather", "all_reduce")
    with clock:
        for i in range(steps):
            before = {k: v["ms"] for k, v in clock.by_name.items()}
            _reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, local = step(lp, local, toks[i][rows])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches, coll = _counts()
            per_step.append(dict(
                ms=ms, launches=nonzero(launches),
                routes=kernels.route_counts(),
                plain=nonzero(kernels.plain_call_counts()),
                collectives={k: (v["calls"], v["bytes"])
                             for k, v in coll.items() if v["calls"]},
                clock={k: v["ms"] - before[k]
                       for k, v in clock.by_name.items()}))
            logits.append(lg[:, -1].float().cpu().numpy())
    out.update(rows=(rows.start, rows.stop), logits=np.stack(logits),
               steps=per_step, length=local.length)
    full = dl.full_cache(local, layout)
    if one_cache is not None:
        # per layer and tensor: the positions the steps did not write
        # bitwise, the written ones bitwise, or their largest difference
        # over the tensor's max
        new = slice(prompt, prompt + steps)
        keep = torch.ones(S, dtype=torch.bool, device="cuda")
        keep[new] = False
        cmp = []
        for l, (a, b) in enumerate(zip(full.attn, one_cache.attn)):
            for name, x, y in (("k", a.k, b.k), ("v", a.v, b.v)):
                cmp.append((l, name,
                            bool(torch.equal(_bits(x[:, keep]),
                                             _bits(y[:, keep]))),
                            bool(torch.equal(_bits(x[:, new]),
                                             _bits(y[:, new]))),
                            ((x[:, new].float() - y[:, new].float()).abs()
                             .max() / y.float().abs().max()).item()))
        out["cache_cmp"] = cmp
    del full, one_cache
    torch.cuda.empty_cache()
    dist.barrier()
    return out


# [ulysses]: the Ulysses layout (dist/seq_layout.py) of the train and
# prefill steps: three cells on [ep]'s four ranks, (data 2, model 2),
# full-width full-depth paper-mpfp-100m (heads mode: 12 heads over 2) and
# mamba2-130m (the SSM's hand-over: 4 chunks of 256 a block), and one on
# three ranks of its own, (data 1, model 3), deepseek-7b at depth 2 at
# full width (seq mode: 32 heads, which 3 does not divide)
ULYSSES_STEPS = 2
# task: (arch, depth (None: the config's), batch, seq, (data, model))
ULYSSES_CELLS = {"ulysses_train": ("paper-mpfp-100m", None, 2, 1024, (2, 2)),
                 "ulysses_prefill": ("paper-mpfp-100m", None, 2, 2048,
                                     (2, 2)),
                 "ulysses_ssm": ("mamba2-130m", None, 2, 2048, (2, 2)),
                 "ulysses_seq": ("deepseek-7b", 2, 1, 3072, (1, 3))}
# the prefill cells that also take a value-and-grad on their tokens
ULYSSES_GRAD = ("ulysses_ssm", "ulysses_seq")
ULYSSES_SEED = 11


def ulysses_cfg(name):
    from repro_torch.configs.registry import get_config

    arch, depth, _, _, _ = ULYSSES_CELLS[name]
    cfg = get_config(arch)
    return cfg if depth is None else dataclasses.replace(cfg,
                                                         n_layers=depth)


def ulysses_batch(cfg, B: int, S: int, step: int = 0) -> dict:
    """A global batch of B rows of S tokens and their labels (numpy seed
    ``ULYSSES_SEED`` + step)."""
    import numpy as np

    rng = np.random.default_rng(ULYSSES_SEED + step)
    return {"tokens": rng.integers(1, cfg.vocab, (B, S)),
            "labels": rng.integers(0, cfg.vocab, (B, S))}


def _seq_pairs(cfg, S: int, M: int) -> tuple:
    """The chunk-scan's (query, kv) chunk pairs a layer of the one-rank
    step at S positions and of a rank's block in seq mode."""
    nk = _n_chunks(S, cfg.attn_kv_chunk)
    return (_n_chunks(S, cfg.attn_q_chunk) * nk,
            _n_chunks(S // M, cfg.attn_q_chunk) * nk)


def ulysses_formula(cfg, B: int, S: int, mesh: tuple, phase: str,
                    m: int = 0) -> dict:
    """A step on the rank at model coordinate ``m`` on the Ulysses layout
    of ``make_rules`` on a (data D, model M) mesh, B rows of S positions
    (b = B / D rows and t = S / M positions a rank), from the code:

    * collectives {name: (calls, bytes handed in)}: the parameters (FSDP
      blocks over data, whole at D = 1): ``all_gather`` one per sharded
      leaf at D > 1 (its block), again per layer leaf in a train step's
      remat recompute; a gradient: ``reduce_scatter`` over data (the whole
      leaf, D > 1), then ``all_reduce`` over model (the block); a train
      step's clipping norm (4 bytes) and metrics (12); attention per layer
      (f32): heads mode 4 ``all_to_all`` of (b, t, H, Dh) a pass (q, k, v,
      the output; forward, recompute, backward), seq mode 2 ``all_gather``
      of K / V's (b, t, Hkv, Dh) a pass (forward, recompute) and their
      ``reduce_scatter`` in the backward (the whole); per Mamba2 layer
      the conv window (b x (d_conv - 1) x conv_dim f32) and the final
      state (b x H x P x N f32) ``send`` to the next block (m < M - 1)
      and ``recv`` from the previous one (m > 0) a forward pass
      (forward, recompute), in the backward the other way; a prefill's
      last logits ``broadcast`` from the last block (b x V f32), and each
      Mamba2 layer's two states;
    * launches: the one-rank formula at the global B x S
      (:func:`arch_forward_launches`, :func:`arch_train_launches`: the
      route and, in heads mode, the chunk pairs), the chunk-scan's query
      chunks in seq mode the rank's block's;
    * resident bytes: the parameters' blocks (and a train step's f32
      moments, + the 0-d step), a prefill's cache blocks (b x t of every
      layer's K / V, bf16; every Mamba2 layer's b rows of both states,
      f32)."""
    from repro_torch import tree as tree_lib
    from repro_torch.models import transformer as T

    D, M = mesh
    b, t, L = B // D, S // M, cfg.n_layers
    H, hk, dh, V = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, \
        cfg.vocab
    train = phase in ("train", "grad")
    items = [(p, x.numel() * x.element_size())
             for p, x in tree_lib.items(T.init_params(cfg, device="meta"))]
    shapes = {p: x.shape for p, x in tree_lib.items(
        T.init_params(cfg, device="meta"))}
    sharded = [(p, n) for p, n in items if shapes[p][-1] % D == 0]
    reps = [(p, n) for p, n in items if shapes[p][-1] % D]
    c = {}

    def add(name, calls, nbytes):
        got = c.get(name, (0, 0))
        c[name] = (got[0] + calls, got[1] + nbytes)

    if D > 1:
        gathered = sharded + ([(p, n) for p, n in sharded
                               if p.startswith("layers/")] if train else [])
        add("all_gather", len(gathered), sum(n // D for _, n in gathered))
    if train:
        if D > 1:
            add("reduce_scatter", len(sharded), sum(n for _, n in sharded))
        add("all_reduce", len(sharded) + len(reps),
            sum(n // D for _, n in sharded) + sum(n for _, n in reps))
        if phase == "train":
            add("all_reduce", 2, 4 + 12)
    n_att = 0 if cfg.family == "ssm" else L
    if n_att and H % M == 0:
        add("all_to_all", 4 * L * (3 if train else 1),
            4 * L * (3 if train else 1) * 4 * b * t * H * dh)
    elif n_att:
        kv = hk if H % M else H
        add("all_gather", 2 * L * (2 if train else 1),
            2 * L * (2 if train else 1) * 4 * b * t * kv * dh)
        if train:
            add("reduce_scatter", 2 * L, 2 * L * M * 4 * b * t * kv * dh)
    states = 0
    if cfg.ssm is not None:
        d = cfg.ssm
        states = 4 * b * ((d.d_conv - 1) * d.conv_dim
                          + d.n_heads * d.head_dim * d.d_state)
        fwd = 2 if train else 1
        nxt, prv = int(m < M - 1), int(m > 0)
        for name, n in (("send", fwd * nxt + train * prv),
                        ("recv", fwd * prv + train * nxt)):
            if n:
                add(name, 2 * L * n, L * states * n)
    if phase == "prefill":
        add("broadcast", 1, 4 * b * V)
        if states:
            add("broadcast", 2 * L, L * states)
    one = (arch_train_launches(cfg, B, S) if train
           else arch_forward_launches(cfg, B, S))
    launches = dict(one)
    if H % M and not launches["mp_flash_attention"]:
        p_one, p_loc = _seq_pairs(cfg, S, M)
        per = 2 * (2 if train else 1) + (4 if train else 0)
        launches["mp_fused_matmul"] -= L * per * (p_one - p_loc)
    params = sum(n // D if shapes[p][-1] % D == 0 else n for p, n in items)
    out = {"collectives": c, "launches": launches, "one_launches": one,
           "params_bytes": params}
    if phase == "train":
        out["state_bytes"] = 3 * params + 4
    if phase == "prefill":
        out["cache_bytes"] = (L * states if cfg.family == "ssm"
                              else 2 * L * b * t * hk * dh * 2)
    return out


def _ulysses_setup(name):
    torch = _dist_setup()
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import specs

    _, _, B, S, (D, M) = ULYSSES_CELLS[name]
    cfg = ulysses_cfg(name)
    mesh = mesh_lib.make_debug_mesh(data=D, model=M)

    def layout_of(phase):
        cell = ShapeCell(name, S, B, phase)
        layout = specs.seq_layout(cfg, cell, specs.make_rules(mesh, cell,
                                                              cfg))
        if layout is None:
            raise AssertionError(f"make_rules gives [ulysses] {name}'s "
                                 f"{phase} cell no Ulysses layout")
        return layout

    return torch, cfg, mesh, layout_of, B, S


def _ulysses_counted(torch, fn, clock):
    """``fn()`` timed (synchronized), its launches, routes, plain calls,
    collectives and the host ms in each collective."""
    from repro_torch import kernels

    before = {k: v["ms"] for k, v in clock.by_name.items()}
    _reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches, coll = _counts()
    return out, dict(
        ms=ms, launches=nonzero(launches),
        routes={k: nonzero(v) for k, v in kernels.route_counts().items()
                if any(v.values())},
        plain=nonzero(kernels.plain_call_counts()),
        collectives={k: (v["calls"], v["bytes"]) for k, v in coll.items()
                     if v["calls"]},
        clock={k: v["ms"] - before[k] for k, v in clock.by_name.items()})


ULYSSES_CLOCKED = ("all_to_all", "all_gather", "reduce_scatter",
                   "all_reduce", "send", "recv", "broadcast")


def _one_rank_counted(torch, fn):
    """The one-rank step's launches and routes (rank 0)."""
    from repro_torch import kernels

    _reset()
    out = fn()
    torch.cuda.synchronize()
    return out, (nonzero(kernels.launch_counts()),
                 {k: nonzero(v) for k, v in kernels.route_counts().items()
                  if any(v.values())})


def _state_sha1(tree) -> str:
    import hashlib

    from repro_torch import tree as tree_lib

    h = hashlib.sha1()
    for p, x in tree_lib.items(tree):
        h.update(p.encode() + _bits(x).cpu().numpy().tobytes())
    return h.hexdigest()


def _grads_worst(got, want) -> tuple:
    """(worst leaf, its largest difference over the leaf's max)."""
    from repro_torch import tree as tree_lib

    worst = ("", 0.0)
    for (p, a), b in zip(tree_lib.items(got), tree_lib.leaves(want)):
        r = ((a.double() - b.double()).abs().max()
             / b.double().abs().max().clamp(min=1e-30)).item()
        if r >= worst[1]:
            worst = (p, r)
    return worst


def dist_ulysses_train(steps):
    """[ulysses] ulysses_train: full-width, full-depth paper-mpfp-100m
    (random weights, seed 0) training on the Ulysses layout of
    ``make_rules`` on a (data 2, model 2) mesh, ``train_default``: the
    first step's forward on every rank's row and block against the
    one-rank forward (rank 0's, broadcast), a value-and-grad against the
    one-rank one (rank 0: loss, every leaf gathered), ``steps``
    ``Trainer.run`` AdamW steps (per step the launches, routes, plain
    calls, collectives and host ms in them, ms) and the state after them
    against ``steps`` one-rank steps (rank 0), the state's digest a rank,
    its resident bytes."""
    torch, cfg, mesh, layout_of, B, S = _ulysses_setup("ulysses_train")
    import torch.distributed as dist

    from repro_torch import tree as tree_lib
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import collectives
    from repro_torch.dist import fsdp
    from repro_torch.dist import seq_layout as sl
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as trainer_lib

    layout = layout_of("train")
    policy = PrecisionPolicy.train_default()
    tcfg = trainer_lib.TrainerConfig(total_steps=TRAIN_STEPS, warmup=2)
    trainer = trainer_lib.Trainer(cfg, tcfg, policy=policy, layout=layout)
    batches = [ulysses_batch(cfg, B, S, i) for i in range(steps)]
    rank0 = dist.get_rank() == 0
    params = T.init_params(cfg, seed=0, device="cuda")
    gb = {k: torch.as_tensor(v, device="cuda") for k, v in batches[0].items()}
    lb = trainer.to_device(batches[0])
    rows, (off, t) = layout.rows(B), layout.block
    out = {"coord": tuple(mesh.get_coordinate()),
           "batch_axes": [a for a in layout.rules.batch_axes if a],
           "seq_axes": list(layout.rules.seq_axes),
           "mode": layout.mode(cfg.n_heads), "rows": (rows.start, rows.stop),
           "block": (off, t)}
    state0 = trainer.init_state(seed=0)
    lp = state0.params
    out["resident"] = sum(x.untyped_storage().nbytes()
                          for x in tree_lib.leaves(state0))
    out["on_card"] = all(x.is_cuda for x in tree_lib.leaves(state0))
    # the first step's forward
    with torch.no_grad():
        with sl.use_seq_layout(layout):
            lg = T.forward(lp, {"tokens": lb["tokens"]}, cfg, policy)[0]
        one = (T.forward(params, {"tokens": gb["tokens"]}, cfg,
                         policy)[0].float().contiguous()
               if rank0 else torch.empty((B, S, cfg.vocab), device="cuda"))
        dist.broadcast(one, 0)
        blk = one[rows, off:off + t]
        out["fwd_bitwise"] = bool(torch.equal(_bits(lg), _bits(blk)))
        out["fwd_rel"] = ((lg - blk).abs().max() / blk.abs().max()).item()
        del one, blk, lg
    # a value-and-grad against the one-rank one
    loss_fn = trainer_lib.make_loss_fn(cfg, policy, tcfg, layout=layout)
    (loss, _), g = trainer_lib.value_and_grad(loss_fn, lp, lb)
    loss = collectives.all_reduce(loss.clone(), layout.metrics_group).item()
    g = fsdp.full_tree(g, layout.params)
    if rank0:
        (one_loss, _), one_g = trainer_lib.value_and_grad(
            trainer_lib.make_loss_fn(cfg, policy, tcfg), params, gb)
        out["loss"], out["one_loss"] = loss, one_loss.item()
        out["loss_rel"] = abs(loss - one_loss.item()) / abs(one_loss.item())
        out["worst_leaf"] = _grads_worst(g, one_g)
        del one_g
    del g
    torch.cuda.empty_cache()
    # the steps
    real_fn, per_step, lrs = trainer._step_fn, [], []
    clock = CollectiveClock(*ULYSSES_CLOCKED)

    def step_fn(state, batch):
        (new, metrics), st = _ulysses_counted(
            torch, lambda: real_fn(state, batch), clock)
        lrs.append(float(metrics["lr"]))
        st["loss"] = float(metrics["loss"])
        st["grad_norm"] = float(metrics["grad_norm"])
        per_step.append(st)
        return new, metrics

    class Batches:
        def batch(self, step):
            return batches[step]

    trainer._step_fn = step_fn
    dist.barrier()
    with clock:
        state, hist = trainer.run(Batches(), num_steps=steps, log_every=0,
                                  state=state0)
    out.update(steps=per_step, lrs=lrs, history=hist,
               state_sha1=_state_sha1(state),
               state_bytes=sum(x.numel() * x.element_size()
                               for x in tree_lib.leaves(state)))
    full = fsdp.full_tree(state, trainer.state_shardings())
    if rank0:
        one_step = trainer_lib.make_train_step(cfg, policy, tcfg)
        one_state = trainer_lib.TrainState(params, adamw.init(params,
                                                              tcfg.opt))
        one_hist = []
        for i, b in enumerate(batches):
            wb = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
            if i == 0:
                (one_state, m), one = _one_rank_counted(
                    torch, lambda: one_step(one_state, wb))
                out["one_launches"] = one
            else:
                one_state, m = one_step(one_state, wb)
            one_hist.append(float(m["loss"]))
        diff = 0.0
        for a, b in zip(tree_lib.leaves(full.params),
                        tree_lib.leaves(one_state.params)):
            diff = max(diff, (a.double() - b.double()).abs().max().item())
        out.update(one_history=one_hist, params_diff=diff)
        del one_state
    del full, state, params
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _cache_tensors(cache) -> list:
    """(path, tensor) of every tensor of a per-layer ``ModelCache``
    (``<group>/<layer>/<field>``: K / V, MLA's latents, the SSM states)."""
    out = []
    for group in ("attn", "dense_attn", "ssm", "shared_attn"):
        for i, c in enumerate(getattr(cache, group) or []):
            for f in dataclasses.fields(c):
                v = getattr(c, f.name)
                if hasattr(v, "is_cuda") and v.ndim:
                    out.append((f"{group}/{i}/{f.name}", v))
    return out


def dist_ulysses_prefill(name="ulysses_prefill"):
    """[ulysses] a prefill on the Ulysses layout (``make_prefill_step(
    layout=...)``): every rank's rows' last logits (the last block's)
    against the one-rank prefill's (rank 0's, broadcast), the gathered
    cache against the one-rank cache (rank 0: per layer and tensor bitwise
    or the largest difference over the max), the counted run's launches,
    routes, plain calls, collectives, host ms in them and ms (after a
    warm-up run), the resident bytes; for the cells of ``ULYSSES_GRAD``
    (deepseek-7b in seq mode, mamba2-130m's SSM hand-over) then a
    value-and-grad on the same tokens against the one-rank one (rank 0:
    the loss, every leaf gathered), with its launches and collectives."""
    torch, cfg, mesh, layout_of, B, S = _ulysses_setup(name)
    import torch.distributed as dist

    from repro_torch import tree as tree_lib
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import collectives
    from repro_torch.dist import decode_layout as dl
    from repro_torch.dist import fsdp
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import make_prefill_step
    from repro_torch.train import trainer as trainer_lib

    layout = layout_of("prefill")
    policy = PrecisionPolicy.serve_default()
    rank0 = dist.get_rank() == 0
    batch = ulysses_batch(cfg, B, S)
    gb = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    rows, (off, t) = layout.rows(B), layout.block
    out = {"coord": tuple(mesh.get_coordinate()),
           "batch_axes": [a for a in layout.rules.batch_axes if a],
           "seq_axes": list(layout.rules.seq_axes),
           "mode": layout.mode(cfg.n_heads), "rows": (rows.start, rows.stop),
           "block": (off, t)}
    lp = fsdp.shard_tree(T.init_params(cfg, seed=0, device="cuda"),
                         layout.params)
    # the one-rank prefill on the whole parameters (rank 0); at data 1 the
    # blocks are the whole leaves
    one_last = torch.empty((B, 1, cfg.vocab), device="cuda")
    one_cache = None
    if rank0:
        whole = (lp if layout.size == 1
                 else T.init_params(cfg, seed=0, device="cuda"))
        with torch.no_grad():
            (last1, one_cache), one = _one_rank_counted(
                torch, lambda: make_prefill_step(cfg, policy)(
                    whole, {"tokens": gb["tokens"]},
                    T.make_cache(cfg, B, S, device="cuda")))
        one_last.copy_(last1.float())
        out["one_launches"] = one
        del whole, last1
    dist.broadcast(one_last, 0)
    local = dl.shard_cache(T.make_cache(cfg, B, S, device="cuda"), layout)
    kv = [x for _, x in _cache_tensors(local)]
    out["resident"] = {
        "params": sum(x.untyped_storage().nbytes()
                      for x in tree_lib.leaves(lp)),
        "cache": sum(x.untyped_storage().nbytes() for x in kv)}
    out["on_card"] = all(x.is_cuda for x in tree_lib.leaves(lp) + kv)
    step = make_prefill_step(cfg, policy, layout=layout)
    inputs = {"tokens": gb["tokens"][rows]}
    step(lp, inputs, local)                  # warm-up: gloo's buffers
    dist.barrier()
    clock = CollectiveClock(*ULYSSES_CLOCKED)
    with clock:
        (last, local), st = _ulysses_counted(
            torch, lambda: step(lp, inputs, local), clock)
    out["prefill"] = st
    want = one_last[rows]
    out["last_bitwise"] = bool(torch.equal(_bits(last), _bits(want)))
    out["last_rel"] = ((last - want).abs().max() / want.abs().max()).item()
    out["length"] = local.length
    full = dl.full_cache(local, layout)
    if one_cache is not None:
        out["cache_cmp"] = [
            (pth, bool(torch.equal(_bits(x), _bits(y))),
             ((x.float() - y.float()).abs().max()
              / y.float().abs().max().clamp(min=1e-30)).item())
            for (pth, x), (_, y) in zip(_cache_tensors(full),
                                        _cache_tensors(one_cache))]
    del full, one_cache, local, kv
    torch.cuda.empty_cache()
    if name in ULYSSES_GRAD:
        tl = layout_of("train")
        lb = {k: v[rows] for k, v in gb.items()}
        loss_fn = trainer_lib.make_loss_fn(cfg, PrecisionPolicy
                                           .train_default(), layout=tl)
        clock = CollectiveClock(*ULYSSES_CLOCKED)
        with clock:
            ((loss, _), g), st = _ulysses_counted(
                torch, lambda: trainer_lib.value_and_grad(loss_fn, lp, lb),
                clock)
        out["grad"] = st
        out["loss"] = collectives.all_reduce(loss.clone(),
                                             tl.metrics_group).item()
        g = fsdp.full_tree(g, tl.params)   # whole leaves (at data 1 as is)
        if not rank0:
            del g
        torch.cuda.empty_cache()
        if rank0:
            whole = (lp if tl.size == 1
                     else T.init_params(cfg, seed=0, device="cuda"))
            ((loss1, _), g1), out["one_grad_launches"] = _one_rank_counted(
                torch, lambda: trainer_lib.value_and_grad(
                    trainer_lib.make_loss_fn(cfg, PrecisionPolicy
                                             .train_default()), whole, gb))
            del whole
            out["one_loss"] = loss1.item()
            out["loss_rel"] = (abs(out["loss"] - loss1.item())
                               / abs(loss1.item()))
            out["worst_leaf"] = _grads_worst(g, g1)
            del g, g1
        dist.barrier()
    del lp
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def ulysses_gates(fail, name, reports, smi) -> dict:
    """[ulysses]'s gates on one cell's reports: the rules (batch over
    ``data``, the sequence over ``model``) and the attention mode; the
    forward's bits on every rank's rows and block (train: the first
    step's logits; a prefill: the last logits on every rank and the
    gathered cache) against the one-rank step's; the loss within 1e-5 and
    every gradient leaf within 5e-4 of its max; after the AdamW steps the
    parameters within ``adamw_drift`` of the one-rank state and the ranks
    holding one block bitwise; a step's collectives, launches and resident
    bytes of :func:`ulysses_formula`, its routes the one-rank step's, no
    plain call; step ms a rank and host ms in the collectives logged."""
    import numpy as np

    label = f"[ulysses] {name}"
    got = _task(fail, label, reports, name)
    if got is None:
        return {}
    _, _, B, S, mesh = ULYSSES_CELLS[name]
    cfg = ulysses_cfg(name)
    r0 = got[0]
    mode = "heads" if cfg.n_heads % mesh[1] == 0 else "seq"
    fail.check(all(r["batch_axes"] == ["data"] and r["seq_axes"] == ["model"]
                   and r["mode"] == mode for r in got),
               f"{label}: rules or mode off (batch over data, the sequence "
               f"over model, {mode} mode)")
    fail.check(sorted(r["block"] for r in got) == sorted(
        (m * S // mesh[1], S // mesh[1]) for _ in range(mesh[0])
        for m in range(mesh[1])), f"{label}: blocks")
    phase = "train" if name == "ulysses_train" else "prefill"
    # the SSM's send / recv depend on the rank's place in the sequence
    want_of = {r["coord"][1]: ulysses_formula(cfg, B, S, mesh, phase,
                                              r["coord"][1]) for r in got}
    want = want_of[r0["coord"][1]]
    mode_txt = f"{mode} mode" if cfg.n_heads else "no attention"
    one_routes = r0["one_launches"][1]

    def step_ok(st, want, one=r0["one_launches"]):
        """The counts of the formula; the launches on the routes the
        one-rank step took (``one``: its launches and routes), no plain
        call."""
        return (st["collectives"] == want["collectives"]
                and st["launches"] == nonzero(want["launches"])
                and one[0] == nonzero(want["one_launches"])
                and set(st["routes"]) == set(one[1])
                and all(set(v) <= set(one[1][k])
                        for k, v in st["routes"].items())
                and not st["plain"])

    out = {"mode": mode, "card": smi}
    if phase == "train":
        fwd = all(r["fwd_bitwise"] for r in got)
        drift = adamw_drift(r0["lrs"])
        by_block = {}
        for r in got:
            by_block.setdefault(r["coord"][0], set()).add(r["state_sha1"])
        same = all(len(v) == 1 for v in by_block.values())
        steps_ok = all(step_ok(st, want_of[r["coord"][1]]) for r in got
                       for st in r["steps"])
        res_ok = all(r["resident"] == r["state_bytes"] == want["state_bytes"]
                     and r["on_card"] for r in got)
        hist_ok = all(r["history"] == r0["history"] for r in got)
        ms = [st["ms"] for r in got for st in r["steps"]]
        coll_ms = {k: float(np.median([st["clock"][k] for r in got
                                       for st in r["steps"]]))
                   for k in ULYSSES_CLOCKED}
        st0 = r0["steps"][0]
        log(f"{label}: paper-mpfp-100m full width and depth, batch {B} x "
            f"{S}, (data, model) {mesh}, {mode} mode, {ULYSSES_STEPS} "
            f"Trainer.run steps (train_default); first forward bitwise the "
            f"one-rank forward on every rank's row and block: {fwd} (max "
            f"{max(r['fwd_rel'] for r in got):.3e} of the max); value and "
            f"grad loss rel {r0['loss_rel']:.3e}, worst leaf "
            f"{r0['worst_leaf'][0]} {r0['worst_leaf'][1]:.3e} of its max "
            f"(bounds 1e-5, 5e-4); after {ULYSSES_STEPS} steps the params "
            f"{r0['params_diff']:.3e} from the one-rank state (adamw_drift "
            f"{drift:.3e}), losses {r0['history']} (one rank "
            f"{r0['one_history']}); ranks of one block bitwise {same}; a "
            f"step's collectives {st0['collectives']} (formula "
            f"{want['collectives']}); launches {st0['launches']} (formula "
            f"{nonzero(want['launches'])}), routes {st0['routes']} (one "
            f"rank {one_routes}), plain {st0['plain']}; resident "
            f"{r0['resident']:,} (formula {want['state_bytes']:,}); step ms "
            f"a rank {min(ms):.1f}-{max(ms):.1f} (median "
            f"{float(np.median(ms)):.1f}), host ms a step (medians) "
            f"{ {k: round(v, 2) for k, v in coll_ms.items() if v} } ({smi})")
        fail.check(fwd, f"{label}: forward logits off the one-rank bits")
        fail.check(r0["loss_rel"] <= 1e-5 and r0["worst_leaf"][1] < 5e-4,
                   f"{label}: loss or gradients off the one-rank step")
        fail.check(r0["params_diff"] <= drift,
                   f"{label}: params off the one-rank state past "
                   f"adamw_drift")
        fail.check(same and hist_ok, f"{label}: ranks of one block differ")
        fail.check(steps_ok,
                   f"{label}: collectives / launches / routes off the "
                   f"formula, or a plain call")
        fail.check(res_ok, f"{label}: resident bytes off the layout")
        out.update(fwd_bitwise=fwd, loss_rel=r0["loss_rel"],
                   worst_leaf=r0["worst_leaf"], params_diff=r0["params_diff"],
                   adamw_drift=drift, same_blocks=same, step_ms=ms,
                   collective_ms=coll_ms, collectives=st0["collectives"],
                   launches=st0["launches"], resident=r0["resident"])
        return out
    last = all(r["last_bitwise"] for r in got)
    cmp = r0["cache_cmp"]
    cache = all(c[1] for c in cmp)
    pre_ok = all(step_ok(r["prefill"], want_of[r["coord"][1]]) for r in got)
    res_ok = all(r["resident"] == {"params": want["params_bytes"],
                                   "cache": want["cache_bytes"]}
                 and r["on_card"] and r["length"] == S for r in got)
    ms = [r["prefill"]["ms"] for r in got]
    coll_ms = {k: float(np.median([r["prefill"]["clock"][k] for r in got]))
               for k in ULYSSES_CLOCKED}
    st0 = r0["prefill"]
    log(f"{label}: {ULYSSES_CELLS[name][0]} depth {cfg.n_layers}, full "
        f"width, "
        f"prefill of {B} x {S} (cache {S}), (data, model) {mesh}, "
        f"{mode_txt} (serve_default): last logits bitwise the one-rank prefill's "
        f"on every rank: {last} (max {max(r['last_rel'] for r in got):.3e} "
        f"of the max); gathered cache bitwise {cache} ({sum(c[1] for c in cmp)}"
        f" of {len(cmp)} layer tensors; worst {max(c[2] for c in cmp):.3e} "
        f"of the max); collectives {st0['collectives']} (formula "
        f"{want['collectives']}); launches {st0['launches']} (formula "
        f"{nonzero(want['launches'])}), routes {st0['routes']} (one rank "
        f"{one_routes}), plain {st0['plain']}; resident {r0['resident']} "
        f"(formula params {want['params_bytes']:,}, cache "
        f"{want['cache_bytes']:,}); prefill ms a rank {min(ms):.1f}-"
        f"{max(ms):.1f}, host ms (medians) "
        f"{ {k: round(v, 2) for k, v in coll_ms.items() if v} } ({smi})")
    fail.check(last, f"{label}: last logits off the one-rank bits")
    fail.check(cache, f"{label}: gathered cache off the one-rank bits")
    fail.check(pre_ok,
               f"{label}: collectives / launches / routes off the formula, "
               f"or a plain call")
    fail.check(res_ok, f"{label}: resident bytes off the layout")
    out.update(last_bitwise=last, cache_bitwise=cache, prefill_ms=ms,
               collective_ms=coll_ms, collectives=st0["collectives"],
               launches=st0["launches"], resident=r0["resident"])
    if name in ULYSSES_GRAD:
        gw_of = {m: ulysses_formula(cfg, B, S, mesh, "grad", m)
                 for m in want_of}
        gw = gw_of[r0["coord"][1]]
        g_ok = all(step_ok(r["grad"], gw_of[r["coord"][1]],
                           r0["one_grad_launches"]) for r in got)
        gms = [r["grad"]["ms"] for r in got]
        log(f"{label}: value-and-grad (train_default) on the same tokens: "
            f"loss rel {r0['loss_rel']:.3e}, worst leaf "
            f"{r0['worst_leaf'][0]} {r0['worst_leaf'][1]:.3e} of its max "
            f"(bounds 1e-5, 5e-4); collectives {r0['grad']['collectives']} "
            f"(formula {gw['collectives']}); launches "
            f"{r0['grad']['launches']} (formula {nonzero(gw['launches'])}); "
            f"ms a rank {min(gms):.1f}-{max(gms):.1f} ({smi})")
        fail.check(r0["loss_rel"] <= 1e-5 and r0["worst_leaf"][1] < 5e-4,
                   f"{label}: loss or gradients off the one-rank step")
        fail.check(g_ok, f"{label}: value-and-grad collectives / launches "
                         f"off the formula, or a plain call")
        out.update(loss_rel=r0["loss_rel"], worst_leaf=r0["worst_leaf"],
                   grad_ms=gms, grad_collectives=r0["grad"]["collectives"])
    return out


def dist_gloo_ops(p2p=False, a2a=False):
    """Which collectives gloo runs on CUDA tensors itself: each op straight
    through ``torch.distributed`` on the world group, the result checked.
    With ``p2p`` only rank 0's send to rank 1, with ``a2a`` only
    ``all_to_all_single`` (a rank that crashes there ends the spawn, so
    each runs alone)."""
    torch = _dist_setup()
    import torch.distributed as dist

    r, w = dist.get_rank(), dist.get_world_size()
    x = torch.arange(8, dtype=torch.float32, device="cuda") + r
    base = torch.arange(8, dtype=torch.float32, device="cuda")
    total = w * base + w * (w - 1) / 2
    out = {}

    def attempt(name, fn, want):
        try:
            got = fn()
            torch.cuda.synchronize()
            out[name] = "right" if torch.equal(got, want) else "wrong"
        except RuntimeError as e:
            out[name] = f"raised: {str(e).splitlines()[0][:120]}"

    def reduced(op):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return y

    def gathered():
        y = torch.empty(8 * w, device="cuda")
        dist.all_gather_into_tensor(y, x)
        return y

    def scattered():
        y = torch.empty(8 // w, device="cuda")
        dist.reduce_scatter_tensor(y, x)
        return y

    def sent():
        y = x.clone() if r == 0 else torch.zeros(8, device="cuda")
        if r == 0:
            dist.send(y, 1)
        elif r == 1:
            dist.recv(y, 0)
        return y

    def exchanged():
        y = torch.empty(8, device="cuda")
        dist.all_to_all_single(y, x)
        return y

    if p2p:
        attempt("send/recv", sent, base if r < 2 else torch.zeros(
            8, device="cuda"))
        return out
    if a2a:   # block j of rank q's x lands as block q of rank j's result
        n = 8 // w
        attempt("all_to_all", exchanged, torch.cat(
            [base[r * n:(r + 1) * n] + q for q in range(w)]))
        return out
    attempt("all_reduce", lambda: reduced(dist.ReduceOp.SUM), total)
    attempt("all_reduce_max", lambda: reduced(dist.ReduceOp.MAX),
            base + w - 1)
    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        return y

    attempt("broadcast", broadcast, base)
    attempt("all_gather", gathered,
            torch.cat([base + q for q in range(w)]))
    attempt("reduce_scatter", scattered,
            total[r * (8 // w):(r + 1) * (8 // w)])
    return out


DIST_TASKS = {"generate": dist_generate, "scheduler": dist_scheduler,
              "sp_decode": dist_sp_decode, "pipeline": dist_pipeline,
              "train": dist_train, "restore": dist_restore,
              "collectives": dist_collectives, "gloo_ops": dist_gloo_ops,
              "fsdp": dist_fsdp,
              "ep_grad": dist_ep_grad, "ep_generate": dist_ep_generate,
              "dlayout_rows": dist_dlayout, "dlayout_context": dist_dlayout,
              "ulysses_train": dist_ulysses_train,
              "ulysses_prefill": dist_ulysses_prefill,
              "ulysses_ssm": dist_ulysses_prefill,
              "ulysses_seq": dist_ulysses_prefill}


def dist_rank(rank, world, init_file, backend, tasks, outq):
    """One spawned rank: join the group, run each task (an exception is
    kept as the task's result), report, leave."""
    import traceback

    out = {}
    try:
        _dist_setup()
        from repro_torch.launch import mesh as mesh_lib

        info = mesh_lib.init_distributed(
            rank, world, init_method=f"file://{init_file}", device="cuda",
            backend=backend, timeout_s=DIST_TIMEOUT_S)
        out["backend"] = info.backend
        for name, kw in tasks:
            t0 = time.perf_counter()
            try:
                out[name] = DIST_TASKS[name](**kw)
            except Exception:  # noqa: BLE001 — reported to the parent
                out[name] = {"error": traceback.format_exc()}
            log(f"[dist] rank {rank}: {name} {time.perf_counter() - t0:.1f} s")
        mesh_lib.shutdown()
    except BaseException:  # noqa: BLE001 — reported, then the rank ends
        out["error"] = traceback.format_exc()
    outq.put((rank, out))


def run_ranks(world: int, tasks, backend=None, timeout=DIST_TIMEOUT_S):
    """Spawn ``world`` ranks running ``tasks``; their reports in rank order.
    A rank that reports a start-up failure, dies or misses the deadline
    fails the call, and every rank still alive is killed."""
    import multiprocessing
    import queue

    ctx = multiprocessing.get_context("spawn")
    (ROOT / "build").mkdir(exist_ok=True)
    init_file = ROOT / "build" / f"dist_rendezvous_{time.time_ns()}"
    outq = ctx.Queue()
    procs = [ctx.Process(target=dist_rank, args=(r, world, str(init_file),
                                                 backend, tasks, outq))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))}"
                                   f" gave no report in {timeout} s")
            try:
                rank, out = outq.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            got[rank] = out
            if "error" in out:
                raise RuntimeError(f"rank {rank} failed:\n{out['error']}")
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == world else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        init_file.unlink(missing_ok=True)
    return [got[r] for r in range(world)]


def _task(fail, label, reports, name):
    """Each rank's result of one task, or None (logged, failed) where a
    rank raised in it."""
    bad = [r for r, rep in enumerate(reports)
           if isinstance(rep.get(name), dict) and "error" in rep[name]]
    for r in bad:
        log(f"[FAIL] {label} rank {r}:\n{reports[r][name]['error']}")
    fail.check(not bad, f"{label} raised on ranks {bad}")
    return None if bad else [rep[name] for rep in reports]


FSDP_STEPS = 3   # [fsdp]: Trainer.run steps on the layout, then a checkpoint


def adamw_drift(lrs) -> float:
    """The most one parameter element of two AdamW runs from the same
    state can differ after steps at ``lrs`` when their gradients differ
    only in rounding: step t's update is lr_t (m̂/(√v̂ + eps) + wd p), and
    |m̂/√v̂| <= R_t = sqrt(Σ_i w_i² / u_i) over the moments' weights
    (Cauchy-Schwarz; w_i the first moment's, u_i the second's, bias
    corrected), so a flipped update moves an element by at most 2 lr_t R_t
    and the decay shrinks the difference already there; plus one f32
    rounding of an element below 2 a step."""
    from repro_torch.optim import adamw

    o = adamw.AdamWConfig()
    d = 0.0
    for t, lr in enumerate(lrs, 1):
        bc1, bc2 = 1 - o.b1 ** t, 1 - o.b2 ** t
        r = math.sqrt(sum(((1 - o.b1) * o.b1 ** (t - i) / bc1) ** 2
                          / ((1 - o.b2) * o.b2 ** (t - i) / bc2)
                          for i in range(1, t + 1)))
        d = d + 2 * lr * r + 2 ** -22
    return d


def fsdp_gates(fail, fs, train, cfg, smi) -> dict:
    """[fsdp]'s gates over the ranks' reports: losses, grad norms and
    replicated leaves bitwise equal on every rank; each loss against
    [train]'s on the same batches (step 1 within 1e-5, later steps 5e-4
    relative); launches per kernel and route of the one-rank step's
    formula, 0 ``strided`` projections, no plain call; collective calls
    and bytes of the formula (the steps' and the checkpoint's gathers);
    resident state bytes the layout's (1/W of each leaf); the checkpoint
    restored on one rank == the gathered state bitwise.  Each grad norm is
    held against [train]'s as the losses are, and the gathered state (params
    and both moments) against [train]'s state
    after the same steps: a reduce-scatter that averaged, or a step that
    lost a rank's rows, moves the norms and the moments where AdamW's
    scale-free update barely moves the losses.  The parameters are held
    within AdamW's drift (:func:`adamw_drift`), which a block in the
    wrong place far exceeds."""
    f0, n = fs[0], FSDP_STEPS
    W = f0["W"]
    same = all(f["losses"] == f0["losses"] and f["norms"] == f0["norms"]
               and f["replicated_sha1"] == f0["replicated_sha1"]
               and f["launches"] == f0["launches"] for f in fs)
    want = train["losses"][:n]
    rel = [abs(a - b) / abs(b) for a, b in zip(f0["losses"], want)]
    log(f"[fsdp] {W} ranks, batch axes {f0['batch_axes']}: losses "
        f"{f0['losses']} vs [train] {want} (rel {[f'{r:.2e}' for r in rel]}"
        f"; bounds 1e-5, then 5e-4); grad norms {f0['norms']}; ranks equal "
        f"(losses, norms, replicated leaves, launches) {same}")
    fail.check(same, "[fsdp] ranks differ")
    fail.check(len(rel) == n and f0["rollbacks"] == 0 and rel[0] <= 1e-5
               and all(r <= 5e-4 for r in rel[1:]),
               "[fsdp] losses off [train]'s")
    want_norms = train["norms"][:n]
    norm_rel = [abs(a - b) / abs(b) for a, b in zip(f0["norms"], want_norms)]
    log(f"[fsdp] grad norms {f0['norms']} vs [train] {want_norms} (rel "
        f"{[f'{r:.2e}' for r in norm_rel]}; bounds 1e-5, then 5e-4)")
    fail.check(len(norm_rel) == n and norm_rel[0] <= 1e-5
               and all(r <= 5e-4 for r in norm_rel[1:]),
               "[fsdp] grad norms off [train]'s")
    # the moments within 5e-4 of each leaf's max of [train]'s; each
    # parameter within the drift AdamW allows two runs whose gradients
    # differ only in rounding (a flipped update of a near-zero gradient
    # moves an element by up to 2 lr R_t; the losses, norms and moments
    # show that they do not differ more)
    vt = f0["vs_train"]
    bound = adamw_drift(f0["lrs"])
    groups = {"params": ("0/", lambda d, mx: d / bound),
              "m": ("1/1/", lambda d, mx: d / max(mx, 1e-30) / 5e-4),
              "v": ("1/2/", lambda d, mx: d / max(mx, 1e-30) / 5e-4)}
    worst, ok = {}, vt.get("1/0", (False,))[0]
    for g, (pre, share) in groups.items():
        shares = {p: share(d, mx) for p, (_, d, mx) in vt.items()
                  if p.startswith(pre)}
        w = max(shares, key=shares.get)
        worst[g] = {"leaf": w, "diff": vt[w][1], "max": vt[w][2],
                    "share_of_bound": shares[w],
                    "bitwise": sum(vt[p][0] for p in shares),
                    "leaves": len(shares)}
        ok = ok and shares[w] <= 1.0
    log(f"[fsdp] the gathered state after {n} steps against [train]'s after "
        f"{n}: the step bitwise {vt.get('1/0', (False,))[0]}; "
        + "; ".join(f"{g} {w['bitwise']} of {w['leaves']} leaves bitwise, "
                    f"worst {w['leaf']} {w['diff']:.3e} (leaf max "
                    f"{w['max']:.3e}), {w['share_of_bound']:.3f} of its "
                    f"bound" for g, w in worst.items())
        + f" (bounds: params {bound:.3e} absolute, AdamW's drift over the "
          f"lrs {f0['lrs']}; m, v 5e-4 of the leaf's max)")
    fail.check(ok, "[fsdp] the state off [train]'s")
    want_launches = {k: n * v for k, v in train["launches_per_step"].items()}
    routes_ok = all(
        f0["routes"][k][r] * TRAIN_STEPS == n * c
        for k, v in train["routes"].items() for r, c in v.items())
    plain = [f["plain"] for f in fs if any(f["plain"].values())]
    log(f"[fsdp] launches {nonzero(f0['launches'])} (want "
        f"{nonzero(want_launches)}); routes "
        f"{ {k: v for k, v in f0['routes'].items() if any(v.values())} }; "
        f"plain calls {plain or 0}")
    fail.check(f0["launches"] == want_launches and routes_ok
               and f0["routes"]["mp_fused_proj"]["strided"] == 0
               and not plain, "[fsdp] launches or routes off the formula")
    per = f0["formula"]
    rs = per["reduce_scatter"]
    want_coll = {
        "all_gather": {"calls": n * per["all_gather"]["calls"]
                       + 3 * rs["calls"],
                       "bytes": n * per["all_gather"]["bytes"]
                       + 3 * rs["bytes"] // W},
        "reduce_scatter": {k: n * v for k, v in rs.items()},
        "all_reduce": {k: n * v for k, v in per["all_reduce"].items()}}
    got_coll = [{k: {c: f["collectives"][k][c] for c in ("calls", "bytes")}
                 for k in want_coll} for f in fs]
    log(f"[fsdp] collectives of {n} steps and the checkpoint "
        f"{got_coll[0]} (want {want_coll}; a step: {per})")
    fail.check(all(g == want_coll for g in got_coll),
               "[fsdp] collectives off the formula")
    step = 4   # the AdamW step counter, int32, on every rank
    want_bytes = (f0["one_rank_bytes"] - step) // W + step
    log(f"[fsdp] resident params + moments a rank "
        f"{[f['resident'] for f in fs]} bytes (the layout's "
        f"{f0['layout_bytes']}, one rank's {f0['one_rank_bytes']} / {W} + "
        f"the step = {want_bytes}); on the card {f0['on_card']}")
    fail.check(all(f["resident"] == f["layout_bytes"] == want_bytes
                   and f["on_card"] for f in fs),
               "[fsdp] resident bytes off the layout's")
    log(f"[fsdp] the checkpoint (rank 0 wrote the global arrays) restored "
        f"on one rank == the gathered state bitwise: "
        f"{f0['checkpoint_equal']}")
    fail.check(f0["checkpoint_equal"] is True, "[fsdp] checkpoint")
    for r, f in enumerate(fs):
        clk = {k: f"{v['ms']:.1f} ms / {v['calls']}"
               for k, v in f["clock"].items()}
        per = {k: [round(c[k], 1) for c in f["step_clock"]]
               for k in f["clock"]}
        log(f"[fsdp] rank {r}: step ms {[round(x, 2) for x in f['step_ms']]}"
            f", host ms in collectives a step {per}; in the run and the "
            f"checkpoint (calls) {clk}; run {f['run_s']:.2f} s ({smi})")
    return dict(W=W, losses=f0["losses"], train_losses=want, loss_rel=rel,
                norms=f0["norms"], train_norms=want_norms, norm_rel=norm_rel,
                vs_train=worst, drift_bound=bound,
                launches=f0["launches"],
                routes=f0["routes"], collectives=got_coll[0],
                collectives_per_step=per,
                step_ms={r: f["step_ms"] for r, f in enumerate(fs)},
                clock={r: f["clock"] for r, f in enumerate(fs)},
                step_clock={r: f["step_clock"] for r, f in enumerate(fs)},
                resident=[f["resident"] for f in fs],
                one_rank_bytes=f0["one_rank_bytes"],
                checkpoint_equal=f0["checkpoint_equal"], card=smi)


def dist_phase(fail, cfg, params, main_prompts, sched_prompts, ck_dir, smi,
               train):
    """[dist]: full-width serving, the scheduler, sequence-parallel decode,
    the pipeline, a training value-and-grad and elastic restore across W
    ranks, then [fsdp] on the same ranks (``train``: [train]'s report, its
    losses and routes on the same batches); the collectives on four; the
    torchrun launcher; one-rank NCCL."""
    import numpy as np
    import torch

    from repro_torch.core.formats import resolve
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import collectives
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve.engine import ServeEngine

    n_dev = torch.cuda.device_count()
    W = min(n_dev, 4) if n_dev >= 2 else 2
    backend = "nccl" if n_dev >= 2 else "gloo"
    L, V, D, H = cfg.n_layers, cfg.padded_vocab, cfg.d_model, cfg.n_heads
    Dh = D // H
    policy = PrecisionPolicy.serve_default()
    new = 32
    sp_lengths = [int(n) + 16 for n in np.linspace(64, 256, 8)]
    sp_lengths[-1] = 0                          # an inactive slot
    tasks = [("generate", dict(prompts=main_prompts, max_new=new)),
             ("scheduler", dict(prompts=sched_prompts, max_new=new,
                                n_blocks=SCHED_BLOCKS)),
             ("sp_decode", dict(lengths=sp_lengths)),
             ("pipeline", dict(n_micro=4)),
             ("train", dict(seq=TRAIN_SEQ, batch=TRAIN_BATCH)),
             ("restore", dict(ck_dir=str(ck_dir), step=TRAIN_STEPS)),
             ("fsdp", dict(steps=FSDP_STEPS, seq=TRAIN_SEQ,
                           batch=TRAIN_BATCH,
                           ck_dir=str(ROOT / "build" / "fsdp_ckpt"),
                           train_dir=train["fsdp_ref_dir"]))]
    t0 = time.perf_counter()
    try:
        reports = run_ranks(W, tasks, backend=backend)
    finally:
        shutil.rmtree(ROOT / "build" / "fsdp_ckpt", ignore_errors=True)
        shutil.rmtree(train["fsdp_ref_dir"], ignore_errors=True)
    ranks_s = time.perf_counter() - t0
    log(f"[dist] {W} ranks over {reports[0]['backend']} "
        f"({'one card each' if n_dev >= 2 else 'sharing one card'}): "
        f"{ranks_s:.1f} s")
    res = {"W": W, "backend": reports[0]["backend"], "ranks_s": ranks_s}

    # ---- sharded generate ---------------------------------------------------
    gen = _task(fail, "[dist] generate", reports, "generate")
    if gen is not None:
        g0 = gen[0]
        fail.check(all(g["tokens"] == g0["tokens"] for g in gen),
                   "[dist] generate: ranks' tokens differ")
        M = 8 * max(len(p) for p in main_prompts)
        fmts = {c: resolve(policy.mode(c)) for c in ("attn_out", "ffn",
                                                     "lm_head")}
        pre_bytes = 4 * M * (L * D * (fmts["attn_out"].n_orders
                                      + fmts["ffn"].n_orders)
                             + V * fmts["lm_head"].n_orders)
        step_bytes = 4 * L * 8 * H * (1 + 1 + Dh)
        want_pre = {"calls": 2 * L + 1, "bytes": pre_bytes}
        want_step = {"calls": 3 * L, "bytes": step_bytes}
        for tag, got, want, part in (
                ("prefill", g0["prefill"], want_pre, 2 * L + 1),
                ("decode step", g0["step"], want_step, 0),
                ("generate", g0["total"],
                 {"calls": want_pre["calls"] + new * want_step["calls"],
                  "bytes": pre_bytes + new * step_bytes},
                 2 * L + 1)):
            ar = got[1]["all_reduce"]
            n_part = got[0]["mp_fused_matmul_partials"]
            log(f"[dist] {tag}: {n_part} partials launches (want {part}), "
                f"{ar['calls']} all-reduces of {ar['bytes']} bytes (want "
                f"{want['calls']} of {want['bytes']}), {ar['staged']} "
                "staged through the host")
            fail.check(n_part == part and ar["calls"] == want["calls"]
                       and ar["bytes"] == want["bytes"],
                       f"[dist] {tag} counts off the formula")
        fail.check(not any(g0["plain"].values()),
                   f"[dist] plain-version calls {g0['plain']}")
        # the prefill's partials: the TMA tile at one limb, the strided
        # tile at more (mp_matmul.fused_route)
        want_routes = dict.fromkeys(("cluster", "tma", "strided"), 0)
        for f, n in ((fmts["attn_out"], L), (fmts["ffn"], L),
                     (fmts["lm_head"], 1)):
            want_routes["tma" if f.n_limbs == 1 else "strided"] += n
        p_routes = g0["routes"]["mp_fused_matmul_partials"]
        log(f"[dist] generate: the partials' routes {p_routes} (want "
            f"{want_routes})")
        fail.check(p_routes == want_routes,
                   "[dist] generate: the partials' routes off the formula")
        a, b = g0["logits"].astype(np.float64), g0["ref_logits"].astype(
            np.float64)
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        rel_tol = 4 * 2.0 ** -6
        top2 = np.sort(b, axis=-1)[:, -2:]
        margin_ok = (top2[:, 1] - top2[:, 0]) > rel_tol * np.abs(b).max()
        first_eq = [g0["tokens"][i][0] == g0["ref_tokens"][i][0]
                    for i in range(8)]
        same_streams = sum(g0["tokens"][i] == g0["ref_tokens"][i]
                           for i in range(8))
        log(f"[dist] generate 8 prompts x {new} new on {W} ranks: "
            f"{g0['gen_s']:.3f} s, {g0['tokens_per_s']:.1f} tokens/s (cuda "
            f"engine on rank 0: {g0['ref_tokens_per_s']:.1f}); prefill "
            f"{g0['prefill_ms']:.1f} ms (all-reduces {g0['coll_ms_prefill']:.1f}"
            f" ms host), decode {g0['decode_ms_per_step']:.3f} ms/step (cuda "
            f"{g0['ref_decode_ms_per_step']:.3f}; all-reduces "
            f"{g0['coll_ms_per_step']:.3f} ms/step host); prefill logits vs "
            f"the cuda engine rel {rel:.3e} (tol {rel_tol:.3e}); first tokens"
            f" equal {sum(first_eq)}/8 ({int(margin_ok.sum())} with a margin "
            f"above the bound), streams equal {same_streams}/8 ({smi})")
        fail.check(rel <= rel_tol and np.isfinite(a).all(),
                   "[dist] prefill logits disagree with the cuda engine")
        fail.check(all(e for e, m in zip(first_eq, margin_ok) if m),
                   "[dist] a first token with a clear margin differs")
        res["generate"] = {k: v for k, v in g0.items()
                           if k not in ("logits", "ref_logits", "tokens",
                                        "ref_tokens")}
        res["generate"].update(logits_rel_vs_cuda=rel,
                               first_equal=sum(first_eq),
                               margin_ok=int(margin_ok.sum()),
                               streams_equal=same_streams,
                               launches=g0["total"][0])

    # ---- the scheduler --------------------------------------------------------
    sch = _task(fail, "[dist] scheduler", reports, "scheduler")
    if sch is not None:
        s0 = sch[0]
        fail.check(all(s["out"] == s0["out"] for s in sch),
                   "[dist] scheduler: ranks' streams differ")
        ok = (s0["completed"] == len(sched_prompts) and s0["blocks_live"] == 0
              and all(len(o) == new for o in s0["out"].values()))
        ar = s0["counts"][1]["all_reduce"]
        log(f"[dist] scheduler {len(sched_prompts)} requests: {s0['ticks']} "
            f"ticks, {s0['run_s']:.3f} s, {s0['useful_tokens'] / s0['run_s']:.1f}"
            f" tokens/s, {ar['calls']} all-reduces ({ar['staged']} staged), "
            f"partials launches {s0['counts'][0]['mp_fused_matmul_partials']},"
            f" paged kernel launches {s0['counts'][0]['mp_paged_attention']}")
        fail.check(ok, "[dist] scheduler: a request unfinished or a block "
                       "leaked")
        fail.check(s0["counts"][0]["mp_paged_attention"] == 0 and ar["calls"]
                   > 0, "[dist] scheduler: paged decode did not go "
                        "sequence-parallel")
        res["scheduler"] = {k: v for k, v in s0.items() if k != "out"}

    # ---- sp decode ---------------------------------------------------------------
    sp = _task(fail, "[dist] sp_decode", reports, "sp_decode")
    if sp is not None:
        res["sp_decode"] = {}
        for key, r0 in sp[0].items():
            tol = DIST_PV_TOL.get(key.split("/")[1], 2e-5)
            same = all(np.array_equal(r[key]["sp"], r0["sp"]) for r in sp)
            log(f"[dist] sp_decode_attention (8, 1, 12, 64) vs (8, 512) "
                f"{key}: max abs err vs the cuda route {r0['max_abs_err']:.3e}"
                f" (tol {tol:.0e}), {r0['calls']} all-reduces, length-0 slot"
                f" exact zeros {r0['zeros_exact']}, ranks equal {same}")
            fail.check(r0["max_abs_err"] <= tol and r0["calls"] == 3
                       and r0["zeros_exact"] and same,
                       f"[dist] sp_decode {key}")
            res["sp_decode"][key] = {k: v for k, v in r0.items() if k != "sp"}

    # ---- the pipeline -------------------------------------------------------------
    pp = _task(fail, "[dist] pipeline", reports, "pipeline")
    if pp is not None:
        p0 = pp[0]
        c = p0["counts"]
        log(f"[dist] pipeline_forward {L} layers over {W} stages, n_micro 4, "
            f"8 x 128: bitwise the sequential forward {p0['bitwise']} (max "
            f"abs {p0['max_abs_err']:.3e} of {p0['scale']:.3e}); sends "
            f"{[r['counts']['send']['calls'] for r in pp]}, staged "
            f"{c['send']['staged'] + c['recv']['staged']}, all-reduces "
            f"{c['all_reduce']['calls']}")
        fail.check(p0["bitwise"] and all(r["digest"] == p0["digest"]
                                         for r in pp)
                   and c["all_reduce"]["calls"] == 0,
                   "[dist] pipeline forward is not the sequential forward")
        res["pipeline"] = dict(bitwise=p0["bitwise"],
                               max_abs_err=p0["max_abs_err"],
                               counts=[r["counts"] for r in pp])

    # ---- training -------------------------------------------------------------------
    tr = _task(fail, "[dist] train", reports, "train")
    if tr is not None:
        t0_ = tr[0]
        same = all(r["loss"] == t0_["loss"] and
                   r["grads_sha1"] == t0_["grads_sha1"] for r in tr)
        ar = t0_["counts"][1]["all_reduce"]
        log(f"[dist] train value-and-grad, depth 2, 8 x 128: loss "
            f"{t0_['loss']:.6f} vs cuda {t0_['loss_cuda']:.6f} (rel "
            f"{t0_['loss_rel']:.3e}), worst leaf {t0_['worst_leaf']:.3e} of "
            f"its max; ranks equal (loss, gradients) {same}; {ar['calls']} "
            f"all-reduces, partials launches "
            f"{t0_['counts'][0]['mp_fused_matmul_partials']}")
        fail.check(same and t0_["loss_rel"] <= 1e-5
                   and t0_["worst_leaf"] < 5e-4,
                   "[dist] sharded training disagrees")
        res["train"] = t0_

    # ---- elastic restore ------------------------------------------------------------
    rs = _task(fail, "[dist] restore", reports, "restore")
    if rs is not None:
        log(f"[dist] elastic restore of [train]'s checkpoint onto {W} "
            f"ranks: {rs[0]['n_leaves']} leaves, {rs[0]['n_sharded']} "
            f"sharded, every rank's shard == its slice bitwise "
            f"{[r['equal'] for r in rs]}, {rs[0]['restore_s']:.1f} s")
        fail.check(all(r["equal"] for r in rs) and rs[0]["n_sharded"] > 0,
                   "[dist] elastic restore")
        res["restore"] = rs[0]

    # ---- [fsdp]: the training step on the FSDP layout ------------------------------
    fs = _task(fail, "[fsdp]", reports, "fsdp")
    if fs is not None:
        res["fsdp"] = fsdp_gates(fail, fs, train, cfg, smi)

    # ---- collectives on four ranks --------------------------------------------------
    t0 = time.perf_counter()
    four = run_ranks(4, [("collectives", {})],
                     backend="nccl" if n_dev >= 4 else "gloo")
    co = _task(fail, "[dist] collectives", four, "collectives")
    if co is not None:
        c0 = co[0]
        staged = {k: v["staged"] for k, v in c0["counts"].items()
                  if v["staged"]}
        log(f"[dist] hierarchical_psum on 4 ranks ({four[0]['backend']}, "
            f"(pod 2, data 2, model 1), CUDA tensors): vs flat_psum max rel "
            f"{c0['h_vs_flat_max_rel']:.3e}, vs 4x {c0['h_vs_4x']:.3e}; "
            f"compressed rel {c0['compressed_rel']:.3e} then "
            f"{c0['compressed_rel_step2']:.3e} with the error carried (max "
            f"{c0['err_max']:.3e}); staged through the host {staged} "
            f"({time.perf_counter() - t0:.1f} s)")
        fail.check(c0["h_vs_flat_max_rel"] <= 1e-6 and c0["h_vs_4x"] <= 1e-6
                   and c0["compressed_rel"] < 0.03 and c0["err_max"] > 0,
                   "[dist] hierarchical collectives")
        res["collectives"] = c0

    # ---- which ops gloo runs on CUDA tensors: the staged set's evidence --------------
    if n_dev < 4:
        from repro_torch.dist.collectives import GLOO_HOST_STAGED

        ops = run_ranks(2, [("gloo_ops", {})], backend="gloo",
                        timeout=180)[0]["gloo_ops"]
        for flag, key in (("p2p", "send/recv"), ("a2a", "all_to_all")):
            try:
                ops.update(run_ranks(2, [("gloo_ops", {flag: True})],
                                     backend="gloo",
                                     timeout=60)[0]["gloo_ops"])
            except (RuntimeError, TimeoutError) as err:  # died or hung
                ops[key] = f"failed: {str(err).splitlines()[0][:200]}"
        refused = set()
        for k, v in ops.items():
            if v != "right":
                refused |= {"send", "recv"} if k == "send/recv" else {k}
        log(f"[dist] gloo on CUDA tensors, each op run natively on 2 ranks: "
            f"{ops}; staged through the host by dist/collectives.py: "
            f"{sorted(GLOO_HOST_STAGED)}")
        fail.check(refused == set(GLOO_HOST_STAGED),
                   f"[dist] gloo refuses {sorted(refused)}, "
                   f"dist/collectives.py stages {sorted(GLOO_HOST_STAGED)}")
        res["gloo_ops"] = ops

    # ---- the launcher under torchrun ------------------------------------------------
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(W), "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "repro_torch.launch.serve", "--backend", "sharded",
         "--requests", "8", "--max-new", str(new), "--max-seq", "512"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("req")]
    log(f"[dist] torchrun --nproc-per-node {W} -m repro_torch.launch.serve "
        f"--backend sharded: rc {run.returncode}, {len(lines)} streams, "
        f"{time.perf_counter() - t0:.1f} s")
    if run.returncode != 0:
        log(run.stdout[-3000:])
        log(run.stderr[-3000:])
    fail.check(run.returncode == 0 and len(lines) == 8,
               "[dist] the launcher under torchrun")
    res["torchrun"] = dict(rc=run.returncode, streams=len(lines))

    # ---- one rank over NCCL -----------------------------------------------------------
    info = mesh_lib.init_distributed(
        0, 1, init_method=f"file://{ROOT / 'build'}/nccl_{time.time_ns()}",
        device="cuda", backend="nccl", timeout_s=120)
    try:
        collectives.reset_counts()
        one = collectives.all_reduce(torch.ones(4, device="cuda"),
                                     torch.distributed.group.WORLD)
        e_s = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                          policy=policy, matmul_backend="sharded")
        e_c = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                          policy=policy, matmul_backend="cuda")
        toks = e_s.pad_prompts(main_prompts)
        l_s, _ = e_s.prefill(toks, e_s.make_cache())
        l_c, _ = e_c.prefill(toks, e_c.make_cache())
        o_s = e_s.generate(main_prompts, max_new=8)
        o_c = e_c.generate(main_prompts, max_new=8)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(l_s.view(torch.int32),
                                   l_c.view(torch.int32))) and o_s == o_c
        log(f"[dist] one rank over {info.backend}: all-reduce "
            f"{one.tolist()}; sharded engine == cuda engine bitwise "
            f"(prefill logits, 8 x 8 tokens) {bitwise}")
        fail.check(info.backend == "nccl" and bitwise
                   and one.tolist() == [1.0] * 4,
                   "[dist] one-rank NCCL: sharded != cuda")
        res["nccl_one_rank"] = dict(backend=info.backend, bitwise=bitwise)
        del e_s, e_c
    finally:
        mesh_lib.shutdown()
    torch.cuda.empty_cache()
    return res


def dlayout_gates(fail, name, reports, smi) -> dict:
    """[dlayout]'s gates on one cell's reports: every rank's rows' logits
    within 4·2^-6 (in the norm) of the one-rank step's, its greedy tokens
    the one-rank tokens wherever their top-2 margin passes that bound of
    the row's largest logit, the ranks of the same rows bitwise; the
    gathered cache against the one-rank cache (the positions not written
    and the first layer's writes bitwise: the same projections of the same
    inputs on the same routes; the later layers' writes within 4·2^-6 of
    the tensor's max: their inputs passed the sequence-parallel softmax);
    a step's collectives, launches and routes of :func:`dlayout_formula`,
    no plain call; the resident bytes the layout's, on the card."""
    import numpy as np

    from repro_torch.configs import paper_mpfp

    got = _task(fail, f"[dlayout] {name}", reports, name)
    if got is None:
        return {}
    B, S, prompt = DLAYOUT_CELLS[name]
    cfg = paper_mpfp.CONFIG
    want = dlayout_formula(cfg, B, S)
    r0 = got[0]
    one = r0["one_logits"]                          # (steps, B, V)
    rel_tol = 4 * 2.0 ** -6
    rel, tok_ok, compared = [], True, 0
    for r in got:
        rows = slice(*r["rows"])
        for i in range(DLAYOUT_STEPS):
            a, b = r["logits"][i], one[i][rows]
            rel.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
            top2 = np.sort(b, -1)[:, -2:]
            live = top2[:, 1] - top2[:, 0] > rel_tol * np.abs(b).max(-1)
            compared += int(live.sum())
            tok_ok &= bool((a.argmax(-1) == b.argmax(-1))[live].all())
    same_rows = all(np.array_equal(r["logits"], q["logits"])
                    for r in got for q in got if r["rows"] == q["rows"])
    cmp = r0["cache_cmp"]
    kept = all(c[2] for c in cmp)
    first = all(c[3] for c in cmp if c[0] == 0)
    later = max(c[4] for c in cmp)
    n_bitwise = sum(c[3] for c in cmp)
    coll_ok = launch_ok = True
    for r in got:
        for st in r["steps"]:
            coll = st["collectives"]
            coll_ok &= (coll.get("all_gather", (0, 0))
                        == want["all_gather"]
                        and coll.get("all_reduce", (0, 0))
                        == want["all_reduce"]
                        and set(coll) <= {"all_gather", "all_reduce"})
            routes = {k: nonzero(v) for k, v in st["routes"].items()
                      if any(v.values())}
            launch_ok &= (st["launches"] == want["launches"]
                          and routes == {k: {"cluster": n} for k, n in
                                         want["launches"].items()}
                          and not st["plain"])
    one_routes = {k: nonzero(v) for k, v in r0["one_launches"][1].items()
                  if any(v.values())}
    launch_ok &= (r0["one_launches"][0] == want["launches"]
                  and one_routes == {k: {"cluster": n} for k, n in
                                     want["launches"].items()})
    res_ok = all(r["resident"] == {"params": want["params_bytes"],
                                   "cache": want["cache_bytes"]}
                 and r["on_card"] for r in got)
    ms = [st["ms"] for r in got for st in r["steps"]]
    coll_ms = {k: [st["clock"][k] for r in got for st in r["steps"]]
               for k in ("all_gather", "all_reduce")}
    st0 = r0["steps"][0]
    log(f"[dlayout] {name}: paper-mpfp-100m full width and depth, batch "
        f"{B}, cache {S}, prompt {prompt}, {DLAYOUT_STEPS} steps "
        f"teacher-forced on the one-rank greedy tokens; rules batch "
        f"{r0['batch_axes']}, cache sequence over {r0['seq']} (blocks "
        f"{sorted(r['seq_block'] for r in got)}); logits vs the one-rank "
        f"step max {max(rel):.3e} in the norm (tol {rel_tol:.3e}); greedy "
        f"tokens equal where the margin passes: {tok_ok} ({compared} "
        f"compared); equal-row ranks bitwise {same_rows}; gathered cache: "
        f"unwritten positions bitwise {kept}, layer 0's writes bitwise "
        f"{first}, {n_bitwise} of {len(cmp)} layer tensors' writes bitwise, "
        f"the rest within {later:.3e} of the max; a step's collectives "
        f"{st0['collectives']} (formula all_gather {want['all_gather']}, "
        f"all_reduce {want['all_reduce']}); launches {st0['launches']} "
        f"routes cluster, plain {st0['plain']} (formula "
        f"{want['launches']}); resident {r0['resident']} (formula params "
        f"{want['params_bytes']:,}, cache {want['cache_bytes']:,}); step "
        f"ms a rank {min(ms):.2f}-{max(ms):.2f} (median "
        f"{float(np.median(ms)):.2f}), host ms a step in all_gather "
        f"{float(np.median(coll_ms['all_gather'])):.2f}, all_reduce "
        f"{float(np.median(coll_ms['all_reduce'])):.2f} (medians) ({smi})")
    fail.check(max(rel) <= rel_tol and tok_ok,
               f"[dlayout] {name}: logits off the one-rank step")
    fail.check(same_rows, f"[dlayout] {name}: equal-row ranks differ")
    fail.check(kept and first and later <= rel_tol,
               f"[dlayout] {name}: gathered cache off the one-rank cache")
    fail.check(coll_ok, f"[dlayout] {name}: collectives off the formula")
    fail.check(launch_ok,
               f"[dlayout] {name}: launches / routes off the formula, or a "
               f"plain call")
    fail.check(res_ok, f"[dlayout] {name}: resident bytes off the layout")
    fail.check(all(r["length"] == prompt + DLAYOUT_STEPS for r in got),
               f"[dlayout] {name}: cache length")
    return dict(logits_rel=max(rel), tokens_equal=tok_ok,
                tokens_compared=compared, same_rows=same_rows,
                cache_unwritten_bitwise=kept, cache_layer0_bitwise=first,
                cache_writes_bitwise=n_bitwise, cache_tensors=len(cmp),
                cache_later_rel=later, step_ms=ms, collective_ms=coll_ms,
                collectives=st0["collectives"], launches=st0["launches"],
                resident=r0["resident"], card=smi)


def ep_phase(fail, smi):
    """``[ep]``: the expert-parallel MoE on four ranks, (data 2, model 2):
    one value-and-grad (loss and gradients equal on every rank, within
    ``[train]``'s bounds of the one-rank all-experts path at a capacity
    factor that drops nothing, ``all_to_all`` calls and bytes of
    :func:`ep_a2a`, nothing staged), the config's capacity factor (finite,
    the dropped share), ``ServeEngine(mesh=...)`` (prefill on the split
    route, a decode step on the replicated one: logits within 4·2^-6 of
    the one-rank engine, launches and exchanges of the formula); on the
    same ranks ``[dlayout]`` (:func:`dist_dlayout`,
    :func:`dlayout_gates`); then one rank over NCCL on a (1, 1) mesh."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.dist import collectives
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine

    n_dev = torch.cuda.device_count()
    backend = "nccl" if n_dev >= 4 else "gloo"
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              n_layers=EP_DEPTH)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    n_p, p_len, new = EP_PROMPTS
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, p_len) for _ in range(n_p)]
    t0 = time.perf_counter()
    reports = run_ranks(4, [("ep_grad", dict(batch=EP_BATCH, seq=EP_SEQ)),
                            ("ep_generate", dict(prompts=prompts,
                                                 max_new=new))]
                        + [(name, dict(B=B, S=S, prompt=p,
                                       steps=DLAYOUT_STEPS))
                           for name, (B, S, p) in DLAYOUT_CELLS.items()]
                        + [("ulysses_train", dict(steps=ULYSSES_STEPS)),
                           ("ulysses_prefill", {}),
                           ("ulysses_ssm", {"name": "ulysses_ssm"})],
                        backend=backend)
    res = {"backend": reports[0]["backend"],
           "ranks_s": time.perf_counter() - t0}
    log(f"[ep] 4 ranks over {res['backend']} ("
        f"{'one card each' if n_dev >= 4 else 'sharing one card'}), mesh "
        f"(data 2, model 2): {res['ranks_s']:.1f} s")

    # ---- value and grad -------------------------------------------------------
    gr = _task(fail, "[ep] value and grad", reports, "ep_grad")
    if gr is not None:
        g0 = gr[0]
        same = all(g["loss"] == g0["loss"]
                   and g["grads_sha1"] == g0["grads_sha1"] for g in gr)
        # remat: the forward's exchanges again in the recompute, then the
        # backward's (each exchange's transpose is one)
        calls, nbytes = ep_a2a(cfg, EP_BATCH * EP_SEQ, 2, 2,
                               capacity_factor=E / k)
        a2a = g0["collectives"]["all_to_all"]
        want = (3 * calls, 3 * nbytes)
        staged = {n: c["staged"] for n, c in g0["collectives"].items()
                  if c["staged"]}
        log(f"[ep] value-and-grad of deepseek-v2-lite-16b depth {EP_DEPTH} "
            f"({EP_BATCH} x {EP_SEQ}, train_default, capacity factor E/k = "
            f"{E / k:.3f}, aux weight 0): {g0['vg_ms']:.1f} ms on rank 0; "
            f"loss {g0['loss']:.6f} on every rank: {same} (gradients' sha1 "
            f"too); vs the one-rank all-experts path: loss rel "
            f"{g0['loss_rel']:.3e}, nll / zloss rel "
            f"{', '.join(f'{v:.3e}' for v in g0['extras_rel'].values())}, "
            f"worst leaf {g0['worst_leaf']} {g0['worst_leaf_err']:.3e} of its "
            f"max (bounds 1e-5, 5e-4); all_to_all {a2a['calls']} calls, "
            f"{a2a['bytes']:,} bytes (formula {want[0]}, {want[1]:,}); staged "
            f"{staged}; launches {nonzero(g0['launches'])}; collectives "
            f"{ {n: c['calls'] for n, c in g0['collectives'].items() if c['calls']} }")
        fail.check(same, "[ep] ranks' losses or gradients differ")
        fail.check(g0["loss_rel"] <= 1e-5
                   and max(g0["extras_rel"].values()) <= 1e-5
                   and g0["worst_leaf_err"] < 5e-4,
                   "[ep] value and grad disagrees with the all-experts path")
        fail.check((a2a["calls"], a2a["bytes"]) == want,
                   f"[ep] all_to_all {a2a['calls']} calls {a2a['bytes']} "
                   f"bytes != {want}")
        fail.check(not staged if res["backend"] == "nccl" else
                   set(staged) <= set(collectives.GLOO_HOST_STAGED),
                   f"[ep] staged {staged}")
        fail.check(any(g0["launches"].values())
                   and all(g["finite"] for g in gr),
                   "[ep] no launches, or the config's capacity factor gave "
                   "non-finite outputs")
        log(f"[ep] at the config's capacity factor "
            f"{cfg.moe.capacity_factor}: outputs finite "
            f"{all(g['finite'] for g in gr)}, dropped share per rank "
            f"{[round(g['dropped_share'], 4) for g in gr]} of "
            f"{g0['assignments']} assignments")
        res["grad"] = g0
        res["dropped_share"] = [g["dropped_share"] for g in gr]

    # ---- generate with the mesh ---------------------------------------------------
    gen = _task(fail, "[ep] generate", reports, "ep_generate")
    if gen is not None:
        ep0, one, own = gen[0]["ep"], gen[0]["one"], gen[0]["own_cf"]
        same = all(g["ep"]["tokens"] == ep0["tokens"] for g in gen)
        rel_tol = 4 * 2.0 ** -6

        def rel(a, b):
            return float(np.linalg.norm(a - b) / np.linalg.norm(b))

        r_pre = rel(ep0["logits"], one["logits"])
        r_dec = rel(ep0["step_logits"], one["step_logits"])
        r_own = rel(own["logits"], one["logits"])
        m_size = 2
        pre_a2a = ep_a2a(cfg, n_p * p_len, m_size, 2, capacity_factor=E / k)
        got_pre = ep0["prefill"][1]["all_to_all"]
        got_dec = ep0["step"][1]["all_to_all"]
        want_pre_k = ep_launches(cfg, arch_forward_launches(
            cfg, n_p, p_len), m_size, cfg.moe.n_chunks)
        want_dec_k = ep_launches(cfg, arch_decode_launches(cfg), m_size, 1)
        got_pre_k = nonzero(ep0["prefill"][0])
        got_dec_k = nonzero(ep0["step"][0])
        log(f"[ep] ServeEngine(mesh=...) generate {n_p} x {p_len} tokens, "
            f"{new} new (serve_default, capacity factor E/k): tokens equal "
            f"on every rank {same}, "
            f"== the one-rank engine's {ep0['tokens'] == one['tokens']}; "
            f"prefill logits {r_pre:.3e} and a decode step's {r_dec:.3e} "
            f"from the one-rank engine (tol {rel_tol:.3e}); prefill "
            f"{ep0['prefill_ms']:.1f} ms (one rank {one['prefill_ms']:.1f}), "
            f"decode step {ep0['step_ms']:.1f} ms (one rank "
            f"{one['step_ms']:.1f}), {ep0['tokens_per_s']:.1f} tokens/s (one "
            f"rank {one['tokens_per_s']:.1f}); all_to_all per prefill "
            f"{got_pre['calls']} calls {got_pre['bytes']:,} bytes (formula "
            f"{pre_a2a[0]}, {pre_a2a[1]:,}), per decode step "
            f"{got_dec['calls']}; launches per prefill {got_pre_k} (formula "
            f"{nonzero(want_pre_k)}), per decode step {got_dec_k} (formula "
            f"{nonzero(want_dec_k)}); plain calls {nonzero(ep0['plain'])}; "
            f"at the config's capacity factor {cfg.moe.capacity_factor} the "
            f"prefill drops {own['dropped_share']:.4f} of its assignments "
            f"and its last logits read {r_own:.3e} from the one-rank engine")
        fail.check(same, "[ep] generate: ranks' tokens differ")
        fail.check(r_pre <= rel_tol and r_dec <= rel_tol,
                   "[ep] generate logits off the one-rank engine")
        fail.check((got_pre["calls"], got_pre["bytes"]) == pre_a2a
                   and got_dec["calls"] == 0,
                   "[ep] generate: all_to_all off the formula")
        fail.check(got_pre_k == nonzero(want_pre_k)
                   and got_dec_k == nonzero(want_dec_k)
                   and not any(ep0["plain"].values()),
                   "[ep] generate: launches off the formula")
        def plain(d):  # the report keeps numbers, not the logits
            return {k: v for k, v in d.items()
                    if k not in ("logits", "step_logits")}

        res["generate"] = dict(ep=plain(ep0), one=plain(one),
                               prefill_rel=r_pre,
                               decode_rel=r_dec, own_cf_prefill_rel=r_own,
                               own_cf_dropped_share=own["dropped_share"],
                               launches=ep0["total"][0])

    # ---- [dlayout]: the decode layout on the same ranks ---------------------------
    res["dlayout"] = {name: dlayout_gates(fail, name, reports, smi)
                      for name in DLAYOUT_CELLS}

    # ---- [ulysses]: the Ulysses layout on the same ranks, then seq mode on 3 -------
    res["ulysses"] = {name: ulysses_gates(fail, name, reports, smi)
                      for name in ("ulysses_train", "ulysses_prefill",
                                   "ulysses_ssm")}
    t0 = time.perf_counter()
    three = run_ranks(3, [("ulysses_seq", {"name": "ulysses_seq"})],
                      backend="nccl" if n_dev >= 3 else "gloo")
    log(f"[ulysses] 3 ranks over {three[0]['backend']}, mesh (data 1, "
        f"model 3): {time.perf_counter() - t0:.1f} s")
    res["ulysses"]["ulysses_seq"] = ulysses_gates(fail, "ulysses_seq", three,
                                                  smi)

    # ---- one rank over NCCL -------------------------------------------------------
    info = mesh_lib.init_distributed(
        0, 1, init_method=f"file://{ROOT / 'build'}/nccl_ep_{time.time_ns()}",
        device="cuda", backend="nccl", timeout_s=120)
    try:
        mesh = mesh_lib.make_debug_mesh(data=1, model=1)
        params = T.init_params(cfg, seed=0, device="cuda")
        policy = PrecisionPolicy.serve_default()
        whole = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=E / k))
        logits = {}
        for tag, m in (("ep", mesh), ("one", None)):
            eng = ServeEngine(whole, params, max_batch=n_p,
                              max_seq=p_len + new, policy=policy, mesh=m)
            collectives.reset_counts()
            logits[tag], _ = eng.prefill(eng.pad_prompts(prompts),
                                         eng.make_cache())
            if m is not None:
                a2a = collectives.counts()["all_to_all"]
            del eng
        torch.cuda.synchronize()
        r = ((logits["ep"] - logits["one"]).norm()
             / logits["one"].norm()).item()
        log(f"[ep] one rank over {info.backend}, mesh (1, 1), capacity "
            f"factor E/k: prefill logits {r:.3e} from the engine without a "
            f"mesh; all_to_all "
            f"{a2a}")
        fail.check(info.backend == "nccl" and r <= 4 * 2.0 ** -6
                   and a2a["calls"] > 0 and a2a["staged"] == 0,
                   "[ep] one-rank NCCL")
        res["nccl_one_rank"] = dict(backend=info.backend, rel=r, a2a=a2a)
        del params, logits
    finally:
        mesh_lib.shutdown()
    torch.cuda.empty_cache()
    return res


# ---- [autotune] and [roofline] ---------------------------------------------
AUTOTUNE_DIR = ROOT / "build" / "autotune_smoke"   # a fresh table each run
AUTOTUNE_ITERS = 5
# one dry-run cell per family (the cheap shape of each): rank 0 of the
# 256-rank fake world, in a subprocess
DRYRUN_CELLS = ("deepseek-7b:decode_32k", "deepseek-v2-lite-16b:decode_32k",
                "mamba2-130m:long_500k", "zamba2-2.7b:decode_32k",
                "llava-next-34b:decode_32k", "hubert-xlarge:train_4k")
ROOFLINE_MAX_SHARE = 1.05   # no card beats its roofline


def autotune_keys(cfg, params, policy, rows=(8 * 256, 8)):
    """The launch keys of one ``generate`` of the full-width model (8
    prompts padded to 256, decode at 8 rows) that dispatch tunes: at each
    row count the QKV and SwiGLU projections, ``wo``, ``w_down`` and
    ``lm_head`` at the policy's formats (keyed as dispatch keys them), then
    flash at (8, 256, 12, 64) and the scheduler's B = 1 prefill.  Returns
    (matmul keys as autotune() arguments, attention keys likewise)."""
    def fmt(op_class):
        return policy.mode(op_class).name

    lp = params["layers"][0]
    d = cfg.d_model
    wq, wk, wv = (lp["attn"][k].shape[1] for k in ("wq", "wk", "wv"))
    qkv = (3, wq) if wq == wk == wv else (1, wq + wk + wv)
    ff, V = lp["mlp"]["w_gate"].shape[1], params["lm_head"]["w"].shape[1]
    mm = []
    for M in rows:
        mm += [(M, d, qkv[1], fmt("qkv"), qkv[0], "none"),
               (M, d, ff, fmt("ffn"), 2, "swiglu"),
               (M, lp["attn"]["wo"].shape[0], d, fmt("attn_out"), 1, "none"),
               (M, ff, d, fmt("ffn"), 1, "none"),
               (M, d, V, fmt("lm_head"), 1, "none")]
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    attn = [(B * H, 256, 256, Dh, fmt("attn_qk"), fmt("attn_pv"))
            for B in (8, 1)]
    return mm, attn


def autotune_phase(cfg, params, prompts, main_outs, smi) -> dict:
    """Sweep the full-width keys into a fresh table (every candidate held
    bitwise against the default launch inside the sweep), then a generate
    with the switch off reads it: no sweep, a hit on every key generate
    uses, the tokens of [main] bitwise; then a fresh process reads the same
    table from disk and does not sweep."""
    from repro_torch.kernels import autotune as at

    shutil.rmtree(AUTOTUNE_DIR, ignore_errors=True)
    before = os.environ.get("REPRO_AUTOTUNE_CACHE_DIR")
    os.environ["REPRO_AUTOTUNE_CACHE_DIR"] = str(AUTOTUNE_DIR)
    at.clear_memory_cache()
    try:
        return _autotune_run(cfg, params, prompts, main_outs, smi)
    finally:   # the other phases launch with the defaults
        os.environ["REPRO_AUTOTUNE_CACHE_DIR"] = before
        at.clear_memory_cache()


def _autotune_run(cfg, params, prompts, main_outs, smi) -> dict:
    import torch

    import repro_torch.mp as mp
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.kernels import autotune as at
    from repro_torch.serve.engine import ServeEngine

    policy = PrecisionPolicy.serve_default()
    eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                      prelimb_weights=False, policy=policy)
    mm, attn = autotune_keys(cfg, params, policy)
    keys = [at.table_key(M, K, N, f, torch.float32, n_out=n, epilogue=e)
            for M, K, N, f, n, e in mm]
    akeys = [at.attention_table_key(bh, S, T_, Dh, fq, fp, causal=True)
             for bh, S, T_, Dh, fq, fp in attn]
    gen_keys = set(keys) | {akeys[0]}     # B = 1 is the scheduler's prefill
    at.reset_stats()
    rows = []
    t0 = time.perf_counter()
    for (M, K, N, f, n, e), key in zip(mm, keys):
        rec = {}
        at.autotune(M, K, N, f, n_out=n, epilogue=e, iters=AUTOTUNE_ITERS,
                    record=rec)
        rows.append(rec)
    for (bh, S, T_, Dh, fq, fp), key in zip(attn, akeys):
        rec = {}
        at.autotune_attention(bh, S, T_, Dh, fq, fp, causal=True,
                              iters=AUTOTUNE_ITERS, record=rec)
        rows.append(rec)
    sweep_s = time.perf_counter() - t0
    for r in rows:
        log(f"[autotune] {r['key']}: default {r['default_ms']:.4f} ms, "
            f"winner {r['winner']} {r['winner_ms']:.4f} ms, the default "
            f"{'won' if r['default_won'] else 'lost'}; every candidate "
            f"bitwise the default launch: "
            f"{ {k: round(v, 4) for k, v in r['candidates'].items()} } "
            f"(device time, calls queued behind a sleep kernel; {smi})")
        # the default is one of the configurations the sweep times
        if r["winner_ms"] > r["default_ms"]:
            raise AssertionError(f"[autotune] {r['key']}: the winner "
                                 f"{r['winner']} is slower than the default")
    st = at.stats()
    if st["sweeps"] != len(keys) + len(akeys):
        raise AssertionError(f"[autotune] {st['sweeps']} sweeps for "
                             f"{len(keys) + len(akeys)} keys")
    # the switch off: the table is read, nothing sweeps
    at.reset_stats()
    with mp.context(autotune=False):
        outs = eng.generate(prompts, max_new=32)
    torch.cuda.synchronize()
    st = at.stats()
    log(f"[autotune] generate with the switch off: {st['sweeps']} sweeps, "
        f"{len(st['hit_keys'])} of the {len(gen_keys)} keys it uses hit "
        f"({st['hits']} hits in {st['lookups']} lookups); tokens "
        f"{'bitwise' if outs == main_outs else 'NOT'} [main]'s")
    # every lookup hits, and every key but the scheduler's is looked up
    if st["sweeps"] or set(st["hit_keys"]) != gen_keys \
            or st["hits"] != st["lookups"]:
        raise AssertionError(f"[autotune] the tuned generate swept or "
                             f"missed: {st}")
    if outs != main_outs:
        raise AssertionError("[autotune] the tuned generate's tokens are not "
                             "[main]'s")
    table = dict(at.load_table())
    # a fresh process: the switch ON, every key cached on disk, no sweep
    code = ("import json, torch\n"
            "from repro_torch.kernels import autotune as at\n"
            f"mm, attn = {mm!r}, {attn!r}\n"
            "got = {}\n"
            "for M, K, N, f, n, e in mm:\n"
            "    got[at.table_key(M, K, N, f, torch.float32, n_out=n, "
            "epilogue=e)] = list(at.autotune(M, K, N, f, n_out=n, "
            "epilogue=e))\n"
            "for bh, S, T, Dh, fq, fp in attn:\n"
            "    got[at.attention_table_key(bh, S, T, Dh, fq, fp, "
            "causal=True)] = list(at.autotune_attention(bh, S, T, Dh, fq, "
            "fp))\n"
            "print(json.dumps({'table': got, 'stats': at.stats()}))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_AUTOTUNE_CACHE_DIR": str(AUTOTUNE_DIR),
           "REPRO_MP_AUTOTUNE": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"[autotune] the reader process failed:\n"
                             f"{out.stderr[-3000:]}")
    sub = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"[autotune] a fresh process with the switch on read "
        f"{len(sub['table'])} keys from disk: {sub['stats']['sweeps']} "
        f"sweeps, {sub['stats']['hits']} hits, table "
        f"{'equal' if sub['table'] == table else 'DIFFERENT'}")
    if sub["stats"]["sweeps"] or sub["table"] != table:
        raise AssertionError("[autotune] the reader process swept or read "
                             "another table")
    return dict(keys=rows, sweep_s=sweep_s, table=table,
                generate_hits=len(gen_keys), reader=sub["stats"])


def roofline_phase(cfg, params, prompts, trainer, state, pipe, train_ms,
                   smi) -> dict:
    """Count the real [main] prefill and one [train] step under ``cuda``,
    hold the counts equal to the dry run of the same shapes (meta tensors,
    ``launch/specs.build_cell``), and read each path's measured time
    against its roofline bound; then one dry-run cell per family."""
    import numpy as np
    import torch

    from repro_torch.analysis import accounting, roofline
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.launch import specs
    from repro_torch.serve.engine import ServeEngine

    hw = card_rates()
    out = {}
    eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                      prelimb_weights=False,
                      policy=PrecisionPolicy.serve_default())
    toks = eng.pad_prompts(prompts)
    eng.prefill(toks, eng.make_cache())
    ms = []
    for _ in range(3):
        cache = eng.make_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.prefill(toks, cache)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    with accounting.count_work() as real_pre:
        eng.prefill(toks, eng.make_cache())
        torch.cuda.synchronize()
    del eng
    b_train = trainer.to_device(pipe.batch(0))
    with accounting.count_work() as real_train:
        trainer._step_fn(state, b_train)
        torch.cuda.synchronize()
    for path, real, cell, measured in (
            ("prefill", real_pre,
             ShapeCell("main_prefill", toks.shape[1], toks.shape[0],
                       "prefill"), float(np.median(ms))),
            ("train", real_train,
             ShapeCell("train_step", b_train["tokens"].shape[1],
                       b_train["tokens"].shape[0], "train"), train_ms)):
        policy = PrecisionPolicy.serve_default() if path == "prefill" \
            else trainer.policy
        dry = specs.build_cell("paper-mpfp-100m", cfg, cell, policy=policy)
        with accounting.count_work() as meta:
            dry.fn(*dry.args)
        if meta.summary() != real.summary():
            raise AssertionError(f"[roofline] {path}: the card's counts "
                                 f"{real.summary()} != the dry run's "
                                 f"{meta.summary()}")
        r = roofline.from_work(real, hw=hw)
        share = r.bound_s * 1e3 / measured
        log(f"[roofline] {path} {cell.global_batch} x {cell.seq_len}: "
            f"{len(real.calls)} dispatch calls, {real.flops:,} flops, "
            f"{real.bytes:,} bytes, == the dry run's exactly; bound "
            f"{r.bound_s * 1e3:.4f} ms ({r.dominant}), measured "
            f"{measured:.3f} ms (host clock after synchronize), share "
            f"{share:.4f} ({smi})")
        if share > ROOFLINE_MAX_SHARE:
            raise AssertionError(f"[roofline] {path}: share {share:.4f} above "
                                 f"{ROOFLINE_MAX_SHARE}")
        out[path] = dict(work=real.summary(), bound_ms=r.bound_s * 1e3,
                         dominant=r.dominant, measured_ms=measured,
                         share=share, roofline=r.to_dict())
    # one dry-run cell per family, full size, rank 0 of 256
    dry_dir = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(dry_dir, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
         "single", "--out", str(dry_dir), "--cells", ",".join(DRYRUN_CELLS)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    dry_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[roofline] dryrun {line}")
    if proc.returncode != 0:
        raise AssertionError(f"[roofline] dryrun failed:\n"
                             f"{proc.stderr[-3000:]}")
    recs = {}
    for c in DRYRUN_CELLS:
        arch, shape = c.split(":")
        rec = json.loads((dry_dir / f"singlepod_{arch}_{shape}.json")
                         .read_text())
        if rec["status"] != "ok":
            raise AssertionError(f"[roofline] dryrun {c}: {rec['reason']}")
        recs[c] = dict(roofline=rec["roofline"], memory=rec["memory"],
                       work_flops=rec["work"]["flops"],
                       trace_s=rec["trace_s"])
    log(f"[roofline] dryrun: {len(recs)} cells in {dry_s:.1f} s")
    out["dryrun"] = recs
    out["dryrun_s"] = dry_s
    return out


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed(fn, torch, min_ms: float = 30.0) -> float:
    """Mean device milliseconds per call, from CUDA events over a run of
    calls after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    n = max(3, min(200, int(min_ms / once)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_busy_ms(fn):
    """Milliseconds of device time on the card while ``fn`` runs, summed
    over what ``torch.profiler`` records (kernels and copies), and the
    same by name, largest first (fails when it records none: a busy time
    is read from the card or not at all)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("<")[0].split("(")[0]
            name = name.split("::")[-1].strip()
            by_name[name] = by_name.get(name, 0.0) \
                + e.self_device_time_total / 1e3
    total = sum(by_name.values())
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total, dict(sorted(by_name.items(), key=lambda kv: -kv[1]))


def device_ms(fn, torch=None, min_ms: float = 30.0):
    """Mean device milliseconds per call with the host ahead of the card,
    and whether it stayed ahead: the port's one timer,
    :func:`repro_torch.kernels.timing.device_ms` (calls queued behind a
    sleep kernel), which the autotuner's sweeps use too."""
    from repro_torch.kernels.timing import device_ms as timer

    return timer(fn, min_ms)


def paged_inputs(torch, randn, lengths, H, Hkv, Dh=64, bs=16, perm_seed=0,
                 W=None, plant=()):
    """Inputs of one paged decode launch: q (B, H, Dh), K and V pools of
    random blocks, a (B, W) table holding each slot's distinct live blocks
    and the trash block 0 after them, int32 lengths; W defaults to the power
    of two at least the longest slot's columns.  ``plant`` holds (slot,
    position, gain): K there becomes the multiple of the first query head
    of each kv head that gives that head the logit ``gain``."""
    import numpy as np

    B = len(lengths)
    cols = [-(-n // bs) for n in lengths]
    if W is None:
        W = 1 << (max(max(cols), 1) - 1).bit_length()
    n_blocks = sum(cols) + 1 + 8
    q = randn(B, H, Dh)
    kp, vp = randn(n_blocks, bs, Hkv, Dh), randn(n_blocks, bs, Hkv, Dh)
    perm = (torch.randperm(n_blocks - 1, generator=torch.Generator()
                           .manual_seed(perm_seed)) + 1).tolist()
    table = np.zeros((B, W), np.int32)     # trash-padded
    for b, c in enumerate(cols):
        table[b, :c] = [perm.pop() for _ in range(c)]
    for b, pos, gain in plant:
        blk = int(table[b, pos // bs])
        for g in range(Hkv):
            qr = q[b, g * (H // Hkv)]
            kp[blk, pos % bs, g] = gain * qr / (qr.dot(qr) * Dh ** -0.5)
    table = torch.from_numpy(table).to(q.device)
    ln = torch.tensor(lengths, dtype=torch.int32, device=q.device)
    return q, kp, vp, table, ln


def flash_inputs(torch, randn, B, S, T, H, Dh, plant=()):
    """q (B, S, H, Dh), k and v (B, T, H, Dh) of one flash case; for each
    (row, position, gain) of ``plant``, K at the position becomes the
    multiple of each head's query row that gives it the logit ``gain``
    (scale Dh^-1/2)."""
    q, k, v = randn(B, S, H, Dh), randn(B, T, H, Dh), randn(B, T, H, Dh)
    for s, t, gain in plant:
        qr = q[:, s]                                     # (B, H, Dh)
        k[:, t] = gain * qr / ((qr * qr).sum(-1, keepdim=True)
                               * Dh ** -0.5)
    return q, k, v


def card_rates():
    """The H100 SXM's rates from the port's roofline
    (``repro_torch.analysis.roofline``): every bound of this script."""
    from repro_torch.analysis import roofline

    return roofline.hardware(roofline.H100_SXM)


def bound(ops: float, nbytes: float, peak_ops=None):
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``ops`` at ``peak_ops`` (the bf16 tensor-core rate by default) and
    ``nbytes`` at the HBM rate (``roofline.bound_s``)."""
    from repro_torch.analysis import roofline

    t, by = roofline.bound_s(ops, nbytes, card_rates(), peak_ops)
    return t * 1e3, by


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # the autotune table every phase but [autotune] reads: an empty one
    # inside the checkout, so every launch keeps its default choice
    shutil.rmtree(ROOT / "build" / "autotune_table", ignore_errors=True)
    os.environ["REPRO_AUTOTUNE_CACHE_DIR"] = str(ROOT / "build"
                                                 / "autotune_table")
    import numpy as np

    import repro_torch.mp as mp
    from repro_torch import kernels
    from repro_torch.configs import paper_mpfp
    from repro_torch.core import auto as auto_lib
    from repro_torch.core import lanes
    from repro_torch.core import limbs as limbs_lib
    from repro_torch.core.formats import register_format, resolve
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.kernels import build, mp_attention, mp_matmul
    from repro_torch.models import transformer as T
    from repro_torch.serve import primitives as prim
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.kv_cache import PagedKVPool
    from repro_torch.serve.scheduler import ContinuousScheduler, \
        ScheduledRequest
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.core import context as context_lib
    from repro_torch.core.classify import all_finite
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ref as ref_lib
    from repro_torch.train import trainer as trainer_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report = {}

    # ---- 1. the card ------------------------------------------------------
    smi = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {name}")
    report["card"] = smi

    # ---- 2. the build -----------------------------------------------------
    t0 = time.perf_counter()
    builds = build.build()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {report['build_s']:.1f} s wall "
        + ", ".join(f"{b.name} {b.seconds:.1f} s" for b in builds.values()))
    for b in builds.values():
        for entry, (regs, st, ld) in sorted(
                build.ptxas_summary(b.ptxas).items()):
            log(f"[ptxas] {b.name}: {entry[:90]} regs {regs} "
                f"spill st {st} ld {ld}")
    # the K of one chunk: the length of every tensor-core chain, so the
    # order of every matmul's sum
    report["chunk_k"] = mp_matmul.chunk_k()
    log(f"[build] limb matmuls: one tensor-core chain per product (mma.sync;"
        f" wgmma on the fused matmul's TMA tile) over chunks of KC = "
        f"{report['chunk_k']} k, summed by f32 adds")
    # the split decode plans at the serving decode shapes: the cluster size
    # splitting K's chunks and the k per ring stage, on each split kernel's
    # registers (the fused matmul's, the projection's one weight a block
    # and gated two, the mixed tick's envelope (3, 2) on stored planes)
    plans = (("w_down", 3072, 768, "M8", {}), ("wo", 768, 768, "M8", {}),
             ("lm_head", 768, 32000, "M16", {}),
             ("QKV", 768, 768, "M8", dict(kind="proj", n_out=3)),
             ("SwiGLU", 768, 3072, "M8", dict(kind="proj", n_out=2,
                                               gate=True)),
             ("mixed wq", 768, 768, "M23", dict(kind="mixed")),
             ("mixed w_gate", 768, 3072, "M23", dict(kind="mixed")),
             ("mixed w_down", 3072, 768, "M23", dict(kind="mixed")),
             ("mixed lm_head", 768, 32000, "M23", dict(kind="mixed")))
    report["split_plan"] = {
        f"{lbl} 8x{K}x{N} {f}": mp_matmul.decode_plan(8, N, K, f, **kw)
        for lbl, K, N, f, kw in plans}
    report["split_regs"] = {
        f"{kind} {f}" + (f" nout {n}" if kind == "proj" else ""):
            mp_matmul.split_regs(kind, f, n)
        for kind, n in (("fused", 1), ("prelimbed", 1), ("proj", 1),
                        ("proj", 2), ("mixed", 1))
        for f in ("M8", "M16", "M23")}
    log("[build] split decode plans (cluster size, k per stage): "
        + ", ".join(f"{k} {v}" for k, v in report["split_plan"].items())
        + "; registers a thread: "
        + ", ".join(f"{k} {v}" for k, v in report["split_regs"].items()))
    # the paged kernels' chunk at the decode shape (Dh 64, bs 16, M16/M8 and
    # the mixed tick's (3, 3) envelope); a slot's bits do not depend on it
    chunk_cols = mp_attention.paged_chunk_cols(64, 16, 1, 2, 1)
    report["paged_chunk_cols"] = chunk_cols
    if (chunk_cols != mp_attention.PAGED_CHUNK_POS // 16
            or mp_attention.paged_chunk_cols(64, 16, 1, 3, 3) != chunk_cols):
        raise AssertionError(f"paged chunk of {chunk_cols} columns, not "
                             f"{mp_attention.PAGED_CHUNK_POS // 16}")
    log(f"[build] paged attention: chunks of C = {chunk_cols} table columns "
        f"({chunk_cols * 16} positions at bs 16, Dh 64), no split: one block "
        f"per (kv head, slot)")
    # flash attention's query rows per block: the largest of 64, 32, 16
    # whose grid B * H * ceil(S / rows) reaches the SM count
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    flash_bq = {f"B{b} S{s} H12": mp_attention.flash_block_q(
        b, s, 12, 64, "M16", "M8") for b, s in ((8, 256), (1, 256), (1, 64))}
    report["flash_block_q"] = {k: v[0] for k, v in flash_bq.items()}
    if not all(sp for _, sp in flash_bq.values()):
        raise AssertionError("flash M16/M8 at Dh 64 is not the compile-time "
                             "instantiation")
    report["flash_block_q"]["B8 S256 H16 Dh192"], sp192 = \
        mp_attention.flash_block_q(8, 256, 16, 192, "M16", "M8")
    if sp192 or not report["flash_block_q"]["B8 S256 H16 Dh192"]:
        raise AssertionError("flash M16/M8 at Dh 192 is not the generic "
                             "instantiation")
    log(f"[build] flash attention: BQ = the largest of 64, 32, 16 query rows "
        f"with B * H * ceil(S / BQ) >= {n_sm} SMs (else 16); 128 threads: a "
        f"warp per 16 rows, the others copy and limb; kv tiles of 32: M16/M8 "
        f"Dh 64 (Dh 192: the generic instantiation) "
        + ", ".join(f"{k} -> BQ {v}" for k, v in
                    report["flash_block_q"].items()))

    # ---- 3. kernels against their plain versions --------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    checks = {k: [] for k in SOURCES}
    cases = {k: [] for k in SOURCES}

    def hold(kernel, label, out, ref, tol, extra):
        err = (out - ref).abs()
        bad = (err > tol).sum().item()
        row = {"case": label, "max_abs_err": err.max().item(),
               "max_rel_err": (err / ref.abs().clamp_min(1e-30)).max().item(),
               "violations": bad, **extra}
        checks[kernel].append(row)
        log(f"[check] {kernel} {label}: max_abs {row['max_abs_err']:.3e} "
            f"max_rel {row['max_rel_err']:.3e} tol_max "
            f"{tol.max().item() if torch.is_tensor(tol) else tol:.3e} "
            f"violations {bad}")
        if bad or not torch.isfinite(out).all():
            raise AssertionError(f"{kernel} {label} disagrees with its "
                                 "plain version")

    def f32_bound(fmt, K):
        # tests/test_kernels.py's error model: limb truncation (f32 inputs
        # carry at most 3 limbs) or the f32 accumulation floor
        return max(2.0 ** -(8 * min(fmt.n_limbs, 3) - 2),
                   8 * U32 * math.sqrt(K))

    def hold_golden(kernel, label, out, gold, bound):
        """A prefill case against its float64 golden: the relative error in
        the norm, held below ``bound``, and the largest absolute error beside
        it; returned for the case's ``[time]`` line."""
        err = out.double() - gold
        res = dict(gold_rel=(err.norm() / gold.norm()).item(),
                   gold_bound=bound, gold_max_abs=err.abs().max().item())
        checks[kernel][-1].update(res)
        log(f"[gold] {kernel} {label}: rel err vs float64 "
            f"{res['gold_rel']:.3e} (bound {bound:.3e}), max abs "
            f"{res['gold_max_abs']:.3e}")
        if not res["gold_rel"] < bound:
            raise AssertionError(f"{kernel} {label}: error vs float64 "
                                 f"{res['gold_rel']} >= {bound}")
        return res

    gen70 = torch.Generator(device=dev).manual_seed(70)

    def decode_rows_bitwise(kernel, label, fn, a, out):
        """A decode case (M <= 16 rows: the decode tile) against the same
        rows of one launch at M = 70 (the prefill tile), bit for bit."""
        M = a.shape[-2]
        if M > 16:
            return
        pad = torch.randn(*a.shape[:-2], 70 - M, a.shape[-1],
                          generator=gen70, device=dev)
        big = fn(torch.cat([a, pad], dim=-2))[..., :M, :]
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), big.view(torch.int32)):
            raise AssertionError(f"{kernel} {label}: rows of the M = {M} "
                                 "launch are not bitwise the M = 70 "
                                 "launch's")
        checks[kernel][-1]["bitwise_vs_m70"] = True
        log(f"[check] {kernel} {label}: M = {M} rows == M = 70 rows "
            "bitwise")

    def golden_case(label):
        # the serving prefill cases and the training cases meet the float64
        # golden; decode cases are held bitwise against their M = 70 rows
        return label.startswith(("prefill", "train"))

    def matmul_case(label, a, b, fmt, main=False, library=False, per=None,
                    contig=False, solo=False):
        """``contig``: a 2-D operand is a transposed view (dgrad's W^T, a
        2-D wgrad's x^T), which the wrapper copies to row-major; the launch
        on the views as they are (strided 4-byte copies in the kernel) must
        give the wrapper's bits, and is timed beside it.  ``solo``: each
        batch entry bitwise the same product launched alone."""
        fmt = resolve(fmt)
        out, route = routed_call(mp_matmul.mp_fused_matmul, a, b, fmt)
        ref = mp_matmul.fused_matmul_plain(a, b, fmt)
        torch.cuda.synchronize()
        K = a.shape[-1]
        hold("mp_fused_matmul", label, out, ref, mm_tol(ref, K),
             {"fmt": fmt.name, "route": route})
        gold = (hold_golden("mp_fused_matmul", label, out,
                            a.double() @ b.double(), f32_bound(fmt, K))
                if golden_case(label) else {})
        decode_rows_bitwise("mp_fused_matmul", label,
                            lambda x: mp_matmul.mp_fused_matmul(x, b, fmt),
                            a, out)
        if a.ndim == 2 and b.ndim == 2:
            partials_gate(label, a, b, fmt, out)
        lib, stream = build.load("mp_matmul"), \
            torch.cuda.current_stream().cuda_stream

        def on_views():
            return mp_matmul.launch_fused_matmul(lib, stream, a, b, fmt)

        if contig:
            views = on_views()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32),
                               views.view(torch.int32)):
                raise AssertionError(f"mp_fused_matmul {label}: the launch on "
                                     "the transposed views is not bitwise the "
                                     "launch on row-major copies")
            checks["mp_fused_matmul"][-1]["bitwise_vs_views"] = True
            log(f"[check] mp_fused_matmul {label}: the views as they are == "
                "row-major copies, bitwise")
        if solo:
            lead = out.shape[:-2]
            for idx in np.ndindex(*lead):
                one = mp_matmul.mp_fused_matmul(a[idx], b[idx], fmt)
                torch.cuda.synchronize()
                if not torch.equal(out[idx].view(torch.int32),
                                   one.view(torch.int32)):
                    raise AssertionError(f"mp_fused_matmul {label}: entry "
                                         f"{idx} alone is not bitwise its "
                                         "part of the batch")
            checks["mp_fused_matmul"][-1]["solo_bitwise"] = True
            log(f"[check] mp_fused_matmul {label}: each of "
                f"{math.prod(lead)} entries == the entry launched alone, "
                "bitwise")
        nb = out.numel() // (out.shape[-1] * out.shape[-2])
        M, N = out.shape[-2:]
        ops = 2 * nb * M * K * N * fmt.n_products
        nbytes = 4 * (a.numel() + b.numel() + out.numel())
        row = dict(case=label, fmt=fmt.name, a=list(a.shape),
                   b=list(b.shape), ops=ops, bytes=nbytes, main=main,
                   per=per, route=route, **gold,
                   fn=lambda: mp_matmul.mp_fused_matmul(a, b, fmt),
                   plain=lambda: mp_matmul.fused_matmul_plain(a, b, fmt),
                   library=(lambda ar=a.bfloat16().float(),
                            br=b.bfloat16().float(): torch.matmul(ar, br))
                   if library else None,
                   # M8's function exactly, on the card's bf16 fast path
                   library_bf16=(lambda ab=a.bfloat16(), bb=b.bfloat16():
                                 torch.mm(ab, bb, out_dtype=torch.float32))
                   if library and fmt.name == "M8" and a.ndim == 2
                   and b.ndim == 2 else None)
        cases["mp_fused_matmul"].append(row)
        if contig:
            cases["mp_fused_matmul"].append(dict(
                row, case=label + ", launched on the views as they are",
                main=False, per=None, fn=on_views,
                route=mp_matmul.STRIDED))

    def partials_gate(label, a, b, fmt, fused_out):
        """The partials epilogue on a 2-D case: each order's plane against
        its plain version, ``combine_partials`` of the stack bitwise the
        fused kernel's output, and a decode case's rows (M <= 16, the
        decode tile) bitwise the same rows of an M = 70 launch."""
        kname = "mp_fused_matmul_partials"
        parts, route = routed_call(mp_matmul.mp_fused_matmul_partials, a, b,
                                   fmt)
        plain = mp_matmul.fused_matmul_partials_plain(a, b, fmt)
        torch.cuda.synchronize()
        tol = torch.stack([mm_tol(pl, a.shape[-1]) for pl in plain])
        hold(kname, label, parts, plain, tol, {"fmt": fmt.name,
                                               "route": route})
        joined = ref_lib.combine_partials(parts, fmt)
        torch.cuda.synchronize()
        if not torch.equal(joined.view(torch.int32),
                           fused_out.view(torch.int32)):
            raise AssertionError(f"{kname} {label}: combine_partials of the "
                                 "stack is not bitwise mp_fused_matmul")
        checks[kname][-1]["combine_bitwise_fused"] = True
        M = a.shape[0]
        if M <= 16:
            pad = torch.randn(70 - M, a.shape[1], generator=gen70,
                              device=dev)
            big = mp_matmul.mp_fused_matmul_partials(
                torch.cat([a, pad]), b, fmt)[:, :M]
            torch.cuda.synchronize()
            if not torch.equal(parts.view(torch.int32),
                               big.view(torch.int32)):
                raise AssertionError(f"{kname} {label}: rows of the M = {M} "
                                     "stack are not bitwise the M = 70 "
                                     "stack's")
            checks[kname][-1]["bitwise_vs_m70"] = True
        log(f"[check] {kname} {label}: combine_partials(stack) == "
            "mp_fused_matmul bitwise"
            + (f"; M = {M} rows == M = 70 rows bitwise" if M <= 16 else ""))

    def partials_case(label, a, b, fmt, main=False):
        """A timed partials case at a K-sharded shape, with the fused
        kernel on the same operands timed beside it (``fused_ms``)."""
        fmt = resolve(fmt)
        fused = mp_matmul.mp_fused_matmul(a, b, fmt)
        partials_gate(label, a, b, fmt, fused)
        (M, K), N = a.shape, b.shape[1]
        cases["mp_fused_matmul_partials"].append(dict(
            case=label, fmt=fmt.name, a=list(a.shape), b=list(b.shape),
            route=checks["mp_fused_matmul_partials"][-1]["route"],
            ops=2 * M * K * N * fmt.n_products,
            bytes=4 * (a.numel() + b.numel() + fmt.n_orders * M * N),
            main=main, per=None,
            fn=lambda: mp_matmul.mp_fused_matmul_partials(a, b, fmt),
            plain=lambda: mp_matmul.fused_matmul_partials_plain(a, b, fmt),
            library=None,
            vs=lambda: mp_matmul.mp_fused_matmul(a, b, fmt)))

    def proj_case(label, a, ws, fmt, gate="none", biases=None,
                  residual=None, main=False, library=False, per=None,
                  bf16=False):
        fmt = resolve(fmt)
        kw = dict(gate=gate, biases=biases, residual=residual)
        out, route = routed_call(mp_matmul.mp_fused_proj, a, ws, fmt, **kw)
        ref = mp_matmul.fused_proj_plain(a, ws, fmt, **kw)
        torch.cuda.synchronize()
        K = a.shape[-1]
        hold("mp_fused_proj", label, out, ref, proj_tol(a, ws, fmt, ref, **kw),
             {"fmt": fmt.name, "route": route})
        gold = {}
        if golden_case(label):
            raw = []
            for t, w in enumerate(ws):
                r = a.double() @ w.double()
                if biases is not None:
                    r = r + biases[t].double()
                raw.append(r)
            lim = f32_bound(fmt, K)
            if gate == "none":
                g64 = torch.stack(raw)
                if residual is not None:
                    g64 = g64 + residual.double()
                gold = hold_golden("mp_fused_proj", label, out, g64, lim)
            else:
                # each raw output within lim of its golden in the norm,
                # carried through silu(g) * u (|silu'| <= 1.1)
                g, u = raw
                sg = g / (1 + torch.exp(-g))
                g64 = sg * u
                carried = lim * (1.1 * u.abs().max() * g.norm()
                                 + sg.abs().max() * u.norm()) / g64.norm()
                if residual is not None:
                    g64 = g64 + residual.double()
                gold = hold_golden("mp_fused_proj", label, out, g64,
                                   carried.item())
        if gate == "none" and biases is None and residual is None:
            # no epilogue: each output is the fused matmul with its weight
            for t, w in enumerate(ws):
                mm = mp_matmul.mp_fused_matmul(a, w, fmt)
                torch.cuda.synchronize()
                if not torch.equal(out[t].view(torch.int32),
                                   mm.view(torch.int32)):
                    raise AssertionError(f"mp_fused_proj {label}: output {t}"
                                         " is not bitwise mp_fused_matmul")
            checks["mp_fused_proj"][-1]["bitwise_vs_fused"] = True
        decode_rows_bitwise(
            "mp_fused_proj", label,
            lambda x: mp_matmul.mp_fused_proj(x, ws, fmt, **kw), a, out)
        M, N = a.shape[0], ws[0].shape[1]
        ops = 2 * M * K * N * fmt.n_products * len(ws)
        nbytes = 4 * (a.numel() + sum(w.numel() for w in ws) + out.numel()
                      + (0 if biases is None else N * len(ws))
                      + (0 if residual is None else residual.numel()))
        stack = torch.stack([w.bfloat16().float() for w in ws])
        cases["mp_fused_proj"].append(dict(
            case=label, fmt=fmt.name, a=list(a.shape), n_out=len(ws),
            N=N, gate=gate, ops=ops, bytes=nbytes, main=main, per=per,
            route=route, **gold,
            fn=lambda: mp_matmul.mp_fused_proj(a, ws, fmt, **kw),
            plain=lambda: mp_matmul.fused_proj_plain(a, ws, fmt, **kw),
            library=(lambda ar=a.bfloat16().float(): torch.matmul(ar, stack))
            if library else None,
            # M8's function (without the epilogue; SwiGLU's product only)
            # on the weights concatenated along N, on the bf16 fast path
            library_bf16=(lambda ab=a.bfloat16(),
                          bb=torch.cat(ws, dim=1).bfloat16():
                          torch.mm(ab, bb, out_dtype=torch.float32))
            if (library or bf16) and fmt.name == "M8" else None))

    def flash_case(label, B, S, T, H, Dh, qk, pv, causal, q_offset=0,
                   plant=(), main=False, per=None, data=None):
        q, k, v = flash_inputs(torch, data or randn, B, S, T, H, Dh, plant)
        fq, fp = resolve(qk), resolve(pv)
        out = mp_attention.mp_flash_attention(q, k, v, fq, fp, causal=causal,
                                              q_offset=q_offset)
        ref = mp_attention.flash_attention_plain(q, k, v, fq, fp,
                                                 causal=causal,
                                                 q_offset=q_offset)
        torch.cuda.synchronize()
        hold("mp_flash_attention", label, out, ref,
             FLASH_TOL + FLASH_TOL * ref.abs(), {"fmt": f"{qk}/{pv}"})
        # each (b, h) bitwise the same head launched alone (B = H = 1, so
        # the smallest block of query rows)
        for b in range(B):
            for h in range(H):
                one = mp_attention.mp_flash_attention(
                    q[b:b + 1, :, h:h + 1], k[b:b + 1, :, h:h + 1],
                    v[b:b + 1, :, h:h + 1], fq, fp, causal=causal,
                    q_offset=q_offset)
                torch.cuda.synchronize()
                if not torch.equal(out[b:b + 1, :, h:h + 1].view(torch.int32),
                                   one.view(torch.int32)):
                    raise AssertionError(f"mp_flash_attention {label}: head "
                                         f"({b}, {h}) alone is not bitwise "
                                         "its part of the batch")
        checks["mp_flash_attention"][-1]["solo_bitwise"] = True
        log(f"[check] mp_flash_attention {label}: each of {B * H} heads == "
            "the head launched alone, bitwise")
        gold = {}
        if golden_case(label):
            # float64 attention; both contractions within the error model
            # of their formats, the softmax carrying the logits' error:
            # 4x the QK format's bound (the repo's logits convention)
            qd, kd, vd = (x.double().permute(0, 2, 1, 3) for x in (q, k, v))
            lg = qd @ kd.transpose(-1, -2) * Dh ** -0.5
            if causal:
                keep = (q_offset + torch.arange(S, device=dev))[:, None] \
                    >= torch.arange(T, device=dev)[None, :]
                lg = lg.masked_fill(~keep, -math.inf)
            g64 = (torch.softmax(lg, dim=-1) @ vd).permute(0, 2, 1, 3)
            gold = hold_golden("mp_flash_attention", label, out, g64,
                               4 * max(f32_bound(fq, Dh), f32_bound(fp, T)))
        qpos = q_offset + np.arange(S)
        pairs = (np.minimum(qpos + 1, T).sum() if causal else S * T)
        ops = 2 * B * H * int(pairs) * Dh * (fq.n_products + fp.n_products)
        nbytes = 4 * (q.numel() + k.numel() + v.numel() + out.numel())
        cases["mp_flash_attention"].append(dict(
            case=label, fmt=f"{qk}/{pv}", shape=[B, S, T, H, Dh],
            causal=causal, ops=ops, bytes=nbytes, main=main, per=per, **gold,
            fn=lambda: mp_attention.mp_flash_attention(
                q, k, v, fq, fp, causal=causal, q_offset=q_offset),
            plain=lambda: mp_attention.flash_attention_plain(
                q, k, v, fq, fp, causal=causal, q_offset=q_offset),
            library=None))

    def decompose_case(label, w, n_limbs, main=False):
        out = mp_matmul.mp_decompose(w, n_limbs)
        ref = mp_matmul.decompose_plain(w, n_limbs)
        torch.cuda.synchronize()
        # the same round-to-nearest-even cascade: bitwise
        diff = (out.view(torch.int16) != ref.view(torch.int16)).sum().item()
        err = (out.float() - ref.float()).abs().max().item()
        checks["mp_decompose"].append(dict(case=label, max_abs_err=err,
                                           bit_mismatches=diff))
        log(f"[check] mp_decompose {label}: bit mismatches {diff}")
        if diff:
            raise AssertionError(f"mp_decompose {label} is not bitwise its "
                                 "plain version")
        n = w.numel()
        cases["mp_decompose"].append(dict(
            case=label, fmt=f"L{n_limbs}", shape=list(w.shape),
            ops=2 * n_limbs * n, bytes=4 * n + 2 * n_limbs * n,
            peak=card_rates().peak_f32, main=main, per=None,
            fn=lambda: mp_matmul.mp_decompose(w, n_limbs),
            plain=lambda: mp_matmul.decompose_plain(w, n_limbs),
            library=None))

    def prelimbed_case(label, a, w, fmt, n_stored, main=False,
                       library=False, per=None):
        fmt = resolve(fmt)
        limbs = mp_matmul.mp_decompose(w, n_stored)
        out, route = routed_call(mp_matmul.mp_prelimbed_matmul, a, limbs, fmt)
        ref = mp_matmul.prelimbed_matmul_plain(a, limbs, fmt)
        torch.cuda.synchronize()
        K = a.shape[-1]
        hold("mp_prelimbed_matmul", label, out, ref, mm_tol(ref, K),
             {"fmt": fmt.name, "n_stored": n_stored, "route": route})
        if n_stored >= fmt.n_limbs:
            # every limb the format needs is stored: the fused kernel's
            # products in the fused kernel's order, so its bits
            fused = mp_matmul.mp_fused_matmul(a, w, fmt)
            torch.cuda.synchronize()
            if not torch.equal(out, fused):
                raise AssertionError(f"mp_prelimbed_matmul {label} is not "
                                     "bitwise mp_fused_matmul")
            checks["mp_prelimbed_matmul"][-1]["bitwise_vs_fused"] = True
        decode_rows_bitwise(
            "mp_prelimbed_matmul", label,
            lambda x: mp_matmul.mp_prelimbed_matmul(x, limbs, fmt), a, out)
        M, N = out.shape
        ops = 2 * M * K * N * fmt.n_products
        # only the planes the format reads leave device memory
        nbytes = (4 * (a.numel() + out.numel())
                  + 2 * min(n_stored, fmt.n_limbs) * K * N)
        cases["mp_prelimbed_matmul"].append(dict(
            case=label, fmt=fmt.name, n_stored=n_stored, a=list(a.shape),
            b=list(w.shape), ops=ops, bytes=nbytes, main=main, per=per,
            route=route,
            fn=lambda: mp_matmul.mp_prelimbed_matmul(a, limbs, fmt),
            plain=lambda: mp_matmul.prelimbed_matmul_plain(a, limbs, fmt),
            library=(lambda ar=a.bfloat16().float(), br=w.bfloat16().float():
                     torch.matmul(ar, br)) if library else None,
            # M8 reads plane 0, the bf16 weight: torch.mm of bf16 operands
            # (f32 out) computes its function
            library_bf16=(lambda ab=a.bfloat16(), bb=limbs[0]:
                          torch.mm(ab, bb, out_dtype=torch.float32))
            if library and fmt.name == "M8" else None))

    def solo_bitwise(kernel, label, launch, out, table, lengths, bs):
        """Each slot of ``out`` bitwise the same slot launched alone (B = 1,
        the table cut to its own power-of-two width): a slot's bits may
        depend on nothing but its own inputs."""
        for b, n in enumerate(lengths):
            w = 1 << (max(-(-n // bs), 1) - 1).bit_length()
            one = launch(slice(b, b + 1), table[b:b + 1, :w])
            torch.cuda.synchronize()
            if not torch.equal(out[b:b + 1].view(torch.int32),
                               one.view(torch.int32)):
                raise AssertionError(f"{kernel} {label}: slot {b} alone is "
                                     "not bitwise its row of the batch")
        checks[kernel][-1]["solo_bitwise"] = True

    def paged_case(label, lengths, H, Hkv, qk, pv, Dh=64, bs=16, main=False,
                   per=None, data=None, W=None, plant=()):
        B = len(lengths)
        q, kp, vp, table, ln = paged_inputs(
            torch, data or randn, lengths, H, Hkv, Dh, bs, perm_seed=B, W=W,
            plant=plant)
        W = table.shape[1]
        fq, fp = resolve(qk), resolve(pv)
        out = mp_attention.mp_paged_attention(q, kp, vp, table, ln, fq, fp)
        ref = mp_attention.paged_attention_plain(q, kp, vp, table, ln, fq, fp,
                                                 scale=Dh ** -0.5)
        torch.cuda.synchronize()
        # the same pool blocks and online-softmax steps on both sides: only
        # f32 summation order differs (flash's same-blocking tolerance)
        hold("mp_paged_attention", label, out, ref, 2e-5 + 2e-5 * ref.abs(),
             {"fmt": f"{qk}/{pv}"})
        for b, n in enumerate(lengths):
            if n == 0 and out[b].any():
                raise AssertionError(f"mp_paged_attention {label}: a "
                                     "length-0 slot is not exact zeros")
        solo_bitwise("mp_paged_attention", label,
                     lambda s, t: mp_attention.mp_paged_attention(
                         q[s], kp, vp, t, ln[s], fq, fp),
                     out, table, lengths, bs)
        toks = sum(lengths)
        ops = 2 * H * toks * Dh * (fq.n_products + fp.n_products)
        # blocks below each slot's length only, plus q, out, table, lengths
        nbytes = (4 * 2 * Hkv * Dh * toks + 4 * (q.numel() + out.numel())
                  + 4 * (table.numel() + B))
        cases["mp_paged_attention"].append(dict(
            case=label, fmt=f"{qk}/{pv}", lengths=list(lengths), H=H,
            Hkv=Hkv, bs=bs, W=W, ops=ops, bytes=nbytes, main=main, per=per,
            fn=lambda: mp_attention.mp_paged_attention(q, kp, vp, table, ln,
                                                       fq, fp),
            plain=lambda: mp_attention.paged_attention_plain(
                q, kp, vp, table, ln, fq, fp, scale=Dh ** -0.5),
            library=None))

    def lane_vectors(fmts):
        """(M,) int32 device lanes of per-row formats."""
        return (torch.tensor([f.n_limbs for f in fmts], dtype=torch.int32,
                             device=dev),
                torch.tensor([f.max_order for f in fmts], dtype=torch.int32,
                             device=dev))

    def envelope(fmts):
        return lanes.envelope_format(max(f.n_limbs for f in fmts),
                                     max(f.max_order for f in fmts))

    def mixed_case(label, a, w, names, n_stored, main=False, per=None):
        """Rows of a at the formats ``names`` (cycled; "PAD" = PAD_LANE)
        against the stored limbs of w: each row bitwise the homogeneous
        pre-limbed kernel at its format, all rows against the plain
        version at the matmul tolerance."""
        pad = lanes.envelope_format(*lanes.PAD_LANE)
        fmts = [pad if n == "PAD" else resolve(n) for n in names]
        fmts = (fmts * a.shape[0])[:a.shape[0]]
        env = envelope(fmts)
        limbs = mp_matmul.mp_decompose(w, n_stored)
        ln, lo = lane_vectors(fmts)
        out = mp_matmul.mp_mixed_prelimbed_matmul(a, limbs, env, ln, lo)
        ref = mp_matmul.mixed_prelimbed_matmul_plain(a, limbs, env, ln, lo)
        torch.cuda.synchronize()
        K = a.shape[-1]
        hold("mp_mixed_prelimbed_matmul", label, out, ref, mm_tol(ref, K),
             {"fmt": env.name, "n_stored": n_stored})
        for f in sorted(set(fmts), key=lambda f: f.name):
            rows = [i for i, x in enumerate(fmts) if x == f]
            homo = mp_matmul.mp_prelimbed_matmul(a[rows], limbs, f)
            torch.cuda.synchronize()
            if not torch.equal(out[rows].view(torch.int32),
                               homo.view(torch.int32)):
                raise AssertionError(
                    f"mp_mixed_prelimbed_matmul {label}: the {f.name} rows "
                    "are not bitwise mp_prelimbed_matmul's")
        checks["mp_mixed_prelimbed_matmul"][-1]["rows_bitwise"] = True

        def padded(x):
            # the rows past a's run at PAD_LANE under the same envelope
            pn, po = (torch.full((x.shape[0] - a.shape[0],), v,
                                 dtype=torch.int32, device=dev)
                      for v in lanes.PAD_LANE)
            return mp_matmul.mp_mixed_prelimbed_matmul(
                x, limbs, env, torch.cat([ln, pn]), torch.cat([lo, po]))

        decode_rows_bitwise("mp_mixed_prelimbed_matmul", label, padded, a,
                            out)
        M, N = out.shape
        # the products each row keeps (its own lane), the envelope's planes
        # read once, A and C, and the two lane vectors
        ops = 2 * K * N * sum(f.n_products for f in fmts)
        nbytes = (4 * (a.numel() + out.numel()) + 8 * M
                  + 2 * min(n_stored, env.n_limbs) * K * N)
        cases["mp_mixed_prelimbed_matmul"].append(dict(
            case=label, fmt=env.name, lanes=[f.name for f in fmts],
            n_stored=n_stored, a=list(a.shape), b=list(w.shape), ops=ops,
            bytes=nbytes, main=main, per=per,
            fn=lambda: mp_matmul.mp_mixed_prelimbed_matmul(a, limbs, env,
                                                           ln, lo),
            plain=lambda: mp_matmul.mixed_prelimbed_matmul_plain(
                a, limbs, env, ln, lo),
            library=None))

    def mixed_paged_case(label, lengths, H, Hkv, slot_modes, Dh=64, bs=16,
                         main=False, per=None, data=None, W=None, plant=()):
        """Slot b at the (qk, pv) formats ``slot_modes[b]`` (cycled): each
        slot bitwise the paged kernel at its formats and bitwise itself
        launched alone, all slots against the plain version at 2e-5, a
        length-0 slot exact zeros."""
        B = len(lengths)
        slot_modes = (list(slot_modes) * B)[:B]
        q, kp, vp, table, ln = paged_inputs(
            torch, data or randn, lengths, H, Hkv, Dh, bs, perm_seed=B + 1,
            W=W, plant=plant)
        W = table.shape[1]
        fq = [resolve(a) for a, _ in slot_modes]
        fp = [resolve(b) for _, b in slot_modes]
        eq, ep = envelope(fq), envelope(fp)
        lv = (*lane_vectors(fq), *lane_vectors(fp))
        out = mp_attention.mp_mixed_paged_attention(q, kp, vp, table, ln, eq,
                                                    ep, *lv)
        ref = mp_attention.mixed_paged_attention_plain(
            q, kp, vp, table, ln, eq, ep, *lv, scale=Dh ** -0.5)
        torch.cuda.synchronize()
        hold("mp_mixed_paged_attention", label, out, ref,
             2e-5 + 2e-5 * ref.abs(), {"fmt": f"{eq.name}/{ep.name}"})
        for b in range(B):
            homo = mp_attention.mp_paged_attention(q, kp, vp, table, ln,
                                                   fq[b], fp[b])
            torch.cuda.synchronize()
            if not torch.equal(out[b].view(torch.int32),
                               homo[b].view(torch.int32)):
                raise AssertionError(
                    f"mp_mixed_paged_attention {label}: slot {b} is not "
                    "bitwise mp_paged_attention's")
            if lengths[b] == 0 and out[b].any():
                raise AssertionError(f"mp_mixed_paged_attention {label}: a "
                                     "length-0 slot is not exact zeros")
        checks["mp_mixed_paged_attention"][-1]["slots_bitwise"] = True
        solo_bitwise("mp_mixed_paged_attention", label,
                     lambda s, t: mp_attention.mp_mixed_paged_attention(
                         q[s], kp, vp, t, ln[s], eq, ep,
                         *(x[s] for x in lv)),
                     out, table, lengths, bs)
        ops = sum(2 * H * n * Dh * (a.n_products + b.n_products)
                  for n, a, b in zip(lengths, fq, fp))
        toks = sum(lengths)
        nbytes = (4 * 2 * Hkv * Dh * toks + 4 * (q.numel() + out.numel())
                  + 4 * (table.numel() + B) + 16 * B)
        cases["mp_mixed_paged_attention"].append(dict(
            case=label, fmt=f"{eq.name}/{ep.name}",
            slots=[f"{a}/{b}" for a, b in slot_modes],
            lengths=list(lengths), H=H, Hkv=Hkv, bs=bs, W=W, ops=ops,
            bytes=nbytes, main=main, per=per,
            fn=lambda: mp_attention.mp_mixed_paged_attention(
                q, kp, vp, table, ln, eq, ep, *lv),
            plain=lambda: mp_attention.mixed_paged_attention_plain(
                q, kp, vp, table, ln, eq, ep, *lv, scale=Dh ** -0.5),
            library=None))

    cfg = paper_mpfp.CONFIG
    d, ff, V, L = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.n_layers
    x = randn(2048, d)
    matmul_case("prefill lm_head 2048x768x32000", x, randn(d, V) * 0.03,
                "M16", main=True, per=("prefill", 1))
    cache_k = randn(8, 512, 12, 64)
    qh = randn(8, 1, 12, 64).permute(0, 2, 1, 3) * 0.125
    matmul_case("decode QK 96 x 1x64x512", qh,
                cache_k.permute(0, 2, 1, 3).transpose(-1, -2), "M16",
                per=("decode", L))
    p = torch.softmax(randn(8, 12, 1, 512), dim=-1)
    matmul_case("decode PV 96 x 1x512x64", p,
                randn(8, 512, 12, 64).permute(0, 2, 1, 3), "M8",
                library=True, per=("decode", L))
    w_o, w_down = randn(d, d) * 0.03, randn(ff, d) * 0.02
    matmul_case("prefill wo 2048x768x768", x, w_o, "M8", library=True,
                per=("prefill", L))
    matmul_case("prefill w_down 2048x3072x768", randn(2048, ff), w_down,
                "M8", library=True, per=("prefill", L))
    matmul_case("decode wo 8x768x768", randn(8, d), w_o, "M8", library=True,
                per=("decode", L))
    matmul_case("decode w_down 8x3072x768", randn(8, ff), w_down, "M8",
                library=True, per=("decode", L))
    matmul_case("decode lm_head 8x768x32000", randn(8, d),
                randn(d, V) * 0.03, "M16", per=("decode", 1))
    # a partly filled decode micro-batch (own generator: every other case
    # keeps its data)
    for m in (1, 4):
        matmul_case(f"decode w_down {m}x3072x768",
                    torch.randn(m, ff, generator=gen70, device=dev), w_down,
                    "M8", library=True)
    matmul_case("wo 2048x768x768 M23", x, randn(d, d), "M23")
    matmul_case("wo 2048x768x768 M36", x, randn(d, d), "M36")
    matmul_case("ragged 1000x700x300 M23", randn(1000, 700),
                randn(700, 300), "M23")
    matmul_case("ragged 200x333x77 M52", randn(200, 333), randn(333, 77),
                "M52")
    # the partials epilogue at [dist]'s K-sharded prefill shapes (two
    # ranks: half of K each)
    partials_case(f"lm_head prefill K/2 2048x{d // 2}x{V}", x[:, :d // 2],
                  randn(d // 2, V) * 0.03, "M16", main=True)
    partials_case(f"w_down prefill K/2 2048x{ff // 2}x{d}",
                  randn(2048, ff // 2), w_down[:ff // 2], "M8")

    wq = [randn(d, d) * 0.03 for _ in range(3)]
    proj_case("prefill QKV 2048x768 vs 3x768x768", x, wq, "M8", main=True,
              library=True, per=("prefill", L))
    wg = [randn(d, ff) * 0.03 for _ in range(2)]
    proj_case("prefill SwiGLU 2048x768 vs 2x768x3072", x, wg, "M8",
              gate="swiglu", per=("prefill", L), bf16=True)
    proj_case("decode SwiGLU 8x768 vs 2x768x3072", randn(8, d), wg, "M8",
              gate="swiglu", library=True, per=("decode", L))
    proj_case("decode QKV 8x768 vs 3x768x768", randn(8, d), wq, "M8",
              library=True, per=("decode", L))
    proj_case("QKV 512x768 M23", x[:512], wq, "M23")
    proj_case("QKV 512x768 M36", x[:512], wq, "M36")
    proj_case("SwiGLU+bias+res 300x768 M16", x[:300], wg, "M16",
              gate="swiglu", biases=[randn(ff), randn(ff)],
              residual=randn(300, ff))
    proj_case("1 out+bias+res 300x768 M23", x[:300], wq[:1], "M23",
              biases=[randn(d)], residual=randn(300, d))
    # rows of 280 bytes: the strided prefill tile (its own generator, so
    # the cases after it keep their data)
    genr = torch.Generator(device=dev).manual_seed(27)

    def randr(*shape):
        return torch.randn(*shape, generator=genr, device=dev)

    proj_case("ragged QKV 130x200 vs 3x200x70 M16", randr(130, 200),
              [randr(200, 70) * 0.05 for _ in range(3)], "M16")

    # the cases after the first four draw from their own generator: every
    # other case keeps its data
    genf = torch.Generator(device=dev).manual_seed(19)

    def randf(*shape):
        return torch.randn(*shape, generator=genf, device=dev)

    for i, (label, *shape, qk, pv, causal, q_off, plant) in enumerate(
            FLASH_CASES):
        flash_case(label, *shape, qk, pv, causal, q_offset=q_off,
                   plant=plant, main=i == 0,
                   per=("prefill", L) if i == 0 else None,
                   data=randn if i < 4 else randf)

    # the scheduler slice's kernels at the decode path's shapes: serve_default
    # pre-limbs at 2 limbs (lm_head M16), so M8 matmuls run with one extra
    # stored plane and read plane 0 only
    w_up, w_lm = randn(d, ff) * 0.03, randn(d, V) * 0.03
    decompose_case("lm_head 768x32000 L2", w_lm, 2, main=True)
    decompose_case("w_up 768x3072 L2", w_up, 2)
    decompose_case("w_down 3072x768 L2", w_down, 2)
    decompose_case("wo 768x768 L2", w_o, 2)
    decompose_case("ragged 37x300 L1", randn(37, 300), 1)
    decompose_case("ragged 37x300 L3", randn(37, 300), 3)
    x8 = randn(8, d)
    prelimbed_case("decode wq/wk/wv/wo 8x768x768 M8", x8, w_o, "M8", 2,
                   library=True, per=("tick", 4 * L))
    prelimbed_case("decode w_gate/w_up 8x768x3072 M8", x8, w_up, "M8", 2,
                   library=True, per=("tick", 2 * L))
    prelimbed_case("decode w_down 8x3072x768 M8", randn(8, ff), w_down, "M8",
                   2, main=True, library=True, per=("tick", L))
    prelimbed_case("decode lm_head 8x768x32000 M16", x8, w_lm, "M16", 2,
                   per=("tick", 1))
    for m in (1, 4):
        prelimbed_case(f"decode w_down {m}x3072x768 M8",
                       torch.randn(m, ff, generator=gen70, device=dev),
                       w_down, "M8", 2, library=True)
    prelimbed_case("decode wo M16 from 1 stored limb", x8, w_o, "M16", 1)
    # the formats of the mixed-traffic tick, homogeneous, at w_down's shape:
    # what each launch of the per-policy plan runs and what the mixed kernel
    # at the (3 limbs, order 2) envelope is compared with
    spec = dict(CUSTOM)
    custom = register_format(spec.pop("name"), **spec)
    x_ff = randn(8, ff)
    for m in ("M16", "M23", custom.name):
        prelimbed_case(f"decode w_down 8x3072x768 {m}", x_ff, w_down, m, 3)
    prelimbed_case("wo 512x768x768 M23", x[:512], randn(d, d), "M23", 3)
    prelimbed_case("wo 256x768x768 M36", x[:256], randn(d, d), "M36", 5)
    prelimbed_case("ragged 37x300x77 M16", randn(37, 300), randn(300, 77),
                   "M16", 3)
    # planes of 154-byte rows, which no tensor map reads: the split route's
    # single-block tile
    prelimbed_case("decode ragged 8x300x77 M16", randr(8, 300),
                   randr(300, 77), "M16", 2)
    decode_lengths = [int(n) for n in np.linspace(64, 288, 8)]
    paged_case(f"decode 8 slots H12 lengths {decode_lengths[0]}.."
               f"{decode_lengths[-1]}", decode_lengths, 12, 12, "M16", "M8",
               main=True, per=("tick", L))
    paged_case("GQA n_rep 2, a length-0 slot, mid-block ends",
               [0, 37, 16, 1, 100], 12, 6, "M16", "M8")
    paged_case("M23/M16 lengths 5, 250", [5, 250], 4, 4, "M23", "M16")
    # what the chunked walk changes (own generator: every other case keeps
    # its data): lengths at the chunk's edges, the largest logit in the
    # first column, in the last, rising in every column (m_j moves inside
    # a chunk), and a table far wider than the slots
    genp = torch.Generator(device=dev).manual_seed(18)

    def randp(*shape):
        return torch.randn(*shape, generator=genp, device=dev)

    edge = chunk_cols * 16
    edge_lengths = [edge - 1, edge, edge + 1, 2 * edge - 1, 2 * edge,
                    2 * edge + 1, 1, 16]
    max_lengths = [200, 200, 200, 2 * edge + 1]
    plant = ([(0, 5, 8.0), (1, 197, 8.0), (3, 2 * edge, 8.0)]
             + [(2, 16 * j + 7, 2.0 + 0.5 * j) for j in range(13)])
    wide_lengths = [5, 16, 17, 70]
    paged_case(f"chunk edges {edge - 1}..{2 * edge + 1}", edge_lengths, 12,
               12, "M16", "M8", data=randp)
    paged_case("max in the first / last column, rising", max_lengths, 12, 12,
               "M16", "M8", data=randp, plant=plant)
    paged_case("W 64 columns, slots of 1..5", wide_lengths, 12, 12, "M16",
               "M8", data=randp, W=64)

    # the mixed-lane kernels: the mixed-traffic tick's rows (two per mode,
    # envelope M23's 3 limbs, stored at 3), then M36, PAD_LANE rows, a
    # ragged shape and the generic instantiation
    tick_modes = [m for m in MODES for _ in range(2)]
    mixed_case("decode wq/wk/wv/wo 8x768x768 mixed", x8, w_o, tick_modes, 3,
               per=("mtick", 4 * L))
    mixed_case("decode w_gate/w_up 8x768x3072 mixed", x8, w_up, tick_modes,
               3, per=("mtick", 2 * L))
    mixed_case("decode w_down 8x3072x768 mixed", x_ff, w_down,
               tick_modes, 3, main=True, per=("mtick", L))
    mixed_case("decode lm_head 8x768x32000 mixed", x8, w_lm, tick_modes, 3,
               per=("mtick", 1))
    mixed_case("8x768x768 M8/M16/M23/M36/custom/PAD", x8, w_o,
               ["M8", "M16", "M23", "M36", custom.name, "PAD", "PAD", "M8"],
               5)
    mixed_case("ragged 13x300x77 M8/custom/PAD/M16 (generic)",
               randn(13, 300), randn(300, 77),
               ["M8", custom.name, "PAD", "M16"], 2)
    mixed_case("ragged 13x700x300 M16/M52/M8 from 5 stored", randn(13, 700),
               randn(700, 300), ["M16", "M52", "M8"], 5)
    slot_modes = [(m, m) for m in tick_modes]
    mixed_paged_case(f"decode 8 slots H12 lengths {decode_lengths[0]}.."
                     f"{decode_lengths[-1]} two per mode", decode_lengths,
                     12, 12, slot_modes, main=True, per=("mtick", L))
    mixed_paged_case(
        "GQA n_rep 2, a length-0 slot, mixed qk/pv",
        [0, 37, 16, 1, 100, 64, 5, 200], 12, 6,
        [("M16", "M8"), ("M8", "M8"), ("M23", "M16"), (custom.name, "M23"),
         ("M16", custom.name), ("M8", "M23"), ("M23", "M23"),
         ("M36", "M8")])

    edge_modes = [("M16", "M8"), ("M8", "M8"), ("M23", "M16"),
                  (custom.name, "M23")]
    mixed_paged_case(f"chunk edges {edge - 1}..{2 * edge + 1} mixed",
                     edge_lengths, 12, 12, edge_modes, data=randp)
    mixed_paged_case("max in the first / last column, rising, mixed",
                     max_lengths, 12, 12, edge_modes, data=randp, plant=plant)
    mixed_paged_case("W 64 columns, slots of 1..5, mixed", wide_lengths, 12,
                     12, edge_modes, data=randp, W=64)

    # the training slice's shapes: paper-mpfp-100m at batch 8 x 128 under
    # train_default (M16, lm_head M23), as a step's backward gives them to
    # the forward kernels (own generator: every other case keeps its data)
    gent = torch.Generator(device=dev).manual_seed(20)

    def randt(*shape):
        return torch.randn(*shape, generator=gent, device=dev)

    tok = TRAIN_BATCH * TRAIN_SEQ
    w_down_t, w_lm_t = randt(ff, d) * 0.02, randt(d, V) * 0.03
    g_d, g_lm, h_ff = randt(tok, d), randt(tok, V) * 1e-3, randt(tok, ff)
    # dgrad g @ W^T: W^T a view with unit row stride, which the wrapper
    # copies to row-major; the launch on the view timed beside it
    matmul_case(f"train dgrad w_down {tok}x{d}x{ff} (W^T view) M16", g_d,
                w_down_t.t(), "M16", contig=True)
    matmul_case(f"train dgrad lm_head {tok}x{V}x{d} (W^T view) M23", g_lm,
                w_lm_t.t(), "M23", contig=True)
    # the attention backward's five both-batched products on (B, H, S, Dh)
    # views of (B, S, H, Dh) tensors: each (b, h) bitwise launched alone
    nh, dh = cfg.n_heads, cfg.resolved_head_dim

    def bhsd(scale=1.0):
        return (randt(TRAIN_BATCH, TRAIN_SEQ, nh, dh) * scale).permute(
            0, 2, 1, 3)

    qs_t, k_t, v_t, go_t = bhsd(dh ** -0.5), bhsd(), bhsd(), bhsd()
    p_t = torch.softmax(randt(TRAIN_BATCH, nh, TRAIN_SEQ, TRAIN_SEQ),
                        dim=-1)
    ds_t = randt(TRAIN_BATCH, nh, TRAIN_SEQ, TRAIN_SEQ) * 1e-3
    bh = f"{TRAIN_BATCH * nh} x {TRAIN_SEQ}x"
    for label, x_, y_ in (
            (f"logits Qs K^T {bh}{dh}x{TRAIN_SEQ}", qs_t,
             k_t.transpose(-1, -2)),
            (f"dV = P^T dO {bh}{TRAIN_SEQ}x{dh}", p_t.transpose(-1, -2), go_t),
            (f"dP = dO V^T {bh}{dh}x{TRAIN_SEQ}", go_t, v_t.transpose(-1, -2)),
            (f"dQ = dS K {bh}{TRAIN_SEQ}x{dh}", ds_t, k_t),
            (f"dK = dS^T Qs {bh}{TRAIN_SEQ}x{dh}", ds_t.transpose(-1, -2),
             qs_t)):
        matmul_case(f"train attn bwd {label} M16", x_, y_, "M16", solo=True)
    # a weight gradient as the kernel would take it (x^T a view): the
    # step takes the same contraction as one plain product (mp_wgrad_ref,
    # timed in [train])
    matmul_case(f"train wgrad w_down as a matmul {ff}x{tok}x{d} (x^T view) "
                "M16", h_ff.t(), g_d, "M16", contig=True)
    x_t = randt(tok, d)
    proj_case(f"train QKV {tok}x{d} vs 3x{d}x{d} M16 (no gate)", x_t,
              [randt(d, d) * 0.03 for _ in range(3)], "M16")
    proj_case(f"train gate/up {tok}x{d} vs 2x{d}x{ff} M16 (no gate)", x_t,
              [randt(d, ff) * 0.03 for _ in range(2)], "M16")
    flash_case(f"train ({TRAIN_BATCH},{TRAIN_SEQ},{nh},{dh}) causal "
               "M16/M16", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, nh, dh, "M16",
               "M16", True, data=randt)

    # ---- 3b. [modes]: the paper's six modes through repro_torch.mp --------
    # the quickstart's surface at the model's prefill shapes: f32 operands at
    # every built-in format and a run-time M30 (4 limbs, order 3), two-float
    # (DD) operands at M36 / M52, M52 DD once at the lm_head shape, AUTO on
    # integer and float data; counts zeroed just before, read just after
    m30 = mp.register_format("M30", mantissa_bits=30, n_limbs=4, max_order=3)
    f32_fmts = ("M8", "M16", "M23", "M36", "M52", m30.name)
    mrng = np.random.default_rng(1)
    mshapes = {"w_up 2048x768x3072": (2048, d, ff),
               "w_down 2048x3072x768": (2048, ff, d),
               "lm_head 2048x768x32000": (2048, d, V)}
    m64 = {k: (mrng.standard_normal((M, K)), mrng.standard_normal((K, N)))
           for k, (M, K, N) in mshapes.items()}
    mf32 = {k: tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
                     for x in v) for k, v in m64.items()}
    mdd = {k: tuple(limbs_lib.dd_from_f64(x) for x in v)
           for k, v in m64.items()}
    ia = torch.from_numpy(mrng.integers(-99, 99, (2048, d)).astype(
        np.float32)).to(dev)
    ib = torch.from_numpy(mrng.integers(-99, 99, (d, ff)).astype(
        np.float32)).to(dev)
    runs = [(k, f, "f32") for k in list(mshapes)[:2] for f in f32_fmts]
    runs += [(k, f, "dd") for k in list(mshapes)[:2] for f in ("M36", "M52")]
    runs += [("lm_head 2048x768x32000", "M52", "dd")]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mode_out = {}
    for k, f, kind in runs:
        a_, b_ = (mf32 if kind == "f32" else mdd)[k]
        mode_out[(k, f, kind)] = mp.mp_matmul(a_, b_, f)
    auto_int = mp.mp_matmul(ia, ib, mp.AUTO)
    auto_float = mp.mp_matmul(*mf32["w_up 2048x768x3072"], mp.AUTO)
    torch.cuda.synchronize()
    modes_s = time.perf_counter() - t0
    md_launches = kernels.launch_counts()
    md_routes = kernels.route_counts()
    md_reads = auto_lib.mp_matmul_auto.host_reads
    n_f32 = sum(kind == "f32" for _, _, kind in runs)
    md_want = {**dict.fromkeys(kernels.KERNELS, 0),
               "mp_fused_matmul": n_f32 + 2,
               "mp_both_prelimbed_matmul": len(runs) - n_f32}
    # every DD launch (built-in formats, stacks a tensor map reads) on the
    # both-prelimbed matmul's TMA tile
    md_want_both = {"tma": len(runs) - n_f32, "mma": 0}
    log(f"[modes] {len(runs)} facade calls + 2 AUTO in {modes_s:.3f} s: "
        f"launches {md_launches}, AUTO host reads {md_reads}; the "
        f"both-prelimbed matmul's routes "
        f"{md_routes['mp_both_prelimbed_matmul']}")
    if (md_launches != md_want or md_reads != 2
            or md_routes["mp_both_prelimbed_matmul"] != md_want_both
            or any(kernels.plain_call_counts().values())):
        raise AssertionError(f"[modes] launches {md_launches} != {md_want} "
                             f"or host reads {md_reads} != 2 or the "
                             f"both-prelimbed routes "
                             f"{md_routes['mp_both_prelimbed_matmul']} != "
                             f"{md_want_both}")
    modes_rel = {}
    for (k, f, kind), out in mode_out.items():
        a64, b64 = m64[k]
        K = a64.shape[1]
        gold = (torch.from_numpy(a64).to(dev)
                @ torch.from_numpy(b64).to(dev))
        rel = ((out.double() - gold).norm() / gold.norm()).item()
        modes_rel[f"{k} {f} {kind}"] = rel
        fmt = resolve(f)
        if kind == "f32":
            lim = f32_bound(fmt, K)
        else:
            lim = 8 * U32 * math.sqrt(K)  # tests/test_kernels.py, DD
        log(f"[modes] {k} {f} on {kind} operands: rel err vs float64 "
            f"{rel:.3e} (limit {lim:.3e})")
        if not torch.isfinite(out).all() or rel >= lim:
            raise AssertionError(f"[modes] {k} {f} {kind}: rel {rel} >= "
                                 f"{lim}")
    for k in list(mshapes)[:2]:
        r = [modes_rel[f"{k} {f} f32"] for f in ("M8", "M16", "M23")]
        if not r[0] > r[1] > r[2]:
            raise AssertionError(f"[modes] {k}: accuracy not monotone in "
                                 f"the format {r}")

    def both_case(label, al, bl, fmt, out=None, bitwise=None, timed=False,
                  main=False, gold=None, route=None):
        """The both-prelimbed kernel's result ``out`` on the stacks (al, bl)
        (launched here when None) against its plain version; ``bitwise``:
        the fused kernel's result it must equal bit for bit; ``timed``: a
        case of the ``[time]`` lines; ``gold``: its error against the
        float64 golden and the bound (held in ``[modes]``) for that line;
        ``route``: the route the stacks must take."""
        fmt = resolve(fmt)
        got = mp_matmul.both_route(al, bl, fmt)
        if route is not None and got != route:
            raise AssertionError(f"mp_both_prelimbed_matmul {label} routes "
                                 f"to {got}, not {route}")
        if out is None:
            out = mp_matmul.mp_both_prelimbed_matmul(al, bl, fmt)
        ref = mp_matmul.both_prelimbed_matmul_plain(al, bl, fmt)
        torch.cuda.synchronize()
        K = al.shape[-1]
        hold("mp_both_prelimbed_matmul", label, out, ref, mm_tol(ref, K),
             {"fmt": fmt.name, "stored": [al.shape[0], bl.shape[0]],
              "route": got})
        if bitwise is not None:
            if not torch.equal(out.view(torch.int32),
                               bitwise.view(torch.int32)):
                raise AssertionError(f"mp_both_prelimbed_matmul {label} is "
                                     "not bitwise mp_fused_matmul")
            checks["mp_both_prelimbed_matmul"][-1]["bitwise_vs_fused"] = True
        if not timed:
            return
        M, N = out.shape
        L = fmt.n_limbs
        ops = 2 * M * K * N * fmt.n_products
        # the planes the format reads, once each, and C
        nbytes = (2 * (min(al.shape[0], L) * M * K + min(bl.shape[0], L)
                       * K * N) + 4 * M * N)
        cases["mp_both_prelimbed_matmul"].append(dict(
            case=label, fmt=fmt.name, a=[M, K], b=[K, N], ops=ops,
            bytes=nbytes, main=main, per=None, route=got, **(gold or {}),
            fn=lambda: mp_matmul.mp_both_prelimbed_matmul(al, bl, fmt),
            plain=lambda: mp_matmul.both_prelimbed_matmul_plain(al, bl, fmt),
            library=None))

    # the DD calls of the facade: the kernel against its plain version on
    # the same stacks (decompose_dd's, plain PyTorch on the card)
    for (k, f, kind), out in mode_out.items():
        if kind != "dd":
            continue
        n = resolve(f).n_limbs
        al, bl = (limbs_lib.decompose_dd(x, n) for x in mdd[k])
        main = k.startswith("lm_head")
        K = m64[k][0].shape[1]
        both_case(f"DD {k} {f}", al, bl, f, out=out, main=main,
                  timed=main or (k.startswith("w_down") and f == "M36"),
                  gold=dict(gold_rel=modes_rel[f"{k} {f} {kind}"],
                            gold_bound=8 * U32 * math.sqrt(K)),
                  route=mp_matmul.TMA)
    # on stacks cut from f32 operands: bitwise the fused kernel's result
    a32, b32 = mf32["w_up 2048x768x3072"]
    for f in f32_fmts:
        n = resolve(f).n_limbs
        both_case(f"w_up 2048x768x3072 {f} on decompose(a), decompose(b)",
                  mp_matmul.mp_decompose(a32, n),
                  mp_matmul.mp_decompose(b32, n), f,
                  bitwise=mode_out[("w_up 2048x768x3072", f, "f32")])
    ra, rb = randn(37, 300), randn(300, 77)
    both_case("ragged 37x300x77 M52 from 3 and 7 stored",
              mp_matmul.mp_decompose(ra, 3), mp_matmul.mp_decompose(rb, 7),
              "M52")
    # a DD stack no tensor map reads (A's rows of 666 bytes): the mma.sync
    # tile, held against the plain version on every run
    rag = [limbs_lib.dd_from_f64(mrng.standard_normal(sh))
           for sh in ((200, 333), (333, 77))]
    both_case("DD ragged 200x333x77 M52 (rows no tensor map reads)",
              *(limbs_lib.decompose_dd(x, 7) for x in rag), "M52",
              route=mp_matmul.MMA)
    # AUTO: M8 on integers with an exact product; the float data's choice
    int_gold = ia.double() @ ib.double()
    rep_int = mp.auto_report(ia, ib)
    rep_float = mp.auto_report(*mf32["w_up 2048x768x3072"])
    exact = torch.equal(auto_int.double(), int_gold)
    log(f"[modes] AUTO on integers: {rep_int['selected_format']} "
        f"(sig limbs {rep_int['sig_limbs_a']}/{rep_int['sig_limbs_b']}), "
        f"product exact {exact}; on floats: {rep_float['selected_format']} "
        f"(sig limbs {rep_float['sig_limbs_a']}/{rep_float['sig_limbs_b']})")
    if rep_int["selected_format"] != "M8" or not exact:
        raise AssertionError("[modes] AUTO on integers is not an exact M8")
    float_fmt = rep_float["selected_format"]
    if not torch.equal(auto_float,
                       mode_out[("w_up 2048x768x3072", float_fmt, "f32")]):
        raise AssertionError("[modes] AUTO on floats is not its selected "
                             "format's result")
    report["modes"] = dict(
        seconds=modes_s, launches=md_launches, host_reads=md_reads,
        routes=md_routes,
        rel_vs_f64=modes_rel, auto_int=rep_int["selected_format"],
        auto_float=float_fmt, auto_int_exact=exact)
    del mode_out, mf32, mdd, auto_int, auto_float, int_gold
    torch.cuda.empty_cache()

    # ---- 4. the main path -------------------------------------------------
    params = T.init_params(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                      prelimb_weights=False,
                      policy=PrecisionPolicy.serve_default())
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in np.linspace(64, 256, 8)]
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int64)
               for n in lengths]
    assert max(lengths) == 256
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=32)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    main_routes = kernels.route_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] generate 8 prompts {lengths} x 32 new: {gen_s:.3f} s, "
        f"{8 * 32 / gen_s:.1f} tokens/s, peak {peak / 2**30:.2f} GiB, "
        f"launches {launches}; the fused matmul's routes "
        f"{main_routes['mp_fused_matmul']}, the projection's "
        f"{main_routes['mp_fused_proj']}")
    if launches != EXPECTED:
        raise AssertionError(f"launches {launches} != expected {EXPECTED}")
    if main_routes["mp_fused_matmul"] != EXPECTED_ROUTES:
        raise AssertionError(f"routes {main_routes['mp_fused_matmul']} != "
                             f"expected {EXPECTED_ROUTES}")
    if main_routes["mp_fused_proj"] != EXPECTED_PROJ_ROUTES:
        raise AssertionError(f"projection routes "
                             f"{main_routes['mp_fused_proj']} != expected "
                             f"{EXPECTED_PROJ_ROUTES}")
    if len(outs) != 8 or any(len(o) != 32 for o in outs) or any(
            not 0 <= t < cfg.vocab for o in outs for t in o):
        raise AssertionError("generate returned malformed token streams")
    main_outs = [list(o) for o in outs]

    toks = eng.pad_prompts(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = eng.prefill(toks, eng.make_cache())
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    probe = eng.decode_throughput_probe(steps=16)
    ref_eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                          matmul_backend="ref", prelimb_weights=False,
                          policy=PrecisionPolicy.serve_default())
    ref_logits, _ = ref_eng.prefill(toks, ref_eng.make_cache())
    a, b = logits[:, -1].double(), ref_logits[:, -1].double()
    rel = ((a - b).norm() / b.norm()).item()
    # the repo-wide convention: 4x the loosest format bound in the policy
    # (M8: 2^-6) on the tensor norm; ref runs unblocked attention and plain
    # adds, the kernels blocked attention and compensated order sums
    rel_tol = 4 * 2.0 ** -6
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"[main] prefill {prefill_ms:.1f} ms; decode "
        f"{probe['ms_per_step']:.3f} ms/step {probe['tokens_per_s']:.1f} "
        f"tokens/s; last-token logits vs ref backend: rel {rel:.3e} "
        f"(tol {rel_tol:.3e}), top-1 agreement {agree:.3f}")
    if not torch.isfinite(logits).all() or rel > rel_tol:
        raise AssertionError("prefill logits disagree with the ref backend")
    report["main"] = dict(lengths=lengths, max_new=32, generate_s=gen_s,
                          tokens_per_s=8 * 32 / gen_s, prefill_ms=prefill_ms,
                          decode_ms_per_step=probe["ms_per_step"],
                          decode_tokens_per_s=probe["tokens_per_s"],
                          peak_bytes=peak, launches=launches,
                          routes=main_routes,
                          logits_rel_vs_ref=rel, top1_agree_vs_ref=agree)

    # ---- 4b. the scheduler path -------------------------------------------
    policy = PrecisionPolicy.serve_default()
    n_req, sched_new = 16, 32
    sched_lengths = [int(n) for n in np.linspace(64, 256, n_req)]
    sched_prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
                     for n in sched_lengths]

    def requests(ids, spaced=True):
        return [ScheduledRequest(rid=i, prompt=sched_prompts[i],
                                 max_new=sched_new,
                                 arrival=2 * i if spaced else 0)
                for i in ids]

    del eng  # the static path's engine: its memory is not this path's
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # resident before the path: the f32 weights and phase 3's inputs
    s_base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s_eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                        prelimb_weights=True, policy=policy)
    torch.cuda.synchronize()
    prelimb_s = time.perf_counter() - t0
    sched = ContinuousScheduler(s_eng, n_blocks=160, block_size=16)
    t1 = time.perf_counter()
    done = sched.run(requests(range(n_req)))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    s_launches = kernels.launch_counts()
    s_routes = kernels.route_counts()
    s_plain = kernels.plain_call_counts()
    s_peak = torch.cuda.max_memory_allocated()
    stats = sched.stats()
    n_dec = stats["decode_launches"]
    want = serve_launches(L, stats["prefills"], n_dec, 0, 1)
    # every pre-limbed launch is a decode one (M <= 16): the split tile
    want_pl = {"cluster": want["mp_prelimbed_matmul"], "mma": 0}
    log(f"[sched] {n_req} requests, prompts {sched_lengths[0]}.."
        f"{sched_lengths[-1]} x {sched_new} new, arrivals 2 ticks apart: "
        f"prelimb {prelimb_s * 1e3:.1f} ms, run {run_s:.3f} s, "
        f"{stats['useful_tokens'] / run_s:.1f} tokens/s, {stats['steps']} "
        f"ticks, {stats['prefills']} prefills, {n_dec} decode launches, "
        f"peak {s_peak / 2**30:.2f} GiB ({(s_peak - s_base) / 2**30:.2f} "
        f"GiB above the {s_base / 2**30:.2f} GiB resident before the path), "
        f"launches {s_launches}; the pre-limbed matmul's routes "
        f"{s_routes['mp_prelimbed_matmul']}")
    if s_launches != want or any(s_plain.values()):
        raise AssertionError(f"scheduler launches {s_launches} != expected "
                             f"{want} (plain calls {s_plain})")
    if s_routes["mp_prelimbed_matmul"] != want_pl:
        raise AssertionError(f"scheduler pre-limbed routes "
                             f"{s_routes['mp_prelimbed_matmul']} != "
                             f"expected {want_pl}")
    out = {r.rid: r.out for r in done}
    if (len(out) != n_req or stats["completed"] != n_req
            or any(len(o) != sched_new for o in out.values())
            or any(not 0 <= t < cfg.vocab for o in out.values() for t in o)
            or stats["blocks_live"] != 0):
        raise AssertionError(f"scheduler run malformed: {stats}")
    lat = {k: stats[k] for k in ("ttft_p50_ms", "ttft_p95_ms", "tpot_p50_ms",
                                 "tpot_p95_ms", "itl_p50_ms", "itl_p95_ms",
                                 "queue_wait_p50_steps",
                                 "queue_wait_p95_steps")}
    log(f"[sched] latency {lat}")

    # port-internal bitwise: streams decoded in micro-batches of up to 8
    # equal their solo scheduled runs
    solo_ids = (0, n_req - 1)
    for i in solo_ids:
        solo = ContinuousScheduler(s_eng, n_blocks=160, block_size=16).run(
            requests([i], spaced=False))[0].out
        if solo != out[i]:
            first = next(t for t, (a, b) in enumerate(zip(solo, out[i]))
                         if a != b)
            raise AssertionError(f"request {i}: batched stream differs from "
                                 f"its solo run at token {first}")
    log(f"[sched] requests {list(solo_ids)}: batched streams == solo runs "
        f"bitwise")

    # one paged prefill's last-token logits against the ref backend
    def paged_prefill_logits(engine, prompt):
        pool = PagedKVPool(L, 24, 16, cfg.n_kv_heads, cfg.resolved_head_dim,
                           max_blocks_per_seq=32, device=dev)
        req = ScheduledRequest(rid=0, prompt=prompt, max_new=sched_new)
        if not prim.try_reserve(pool, req):
            raise AssertionError("the probe pool cannot hold the prompt")
        prefill_fn, _ = engine.paged_steps_for(policy)
        n = len(prompt)
        tokens = np.zeros((1, prim.pow2_at_least(n)), np.int64)
        tokens[0, :n] = prompt
        table = pool.table_row(req.blocks)[None, :prim.table_width(pool,
                                                                  [req])]
        logits, stat, _, _ = prefill_fn(
            engine.params, pool.k, pool.v, engine.to_device(table),
            engine.to_device(np.zeros((1,), np.int32)),
            engine.to_device(tokens), n - 1)
        return logits[0, 0].double()

    a = paged_prefill_logits(s_eng, sched_prompts[-1])
    b = paged_prefill_logits(ref_eng, sched_prompts[-1])
    s_rel = ((a - b).norm() / b.norm()).item()
    log(f"[sched] paged prefill ({sched_lengths[-1]} tokens) last-token "
        f"logits vs ref backend: rel {s_rel:.3e} (tol {rel_tol:.3e}), "
        f"top-1 {'agrees' if a.argmax() == b.argmax() else 'differs'}")
    if not torch.isfinite(a).all() or s_rel > rel_tol:
        raise AssertionError("paged prefill logits disagree with the ref "
                             "backend")

    # decode-only tick probe: 8 active slots (prompts 64..256), no arrivals
    probe = ContinuousScheduler(s_eng, n_blocks=160, block_size=16)
    for r in requests(range(0, n_req, 2), spaced=False):
        r.max_new = 64
        probe.submit(r)
    probe.step()  # admits all 8 (and runs the first tick)
    ticks = 16
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(ticks):
        probe.step()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t2) / ticks * 1e3
    log(f"[sched] decode tick (8 slots, no admissions): {tick_ms:.3f} ms, "
        f"{8e3 / tick_ms:.1f} tokens/s")
    report["sched"] = dict(
        lengths=sched_lengths, max_new=sched_new, prelimb_ms=prelimb_s * 1e3,
        run_s=run_s, tokens_per_s=stats["useful_tokens"] / run_s,
        stats=stats, launches=s_launches, routes=s_routes,
        peak_bytes=s_peak, resident_before_bytes=s_base,
        solo_bitwise=list(solo_ids), logits_rel_vs_ref=s_rel,
        decode_tick_ms=tick_ms)
    del s_eng, sched, probe
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 4c. mixed traffic: one partitioned-lane launch per tick ----------
    def mode_requests(ids, spaced=True, max_new=sched_new):
        reqs = requests(ids, spaced)
        for r in reqs:
            r.mode, r.max_new = MODES[r.rid % len(MODES)], max_new
        return reqs

    with Counted() as step_calls:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        m_eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                            prelimb_weights=True, policy=policy)
        m_sched = ContinuousScheduler(m_eng, n_blocks=160, block_size=16)
        m_done = m_sched.run(mode_requests(range(n_req)))
        torch.cuda.synchronize()
        m_run_s = time.perf_counter() - t0
        m_launches = kernels.launch_counts()
        m_routes = kernels.route_counts()
        m_plain = kernels.plain_call_counts()
    m_stats = m_sched.stats()
    n_mixed, n_bucket = step_calls.steps["mixed"], step_calls.steps["bucket"]
    misses = m_eng.prelimb_cache_misses
    m_want = serve_launches(L, m_stats["prefills"], n_bucket, n_mixed,
                            misses)
    log(f"[mixed] {n_req} requests, modes {list(MODES)} in turn, prompts "
        f"{sched_lengths[0]}..{sched_lengths[-1]} x {sched_new} new, "
        f"arrivals 2 ticks apart: run {m_run_s:.3f} s (prelimbs included), "
        f"{m_stats['useful_tokens'] / m_run_s:.1f} tokens/s, "
        f"{m_stats['steps']} ticks, {m_stats['decode_launches']} decode "
        f"launches ({n_mixed} mixed, {n_bucket} bucket), launches per tick "
        f"{m_stats['launches_per_tick']}, {misses} prelimbs, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{m_launches} ({smi})")
    if m_stats["launches_per_tick"] != 1.0 or n_mixed == 0:
        raise AssertionError(f"mixed traffic is not one launch per tick: "
                             f"{m_stats}, {step_calls.steps}")
    if m_launches != m_want or any(m_plain.values()):
        raise AssertionError(f"mixed launches {m_launches} != expected "
                             f"{m_want} (plain calls {m_plain})")
    # every mixed-lane launch is a decode one (M <= 16): the split tile
    m_want_routes = {"cluster": m_want["mp_mixed_prelimbed_matmul"],
                     "mma": 0}
    log(f"[mixed] the mixed-lane matmul's routes "
        f"{m_routes['mp_mixed_prelimbed_matmul']} (want {m_want_routes})")
    if m_routes["mp_mixed_prelimbed_matmul"] != m_want_routes:
        raise AssertionError(f"mixed-lane routes "
                             f"{m_routes['mp_mixed_prelimbed_matmul']} != "
                             f"expected {m_want_routes}")
    m_out = {r.rid: r.out for r in m_done}
    if (len(m_out) != n_req or m_stats["completed"] != n_req
            or any(len(o) != sched_new for o in m_out.values())
            or any(not 0 <= t < cfg.vocab for o in m_out.values() for t in o)
            or m_stats["blocks_live"] != 0):
        raise AssertionError(f"mixed scheduler run malformed: {m_stats}")
    # two requests of different modes == their solo runs at their modes
    m_solo_ids = (0, n_req - 1)
    for i in m_solo_ids:
        solo = ContinuousScheduler(m_eng, n_blocks=160, block_size=16).run(
            mode_requests([i], spaced=False))[0].out
        if solo != m_out[i]:
            first = next(t for t, (a, b) in enumerate(zip(solo, m_out[i]))
                         if a != b)
            raise AssertionError(f"request {i} ({MODES[i % 4]}): mixed "
                                 f"stream differs from its solo run at "
                                 f"token {first}")
    log(f"[mixed] requests {list(m_solo_ids)} "
        f"({', '.join(MODES[i % 4] for i in m_solo_ids)}): mixed streams == "
        f"solo runs bitwise")

    # mixed decode-tick probe: 8 slots, two per mode, no admissions; the
    # one mixed launch against the per-policy plan on the same slots, in
    # turns (mixed, per-policy, mixed, per-policy), tokens equal
    def per_policy_plan(reqs, base):
        return [("bucket", g) for _, g in prim.bucket_by_policy(reqs, base)]

    mixed_plan = prim.decode_tick_plan
    probes = {}
    probe_ids = (0, 1, 2, 3, n_req - 4, n_req - 3, n_req - 2, n_req - 1)
    for kind in ("mixed", "per_policy"):
        pr = ContinuousScheduler(m_eng, n_blocks=160, block_size=16)
        for r in mode_requests(probe_ids, spaced=False, max_new=64):
            pr.submit(r)
        probes[kind] = pr

    def ticks_of(kind, n):
        prim.decode_tick_plan = (mixed_plan if kind == "mixed"
                                 else per_policy_plan)
        try:
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                probes[kind].step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / n * 1e3
            return ms, sum(kernels.launch_counts().values()) / n
        finally:
            prim.decode_tick_plan = mixed_plan

    for kind in probes:  # admits all 8 (and runs the first tick)
        ticks_of(kind, 1)
    probe_ticks = 12
    tick = {"mixed": [], "per_policy": []}
    per_tick = {}
    for kind in ("mixed", "per_policy", "mixed", "per_policy"):
        ms, n_launch = ticks_of(kind, probe_ticks)
        tick[kind].append(ms)
        per_tick[kind] = n_launch
    busy_ms, busy_by_name = {}, {}
    for k in probes:
        total, names = device_busy_ms(lambda k=k: ticks_of(k, 4))
        busy_ms[k] = total / 4
        busy_by_name[k] = {n: ms / 4 for n, ms in names.items()}
        log(f"[mixed] {k} tick, device ms by name: "
            + ", ".join(f"{n} {ms:.3f}" for n, ms in
                        list(busy_by_name[k].items())[:6]) + f" ({smi})")
    outs = {k: {r.rid: list(r.out) for r in pr._slots if r is not None}
            for k, pr in probes.items()}
    if outs["mixed"] != outs["per_policy"] or len(outs["mixed"]) != 8:
        raise AssertionError("mixed tick tokens differ from the per-policy "
                             "plan's")
    if per_tick["mixed"] != 97 or per_tick["per_policy"] != 4 * 97:
        raise AssertionError(f"kernel launches per tick {per_tick} != "
                             "97 (mixed) and 4 x 97 (per-policy)")
    log(f"[mixed] decode tick (8 slots, two per mode, no admissions), in "
        f"turns: mixed {tick['mixed'][0]:.3f} / {tick['mixed'][1]:.3f} ms "
        f"({per_tick['mixed']:.0f} kernel launches, kernels busy "
        f"{busy_ms['mixed']:.3f} ms); per-policy plan "
        f"{tick['per_policy'][0]:.3f} / {tick['per_policy'][1]:.3f} ms "
        f"({per_tick['per_policy']:.0f} launches, busy "
        f"{busy_ms['per_policy']:.3f} ms); tokens equal bitwise ({smi})")
    report["mixed"] = dict(
        modes=list(MODES), lengths=sched_lengths, max_new=sched_new,
        run_s=m_run_s, tokens_per_s=m_stats["useful_tokens"] / m_run_s,
        stats=m_stats, launches=m_launches, routes=m_routes,
        mixed_launches=n_mixed,
        bucket_launches=n_bucket, prelimb_misses=misses,
        solo_bitwise=list(m_solo_ids), tick_ms=tick,
        kernel_launches_per_tick=per_tick, kernel_busy_ms_per_tick=busy_ms,
        device_ms_per_tick_by_name=busy_by_name)

    del m_eng, m_sched, probes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 4d. [auto]: generate under PrecisionPolicy.auto() ----------------
    auto_pol = PrecisionPolicy.auto()
    a_lengths = [int(n) for n in np.linspace(64, 256, 4)]
    a_prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int64)
                 for n in a_lengths]
    a_new = 16
    a_eng = ServeEngine(cfg, params, max_batch=4, max_seq=512,
                        policy=auto_pol)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    a_outs = a_eng.generate(a_prompts, max_new=a_new)
    torch.cuda.synchronize()
    a_gen_s = time.perf_counter() - t0
    a_launches = kernels.launch_counts()
    a_reads = auto_lib.mp_matmul_auto.host_reads
    passes = 1 + a_new  # the prefill and a_new decode steps
    a_want = {**dict.fromkeys(kernels.KERNELS, 0),
              "mp_fused_matmul": passes * (AUTO_PER_PASS + 1)}
    log(f"[auto] generate 4 prompts {a_lengths} x {a_new} new: "
        f"{a_gen_s:.3f} s, {4 * a_new / a_gen_s:.1f} tokens/s, launches "
        f"{a_launches}, host reads {a_reads} ({smi})")
    if (a_launches != a_want or a_reads != passes * AUTO_PER_PASS
            or any(kernels.plain_call_counts().values())
            or a_eng.prelimb_cache_misses != 0):
        raise AssertionError(f"[auto] launches {a_launches} != {a_want} or "
                             f"host reads {a_reads} != "
                             f"{passes * AUTO_PER_PASS}")
    if any(len(o) != a_new or not all(0 <= t < cfg.vocab for t in o)
           for o in a_outs):
        raise AssertionError("[auto] generate returned malformed streams")
    a_toks = a_eng.pad_prompts(a_prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a_logits, a_cache = a_eng.prefill(a_toks, a_eng.make_cache())
    torch.cuda.synchronize()
    a_prefill_ms = (time.perf_counter() - t0) * 1e3
    cur = a_logits[:, -1].argmax(-1)[:, None]

    def a_steps(n):
        nonlocal a_cache, cur
        for _ in range(n):
            lg, a_cache = a_eng.decode(a_cache, cur)
            cur = lg[:, -1].argmax(-1)[:, None]

    a_steps(1)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a_steps(8)
    torch.cuda.synchronize()
    a_step_ms = (time.perf_counter() - t0) / 8 * 1e3
    a_reads_step = auto_lib.mp_matmul_auto.host_reads / 8
    a_busy, a_busy_names = device_busy_ms(lambda: a_steps(4))
    a_busy /= 4
    # which formats AUTO selected, on one more prefill and decode step (the
    # recording reads the index a second time, so it is kept out of the
    # timed runs)
    picks = {}
    real_select = auto_lib.select_mode_index

    def recording_select(*args, **kw):
        idx = real_select(*args, **kw)
        cands = args[2] if len(args) > 2 else kw.get("candidates")
        name = resolve(cands[int(idx)]).name
        picks[name] = picks.get(name, 0) + 1
        return idx

    auto_lib.select_mode_index = recording_select
    try:
        lg, c2 = a_eng.prefill(a_toks, a_eng.make_cache())
        a_eng.decode(c2, lg[:, -1].argmax(-1)[:, None])
    finally:
        auto_lib.select_mode_index = real_select
    ref_a = ServeEngine(cfg, params, max_batch=4, max_seq=512,
                        matmul_backend="ref", policy=auto_pol)
    ref_logits, _ = ref_a.prefill(a_toks, ref_a.make_cache())
    a, b = a_logits[:, -1].double(), ref_logits[:, -1].double()
    a_rel = ((a - b).norm() / b.norm()).item()
    log(f"[auto] prefill {a_prefill_ms:.1f} ms; decode {a_step_ms:.3f} "
        f"ms/step, {a_reads_step:.1f} host reads per step, device busy "
        f"{a_busy:.3f} ms/step (idle share "
        f"{max(0.0, 1 - a_busy / a_step_ms):.3f}); selections over one "
        f"prefill + one decode step {picks}; last-token logits vs ref "
        f"backend: rel {a_rel:.3e} (tol {rel_tol:.3e}) ({smi})")
    log("[auto] decode step device ms by name: " + ", ".join(
        f"{n} {ms / 4:.3f}" for n, ms in list(a_busy_names.items())[:6]))
    if not torch.isfinite(a_logits).all() or a_rel > rel_tol:
        raise AssertionError("[auto] prefill logits disagree with the ref "
                             "backend")
    report["auto"] = dict(
        lengths=a_lengths, max_new=a_new, generate_s=a_gen_s,
        tokens_per_s=4 * a_new / a_gen_s, launches=a_launches,
        host_reads=a_reads, prefill_ms=a_prefill_ms,
        decode_ms_per_step=a_step_ms, host_reads_per_step=a_reads_step,
        device_busy_ms_per_step=a_busy,
        device_ms_per_step_by_name={n: ms / 4
                                    for n, ms in a_busy_names.items()},
        selections=picks, logits_rel_vs_ref=a_rel)
    del ref_a, a_cache, c2
    torch.cuda.empty_cache()

    # ---- 4e. [auto-sched]: static-format and AUTO requests together -------
    def auto_requests(ids, spaced=True):
        reqs = requests(ids, spaced)
        for r in reqs:
            mode = AUTO_MODES[r.rid % len(AUTO_MODES)]
            r.max_new = a_new
            if mode is None:
                r.policy = auto_pol
            else:
                r.mode = mode
        return reqs

    n_as = 12
    plans = []
    real_plan = prim.decode_tick_plan

    def recording_plan(reqs, base):
        plan = real_plan(reqs, base)
        n_auto = sum(r.policy is auto_pol for r in reqs)
        plans.append((len(reqs) - n_auto, n_auto,
                      [(kind, all(r.policy is auto_pol for r in g))
                       for kind, g in plan]))
        return plan

    prim.decode_tick_plan = recording_plan
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        as_eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                             prelimb_weights=True, policy=policy)
        as_sched = ContinuousScheduler(as_eng, n_blocks=160, block_size=16)
        as_done = as_sched.run(auto_requests(range(n_as)))
        torch.cuda.synchronize()
        as_run_s = time.perf_counter() - t0
        as_launches = kernels.launch_counts()
        as_reads = auto_lib.mp_matmul_auto.host_reads
        as_plain = kernels.plain_call_counts()
    finally:
        prim.decode_tick_plan = real_plan
    as_stats = as_sched.stats()
    both_live = [p for p in plans if p[0] and p[1]]
    n_auto_launch = sum(is_auto for p in plans for _, is_auto in p[2])
    n_mixed_launch = sum(k == "mixed" for p in plans for k, _ in p[2])
    n_static_bucket = sum(k == "bucket" and not is_auto
                          for p in plans for k, is_auto in p[2])
    n_auto_req = sum(AUTO_MODES[i % 4] is None for i in range(n_as))
    n_static_pf = as_stats["prefills"] - n_auto_req
    misses = as_eng.prelimb_cache_misses
    as_want = serve_launches(L, n_static_pf, n_static_bucket, n_mixed_launch,
                             misses)
    as_want["mp_fused_matmul"] += ((n_auto_req + n_auto_launch)
                                   * (AUTO_PER_PASS + 1))
    as_reads_want = (n_auto_req + n_auto_launch) * AUTO_PER_PASS
    both_per_tick = (sum(len(p[2]) for p in both_live)
                     / max(len(both_live), 1))
    log(f"[auto-sched] {n_as} requests, modes "
        f"{[m or 'AUTO' for m in AUTO_MODES]} in turn, prompts "
        f"{sched_lengths[0]}..{sched_lengths[-1]} x {a_new} new, arrivals 2 "
        f"ticks apart: run {as_run_s:.3f} s (prelimbs included), "
        f"{as_stats['useful_tokens'] / as_run_s:.1f} tokens/s, "
        f"{as_stats['steps']} ticks, {len(both_live)} with static and AUTO "
        f"requests live at {both_per_tick} launches each; decode launches "
        f"{n_mixed_launch} mixed, {n_static_bucket} static bucket, "
        f"{n_auto_launch} AUTO bucket; launches {as_launches}, host reads "
        f"{as_reads} ({smi})")
    if not both_live or any(len(p[2]) != 2 for p in both_live):
        raise AssertionError(f"[auto-sched] ticks with static and AUTO "
                             f"requests live are not two launches: {plans}")
    if as_launches != as_want or as_reads != as_reads_want \
            or any(as_plain.values()):
        raise AssertionError(f"[auto-sched] launches {as_launches} != "
                             f"{as_want} or host reads {as_reads} != "
                             f"{as_reads_want} (plain {as_plain})")
    as_out = {r.rid: r.out for r in as_done}
    if (len(as_out) != n_as or as_stats["completed"] != n_as
            or any(len(o) != a_new for o in as_out.values())
            or as_stats["blocks_live"] != 0):
        raise AssertionError(f"[auto-sched] run malformed: {as_stats}")
    # the AUTO requests == their solo AUTO generate, bit for bit
    auto_ids = [i for i in range(n_as) if AUTO_MODES[i % 4] is None]
    for i in auto_ids:
        solo = a_eng.generate([sched_prompts[i]], max_new=a_new)[0]
        if solo != as_out[i]:
            first = next(t for t, (x, y) in enumerate(zip(solo, as_out[i]))
                         if x != y)
            raise AssertionError(f"[auto-sched] AUTO request {i}: scheduled "
                                 f"stream differs from its solo generate "
                                 f"at token {first}")
    log(f"[auto-sched] AUTO requests {auto_ids}: scheduled streams == solo "
        f"AUTO generate bitwise")
    report["auto_sched"] = dict(
        modes=[m or "AUTO" for m in AUTO_MODES], n_requests=n_as,
        max_new=a_new, run_s=as_run_s,
        tokens_per_s=as_stats["useful_tokens"] / as_run_s, stats=as_stats,
        launches=as_launches, host_reads=as_reads,
        ticks_both_live=len(both_live),
        launches_per_tick_both_live=both_per_tick,
        mixed_launches=n_mixed_launch, static_bucket_launches=n_static_bucket,
        auto_bucket_launches=n_auto_launch, solo_bitwise=auto_ids)
    del as_eng, as_sched, a_eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 4f. [train]: training steps of the full-width model -------------
    t_policy = PrecisionPolicy.train_default()
    # 1.6 GB: under build/, never the output directory; [dist] restores it
    # onto its ranks' mesh, then it is removed
    ck_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    tcfg = trainer_lib.TrainerConfig(total_steps=TRAIN_STEPS, warmup=2,
                                     ckpt_dir=str(ck_dir),
                                     ckpt_every=TRAIN_STEPS, keep=1)
    trainer = trainer_lib.Trainer(cfg, tcfg, policy=t_policy)
    pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ + 1,
                                  global_batch=TRAIN_BATCH))
    state0 = trainer.init_state(seed=0)
    batch0 = trainer.to_device(pipe.batch(0))
    per_step = {**dict.fromkeys(kernels.KERNELS, 0), **train_launches(L)}

    def grads_of(model_cfg):
        loss_fn = trainer_lib.make_loss_fn(model_cfg, t_policy)
        out = trainer_lib.value_and_grad(loss_fn, state0.params, batch0)
        torch.cuda.synchronize()
        return out

    # step 1's loss and gradients against the ref backend on the card, at
    # the CPU tests' bounds (loss 1e-5 relative; each leaf 5e-4 of its max)
    kernels.reset_launch_counts()
    (l_k, _), g_k = grads_of(cfg)
    vg_launches = kernels.launch_counts()
    if vg_launches != per_step or any(kernels.plain_call_counts().values()):
        raise AssertionError(f"[train] value and grad launches {vg_launches}"
                             f" != {per_step}")
    with context_lib.context(backend="ref"):
        (l_r, _), g_r = grads_of(cfg)
    loss_rel = abs(l_k.item() - l_r.item()) / abs(l_r.item())
    leaf_err = {path: ((a_ - b_).abs().max() / b_.abs().max()).item()
                for (path, a_), b_ in zip(tree_lib.items(g_k),
                                          tree_lib.leaves(g_r))}
    worst = max(leaf_err, key=leaf_err.get)
    log(f"[train] step 1 against the ref backend: loss {l_k.item():.6f} vs "
        f"{l_r.item():.6f} (rel {loss_rel:.3e}, bound 1e-5); worst gradient "
        f"leaf {worst} {leaf_err[worst]:.3e} of its max (bound 5e-4); "
        f"launches {vg_launches}")
    if not loss_rel <= 1e-5 or not leaf_err[worst] < 5e-4:
        raise AssertionError("[train] step 1 disagrees with the ref backend")
    del g_r
    # remat's recompute gives the forward's bits: remat off, same bits
    kernels.reset_launch_counts()
    (l_n, _), g_n = grads_of(dataclasses.replace(cfg, remat=False))
    no_remat = {**dict.fromkeys(kernels.KERNELS, 0),
                **train_launches(L, remat=False)}
    if kernels.launch_counts() != no_remat:
        raise AssertionError(f"[train] launches without remat "
                             f"{kernels.launch_counts()} != {no_remat}")
    if not torch.equal(l_n, l_k) or not all(
            torch.equal(a_, b_) for a_, b_ in zip(tree_lib.leaves(g_n),
                                                   tree_lib.leaves(g_k))):
        raise AssertionError("[train] remat's gradients are not bitwise the "
                             "gradients without remat")
    log("[train] remat on == remat off, loss and every gradient bitwise")
    del g_n, g_k
    # the same step twice from one state and batch: the same bits
    s1, m1 = trainer._step_fn(state0, batch0)
    s2, m2 = trainer._step_fn(state0, batch0)
    torch.cuda.synchronize()
    if not torch.equal(m1["loss"], m2["loss"]) or not all(
            torch.equal(a_, b_) for a_, b_ in zip(tree_lib.leaves(s1),
                                                   tree_lib.leaves(s2))):
        raise AssertionError("[train] one step twice is not bitwise")
    log("[train] one step twice from one state and batch: loss and every "
        "parameter and moment bitwise")
    del s1, s2, m1, m2
    # Trainer.run: TRAIN_STEPS steps from seed 0, a checkpoint at the end
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # resident before the path: the serving weights and phase 3's inputs
    t_base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    # each step's grad norm and the state after FSDP_STEPS steps, which
    # [fsdp] holds its own against (kept on the card, written after the run)
    run_fn, t_norms, at_fsdp = trainer._step_fn, [], []

    def keep_step(state_, batch_):
        new_, metrics_ = run_fn(state_, batch_)
        t_norms.append(metrics_["grad_norm"])
        if len(t_norms) == FSDP_STEPS:
            at_fsdp.append(new_)
        return new_, metrics_

    trainer._step_fn = keep_step
    t0 = time.perf_counter()
    state, hist = trainer.run(pipe, num_steps=TRAIN_STEPS, log_every=0,
                              state=state0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    trainer._step_fn = run_fn
    t_norms = [float(x) for x in t_norms]
    fsdp_ref_dir = ROOT / "build" / "train_fsdp_ref"
    ckpt_lib.save(str(fsdp_ref_dir), FSDP_STEPS, at_fsdp.pop(), keep=1)
    t_launches = kernels.launch_counts()
    t_routes = kernels.route_counts()
    t_peak = torch.cuda.max_memory_allocated()
    t_want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    # every projection of a step (1024 rows, contiguous) on the TMA tile
    t_want_proj = {"cluster": 0, "tma": t_want["mp_fused_proj"],
                   "strided": 0}
    run_ms = [t * 1e3 for t in trainer._step_times]
    log(f"[train] Trainer.run {TRAIN_STEPS} steps of batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} under train_default: {train_s:.3f} s, losses "
        f"{[round(x, 5) for x in hist]}, step ms {[round(x, 2) for x in run_ms]}"
        f", peak {t_peak / 2**30:.2f} GiB ({(t_peak - t_base) / 2**30:.2f} "
        f"GiB above the {t_base / 2**30:.2f} GiB resident before the path), "
        f"launches {t_launches}; the projection's routes "
        f"{t_routes['mp_fused_proj']}")
    if t_launches != t_want or any(kernels.plain_call_counts().values()):
        raise AssertionError(f"[train] launches {t_launches} != {t_want} "
                             f"(plain {kernels.plain_call_counts()})")
    if t_routes["mp_fused_proj"] != t_want_proj:
        raise AssertionError(f"[train] projection routes "
                             f"{t_routes['mp_fused_proj']} != {t_want_proj}")
    if (len(hist) != TRAIN_STEPS or not all(math.isfinite(x) for x in hist)
            or not bool(all_finite(state.params))):
        raise AssertionError("[train] losses or parameters not finite")
    if ckpt_lib.latest_step(str(ck_dir)) != TRAIN_STEPS:
        raise AssertionError("[train] no checkpoint at the last step")
    restored, _ = ckpt_lib.restore(str(ck_dir), TRAIN_STEPS, state)
    if not all(torch.equal(a_, b_) for a_, b_ in zip(
            tree_lib.leaves(restored), tree_lib.leaves(state))):
        raise AssertionError("[train] the checkpoint does not restore the "
                             "state bitwise")
    del restored
    log(f"[train] checkpoint of step {TRAIN_STEPS} restores the state bitwise")
    # step time on the host clock after synchronize, then the card's busy
    # time of one more step
    step_ms = []
    for i in range(3):
        b_ = trainer.to_device(pipe.batch(TRAIN_STEPS + i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer._step_fn(state, b_)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    b_ = trainer.to_device(pipe.batch(TRAIN_STEPS + 3))
    t_busy, t_by_name = device_busy_ms(lambda: trainer._step_fn(state, b_))
    med = float(np.median(step_ms))
    tok = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] step {med:.2f} ms (host clock after synchronize, "
        f"{[round(x, 2) for x in step_ms]}), {tok / med * 1e3:.0f} tokens/s;"
        f" busy {t_busy:.2f} ms, idle share {max(0.0, 1 - t_busy / med):.3f}"
        f"; busy by name {dict(list(t_by_name.items())[:10])} ({smi})")
    # the weight gradient's plain product against the kernel on the same
    # contraction (one sum of the same exact products in other orders)
    x3 = x_t.reshape(TRAIN_BATCH, TRAIN_SEQ, d)
    wgrads = {}
    for label, a3, g3, f in (
            (f"w_down {ff}x{d} M16", h_ff.reshape(TRAIN_BATCH, TRAIN_SEQ, ff),
             g_d.reshape(TRAIN_BATCH, TRAIN_SEQ, d), "M16"),
            (f"wq {d}x{d} M16", x3, g_d.reshape(TRAIN_BATCH, TRAIN_SEQ, d),
             "M16"),
            (f"w_up {d}x{ff} M16", x3,
             h_ff.reshape(TRAIN_BATCH, TRAIN_SEQ, ff), "M16"),
            (f"lm_head {d}x{V} M23", x3,
             g_lm.reshape(TRAIN_BATCH, TRAIN_SEQ, V), "M23")):
        fmt = resolve(f)
        a2, g2 = a3.reshape(tok, -1), g3.reshape(tok, -1)
        a_sel, g_sel = ref_lib.wgrad_stacks(a3, g3, fmt)
        via_mm = ref_lib.mp_wgrad_ref(a3, g3, fmt)
        via_k = mp_matmul.mp_fused_matmul(a2.t(), g2, fmt)
        torch.cuda.synchronize()
        w_err = (via_k - via_mm).abs()
        if not (w_err <= mm_tol(via_mm, tok * fmt.n_products)).all():
            raise AssertionError(f"[train] wgrad {label}: the kernel and the "
                                 "plain product disagree beyond the f32 "
                                 "floor")
        ref_ms, ref_ahead = device_ms(
            lambda: ref_lib.mp_wgrad_ref(a3, g3, fmt), torch)
        mm_ms, mm_ahead = device_ms(
            lambda: ref_lib.wgrad_product(a_sel, g_sel), torch)
        k_ms, k_ahead = device_ms(
            lambda: mp_matmul.mp_fused_matmul(a2.t(), g2, fmt), torch)
        del a_sel, g_sel
        b_ms, b_by = bound(2 * tok * a2.shape[1] * g2.shape[1]
                           * fmt.n_products,
                           4 * (a2.numel() + g2.numel()
                                + a2.shape[1] * g2.shape[1]))
        wgrads[label] = dict(wgrad_ref_ms=ref_ms, torch_mm_ms=mm_ms,
                             kernel_ms=k_ms, max_abs_diff=w_err.max().item(),
                             bound_ms=b_ms, bound_by=b_by,
                             host_ahead=dict(wgrad_ref=ref_ahead,
                                             torch_mm=mm_ahead,
                                             kernel=k_ahead))
        log(f"[train] wgrad {label} over {tok} tokens: mp_wgrad_ref "
            f"{ref_ms:.4f} ms, of it the one torch.mm (bf16 operands, f32 "
            f"out) {mm_ms:.4f} ms; the fused matmul on the same "
            f"contraction (x^T copied) {k_ms:.4f} ms; bound {b_ms:.4f} ms "
            f"({b_by})")
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("[train] TF32 left on for f32 matmuls")
    report["train"] = dict(
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        policy="train_default", losses=hist, run_s=train_s,
        run_step_ms=run_ms, step_ms=step_ms, step_ms_median=med,
        tokens_per_s=tok / med * 1e3, busy_ms=t_busy,
        idle_share=max(0.0, 1 - t_busy / med),
        busy_by_name=t_by_name, peak_bytes=t_peak,
        resident_before_bytes=t_base, launches=t_launches, routes=t_routes,
        launches_per_step=per_step, loss_rel_vs_ref=loss_rel,
        grad_err_vs_ref=leaf_err, wgrad=wgrads, norms=t_norms,
        fsdp_ref_dir=str(fsdp_ref_dir))

    # ---- 4f'. [autotune] and [roofline] -----------------------------------
    t0 = time.perf_counter()
    report["autotune"] = autotune_phase(cfg, params, prompts, main_outs, smi)
    report["roofline"] = roofline_phase(cfg, params, prompts, trainer, state,
                                        pipe, med, smi)
    log(f"[autotune] + [roofline] {time.perf_counter() - t0:.1f} s")
    del trainer, state, state0, hist
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 4g-4j. AUTO and the other training paths, the fleet, chaos --------
    # each gate of these phases is logged and kept; the run fails at the end
    # of them if any failed
    fail = Failures()

    def card_counts():
        plain = kernels.plain_call_counts()
        fail.check(not any(plain.values()), f"plain-version calls {plain}")
        return kernels.launch_counts()

    new = {}
    new["train_auto"] = fail.run("[train-auto]", train_auto_phase, fail, cfg,
                                 dev, smi, card_counts)
    torch.cuda.empty_cache()
    ck_root = ROOT / "build" / "train_more_ckpt"
    try:
        new["train_more"] = fail.run("[train-more]", train_more_phase, fail,
                                     cfg, dev, smi, card_counts, ck_root)
    finally:
        shutil.rmtree(ck_root, ignore_errors=True)
    torch.cuda.empty_cache()
    f_eng = ServeEngine(cfg, params, max_batch=8, max_seq=512,
                        prelimb_weights=True,
                        policy=PrecisionPolicy.serve_default())
    new["fleet"] = fail.run("[fleet]", fleet_phase, fail, f_eng, dev, smi,
                            card_counts)
    new["chaos"] = fail.run("[chaos]", chaos_phase, fail, f_eng, dev, smi,
                            card_counts)
    del f_eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    new["arch"] = fail.run("[arch]", arch_phase, fail, dev, smi, card_counts,
                           prompts)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    new["train_arch"] = fail.run("[train-arch]", train_arch_phase, fail, dev,
                                 smi, card_counts)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    try:
        new["dist"] = fail.run("[dist]", dist_phase, fail, cfg, params,
                               prompts, sched_prompts, ck_dir, smi,
                               report["train"])
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    new["ep"] = fail.run("[ep]", ep_phase, fail, smi)
    report.update({k: v for k, v in new.items() if v is not None})
    fail.raise_if_any()
    new_launches = {
        "train_auto": report["train_auto"]["launches"],
        "train_more": report["train_more"]["rollback"]["launches"],
        "fleet": report["fleet"]["mode_affinity"]["launches"],
        "chaos": report["chaos"]["launches"],
        "arch": report["arch"][ARCH_RUNS[0][0]]["launches"],
        "train_arch": report["train_arch"][TRAIN_ARCH[0]]["launches"],
        "dist": report["dist"]["generate"]["launches"],
        "ep": report["ep"]["generate"]["launches"]}

    # ---- 5. the kernels line -----------------------------------------------
    line = []
    for kname, (src, replaces) in SOURCES.items():
        rows = []
        for c in cases[kname]:
            ms, ahead = device_ms(c["fn"], torch)
            event_ms = timed(c["fn"], torch)
            plain_ms, plain_ahead = device_ms(c["plain"], torch)
            lib_ms, lib_ahead = (device_ms(c["library"], torch)
                                 if c["library"] else (None, True))
            b_ms, b_by = bound(c["ops"], c["bytes"], c.get("peak"))
            row = {k: v for k, v in c.items()
                   if k not in ("fn", "plain", "library", "peak", "vs",
                                "library_bf16")}
            if c.get("library_bf16"):
                row["library_bf16_ms"] = device_ms(c["library_bf16"],
                                                   torch)[0]
            if c.get("vs"):
                row["fused_ms"] = device_ms(c["vs"], torch)[0]
            # False where the host fell behind the card even so
            host_ahead = dict(ms=ahead, plain_ms=plain_ahead,
                              library_ms=lib_ahead)
            row.update(ms=ms, event_ms=event_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                       host_ahead=host_ahead)
            rows.append(row)
            behind = [k for k, v in host_ahead.items() if not v]
            log(f"[time] {kname} {c['case']} {c['fmt']}"
                + (f" ({c['route']} route)" if c.get("route") else "")
                + f": {ms:.4f} ms "
                f"(back to back from the host {event_ms:.4f} ms), plain "
                f"{plain_ms:.4f} ms, library "
                f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                f"{b_ms:.4f} ms ({b_by})"
                + (f"; torch.mm bf16 (f32 out)"
                   + (" (product only)" if c.get("gate", "none") != "none"
                      else "") + f" {row['library_bf16_ms']:.4f} ms"
                   if "library_bf16_ms" in row else "")
                + (f"; the fused matmul on the same operands "
                   f"{row['fused_ms']:.4f} ms" if "fused_ms" in row else "")
                + (f"; rel err vs float64 {c['gold_rel']:.3e} (bound "
                   f"{c['gold_bound']:.3e})" if "gold_rel" in c else "")
                + (f"; host behind the card for {behind}" if behind else ""))
        main_row = next(r for r in rows if r["main"])
        by_path = {"generate": launches[kname],
                   "scheduler": s_launches[kname],
                   "mixed": m_launches[kname], "modes": md_launches[kname],
                   "auto": a_launches[kname],
                   "auto_sched": as_launches[kname],
                   "train": t_launches[kname],
                   **{k: v[kname] for k, v in new_launches.items()}}
        path = LAUNCH_PATH.get(kname, "generate")
        routes = {"generate": report["main"]["routes"],
                  "scheduler": report["sched"]["routes"],
                  "mixed": report["mixed"]["routes"],
                  "modes": report["modes"]["routes"],
                  "dist": report["dist"]["generate"]["routes"]}.get(
                      path, {}).get(kname)
        if routes:     # the files of the routes that ran
            src = ", ".join(dict.fromkeys(
                ROUTE_SOURCES[r] for r, n in routes.items() if n)) or src
        line.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": by_path[path],
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in checks[kname]),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "main_case": main_row["case"],
            **({"routes": routes} if routes else {})})
        report.setdefault("cases", {})[kname] = rows
    # kernel time of one prefill and one decode step at these shapes: the
    # device-busy lower bound the measured step times are read against
    busy = {"prefill": 0.0, "decode": 0.0, "tick": 0.0, "mtick": 0.0}
    for rows in report["cases"].values():
        for r in rows:
            if r["per"]:
                busy[r["per"][0]] += r["ms"] * r["per"][1]
    report["main"]["kernel_ms_per_prefill"] = busy["prefill"]
    report["main"]["kernel_ms_per_decode_step"] = busy["decode"]
    report["sched"]["kernel_ms_per_tick"] = busy["tick"]
    report["mixed"]["kernel_ms_per_tick_from_cases"] = busy["mtick"]
    log(f"[busy] kernel ms per prefill {busy['prefill']:.3f} "
        f"(measured {report['main']['prefill_ms']:.3f} ms); per decode step "
        f"{busy['decode']:.3f} (measured "
        f"{report['main']['decode_ms_per_step']:.3f} ms); per scheduler "
        f"decode tick {busy['tick']:.3f} (measured {tick_ms:.3f} ms, idle "
        f"share {max(0.0, 1 - busy['tick'] / tick_ms):.3f}); per mixed tick "
        f"{busy['mtick']:.3f} (profiled {busy_ms['mixed']:.3f}, measured "
        f"{tick['mixed'][0]:.3f} ms, idle share "
        f"{max(0.0, 1 - busy_ms['mixed'] / tick['mixed'][0]):.3f}; "
        f"per-policy plan: profiled {busy_ms['per_policy']:.3f}, measured "
        f"{tick['per_policy'][0]:.3f} ms, idle share "
        f"{max(0.0, 1 - busy_ms['per_policy'] / tick['per_policy'][0]):.3f})"
        f" ({smi})")
    report["kernels"] = line
    report["checks"] = checks
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": line}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
