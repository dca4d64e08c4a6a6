#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass:

1. device — the card's name and power limit (nvidia-smi);
2. build  — every CUDA source under src/repro_torch/kernels/csrc, one
   `nvcc` each, all started together; ptxas registers and spills per
   kernel; the flash library's SASS must hold `HGMMA` (wgmma) and
   `UTMALDG` (TMA) instructions, in each of its tensor-core
   instantiations (hd 64, 96 and 128), the fused timestep's `DMMA` (f64
   tensor cores);
3. kernels — each fused-timestep kernel against its plain torch version
   on the card, at the three layer shapes of the paper's network
   (configs/snn_chip.py ARCH: 2312-4096-1024-10) with a batch of 32, over
   input densities 0, 0.02, 0.10 and 1.0, random v / elapsed, both
   `all_nonzero` settings (a codebook with a zero level when False) and
   both update modes, the dense kernel on the codebook's levels and on
   Gaussian f32 weights with exact 0.0 and -0.0 among them; then both
   fused kernels at FUSED_EDGE_CASES (the plan's edges: Kw = 1 and 9,
   N = 10, 37 and 1000, M = 1, RAGGED_ROWS, 128, 640 and 4096; L = 1, 2,
   16 and 200; int8 indexes outside [0, L), which add 0; all-zero and
   all-one spike tiles) and with weights at storage offset 1, every call
   repeated and held bitwise equal; both plans (BM, BN, threads, shared
   bytes, grid) are logged per ARCH layer at M = 32 and 640; then their
   times per layer at M = 32 (the kernels line) and 640 beside the plain
   version's, a `torch.matmul` of the same product and the device-memory
   bound;
   Then the kernel API's kernels (zspe_spmm, codebook_matmul,
   lif_update) against their plain versions at the same layer shapes
   with M = 32 (one step), 200 (edge row tiles) and 32 x 20 = 640 rows
   (a whole run; spike densities 0, 0.02, 0.10, 1.0 and a
   tile-structured case; Gaussian f32 and bf16 x for the codebook
   product; (M, N) LIF states), and their times at M = 32 and 640.
   lif_update also at LIF_EDGE_SHAPES (element counts four does not
   divide, one row), with each operand in turn at storage offset 1 and
   elapsed up to 99, every call repeated and held bitwise equal.  The
   two products are held against the plain product in f64, which they
   compute (f64 sums, one rounding), not against an f32 matmul's rounding.
   The codebook product also at the edges of its plan and lookup table:
   int8 indexes outside [0, L) (negative ones, and 16 with L = 8) at the
   three layer shapes with M = 32, and shapes whose K the split does not
   divide (K = 1, 999, 1000, 4100; N = 10 and 37); the zspe product also
   at its plan's edges (K = 1, 999, 1000, 2312 with N = 64, 10, 37, 1024
   and M = 32 or RAGGED_ROWS) with {0, 1} spikes, other spike values
   ({0, 0.5, 1, 2} in f32, {0, 1, 2, -3} in int8), all-zero and all-one
   tiles, and every zspe case called twice and held bitwise equal; its
   plan (BM, BN, split, grid) per ARCH layer at M = 32 and 640 is logged;
4. main path — `ChipSimulator(quantize(ARCH weights), engine="fused")
   .run_batch` at B=32, T=20, Bernoulli(0.10) input: exactly 60
   codebook-kernel launches, spike totals per layer within 0.1% and
   pJ/SOP within 1e-3 of the port's compiled engine, samples/s; then a
   float ARCH simulator for T=2 through the dense kernel (6 launches);
5. kernel-API path — the paper's network as a loop over T of
   `kernels.ops` calls at B=32, T=20: (a) `zspe_spmm` of the dequantized
   weights then `lif_update`, (b) the same with `codebook_matmul` of the
   indexes, (c) the padded `fused_timestep` of the indexes: exactly 60
   launches of each kernel per loop; every layer-step's current (against
   the f64 product) and LIF outputs held against the plain versions on the
   same inputs (loop (c)
   against `ops.fused_timestep` on the CPU); spike totals per layer
   within 0.1% of the same loop on the plain LIF driven by the f64
   product, the current the kernels compute (a, b), and of each other;
   one `codebook_matmul` backward at layer 1 against plain autograd; ms
   per loop and the card's idle share;
6. LM serving path — (a) the flash-attention kernel against its plain
   version (B 2, H 8, S = T in {128, 1024}, hd 16 / 32 / 64 / 128, group
   1 and 4, causal and not, f32 and bf16; T > S and S > T causal; the
   served shape B 4, H 32, KV 8, S = T = 512, hd 64, bf16, and
   granite-3-8b's, the same with hd 128) and timed at both beside
   `scaled_dot_product_attention` (the kernels line reports the served
   one); (b) `Server` on granite-3-2b ARCH (40 layers, d 2048, bf16,
   random weights from --seed): 8 requests of 512 prompt tokens, 4 slots,
   16 new tokens each, exactly 80 flash launches (2 prefill batches x 40
   layers), every one on the tensor-core kernel, tokens/s, prefill and
   decode ms, peak memory, the idle share over one batch; (c) last-token
   logits of a 512-token prefill (flash route) against a 511-token
   prefill plus one decode step (plain route), and every layer's flash
   call of that prefill against the plain version on the same q / k / v.
7. faults and telemetry — run right after phase 4, on its quantized
   weights, mapping and trains: (a) an unrepaired chip (`fault_plan`: a
   dead core of layer 2, a failed router and a failed link that cut
   routes, a bit-flip and a stuck codebook word, per-hop drop 0.05, seed
   7), traced: every layer in codebook mode, exactly 60 codebook
   launches, every cut weight block zeroed, the drop plan active and its
   masks drawn on the card bitwise equal to the CPU's, fused within phase
   4's rule of the compiled engine under the same faults, the trace's
   energy and wall sums equal to the reports' within 1e-9 relative and
   its Perfetto document monotonic per track; (b) the chip repaired
   around the router (`with_rerouted`): no route crosses it, fused
   within the rule of compiled, NoC hops per sample equal to its fired
   counts times the rerouted flows' hops; (c) a float simulator under
   (a)'s topology faults and drop, T=2: 6 dense launches, fused within
   the rule of compiled; (d) a transient dispatch fault raises once and
   the retry equals the healthy run, and a null `FaultConfig` with the
   trace off gives counters, counts, reports and launches bitwise those
   of `faults=None`; (e) ms
   per run of (a) and of the healthy run, and their device busy.

8. plasticity and the interpretive engine — right after phase 7, on phase
   4's quantized weights, mapping and trains: (a) STDP on layers 1 and 2
   (`PlasticityConfig(enabled=True, mode="stdp", layers=(1, 2))`), fused
   and compiled: exactly 20 codebook launches per fused run (layer 0),
   index writes in both learnable layers, spike and write totals per
   layer within phase 4's 1e-3, and in every sample whose layer 0 fired
   the compiled engine's per-core counts at every step, learned indexes
   and writes bitwise equal; peak device memory; (b) R-STDP on the
   readout (`mode="reward", layers=(2,), lr=0.05, elig_pre=0.5`, the
   settings of deploy/adapt.py `continual_adaptation`): a run (40
   codebook launches), `apply_reward` with the per-neuron reward
   one_hot(target) - one_hot(pred), and a run warm-started from
   `last_learned` (40 launches), held to the compiled engine by (a)'s
   rule (layers 0 and 1 frozen), the commit's writes, write energy and
   write cycles equal; (c) `engine="reference"` at B = 2: healthy and
   untraced (totals within phase 4's rule), then (a)'s STDP traced,
   against the compiled engine run a sample at a time by (a)'s rule, no
   kernel launch, the trace's writes summing to the reports'; (d) ms per
   run and device busy of (a), (b) and the healthy run, ms per sample of
   (c) (its first runs, and warm on one sample with its device busy).

9. SNN serving — right after phase 8, on phase 4's quantized weights:
   (a) `SnnServer(batch_slots=32)` on a greedy-mapped ARCH simulator
   (cores 12, 13, 14), engine "fused", 80 requests of T = 20 at density
   0.10, every 4th with a deadline: exactly 3 slot groups (32, 32, 16)
   and 180 codebook launches, every request's counts, prediction,
   energy and pJ/SOP equal to its row of the same padded batch through
   `run_batch`, none carrying a padded slot's report, `host_summary()`
   and each request's DMA energy equal to `HostDmaModel`'s prices
   reckoned here in numpy; (b) tenancy: a second ARCH network (weights
   from --seed + 2) remapped by `remap_mapping_cores` onto 3 cores
   disjoint from (a)'s, interleaved requests equal to two solo servers'
   with 2 model swaps, then phase 4's anneal-mapped simulator (all 20
   cores) as a third tenant evicting both, every swap priced by
   `table_load`; (c) resilience: `FaultConfig(transient_dispatches=(0,))`
   raises once and is retried (no-op sleep) to the healthy server's
   results, then a primary over a 0 s dispatch budget with
   `RetryPolicy(max_retries=1)` and breaker threshold 1 completes through
   phase 7 (b)'s repaired chip with `degraded=True`, each request equal
   to its row of the repaired chip's `run_batch`; (d) requests/s,
   latency p50 / p99, ms per group beside phase 4's ms per run, and one
   group's device busy and idle share.
10. SNN training — `SNNTrainer` on `SNNConfig(ARCH widths, T = 20,
   qat=True)`, B = 32, the hardware-aware loss (rate 1.0 at 0.08, L1
   1e-3), 5 steps of `EventStream` (34 x 34 x 2) with a checkpoint every
   2: loss and gradient norm finite at every step, parameters moved;
   step 0 on the card against the same step on the CPU from the same
   parameters and batch (loss and spikes per layer within 1e-3, the
   gradient norm within TRAIN_GRAD_REL); a fit stopped after step 2 and
   resumed from its checkpoint ends within TRAIN_RESUME_ATOL of the
   uninterrupted fit; ms per step, device busy, idle share and peak
   memory.

11. deploy — right after phase 10: (a) `deploy.deploy` on
   `SNNConfig(ARCH widths, T = 20, qat=True)` with `EventStream` 34 x 34 x
   2 (seed --seed), 5 training steps at B = 32 with phase 10's
   hardware-aware loss, `DeployConfig` otherwise at its defaults (anneal
   mapping, eval 256 in chunks of 64, engine "fused"): exactly 420
   codebook launches (4 eval chunks, the traced profile batch and 2
   serving groups, 60 each) and no dense one, no aten op computing on a
   host tensor (copies excepted, and the trainer's seeded CPU draw), a
   finite report of plain values whose `save()` loads back, every gate
   logged; (b) one `SNNTrainer.fit` of the same config, its parameters
   deployed on the fused and on the compiled engine: equal register
   tables, cores, compile summary and accuracies before the chip, SOPs
   and pJ/SOP within phase 4's 1e-3, chip accuracy at most 2 of 256
   samples apart; (c) `fit_per_core_codebooks` of those parameters on
   the deployed mapping, on the card against the CPU: register words,
   indexes, codebooks, scales and dequantized weights bitwise equal; (d)
   `continual_adaptation` at its defaults, fused (exactly 786 codebook
   launches: 3 evals and 128 trials of 6 layer-0 steps) against compiled:
   equal accuracies, writes and write energy; (e) seconds per `deploy()`
   stage (train, accuracy forwards, compile, PTQ, the two simulator
   builds with their lowering, chip eval, profile, serving smoke), read
   from deploy()'s profiler spans, beside an unprofiled call; per
   `continual_adaptation`; and one eval chunk's ms, device busy and idle
   share.

12. sharding — right after phase 11, on phase 4's quantized weights and
   trains, with ARCH mapped by `compile_network(from_layer_sizes(ARCH),
   ChipSpec(neurons_per_core=256, max_domains=4), seed=3)` onto 2
   domains: (a) one process without a process group,
   `engine="sharded"` at S = 1: every counter bitwise the compiled
   engine's on that mapping, report fields within 1e-6; (b) two spawned
   gloo ranks, both on the one card (NCCL refuses two ranks on one
   card): S = 2, spike totals per layer and pJ/SOP within phase 4's 1e-3
   of (a) (whether it came out bitwise is logged), the spike-word bytes
   each rank sent equal to its words x 2 B x T x B; STDP on layers 1-2
   held by phase 8's rule to the compiled engine; the fused engine
   batch-sharded, 16 rows a rank: T x 3 codebook launches a rank and
   counters bitwise phase 4's fused run; every rank's results equal;
   (c) one spawned rank with NCCL at world size 1: the sharded engine
   bitwise (a) and the batch-sharded fused engine bitwise phase 4, both
   through the collectives; ms per run and device busy of every rank.
   A rank that fails, hangs past its deadline or exits non-zero fails
   the phase.

13. MoE and C3 codebook-quantized LM serving — right after phase 6: (a)
   `Server` on granite-moe-1b-a400m ARCH (24 layers, d 1024, 16 / 8
   heads, 32 experts top-8, groups of 256, bf16, random weights from
   --seed): phase 6's 8 requests of 512 prompt tokens, 4 slots, 16 new
   each; exactly 48 flash launches (2 prefill batches x 24 layers), all
   on the tensor-core kernel, and no codebook launch; tokens/s, prefill
   and decode ms, peak memory, the idle share over one batch; (b) the
   same weights C3-quantized (`quant.lm_quant.quantize_blocks`, int8,
   fitted on the card; seconds and weight bytes before and after) and
   served with `quant_serving` to the same requests and columns: exactly
   24 x 5 (wq, wk, wv, wo, router) x 32 forward passes = 3840
   `codebook_matmul` launches (the expert stacks are gathered dense, as
   in the reference); last-token logits of one 512-token prefill against
   a dense bf16 model of every leaf's cb.to(bf16)[idx] within phase 6's
   0.125, greedy tokens equal where the top-2 gap is not below it; every
   layer's codebook call of one decode step against the plain product
   by phase 3's rule; the kernel at the decode shapes (M = 4; K x N =
   1024 x 1024, 1024 x 512, 1024 x 32) beside `x @ cb[idx]` and the
   bound; (c) 4-bit C3 on granite-3-2b at full width, depth cut to 8
   layers: one prefill of 4 x 512 tokens and 15 greedy decode steps,
   exactly 8 x 7 x 16 = 896 codebook launches and 8 flash launches,
   every step's logits within 0.125 of the dense dequantized model fed
   the same tokens.

14. the ssm, hybrid and audio families — right after phase 13, each at
   full width and depth with random weights from --seed and phase 6's
   traffic (8 requests of 512 prompt tokens, 4 slots, 16 new each, cache
   640: 32 forward passes), bf16: (a) `Server` on mamba2-130m ARCH (24
   layers, d 768, 24 SSD heads of 64, state 128, chunk 256): no flash
   and no codebook launch; tokens/s, prefill and decode ms, peak memory,
   the idle share over one batch; last-token logits of a 512-token
   prefill against a 511-token prefill (the SSD scan's end padding) plus
   one decode step within phase 6's 0.125; one layer's `mamba2_forward`
   in f32 on the card against the CPU within 1e-4 + 1e-4 |want|;
   `ssd_chunked` at that layer's shapes against the step recurrence of
   `mamba2_decode` within the reference's 1e-3; (b) the same weights C3
   int8, fitted on the card (seconds, weight bytes): exactly 24 x 2
   (in_proj, out_proj) x 32 = 1536 codebook launches (`conv_w` is read
   dense); prefill logits against a dense bf16 model of every leaf's
   cb.to(bf16)[idx] within 0.125; every layer's codebook call of one
   decode step against the plain product by phase 3's rule; (c)
   zamba2-2.7b ARCH (54 layers, d 2560, 80 SSD heads, state 64, a
   shared attention block of 32 heads of hd 80 before every 6 layers,
   window 4096): no flash (the window) and no codebook launch, (a)'s
   columns and 512 against 511 + 1; (d) whisper-tiny ARCH (4 + 4
   layers, d 384, 6 heads of hd 64, 1500 zero frames): exactly 8 flash
   launches (2 prefill batches x 4 decoder layers), all on the
   tensor-core kernel, no codebook launch, every decoder layer's flash
   call of one prefill against the plain version by phase 6's rule, and
   512 against 511 + 1 (the 511 prefill on the plain route).

15. the vlm family and LM training — right after phase 14: (a) the flash
   kernel at hd 80 and 96 (f32 at both and bf16 hd 80 on the SIMT
   kernel, bf16 hd 96 on the tensor-core kernel, launches counted per
   route; T > S,
   S > T, GQA group 4, non-causal, phi-3-vision's prefill shape and a V
   whose columns differ) against its plain version, then timed at
   phi-3-vision's prefill shape (B 4, H = KV = 32, S = T = 640, hd 96,
   bf16, causal) beside the plain version,
   `scaled_dot_product_attention` and the bound, hd 64 and 128 beside it (`flash_head_dim_times`, which also runs alone against an
   older tree's src); (b) phi-3-vision-4.2b served at full width and
   depth, bf16, every flash launch on the tensor-core kernel; (c) its
   first 8 layers C3 int8;
   (d) granite-3-2b training at full width and depth, bf16, B 2 x S 512,
   4 `make_train_step` steps at the remat default ("nothing"), exactly
   320 flash launches (each layer's forward and its recompute); (e)
   `Trainer.run` crashed in step 4 and resumed from 3; (f) granite-3-2b
   at full width and depth, bf16, B 1 x S 4096 (train_4k's sequence),
   3 steps at each remat policy ("everything", "nothing", "dots", then
   "everything" again) from the same weights and batches: 40 / 80 / 80
   flash launches a step, ms per step, peak memory and the memory
   allocated before the first step, losses and grad_norms bitwise the
   first "everything" run's or within its two runs' spread; step 0's
   first and last flash call of each run (wgmma, q (1, 32, 4096, 64), k
   / v (1, 8, 4096, 64)) held against the plain version on its own q / k
   / v within FLASH_BF16_TOL.
16. LM training on a DeviceMesh — right after phase 15, its memory freed:
   (a) two gloo ranks spawned on the card, mesh data 1 x model 2,
   granite-3-2b at full width and depth (40 layers, bf16), B 2 x S 512,
   3 `make_train_step(mesh=...)` steps from phase 15 (d)'s seed and
   batches: every rank exactly 80 flash launches a step (40 forward, 40
   recompute), all on the tensor-core kernel, at the local shape (B 2, H 16, KV 4, S = T = 512,
   hd 64); step 0's loss and grad_norm within MESH_LOSS_REL /
   MESH_GNORM_REL of phase 15 (d)'s one-device step; ms per step, device
   busy and peak memory per rank, and the collective bytes each rank
   sends a step (one more step, profiled and counted); (b) the same on
   data 2 x model 1 (batch and FSDP on the embed axes) at 8 of the 40
   layers, against the one-device step of those 8 layers; (c) one NCCL
   rank, mesh 1 x 1: loss, grad_norm and updated parameters bitwise the
   one-device step's; (d) granite-3-2b train_4k on the (16, 16) mesh of
   the dry run (`launch/dryrun.py`, a fake 256-rank world on the host) in
   a subprocess, under the card machine's torch:
   its temp bytes beside the reference's (REF_DRYRUN_TEMP_BYTES), and
   argument plus temp bytes below the card's memory.  The ranks on the card
   talk over gloo with every collective staged through host memory
   (`launch/mesh.py` `stage_gloo_collectives_through_host`): NCCL refuses
   two ranks on one card and gloo's CUDA all-gather crashes.
17. LM serving on a DeviceMesh — right after phase 16, its memory freed:
   `Server(mesh=...)` with phase 6's first 4 prompts (4 x 512 tokens, 4
   slots, 16 new each), random weights from --seed; one pair of gloo
   ranks on the card runs (a) granite-3-2b at full width and depth, bf16,
   data 1 x model 2: every rank exactly 40 flash launches, all on the
   tensor-core kernel, at the local shape (B 4, H 16, KV 4, S = T = 512,
   hd 64), the first against the plain version; (b) its first 8 layers
   C3 int8 (fitted by the parent) on the same mesh: 896 codebook
   launches a rank over 10 local (M, K, N), the first of each against
   the f64 product; (c) 8 layers, data 2 x model 1; (e)
   granite-moe-1b-a400m at full width, 8 layers, bf16, data 2 x model 1
   (a decode group straddles the two batch shards: each rank routes
   every row and does half of the experts' work, along their "embed"
   axis), 8 flash launches a rank, and (f) the same on data 1 x model 2
   (expert parallel), the one-device model's routing pinned to each
   run's (top-k flips at bf16 resolution, logged free); each run's every
   step's logits within MESH_SERVE_TOL of the one-device model fed the
   run's own tokens, no greedy token differing above it, and (a)'s two
   planted faults outside it; tokens/s, prefill and decode ms, device
   busy and idle share of one more decode step, peak memory and the
   collective bytes of a decode step per rank; (g) whisper-tiny and (h)
   mamba2-130m at full width and depth, data 1 x model 2, the heads
   unsplit (the sequence split through every block), (h)'s decode step
   divided over "model" (in_proj by pieces, out_proj's rows, the
   state's heads): each rank's decode FLOPs half of one device's
   (MESH_DECODE_FLOP_SHARE); (i) zamba2-2.7b at full width, 6 layers
   (one shared-attention group), 4 prompts of 1024 tokens on data 1 x
   model 2: in_proj by pieces on the heads' columns in every layer of
   the prefill, no prefill all-gather as large as a rank's in_proj
   output; then (d) one NCCL rank, 1 x 1, 8 layers: tokens and logits
   bitwise the one-device `Server`.

18. the examples — right after phase 17: examples/torch_quickstart.py
   on the card, exactly one zspe_spmm and one lif_update launch and no
   other, the product within V_ATOL and the LIF spikes and touched set
   equal to the same script on the CPU; examples/torch_snn_nmnist_e2e.py
   at its defaults (60 training steps, T 10), its differential check
   against the interpretive reference engine passing.

The line before the last is {"kernels": [...]} (launches from phases
4, 7, 8, 9, 11, 12, 5, 6, 13, 14, 15, 16, 17 and 18); the last line is
{"ok": true, "device": {...}}.  Exits non-zero, with no result line, when
no CUDA card is present or any phase fails.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
BATCH = 32
RAGGED_ROWS = 200              # not a multiple of the 128-row zspe tile or
                               # of the codebook kernel's 64-row tile
DENSITIES = (0.0, 0.02, 0.10, 1.0)
TIME_DENSITY = 0.10            # engine_bench's NMNIST-like input density
H100_BYTES_PER_S = 3.35e12     # H100 SXM device memory
H100_F32_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
V_ATOL = V_RTOL = 1e-5         # kernel sums over set bits in k order, the
                               # plain version is a matmul: rounding differs
TIE = 1e-4                     # a spike may flip where |v_int - theta| < TIE
SPIKE_REL_TOL = 1e-3           # fused vs compiled spike totals per layer
PJ_REL_TOL = 1e-3              # fused vs compiled pJ/SOP
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-2   # codebook backward, as the reference's
                                    # own gradient test holds it
LIF_BYTES = 25                 # lif_update: 3 x 4 bytes read, 3 x 4 + 1
                               # (int8 `updated`) written per element


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _case(rng, m, k, n, density, codebook, all_nonzero, dev, levels=16,
          idx_range=None, gauss=False):
    """Inputs of one layer-step; a zero level exists unless all_nonzero.
    Indexes are drawn from [lo, hi) = `idx_range` (default [0, levels)),
    and the dense variant's weights are their levels, 0 outside [0, L);
    with `gauss`, Gaussian f32 weights instead, a tenth of them exact 0.0
    and a tenth -0.0 unless all_nonzero."""
    import torch

    from repro_torch.core import zspe as Z

    lo, hi = (0, levels) if idx_range is None else idx_range
    kw = Z.spike_word_count(k)
    kp = kw * Z.SPIKE_WORD_BITS
    s = (rng.random((m, k)) < density).astype(np.float32)
    lv = np.sort(rng.normal(0, 2.0 / np.sqrt(k), levels)).astype(np.float32)
    if all_nonzero:
        lv[lv == 0] = 1e-3
    else:
        lv[np.argmin(np.abs(lv))] = 0.0
    idx = np.zeros((kp, n), np.int8)
    idx[:k] = rng.integers(lo, hi, (k, n))
    cbw = np.broadcast_to(lv[:, None], (levels, n)).copy()
    ix = idx[:k].astype(np.int64)
    dense = np.zeros((kp, n), np.float32)
    dense[:k] = np.where((ix >= 0) & (ix < levels),
                         lv[np.clip(ix, 0, levels - 1)], 0.0)
    t = dict(
        packed=Z.pack_spike_words(torch.as_tensor(s, device=dev)),
        v=torch.as_tensor(rng.normal(0.5, 0.4, (m, n)).astype(np.float32),
                          device=dev),
        elapsed=torch.as_tensor(rng.integers(0, 6, (m, n)).astype(np.int32),
                                device=dev))
    if gauss:
        dense[:k] = rng.normal(0, 2.0 / np.sqrt(k), (k, n))
        if not all_nonzero:
            share = rng.random((k, n))
            dense[:k][share < 0.1] = 0.0
            dense[:k][(share >= 0.1) & (share < 0.2)] = -0.0
    if codebook:
        t.update(w0=torch.as_tensor(idx, device=dev),
                 cbw=torch.as_tensor(cbw, device=dev))
    else:
        t.update(w0=torch.as_tensor(dense, device=dev), cbw=None)
    return t


def _misaligned(t):
    """A contiguous copy of `t` at storage offset 1: its data is not
    16-byte aligned, so the kernels take their narrow-copy paths."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _plain_v_int(c, partial_update, leak=0.9):
    """The plain version's integrated potential v * decay + current (the
    quantity the threshold compares), for the tie exemption."""
    from repro_torch.kernels.fused_timestep import (_dequant_columns,
                                                    _unpack_words)

    s, _ = _unpack_words(c["packed"])
    w = _dequant_columns(c["w0"], c["cbw"]) if c["cbw"] is not None \
        else c["w0"]
    decay = leak ** (c["elapsed"] + 1).float() if partial_update else leak
    return c["v"] * decay + s @ w


def _launch(c, kernel_name, all_nonzero, partial_update, v=None, el=None):
    """One kernel call on case `c`; v / elapsed are cloned unless given."""
    from repro_torch.kernels import fused_timestep as FT

    v = c["v"].clone() if v is None else v
    el = c["elapsed"].clone() if el is None else el
    kw = dict(threshold=1.0, leak=0.9, reset=0.0,
              partial_update=partial_update, all_nonzero=all_nonzero)
    if kernel_name == "fused_timestep_codebook":
        return FT.fused_timestep_codebook(c["packed"], c["w0"], c["cbw"], v,
                                          el, **kw)
    return FT.fused_timestep_dense(c["packed"], c["w0"], v, el, **kw)


def _plain(c, all_nonzero, partial_update):
    from repro_torch.kernels import fused_timestep as FT

    return FT.fused_timestep_plain(
        c["packed"], c["w0"], c["cbw"], c["v"], c["elapsed"], threshold=1.0,
        leak=0.9, reset=0.0, partial_update=partial_update,
        all_nonzero=all_nonzero)


FUSED_INTS = {1: "elapsed'", 3: "touched", 4: "nnz", 5: "empty words"}
LIF_INTS = {1: "elapsed'", 3: "updated"}


def _assert_close(what: str, got, want, tol: float = V_ATOL) -> float:
    """Floats within tol + tol * |want| (by default V_ATOL + V_RTOL *
    |want|, which are equal); returns the max difference."""
    d = (got.float() - want.float()).abs()
    if bool((d > tol + tol * want.float().abs()).any()):
        raise AssertionError(f"{what}: off by up to {float(d.max())}")
    return float(d.max()) if d.numel() else 0.0


def _exact_product(x, w):
    """The plain product x @ w in f64, where the inputs are exact: what
    the zspe and codebook kernels compute, since they sum in f64 and round
    once.  Their plain versions' f32 matmul rounds over up to K = 4096
    terms, and that rounding moves from run to run with the codebook the
    card's k-means finds (its `index_add_` adds in no fixed order): on an
    H100 it reached 1.47e-05 at M=640 K=4096 N=1024 density 1.0, past
    V_ATOL + V_RTOL * |want|."""
    return x.double() @ w.double()


def check_step(what: str, got, want, ints: dict, v_int, threshold=1.0,
               touched=None) -> float:
    """A LIF step's outputs (v', elapsed', spikes, ...) against the plain
    version's: the outputs named in `ints` exact, a spike may flip only
    within TIE of the threshold (and only where `touched` > 0, if given),
    v' within V_ATOL + V_RTOL * |want| where the spikes agree.  `v_int` is
    the plain integrated potential.  Returns the max |v' difference|."""
    import torch

    for i, name in ints.items():
        if not torch.equal(got[i], want[i]):
            raise AssertionError(f"{what}: {name} differs in "
                                 f"{int((got[i] != want[i]).sum())} elements")
    flip_ok = (v_int - threshold).abs() < TIE
    if touched is not None:
        flip_ok &= touched > 0
    flip = got[2] != want[2]
    if bool((flip & ~flip_ok).any()):
        raise AssertionError(
            f"{what}: {int((flip & ~flip_ok).sum())} spikes differ away "
            f"from the threshold")
    return _assert_close(f"{what} v'", got[0][~flip], want[0][~flip])


def compare_case(c, kernel_name, all_nonzero, partial_update,
                 desc: str = "", repeat: bool = False) -> float:
    """Kernel vs plain on one case; raises on disagreement, returns the
    max |v' difference| where no spike flipped.  With `repeat`, a second
    call on the same inputs must give bitwise the same outputs."""
    import torch

    got = _launch(c, kernel_name, all_nonzero, partial_update)
    want = _plain(c, all_nonzero, partial_update)
    if repeat:
        again = _launch(c, kernel_name, all_nonzero, partial_update)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, again)):
            if not torch.equal(a, b):
                raise AssertionError(f"{kernel_name} {desc}: output {i} of "
                                     f"two calls differs")
    torch.cuda.synchronize()
    return check_step(f"{kernel_name} {desc}", got, want, FUSED_INTS,
                      _plain_v_int(c, partial_update),
                      touched=want[3] if partial_update else None)


def _time_eager_ms(fn, reps: int = 20) -> float:
    """CUDA-event time per call of `fn` issued from Python; where the host
    issues slower than the card runs, this is the host's rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_graph_ms(fn, reps: int = 50) -> float:
    """Device time per call: `reps` calls captured in one CUDA graph and
    replayed, so no host launch cost is in the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _bound(c, codebook: bool) -> tuple[float, str]:
    """Least time for one call on these inputs: each input read once, each
    output written once (only the weight rows a spike reaches), or the f32
    adds of the set bits, whichever is larger."""
    from repro_torch.kernels.fused_timestep import _unpack_words

    s, nnz = _unpack_words(c["packed"])
    m, n = c["v"].shape
    rows_needed = int((s.sum(0) > 0).sum())
    w_bytes = rows_needed * n * (1 if codebook else 4)
    if codebook:
        w_bytes += c["cbw"].numel() * 4
    state = m * n * 4 * 2 * 2            # v and elapsed, read + written
    outs = m * n * 4 * 2 + m * 4 * 2     # spikes, touched, nnz, empty words
    nbytes = c["packed"].numel() * 2 + w_bytes + state + outs
    return _roof(nbytes, int(nnz.sum()) * n)


def _roof(nbytes: int, ops: int) -> tuple[float, str]:
    """The larger of bytes over the memory rate and f32 operations over
    the f32 rate, in ms, and which of the two it is."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (M, K, N, L, [lo, hi) of the int8 indexes, spike density) of the fused
# kernels' edges: one spike word (Kw = 1); Kw = 9, which a split of 8 does
# not divide; N = 10 and 37 (weight rows not 16-byte aligned: narrow
# copies); one row, a ragged last row tile and a whole run's 640 rows;
# M = 128 with N = 512 (BN 16 where 16 is short of a block per SM's
# worth at fewer rows); N = 1000 at M = 640 (dense: copies past N in the
# last tile; codebook: byte loads); M = 4096 with N = 37 (BN 16 on rows not
# 16-byte aligned); L = 1, 2 and 200 (only
# 0..127 reachable); indexes outside [0, L), from [-20, 20] with L = 8 at
# the ARCH shapes and from all of int8 with L = 16; all-zero and all-one
# spike tiles
FUSED_EDGE_CASES = (
    (BATCH, 16, 128, 16, None, 0.10), (BATCH, 144, 256, 16, None, 0.10),
    (BATCH, 1000, 10, 16, None, 0.10), (BATCH, 999, 37, 16, None, 0.10),
    (1, 2312, 4096, 16, None, 0.10), (RAGGED_ROWS, 999, 37, 16, None, 0.10),
    (RAGGED_ROWS, 4096, 1024, 16, None, 0.10),
    (640, 2312, 4096, 16, None, 0.10), (4 * BATCH, 1000, 512, 16, None, 0.10),
    (640, 512, 1000, 16, None, 0.10), (4096, 64, 37, 16, None, 0.10),
    (BATCH, 1024, 256, 1, None, 0.10), (BATCH, 1024, 256, 2, None, 0.10),
    (BATCH, 1024, 256, 200, (0, 128), 0.10),
    (BATCH, 1024, 256, 200, (-128, 128), 0.10),
    (BATCH, 2312, 4096, 8, (-20, 21), 0.10),
    (BATCH, 4096, 1024, 8, (-20, 21), 0.10),
    (BATCH, 1024, 10, 8, (-20, 21), 0.10),
    (BATCH, 999, 37, 16, (-128, 128), 0.10),
    (BATCH, 2312, 4096, 16, None, 0.0), (BATCH, 2312, 4096, 16, None, 1.0),
    (RAGGED_ROWS, 999, 37, 16, None, 0.0),
    (RAGGED_ROWS, 999, 37, 16, (-20, 21), 1.0))


def _weight_kinds(name) -> tuple[bool, ...]:
    """`gauss` settings of `_case` a kernel is checked with: the dense
    kernel on the indexes' levels and on Gaussian weights with 0.0 and
    -0.0 among them, the codebook kernel on its indexes."""
    return (False, True) if name == "fused_timestep_dense" else (False,)


def _fused_edge_cases(rng, dev, name) -> tuple[float, int]:
    """Fused kernel `name` at FUSED_EDGE_CASES (the dense one on the
    weights of the indexes, 0 outside [0, L), and on Gaussian weights),
    both update modes, both `all_nonzero` settings, then weights at a
    storage offset that breaks their 16-byte alignment, against the plain
    version; every call repeated and held bitwise equal."""
    codebook = name == "fused_timestep_codebook"
    err, n_cases = 0.0, 0
    for m, k, n, levels, idx_range, density in FUSED_EDGE_CASES:
        for gauss in _weight_kinds(name):
            if gauss and idx_range is not None:
                continue                      # no indexes to range over
            for all_nonzero in (False, True):
                c = _case(rng, m, k, n, density, codebook, all_nonzero, dev,
                          levels, idx_range, gauss)
                for partial_update in (True, False):
                    desc = (f"[M={m} K={k} N={n} L={levels} idx in "
                            f"{idx_range or (0, levels)} density={density} "
                            f"gauss={gauss} all_nonzero={all_nonzero} "
                            f"partial_update={partial_update}]")
                    err = max(err, compare_case(c, name, all_nonzero,
                                                partial_update, desc,
                                                repeat=True))
                    n_cases += 1
    for m, k, n in ((BATCH, 999, 64), (4 * BATCH, 1000, 512)):
        for gauss in _weight_kinds(name):
            c = _case(rng, m, k, n, TIME_DENSITY, codebook, False, dev,
                      gauss=gauss)
            c["w0"] = _misaligned(c["w0"])
            err = max(err, compare_case(
                c, name, False, True, f"[M={m} K={k} N={n} gauss={gauss} "
                f"weights at storage offset 1]", repeat=True))
            n_cases += 1
    return err, n_cases


def fused_timing(arch, seed: int, name: str, m: int) -> list[dict]:
    """Times kernel `name` at each ARCH layer with M rows, density 0.10,
    partial update: device time by CUDA-graph replay, eager time, the
    plain version's, one `torch.matmul` of the same product, and the
    bound."""
    import torch

    from repro_torch.kernels.fused_timestep import _dequant_columns, \
        _unpack_words

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 7 * m)
    codebook = name == "fused_timestep_codebook"
    per_shape = []
    for k, n in zip(arch.layer_sizes[:-1], arch.layer_sizes[1:]):
        c = _case(rng, m, k, n, TIME_DENSITY, codebook, False, dev)
        v, el = c["v"].clone(), c["elapsed"].clone()

        def run_kernel():
            _launch(c, name, False, True, v, el)
        s, _ = _unpack_words(c["packed"])
        w = _dequant_columns(c["w0"], c["cbw"]) if codebook else c["w0"]
        b, by = _bound(c, codebook)
        per_shape.append({
            "shape": [m, k, n], "ms": _time_graph_ms(run_kernel),
            "eager_ms": _time_eager_ms(run_kernel),
            "plain_ms": _time_eager_ms(lambda: _plain(c, False, True)),
            "library_ms": _time_graph_ms(lambda: torch.matmul(s, w)),
            "bound_ms": b, "bound_by": by})
    log(f"kernel {name} timed at M={m}: per shape {json.dumps(per_shape)}")
    return per_shape


def kernel_phase(arch, seed: int) -> dict:
    """Compare both kernels with their plain versions over the cases and
    the edge cases, then time them at the main path's shapes (M = 32,
    which the kernels line reports) and at a whole run's 640 rows."""
    import torch

    from repro_torch.core import zspe as Z
    from repro_torch.kernels import fused_timestep as FT

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    shapes = [(arch.layer_sizes[i], arch.layer_sizes[i + 1])
              for i in range(len(arch.layer_sizes) - 1)]
    for m in (BATCH, BATCH * arch.timesteps):
        for k, n in shapes:
            for variant, levels in (("codebook", 16), ("dense", None)):
                plan = FT._plan(m, n, levels)
                log(f"fused {variant} plan [M={m} K={k} N={n}]: BM {FT.BM}, "
                    f"BN {plan.bn}, {FT._block_threads(plan.bn)} threads, "
                    f"all {Z.spike_word_count(k)} spike words per block, "
                    f"{plan.smem} B shared, grid "
                    f"({-(-n // plan.bn)}, {-(-m // FT.BM)})")
    results = {}
    for name, codebook in (("fused_timestep_codebook", True),
                           ("fused_timestep_dense", False)):
        err = 0.0
        n_cases = 0
        for k, n in shapes:
            for density in DENSITIES:
                for gauss in _weight_kinds(name):
                    for all_nonzero in (False, True):
                        modes = (True, False) if density == TIME_DENSITY \
                            else (True,)
                        for partial_update in modes:
                            c = _case(rng, BATCH, k, n, density, codebook,
                                      all_nonzero, dev, gauss=gauss)
                            desc = (f"[K={k} N={n} density={density} "
                                    f"gauss={gauss} all_nonzero="
                                    f"{all_nonzero} partial_update="
                                    f"{partial_update}]")
                            err = max(err, compare_case(
                                c, name, all_nonzero, partial_update, desc,
                                repeat=True))
                            n_cases += 1
        edge_err, edge_n = _fused_edge_cases(rng, dev, name)
        log(f"kernel {name}: {n_cases + edge_n} cases agree (every case "
            f"called twice, bitwise equal), max |dv'| "
            f"{max(err, edge_err):.3g}")
        fused_timing(arch, seed, name, BATCH * arch.timesteps)  # logged
        per_shape = fused_timing(arch, seed, name, BATCH)
        by = {"bytes": 0.0, "operations": 0.0}
        for p in per_shape:
            by[p["bound_by"]] += p["bound_ms"]
        results[name] = {
            "max_abs_err": max(err, edge_err),
            **{key: sum(p[key] for p in per_shape)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
            "bound_by": max(by, key=by.get)}
    return results


def _api_spikes(rng, m: int, k: int, density, dev, tile=(128, 128)):
    """(m, K) f32 spikes: one step's (B, K) spikes (m = 32) or a run's
    (B, T, K) trains seen through the kernel API's leading dims.
    `density=None` is tile-structured: about half of the `tile` spike
    tiles, and always the first, hold no spike, the rest Bernoulli(0.10),
    so the zspe skip counters are nonzero at full width."""
    import torch

    if density is None:
        bm, bk = tile
        keep = rng.random((-(-m // bm), -(-k // bk))) < 0.5
        keep[0, 0] = False
        mask = np.repeat(np.repeat(keep, bm, 0), bk, 1)[:m, :k]
        s = (rng.random((m, k)) < 0.10) & mask
    else:
        s = rng.random((m, k)) < density
    return torch.as_tensor(s.astype(np.float32), device=dev)


def _lif_inputs(rng, m: int, n: int, dev):
    import torch

    cur = np.where(rng.random((m, n)) < 0.4, rng.normal(0, 0.6, (m, n)),
                   0.0).astype(np.float32)
    cur[rng.random((m, n)) < 0.05] = -0.0     # no input, like +0.0
    return (torch.as_tensor(rng.normal(0.5, 0.4, (m, n)).astype(np.float32),
                            device=dev),
            torch.as_tensor(rng.integers(0, 6, (m, n)).astype(np.int32),
                            device=dev),
            torch.as_tensor(cur, device=dev))


def _lif_v_int(v, el, cur, leak):
    """The plain partial-update potential v * leak^(elapsed + 1) + current."""
    return v * leak ** (el + 1).float() + cur


def _check_lif(v, el, cur, leak, what: str) -> float:
    """lif_update against its plain version on (v, el, cur), a second call
    bitwise equal to the first; returns the max |v' difference|."""
    import torch

    from repro_torch.kernels import lif_update as LU

    got = LU.lif_update(v, el, cur, threshold=1.0, leak=leak)
    again = LU.lif_update(v, el, cur, threshold=1.0, leak=leak)
    want = LU.lif_update_plain(v, el, cur, threshold=1.0, leak=leak,
                               reset=0.0)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, again)):
        if not torch.equal(a, b):
            raise AssertionError(f"lif_update {what}: output {i} of two "
                                 f"calls differs")
    return check_step(f"lif_update {what}", got, want, LIF_INTS,
                      _lif_v_int(v, el, cur, leak))


# (M, N) of lif_update's edges: element counts that four does not divide,
# one row, a row of the widest layer, the ARCH layers at one step and at a
# whole run
LIF_EDGE_SHAPES = ((1, 10), (1, 37), (3, 37), (37, 10), (1, 4096),
                   (BATCH, 10), (BATCH, 4096), (BATCH * 20, 1024))


def _lif_edge_cases(rng, dev) -> tuple[float, int]:
    """lif_update at LIF_EDGE_SHAPES, with all operands 16-byte aligned
    and with each of v, elapsed and current at storage offset 1, elapsed
    up to 99, against the plain version; every call repeated and held
    bitwise equal."""
    import torch

    err, n = 0.0, 0
    for m, nn in LIF_EDGE_SHAPES:
        v, _, cur = _lif_inputs(rng, m, nn, dev)
        ops = (v, torch.as_tensor(rng.integers(0, 100, (m, nn))
                                  .astype(np.int32), device=dev), cur)
        for odd in (None, 0, 1, 2):
            moved = [(_misaligned(t) if i == odd else t)
                     for i, t in enumerate(ops)]
            what = f"[{m}, {nn}]" + ("" if odd is None else
                                      f" operand {odd} at offset 1")
            err = max(err, _check_lif(*moved, 0.9, what))
            n += 1
    return err, n


def _time_api_case(m, k, n, kern, plain, lib, bound) -> dict:
    b, by = bound
    return {"shape": [m, k, n] if k else [m, n],
            "ms": _time_graph_ms(kern), "eager_ms": _time_eager_ms(kern),
            "plain_ms": _time_eager_ms(plain),
            "library_ms": None if lib is None else _time_graph_ms(lib),
            "bound_ms": b, "bound_by": by}


# (M, K, N) of the codebook product's plan edges: K = 1 (one stage, no
# split), K = 1000 and 4100 (the split's last block takes a shorter
# slice), K = 999 and N = 37 (rows not 16-byte aligned: element loads)
CODEBOOK_EDGE_SHAPES = ((BATCH, 1, 64), (BATCH, 1000, 10), (BATCH, 4100, 1024),
                        (RAGGED_ROWS, 999, 37))


def _codebook_edge_cases(rng, arch, dev) -> tuple[float, int]:
    """The codebook kernel at the edges of its lookup table and its plan,
    against the f64 product: int8 indexes drawn from [-20, 20] with an
    8-level codebook (negative bytes and 8..20 contribute 0) at the ARCH
    layer shapes with M = 32, and CODEBOOK_EDGE_SHAPES with 16 levels;
    Gaussian x in f32 and bf16, levels at the ARCH scale N(0, 2/sqrt(K))."""
    import torch

    from repro_torch.kernels import codebook_matmul as CBM

    sizes = arch.layer_sizes
    cases = [((BATCH, sizes[i], sizes[i + 1]), 8, (-20, 21))
             for i in range(len(sizes) - 1)]
    cases += [(shape, 16, (0, 16)) for shape in CODEBOOK_EDGE_SHAPES]
    err, n = 0.0, 0
    for (m, k, nn), levels, (lo, hi) in cases:
        idx = torch.as_tensor(rng.integers(lo, hi, (k, nn)).astype(np.int8),
                              device=dev)
        cb = torch.as_tensor(np.sort(rng.normal(0, 2.0 / np.sqrt(k), levels))
                             .astype(np.float32), device=dev)
        x = torch.as_tensor(rng.normal(0, 1, (m, k)).astype(np.float32),
                            device=dev)
        for xt in (x, x.to(torch.bfloat16)):
            got = CBM.codebook_matmul(xt, idx, cb)
            want = _exact_product(xt, CBM.dequantize(idx, cb))
            torch.cuda.synchronize()
            err = max(err, _assert_close(
                f"codebook_matmul [M={m} K={k} N={nn} L={levels} idx in "
                f"[{lo}, {hi})] x {xt.dtype}", got, want))
            n += 1
    return err, n


# (M, K, N) of the zspe kernel's plan edges: K = 1 (one k, no split),
# K = 999 and 1000 (no split divides them), N = 10 and 37 (rows not 16-byte
# aligned: 4-byte copies), M = RAGGED_ROWS (a ragged last row tile)
ZSPE_EDGE_SHAPES = ((BATCH, 1, 64), (BATCH, 999, 10), (BATCH, 1000, 37),
                    (RAGGED_ROWS, 999, 37), (RAGGED_ROWS, 2312, 1024))
# spike values besides {0, 1}: the kernel multiplies by them (int8 spikes
# take the integer levels)
ZSPE_LEVELS = {"float32": (0.0, 0.5, 1.0, 2.0), "int8": (0.0, 1.0, 2.0, -3.0)}


def _zspe_edge_cases(rng, dev) -> tuple[float, int]:
    """The zspe kernel at the edges of its plan, with {0, 1} spikes
    (density 0.10), other spike values, an all-zero and an all-one tile,
    in f32 and int8: against the f64 product, counters equal to the plain
    version's, and a second call bitwise equal to the first."""
    import torch

    from repro_torch.kernels import zspe_spmm as ZS
    from repro_torch.kernels.ops import _pick_block

    err, n_cases = 0.0, 0
    for m, k, n in ZSPE_EDGE_SHAPES:
        w = torch.as_tensor(rng.normal(0, 1, (k, n)).astype(np.float32),
                            device=dev)
        block = _pick_block(m, k, n)
        for kind in ("binary", "levels", "zeros", "ones"):
            for dtype in (torch.float32, torch.int8):
                nz = rng.random((m, k)) < 0.10
                if kind == "levels":
                    lv = np.asarray(ZSPE_LEVELS[str(dtype).split(".")[1]],
                                    np.float32)
                    s = nz * lv[rng.integers(1, len(lv), (m, k))]
                elif kind == "zeros":
                    s = np.zeros((m, k), np.float32)
                elif kind == "ones":
                    s = np.ones((m, k), np.float32)
                else:
                    s = nz.astype(np.float32)
                st = torch.as_tensor(s.astype(np.float32), device=dev)
                st = st.to(dtype)
                desc = (f"zspe_spmm [M={m} K={k} N={n} {kind} {dtype}]")
                out, skipped = ZS.zspe_spmm(st, w, block=block)
                again, skipped_again = ZS.zspe_spmm(st, w, block=block)
                _, want_skipped = ZS.zspe_spmm_plain(st, w, block)
                torch.cuda.synchronize()
                if not (torch.equal(skipped, want_skipped)
                        and torch.equal(skipped_again, want_skipped)):
                    raise AssertionError(f"{desc}: skip counters differ")
                if not torch.equal(out, again):
                    raise AssertionError(f"{desc}: two calls differ")
                err = max(err, _assert_close(desc, out,
                                             _exact_product(st, w)))
                n_cases += 1
    return err, n_cases


def api_kernel_phase(arch, qws, seed: int) -> dict:
    """The kernel API's three kernels against their plain versions on the
    card at the ARCH layer shapes and three row counts: M = 32 (one step
    of the kernel-API path), M = RAGGED_ROWS (edge row tiles in both
    products) and M = 640 (a whole run through the leading dims).  Then
    timed at density 0.10 at M = 32, the shape the path runs, which the
    kernels line reports, and at M = 640."""
    import torch

    from repro_torch.core.quant import dequantize
    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.kernels import lif_update as LU
    from repro_torch.kernels import zspe_spmm as ZS
    from repro_torch.kernels.ops import _pick_block

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 3)
    rows = BATCH * arch.timesteps
    leak = 0.9
    err = {"zspe_spmm": 0.0, "codebook_matmul": 0.0, "lif_update": 0.0}
    n_cases = dict.fromkeys(err, 0)
    timing = {name: [] for name in err}
    for q in qws:
        idx, cb = q.idx, q.codebook[0]
        w = dequantize(q)
        k, n = w.shape
        for m in (BATCH, rows):
            plan = ZS._plan(m, k, n)
            log(f"zspe plan [M={m} K={k} N={n}]: BM {ZS.BM}, BN {ZS.BN}, "
                f"split {plan.split}, K slice {plan.k_chunk}, grid "
                f"({-(-n // ZS.BN) * plan.split}, {-(-m // ZS.BM)})")
        for m in (BATCH, RAGGED_ROWS, rows):
            block = _pick_block(m, k, n)
            for density in (*DENSITIES, None):
                s = _api_spikes(rng, m, k, density, dev, block[:2])
                desc = f"[M={m} K={k} N={n} density={density}]"
                for sd in ((s, s.to(torch.int8)) if density == TIME_DENSITY
                           else (s,)):
                    out, skipped = ZS.zspe_spmm(sd, w, block=block)
                    again, _ = ZS.zspe_spmm(sd, w, block=block)
                    _, want_skipped = ZS.zspe_spmm_plain(sd, w, block)
                    torch.cuda.synchronize()
                    if not torch.equal(skipped, want_skipped):
                        raise AssertionError(f"zspe_spmm {desc}: skip "
                                             f"counters differ")
                    if not torch.equal(out, again):
                        raise AssertionError(f"zspe_spmm {desc}: two "
                                             f"calls differ")
                    if density is None and int(skipped.sum()) == 0:
                        raise AssertionError(f"zspe_spmm {desc}: no tile "
                                             f"skipped")
                    err["zspe_spmm"] = max(err["zspe_spmm"], _assert_close(
                        f"zspe_spmm {desc} {sd.dtype}", out,
                        _exact_product(sd, w)))
                    n_cases["zspe_spmm"] += 1
                gauss = torch.as_tensor(
                    rng.normal(0, 1, s.shape).astype(np.float32), device=dev)
                xs = ((s, gauss, gauss.to(torch.bfloat16))
                      if density == TIME_DENSITY else (s,))
                for x in xs:
                    got = CBM.codebook_matmul(x, idx, cb)
                    want = _exact_product(x, CBM.dequantize(idx, cb))
                    torch.cuda.synchronize()
                    err["codebook_matmul"] = max(
                        err["codebook_matmul"],
                        _assert_close(f"codebook_matmul {desc} x {x.dtype}",
                                      got, want))
                    n_cases["codebook_matmul"] += 1
            v, el, cur = _lif_inputs(rng, m, n, dev)
            err["lif_update"] = max(err["lif_update"], _check_lif(
                v, el, cur, leak, f"[{m}, {n}]"))
            n_cases["lif_update"] += 1

        for m in (BATCH, rows):
            s = _api_spikes(rng, m, k, TIME_DENSITY, dev)
            v, el, cur = _lif_inputs(rng, m, n, dev)
            block = _pick_block(m, k, n)
            nz = s != 0
            zspe_bytes = (s.numel() * 4 + int(nz.any(0).sum()) * n * 4
                          + m * n * 4
                          + 4 * -(-m // block[0]) * -(-n // block[2]))
            timing["zspe_spmm"].append(_time_api_case(
                m, k, n, lambda: ZS.zspe_spmm(s, w, block=block),
                lambda: ZS.zspe_spmm_plain(s, w, block),
                lambda: torch.matmul(s, w),
                _roof(zspe_bytes, int(nz.sum()) * n)))
            timing["codebook_matmul"].append(_time_api_case(
                m, k, n, lambda: CBM.codebook_matmul(s, idx, cb),
                lambda: CBM.codebook_matmul_plain(s, idx, cb),
                lambda: torch.matmul(s, cb[idx.long()]),
                _roof(s.numel() * 4 + idx.numel() + cb.numel() * 4
                      + m * n * 4, 2 * m * k * n)))
            timing["lif_update"].append(_time_api_case(
                m, 0, n,
                lambda: LU.lif_update(v, el, cur, threshold=1.0, leak=leak),
                lambda: LU.lif_update_plain(v, el, cur, threshold=1.0,
                                            leak=leak, reset=0.0),
                None, _roof(LIF_BYTES * v.numel(), 0)))
    edge_err, edge_n = _codebook_edge_cases(rng, arch, dev)
    err["codebook_matmul"] = max(err["codebook_matmul"], edge_err)
    n_cases["codebook_matmul"] += edge_n
    edge_err, edge_n = _zspe_edge_cases(rng, dev)
    err["zspe_spmm"] = max(err["zspe_spmm"], edge_err)
    n_cases["zspe_spmm"] += edge_n
    edge_err, edge_n = _lif_edge_cases(rng, dev)
    err["lif_update"] = max(err["lif_update"], edge_err)
    n_cases["lif_update"] += edge_n
    results = {}
    for name, shapes in timing.items():
        log(f"kernel {name}: {n_cases[name]} cases agree, max |diff| "
            f"{err[name]:.3g}; per shape {json.dumps(shapes)}")
        path = [r for r in shapes if r["shape"][0] == BATCH]
        by = {"bytes": 0.0, "operations": 0.0}
        for r in path:
            by[r["bound_by"]] += r["bound_ms"]
        lib = [r["library_ms"] for r in path]
        results[name] = {
            "max_abs_err": err[name], "ms": sum(r["ms"] for r in path),
            "plain_ms": sum(r["plain_ms"] for r in path),
            "library_ms": None if None in lib else sum(lib),
            "bound_ms": sum(r["bound_ms"] for r in path),
            "bound_by": max(by, key=by.get)}
    return results


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def _arch_weights(arch, seed):
    rng = np.random.default_rng(seed)
    sizes = arch.layer_sizes
    return [rng.normal(0, 2.0 / np.sqrt(sizes[i]),
                       (sizes[i], sizes[i + 1])).astype(np.float32)
            for i in range(len(sizes) - 1)]


def _arch_quantized(arch, seed):
    """The ARCH weights of `_arch_weights`, 16-level quantized on the card
    as the main path quantizes them."""
    from repro_torch import CodebookConfig, quantize

    qcfg = CodebookConfig(n_levels=arch.weight_levels,
                          bit_width=arch.weight_bits, zero_level=True)
    return [quantize(w, qcfg, device=DEVICE)
            for w in _arch_weights(arch, seed)]


def _layer_spikes(sim, trains) -> np.ndarray:
    ys, _ = sim.array_engine().run_raw(trains)
    return ys["fired"].sum(dim=(0, 1)).double().cpu().numpy()


def _check_against_compiled(fused, compiled, trains, what: str) -> None:
    f_sp = _layer_spikes(fused, trains)
    c_sp = _layer_spikes(compiled, trains)
    rel = np.abs(f_sp - c_sp) / np.maximum(c_sp, 1.0)
    log(f"{what}: spikes per layer fused {f_sp.tolist()} compiled "
        f"{c_sp.tolist()} (max rel {rel.max():.3g})")
    if rel.max() > SPIKE_REL_TOL:
        raise AssertionError(f"{what}: fused and compiled spike totals "
                             f"differ by {rel.max():.3g} relative")
    _, rf = fused.run_batch(trains)
    _, rc = compiled.run_batch(trains)
    pf = np.array([r.pj_per_sop for r in rf])
    pc = np.array([r.pj_per_sop for r in rc])
    prel = np.abs(pf - pc) / pc
    log(f"{what}: pJ/SOP fused {pf.mean():.6f} compiled {pc.mean():.6f} "
        f"(max rel {prel.max():.3g})")
    if prel.max() > PJ_REL_TOL:
        raise AssertionError(f"{what}: pJ/SOP differs by {prel.max():.3g}")


def _device_breakdown(fn, wall_ms: float,
                      sums=(("fused_kernel_ms", "fused_timestep_"),)
                      ) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler), and
    the card's idle share against the unprofiled wall time `wall_ms`;
    `sums` names (key, substring) pairs: the device ms of the kernels whose
    name holds the substring.  Only device events count: a CPU op (an
    `aten::` op, an autograd node) also carries the device time of the
    kernels it launched, so summing it too would count them twice.  The
    profiler records the device activity alone: recording the CPU ops
    too gives the same device sums (within 0.3 % on a served zamba2-2.7b
    or mamba2-130m batch) and costs 2 to 3 times the profiler's seconds
    over the thousands of eager ops of LM decode steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0 and e.device_type != DeviceType.CPU:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + us / 1e3
    busy = sum(by_kernel.values())
    if busy == 0:
        log("device breakdown: the profiler saw no device time — not "
            "measured")
        return {}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"device_busy_ms": busy}
    for key, part in sums:
        out[key] = sum(ms for name, ms in by_kernel.items() if part in name)
    out.update(idle_share=max(0.0, 1.0 - busy / wall_ms),
               device_kernels=len(by_kernel))
    log(f"device breakdown of one run (profiled): {json.dumps(out)}; "
        f"top kernels (ms): {json.dumps(top)}")
    return out


def main_path(arch, seed: int) -> dict:
    import torch

    from repro_torch import ChipSimulator, CodebookConfig, quantize
    from repro_torch.kernels import fused_timestep as FT

    dev = DEVICE
    weights = _arch_weights(arch, seed)
    rng = np.random.default_rng(seed + 1)
    trains = (rng.random((BATCH, arch.timesteps, arch.layer_sizes[0]))
              < TIME_DENSITY).astype(np.float32)
    qcfg = CodebookConfig(n_levels=arch.weight_levels,
                          bit_width=arch.weight_bits, zero_level=True)
    stage = {}
    t0 = time.perf_counter()
    qws = [quantize(w, qcfg, device=dev) for w in weights]
    torch.cuda.synchronize()
    stage["quantize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = ChipSimulator(qws, engine="fused", freq_hz=arch.freq_hz,
                        threshold=arch.threshold, leak=arch.leak, device=dev)
    stage["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = sim.fused_engine()
    stage["lower_s"] = time.perf_counter() - t0
    if eng.codebook_layers != len(weights):
        raise AssertionError(f"only {eng.codebook_layers} layers lowered to "
                             f"codebook mode")
    trains_dev = torch.as_tensor(trains, device=dev)

    FT.reset_launches()
    counts, reports = sim.run_batch(trains_dev)
    torch.cuda.synchronize()
    launches = dict(FT.launches)
    want = arch.timesteps * len(weights)
    if launches != {"fused_timestep_codebook": want,
                    "fused_timestep_dense": 0}:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{want} codebook launches")
    counts_np = counts.cpu().numpy()
    if counts_np.shape != (BATCH, arch.layer_sizes[-1]) \
            or not np.isfinite(counts_np).all() or counts_np.min() < 0:
        raise AssertionError(f"bad output counts {counts_np.shape}")
    pj = np.array([r.pj_per_sop for r in reports])
    if not np.isfinite(pj).all() or pj.min() <= 0:
        raise AssertionError(f"bad pJ/SOP {pj}")
    log(f"main path: {launches}, outputs {counts_np.shape} total "
        f"{counts_np.sum():.0f}, pJ/SOP mean {pj.mean():.6f}")

    compiled = ChipSimulator(qws, engine="compiled", freq_hz=arch.freq_hz,
                             threshold=arch.threshold, leak=arch.leak,
                             mapping=sim.mapping, device=dev)
    _check_against_compiled(sim, compiled, trains_dev, "quantized ARCH")

    def timed(fn, reps=5):
        fn()                                  # warmup
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return statistics.median(out) * 1e3

    run_ms = timed(lambda: sim.run_batch(trains_dev))
    raw_ms = timed(lambda: eng.run_raw(trains_dev))
    comp_ms = timed(lambda: compiled.run_batch(trains_dev))
    perf = {"ms_per_run": run_ms, "samples_per_s": BATCH / run_ms * 1e3,
            "run_raw_ms": raw_ms, "price_ms": run_ms - raw_ms,
            "compiled_ms_per_run": comp_ms, **stage}
    log(f"main path timing (median of 5): {json.dumps(perf)}")
    perf.update(_device_breakdown(lambda: sim.run_batch(trains_dev), run_ms))

    # a float simulator takes the dense kernel
    fsim = ChipSimulator(weights, engine="fused", freq_hz=arch.freq_hz,
                         threshold=arch.threshold, leak=arch.leak,
                         mapping=sim.mapping, device=dev)
    if fsim.fused_engine().codebook_layers != 0:
        raise AssertionError("float simulator lowered to codebook mode")
    short = trains_dev[:, :2].contiguous()
    FT.reset_launches()
    fsim.run_batch(short)
    torch.cuda.synchronize()
    dense_launches = dict(FT.launches)
    if dense_launches != {"fused_timestep_codebook": 0,
                          "fused_timestep_dense": 2 * len(weights)}:
        raise AssertionError(f"float run launches {dense_launches}")
    fcomp = ChipSimulator(weights, engine="compiled", freq_hz=arch.freq_hz,
                          threshold=arch.threshold, leak=arch.leak,
                          mapping=sim.mapping, device=dev)
    _check_against_compiled(fsim, fcomp, short, "float ARCH, T=2")
    return {"launches": {**launches, "fused_timestep_dense":
                         dense_launches["fused_timestep_dense"]},
            "perf": perf,
            "ctx": {"sim": sim, "qws": qws, "weights": weights,
                    "trains": trains_dev}}


# ---------------------------------------------------------------------------
# phase 7: the faulted and traced main path
# ---------------------------------------------------------------------------

DROP_P = 0.05                  # per-hop packet loss of the faulted chip
FAULT_SEED = 7
TRACE_REL_TOL = 1e-9           # trace sums against the reports (f64)


def _cuts(sim, src: int, dst: int, nodes, links) -> bool:
    """Does the healthy static route src -> dst pass through one of
    `nodes` or over one of `links`?  Worked out here from the routing
    table, apart from the program's own predicate, so the zeroed-block
    check below can catch a wrong one."""
    path = [int(n) for n in sim.routing.path(int(src), int(dst))]
    return (any(n in nodes for n in path[1:-1])
            or any(tuple(sorted(uv)) in links for uv in zip(path, path[1:])))


def fault_plan(sim, bit_width: int = 8):
    """The unrepaired chip of phase 7 on the healthy simulator's mapping:
    one dead core of layer 2; the failed router on the static routes of
    the most (src core, dst core) pairs; a failed link on the route of
    another pair; a bit-flip on a layer-1 core's codebook word and a
    stuck word on a layer-2 core's (nonzero words, so the zero level
    every zeroed block needs survives); drop_p DROP_P, seed FAULT_SEED."""
    from repro_torch.core import noc as NOC
    from repro_torch.faults import CodebookFault, FaultConfig

    m = sim.mapping
    layer2 = m.cores_of_layer(2)
    dead = int(layer2[-1].core_id)
    pairs = [(int(s.core_id), int(d.core_id))
             for li in range(1, len(sim.weights))
             for s in m.cores_of_layer(li) for d in m.cores_of_layer(li + 1)
             if s.core_id != d.core_id and dead not in (s.core_id,
                                                        d.core_id)]
    routers = [(sum(_cuts(sim, s, d, {int(r)}, ()) for s, d in pairs),
                int(r)) for r in NOC.router_ids()]
    blocks, router = max(routers)
    if not blocks:
        raise AssertionError("no router lies on a route of the mapping")
    uses: dict = {}
    for s, d in pairs:
        p = sim.routing.path(s, d)
        if router in p:
            continue
        for uv in zip(p, p[1:]):
            uses[tuple(sorted(uv))] = uses.get(tuple(sorted(uv)), 0) + 1
    link = max(uses, key=lambda uv: (uses[uv], uv))

    def table(a):
        return sim.register_tables[m.assignments.index(a)]

    flip_core = m.cores_of_layer(1)[0]
    words = table(flip_core).codebook_words
    flip_word = int(np.argmax(np.abs(words)))        # |w| >= 2: stays != 0
    stuck_core = layer2[0]
    words = table(stuck_core).codebook_words
    stuck_word = int(np.flatnonzero(np.asarray(words))[0])
    w = int(words[stuck_word])
    lim = 1 << (bit_width - 1)
    stuck_value = -w if -lim <= -w < lim else lim - 1
    return FaultConfig(
        dead_cores=(dead,), failed_routers=(router,), failed_links=(link,),
        codebook_faults=(
            CodebookFault(core_id=int(flip_core.core_id), word=flip_word,
                          kind="bitflip", bit=0),
            CodebookFault(core_id=int(stuck_core.core_id), word=stuck_word,
                          kind="stuck", value=stuck_value)),
        drop_p=DROP_P, seed=FAULT_SEED)


def _expect_launches(what: str, want: dict) -> dict:
    from repro_torch.kernels import fused_timestep as FT

    got = dict(FT.launches)
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    return got


def _blocked_blocks(sim, faults) -> list:
    """(layer index, src rows, dst cols) of every weight block a failed
    router, dead core or link cuts on the healthy routes."""
    dead = set(faults.dead_cores)
    nodes = dead | set(faults.failed_routers)
    links = {tuple(sorted(uv)) for uv in faults.failed_links}
    out = []
    for li in range(1, len(sim.weights)):
        for s in sim.mapping.cores_of_layer(li):
            for d in sim.mapping.cores_of_layer(li + 1):
                if (s.core_id != d.core_id and s.core_id not in dead
                        and _cuts(sim, s.core_id, d.core_id, nodes, links)):
                    out.append((li, slice(s.neuron_lo, s.neuron_hi),
                                slice(d.neuron_lo, d.neuron_hi)))
    return out


def _check_trace(sim, counts, reports, what: str) -> dict:
    """The run's ChipTrace against its reports (energy and wall sums,
    tests/test_telemetry.py's rule) and its Perfetto document."""
    from repro_torch.telemetry import profile, to_perfetto

    trace = sim.last_trace()
    if trace is None or trace.batch != len(reports):
        raise AssertionError(f"{what}: no trace of the run")
    chip = profile(trace, core_model=sim.core_model, riscv=sim.riscv)["chip"]
    worst = 0.0
    for key, field in (("core_pj", "core_energy_pj"),
                       ("noc_pj", "noc_energy_pj"),
                       ("riscv_pj", "riscv_energy_pj"),
                       ("total_pj", "energy_pj")):
        want = sum(getattr(r, field) for r in reports)
        rel = abs(chip[key] - want) / max(abs(want), 1e-300)
        worst = max(worst, rel)
        if rel > TRACE_REL_TOL:
            raise AssertionError(f"{what}: profile {key} {chip[key]} "
                                 f"against the reports' {want}")
    walls = trace.wall_cycles()
    for b, r in enumerate(reports):
        rel = abs(walls[b] - r.wall_cycles) / r.wall_cycles
        worst = max(worst, rel)
        if rel > TRACE_REL_TOL:
            raise AssertionError(f"{what}: trace wall {walls[b]} against "
                                 f"sample {b}'s {r.wall_cycles}")
    last_layer = trace.slice_layer == trace.n_layers - 1
    if not np.array_equal(trace.fired[..., last_layer].sum(axis=(1, 2)),
                          counts.sum(axis=1)):
        raise AssertionError(f"{what}: traced output spikes differ from "
                             f"the counts")
    doc = json.loads(json.dumps(to_perfetto(trace)))
    last: dict = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "M":
            continue
        track = (ev["pid"], ev["tid"])
        if ev["ts"] < last.get(track, 0.0) - 1e-9 or ev.get("dur", 0) < 0:
            raise AssertionError(f"{what}: perfetto track {track} goes "
                                 f"back in time at {ev}")
        last[track] = ev["ts"]
    log(f"{what}: trace {trace.fired.shape}, chip {json.dumps(chip)}, "
        f"max rel against the reports {worst:.3g}, perfetto "
        f"{len(doc['traceEvents'])} events on {len(last)} tracks")
    return chip


def fault_path(arch, ctx: dict, smi: str) -> dict:
    """Phase 7: phase 4's network (its quantized weights and mapping)
    on faulted chips, through the same entry points."""
    import dataclasses

    import torch

    from repro_torch import ChipSimulator
    from repro_torch.faults import FaultConfig, TransientChipFault
    from repro_torch.kernels import fused_timestep as FT
    from repro_torch.telemetry import TraceConfig

    healthy, qws, weights, trains = (ctx["sim"], ctx["qws"], ctx["weights"],
                                     ctx["trains"])
    dev = healthy.device
    T, L = int(trains.shape[1]), len(qws)
    kw = dict(freq_hz=arch.freq_hz, threshold=arch.threshold,
              leak=arch.leak, mapping=healthy.mapping, device=dev)
    faults = fault_plan(healthy, arch.weight_bits)
    log(f"fault plan: {json.dumps(faults.describe())}, codebook faults "
        f"{[dataclasses.astuple(c) for c in faults.codebook_faults]}")

    # (a) the unrepaired chip, traced
    sim = ChipSimulator(qws, engine="fused", faults=faults,
                        trace=TraceConfig(enabled=True), **kw)
    eng = sim.fused_engine()
    if eng.codebook_layers != L:
        raise AssertionError(f"faulted chip: only {eng.codebook_layers} "
                             f"layers lowered to codebook mode")
    blocks = [b for b in _blocked_blocks(sim, faults)
              if healthy.weights[b[0]][b[1], b[2]].any()]
    kept = [b for b in blocks if sim.weights[b[0]][b[1], b[2]].any()]
    if not blocks or kept:
        raise AssertionError(f"faulted chip: {len(kept)} of {len(blocks)} "
                             f"cut weight blocks not zeroed")
    plan = sim.drop_plan
    active = [li for li, p in enumerate(plan.keep_p if plan else ())
              if p is not None]
    if not active:
        raise AssertionError("faulted chip: the drop plan is inactive")
    for li in active:
        if not torch.equal(plan.masks(li, T, dev).cpu(),
                           plan.masks(li, T, "cpu")):
            raise AssertionError(f"drop masks of layer {li} differ between "
                                 f"the card and the CPU")
    keep_min = min(float(plan.keep_p[li].min()) for li in active)
    draws = sum(T * len(plan.keep_p[li]) for li in active)
    log(f"faulted chip: all {len(blocks)} cut weight blocks zeroed (a "
        f"block is counted where the healthy chip's is not zero), "
        f"drop active on layers {active}, keep_p min {keep_min:.4f}, device "
        f"masks equal to the CPU's ({draws} draws)")
    FT.reset_launches()
    counts, reports = sim.run_batch(trains)
    torch.cuda.synchronize()
    launches = _expect_launches("faulted chip", {
        "fused_timestep_codebook": T * L, "fused_timestep_dense": 0})
    counts_np = counts.cpu().numpy()
    pj = np.array([r.pj_per_sop for r in reports])
    if counts_np.shape != (len(reports), arch.layer_sizes[-1]) \
            or not np.isfinite(counts_np).all() or not np.isfinite(pj).all():
        raise AssertionError(f"faulted chip: bad outputs {counts_np.shape}")
    _check_trace(sim, counts_np, reports, "faulted chip")
    compiled = ChipSimulator(qws, engine="compiled", faults=faults, **kw)
    _check_against_compiled(sim, compiled, trains, "faulted ARCH")

    # (b) the repaired chip: routes recompiled around the router
    router = faults.failed_routers[0]
    repaired = FaultConfig(failed_routers=(router,)).with_rerouted()
    rsim = ChipSimulator(qws, engine="fused", faults=repaired, **kw)
    crossing = [f for fl in rsim._layer_routes.values() for f in fl
                if any(router in uv for uv in f.links)]
    if crossing:
        raise AssertionError(f"repaired chip: {len(crossing)} routes cross "
                             f"router {router}")
    rcomp = ChipSimulator(qws, engine="compiled", faults=repaired, **kw)
    _check_against_compiled(rsim, rcomp, trains, "repaired ARCH")
    # the run's NoC hops are the fired counts times the rerouted flows'
    # hops (its spikes are the healthy chip's: no weight changed)
    ys, _ = rsim.array_engine().run_raw(trains)
    replay = np.zeros(int(trains.shape[0]))
    for li in range(L):
        routes = rsim._layer_routes.get(li + 1)
        if routes:
            fired = ys[f"fired_core_{li}"].sum(dim=1).double().cpu().numpy()
            replay += fired @ np.array([f.hops for f in routes], np.float64)
    _, rrep = rsim.run_batch(trains)
    _, hrep = healthy.run_batch(trains)
    hops = np.array([r.stats.noc_hops for r in rrep])
    hops0 = np.array([r.stats.noc_hops for r in hrep])
    if not np.array_equal(hops, replay):
        raise AssertionError(f"repaired chip: NoC hops {hops.tolist()} "
                             f"against the rerouted replay "
                             f"{replay.tolist()}")
    log(f"repaired chip (router {router}): no route crosses it, NoC hops "
        f"per sample {hops.mean():.1f} (equal to the rerouted replay) "
        f"against healthy {hops0.mean():.1f} (min change "
        f"{(hops - hops0).min():.0f})")

    # (c) a float simulator under (a)'s faults (codebook faults need a
    # quantized chip), T = 2: the dense kernel
    ffaults = dataclasses.replace(faults, codebook_faults=())
    fsim = ChipSimulator(weights, engine="fused", faults=ffaults, **kw)
    if fsim.fused_engine().codebook_layers != 0:
        raise AssertionError("float simulator lowered to codebook mode")
    short = trains[:, :2].contiguous()
    FT.reset_launches()
    fsim.run_batch(short)
    torch.cuda.synchronize()
    dense = _expect_launches("faulted float chip", {
        "fused_timestep_codebook": 0, "fused_timestep_dense": 2 * L})
    fcomp = ChipSimulator(weights, engine="compiled", faults=ffaults, **kw)
    _check_against_compiled(fsim, fcomp, short, "faulted float ARCH, T=2")

    # (d) a transient dispatch fault, and the null config
    tsim = ChipSimulator(qws, engine="fused",
                         faults=FaultConfig(transient_dispatches=(0,)), **kw)
    try:
        tsim.run_batch(trains)
    except TransientChipFault as e:
        log(f"transient fault: first dispatch raised ({e})")
    else:
        raise AssertionError("transient fault: dispatch 0 did not raise")
    tcounts, _ = tsim.run_batch(trains)
    hcounts, _ = healthy.run_batch(trains)
    if not torch.equal(tcounts, hcounts):
        raise AssertionError("transient fault: the retry differs from the "
                             "healthy run")
    nsim = ChipSimulator(qws, engine="fused", faults=FaultConfig(),
                         trace=TraceConfig(enabled=False), **kw)
    raw = {}
    for name, s in (("none", healthy), ("null", nsim)):
        FT.reset_launches()
        ys, c = s.fused_engine().run_raw(trains)
        torch.cuda.synchronize()
        raw[name] = (ys, c, dict(FT.launches), s.run_batch(trains))
    (ys0, c0, l0, (cc0, r0)), (ys1, c1, l1, (cc1, r1)) = (raw["none"],
                                                          raw["null"])
    same = (ys0.keys() == ys1.keys() and l0 == l1 and torch.equal(c0, c1)
            and torch.equal(cc0, cc1)
            and all(torch.equal(ys0[k], ys1[k]) for k in ys0)
            and [dataclasses.astuple(r) for r in r0]
            == [dataclasses.astuple(r) for r in r1])
    if not same or nsim.last_trace() is not None:
        raise AssertionError("null FaultConfig: not bitwise the healthy run")
    log(f"null config: counters {sorted(ys1)} bitwise equal to faults=None, "
        f"launches {l1}")

    # (e) timing: the traced faulted run against the untraced healthy one
    perf = {"faulted_traced_ms_per_run": _timed_ms(
                lambda: sim.run_batch(trains)),
            "healthy_ms_per_run": _timed_ms(
                lambda: healthy.run_batch(trains))}
    for name, s, ms in (("faulted_traced", sim,
                         perf["faulted_traced_ms_per_run"]),
                        ("healthy", healthy, perf["healthy_ms_per_run"])):
        got = _device_breakdown(lambda: s.run_batch(trains), ms)
        perf.update({f"{name}_{k}": v for k, v in got.items()})
    log(f"fault path timing (median of 5; {smi}): {json.dumps(perf)}")
    return {"launches": {
        "fused_timestep_codebook": launches["fused_timestep_codebook"],
        "fused_timestep_dense": dense["fused_timestep_dense"]},
        "perf": perf, "repaired": rsim}


# ---------------------------------------------------------------------------
# phase 8: on-chip plasticity and the interpretive reference engine
# ---------------------------------------------------------------------------

STDP_LAYERS = (1, 2)           # (a): the two layers after the input layer
READOUT = 2                    # (b): R-STDP on the readout, as
RSTDP = dict(lr=0.05, elig_pre=0.5)   # deploy/adapt.py continual_adaptation
REF_BATCH = 2                  # (c): samples of the interpretive engine


def _host_ys(ys, keys) -> dict:
    return {k: ys[k].double().cpu().numpy() for k in keys}


def _trace_ys(trace) -> dict:
    """The run's counters as the array engines' run_raw names them, from
    a ChipTrace (the reference engine has no run_raw)."""
    ys = {f"fired_core_{li}": trace.fired[..., trace.slice_layer == li]
          for li in range(trace.n_layers)}
    ys["fired"] = np.stack([ys[f"fired_core_{li}"].sum(axis=-1)
                            for li in range(trace.n_layers)], axis=-1)
    ys["writes"] = trace.weight_writes
    return ys


def _hold_plastic(what: str, got: tuple, want: tuple, frozen, learnable
                  ) -> int:
    """Phase 8's rule, `got` (fused or reference) against `want`
    (compiled), each (host counters, learned indexes): spike and write
    totals per layer within SPIKE_REL_TOL; in every sample whose frozen
    layers fired the same per-core counts at every step (so its learnable
    layers saw the same spikes), learned indexes and writes bitwise
    equal.  Returns how many samples that is (at least one)."""
    (ys_g, learned_g), (ys_w, learned_w) = got, want
    for key in ("fired", "writes"):
        g, w = ys_g[key].sum(axis=(0, 1)), ys_w[key].sum(axis=(0, 1))
        rel = np.abs(g - w) / np.maximum(w, 1.0)
        log(f"{what}: {key} per layer {g.tolist()} against compiled "
            f"{w.tolist()} (max rel {rel.max():.3g})")
        if rel.max() > SPIKE_REL_TOL:
            raise AssertionError(f"{what}: {key} totals differ by "
                                 f"{rel.max():.3g} relative")
    rows = _frozen_rows(ys_g, ys_w, frozen)
    if not len(rows):
        raise AssertionError(f"{what}: no sample's frozen layers fired as "
                             f"the compiled engine's")
    if not np.array_equal(ys_g["writes"][rows], ys_w["writes"][rows]):
        raise AssertionError(f"{what}: writes differ in a sample with "
                             f"equal frozen layers")
    for li in learnable:
        if not _rows_equal(learned_g[li], learned_w[li], rows):
            raise AssertionError(f"{what}: layer {li}'s learned indexes "
                                 f"differ in a sample with equal frozen "
                                 f"layers")
    rest = ys_w["fired"].shape[0] - len(rows)
    log(f"{what}: learned indexes and writes bitwise equal in all "
        f"{len(rows)} samples whose frozen layers {list(frozen)} fired as "
        f"the compiled engine's, of {ys_w['fired'].shape[0]}"
        + (f" (in {rest}, a near-tie flip in a frozen layer: the kernel's "
           f"f64 sum against an f32 matmul)" if rest else ""))
    return len(rows)


def _frozen_rows(ys_a, ys_b, frozen) -> np.ndarray:
    """The samples whose frozen layers fired the same per-core counts at
    every step in both runs: their learnable layers saw the same spikes."""
    same = np.ones(ys_a["fired"].shape[0], bool)
    for li in frozen:
        key = f"fired_core_{li}"
        same &= (ys_a[key] == ys_b[key]).all(axis=(1, 2))
    return np.flatnonzero(same)


def _rows_equal(a, b, rows) -> bool:
    import torch

    idx = torch.as_tensor(rows, dtype=torch.long)
    return torch.equal(a.cpu()[idx], b.cpu()[idx])


def _plastic_runs(fused, comp, trains, learned=(None, None)) -> tuple:
    """One run_raw of each engine: ((host counters, learned indexes) of
    the fused run, the same of the compiled run)."""
    out = []
    for sim, warm in zip((fused, comp), learned):
        ys, _ = sim.array_engine().run_raw(trains, learned=warm)
        keys = [k for k in ys if k.startswith(("fired", "writes"))]
        out.append((_host_ys(ys, keys), [ys.get(f"learned_idx_{li}")
                                         for li in range(len(sim.weights))]))
    return tuple(out)


def plasticity_path(arch, ctx: dict, smi: str) -> dict:
    """Phase 8: phase 4's network (its quantized weights, mapping and
    trains) learning on the card, through `ChipSimulator(plasticity=)`,
    and the interpretive engine."""
    import torch

    from repro_torch import ChipSimulator, PlasticityConfig
    from repro_torch.kernels import fused_timestep as FT
    from repro_torch.telemetry import TraceConfig

    healthy, qws, trains = ctx["sim"], ctx["qws"], ctx["trains"]
    dev = healthy.device
    B, T, L = int(trains.shape[0]), int(trains.shape[1]), len(qws)
    kw = dict(freq_hz=arch.freq_hz, threshold=arch.threshold,
              leak=arch.leak, mapping=healthy.mapping, device=dev)
    codebook_only = {"fused_timestep_codebook": 0, "fused_timestep_dense": 0}
    perf: dict = {}

    # (a) STDP on layers 1 and 2, both engines
    stdp = PlasticityConfig(enabled=True, mode="stdp", layers=STDP_LAYERS)
    fa = ChipSimulator(qws, engine="fused", plasticity=stdp, **kw)
    ca = ChipSimulator(qws, engine="compiled", plasticity=stdp, **kw)
    frozen_a = [li for li in range(L) if li not in STDP_LAYERS]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    FT.reset_launches()
    counts, reports = fa.run_batch(trains)
    torch.cuda.synchronize()
    launches = _expect_launches("STDP fused run", {
        **codebook_only, "fused_timestep_codebook": T * len(frozen_a)})
    perf["stdp_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    perf["stdp_peak_over_resident_gb"] = (torch.cuda.max_memory_allocated()
                                          - base) / 1e9
    counts_np = counts.cpu().numpy()
    writes = np.array([r.stats.weight_writes for r in reports])
    if counts_np.shape != (B, arch.layer_sizes[-1]) \
            or not np.isfinite(counts_np).all() or writes.min() <= 0 \
            or not np.isfinite([r.energy_pj for r in reports]).all():
        raise AssertionError(f"STDP fused run: bad outputs {counts_np.shape}"
                             f", writes {writes.min()}")
    (ys_f, lf), (ys_c, lc) = _plastic_runs(fa, ca, trains)
    per_layer = ys_f["writes"].sum(axis=(0, 1))
    if (per_layer[list(STDP_LAYERS)] <= 0).any():
        raise AssertionError(f"STDP: writes per layer {per_layer.tolist()}")
    log(f"STDP (layers {STDP_LAYERS}): {launches}, writes per layer "
        f"{per_layer.tolist()}, write pJ per sample "
        f"{np.mean([r.write_energy_pj for r in reports]):.1f}, peak device "
        f"memory {perf['stdp_peak_gb']:.3f} GB "
        f"({perf['stdp_peak_over_resident_gb']:.3f} GB over the resident "
        f"{base / 1e9:.3f} GB)")
    if not np.array_equal(writes, ys_f["writes"].sum(axis=(1, 2))):
        raise AssertionError("STDP: reports' writes differ from run_raw's")
    perf["stdp_same_samples"] = _hold_plastic(
        "STDP fused", (ys_f, lf), (ys_c, lc), frozen_a, STDP_LAYERS)

    # (b) R-STDP on the readout: run, commit, warm-started run
    rstdp = PlasticityConfig(enabled=True, mode="reward", layers=(READOUT,),
                             **RSTDP)
    fb = ChipSimulator(qws, engine="fused", plasticity=rstdp, **kw)
    cb = ChipSimulator(qws, engine="compiled", plasticity=rstdp, **kw)
    frozen_b = [li for li in range(L) if li != READOUT]
    want_b = {**codebook_only, "fused_timestep_codebook": T * len(frozen_b)}
    (ys_f, lf), (ys_c, lc) = _plastic_runs(fb, cb, trains)
    same = _hold_plastic("R-STDP fused", (ys_f, lf), (ys_c, lc), frozen_b,
                         (READOUT,))
    FT.reset_launches()
    counts, _ = fb.run_batch(trains)
    torch.cuda.synchronize()
    launches_b = _expect_launches("R-STDP fused run", want_b)
    ccounts, _ = cb.run_batch(trains)
    labels = np.random.default_rng(7).integers(0, arch.layer_sizes[-1], B)
    eye = np.eye(arch.layer_sizes[-1], dtype=np.float32)
    infos = []
    for sim, c in ((fb, counts), (cb, ccounts)):
        pred = c.argmax(-1).cpu().numpy()
        infos.append(sim.apply_reward(eye[labels] - eye[pred]))
    rows = _frozen_rows(ys_f, ys_c, frozen_b)
    for key in ("weight_writes", "write_energy_pj", "write_cycles"):
        g, w = infos[0][key], infos[1][key]
        if not np.array_equal(g[rows], w[rows]):
            raise AssertionError(f"R-STDP commit: {key} differs in a "
                                 f"sample with equal frozen layers")
    if infos[1]["weight_writes"].sum() <= 0:
        raise AssertionError("R-STDP commit wrote nothing")
    rel = (abs(infos[0]["weight_writes"].sum()
               - infos[1]["weight_writes"].sum())
           / infos[1]["weight_writes"].sum())
    if rel > SPIKE_REL_TOL:
        raise AssertionError(f"R-STDP commit: write totals differ by {rel}")
    if not _rows_equal(fb.last_learned[READOUT], cb.last_learned[READOUT],
                       rows):
        raise AssertionError("R-STDP commit: learned indexes differ in a "
                             "sample with equal frozen layers")
    log(f"R-STDP commit (per-neuron reward one_hot(target) - one_hot(pred)): "
        f"writes {infos[0]['weight_writes'].sum():.0f} against compiled "
        f"{infos[1]['weight_writes'].sum():.0f}, write pJ "
        f"{infos[0]['write_energy_pj'].sum():.2f}, cycles "
        f"{infos[0]['write_cycles'].sum():.0f}; equal in all {len(rows)} "
        f"samples with equal frozen layers")
    warm = [fb.last_learned, cb.last_learned]
    FT.reset_launches()
    fb.run_batch(trains, learned=warm[0])
    torch.cuda.synchronize()
    launches_w = _expect_launches("warm R-STDP fused run", want_b)
    (ys_f, lf), (ys_c, lc) = _plastic_runs(fb, cb, trains, learned=warm)
    _hold_plastic("R-STDP warm fused", (ys_f, lf), (ys_c, lc), frozen_b,
                  (READOUT,))
    perf["rstdp_same_samples"] = same

    # (c) the interpretive engine at ARCH, against the compiled engine on
    # the same samples (a sample at a time)
    few = trains[:REF_BATCH]
    FT.reset_launches()
    ref = ChipSimulator(qws, engine="reference", **kw)
    t0 = time.perf_counter()
    rcounts, rreps = ref.run_batch(few)
    torch.cuda.synchronize()
    perf["reference_healthy_ms_per_sample"] = (
        (time.perf_counter() - t0) * 1e3 / REF_BATCH)
    hcounts, hreps = healthy.compiled_engine().run_batch(few)
    _hold_totals("reference engine, healthy", rcounts, rreps, hcounts,
                 hreps)
    rp = ChipSimulator(qws, engine="reference", plasticity=stdp,
                       trace=TraceConfig(enabled=True), **kw)
    t0 = time.perf_counter()
    _, preps = rp.run_batch(few)
    torch.cuda.synchronize()
    perf["reference_stdp_traced_ms_per_sample"] = (
        (time.perf_counter() - t0) * 1e3 / REF_BATCH)
    _expect_launches("reference engine", codebook_only)
    trace = rp.last_trace()
    tw = trace.weight_writes.sum(axis=(1, 2))
    if not np.array_equal(tw, [r.stats.weight_writes for r in preps]) \
            or tw.min() <= 0:
        raise AssertionError(f"reference engine: trace writes {tw} against "
                             f"the reports'")
    cp = ChipSimulator(qws, engine="compiled", plasticity=stdp,
                       trace=TraceConfig(enabled=True), **kw)
    per = [cp.compiled_engine().run_raw(few[b:b + 1])[0]
           for b in range(REF_BATCH)]
    keys = [k for k in per[0] if k.startswith(("fired", "writes"))]
    ys_c = {k: np.concatenate([_host_ys(p, [k])[k] for p in per])
            for k in keys}
    lc = [None if per[0].get(f"learned_idx_{li}") is None else torch.cat(
        [p[f"learned_idx_{li}"] for p in per]) for li in range(L)]
    perf["reference_same_samples"] = _hold_plastic(
        "reference engine, STDP traced", (_trace_ys(trace), rp.last_learned),
        (ys_c, lc), frozen_a, STDP_LAYERS)
    log(f"reference engine: 0 kernel launches, trace writes per sample "
        f"{tw.tolist()} equal to the reports'")

    # (d) times, beside the healthy phase 4 run in this call; the
    # interpretive engine's warm, on one sample
    for name, sim, x in (("stdp", fa, trains), ("rstdp", fb, trains),
                         ("healthy", healthy, trains),
                         ("reference_stdp_traced_one_sample", rp, few[:1])):
        ms = _timed_ms(lambda: sim.run_batch(x))
        perf[f"{name}_ms_per_run"] = ms
        got = _device_breakdown(lambda: sim.run_batch(x), ms)
        perf.update({f"{name}_{k}": v for k, v in got.items()})
    log(f"plasticity path timing (median of 5; {smi}): {json.dumps(perf)}")
    return {"launches": {"fused_timestep_codebook":
                         launches["fused_timestep_codebook"]
                         + launches_b["fused_timestep_codebook"]
                         + launches_w["fused_timestep_codebook"],
                         "fused_timestep_dense": 0},
            "perf": perf}


def _hold_totals(what, counts, reports, want_counts, want_reports) -> None:
    """Output spike totals and each sample's input spikes (all layers)
    and pJ/SOP within phase 4's rule of the compiled engine's."""
    g = float(counts.sum())
    w = float(want_counts.sum())
    rel = abs(g - w) / max(w, 1.0)
    sp = np.array([r.stats.spikes_in for r in reports])
    wsp = np.array([r.stats.spikes_in for r in want_reports])
    srel = (np.abs(sp - wsp) / np.maximum(wsp, 1.0)).max()
    pj = np.array([r.pj_per_sop for r in reports])
    wpj = np.array([r.pj_per_sop for r in want_reports])
    prel = (np.abs(pj - wpj) / wpj).max()
    log(f"{what}: output spikes {g:.0f} against compiled {w:.0f}, input "
        f"spikes per sample {sp.tolist()} against {wsp.tolist()}, pJ/SOP "
        f"max rel {prel:.3g}")
    if rel > SPIKE_REL_TOL or srel > SPIKE_REL_TOL or prel > PJ_REL_TOL:
        raise AssertionError(f"{what}: differs from the compiled engine "
                             f"({rel:.3g}, {srel:.3g}, {prel:.3g})")


# ---------------------------------------------------------------------------
# phase 9: SNN serving at full width
# ---------------------------------------------------------------------------

SERVE_SLOTS = 32
SERVE_REQUESTS = 80            # 3 slot groups, the last 16 real + 16 padded
SERVE_DEADLINE_MS = 6e4        # every 4th request; never expires here
TENANT_REQUESTS = 12           # per tenant in (b), interleaved
RESILIENT_REQUESTS = 8         # in each of (c)'s two runs


def _serve_trains(arch, seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random((n, arch.timesteps, arch.layer_sizes[0]))
            < TIME_DENSITY).astype(np.float32)


def _groups(done) -> list:
    """Served requests as their slot groups (one `t_dequeue` each), each
    in slot order: the order `admission.form_group` took them in."""
    by = {}
    for r in done:
        by.setdefault(r.t_dequeue, []).append(r)
    key = (lambda r: (r.deadline if r.deadline is not None else np.inf,
                      r.t_enqueue))
    return [sorted(g, key=key) for _, g in sorted(by.items())]


def _padded(group, slots: int) -> np.ndarray:
    batch = np.zeros((slots,) + group[0].events.shape, np.float32)
    for i, r in enumerate(group):
        batch[i] = r.events
    return batch


def _hold_rows(what: str, sim, groups, slots: int) -> None:
    """Each request of each group equal to its row of the same padded
    batch through `sim.run_batch`: counts, prediction, energy, pJ/SOP."""
    import torch

    for group in groups:
        counts, reports = sim.run_batch(torch.as_tensor(
            _padded(group, slots), device=sim.device))
        counts = counts.cpu().numpy()
        for i, r in enumerate(group):
            if not (np.array_equal(r.spike_counts, counts[i])
                    and r.prediction == int(counts[i].argmax())
                    and r.energy_pj == reports[i].energy_pj
                    and r.pj_per_sop == reports[i].pj_per_sop):
                raise AssertionError(f"{what}: request {r.uid} differs from "
                                     f"row {i} of its padded batch")


def _dma_reckoned(arch, sim, n_req: int) -> dict:
    """HostDmaModel's default prices reckoned here in numpy: 3.2 pJ per
    32-bit word, a header word per 64, 120 setup cycles."""
    def transfer(words):
        total = words + -(-words // 64)
        return total * 3.2, 120.0 + total

    chip_words = math.ceil(arch.layer_sizes[0] / 16)   # 16 spikes a word
    words_up = arch.timesteps * math.ceil(chip_words / 2)
    per_req = transfer(words_up)[0] + transfer(arch.layer_sizes[-1])[0]
    nbytes = sum((t.weight_levels * t.weight_bits + 7) // 8 + 20
                 for t in sim.register_tables)
    swap_pj, swap_cycles = transfer(-(-nbytes // 4))
    return {"dma_pj": n_req * per_req, "model_swaps": 1.0,
            "swap_pj": swap_pj, "swap_cycles": swap_cycles}


def _launched(what: str, fn) -> int:
    """Codebook-timestep launches of `fn()` (counts zeroed before, read
    after; no dense launch allowed)."""
    import torch

    from repro_torch.kernels import fused_timestep as FT

    FT.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = dict(FT.launches)
    if got["fused_timestep_dense"]:
        raise AssertionError(f"{what}: dense launches {got}")
    return got["fused_timestep_codebook"], out


def serving_snn_path(arch, ctx: dict, repaired, mp_perf: dict, seed: int,
                     smi: str) -> dict:
    """Phase 9: `SnnServer` on ARCH simulators built from phase 4's
    quantized weights."""
    import torch

    from repro_torch import ChipSimulator
    from repro_torch.core import noc as NOC
    from repro_torch.core.soc import HostDmaModel, remap_mapping_cores
    from repro_torch.faults import FaultConfig
    from repro_torch.serve import SnnRequest, SnnServer
    from repro_torch.serve.resilience import RetryPolicy

    qws, dev = ctx["qws"], ctx["sim"].device
    kw = dict(freq_hz=arch.freq_hz, threshold=arch.threshold,
              leak=arch.leak, device=dev)
    T, L = arch.timesteps, len(qws)
    launches = {}

    # (a) one tenant, greedy-mapped: 80 requests, 3 slot groups
    sim = ChipSimulator(qws, engine="fused", mapping_strategy="greedy", **kw)
    cores = sorted(sim.mapping.active_core_ids())
    if cores != [12, 13, 14]:
        raise AssertionError(f"greedy ARCH mapping on cores {cores}")
    sim.fused_engine()                         # lowered before serving
    trains = _serve_trains(arch, seed + 3, SERVE_REQUESTS)
    srv = SnnServer(sim, batch_slots=SERVE_SLOTS)

    def serve():
        t0 = time.perf_counter()
        reqs = [srv.submit(SnnRequest(
            uid=i, events=ev, deadline_ms=SERVE_DEADLINE_MS
            if i % 4 == 0 else None)) for i, ev in enumerate(trains)]
        done = srv.run()
        torch.cuda.synchronize()
        return reqs, done, time.perf_counter() - t0

    n, (reqs, done, wall_s) = _launched("served ARCH", serve)
    launches["a"] = n
    want = -(-SERVE_REQUESTS // SERVE_SLOTS) * T * L
    if n != want:
        raise AssertionError(f"served ARCH: {n} codebook launches, "
                             f"expected {want}")
    if sorted(r.uid for r in done) != list(range(SERVE_REQUESTS)) \
            or any(r.status != "served" for r in reqs):
        raise AssertionError("served ARCH: not every request served")
    groups = _groups(done)
    sizes = [len(g) for g in groups]
    if sizes != [32, 32, 16]:
        raise AssertionError(f"served ARCH: groups of {sizes}")
    _hold_rows("served ARCH", sim, groups, SERVE_SLOTS)
    _, [pad] = sim.run_batch(torch.zeros((1, T, arch.layer_sizes[0]),
                                         device=dev))
    if any(r.energy_pj == pad.energy_pj for r in done):
        raise AssertionError("served ARCH: a request carries a padded "
                             "slot's report")
    hs = srv.host_summary()
    reckoned = _dma_reckoned(arch, sim, SERVE_REQUESTS)
    if any(abs(hs[k] - v) > 1e-9 * max(abs(v), 1.0)
           for k, v in reckoned.items()) or any(
               abs(r.dma_pj - reckoned["dma_pj"] / SERVE_REQUESTS) > 1e-9
               for r in done):
        raise AssertionError(f"served ARCH: host summary {hs} against "
                             f"{reckoned}")
    lat = srv.metrics.get("snn_request_latency_ms")
    perf = {"requests_per_s": SERVE_REQUESTS / wall_s,
            "serve_wall_ms": wall_s * 1e3,
            "ms_per_group": wall_s * 1e3 / len(groups),
            "latency_p50_ms": lat.percentile(0.5),
            "latency_p99_ms": lat.percentile(0.99),
            "phase4_ms_per_run": mp_perf["ms_per_run"]}
    log(f"served ARCH: {SERVE_REQUESTS} requests in groups {sizes}, {n} "
        f"codebook launches, every request equal to its padded batch row, "
        f"host summary {json.dumps(hs)} equal to HostDmaModel reckoned in "
        f"numpy")

    # (b) tenancy: a second network on 3 disjoint cores, then a third on
    # the anneal mapping (all 20 cores) that evicts both
    qws_b = _arch_quantized(arch, seed + 2)
    base_b = ChipSimulator(qws_b, engine="fused", mapping_strategy="greedy",
                           **kw)
    pool = [int(c) for c in NOC.core_ids() if int(c) not in cores]
    sim_b = ChipSimulator(qws_b, engine="fused", mapping=remap_mapping_cores(
        base_b.mapping, pool[-3:]), **kw)
    sim_c = ctx["sim"]
    for s in (sim_b, sim_c):
        s.fused_engine()
    dma = HostDmaModel()
    multi = SnnServer(sim, batch_slots=SERVE_SLOTS, dma=dma)
    multi.add_model("b", sim_b)
    if multi.tenants["default"].core_ids & multi.tenants["b"].core_ids:
        raise AssertionError("tenancy: the remapped cores overlap")
    mixed = _serve_trains(arch, seed + 4, 2 * TENANT_REQUESTS)

    def interleave():
        for i, ev in enumerate(mixed):
            multi.submit(SnnRequest(uid=i, events=ev,
                                    model="b" if i % 2 else "default"))
        return {r.uid: r for r in multi.run()}

    nb, served = _launched("tenancy", interleave)
    solo = {}
    for name, s in (("default", sim), ("b", sim_b)):
        one = SnnServer(s, batch_slots=SERVE_SLOTS)
        for i, ev in enumerate(mixed):
            if (i % 2 == 1) == (name == "b"):
                one.submit(SnnRequest(uid=i, events=ev))
        solo.update({r.uid: r for r in one.run()})
    for uid, r in served.items():
        if not (np.array_equal(r.spike_counts, solo[uid].spike_counts)
                and r.energy_pj == solo[uid].energy_pj):
            raise AssertionError(f"tenancy: request {uid} differs from the "
                                 f"solo server's")
    if multi.host_summary()["model_swaps"] != 2:
        raise AssertionError(f"tenancy: {multi.host_summary()} swaps")
    tc = multi.add_model("c", sim_c)
    if not (tc.core_ids & multi.tenants["default"].core_ids
            and tc.core_ids & multi.tenants["b"].core_ids):
        raise AssertionError("tenancy: the anneal tenant overlaps neither")
    order = ["c", "default", "b"]

    def evict():
        for i, name in enumerate(order):
            multi.submit(SnnRequest(uid=100 + i, events=mixed[i],
                                    model=name))
            multi.step()

    nc, _ = _launched("eviction", evict)
    launches["b"] = nb + nc
    prices = {name: dma.table_load(t.sim.register_tables)[0]
              for name, t in multi.tenants.items()}
    want_pj = prices["default"] * 2 + prices["b"] * 2 + prices["c"]
    hs = multi.host_summary()
    if hs["model_swaps"] != 5 or abs(hs["swap_pj"] - want_pj) > 1e-9 * want_pj:
        raise AssertionError(f"eviction: {hs} against 5 swaps, {want_pj} pJ")
    cores_b = sorted(sim_b.mapping.active_core_ids())
    log(f"tenancy: {2 * TENANT_REQUESTS} interleaved requests equal to two "
        f"solo servers', cores {cores} and {cores_b}, 2 swaps; tenant c on {len(tc.core_ids)} cores evicted both: 5 "
        f"swaps, {hs['swap_pj']:.1f} pJ = table_load of each load "
        f"({json.dumps(prices)})")

    # (c) resilience: a transient fault retried; a primary that always
    # times out, served by phase 7 (b)'s repaired chip
    few = _serve_trains(arch, seed + 5, RESILIENT_REQUESTS)
    flaky = ChipSimulator(qws, engine="fused", mapping=sim.mapping,
                          faults=FaultConfig(transient_dispatches=(0,)), **kw)
    rsrv = SnnServer(flaky, batch_slots=SERVE_SLOTS, sleep=lambda s: None)
    healthy = SnnServer(sim, batch_slots=SERVE_SLOTS)
    for i, ev in enumerate(few):
        rsrv.submit(SnnRequest(uid=i, events=ev))
        healthy.submit(SnnRequest(uid=i, events=ev))
    n1, got = _launched("retried", rsrv.run)
    want = healthy.run()
    if (rsrv._m_faults.value, rsrv._m_retries.value) != (1, 1) or any(
            not np.array_equal(g.spike_counts, w.spike_counts)
            or g.energy_pj != w.energy_pj or g.degraded
            for g, w in zip(got, want)):
        raise AssertionError("retried: not the healthy server's results, "
                             "or not one fault and one retry")
    dsrv = SnnServer(None, batch_slots=SERVE_SLOTS, dispatch_timeout_s=0.0,
                     retry=RetryPolicy(max_retries=1, base_delay_s=0.0),
                     breaker_threshold=1, sleep=lambda s: None)
    dsrv.add_model("default", sim, degraded_sim=repaired)
    dreqs = [dsrv.submit(SnnRequest(uid=i, events=ev))
             for i, ev in enumerate(few)]
    n2, _ = _launched("degraded", dsrv.run)
    launches["c"] = n1 + n2
    _hold_rows("degraded", repaired, [dreqs], SERVE_SLOTS)
    if not all(r.degraded for r in dreqs) or \
            dsrv.breakers["default"].state != "open" or \
            (dsrv._m_faults.value, dsrv._m_retries.value,
             dsrv._m_degraded.value) != (2, 1, RESILIENT_REQUESTS):
        raise AssertionError("degraded: not served through the repaired chip")
    log(f"resilience: a transient fault raised once and was retried "
        f"(snn_faults_injected 1, snn_retries 1), results equal to the "
        f"healthy server's; a primary over its 0 s budget: 2 timeouts, 1 "
        f"retry, breaker open, {RESILIENT_REQUESTS} requests degraded=True, "
        f"each equal to its row of the repaired chip's run_batch")

    # (d) times: one full slot group alone, then the same profiled
    def one_group():
        for i, ev in enumerate(trains[:SERVE_SLOTS]):
            srv.submit(SnnRequest(uid=1000 + i, events=ev))
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    perf["group_ms"] = statistics.median(one_group() for _ in range(5))
    for i, ev in enumerate(trains[:SERVE_SLOTS]):
        srv.submit(SnnRequest(uid=2000 + i, events=ev))
    perf.update(_device_breakdown(srv.step, perf["group_ms"]))
    log(f"SNN serving timing ({smi}): {json.dumps(perf)}")
    return {"launches": {"fused_timestep_codebook": sum(launches.values()),
                         "fused_timestep_dense": 0},
            "by_part": launches, "perf": perf}


# ---------------------------------------------------------------------------
# phase 10: SNN training at ARCH widths
# ---------------------------------------------------------------------------

TRAIN_STEPS = 5
TRAIN_BATCH = 32
TRAIN_GRAD_REL = 1e-2          # card vs CPU global gradient norm, step 0
TRAIN_RESUME_ATOL = 3e-3       # resumed vs uninterrupted params: under one
                               # AdamW step of lr 2e-3 per element


def training_path(arch, seed: int, smi: str) -> dict:
    """Phase 10: `SNNTrainer` at the paper's widths on the card."""
    import tempfile

    import torch

    from repro_torch.data.synthetic import EventStream
    from repro_torch.models import snn as SNN
    from repro_torch.optim import adamw
    from repro_torch.train.snn_trainer import (HWLossConfig, SNNTrainConfig,
                                               SNNTrainer, train_step)

    ev = EventStream(height=34, width=34, timesteps=arch.timesteps,
                     seed=seed)
    if ev.n_inputs != arch.layer_sizes[0]:
        raise AssertionError(f"EventStream gives {ev.n_inputs} inputs")
    cfg = SNN.SNNConfig(layer_sizes=tuple(arch.layer_sizes),
                        timesteps=arch.timesteps, qat=True)
    hw = HWLossConfig(rate_weight=1.0, target_rate=0.08, l1_weight=1e-3)

    def trainer(d, device=DEVICE):
        return SNNTrainer(cfg, SNNTrainConfig(
            steps=TRAIN_STEPS, batch=TRAIN_BATCH, hw=hw, ckpt_dir=d,
            save_every=2), device=device)

    def batches(stop=None):
        def fn(step):
            if step == stop:
                raise KeyboardInterrupt(f"stopped at step {step}")
            return ev.batch(TRAIN_BATCH, step, device=DEVICE)
        return fn

    gen = (lambda: torch.Generator().manual_seed(seed))
    p0 = [p.clone() for p in trainer(None).init(gen())[0]]
    rows, step_ms = [], []
    last = [time.perf_counter()]

    def on_metrics(step, row):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - last[0]) * 1e3)
        last[0] = now
        rows.append(row)

    with tempfile.TemporaryDirectory() as d:
        torch.cuda.reset_peak_memory_stats()
        last[0] = time.perf_counter()
        whole, hist = trainer(str(Path(d) / "a")).fit(
            batches(), gen(), on_metrics)
        peak = torch.cuda.max_memory_allocated()
        for r in hist:
            if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
                raise AssertionError(f"training: step {r['step']} {r}")
        moved = max(float((a - b).abs().max()) for a, b in zip(whole, p0))
        if not moved > 0:
            raise AssertionError("training: the parameters did not move")
        log(f"training: {TRAIN_STEPS} steps at {list(arch.layer_sizes)}, "
            f"losses {[round(r['loss'], 6) for r in hist]}, gradient norms "
            f"{[round(r['grad_norm'], 6) for r in hist]}, max |param "
            f"change| {moved:.4g}")

        # step 0 on the card against the port on the CPU, same params
        # and batch
        s, l = ev.batch(TRAIN_BATCH, 0, device="cpu")
        out = {}
        for device in (DEVICE, "cpu"):
            tr = trainer(None, device)
            params = [p.to(device) for p in p0]
            st, lt = s.to(device), l.to(device)
            with torch.no_grad():
                _, stats = SNN.forward(params, cfg, st)
            _, _, m = train_step(params, adamw.init(params), cfg, hw,
                                 tr.opt_cfg, st, lt)
            out[device] = ({k: float(v) for k, v in m.items()},
                           (stats["rates"] * TRAIN_BATCH * arch.timesteps
                            * torch.tensor(arch.layer_sizes[1:],
                                           device=device)).tolist())
        (mg, sg), (mc, sc) = out[DEVICE], out["cpu"]
        rel = {"loss": abs(mg["loss"] - mc["loss"]) / abs(mc["loss"]),
               "spikes": max(abs(a - b) / max(b, 1.0)
                             for a, b in zip(sg, sc)),
               "grad_norm": abs(mg["grad_norm"] - mc["grad_norm"])
               / mc["grad_norm"]}
        log(f"training step 0, card against CPU: loss {mg['loss']} / "
            f"{mc['loss']}, spikes per layer {sg} / {sc}, gradient norm "
            f"{mg['grad_norm']} / {mc['grad_norm']} (rel {json.dumps(rel)})")
        if rel["loss"] > SPIKE_REL_TOL or rel["spikes"] > SPIKE_REL_TOL \
                or rel["grad_norm"] > TRAIN_GRAD_REL:
            raise AssertionError(f"training step 0: card and CPU differ "
                                 f"{rel}")

        # a fit stopped after step 2, resumed from its checkpoint
        b = str(Path(d) / "b")
        try:
            trainer(b).fit(batches(stop=2), gen())
        except KeyboardInterrupt:
            pass
        else:
            raise AssertionError("training: the stopped fit did not stop")
        if trainer(b).ckpt.latest_step() != 2:
            raise AssertionError("training: no checkpoint at step 2")
        resumed, rhist = trainer(b).fit(batches(), gen())
        if [r["step"] for r in rhist] != list(range(2, TRAIN_STEPS)):
            raise AssertionError(f"training: resumed at {rhist[:1]}")
        diff = max(float((a - b).abs().max())
                   for a, b in zip(resumed, whole))
        log(f"training: resumed from step 2, max |param diff| against the "
            f"uninterrupted fit {diff:.4g} (tolerance {TRAIN_RESUME_ATOL})")
        if diff > TRAIN_RESUME_ATOL:
            raise AssertionError(f"training: resumed params differ by {diff}")

    # times: a step at its steady state, profiled
    tr = trainer(None)
    params, opt = tr.init(gen())
    st, lt = ev.batch(TRAIN_BATCH, 0, device=DEVICE)
    ms = _timed_ms(lambda: tr.step(params, opt, st, lt), reps=3)
    perf = {"ms_per_step": ms, "fit_step_ms": step_ms,
            "peak_memory_gb": peak / 1e9, "resume_max_diff": diff,
            "card_vs_cpu_rel": rel}
    perf.update(_device_breakdown(lambda: tr.step(params, opt, st, lt), ms,
                                  sums=(("gemm_ms", "gemm"),)))
    log(f"SNN training timing ({smi}): {json.dumps(perf)}")
    return {"perf": perf}


# ---------------------------------------------------------------------------
# phase 11: the train -> deploy pipeline and continual adaptation
# ---------------------------------------------------------------------------

DEPLOY_STEPS = 5               # (a): training steps, phase 10's loss
DEPLOY_BATCH = 32
DEPLOY_LAUNCHES = 420          # (a): 7 runs x T 20 x 3 layers: 4 eval
                               # chunks (256 / 64), the traced profile
                               # batch, 2 serving groups (16 requests, 8
                               # slots)
ADAPT_LAUNCHES = 786           # (d): (3 evals + 128 trials) x T 6, layer 0
ACC_CHIP_SLACK = 2             # (b): eval samples of 256 fused and compiled
                               # may differ by: threshold ties between an
                               # f64 k-order sum and a matmul
# aten ops that may read a host tensor on the card's path: copies between
# the host and the card, and reading a device scalar
HOST_COPY_OPS = ("aten._to_copy.", "aten.copy_.", "aten.lift_fresh",
                 "aten.detach.", "aten.alias.", "aten._local_scalar_dense.")
# deploy()'s spans, `deploy.<stage>` (repro_torch/deploy/pipeline.py)
DEPLOY_STAGES = ("train", "accuracy", "compile", "ptq", "build_sim",
                 "chip_eval", "profile", "serving_smoke")


def _host_compute():
    """A dispatch mode that counts, by name, the aten ops that read a host
    tensor of one dimension or more (a 0-d host tensor is a wrapped
    scalar), copies to and from the card excepted; `paused` while
    `models/snn.py` `init_params` draws on the CPU by design (a seed gives
    the same weights on every device)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class HostCompute(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops: dict = {}
            self.paused = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            if not self.paused and not name.startswith(HOST_COPY_OPS) and any(
                    isinstance(a, torch.Tensor) and a.device.type == "cpu"
                    and a.dim() > 0
                    for a in tree_leaves((args, kwargs or {}))):
                self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    return HostCompute()


def _stage_seconds(fn) -> tuple:
    """(fn's result, seconds per stage) of one `deploy()` call, read from
    the `deploy.*` and `soc.lower` spans that the pipeline and the
    simulator mark (host clock; a stage that reads a value back ends in
    a sync).  A simulator build's seconds hold the lowering that its
    first run does, taken out of that run's stage."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    # the exported trace, not `prof.events()`: at ARCH the events' Python
    # objects take about a minute to build, the export and parse seconds
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "deploy_trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans: dict = {}
    for e in sorted((e for e in events if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"]):
        if e["name"].startswith("deploy.") or e["name"] == "soc.lower":
            spans.setdefault(e["name"], []).append(e["dur"] / 1e6)
    s = {name: spans.get(f"deploy.{name}", []) for name in DEPLOY_STAGES}
    builds, lowers = s["build_sim"], spans.get("soc.lower", [])
    if len(builds) != 2 or len(lowers) != 2:
        raise AssertionError(f"phase 11: {len(builds)} simulator builds and "
                             f"{len(lowers)} lowerings in one deploy()")
    top = sum(sum(s[k]) for k in DEPLOY_STAGES if k != "build_sim") + builds[0]
    return out, {"total_s": total, "train_s": sum(s["train"]),
                 "accuracy_s": sum(s["accuracy"]),
                 "compile_s": sum(s["compile"]), "ptq_s": sum(s["ptq"]),
                 "sim_build_s": [b + l for b, l in zip(builds, lowers)],
                 "chip_eval_s": sum(s["chip_eval"]) - lowers[0],
                 "profile_s": sum(s["profile"]) - builds[1] - lowers[1],
                 "serving_smoke_s": sum(s["serving_smoke"]),
                 "rest_s": total - top}


def _check_report(what: str, rep) -> dict:
    """A finite DeployReport of plain Python values whose `save()` loads
    back equal."""
    import tempfile

    doc = rep.to_dict()
    bad = []

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        elif x is not None and type(x) not in (bool, int, float, str) or (
                type(x) is float and not math.isfinite(x)):
            bad.append((path, repr(x)[:60]))

    walk(doc, "")
    if bad:
        raise AssertionError(f"phase 11 {what}: report fields {bad}")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "report.json"
        rep.save(str(path))
        back = json.loads(path.read_text())
    if back != json.loads(json.dumps(doc, allow_nan=False)):
        raise AssertionError(f"phase 11 {what}: save() does not load back")
    if rep.passed != rep.gates["passed"]:
        raise AssertionError(f"phase 11 {what}: passed {rep.passed}")
    return doc


def deploy_path(arch, seed: int, smi: str) -> dict:
    """Phase 11: `deploy()` at the paper's widths on the fused engine, held
    to the compiled engine, its PTQ on the card held to the CPU's, and
    `continual_adaptation` at its defaults, fused against compiled."""
    import dataclasses
    from unittest import mock

    import torch

    from repro_torch import compiler as COMP
    from repro_torch.core.soc import ChipSimulator
    from repro_torch.data.synthetic import EventStream
    from repro_torch.deploy import (AdaptConfig, DeployConfig,
                                    continual_adaptation, deploy,
                                    fit_per_core_codebooks)
    from repro_torch.models import snn as SNN
    from repro_torch.train.snn_trainer import (HWLossConfig, SNNTrainConfig,
                                               SNNTrainer)

    ev = EventStream(height=34, width=34, timesteps=arch.timesteps,
                     seed=seed)
    cfg = SNN.SNNConfig(layer_sizes=tuple(arch.layer_sizes),
                        timesteps=arch.timesteps, qat=True)
    hw = HWLossConfig(rate_weight=1.0, target_rate=0.08, l1_weight=1e-3)
    tcfg = SNNTrainConfig(steps=DEPLOY_STEPS, batch=DEPLOY_BATCH, hw=hw)
    dcfg = DeployConfig(train=tcfg)

    # (a) deploy() trains, compiles, quantizes per core, runs the chip
    host = _host_compute()
    init = SNN.init_params

    def paused_init(*a, **kw):
        host.paused = True
        try:
            return init(*a, **kw)
        finally:
            host.paused = False

    t0 = time.perf_counter()
    with mock.patch.object(SNN, "init_params", paused_init), host:
        launches, rep_a = _launched(
            "phase 11 (a)", lambda: deploy(cfg, ev, dcfg, device=DEVICE))
    a_s = time.perf_counter() - t0
    if launches != DEPLOY_LAUNCHES:
        raise AssertionError(f"phase 11 (a): {launches} codebook launches, "
                             f"expected {DEPLOY_LAUNCHES}")
    if host.ops:
        raise AssertionError(f"phase 11 (a): host compute on the deploy "
                             f"path: {host.ops}")
    doc_a = _check_report("(a)", rep_a)
    if not isinstance(rep_a.final_loss, float):
        raise AssertionError(f"phase 11 (a): final loss {rep_a.final_loss}")
    log(f"deploy (a): {launches} codebook launches, no host compute, "
        f"{a_s:.1f} s (op check on); gates {json.dumps(rep_a.gates)}; "
        f"acc train / dequant / chip {rep_a.acc_train} / "
        f"{rep_a.acc_dequant} / {rep_a.acc_chip}, pJ/SOP "
        f"{rep_a.pj_per_sop}, {rep_a.n_cores} cores, rms "
        f"{rep_a.quant_rms_error}, serving "
        f"{json.dumps(doc_a['serving_slo'])}")

    # (b) the same parameters deployed fused and compiled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _ = SNNTrainer(cfg, tcfg, device=DEVICE).fit(
        lambda step: ev.batch(DEPLOY_BATCH, step, device=DEVICE))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    reps, clocks = {}, {}
    for engine in ("fused", "compiled"):
        reps[engine], clocks[engine] = _stage_seconds(lambda: deploy(
            cfg, ev, dataclasses.replace(dcfg, engine=engine),
            params=params, device=DEVICE))
        _check_report(f"(b) {engine}", reps[engine])
    # the profiler's own cost: the fused deploy once more, unprofiled
    t0 = time.perf_counter()
    deploy(cfg, ev, dcfg, params=params, device=DEVICE)
    torch.cuda.synchronize()
    clocks["fused"]["unprofiled_total_s"] = time.perf_counter() - t0
    f, c = reps["fused"], reps["compiled"]
    for key in ("n_register_tables", "n_cores", "compile_summary",
                "acc_dequant", "acc_train"):
        if getattr(f, key) != getattr(c, key):
            raise AssertionError(f"phase 11 (b): {key} fused "
                                 f"{getattr(f, key)} compiled "
                                 f"{getattr(c, key)}")
    rel = {key: abs(getattr(f, key) - getattr(c, key))
           / max(abs(getattr(c, key)), 1e-300)
           for key in ("nominal_sops", "performed_sops", "pj_per_sop")}
    flips = round(abs(f.acc_chip - c.acc_chip) * f.eval_samples)
    log(f"deploy (b) fused / compiled: acc chip {f.acc_chip} / "
        f"{c.acc_chip} ({flips} of {f.eval_samples} apart), rel "
        f"{json.dumps(rel)}; (a)'s acc train equal: "
        f"{rep_a.acc_train == f.acc_train}")
    if max(rel.values()) > PJ_REL_TOL or flips > ACC_CHIP_SLACK:
        raise AssertionError(f"phase 11 (b): fused and compiled differ: "
                             f"{rel}, {flips} samples")

    # (c) per-core PTQ on the card against the CPU, on the deployed
    # mapping: the profile-guided compile that deploy() runs
    eval_sp, _ = ev.batch(dcfg.eval_batch, dcfg.eval_step, device=DEVICE)
    compiled = COMP.compile_network(COMP.from_weights(
        params, spike_rates=COMP.measure_spike_rates(params, eval_sp[0],
                                                     lif=cfg.lif)),
        strategy=dcfg.mapping_strategy)
    if compiled.summary() != f.compile_summary:
        raise AssertionError("phase 11 (c): the compile is not deploy()'s")
    mapping = compiled.to_soc_mapping()
    qcfg = dataclasses.replace(cfg.quant, zero_level=hw.l1_weight > 0.0)
    t0 = time.perf_counter()
    card = fit_per_core_codebooks(params, mapping, qcfg)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = fit_per_core_codebooks([p.cpu() for p in params], mapping, qcfg)
    cpu_s = time.perf_counter() - t0
    words = sum(a.codebook_words != b.codebook_words
                for a, b in zip(card.tables, cpu.tables))
    idx_diff = {str(k): int((card.slices[k].idx.cpu() != q.idx).sum())
                for k, q in cpu.slices.items()}
    # the fits are bitwise the CPU's (quant.py `_tree_colsum`): codebooks,
    # scales and the dequantized weights are held equal, not within ulps
    tables = sum(not (torch.equal(card.slices[k].codebook.cpu(), q.codebook)
                      and torch.equal(card.slices[k].scale.cpu(), q.scale))
                 for k, q in cpu.slices.items())
    weights = sum(not torch.equal(a.cpu(), b)
                  for a, b in zip(card.weights, cpu.weights))
    log(f"PTQ (c) card / CPU: {card.n_tables} tables, {words} differ in a "
        f"word, {sum(idx_diff.values())} of "
        f"{sum(q.idx.numel() for q in cpu.slices.values())} indexes "
        f"differ {json.dumps({k: v for k, v in idx_diff.items() if v})}, "
        f"{tables} codebooks or scales and {weights} dequantized layers "
        f"not bitwise equal; {card_s:.3f} s / {cpu_s:.1f} s")
    if words or any(idx_diff.values()) or tables or weights:
        raise AssertionError("phase 11 (c): PTQ on the card differs from "
                             "the CPU's")

    # (d) continual adaptation at its defaults, fused against compiled
    adapt, adapt_s = {}, {}
    for engine in ("fused", "compiled"):
        t0 = time.perf_counter()
        if engine == "fused":
            n, adapt[engine] = _launched("phase 11 (d)", lambda: (
                continual_adaptation(AdaptConfig(engine="fused"),
                                     device=DEVICE)))
            if n != ADAPT_LAUNCHES:
                raise AssertionError(f"phase 11 (d): {n} codebook launches, "
                                     f"expected {ADAPT_LAUNCHES}")
        else:
            adapt[engine] = continual_adaptation(
                AdaptConfig(engine=engine), device=DEVICE)
        torch.cuda.synchronize()
        adapt_s[engine] = time.perf_counter() - t0
    fa, ca = adapt["fused"].to_dict(), adapt["compiled"].to_dict()
    log(f"adaptation (d) fused: {json.dumps(fa)}")
    log(f"adaptation (d) compiled: {json.dumps(ca)}")
    held = ("acc_base", "acc_drift", "acc_adapted", "weight_writes",
            "write_energy_pj")
    if any(fa[k] != ca[k] for k in held):
        raise AssertionError(f"phase 11 (d): fused and compiled differ in "
                             f"{[k for k in held if fa[k] != ca[k]]}")

    # (e) times, on the deployed fused simulator (the card's fit is the
    # deployed one: (c) holds it bitwise to the CPU's)
    sim = ChipSimulator(card.weights, freq_hz=dcfg.chip_freq_hz,
                        mapping=mapping, register_tables=card.tables,
                        lif=cfg.lif, engine="fused", device=DEVICE)
    if sim.fused_engine().codebook_layers != len(arch.layer_sizes) - 1:
        raise AssertionError("phase 11 (e): a layer left codebook mode")
    chunk = eval_sp[:dcfg.chip_chunk]
    chunk_ms = _timed_ms(lambda: sim.run_batch(chunk))
    perf = {"deploy_a_s_op_check": a_s, "train_s": train_s,
            "deploy_fused": clocks["fused"],
            "deploy_compiled": clocks["compiled"],
            "ptq_card_s": card_s, "ptq_cpu_s": cpu_s,
            "adapt_s": adapt_s, "eval_chunk_ms": chunk_ms}
    perf.update(_device_breakdown(lambda: sim.run_batch(chunk), chunk_ms))
    log(f"deploy timing ({smi}): {json.dumps(perf)}")
    return {"launches": {"fused_timestep_codebook":
                         DEPLOY_LAUNCHES + ADAPT_LAUNCHES}, "perf": perf}


# ---------------------------------------------------------------------------
# phase 12: the sharded engine and batch sharding over torch.distributed
# ---------------------------------------------------------------------------

SHARD_SPEC = dict(neurons_per_core=256, max_domains=4)  # ARCH on 2 domains
SHARD_MAP_SEED = 3
SHARD_RANKS = 2                # (b): gloo ranks, both on the one card
SHARD_GROUP_TIMEOUT_S = 60     # every process group's collective timeout
SHARD_JOIN_S = 420             # the spawned ranks' deadline
SHARD_REPORT_REL = 1e-6        # (a): report fields against compiled


def _shard_mapping(arch):
    """ARCH mapped at 256 neurons a core: 2 domains of 20 assignments."""
    from repro_torch.compiler import ChipSpec, compile_network
    from repro_torch.compiler.ir import from_layer_sizes

    cn = compile_network(from_layer_sizes(arch.layer_sizes),
                         ChipSpec(**SHARD_SPEC), seed=SHARD_MAP_SEED)
    return cn.to_soc_mapping(), cn.n_domains_used


def _sync(dev=None) -> None:
    """Wait for the card (`dev` None or a CUDA device); nothing on the
    CPU."""
    import torch

    if dev is None or dev.type == "cuda":
        torch.cuda.synchronize()


def _digest(tensors) -> str:
    """A digest of the tensors' bits (any type, bf16 too)."""
    import hashlib

    import torch

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def _shard_sim(inp, engine: str, mapping, dev, **kw):
    from repro_torch import ChipSimulator

    arch = inp["arch"]
    return ChipSimulator(inp["qws"], engine=engine, freq_hz=arch["freq_hz"],
                         threshold=arch["threshold"], leak=arch["leak"],
                         mapping=mapping, device=dev, **kw)


def _shard_jobs(rank: int, world: int, inp: dict, dev) -> dict:
    """What one rank of (b) or (c) runs: the sharded engine on the
    two-domain mapping (S = world), then, at world 2, STDP on it, then the
    fused engine batch-sharded on phase 4's mapping.  Every collective
    runs inside the engines."""
    import torch

    from repro_torch import PlasticityConfig
    from repro_torch.kernels import fused_timestep as FT

    trains = inp["trains"].to(dev)
    res = {"rank": rank, "world": world}
    digests = []
    sim = _shard_sim(inp, "sharded", inp["mapping2"], dev)
    eng = sim.sharded_engine()
    ys, counts = eng.run_raw(trains)
    res.update(n_shards=eng.n_shards, sharded=eng.last_run_sharded,
               exchange_bytes=eng.last_exchange_bytes,
               words=[sl.words for sl in eng.sharded_layers],
               ys={k: v.cpu() for k, v in ys.items()}, counts=counts.cpu())
    digests.append(_digest([ys[k] for k in sorted(ys)] + [counts]))
    _, reports = sim.run_batch(trains)
    res["reports"] = [(r.pj_per_sop, r.energy_pj, r.wall_cycles)
                      for r in reports]
    res["ms"] = _timed_ms(lambda: sim.run_batch(trains), dev=dev)
    if dev.type == "cuda":
        res["busy"] = _device_breakdown(lambda: sim.run_batch(trains),
                                        res["ms"])
    del sim, eng
    if world > 1:
        psim = _shard_sim(inp, "sharded", inp["mapping2"], dev,
                          plasticity=PlasticityConfig(
                              enabled=True, mode="stdp",
                              layers=STDP_LAYERS))
        ys_p, _ = psim.array_engine().run_raw(trains)
        keys = [k for k in ys_p if k.startswith(("fired", "writes"))]
        learned = [ys_p.get(f"learned_idx_{li}")
                   for li in range(len(inp["qws"]))]
        digests.append(_digest([ys_p[k] for k in sorted(keys)]
                               + [x for x in learned if x is not None]))
        res["stdp"] = {"ys": {k: ys_p[k].cpu() for k in keys},
                       "learned": ([None if x is None else x.cpu()
                                    for x in learned] if rank == 0
                                   else None)}
        del psim, ys_p, learned
    fsim = _shard_sim(inp, "fused", inp["mapping4"], dev)
    feng = fsim.fused_engine()
    FT.reset_launches()
    ys_f, counts_f = feng.run_raw(trains)
    _sync(dev)
    res["fused"] = {"launches": dict(FT.launches),
                    "sharded": feng.last_run_sharded,
                    "exchange_bytes": feng.last_exchange_bytes,
                    "ys": {k: v.cpu() for k, v in ys_f.items()},
                    "counts": counts_f.cpu()}
    digests.append(_digest([ys_f[k] for k in sorted(ys_f)] + [counts_f]))
    res["fused"]["ms"] = _timed_ms(lambda: fsim.run_batch(trains), dev=dev)
    if dev.type == "cuda":
        res["fused"]["busy"] = _device_breakdown(
            lambda: fsim.run_batch(trains), res["fused"]["ms"])
    res["digests"] = digests
    return res


def _shard_rank(rank: int, world: int, backend: str, tmp: str,
                device: str) -> None:
    """One spawned rank: join the group, run `_shard_jobs`, save."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/store-{backend}", rank=rank,
        world_size=world, timeout=timedelta(seconds=SHARD_GROUP_TIMEOUT_S))
    try:
        inp = torch.load(f"{tmp}/inputs.pt", weights_only=False)
        res = _shard_jobs(rank, world, inp, dev)
        torch.save(res, f"{tmp}/{backend}-rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn_ranks(world: int, backend: str, tmp: str, device: str) -> list:
    """Start `world` ranks, join them by a deadline, stop any still
    alive; raise unless every rank exited 0.  Returns their results."""
    import multiprocessing as mp

    import torch

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_shard_rank,
                         args=(r, world, backend, tmp, device))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARD_JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    log(f"{backend} x {world}: ranks exited {codes} in "
        f"{time.perf_counter() - t0:.1f} s")
    if hung or any(c != 0 for c in codes):
        raise AssertionError(f"{backend} ranks failed: exit codes {codes}, "
                             f"hung {hung}")
    return [torch.load(f"{tmp}/{backend}-rank{r}.pt", weights_only=False)
            for r in range(world)]


def _equal_ys(a: dict, b: dict) -> bool:
    import torch

    return set(a) == set(b) and all(torch.equal(a[k].cpu(), b[k].cpu())
                                    for k in a)


def _hold_layer_totals(what, ys, reports, want_ys, want_reports) -> None:
    """Phase 4's rule: spike totals per layer within SPIKE_REL_TOL and
    pJ/SOP within PJ_REL_TOL of `want`."""
    got = ys["fired"].double().sum(dim=(0, 1)).numpy()
    want = want_ys["fired"].double().sum(dim=(0, 1)).numpy()
    rel = np.abs(got - want) / np.maximum(want, 1.0)
    pg = np.array([r[0] for r in reports])
    pw = np.array([r[0] for r in want_reports])
    prel = np.abs(pg - pw) / pw
    log(f"{what}: spikes per layer {got.tolist()} against {want.tolist()} "
        f"(max rel {rel.max():.3g}); pJ/SOP {pg.mean():.6f} against "
        f"{pw.mean():.6f} (max rel {prel.max():.3g})")
    if rel.max() > SPIKE_REL_TOL or prel.max() > PJ_REL_TOL:
        raise AssertionError(f"{what}: outside phase 4's rule")


def shard_path(arch, ctx: dict, smi: str, device: str = DEVICE) -> dict:
    """Phase 12: the cores-axis sharded engine on ARCH mapped onto two
    domains, and batch sharding of the fused engine, on phase 4's
    quantized weights and trains: (a) one process without a group, S = 1;
    (b) two spawned gloo ranks on the one card, S = 2; (c) one spawned
    NCCL rank (world size 1)."""
    import shutil
    import tempfile

    import torch

    from repro_torch import PlasticityConfig

    dev = torch.device(device)
    qws, trains, sim4 = ctx["qws"], ctx["trains"], ctx["sim"]
    mapping2, n_dom = _shard_mapping(arch)
    if n_dom != 2:
        raise AssertionError(f"ARCH at {SHARD_SPEC} spans {n_dom} domains")
    L = len(qws)
    inp = {"qws": qws, "trains": trains, "mapping2": mapping2,
           "mapping4": sim4.mapping,
           "arch": {"freq_hz": arch.freq_hz, "threshold": arch.threshold,
                    "leak": arch.leak}}

    # (a) one process, no group: S = 1 against the compiled engine
    comp = _shard_sim(inp, "compiled", mapping2, dev)
    shrd = _shard_sim(inp, "sharded", mapping2, dev)
    eng = shrd.sharded_engine()
    if eng.n_shards != 1 or eng.n_domains != 2:
        raise AssertionError(f"(a): {eng.n_shards} shards of "
                             f"{eng.n_domains} domains")
    ys_c, counts_c = comp.array_engine().run_raw(trains)
    ys_a, counts_a = eng.run_raw(trains)
    if not (_equal_ys(ys_a, ys_c) and torch.equal(counts_a, counts_c)):
        raise AssertionError("(a): sharded S = 1 counters differ from the "
                             "compiled engine's")
    _, reps_c = comp.run_batch(trains)
    _, reps_a = shrd.run_batch(trains)
    worst = 0.0
    for rc, ra in zip(reps_c, reps_a):
        for f in ("energy_pj", "core_energy_pj", "noc_energy_pj",
                  "riscv_energy_pj", "wall_cycles"):
            x, y = getattr(rc, f), getattr(ra, f)
            worst = max(worst, abs(x - y) / max(abs(x), 1.0))
    if worst > SHARD_REPORT_REL:
        raise AssertionError(f"(a): report fields {worst:.3g} apart")
    log(f"phase 12 (a): sharded S = 1 on {n_dom} domains, counters bitwise "
        f"the compiled engine's, report fields within {worst:.3g}")
    perf = {"a_ms": _timed_ms(lambda: shrd.run_batch(trains), dev=dev),
            "a_compiled_ms": _timed_ms(lambda: comp.run_batch(trains),
                                       dev=dev)}
    if dev.type == "cuda":
        perf["a_busy"] = _device_breakdown(lambda: shrd.run_batch(trains),
                                           perf["a_ms"])
    rep_a = [(r.pj_per_sop, r.energy_pj, r.wall_cycles) for r in reps_a]
    ys_a = {k: v.cpu() for k, v in ys_a.items()}
    counts_a = counts_a.cpu()
    # what the spawned ranks are held to: compiled STDP on this mapping,
    # phase 4's fused run on its own mapping
    pcomp = _shard_sim(inp, "compiled", mapping2, dev,
                       plasticity=PlasticityConfig(enabled=True,
                                                   mode="stdp",
                                                   layers=STDP_LAYERS))
    ys_p, _ = pcomp.array_engine().run_raw(trains)
    keys = [k for k in ys_p if k.startswith(("fired", "writes"))]
    stdp_want = (_host_ys(ys_p, keys),
                 [ys_p.get(f"learned_idx_{li}") for li in range(L)])
    del pcomp, ys_p, comp, shrd, eng
    ys4, counts4 = sim4.array_engine().run_raw(trains)
    ys4 = {k: v.cpu() for k, v in ys4.items()}
    counts4 = counts4.cpu()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    try:
        torch.save({**inp, "qws": [type(q)(idx=q.idx.cpu(),
                                           codebook=q.codebook.cpu(),
                                           scale=q.scale.cpu(),
                                           group_axis_size=q.group_axis_size)
                                   for q in qws],
                    "trains": trains.cpu()}, f"{tmp}/inputs.pt")
        # (b) two gloo ranks on the one card; (c) NCCL at world size 1
        rank_dev = "cuda:0" if dev.type == "cuda" else "cpu"
        gloo = _spawn_ranks(SHARD_RANKS, "gloo", tmp, rank_dev)
        nccl = (_spawn_ranks(1, "nccl", tmp, rank_dev)
                if dev.type == "cuda" else [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if any(r["digests"] != gloo[0]["digests"] for r in gloo):
        raise AssertionError("(b): the ranks' results differ")
    b = gloo[0]
    if b["n_shards"] != SHARD_RANKS or not b["sharded"]:
        raise AssertionError(f"(b): {b['n_shards']} shards, sharded "
                             f"{b['sharded']}")
    bitwise = _equal_ys(b["ys"], ys_a) and torch.equal(b["counts"], counts_a)
    _hold_layer_totals("phase 12 (b) S = 2", b["ys"], b["reports"], ys_a,
                       rep_a)
    log(f"phase 12 (b) S = 2: counters bitwise the S = 1 run's: {bitwise}")
    # each rank sends its words of every layer-step
    reckoned = sum(w * 2 for w in b["words"]) * arch.timesteps * BATCH
    sent = sum(r["exchange_bytes"] for r in gloo)
    log(f"phase 12 (b): spike-word bytes per run, all ranks {sent} "
        f"(reckoned words x 2 B x S x T x B: {reckoned * SHARD_RANKS})")
    if sent != reckoned * SHARD_RANKS:
        raise AssertionError("(b): exchanged bytes differ from the words")
    got_p = ({k: v.double().numpy() for k, v in b["stdp"]["ys"].items()},
             b["stdp"]["learned"])
    _hold_plastic("phase 12 (b) STDP S = 2", got_p, stdp_want,
                  frozen=[li for li in range(L) if li not in STDP_LAYERS],
                  learnable=STDP_LAYERS)
    want_launch = arch.timesteps * L if dev.type == "cuda" else 0
    launches = 0
    for name, runs in (("(b)", gloo), ("(c)", nccl)):
        for r in runs:
            f = r["fused"]
            if f["launches"] != {"fused_timestep_codebook": want_launch,
                                 "fused_timestep_dense": 0}:
                raise AssertionError(f"{name} rank {r['rank']}: fused "
                                     f"launches {f['launches']}")
            launches += f["launches"]["fused_timestep_codebook"]
            if not (_equal_ys(f["ys"], ys4)
                    and torch.equal(f["counts"], counts4)):
                raise AssertionError(f"{name} rank {r['rank']}: "
                                     f"batch-sharded fused counters differ "
                                     f"from phase 4's")
    if not gloo[0]["fused"]["sharded"]:
        raise AssertionError("(b): the fused batch was not split")
    log(f"phase 12 (b): fused, {BATCH // SHARD_RANKS} rows a rank: "
        f"{want_launch} codebook launches a rank, counters bitwise phase "
        f"4's; exchanged {gloo[0]['fused']['exchange_bytes']} B a rank")
    if nccl:
        c = nccl[0]
        if not (_equal_ys(c["ys"], ys_a) and torch.equal(c["counts"],
                                                         counts_a)):
            raise AssertionError("(c): NCCL S = 1 differs from (a)")
        # the spike words, then the batch gather of the whole result
        words_c = sum(w * 2 for w in c["words"]) * arch.timesteps * BATCH
        rows_c = sum(t.numel() * t.element_size()
                     for t in [*c["ys"].values(), c["counts"]])
        if c["exchange_bytes"] != words_c + rows_c or not c["fused"][
                "exchange_bytes"]:
            raise AssertionError("(c): the collectives did not run")
        log(f"phase 12 (c): NCCL world 1, sharded bitwise (a), fused "
            f"bitwise phase 4, {c['exchange_bytes']} + "
            f"{c['fused']['exchange_bytes']} B through the collectives")
    for name, runs in (("b", gloo), ("c", nccl)):
        for r in runs:
            perf[f"{name}{r['rank']}"] = {
                "sharded_ms": r["ms"], "fused_ms": r["fused"]["ms"],
                "sharded_busy_ms": r.get("busy", {}).get("device_busy_ms"),
                "fused_busy_ms": r["fused"].get("busy", {}).get(
                    "device_busy_ms")}
    perf["bitwise_s2"] = bitwise
    perf["exchange_bytes_per_run"] = sent
    log(f"phase 12 timing ({smi}): {json.dumps(perf)}")
    return {"launches": {"fused_timestep_codebook": launches}, "perf": perf}


# ---------------------------------------------------------------------------
# phase 5: the kernel-API path
# ---------------------------------------------------------------------------

def _timed_ms(fn, reps: int = 5, dev=None) -> float:
    """Host-clock ms of `fn` ending in a synchronize (`_sync(dev)`):
    warmup, median."""
    fn()
    _sync(dev)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append(time.perf_counter() - t0)
    return statistics.median(out) * 1e3


def api_path(arch, qws, seed: int) -> dict:
    """The paper's network through `kernels.ops`, one call per layer-step:
    (a) zspe_spmm of the dequantized weights, (b) codebook_matmul of the
    indexes, each followed by lif_update, (c) fused_timestep of the
    indexes and a per-column level table, padded to `_pick_block`'s
    (bm, bn)."""
    import torch

    from repro_torch.core.quant import dequantize
    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.kernels import fused_timestep as FT
    from repro_torch.kernels import lif_update as LU
    from repro_torch.kernels import ops
    from repro_torch.kernels import zspe_spmm as ZS

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 2)
    trains = torch.as_tensor(
        (rng.random((BATCH, arch.timesteps, arch.layer_sizes[0]))
         < TIME_DENSITY).astype(np.float32), device=dev)
    ws = [dequantize(q) for q in qws]
    blocks = [ops._pick_block(BATCH, *w.shape) for w in ws]
    tables = [q.codebook[0][:, None].expand(-1, w.shape[1])
              for q, w in zip(qws, ws)]
    on_cpu = [(q.idx.cpu(), t.cpu()) for q, t in zip(qws, tables)]
    lif = dict(threshold=arch.threshold, leak=arch.leak, reset=0.0)
    currents = {
        "zspe_spmm": lambda li, s: ops.zspe_spmm(s, ws[li]),
        "codebook_matmul": lambda li, s: ops.codebook_matmul(
            s, qws[li].idx, qws[li].codebook[0])}
    exact_weights = {
        "zspe_spmm": ws,
        "codebook_matmul": [CBM.dequantize(q.idx, q.codebook[0])
                            for q in qws]}

    def fused(li, s, v, el, on=None):
        idx, table = (qws[li].idx, tables[li]) if on is None else on[li]
        return ops.fused_timestep(s, idx, v, el, codebook=table,
                                  block=blocks[li][::2], **lif)

    def api_step(name):
        """One layer-step of loop `name` on the kernels: its outputs and
        the current (None in the fused loop)."""
        def step(li, s, v, el):
            if name == "fused_timestep":
                return fused(li, s, v, el), None
            cur = currents[name](li, s)
            return ops.lif_update(v, el, cur, **lif), cur
        return step

    def plain_step(name):
        """One layer-step of the reference loop: the plain LIF on the f64
        product rounded once, which the kernels compute.  The plain
        products' f32 matmul rounds otherwise, and on some codebooks from
        the card's k-means that moved a near-threshold spike and a layer-3
        total (about 520 spikes) by 0.19%."""
        def step(li, s, v, el):
            cur = _exact_product(s, exact_weights[name][li]).float()
            return LU.lif_update_plain(v, el, cur, **lif), cur
        return step

    def check(name, li, s, v, el, got, cur) -> float:
        """One layer-step of loop `name` against the plain versions on the
        same inputs: the current (a, b), then the LIF outputs."""
        what = f"kernel-API loop {name}, layer {li + 1}"
        if name == "fused_timestep":
            want = [o.to(dev) for o in fused(li, s.cpu(), v.cpu(), el.cpu(),
                                             on_cpu)]
            return check_step(what, got, want, FUSED_INTS,
                              _lif_v_int(v, el, s @ ws[li], arch.leak),
                              arch.threshold, touched=want[3])
        err = _assert_close(f"{what} current", cur,
                            _exact_product(s, exact_weights[name][li]))
        want = LU.lif_update_plain(v, el, cur, **lif)
        return max(err, check_step(what, got, want, LIF_INTS,
                                   _lif_v_int(v, el, cur, arch.leak),
                                   arch.threshold))

    def run(step, name=None):
        """Spike totals per layer of one B x T run; with `name`, every
        layer-step is also held against the plain versions."""
        states = [(torch.zeros(BATCH, n, device=dev),
                   torch.zeros(BATCH, n, dtype=torch.int32, device=dev))
                  for n in arch.layer_sizes[1:]]
        totals = torch.zeros(len(qws), dtype=torch.float64, device=dev)
        err = 0.0
        for t in range(arch.timesteps):
            s = trains[:, t].contiguous()
            for li in range(len(qws)):
                out, cur = step(li, s, *states[li])
                if name is not None:
                    err = max(err, check(name, li, s, *states[li], out, cur))
                states[li] = (out[0], out[1])
                s = out[2]
                totals[li] += s.sum()
        return totals.cpu().numpy(), err

    mods = (ZS, CBM, LU, FT)
    want = arch.timesteps * len(qws)
    totals, perf = {}, {}
    for name in (*currents, "fused_timestep"):
        for mod in mods:
            mod.reset_launches()
        # each layer-step is held against the plain versions on the same
        # inputs as it runs; the plain versions launch no kernel
        got, err = run(api_step(name), name)
        torch.cuda.synchronize()
        launches = {}
        for mod in mods:
            launches.update(mod.launches)
        expect = dict.fromkeys(launches, 0)
        expect.update({"fused_timestep_codebook": want}
                      if name == "fused_timestep"
                      else {name: want, "lif_update": want})
        if launches != expect:
            raise AssertionError(f"kernel-API loop {name}: launches "
                                 f"{launches}, expected {expect}")
        log(f"kernel-API loop {name}: {launches}; every layer-step agrees "
            f"with the plain versions (max |diff| {err:.3g})")
        if name != "fused_timestep":
            plain, _ = run(plain_step(name))
            rel = np.abs(got - plain) / np.maximum(plain, 1.0)
            log(f"kernel-API loop {name}: spikes per layer {got.tolist()} "
                f"plain LIF on the f64 product {plain.tolist()} (max rel "
                f"{rel.max():.3g})")
            if rel.max() > SPIKE_REL_TOL:
                raise AssertionError(f"kernel-API loop {name}: spike totals "
                                     f"differ from the reference loop by "
                                     f"{rel.max():.3g} relative")
        totals[name] = got
        perf[name] = {"launches": launches, "max_abs_err": err}
    b = totals["codebook_matmul"]
    for name in ("zspe_spmm", "fused_timestep"):
        rel = np.abs(totals[name] - b) / np.maximum(b, 1.0)
        log(f"kernel-API loop {name}: spikes per layer "
            f"{totals[name].tolist()}, loop codebook_matmul {b.tolist()} "
            f"(max rel {rel.max():.3g})")
        if rel.max() > SPIKE_REL_TOL:
            raise AssertionError(f"kernel-API loops {name} and "
                                 f"codebook_matmul differ by "
                                 f"{rel.max():.3g} relative")
    if b[0] == 0:
        raise AssertionError("kernel-API path: layer 1 never spiked")

    for name in perf:
        step = api_step(name)
        ms = _timed_ms(lambda: run(step))
        perf[name].update(ms_per_loop=ms, **_device_breakdown(
            lambda: run(step), ms,
            (("zspe_kernel_ms", "zspe_"),
             ("codebook_kernel_ms", "codebook_matmul_"),
             ("lif_kernel_ms", "lif_update_"),
             ("fused_timestep_kernel_ms", "fused_timestep_"))))
        log(f"kernel-API loop {name}: {json.dumps(perf[name])}")

    # one codebook_matmul backward at layer 1 against plain autograd
    q = qws[0]
    x0 = torch.as_tensor(rng.normal(0, 1, (BATCH * arch.timesteps,
                                           q.idx.shape[0]))
                         .astype(np.float32), device=dev)
    grads = []
    for fwd in (lambda x, c: ops.codebook_matmul(x, q.idx, c),
                lambda x, c: x @ CBM.dequantize(q.idx, c)):
        x = x0.clone().requires_grad_()
        c = q.codebook[0].clone().requires_grad_()
        (fwd(x, c) ** 2).sum().backward()
        grads.append((x.grad, c.grad))
    torch.cuda.synchronize()
    for got_g, want_g, what in zip(*grads, ("gx", "gcb")):
        torch.testing.assert_close(got_g, want_g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, msg=f"codebook {what}")
        rel = float(((got_g - want_g).abs()
                     / want_g.abs().clamp(min=GRAD_ATOL)).max())
        log(f"codebook_matmul backward at layer 1: {what} agrees with "
            f"plain autograd (max rel {rel:.3g})")
    return perf


# ---------------------------------------------------------------------------
# phase 6: the LM serving path
# ---------------------------------------------------------------------------

LM_ARCH = "granite-3-2b"       # configs/granite_3_2b.py ARCH, full width
LM_SLOTS = 4
LM_REQUESTS = 8
LM_PROMPT = 512
LM_NEW = 16
LM_CACHE = 640
FLASH_F32_TOL = 2e-5           # online vs one-pass softmax: abs + rel
FLASH_BF16_TOL = 2e-2          # p and the output rounded to bf16: abs
H100_BF16_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
# Last-token logits of one bf16 prefill over 512 tokens (flash route)
# against a prefill over 511 plus one decode step (plain SDPA): the two
# round in other places (GEMM shapes, flash vs one-pass softmax, each
# rounded to bf16) through 40 layers.  Logits are O(1) to O(4), where a
# bf16 ulp is 2^-7 to 2^-5; the bound allows a few ulp at the top.
LM_LOGIT_TOL = 0.125


def _flash_case(rng, b, h, kv, s, t, hd, dtype, dev):
    import torch

    return [torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32),
                            device=dev).to(dtype)
            for shape in ((b, h, s, hd), (b, kv, t, hd), (b, kv, t, hd))]


def _flash_diff(got, want) -> float:
    """Max |got - want|; raises beyond the tolerance of the input type."""
    import torch

    d = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        bad = d > FLASH_F32_TOL + FLASH_F32_TOL * want.float().abs()
    else:
        bad = d > FLASH_BF16_TOL
    if bool(bad.any()):
        raise AssertionError(f"flash_attention {tuple(got.shape)} "
                             f"{got.dtype}: off by up to {float(d.max())}")
    return float(d.max())


def _flash_bound(q, k, causal: bool) -> tuple[float, str]:
    """q, k, v read once and o written once, or the score and PV products
    of the pairs the mask keeps at the tensor-core rate of the type."""
    b, h, s, hd = q.shape
    t = k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    pairs = sum(min(r + 1, t) for r in range(s)) if causal else s * t
    ops = 4 * b * h * pairs * hd
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    rate = H100_BF16_PER_S if q.element_size() == 2 else H100_F32_PER_S
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_kernel_phase(seed: int) -> dict:
    """The flash kernel against its plain version over the cases, then
    timed at the served prefill shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 6)
    cfg_shape = (4, 32, 8, LM_PROMPT, LM_PROMPT, 64)    # B H KV S T hd
    hd128_shape = cfg_shape[:5] + (128,)                # granite-3-8b's
    cases = [(cfg_shape, torch.bfloat16, True),
             (hd128_shape, torch.bfloat16, True)]
    for s in (128, 1024):
        for hd in (16, 32, 64, 128):
            for group in (1, 4):
                for causal in (True, False):
                    for dtype in (torch.float32, torch.bfloat16):
                        cases.append(((2, 8, 8 // group, s, s, hd), dtype,
                                      causal))
    for s, t in ((128, 512), (384, 256)):      # T > S and S > T, causal
        for hd in (32, 64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                cases.append(((2, 8, 2, s, t, hd), dtype, True))
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape, dtype, causal in cases:
        q, k, v = _flash_case(rng, *shape, dtype, dev)
        got = FA.flash_attention(q, k, v, causal=causal)
        want = FA.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err[dtype] = max(err[dtype], _flash_diff(got, want))
    log(f"kernel flash_attention: {len(cases)} cases agree, max |diff| "
        f"f32 {err[torch.float32]:.3g} (tolerance {FLASH_F32_TOL} abs + "
        f"rel), bf16 {err[torch.bfloat16]:.3g} (tolerance "
        f"{FLASH_BF16_TOL} abs)")

    timed = {}
    for shape in (cfg_shape, hd128_shape):
        q, k, v = _flash_case(rng, *shape, torch.bfloat16, dev)
        bound, by = _flash_bound(q, k, True)
        timed[shape] = {
            "max_abs_err": max(err.values()),
            "ms": _time_graph_ms(lambda: FA.flash_attention(q, k, v)),
            "plain_ms": _time_eager_ms(
                lambda: FA.flash_attention_plain(q, k, v)),
            "library_ms": _time_graph_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)),
            "bound_ms": bound, "bound_by": by}
        log(f"kernel flash_attention at (B, H, KV, S, T, hd) = {shape} "
            f"bf16 causal: {json.dumps(timed[shape])}")
    return timed[cfg_shape]


def _serve_once(cfg, model, prompts, instrument=None, cache_len=LM_CACHE):
    """One `Server.run` over fresh requests; `instrument` maps "prefill" /
    "decode" to lists that receive each call's host-clock ms (each call
    synchronised on both sides)."""
    import torch

    from repro_torch.serve.server import Request, Server

    srv = Server(cfg, model, device=DEVICE, batch_slots=LM_SLOTS,
                 cache_len=cache_len)
    if instrument is not None:
        def timed(fn, key):
            def call(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                instrument[key].append((time.perf_counter() - t0) * 1e3)
                return out
            return call
        srv.prefill = timed(srv.prefill, "prefill")
        srv.decode = timed(srv.decode, "decode")
    for uid, p in enumerate(prompts):
        srv.submit(Request(uid=uid, prompt=p, max_new_tokens=LM_NEW))
    return srv.run()


def _measured_serve(cfg, model, prompts, what: str, want: dict,
                    cache_len: int = LM_CACHE, **extra) -> dict:
    """A warm-up batch, then the served run with every LM launch count
    from 0 just before it and read just after (they must equal `want`):
    tokens/s, prefill and decode ms per call (each call is timed between
    two synchronisations; the server crosses to the host after each call
    anyway, so the run's wall time is the same as without them), peak
    memory; then one batch's device breakdown (a prefill and its decode
    steps) against the same batch unprofiled: the profiler's own host
    cost grows with the thousands of ops of every decode step."""
    import torch

    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.kernels import flash_attention as FA

    serve = functools.partial(_serve_once, cfg, model, cache_len=cache_len)
    serve(prompts[:LM_SLOTS])                            # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phase = {"prefill": [], "decode": []}
    FA.reset_launches()
    CBM.reset_launches()
    t0 = time.perf_counter()
    done = serve(prompts, phase)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**FA.launches, **CBM.launches}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{want}")
    toks = [r.out_tokens for r in done]
    if len(done) != len(prompts) or any(
            len(t) != LM_NEW or min(t) < 0 or max(t) >= cfg.vocab
            for t in toks):
        raise AssertionError(f"{what}: bad served tokens {toks}")
    n_tok = sum(len(t) for t in toks)
    perf = {"tokens_per_s": n_tok / wall, "ms_per_run": wall * 1e3,
            "tokens": n_tok, "launches": launches,
            "prefill_ms_per_batch": statistics.median(phase["prefill"]),
            "decode_ms_per_step": statistics.median(phase["decode"]),
            "prefill_batches": len(phase["prefill"]),
            "decode_steps": len(phase["decode"]),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **extra}
    log(f"{what}: {len(prompts)} requests x {len(prompts[0])} prompt "
        f"tokens, {LM_NEW} new each, {LM_SLOTS} slots: {json.dumps(perf)}; "
        f"first tokens {[t[:4] for t in toks[:2]]}")
    batch = prompts[:LM_SLOTS]
    t0 = time.perf_counter()
    serve(batch)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    perf.update(batch_ms=batch_ms, **_device_breakdown(
        lambda: serve(batch), batch_ms,
        (("flash_kernel_ms", "flash_attention"),
         ("codebook_kernel_ms", "codebook_matmul"))))
    perf["out_tokens"] = toks
    return perf


def _lm_model(name: str, seed: int, **replace):
    """An LM config of the registry at full width (fields replaced as
    given), its random weights from the port's init on the card, the
    seconds that took, and its parameter count held against the analytic
    one plus the norm weights, which `param_count` leaves out."""
    import dataclasses

    import torch

    from repro_torch.configs import registry as R
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(R.get_arch(name), **replace)
    t0 = time.perf_counter()
    model = T.init_model(cfg, torch.Generator(device=DEVICE).manual_seed(
        seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count() + _uncounted(cfg):
        raise AssertionError(f"{n_params} parameters, ArchConfig says "
                             f"{cfg.param_count()} + {_uncounted(cfg)}")
    return cfg, model, init_s, n_params


def _uncounted(cfg) -> int:
    """What `ArchConfig.param_count` leaves out of the model's parameters
    (the reference's analytic count): the norm weights of every family;
    in an SSM layer also `conv_b` and the third of its (nh,) vectors; the
    hybrid's shared block has an `ln_attn` but no MLP, which param_count
    counts; the audio encoder's norms and `enc_final_norm`."""
    d, L = cfg.d_model, cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * d
        extra = L * (d + d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim)
        if cfg.family == "hybrid":
            extra += d - 3 * d * cfg.d_ff
        return extra
    if cfg.family == "audio":
        return 3 * d * L + 2 * d * cfg.enc_layers + d
    return 2 * d * L


def _prompts(seed: int, vocab: int, length: int = LM_PROMPT) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, length).astype(np.int32)
            for _ in range(LM_REQUESTS)]


def _hold_logits(what: str, got, want) -> float:
    """Logits (rows, V) of two routes of one function: finite, within
    LM_LOGIT_TOL, and the greedy token equal wherever `want`'s top-2 gap
    is at least the tolerance; returns the max difference."""
    got, want = got.float(), want.float()
    if not bool(want.isfinite().all() & got.isfinite().all()) or \
            got.shape != want.shape:
        raise AssertionError(f"{what}: bad logits {tuple(got.shape)}")
    diff = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    flipped = got.argmax(-1) != want.argmax(-1)
    log(f"{what}: max |logit diff| {diff:.4g} (tolerance {LM_LOGIT_TOL}, "
        f"logits up to {float(want.abs().max()):.3g}); greedy tokens differ "
        f"in {int(flipped.sum())} of {want.shape[0]} rows; top-2 gaps "
        f"{[round(float(g), 4) for g in gap]}")
    if diff > LM_LOGIT_TOL:
        raise AssertionError(f"{what}: logits differ by {diff}")
    if bool((flipped & (gap >= LM_LOGIT_TOL)).any()):
        raise AssertionError(f"{what}: a greedy token differs away from a "
                             f"near-tie")
    return diff


def serving_path(seed: int) -> dict:
    """granite-3-2b at full width, bf16, random weights from the port's
    init: 8 requests of 512 prompt tokens through a 4-slot `Server`, 16
    new tokens each; then prefill + decode held against a prefill over
    one more token, and every layer's flash call against the plain
    version on the same q / k / v."""
    import torch

    dev = torch.device(DEVICE)
    cfg, model, init_s, n_params = _lm_model(LM_ARCH, seed)
    prompts = _prompts(seed, cfg.vocab)

    # (b) the served run: 2 prefill batches x 40 layers on the flash kernel
    want = -(-LM_REQUESTS // LM_SLOTS) * cfg.n_layers
    perf = _measured_serve(
        cfg, model, prompts, "served run",
        {"flash_attention": want, "flash_attention_wgmma": want,
         "codebook_matmul": 0}, init_s=init_s, n_params=n_params)
    perf.pop("out_tokens")

    # (c) the path held together at full width
    tokens = torch.as_tensor(np.stack(prompts[:LM_SLOTS]), device=dev)
    perf.update(_prefill_continues("phase 6", cfg, model, {"tokens": tokens},
                                   cfg.n_layers))
    return perf


def _prefill_continues(what: str, cfg, model, batch: dict,
                       flash_layers: int, cache_len: int = LM_CACHE) -> dict:
    """A prefill over `batch`'s prompts (S positions, 512 in phases 6 and
    14; 576 patches + 64 tokens in phase 15), every flash call held
    against the plain version on its q / k / v (`flash_layers` calls),
    against a prefill over S - 1 (no flash launch: S - 1 is not a
    multiple of 128) plus one decode step of the last token, by
    `_hold_logits`."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as ATT
    from repro_torch.models import transformer as T

    tokens = batch["tokens"]
    flash = ATT.flash_attention
    layer_err = []

    def checked(q, k, v, *, causal=True):
        out = flash(q, k, v, causal=causal)
        layer_err.append(_flash_diff(
            out, FA.flash_attention_plain(q, k, v, causal)))
        return out

    ATT.flash_attention = checked
    try:
        full, _ = T.forward_prefill(model, cfg, batch, cache_len)
    finally:
        ATT.flash_attention = flash
    if len(layer_err) != flash_layers:
        raise AssertionError(f"{what}: {len(layer_err)} flash calls in one "
                             f"prefill, expected {flash_layers}")
    if layer_err:
        log(f"{what}: every layer's flash call agrees with the plain "
            f"version on its q / k / v (max |diff| {max(layer_err):.3g})")
    FA.reset_launches()
    _, st = T.forward_prefill(model, cfg, dict(batch, tokens=tokens[:, :-1]),
                              cache_len)
    got, st = T.forward_decode(model, cfg, st, tokens[:, -1:])
    torch.cuda.synchronize()
    if FA.launches["flash_attention"] != 0:
        raise AssertionError(f"{what}: prefill over {tokens.shape[1] - 1} "
                             f"tokens took the flash route")
    diff = _hold_logits(f"{what}: prefill({tokens.shape[1]}) vs prefill("
                        f"{tokens.shape[1] - 1}) + decode", got, full)
    return {"layer_max_abs_err": max(layer_err, default=0.0),
            "decode_logit_diff": diff}


# ---------------------------------------------------------------------------
# phase 13: MoE and C3 codebook-quantized LM serving
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"   # configs/granite_moe_1b_a400m.py ARCH
C3_DENSE_LAYERS = 8             # (c): granite-3-2b at full width, 8 layers
C3_DECODE_STEPS = 15            # (c): decode steps after its one prefill
# (b): the quantized 2-D products of one forward pass of granite-moe
# (wq, wk, wv, wo, router); (c): granite-3-2b's seven
MOE_PROJECTIONS = ("wq", "wk", "wv", "wo", "router")
DENSE_PROJECTIONS = ("wq", "wk", "wv", "wo", "mlp_wi", "mlp_wg", "mlp_wo")


def _unpack4(packed):
    """Two 4-bit indexes a byte (low nibble first) as int64."""
    import torch

    return torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(
        *packed.shape[:-1], -1).long()


def _dequantized_model(cfg, qmodel, dtype):
    """The dense model of the same function as the quantized one: every
    quantized leaf as cb.to(dtype)[idx], so its products are plain
    `torch.matmul`s of the weights the kernel route multiplies."""
    from repro_torch.models import transformer as T

    blocks = []
    for block in qmodel.blocks:
        lp = {}
        for name, v in block.leaves().items():
            if isinstance(v, dict):
                idx = v["idx"].long() if "idx" in v else _unpack4(v["idx4"])
                lp[name] = v["cb"].to(dtype)[idx]
            else:
                lp[name] = v.detach()
        blocks.append(lp)
    return T.Transformer(cfg, qmodel.embed.detach(), qmodel.unembed.detach(),
                         qmodel.final_norm.detach(), blocks,
                         **qmodel.extras())


def _quantize_timed(model, what: str, pack_4bit: bool = False):
    """`quantize_blocks` on the card, timed, with its weight bytes."""
    import torch

    from repro_torch.quant import lm_quant as Q

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel = Q.quantize_blocks(model, pack_4bit=pack_4bit)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    before, after = Q.quantized_bytes(qmodel)
    leaves = {n for n, v in qmodel.blocks[0].leaves().items()
              if isinstance(v, dict)}
    out = {"quantize_s": sec, "bytes_before": before, "bytes_after": after,
           "quantized": sorted(leaves)}
    log(f"{what}: C3 quantized serving: weight bytes {before / 2**20:.1f} -> "
        f"{after / 2**20:.1f} MiB; {json.dumps(out)}")
    return qmodel, out


def _checked_codebook_calls(fn) -> tuple:
    """`fn()` with every codebook_matmul call held against the plain
    product on the same operands by phase 3's rule (f64, one rounding);
    returns fn's result, the calls' count and their max difference."""
    import torch

    from repro_torch.kernels import codebook_matmul as CBM

    kernel = CBM.codebook_matmul
    err = []

    def checked(x, idx, cb):
        out = kernel(x, idx, cb)
        want = _exact_product(x, CBM.dequantize(idx, cb))
        torch.cuda.synchronize()
        err.append(_assert_close(f"codebook_matmul {tuple(x.shape)} x "
                                 f"{tuple(idx.shape)} {x.dtype}", out, want))
        return out

    CBM.codebook_matmul = checked
    try:
        result = fn()
    finally:
        CBM.codebook_matmul = kernel
    return result, len(err), max(err) if err else 0.0


def _codebook_decode_timing(seed: int, cfg) -> list:
    """codebook_matmul at granite-moe's decode shapes (M = the server's
    slots, bf16 x, a bf16-exact codebook): kernel, plain version, the
    library's `x @ cb[idx]` and the bound."""
    import torch

    from repro_torch.kernels import codebook_matmul as CBM

    rng = np.random.default_rng(seed + 13)
    d, hd = cfg.d_model, cfg.hd
    rows = []
    for k, n in ((d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
                 (d, cfg.n_experts)):
        x = torch.as_tensor(rng.normal(0, 1, (LM_SLOTS, k)).astype(
            np.float32), device=DEVICE).to(torch.bfloat16)
        idx = torch.as_tensor(rng.integers(0, 16, (k, n)).astype(np.int8),
                              device=DEVICE)
        cb = torch.as_tensor(np.sort(rng.normal(0, 0.05, 16)).astype(
            np.float32), device=DEVICE).to(torch.bfloat16).float()
        ix, cb16 = idx.long(), cb.to(torch.bfloat16)
        row = _time_api_case(
            LM_SLOTS, k, n, lambda: CBM.codebook_matmul(x, idx, cb),
            lambda: CBM.codebook_matmul_plain(x, idx, cb),
            lambda: x @ cb16[ix],
            _roof(x.numel() * 2 + idx.numel() + cb.numel() * 4
                  + LM_SLOTS * n * 4, 2 * LM_SLOTS * k * n))
        row["max_abs_err"] = _assert_close(
            f"codebook_matmul decode {k} x {n}",
            CBM.codebook_matmul(x, idx, cb),
            _exact_product(x, CBM.dequantize(idx, cb)))
        rows.append(row)
        log(f"kernel codebook_matmul at the decode shape (M, K, N) = "
            f"{(LM_SLOTS, k, n)} bf16: {json.dumps(row)}")
    return rows


# Top-k routing is not continuous: a router logit one bf16 ulp apart
# between two routes of one moe function can swap an expert (or a tied
# pair's first), and a swap moves the capacity fill of every later token
# of its group.  Phase 13 (b) pins the routing: one route's dispatch is
# recorded per layer and replayed into the other, whose combine weights
# come from its own router probabilities (combine = dispatch x probs,
# what the rounds of `top_k_dispatch` compute).

def _dispatching(hook, fn):
    """`fn()` with `models.moe.top_k_dispatch` replaced by `hook`."""
    from repro_torch.models import moe as MOE

    dispatch = MOE.top_k_dispatch
    MOE.top_k_dispatch = hook
    try:
        return fn()
    finally:
        MOE.top_k_dispatch = dispatch


def _recorder(routes: list):
    from repro_torch.models import moe as MOE

    dispatch = MOE.top_k_dispatch

    def record(probs, k, cap):
        d, c = dispatch(probs, k, cap)
        routes.append(d)
        return d, c
    return record


def _replayer(routes: list):
    it = iter(routes)

    def replay(probs, k, cap):
        d = next(it)
        return d, d * probs[..., None]
    return replay


def _bf16_ulp(x) -> float:
    """The bf16 spacing at the largest |x|."""
    m = max(float(x.float().abs().max()), 2.0 ** -126)
    return 2.0 ** (math.floor(math.log2(m)) - 7)


def _moe_layerwise(what: str, cfg, got_model, want_model, transform,
                   tokens) -> dict:
    """Every layer of two routes of one moe prefill on the same input, the
    got route's output of the layer before, with the routing pinned: each
    layer's outputs within two bf16 ulps of its largest element (a bf16
    product of either route is within half an ulp of the exact one, and a
    layer rounds its attention and feed-forward outputs once each), then
    the last-token logits of the last layer's two outputs by
    `_hold_logits`."""
    import torch

    from repro_torch.models import transformer as T

    with torch.no_grad():
        x = T.embed_tokens(got_model, cfg, tokens)
        worst = []
        for got_block, want_block in zip(got_model.blocks,
                                         want_model.blocks):
            routes = []
            got = _dispatching(_recorder(routes), lambda: T._attn_mlp_block(
                x, transform(got_block.leaves()), cfg)[0])
            want = _dispatching(_replayer(routes), lambda: T._attn_mlp_block(
                x, want_block, cfg)[0])
            d = float((got.float() - want.float()).abs().max())
            ulp = _bf16_ulp(want)
            worst.append(d / ulp)
            if d > 2 * ulp:
                raise AssertionError(f"{what}: layer {len(worst) - 1} "
                                     f"differs by {d} ({d / ulp} bf16 ulp)")
            x = got
        torch.cuda.synchronize()
        diff = _hold_logits(f"{what}, the last layer's logits",
                            T._logits(got_model, cfg, got[:, -1]),
                            T._logits(want_model, cfg, want[:, -1]))
    log(f"{what}: every layer within 2 bf16 ulp of its largest output "
        f"(max {max(worst):.3g} ulp; per layer "
        f"{[round(w, 3) for w in worst]})")
    return {"layer_max_ulp": max(worst), "layer_logit_diff": diff}


def _moe_routes(what: str, run_got, run_want) -> dict:
    """Two routes of one moe prefill end to end (each a callable returning
    (logits, state)): `want`'s logits free and with `got`'s routing
    replayed, and the token-layers routed otherwise; logged, not held
    (the two routes' roundings compound over the layers).  Replaying
    `got`'s routes into its own route must give its logits bitwise."""
    import torch

    def run(fn, hook):
        logits, _ = _dispatching(hook, fn)
        torch.cuda.synchronize()
        return logits

    got_routes, free_routes = [], []
    got = run(run_got, _recorder(got_routes))
    if not torch.equal(run(run_got, _replayer(got_routes)), got):
        raise AssertionError(f"{what}: a replayed route is not bitwise "
                             f"the route it recorded")
    free = run(run_want, _recorder(free_routes))
    pinned = run(run_want, _replayer(got_routes))
    out = {"routes_moved": sum(
               int((a != b).flatten(2).any(-1).any(-1).sum())
               for a, b in zip(got_routes, free_routes)),
           "token_layers": sum(int(a.shape[0] * a.shape[1])
                               for a in got_routes),
           "free_logit_diff": float((got.float() - free.float()).abs()
                                    .max()),
           "pinned_logit_diff": float((got.float() - pinned.float()).abs()
                                      .max())}
    log(f"{what}, end to end: routing free, max |logit diff| "
        f"{out['free_logit_diff']:.4g}, the routes differ in "
        f"{out['routes_moved']} of {out['token_layers']} token-layers; "
        f"routing pinned, max |logit diff| {out['pinned_logit_diff']:.4g} "
        f"(logits up to {float(got.float().abs().max()):.3g})")
    return out


def moe_c3_path(seed: int, smi: str) -> dict:
    """Phase 13: (a) granite-moe-1b-a400m served at full width; (b) the
    same weights C3-quantized (int8) on the card and served, the kernel
    route held against the dense dequantized model and every layer's
    codebook call of a decode step against the plain product; (c) 4-bit
    C3 on granite-3-2b at full width, 8 layers."""
    import dataclasses

    import torch

    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T
    from repro_torch.quant import lm_quant as Q

    out = {"seconds": {}}
    part = time.perf_counter()
    cfg, model, init_s, n_params = _lm_model(MOE_ARCH, seed)
    prompts = _prompts(seed + 13, cfg.vocab)
    batches = -(-LM_REQUESTS // LM_SLOTS)
    flash = batches * cfg.n_layers
    # (a) bf16 weights: 2 prefill batches x 24 layers on the flash kernel
    out["a"] = _measured_serve(
        cfg, model, prompts, "phase 13 (a) moe served run",
        {"flash_attention": flash, "flash_attention_wgmma": flash,
         "codebook_matmul": 0}, init_s=init_s, n_params=n_params)
    out["a"].pop("out_tokens")
    out["seconds"]["a"] = time.perf_counter() - part

    # (b) the same weights, int8 C3, fitted on the card
    part = time.perf_counter()
    qmodel, out["b_quant"] = _quantize_timed(model, "phase 13 (b)")
    if set(out["b_quant"]["quantized"]) != set(MOE_PROJECTIONS) | {
            "moe_wi", "moe_wg", "moe_wo"}:
        raise AssertionError(f"phase 13 (b): quantized leaves "
                             f"{out['b_quant']['quantized']}")
    del model
    qcfg = dataclasses.replace(cfg, quant_serving=True)
    passes = batches * LM_NEW            # a prefill + 15 steps per batch
    out["b"] = _measured_serve(
        qcfg, qmodel, prompts, "phase 13 (b) C3 int8 served run",
        {"flash_attention": flash, "flash_attention_wgmma": flash,
         "codebook_matmul": cfg.n_layers * len(MOE_PROJECTIONS) * passes})
    out["b"].pop("out_tokens")
    pt = Q.make_param_transform(cfg.dtype)
    dense = _dequantized_model(cfg, qmodel, cfg.dtype)
    tokens = torch.as_tensor(np.stack(prompts[:LM_SLOTS]), device=DEVICE)

    what = "phase 13 (b) kernel route vs dense dequantized"
    out["b"].update(_moe_layerwise(what, cfg, qmodel, dense, pt, tokens))
    out["b"].update(_moe_routes(
        what, lambda: T.forward_prefill(qmodel, cfg, {"tokens": tokens},
                                        LM_CACHE, param_transform=pt),
        lambda: T.forward_prefill(dense, cfg, {"tokens": tokens},
                                  LM_CACHE)))
    got, st = T.forward_prefill(qmodel, cfg, {"tokens": tokens}, LM_CACHE,
                                param_transform=pt)
    step = got.argmax(-1, keepdim=True).to(torch.int32)
    (_, _), calls, err = _checked_codebook_calls(
        lambda: T.forward_decode(qmodel, cfg, st, step, param_transform=pt))
    if calls != cfg.n_layers * len(MOE_PROJECTIONS):
        raise AssertionError(f"phase 13 (b): {calls} codebook calls in one "
                             f"decode step")
    out["b"]["decode_call_max_abs_err"] = err
    log(f"phase 13 (b): every layer's codebook_matmul call of one decode "
        f"step ({calls}) agrees with the plain product (max |diff| "
        f"{err:.3g}, tolerance {V_ATOL} + {V_RTOL} |want|)")
    del qmodel, dense, st
    out["codebook_decode"] = _codebook_decode_timing(seed, cfg)
    out["seconds"]["b"] = time.perf_counter() - part

    # (c) 4-bit C3 on a dense model: granite-3-2b, depth cut to 8 layers
    part = time.perf_counter()
    dcfg, dmodel, _, _ = _lm_model(LM_ARCH, seed + 1,
                                   n_layers=C3_DENSE_LAYERS)
    q4, out["c_quant"] = _quantize_timed(dmodel, "phase 13 (c)",
                                         pack_4bit=True)
    del dmodel
    if set(out["c_quant"]["quantized"]) != set(DENSE_PROJECTIONS):
        raise AssertionError(f"phase 13 (c): quantized leaves "
                             f"{out['c_quant']['quantized']}")
    pt4 = Q.make_param_transform(dcfg.dtype)
    dense4 = _dequantized_model(dcfg, q4, dcfg.dtype)
    toks = torch.as_tensor(np.stack(_prompts(seed + 14, dcfg.vocab)[
        :LM_SLOTS]), device=DEVICE)
    FA.reset_launches()
    CBM.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, st = T.forward_prefill(q4, dcfg, {"tokens": toks}, LM_CACHE,
                                param_transform=pt4)
    logits = [got]
    for _ in range(C3_DECODE_STEPS):
        got, st = T.forward_decode(q4, dcfg, st, logits[-1].argmax(
            -1, keepdim=True).to(torch.int32), param_transform=pt4)
        logits.append(got)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = {**FA.launches, **CBM.launches}
    want4 = {"flash_attention": dcfg.n_layers,
             "flash_attention_wgmma": dcfg.n_layers,
             "codebook_matmul": dcfg.n_layers * len(DENSE_PROJECTIONS)
             * (1 + C3_DECODE_STEPS)}
    if launches != want4:
        raise AssertionError(f"phase 13 (c): launches {launches}, expected "
                             f"{want4}")
    feed = [lg.argmax(-1, keepdim=True).to(torch.int32) for lg in logits]

    def dense_steps():
        ref, st = T.forward_prefill(dense4, dcfg, {"tokens": toks}, LM_CACHE)
        refs = [ref]
        for tok in feed[:-1]:
            ref, st = T.forward_decode(dense4, dcfg, st, tok)
            refs.append(ref)
        torch.cuda.synchronize()
        return refs

    diffs = [_hold_logits(
        f"phase 13 (c) 4-bit kernel route vs dense dequantized, "
        f"{'prefill(512)' if i == 0 else f'decode step {i}'}", got, ref)
        for i, (got, ref) in enumerate(zip(logits, dense_steps()))]
    out["c"] = {"launches": launches, "ms": run_ms, "logit_diffs": diffs}
    out["seconds"]["c"] = time.perf_counter() - part
    log(f"phase 13 (c) 4-bit granite-3-2b, {dcfg.n_layers} layers, one "
        f"prefill of {LM_SLOTS} x {LM_PROMPT} + {C3_DECODE_STEPS} decode "
        f"steps ({smi}): {json.dumps(out['c'])}")
    out["launches"] = {
        k: out["a"]["launches"][k] + out["b"]["launches"][k] + launches[k]
        for k in ("flash_attention", "codebook_matmul")}
    log(f"phase 13 seconds: {json.dumps(out['seconds'])}")
    return out


# ---------------------------------------------------------------------------
# phase 14: the ssm, hybrid and audio families
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-130m"        # configs/mamba2_130m.py ARCH
HYBRID_ARCH = "zamba2-2.7b"     # configs/zamba2_2_7b.py ARCH
AUDIO_ARCH = "whisper-tiny"     # configs/whisper_tiny.py ARCH
SSM_PROJECTIONS = ("in_proj", "out_proj")   # (b): the codebook products
SSM_QUANTIZED = ("in_proj", "out_proj", "conv_w")
SSM_LAYER_TOL = 1e-4            # one f32 layer, card vs CPU: abs + rel
SSD_TOL = 1e-3                  # the reference's own (tests/test_models.py)


def _ssm_layer_check(cfg, model, seed: int) -> float:
    """Layer 0's `mamba2_forward` in f32 on the card against the same call
    on the CPU: its weights widened to f32, one (4, 512, d) input, the
    output and the returned conv window and state."""
    import dataclasses

    import torch

    from repro_torch.models import mamba2 as M2

    fcfg = dataclasses.replace(cfg, dtype=torch.float32)
    lp = {k: v.detach().float() for k, v in model.blocks[0].leaves().items()}
    x = torch.as_tensor(np.random.default_rng(seed).normal(
        0, 1, (LM_SLOTS, LM_PROMPT, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        got = M2.mamba2_forward(x.to(DEVICE), lp, fcfg, return_cache=True)
        want = M2.mamba2_forward(x, {k: v.cpu() for k, v in lp.items()},
                                 fcfg, return_cache=True)
    torch.cuda.synchronize()
    err = max(_assert_close(f"phase 14 (a) f32 layer {part}, card vs CPU",
                            g.cpu(), w, SSM_LAYER_TOL)
              for part, g, w in (("output", got[0], want[0]),
                                 ("conv window", got[1].conv, want[1].conv),
                                 ("state", got[1].state, want[1].state)))
    log(f"phase 14 (a): one mamba2 layer in f32 on the card agrees with the "
        f"CPU (max |diff| {err:.3g}, tolerance {SSM_LAYER_TOL} abs + rel)")
    return err


def _ssd_vs_recurrence(cfg, seed: int) -> float:
    """`ssd_chunked` at the layer's shapes (B 4, S 512, its heads, state
    and chunk) on the card against the step recurrence `mamba2_decode`
    computes, one token at a time, from random x, dt = softplus(N(0, 1)),
    A = -exp(0.3 N(0, 1)), B and C (the reference's own test's inputs)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import mamba2 as M2

    _, h, n, p = M2.dims(cfg)
    b, s = LM_SLOTS, LM_PROMPT
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(0, scale, shape).astype(
            np.float32), device=DEVICE)

    x, dt, A, B, C = (t(b, s, h, p), F.softplus(t(b, s, h)),
                      -torch.exp(t(h, scale=0.3)), t(b, s, n), t(b, s, n))
    y, final = M2.ssd_chunked(x, dt, A, B, C, cfg.ssm_chunk)
    state = torch.zeros((b, h, n, p), device=DEVICE)
    ys = []
    for i in range(s):
        upd = (dt[:, i, :, None] * B[:, i, None, :])[..., None] \
            * x[:, i, :, None]
        state = state * torch.exp(dt[:, i] * A)[..., None, None] + upd
        ys.append((C[:, i, None, None, :] @ state)[:, :, 0])
    torch.cuda.synchronize()
    err = max(_assert_close("phase 14 (a) ssd_chunked vs the recurrence",
                            y, torch.stack(ys, dim=1), SSD_TOL),
              _assert_close("phase 14 (a) ssd_chunked final state vs the "
                            "recurrence", final, state, SSD_TOL))
    log(f"phase 14 (a): ssd_chunked at (B, S, H, P, N, chunk) = "
        f"{(b, s, h, p, n, cfg.ssm_chunk)} agrees with the step recurrence "
        f"(max |diff| {err:.3g}, tolerance {SSD_TOL} abs + rel)")
    return err


def families_path(seed: int, smi: str) -> dict:
    """Phase 14: (a) mamba2-130m served at full width, bf16; (b) the same
    weights C3 int8, fitted on the card and served; (c) zamba2-2.7b and
    (d) whisper-tiny served at full width, bf16.  Each served run has
    phase 6's traffic, then the 512 against 511 + 1 check."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as T
    from repro_torch.quant import lm_quant as Q

    out = {"seconds": {}}
    batches = -(-LM_REQUESTS // LM_SLOTS)
    none = {"flash_attention": 0, "flash_attention_wgmma": 0,
            "codebook_matmul": 0}

    def served(what, cfg, model, prompts, want, **extra):
        perf = _measured_serve(cfg, model, prompts, what, want, **extra)
        perf.pop("out_tokens")
        return perf

    def first_batch(prompts, cfg):
        batch = {"tokens": torch.as_tensor(np.stack(prompts[:LM_SLOTS]),
                                           device=DEVICE)}
        if cfg.family == "audio":          # the server's stub frames
            batch["frames"] = torch.zeros(
                (LM_SLOTS, cfg.enc_frames, cfg.d_model), device=DEVICE)
        return batch

    # (a) mamba2-130m, bf16: no attention, so no flash launch
    part = time.perf_counter()
    cfg, model, init_s, n_params = _lm_model(SSM_ARCH, seed)
    prompts = _prompts(seed + 14, cfg.vocab)
    out["a"] = served("phase 14 (a) mamba2 served run", cfg, model, prompts,
                      none, init_s=init_s, n_params=n_params)
    batch = first_batch(prompts, cfg)
    out["a"].update(_prefill_continues("phase 14 (a)", cfg, model, batch, 0))
    out["a"]["layer_f32_max_abs_err"] = _ssm_layer_check(cfg, model, seed)
    out["a"]["ssd_max_abs_err"] = _ssd_vs_recurrence(cfg, seed)
    out["seconds"]["a"] = time.perf_counter() - part

    # (b) the same weights, int8 C3, fitted on the card; conv_w is read
    # dense, so in_proj and out_proj are the codebook products
    part = time.perf_counter()
    qmodel, out["b_quant"] = _quantize_timed(model, "phase 14 (b)")
    if set(out["b_quant"]["quantized"]) != set(SSM_QUANTIZED):
        raise AssertionError(f"phase 14 (b): quantized leaves "
                             f"{out['b_quant']['quantized']}")
    del model
    qcfg = dataclasses.replace(cfg, quant_serving=True)
    calls = cfg.n_layers * len(SSM_PROJECTIONS)
    out["b"] = served("phase 14 (b) mamba2 C3 int8 served run", qcfg, qmodel,
                      prompts, dict(none, codebook_matmul=calls * batches
                                    * LM_NEW))
    pt = Q.make_param_transform(cfg.dtype)
    dense = _dequantized_model(cfg, qmodel, cfg.dtype)
    got, st = T.forward_prefill(qmodel, cfg, batch, LM_CACHE,
                                param_transform=pt)
    want, _ = T.forward_prefill(dense, cfg, batch, LM_CACHE)
    torch.cuda.synchronize()
    out["b"]["logit_diff"] = _hold_logits(
        f"phase 14 (b) kernel route vs dense dequantized, prefill("
        f"{LM_PROMPT})", got, want)
    step = got.argmax(-1, keepdim=True).to(torch.int32)
    _, n_calls, err = _checked_codebook_calls(
        lambda: T.forward_decode(qmodel, cfg, st, step, param_transform=pt))
    if n_calls != calls:
        raise AssertionError(f"phase 14 (b): {n_calls} codebook calls in one "
                             f"decode step, expected {calls}")
    out["b"]["decode_call_max_abs_err"] = err
    log(f"phase 14 (b): every layer's codebook_matmul call of one decode "
        f"step ({n_calls}) agrees with the plain product (max |diff| "
        f"{err:.3g}, tolerance {V_ATOL} + {V_RTOL} |want|)")
    del qmodel, dense, st
    out["seconds"]["b"] = time.perf_counter() - part

    # (c) zamba2-2.7b, bf16: its shared attention has a 4096-token window,
    # which keeps it off the flash route (as in the reference)
    part = time.perf_counter()
    cfg, model, init_s, n_params = _lm_model(HYBRID_ARCH, seed + 1)
    prompts = _prompts(seed + 15, cfg.vocab)
    out["c"] = served("phase 14 (c) zamba2 served run", cfg, model, prompts,
                      none, init_s=init_s, n_params=n_params)
    out["c"].update(_prefill_continues("phase 14 (c)", cfg, model,
                                       first_batch(prompts, cfg), 0))
    del model
    out["seconds"]["c"] = time.perf_counter() - part

    # (d) whisper-tiny, bf16: the decoder's self-attention prefill on the
    # tensor-core flash kernel (hd 64), the encoder and the
    # cross-attention on plain SDPA
    part = time.perf_counter()
    cfg, model, init_s, n_params = _lm_model(AUDIO_ARCH, seed + 2)
    prompts = _prompts(seed + 16, cfg.vocab)
    flash = batches * cfg.n_layers
    out["d"] = served("phase 14 (d) whisper served run", cfg, model, prompts,
                      dict(none, flash_attention=flash,
                           flash_attention_wgmma=flash),
                      init_s=init_s, n_params=n_params)
    out["d"].update(_prefill_continues("phase 14 (d)", cfg, model,
                                       first_batch(prompts, cfg),
                                       cfg.n_layers))
    del model
    out["seconds"]["d"] = time.perf_counter() - part

    out["launches"] = {k: sum(out[p]["launches"][k] for p in "abcd")
                       for k in ("flash_attention", "codebook_matmul")}
    log(f"phase 14 ({smi}) seconds: {json.dumps(out['seconds'])}")
    return out


# ---------------------------------------------------------------------------
# phase 15: the vlm family and LM training
# ---------------------------------------------------------------------------

VLM_ARCH = "phi-3-vision-4.2b"  # configs/phi_3_vision_4_2b.py ARCH
VLM_PROMPT = 64                 # 576 patches + 64 = 640 positions: flash
VLM_LONG_PROMPT = 512           # 576 + 512 = 1088 positions: plain SDPA
VLM_CACHE = 768                 # 576 + 64 + 16 new tokens
VLM_LONG_CACHE = 1152
VLM_C3_LAYERS = 8               # (c): the first 8 of 32 layers
FLASH_NEW_HEAD_DIMS = (80, 96)  # the head dims this phase adds
TRAIN_ARCH = "granite-3-2b"     # configs/granite_3_2b.py ARCH
TRAIN_BATCH_LM, TRAIN_SEQ, TRAIN_STEPS_LM = 2, 512, 4
# (d), (f), 16: flash calls a layer a training step under remat
# "nothing" or "dots": the forward and its recompute in the backward
FLASH_CALLS_A_LAYER = 2
# (f): granite-3-2b at train_4k's sequence length, one sequence a step,
# each remat policy from the same weights and batches; "everything"
# twice, the spread of its two runs the tolerance of the others
REMAT_SEQ, REMAT_BATCH, REMAT_STEPS = 4096, 1, 3
REMAT_RUNS = ("everything", "nothing", "dots", "everything")
TINY_STEPS, TINY_SAVE, TINY_CRASH = 8, 3, 4   # (e): crash in step 4
TINY_RESUME_REL = 1e-5          # (e): final loss, resumed vs uninterrupted
# (d): one layer's q / k / v gradients through the flash autograd.Function
# (the kernel forward, autograd of the plain version backward) against
# autograd of the plain version alone, on the same bf16 q, k, v and
# cotangent: the same backward on the same operands, so they can differ
# only where a library product picks another f32 summation order between
# two calls; that moves a bf16 result by at most one rounding, one ulp
# at the leaf's largest magnitude (2^-7 of it).
FLASH_GRAD_REL = 2.0 ** -7


# (B, H, KV, S, T, hd) timed by `flash_head_dim_times`: the served
# granite-3-2b prefill, phi-3-vision's prefill (576 patches + 64 tokens)
# and granite-3-8b's head dim at the served shape
FLASH_TIMED_SHAPES = {64: (LM_SLOTS, 32, 8, LM_PROMPT, LM_PROMPT, 64),
                      96: (LM_SLOTS, 32, 32, 576 + VLM_PROMPT,
                           576 + VLM_PROMPT, 96),
                      128: (LM_SLOTS, 32, 8, LM_PROMPT, LM_PROMPT, 128)}


def flash_head_dim_times(seed: int) -> dict:
    """The flash route (`flash_attention`, bf16, causal) timed at
    FLASH_TIMED_SHAPES beside `scaled_dot_product_attention` on the same
    inputs and the bound.  Uses only what every tree of the port has, so
    it also times an older tree (chip_smoke.py copied beside its src):
    there bf16 hd 96 runs the SIMT kernel."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(seed + 30)
    out = {}
    for hd, shape in FLASH_TIMED_SHAPES.items():
        q, k, v = _flash_case(rng, *shape, torch.bfloat16,
                              torch.device(DEVICE))
        bound, by = _flash_bound(q, k, True)
        out[hd] = {"shape": list(shape),
                   "ms": _time_graph_ms(lambda: FA.flash_attention(q, k, v)),
                   "library_ms": _time_graph_ms(
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, is_causal=True, enable_gqa=True)),
                   "bound_ms": bound, "bound_by": by}
    log(f"flash_attention by head dim, bf16 causal: {json.dumps(out)}")
    return out


def _flash_new_dims_phase(seed: int) -> dict:
    """(a) the flash kernel at hd 80 and 96 against the plain version by
    phase 6 (a)'s rule, launches counted per route (bf16 hd 96 on the
    tensor-core kernel, the rest on the SIMT kernel), then timed at
    phi-3-vision's prefill shape (B 4, H = KV = 32, S = T = 640, hd 96,
    bf16, causal) beside the plain version, `scaled_dot_product_attention`
    and the bound, with hd 64 and 128 in the same call."""
    import torch

    from repro_torch.kernels import flash_attention as FA

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 15)
    phi3 = FLASH_TIMED_SHAPES[96]
    cases = []
    for hd in FLASH_NEW_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for s in (128, 640):
                for group in (1, 4):
                    for causal in (True, False):
                        cases.append(((2, 8, 8 // group, s, s, hd), dtype,
                                      causal))
            cases.append(((2, 8, 2, 128, 512, hd), dtype, True))   # T > S
            cases.append(((2, 8, 2, 384, 256, hd), dtype, True))   # S > T
            cases.append((phi3[:5] + (hd,), dtype, True))
    err = {"simt": 0.0, "wgmma": 0.0}
    FA.reset_launches()
    for shape, dtype, causal in cases:
        q, k, v = _flash_case(rng, *shape, dtype, dev)
        got = FA.flash_attention(q, k, v, causal=causal)
        want = FA.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        route = FA._route(dtype, shape[-1])
        err[route] = max(err[route], _flash_diff(got, want))
    # V's columns unlike one another (v rising with the column): a panel
    # stored at the wrong column offset or row stride shows at once
    q, k, v = _flash_case(rng, 2, 8, 8, 640, 640, 96, torch.bfloat16, dev)
    v = (torch.arange(96, device=dev) / 96 + 0.1 * v.float()).to(v.dtype)
    want = FA.flash_attention_plain(q, k, v, True)
    err["wgmma"] = max(err["wgmma"], _flash_diff(
        FA.flash_attention(q, k, v), want))
    wgmma = 1 + sum(1 for shape, dtype, _ in cases
                    if FA._route(dtype, shape[-1]) == "wgmma")
    if FA.launches != {"flash_attention": len(cases) + 1,
                       "flash_attention_wgmma": wgmma}:
        raise AssertionError(f"phase 15 (a): launches {FA.launches} for "
                             f"{len(cases) + 1} cases, {wgmma} of them bf16 "
                             f"hd 96")
    log(f"phase 15 (a): flash_attention at hd {FLASH_NEW_HEAD_DIMS}: "
        f"{len(cases) + 1} cases agree ({wgmma} bf16 hd 96 on the tensor-"
        f"core kernel, {len(cases) + 1 - wgmma} on the SIMT kernel), max "
        f"|diff| SIMT {err['simt']:.3g} (f32 tolerance {FLASH_F32_TOL} abs "
        f"+ rel, bf16 {FLASH_BF16_TOL} abs), tensor cores "
        f"{err['wgmma']:.3g} (tolerance {FLASH_BF16_TOL} abs)")
    by_hd = flash_head_dim_times(seed)
    q, k, v = _flash_case(rng, *phi3, torch.bfloat16, dev)
    timed = {**by_hd[96], "max_abs_err": err["wgmma"],
             "plain_ms": _time_eager_ms(
                 lambda: FA.flash_attention_plain(q, k, v)),
             "hd64_ms": by_hd[64]["ms"], "hd128_ms": by_hd[128]["ms"]}
    log(f"phase 15 (a): flash_attention at (B, H, KV, S, T, hd) = {phi3} "
        f"bf16 causal: {json.dumps(timed)}")
    return timed


def _vlm_batch(prompts, cfg):
    """The server's prefill batch: the prompts and zero f32 patches."""
    import torch

    return {"tokens": torch.as_tensor(np.stack(prompts), device=DEVICE),
            "patch_embeds": torch.zeros((len(prompts), cfg.n_patches,
                                         cfg.d_model), device=DEVICE)}


def _vlm_long_prefill(cfg, model, seed: int) -> dict:
    """(b): a prefill of 512-token prompts (1088 positions) takes the
    plain SDPA and launches no flash kernel."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T

    batch = _vlm_batch(_prompts(seed, cfg.vocab, VLM_LONG_PROMPT)[:LM_SLOTS],
                       cfg)
    FA.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, st = T.forward_prefill(model, cfg, batch, VLM_LONG_CACHE)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if FA.launches["flash_attention"] != 0:
        raise AssertionError(f"phase 15 (b): a {int(st.pos)}-position "
                             f"prefill launched {FA.launches}")
    if tuple(logits.shape) != (LM_SLOTS, cfg.vocab) or not bool(
            logits.float().isfinite().all()):
        raise AssertionError("phase 15 (b): bad long-prefill logits")
    log(f"phase 15 (b): prefill over {cfg.n_patches} patches + "
        f"{VLM_LONG_PROMPT} tokens ({int(st.pos)} positions) on the plain "
        f"SDPA, no flash launch: {ms:.1f} ms")
    return {"long_prefill_ms": ms, "long_prefill_positions": int(st.pos)}


def _capture_qkv(cfg, model, tokens):
    """Layer 0's q, k, v as its flash call receives them: (B, H, S, hd)
    and (B, KV, S, hd), contiguous."""
    import torch

    from repro_torch.models import attention as ATT
    from repro_torch.models import transformer as T
    from repro_torch.models.common import rms_norm

    with torch.no_grad():
        x = rms_norm(T.embed_tokens(model, cfg, tokens),
                     model.blocks[0]["ln1"], cfg.norm_eps)
        positions = torch.arange(tokens.shape[1], device=DEVICE)[None, :]
        q, k, v = ATT._qkv(x, model.blocks[0], cfg, positions)
    return [t.transpose(1, 2).contiguous() for t in (q, k, v)]


def _flash_grad_check(cfg, model, tokens, seed: int) -> dict:
    """(d): one layer's q / k / v gradients through `_FlashCore` against
    autograd of `flash_attention_plain`, on the card, within
    FLASH_GRAD_REL of each gradient's largest magnitude."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as ATT

    qkv = _capture_qkv(cfg, model, tokens)
    g = torch.as_tensor(np.random.default_rng(seed).normal(
        0, 1, qkv[0].shape).astype(np.float32), device=DEVICE).to(
            qkv[0].dtype)
    a = [t.clone().requires_grad_() for t in qkv]
    b = [t.clone().requires_grad_() for t in qkv]
    got = torch.autograd.grad(ATT._FlashCore.apply(*a), a, g)
    want = torch.autograd.grad(FA.flash_attention_plain(*b), b, g)
    torch.cuda.synchronize()
    out = {"bitwise": all(torch.equal(x, y) for x, y in zip(got, want))}
    for name, x, y in zip("qkv", got, want):
        d = float((x.float() - y.float()).abs().max())
        scale = float(y.float().abs().max())
        if not math.isfinite(scale) or d > FLASH_GRAD_REL * scale:
            raise AssertionError(f"phase 15 (d): d{name} off by {d} (largest "
                                 f"{scale})")
        out[f"d{name}_max_abs_err"] = d
        out[f"d{name}_max"] = scale
    log(f"phase 15 (d): layer 0's q / k / v gradients through the flash "
        f"autograd.Function agree with autograd of the plain version "
        f"(tolerance {FLASH_GRAD_REL} of each largest): {json.dumps(out)}")
    return out


def _lm_training(seed: int) -> dict:
    """(d) granite-3-2b at full width and depth, bf16: TRAIN_STEPS_LM
    steps of `make_train_step` (the remat default, "nothing") on
    TokenStream(--seed) batches of B 2 x S 512; exactly 80 flash launches
    a step (each layer's forward and its recompute in the backward)."""
    import torch

    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    torch.cuda.empty_cache()
    cfg, model, init_s, n_params = _lm_model(TRAIN_ARCH, seed + 3)
    opt = adamw.init(dict(model.named_parameters()))
    step = make_train_step(cfg, adamw.AdamWConfig(
        warmup_steps=10, total_steps=TRAIN_STEPS_LM))
    data = TokenStream(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH_LM, seed)
    batches = [data.batch_at(i, DEVICE) for i in range(TRAIN_STEPS_LM + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    ms, losses, norms = [], [], []
    for i in range(TRAIN_STEPS_LM):
        t0 = time.perf_counter()
        model, opt, metrics = step(model, opt, batches[i])
        losses.append(float(metrics["loss"]))      # synchronises
        norms.append(float(metrics["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    want = TRAIN_STEPS_LM * cfg.n_layers * FLASH_CALLS_A_LAYER
    if cfg.remat_policy != "nothing" or FA.launches != {
            "flash_attention": want, "flash_attention_wgmma": want}:
        raise AssertionError(f"phase 15 (d): launches {FA.launches}, "
                             f"expected {want} (each forward and its "
                             f"recompute) at remat {cfg.remat_policy!r}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"phase 15 (d): loss {losses}, grad_norm "
                             f"{norms}")
    warm = statistics.median(ms[1:])
    perf = {"n_params": n_params, "init_s": init_s,
            "remat_policy": cfg.remat_policy, "ms_per_step": ms,
            "ms_per_step_warm": warm,
            "tokens_per_s": TRAIN_BATCH_LM * TRAIN_SEQ / warm * 1e3,
            "loss": losses, "grad_norm": norms, "launches": dict(FA.launches),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"phase 15 (d) {TRAIN_ARCH} training, B {TRAIN_BATCH_LM} x S "
        f"{TRAIN_SEQ}, bf16: {json.dumps(perf)}")
    perf.update(_device_breakdown(
        lambda: step(model, opt, batches[-1]), warm,
        (("flash_kernel_ms", "flash_attention"),)))
    perf.update(_flash_grad_check(cfg, model, batches[0]["tokens"], seed))
    del model, opt, batches
    torch.cuda.empty_cache()
    return perf


def _remat_run(seed: int, policy: str) -> dict:
    """One (f) run: REMAT_STEPS steps of `make_train_step` at `policy`
    from phase 15 (d)'s weights (the same seed, so the same bits each
    run) on TokenStream(--seed) batches of REMAT_BATCH x REMAT_SEQ.  The
    first and the last flash call of step 0's forward (layers 0 and 39,
    (1, 32, 4096, 64) q against (1, 8, 4096, 64) k / v: the wgmma kernel
    at 32 KV tiles) are copied to the host, so that the check adds no
    device memory to the run's peak, and held after the run against
    `flash_attention_plain` on the same q / k / v within FLASH_BF16_TOL."""
    import gc

    import torch

    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import attention as ATT
    from repro_torch.optim import adamw

    gc.collect()
    torch.cuda.empty_cache()
    cfg, model, _, _ = _lm_model(TRAIN_ARCH, seed + 3, remat_policy=policy)
    opt = adamw.init(dict(model.named_parameters()))
    step = make_train_step(cfg, adamw.AdamWConfig(
        warmup_steps=10, total_steps=REMAT_STEPS))
    data = TokenStream(cfg.vocab, REMAT_SEQ, REMAT_BATCH, seed)
    batches = [data.batch_at(i, DEVICE) for i in range(REMAT_STEPS)]
    flash, calls, held = ATT.flash_attention, [0], []

    def spy(q, k, v, causal=True):
        out = flash(q, k, v, causal=causal)
        if calls[0] in (0, cfg.n_layers - 1):          # step 0's forward
            held.append([t.detach().cpu() for t in (q, k, v, out)]
                        + [causal])
        calls[0] += 1
        return out

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    ms, losses, norms = [], [], []
    ATT.flash_attention = spy
    try:
        for batch in batches:
            t0 = time.perf_counter()
            model, opt, metrics = step(model, opt, batch)
            losses.append(float(metrics["loss"]))      # synchronises
            norms.append(float(metrics["grad_norm"]))
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        ATT.flash_attention = flash
    out = {"policy": policy, "ms_per_step": ms,
           "ms_per_step_warm": statistics.median(ms[1:]),
           "allocated_before_gb": before / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": dict(FA.launches), "loss": losses, "grad_norm": norms}
    out["step_memory_gb"] = out["peak_gb"] - out["allocated_before_gb"]
    del model, opt, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    if len(held) != 2:
        raise AssertionError(f"phase 15 (f) {policy}: {calls[0]} flash "
                             f"calls, step 0's forward not seen")
    out["flash_checked"] = [list(h[0].shape) + [h[1].shape[1]] for h in held]
    out["flash_max_err"] = max(_flash_diff(
        got.to(DEVICE), FA.flash_attention_plain(
            q.to(DEVICE), k.to(DEVICE), v.to(DEVICE), causal))
        for q, k, v, got, causal in held)
    torch.cuda.empty_cache()
    return out


def _remat_policies(seed: int, smi: str) -> dict:
    """(f) granite-3-2b at full width and depth, bf16, B 1 x S 4096:
    REMAT_STEPS steps at each of REMAT_RUNS ("everything" twice).  Flash
    launches 40 a step keeping everything, 80 rematerialising; each
    policy's losses and grad_norms bitwise the first "everything" run's,
    or within the two "everything" runs' spread; ms per step, peak memory
    and the memory allocated before the first step."""
    from repro_torch.configs import registry as R

    runs = []
    for policy in REMAT_RUNS:
        runs.append(_remat_run(seed, policy))
        log(f"phase 15 (f) {TRAIN_ARCH} remat {policy!r}, B {REMAT_BATCH} "
            f"x S {REMAT_SEQ}, bf16 ({smi}): {json.dumps(runs[-1])}")
    layers = R.get_arch(TRAIN_ARCH).n_layers
    first, again = runs[0], runs[-1]
    spread = {k: [abs(a - b) for a, b in zip(first[k], again[k])]
              for k in ("loss", "grad_norm")}
    for r in runs:
        calls = (1 if r["policy"] == "everything" else FLASH_CALLS_A_LAYER)
        want = REMAT_STEPS * layers * calls
        if r["launches"] != {"flash_attention": want,
                             "flash_attention_wgmma": want}:
            raise AssertionError(f"phase 15 (f) {r['policy']}: launches "
                                 f"{r['launches']}, expected {want}")
        for k in ("loss", "grad_norm"):
            gaps = [abs(a - b) for a, b in zip(r[k], first[k])]
            if not all(math.isfinite(x) for x in r[k]) or any(
                    g > s for g, s in zip(gaps, spread[k])):
                raise AssertionError(f"phase 15 (f) {r['policy']}: {k} "
                                     f"{r[k]} against {first[k]}, outside "
                                     f"the spread {spread[k]}")
    out = {r["policy"]: r for r in runs[:-1]}
    out["again"] = again
    out["bitwise"] = {r["policy"]: r["loss"] == first["loss"]
                      and r["grad_norm"] == first["grad_norm"]
                      for r in runs[1:]}
    out["spread"] = spread
    out["step_memory_ratio"] = {
        r["policy"]: r["step_memory_gb"] / first["step_memory_gb"]
        for r in runs[1:-1]}
    out["flash_max_err"] = max(r["flash_max_err"] for r in runs)
    log(f"phase 15 (f): losses and grad_norms bitwise the first "
        f"'everything' run's: {out['bitwise']} (spread of its two runs "
        f"{spread}); step memory (peak less the memory allocated before "
        f"the step) against 'everything': {out['step_memory_ratio']}; "
        f"flash at S {REMAT_SEQ}, step 0's first and last forward call of "
        f"each run, against its plain version: max |diff| "
        f"{out['flash_max_err']} (tolerance {FLASH_BF16_TOL} abs)")
    out["launches"] = {"flash_attention": sum(
        r["launches"]["flash_attention"] for r in runs)}
    return out


def _tiny_trainer_resume(seed: int) -> dict:
    """(e) `Trainer.run` on the card at examples/torch_lm_train.py's
    lm-tiny in f32: TINY_STEPS steps uninterrupted, against a run that
    crashes in step TINY_CRASH and a fresh Trainer that resumes from the
    last complete checkpoint; final losses within TINY_RESUME_REL."""
    import tempfile

    import torch

    from repro_torch.models.common import ArchConfig
    from repro_torch.train.trainer import Trainer, TrainJobConfig

    cfg = ArchConfig("lm-tiny", "dense", n_layers=4, d_model=128, n_heads=4,
                     n_kv_heads=2, d_ff=256, vocab=512, dtype=torch.float32)

    class Crash(Exception):
        pass

    with tempfile.TemporaryDirectory() as tmp:
        def job(name):
            return TrainJobConfig(batch=8, seq_len=64, num_steps=TINY_STEPS,
                                  save_every=TINY_SAVE, seed=seed, lr=1e-3,
                                  ckpt_dir=f"{tmp}/{name}")

        def log_to(hist, crash=None):
            def on_metrics(step, m, dt):
                hist.append((step, float(m["loss"])))
                if step == crash:
                    raise Crash
            return on_metrics

        t0 = time.perf_counter()
        full = []
        Trainer(cfg, job("full"), device=DEVICE).run(log_to(full))
        run_s = time.perf_counter() - t0
        crashed = []
        tr = Trainer(cfg, job("crash"), device=DEVICE)
        try:
            tr.run(log_to(crashed, TINY_CRASH))
            raise AssertionError("phase 15 (e): the run did not crash")
        except Crash:
            pass
        tr.ckpt.wait()
        last = tr.ckpt.latest_step()
        resumed = []
        Trainer(cfg, job("crash"), device=DEVICE).run(log_to(resumed))
    want_last = TINY_CRASH // TINY_SAVE * TINY_SAVE
    if last != want_last or [s for s, _ in resumed] != list(
            range(want_last, TINY_STEPS)):
        raise AssertionError(f"phase 15 (e): resumed from {last}, steps "
                             f"{[s for s, _ in resumed]}")
    a, b = resumed[-1][1], full[-1][1]
    rel = abs(a - b) / abs(b)
    if not math.isfinite(a) or rel > TINY_RESUME_REL:
        raise AssertionError(f"phase 15 (e): final loss {a} resumed, {b} "
                             f"uninterrupted")
    out = {"final_loss": b, "resumed_final_loss": a, "rel_diff": rel,
           "resumed_from": last, "first_loss": full[0][1],
           "run_s": run_s}
    log(f"phase 15 (e): Trainer.run lm-tiny f32, {TINY_STEPS} steps, a "
        f"crash in step {TINY_CRASH}, resumed from step {last}: "
        f"{json.dumps(out)}")
    return out


def vlm_train_path(seed: int, smi: str) -> dict:
    """Phase 15: (a) the flash kernel at hd 80 and 96; (b) phi-3-vision-
    4.2b served at full width and depth, bf16; (c) its first 8 layers C3
    int8; (d) granite-3-2b LM training at full width and depth; (e)
    `Trainer.run` with a crash and a resume; (f) granite-3-2b training at
    S 4096 under each remat policy."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as T
    from repro_torch.quant import lm_quant as Q

    out = {"seconds": {}}
    batches = -(-LM_REQUESTS // LM_SLOTS)

    part = time.perf_counter()
    out["a"] = _flash_new_dims_phase(seed)
    out["seconds"]["a"] = time.perf_counter() - part

    # (b) phi-3-vision-4.2b bf16: 576 zero patches + 64 prompt tokens =
    # 640 positions, the tensor-core flash kernel at hd 96 in every layer
    part = time.perf_counter()
    cfg, model, init_s, n_params = _lm_model(VLM_ARCH, seed + 4)
    prompts = _prompts(seed + 20, cfg.vocab, VLM_PROMPT)
    flash = batches * cfg.n_layers
    out["b"] = _measured_serve(
        cfg, model, prompts, "phase 15 (b) phi-3-vision served run",
        {"flash_attention": flash, "flash_attention_wgmma": flash,
         "codebook_matmul": 0}, cache_len=VLM_CACHE, init_s=init_s,
        n_params=n_params)
    out["b"].pop("out_tokens")
    out["b"].update(_prefill_continues(
        "phase 15 (b)", cfg, model, _vlm_batch(prompts[:LM_SLOTS], cfg),
        cfg.n_layers, cache_len=VLM_CACHE))
    out["b"].update(_vlm_long_prefill(cfg, model, seed + 21))
    del model
    out["seconds"]["b"] = time.perf_counter() - part

    # (c) its first 8 layers, C3 int8 fitted on the card: the seven
    # projections of a layer on the codebook kernel
    part = time.perf_counter()
    torch.cuda.empty_cache()
    cfg8, model8, _, _ = _lm_model(VLM_ARCH, seed + 5,
                                   n_layers=VLM_C3_LAYERS)
    qmodel, out["c_quant"] = _quantize_timed(model8, "phase 15 (c)")
    if set(out["c_quant"]["quantized"]) != set(DENSE_PROJECTIONS):
        raise AssertionError(f"phase 15 (c): quantized leaves "
                             f"{out['c_quant']['quantized']}")
    del model8
    qcfg = dataclasses.replace(cfg8, quant_serving=True)
    calls = cfg8.n_layers * len(DENSE_PROJECTIONS)
    out["c"] = _measured_serve(
        qcfg, qmodel, prompts, "phase 15 (c) phi-3-vision C3 int8 served run",
        {"flash_attention": batches * cfg8.n_layers,
         "flash_attention_wgmma": batches * cfg8.n_layers,
         "codebook_matmul": calls * batches * LM_NEW}, cache_len=VLM_CACHE)
    out["c"].pop("out_tokens")
    batch = _vlm_batch(prompts[:LM_SLOTS], cfg8)
    dense = _dequantized_model(cfg8, qmodel, cfg8.dtype)
    got, _ = T.forward_prefill(qmodel, cfg8, batch, VLM_CACHE,
                               param_transform=Q.make_param_transform(
                                   cfg8.dtype))
    want, _ = T.forward_prefill(dense, cfg8, batch, VLM_CACHE)
    torch.cuda.synchronize()
    out["c"]["logit_diff"] = _hold_logits(
        f"phase 15 (c) kernel route vs dense dequantized, prefill("
        f"{cfg8.n_patches} + {VLM_PROMPT})", got, want)
    del qmodel, dense
    out["seconds"]["c"] = time.perf_counter() - part

    part = time.perf_counter()
    out["d"] = _lm_training(seed)
    out["seconds"]["d"] = time.perf_counter() - part

    part = time.perf_counter()
    out["e"] = _tiny_trainer_resume(seed)
    out["seconds"]["e"] = time.perf_counter() - part

    part = time.perf_counter()
    out["f"] = _remat_policies(seed, smi)
    out["seconds"]["f"] = time.perf_counter() - part

    out["launches"] = {
        "flash_attention": sum(out[p]["launches"]["flash_attention"]
                               for p in "bcdf"),
        "codebook_matmul": out["c"]["launches"]["codebook_matmul"]}
    log(f"phase 15 ({smi}) seconds: {json.dumps(out['seconds'])}")
    return out

# ---------------------------------------------------------------------------
# phase 16: LM training on a DeviceMesh, and one dry-run cell
# ---------------------------------------------------------------------------

MESH_RANKS = 2                  # (a), (b): gloo ranks, both on the one card
MESH_STEPS = 3                  # timed steps a rank; one more is profiled
MESH_DP_LAYERS = 8              # (b), (c): granite-3-2b's first 8 layers
MESH_JOIN_S = 900               # the spawned ranks' deadline
# (a), (b): step 0 of a sharded bf16 step against the one-device step on
# the same weights and batch.  The sharded step computes the same
# function, but each row-parallel product (wo and mlp_wo of every layer,
# the unembedding) rounds each rank's partial sum to bf16 before the two
# are added, the sequence-parallel reductions add in another order, and
# the vocab-parallel loss sums its exponentials in another order: each
# is up to one bf16 rounding (2^-8 relative) of an addend.  The loss
# and grad_norm limits are about 14x and 80x the gaps measured on an
# H100 (7.3e-6 and 1.3e-5).  Per parameter leaf, the first moment after
# step 0 ((1 - b1) times the clipped gradient, f32) is compared by its
# norm and by its projection on a gaussian drawn from the leaf's index
# (the projection of a difference d has the spread of |d|, so a
# difference in any part of the leaf shows), both relative to the
# one-device norm: each leaf's gradient carries the roundings of every
# layer above it.  The step's update (the parameter after it less the
# one before, by the same projection) is held relative to the one-device
# update's norm: AdamW's first update is lr times the gradient's sign,
# so an element whose gradient is within a rounding of 0 may flip, and a
# share f of flips moves the update by about 2 sqrt(f) of its norm.  At
# 4 layers and d 512 in bf16 on the CPU the worst leaf was 0.018
# (gradient) and 0.16 (update) off; the same run with every partial
# gradient keeping one rank's part was 2.0 and 2.3 off, and its grad_norm
# 4.75e-2.  The leaf limits
# leave room for 40 layers' roundings.
MESH_LOSS_REL = 1e-4
MESH_GNORM_REL = 1e-3
MESH_GRAD_LEAF_REL = 0.1
MESH_UPDATE_LEAF_REL = 0.75
MESH_PRINT_SEED = 1601          # the leaves' gaussians: seed + leaf index
DRYRUN_CELL = ("granite-3-2b", "train_4k")   # (d): on the (16, 16) mesh
DRYRUN_TIMEOUT_S = 600
# (d): the reference's temp bytes of that cell (XLA's buffer assignment),
# from `python -m repro.launch.dryrun --arch granite-3-2b --shape
# train_4k` under jax 0.9.0 on the CPU; tests/test_torch_dryrun.py runs
# the reference beside the port's cell and holds the two within 0.5-2x
REF_DRYRUN_TEMP_BYTES = 11_116_425_376
# (d): a cell of the sequence split (mamba2-130m's 24 heads do not divide
# the 16-way "model" axis), under the card machine's torch: the
# reference's row from `python -m repro.launch.dryrun --arch mamba2-130m
# --shape prefill_32k` under jax 0.9.0 on the CPU (FLOPs, collective and
# temp bytes a device), logged beside the port's (0.5-2x in the CPU table)
SEQ_DRYRUN_CELL = ("mamba2-130m", "prefill_32k")
SEQ_DRYRUN_REF = {"hlo_flops": 900_543_499_776.0,
                  "coll_bytes": 1_142_210_880.0, "temp_bytes": 345_124_888}
# (e): mamba2-130m at full width and depth, bf16, trained on data 1 x
# model 2 under rules that leave the heads unsplit (its 24 SSD heads are
# never split there: `transformer._shard_ssm_heads` wants 16 to divide
# them), so the sequence stays split on "model" through every block:
# 512 positions a rank, two of the 256-position chunks.  Step 0 is held
# to MESH_LOSS_REL / MESH_GNORM_REL of the one-device step: the split
# products run the same rows (another cuBLAS tiling), the scan folds
# the other rank's f32 summaries in (the recurrence reassociated).
# Measured on an H100 at --seed 0: the losses equal, grad_norm 2.35e-4
# apart (its limit 1e-3).  The run also holds every layer's scan to the
# by-chunks route in each forward and its recompute.
SEQ_RULES = {"heads": [], "kv_heads": []}
SEQ_TRAIN_BATCH, SEQ_TRAIN_SEQ = 2, 1024


def _mesh_rank(rank: int, world: int, backend: str, tmp: str,
               job: dict) -> None:
    """One spawned rank of phase 16: join the group, build the
    ("data", "model") mesh of `job["model"]` on the card, train, save."""
    import faulthandler
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    dev = torch.device("cuda", 0)                  # both on the one card
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/store-{job['name']}",
        rank=rank, world_size=world,
        timeout=timedelta(seconds=SHARD_GROUP_TIMEOUT_S))
    try:
        res = (_seq_train if job.get("seq") else _mesh_train)(rank, dev, job)
        torch.save(res, f"{tmp}/{job['name']}-rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _mesh_model(layers: int, seed: int, dev):
    """granite-3-2b at full width with `layers` layers (bf16), its random
    weights from the port's init on `dev` (phase 15 (d)'s seed)."""
    import dataclasses

    import torch

    from repro_torch.configs import registry as R
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(R.get_arch(TRAIN_ARCH), n_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    return cfg, T.init_model(cfg, gen)


def _lm_batches(cfg, seed: int, dev, n: int) -> list:
    from repro_torch.data.synthetic import TokenStream

    data = TokenStream(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH_LM, seed)
    return [data.batch_at(i, dev) for i in range(n)]


def _projections(tensors: dict, dev) -> dict:
    """{leaf: the sum of its f32 values times a gaussian of its shape drawn
    from MESH_PRINT_SEED + its index in name order}; a DTensor's is that
    of the whole tensor (each device its own shard of the gaussian)."""
    import torch

    from repro_torch.distributed import sharding as SH

    out = {}
    for i, name in enumerate(sorted(tensors)):
        t = tensors[name].detach()
        gen = torch.Generator(device=dev).manual_seed(MESH_PRINT_SEED + i)
        r = torch.randn(tuple(t.shape), generator=gen, device=dev)
        if SH.is_dtensor(t):
            r = SH.shard(r, SH.spec_of(t.placements, t.ndim, t.device_mesh),
                         t.device_mesh)
        out[name] = _whole(torch.sum(t.float() * r))
    return out


def _whole(x) -> float:
    from repro_torch.distributed import sharding as SH

    return float(x.full_tensor() if SH.is_dtensor(x) else x)


def _leaf_prints(params: dict, moments: dict, before: dict, dev) -> dict:
    """Per leaf after step 0: the first moment's norm and projection, and
    the update's projection (`before` holds the parameters'
    projections before the step)."""
    import torch

    m_proj = _projections(moments, dev)
    p_proj = _projections(params, dev)
    return {n: {"m_norm": math.sqrt(_whole(torch.sum(moments[n] ** 2))),
                "m_proj": m_proj[n], "update_proj": p_proj[n] - before[n]}
            for n in sorted(params)}


def _mesh_train(rank: int, dev, job: dict) -> dict:
    """`job["steps"]` steps of `make_train_step(mesh=...)` (each step's
    ms, loss, grad_norm, flash launches; every flash call of step 0 and
    the first of each later one held against the plain version on the
    same local q, k, v; the leaves' prints after step 0), then one step
    under the profiler and the collective counter (device busy, bytes
    sent)."""
    import torch

    from repro_torch.distributed import trace_analysis as TA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import steps as ST
    from repro_torch.models import attention as ATT
    from repro_torch.optim import adamw

    mesh = MESH.make_host_mesh(model=job["model"], device=dev)
    cfg, model = _mesh_model(job["layers"], job["seed"], dev)
    model = ST.shard_params(model, mesh)
    opt = adamw.init(dict(model.named_parameters()))
    step = ST.make_train_step(cfg, adamw.AdamWConfig(
        warmup_steps=10, total_steps=TRAIN_STEPS_LM), mesh)
    batches = _lm_batches(cfg, job["seed"], dev, job["steps"] + 1)
    shapes, calls, flash_err, checking = set(), [0], [], [True]
    plain = ATT.flash_attention

    per_step = job["layers"] * FLASH_CALLS_A_LAYER

    def spy(q, k, v, causal=True):
        shapes.add((tuple(q.shape), tuple(k.shape)))
        out = plain(q, k, v, causal=causal)
        # every forward call of step 0, the first call of each later step
        if checking[0] and (calls[0] < job["layers"]
                            or calls[0] % per_step == 0):
            flash_err.append(_flash_diff(
                out, FA.flash_attention_plain(q, k, v, causal)))
        calls[0] += 1
        return out

    ATT.flash_attention = spy
    before = _projections(dict(model.named_parameters()), dev)
    _sync(dev)
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launches()
    ms, losses, norms, launches, routed = [], [], [], [], []
    prints = None
    for i in range(job["steps"]):
        t0 = time.perf_counter()
        model, opt, metrics = step(model, opt, batches[i])
        losses.append(float(metrics["loss"]))      # synchronises
        norms.append(float(metrics["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(dict(FA.launches))
        routed.append(calls[0])
        if i == 0:
            prints = _leaf_prints(dict(model.named_parameters()), opt.m,
                                  before, dev)
    checking[0] = False
    res = {"rank": rank, "ms_per_step": ms, "loss": losses,
           "grad_norm": norms, "launches": launches, "flash_calls": routed,
           "flash_shapes": sorted(shapes), "flash_checked": len(flash_err),
           "flash_max_err": max(flash_err), "prints": prints,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "placements": {n: [str(pl) for pl in p.placements]
                          for n, p in list(model.named_parameters())[:4]}}
    if job.get("digest"):
        res["digest"] = _digest([p.full_tensor() for _, p in sorted(
            model.named_parameters())])
    warm = statistics.median(ms[1:]) if len(ms) > 1 else ms[0]
    counted = {}

    def traced_step():
        counted["costs"] = TA.trace(lambda: step(model, opt,
                                                 batches[job["steps"]]))

    res.update(_device_breakdown(traced_step, warm,
                                 (("flash_kernel_ms", "flash_attention"),
                                  ("nccl_or_copy_ms", "Memcpy"))))
    costs = counted["costs"]
    res["sent_bytes_per_step"] = dict(costs.per_kind,
                                      total=costs.coll_bytes)
    res["collective_ops_per_step"] = costs.op_counts
    ATT.flash_attention = plain
    return res


def _seq_rules():
    """The sharding rules of phase 16 (e) and 17 (g), (h): the defaults
    with the heads and kv heads unsplit."""
    from repro_torch.distributed import sharding as SH

    return SH.ShardingRules(dict(SH.DEFAULT_RULES, **SEQ_RULES))


def _seq_model(seed: int, dev):
    """mamba2-130m at full width and depth (bf16), its random weights from
    the port's init on `dev`."""
    import torch

    from repro_torch.configs import registry as R
    from repro_torch.models import transformer as T

    cfg = R.get_arch(SSM_ARCH)
    return cfg, T.init_model(cfg, torch.Generator(device=dev).manual_seed(
        seed + 5))


def _seq_batches(cfg, seed: int, dev, n: int) -> list:
    from repro_torch.data.synthetic import TokenStream

    data = TokenStream(cfg.vocab, SEQ_TRAIN_SEQ, SEQ_TRAIN_BATCH, seed)
    return [data.batch_at(i, dev) for i in range(n)]


def _seq_one_device_step(seed: int, dev) -> dict:
    """(e)'s one-device step 0: loss and grad_norm."""
    import torch

    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw

    cfg, model = _seq_model(seed, dev)
    opt = adamw.init(dict(model.named_parameters()))
    step = ST.make_train_step(cfg, adamw.AdamWConfig(
        warmup_steps=10, total_steps=TRAIN_STEPS_LM))
    _, _, metrics = step(model, opt, _seq_batches(cfg, seed, dev, 1)[0])
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"])}
    del model, opt
    torch.cuda.empty_cache()
    return out


def _seq_spies():
    """Count the sequence-split routes as they run: the SSD scan by
    chunks (`mamba2._scan_by_chunks`), attention on a device's query
    rows (`attention._query_rows` naming an axis), and in_proj as one
    product per piece on the columns of an axis (`mamba2._in_proj_pieces`:
    mamba2-130m's decode, zamba2's prefill).  Returns the counts and an
    undo."""
    from repro_torch.models import attention as ATT
    from repro_torch.models import mamba2 as M2

    counts = {"scan_by_chunks": 0, "query_rows": 0, "in_proj_pieces": 0}
    scan, rows, pieces = (M2._scan_by_chunks, ATT._query_rows,
                          M2._in_proj_pieces)

    def scan_spy(*a, **kw):
        counts["scan_by_chunks"] += 1
        return scan(*a, **kw)

    def rows_spy(*a, **kw):
        out = rows(*a, **kw)
        counts["query_rows"] += out is not None
        return out

    def pieces_spy(*a, **kw):
        counts["in_proj_pieces"] += 1
        return pieces(*a, **kw)

    M2._scan_by_chunks, ATT._query_rows = scan_spy, rows_spy
    M2._in_proj_pieces = pieces_spy

    def undo():
        M2._scan_by_chunks, ATT._query_rows = scan, rows
        M2._in_proj_pieces = pieces

    return counts, undo


def _seq_train(rank: int, dev, job: dict) -> dict:
    """(e): `job["steps"]` steps of `make_train_step(mesh=...)` on
    mamba2-130m under `_seq_rules()` (each step's ms, loss, grad_norm and
    the sequence-split routes taken), then one more step under the
    collective counter (bytes sent a step)."""
    import torch

    from repro_torch.distributed import trace_analysis as TA
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw

    mesh = MESH.make_host_mesh(model=job["model"], device=dev)
    rules = _seq_rules()
    cfg, model = _seq_model(job["seed"], dev)
    model = ST.shard_params(model, mesh, rules)
    opt = adamw.init(dict(model.named_parameters()))
    step = ST.make_train_step(cfg, adamw.AdamWConfig(
        warmup_steps=10, total_steps=TRAIN_STEPS_LM), mesh, rules=rules)
    batches = _seq_batches(cfg, job["seed"], dev, job["steps"] + 1)
    counts, undo = _seq_spies()
    _sync(dev)
    torch.cuda.reset_peak_memory_stats()
    ms, losses, norms = [], [], []
    try:
        for i in range(job["steps"]):
            t0 = time.perf_counter()
            model, opt, metrics = step(model, opt, batches[i])
            losses.append(float(metrics["loss"]))      # synchronises
            norms.append(float(metrics["grad_norm"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        routes = dict(counts)
        costs = TA.trace(lambda: step(model, opt, batches[job["steps"]]))
    finally:
        undo()
    return {"rank": rank, "ms_per_step": ms, "loss": losses,
            "grad_norm": norms, "routes": routes,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "sent_bytes_per_step": dict(costs.per_kind,
                                        total=costs.coll_bytes),
            "collective_ops_per_step": costs.op_counts}


def _hold_seq_train(what: str, ranks: list, want: dict, layers: int
                    ) -> dict:
    """(e): every rank scanned every layer by chunks in each forward and
    its recompute (remat "nothing"); the ranks' losses equal, finite; step
    0 within MESH_LOSS_REL / MESH_GNORM_REL of the one-device step."""
    for r in ranks:
        expect = len(r["loss"]) * layers * FLASH_CALLS_A_LAYER
        if r["routes"]["scan_by_chunks"] != expect:
            raise AssertionError(f"{what} rank {r['rank']}: routes "
                                 f"{r['routes']}, expected {expect} scans "
                                 f"by chunks")
    if any(r["loss"] != ranks[0]["loss"] for r in ranks) or not all(
            math.isfinite(x) for r in ranks for x in r["loss"]
            + r["grad_norm"]):
        raise AssertionError(f"{what}: the ranks' losses differ or are not "
                             f"finite: {[r['loss'] for r in ranks]}")
    loss_rel = abs(ranks[0]["loss"][0] - want["loss"]) / abs(want["loss"])
    gnorm_rel = (abs(ranks[0]["grad_norm"][0] - want["grad_norm"])
                 / want["grad_norm"])
    out = {"loss_rel": loss_rel, "grad_norm_rel": gnorm_rel, "want": want,
           "routes": ranks[0]["routes"]}
    log(f"{what}: step 0 loss {ranks[0]['loss'][0]} against one device "
        f"{want['loss']} (rel {loss_rel:.3g}, limit {MESH_LOSS_REL}), "
        f"grad_norm {ranks[0]['grad_norm'][0]} against {want['grad_norm']} "
        f"(rel {gnorm_rel:.3g}, limit {MESH_GNORM_REL}); routes a rank "
        f"{ranks[0]['routes']}; ms a step "
        f"{[r['ms_per_step'] for r in ranks]}; bytes sent a step per rank "
        f"{[r['sent_bytes_per_step']['total'] for r in ranks]}")
    if loss_rel > MESH_LOSS_REL or gnorm_rel > MESH_GNORM_REL:
        raise AssertionError(f"{what}: step 0 outside ({MESH_LOSS_REL}, "
                             f"{MESH_GNORM_REL}) of the one-device step")
    return out


def _spawn_mesh(job: dict, world: int, backend: str, tmp: str,
                target=None, what: str = "phase 16") -> list:
    """Start `world` ranks of `job` (`target`, default phase 16's
    `_mesh_rank`), join them by a deadline, stop any still alive; raise
    unless every rank exited 0."""
    import multiprocessing as mp

    import torch

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target or _mesh_rank,
                         args=(r, world, backend, tmp, job))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    log(f"{what} {job['name']}: {backend} x {world} ranks exited {codes} "
        f"in {time.perf_counter() - t0:.1f} s")
    if hung or any(c != 0 for c in codes):
        raise AssertionError(f"{what} {job['name']}: ranks failed, exit "
                             f"codes {codes}, hung {hung}")
    return [torch.load(f"{tmp}/{job['name']}-rank{r}.pt", weights_only=False)
            for r in range(world)]


def _one_device_step(layers: int, seed: int, dev) -> dict:
    """The one-device step 0 of `_mesh_model(layers)` on batch 0: loss,
    grad_norm, a digest of the updated parameters and the leaves'
    prints, with each update's norm beside them."""
    import torch

    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw

    cfg, model = _mesh_model(layers, seed, dev)
    opt = adamw.init(dict(model.named_parameters()))
    step = ST.make_train_step(cfg, adamw.AdamWConfig(
        warmup_steps=10, total_steps=TRAIN_STEPS_LM))
    batch = _lm_batches(cfg, seed, dev, 1)[0]
    named = dict(model.named_parameters())
    before = _projections(named, dev)
    start = {n: p.detach().clone() for n, p in named.items()}
    model, opt, metrics = step(model, opt, batch)
    named = dict(model.named_parameters())
    prints = _leaf_prints(named, opt.m, before, dev)
    for n, p in named.items():
        prints[n]["update_norm"] = float(torch.linalg.vector_norm(
            p.detach().float() - start[n].float()))
    out = {"loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "digest": _digest([p for _, p in sorted(named.items())]),
           "prints": prints}
    del model, opt, batch, named, start
    torch.cuda.empty_cache()
    return out


def _leaf_gaps(got: dict, want: dict) -> dict:
    """Per leaf, the relative gaps of `got`'s prints from the one-device
    `want`'s: the first moment's norm and projection against its norm,
    the update's projection against the update's norm."""
    out = {}
    for n, w in want.items():
        g = got[n]
        m = max(w["m_norm"], 1e-30)
        out[n] = {"grad": max(abs(g["m_norm"] - w["m_norm"]),
                              abs(g["m_proj"] - w["m_proj"])) / m,
                  "update": abs(g["update_proj"] - w["update_proj"])
                  / max(w["update_norm"], 1e-30)}
    return out


def _hold_mesh(what: str, ranks: list, want: dict, layers: int,
               local_shapes: tuple) -> dict:
    """Every rank: exactly 2 x `layers` flash calls a step (each forward
    and its recompute), each a launch of the tensor-core kernel, at
    `local_shapes`, the checked ones within
    FLASH_BF16_TOL of the plain version; the ranks' losses and prints
    equal; step 0 against the one-device `want` within MESH_LOSS_REL /
    MESH_GNORM_REL and, per leaf, MESH_GRAD_LEAF_REL /
    MESH_UPDATE_LEAF_REL."""
    for r in ranks:
        for i, got in enumerate(r["launches"]):
            n = (i + 1) * layers * FLASH_CALLS_A_LAYER
            expect = {"flash_attention": n, "flash_attention_wgmma": n}
            if {key: got.get(key, 0) for key in expect} != expect \
                    or r["flash_calls"][i] != n:
                raise AssertionError(f"{what} rank {r['rank']}: launches "
                                     f"{got}, {r['flash_calls'][i]} calls "
                                     f"after step {i}, expected {expect}, "
                                     f"{n}")
        if r["flash_shapes"] != [local_shapes]:
            raise AssertionError(f"{what} rank {r['rank']}: flash shapes "
                                 f"{r['flash_shapes']}, expected "
                                 f"{[local_shapes]}")
        if r["flash_checked"] != layers + len(r["launches"]) - 1:
            raise AssertionError(f"{what} rank {r['rank']}: "
                                 f"{r['flash_checked']} flash calls held "
                                 f"against the plain version")
    if any(r["loss"] != ranks[0]["loss"] or r["prints"] != ranks[0]["prints"]
           for r in ranks):
        raise AssertionError(f"{what}: the ranks' losses or prints differ: "
                             f"{[r['loss'] for r in ranks]}")
    loss_rel = abs(ranks[0]["loss"][0] - want["loss"]) / abs(want["loss"])
    gnorm_rel = (abs(ranks[0]["grad_norm"][0] - want["grad_norm"])
                 / want["grad_norm"])
    gaps = _leaf_gaps(ranks[0]["prints"], want["prints"])
    worst = {k: max(gaps, key=lambda n: gaps[n][k])
             for k in ("grad", "update")}
    out = {"loss_rel": loss_rel, "grad_norm_rel": gnorm_rel,
           "flash_max_err": max(r["flash_max_err"] for r in ranks),
           "leaf_grad_rel": [worst["grad"], gaps[worst["grad"]]["grad"]],
           "leaf_update_rel": [worst["update"],
                               gaps[worst["update"]]["update"]],
           "leaf_grad_rel_median": statistics.median(
               g["grad"] for g in gaps.values()),
           "leaf_update_rel_median": statistics.median(
               g["update"] for g in gaps.values()),
           "want": {k: want[k] for k in ("loss", "grad_norm")}}
    log(f"{what}: {sum(r['flash_checked'] for r in ranks)} flash calls on "
        f"the ranks' local heads within {out['flash_max_err']:.3g} of the "
        f"plain version (tolerance {FLASH_BF16_TOL} abs); step 0 loss "
        f"{ranks[0]['loss'][0]} against one device {want['loss']} (rel "
        f"{loss_rel:.3g}), grad_norm {ranks[0]['grad_norm'][0]} against "
        f"{want['grad_norm']} (rel {gnorm_rel:.3g}); per leaf, the worst "
        f"gradient {out['leaf_grad_rel']} (median "
        f"{out['leaf_grad_rel_median']:.3g}), the worst update "
        f"{out['leaf_update_rel']} (median "
        f"{out['leaf_update_rel_median']:.3g})")
    if not all(math.isfinite(x) for r in ranks for x in r["loss"]
               + r["grad_norm"]):
        raise AssertionError(f"{what}: non-finite loss or grad_norm")
    if loss_rel > MESH_LOSS_REL or gnorm_rel > MESH_GNORM_REL:
        raise AssertionError(f"{what}: step 0 outside ({MESH_LOSS_REL}, "
                             f"{MESH_GNORM_REL}) of the one-device step")
    bad = {n: g for n, g in gaps.items() if g["grad"] > MESH_GRAD_LEAF_REL
           or g["update"] > MESH_UPDATE_LEAF_REL}
    if bad:
        raise AssertionError(f"{what}: {len(bad)} leaves outside "
                             f"({MESH_GRAD_LEAF_REL}, {MESH_UPDATE_LEAF_REL})"
                             f" of the one-device step: {bad}")
    return out


def _dryrun_cell(device_note: str, cell=DRYRUN_CELL,
                 ref: dict | None = None) -> dict:
    """(d) one dry-run cell in a subprocess (a fake 256-rank world on
    the host; no card): its row, its temp bytes against the reference's
    (REF_DRYRUN_TEMP_BYTES, or `ref`'s, whose FLOPs and collective bytes
    are set beside the port's too), and its argument plus temp bytes,
    which must stay below the card's memory."""
    import tempfile

    import torch

    arch, shape = cell
    ref = ref or {"temp_bytes": REF_DRYRUN_TEMP_BYTES}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "cell.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", str(out)],
            capture_output=True, text=True, env=env,
            timeout=DRYRUN_TIMEOUT_S)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 16 (d): the dry run exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        row = json.loads(out.read_text())[0]
    r = row["roofline"]
    if row["status"] != "ok" or not r["hlo_flops"] > 0 or r[
            "bottleneck"] not in ("compute", "memory", "collective"):
        raise AssertionError(f"phase 16 (d): {row}")
    mem = row["memory"]
    card = torch.cuda.get_device_properties(0).total_memory
    res = {"cell": f"{arch}/{shape} 16x16", "wall_s": wall,
           "trace_s": row["trace_s"], "memory": mem,
           "temp_vs_reference": mem["temp_bytes"] / ref["temp_bytes"],
           "vs_reference": {k: (mem if k == "temp_bytes" else r)[k] / v
                            for k, v in ref.items()},
           "card_bytes": card,
           "flops_per_device": r["hlo_flops"],
           "bytes_per_device": r["hlo_bytes"],
           "coll_bytes": r["coll_bytes"], "bottleneck": r["bottleneck"],
           "roofline_fraction": r["roofline_fraction"]}
    log(f"phase 16 (d) dry-run cell ({device_note}, analytic H100 "
        f"constants): {json.dumps(res)}")
    if mem["argument_bytes"] + mem["temp_bytes"] >= card:
        raise AssertionError(f"phase 16 (d): argument + temp bytes "
                             f"{mem['argument_bytes'] + mem['temp_bytes']} "
                             f"do not fit the card's {card}")
    return res


def mesh_train_path(seed: int, smi: str, one_device: dict) -> dict:
    """Phase 16: granite-3-2b trained on a DeviceMesh: (a) two gloo ranks
    on the card, data 1 x model 2, full width and depth; (b) data 2 x
    model 1 at 8 of its 40 layers; (c) one NCCL rank, 1 x 1, bitwise the
    one-device step; (e) mamba2-130m at full width and depth, data 1 x
    model 2 under `_seq_rules()` (the sequence split on "model" through
    every block); (d) two dry-run cells (granite-3-2b train_4k,
    mamba2-130m prefill_32k).  Each is held against the one-device step
    0 of its depth, run here first; `one_device` is phase 15 (d)'s
    record, whose step 0 the one at full depth repeats."""
    import gc
    import tempfile

    import torch

    dev = torch.device(DEVICE, 0)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seconds": {}}
    part = time.perf_counter()
    from repro_torch.configs import registry as R

    cfg = R.get_arch(TRAIN_ARCH)
    ref = {n: _one_device_step(n, seed, dev)
           for n in (cfg.n_layers, MESH_DP_LAYERS)}
    for n, r in ref.items():
        log(f"phase 16: one-device step 0 at {n} layers: loss "
            f"{r['loss']}, grad_norm {r['grad_norm']}, digest "
            f"{r['digest']}")
    full = ref[cfg.n_layers]
    if (abs(full["loss"] - one_device["loss"][0]) > MESH_LOSS_REL
            * abs(one_device["loss"][0])
            or abs(full["grad_norm"] - one_device["grad_norm"][0])
            > MESH_GNORM_REL * one_device["grad_norm"][0]):
        raise AssertionError(f"phase 16: the one-device step 0 {full} is "
                             f"not phase 15 (d)'s {one_device['loss'][0]}, "
                             f"{one_device['grad_norm'][0]}")
    out["seconds"]["one_device"] = time.perf_counter() - part
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, s = TRAIN_BATCH_LM, TRAIN_SEQ
    with tempfile.TemporaryDirectory() as tmp:
        # (a) tensor parallel over 2 ranks at full width and depth
        part = time.perf_counter()
        job = dict(name="a", model=MESH_RANKS, layers=cfg.n_layers,
                   seed=seed, steps=MESH_STEPS)
        ranks = _spawn_mesh(job, MESH_RANKS, "gloo", tmp)
        out["a"] = _hold_mesh(
            "phase 16 (a) data 1 x model 2", ranks, full, job["layers"],
            ((b, h // MESH_RANKS, s, hd), (b, kv // MESH_RANKS, s, hd)))
        out["a"]["ranks"] = ranks
        out["seconds"]["a"] = time.perf_counter() - part
        # (b) data parallel (FSDP on the embed axes) at 8 layers
        part = time.perf_counter()
        job = dict(name="b", model=1, layers=MESH_DP_LAYERS, seed=seed,
                   steps=MESH_STEPS)
        ranks = _spawn_mesh(job, MESH_RANKS, "gloo", tmp)
        out["b"] = _hold_mesh(
            "phase 16 (b) data 2 x model 1", ranks, ref[MESH_DP_LAYERS],
            MESH_DP_LAYERS,
            ((b // MESH_RANKS, h, s, hd), (b // MESH_RANKS, kv, s, hd)))
        out["b"]["ranks"] = ranks
        out["seconds"]["b"] = time.perf_counter() - part
        # (c) one NCCL rank: the mesh path bitwise the one-device step
        part = time.perf_counter()
        job = dict(name="c", model=1, layers=MESH_DP_LAYERS, seed=seed,
                   steps=1, digest=True)
        (rank,) = _spawn_mesh(job, 1, "nccl", tmp)
        want = {k: ref[MESH_DP_LAYERS][k]
                for k in ("loss", "grad_norm", "digest", "prints")}
        want["prints"] = {n: {k: v for k, v in p.items()
                              if k != "update_norm"}
                          for n, p in want["prints"].items()}
        got = {"loss": rank["loss"][0], "grad_norm": rank["grad_norm"][0],
               "digest": rank["digest"], "prints": rank["prints"]}
        if got["digest"] != want["digest"] or got["loss"] != want["loss"] \
                or got["grad_norm"] != want["grad_norm"]:
            raise AssertionError(f"phase 16 (c): the 1 x 1 mesh step "
                                 f"{got} is not bitwise the one-device "
                                 f"step {want}")
        log(f"phase 16 (c) nccl 1 x 1: loss, grad_norm and updated "
            f"parameters bitwise the one-device step's; the leaves' prints "
            f"{'equal' if got['prints'] == want['prints'] else 'differ'}")
        out["c"] = {"ranks": [rank], "bitwise": True}
        out["seconds"]["c"] = time.perf_counter() - part
        # (e) mamba2-130m, heads unsplit: the sequence split on "model"
        part = time.perf_counter()
        want = _seq_one_device_step(seed, dev)
        log(f"phase 16 (e): one-device step 0 of {SSM_ARCH}: {want}")
        job = dict(name="e", seq=True, model=MESH_RANKS, seed=seed,
                   steps=MESH_STEPS)
        ranks = _spawn_mesh(job, MESH_RANKS, "gloo", tmp)
        out["e"] = _hold_seq_train(
            f"phase 16 (e) {SSM_ARCH} data 1 x model 2, heads unsplit",
            ranks, want, R.get_arch(SSM_ARCH).n_layers)
        out["e"]["ranks"] = ranks
        out["seconds"]["e"] = time.perf_counter() - part
    part = time.perf_counter()
    out["d"] = _dryrun_cell(f"torch {torch.__version__}")
    out["d_seq"] = _dryrun_cell(f"torch {torch.__version__}",
                                SEQ_DRYRUN_CELL, SEQ_DRYRUN_REF)
    out["seconds"]["d"] = time.perf_counter() - part
    flash = sum(r["launches"][-1]["flash_attention"]
                for p in "abc" for r in out[p]["ranks"])
    out["launches"] = {"flash_attention": flash}
    perf = {p: {"ms_per_step": [r["ms_per_step"] for r in out[p]["ranks"]],
                "loss": out[p]["ranks"][0]["loss"],
                "grad_norm": out[p]["ranks"][0]["grad_norm"],
                "peak_mem_gb": [r["peak_mem_gb"] for r in out[p]["ranks"]],
                "device_busy_ms": [r.get("device_busy_ms")
                                   for r in out[p]["ranks"]],
                "idle_share": [r.get("idle_share")
                               for r in out[p]["ranks"]],
                "flash_kernel_ms": [r.get("flash_kernel_ms")
                                    for r in out[p]["ranks"]],
                "flash_max_err": [r["flash_max_err"]
                                  for r in out[p]["ranks"]],
                "sent_bytes_per_step": [r["sent_bytes_per_step"]
                                        for r in out[p]["ranks"]],
                "collective_ops_per_step": out[p]["ranks"][0][
                    "collective_ops_per_step"]}
            for p in "abc"}
    for p in "ab":
        perf[p].update({k: out[p][k] for k in (
            "loss_rel", "grad_norm_rel", "leaf_grad_rel",
            "leaf_grad_rel_median", "leaf_update_rel",
            "leaf_update_rel_median")})
    perf["e"] = {k: [r[k] for r in out["e"]["ranks"]] for k in (
        "ms_per_step", "loss", "grad_norm", "peak_mem_gb",
        "sent_bytes_per_step")}
    perf["e"].update({k: out["e"][k] for k in ("loss_rel", "grad_norm_rel",
                                               "routes")})
    log(f"phase 16 ({smi}): {json.dumps(perf)}")
    log(f"phase 16 seconds: {json.dumps(out['seconds'])}")
    out["perf"] = perf
    return out


# ---------------------------------------------------------------------------
# phase 17: LM serving on a DeviceMesh
# ---------------------------------------------------------------------------

SERVE_SHORT_LAYERS = 8          # (b)-(f): the first 8 layers
# Every step's logits of a meshed bf16 server against the one-device
# model fed the meshed run's own tokens (teacher-forced).  The meshed
# function is the same, but each row-parallel product (wo and mlp_wo of
# every layer) rounds each rank's partial sum to bf16 before the two are
# added, and data parallel runs every product at half the rows (another
# cuBLAS tiling): each layer adds up to a bf16 rounding of its output to
# the residual.  Logits are O(1) to O(8), where a bf16 ulp is 2^-7 to
# 2^-4.  Measured on an H100 at --seed 0: (a) 0.0625, (b) 0.03125, (c)
# 0.03516 at most over 16 steps x 4 rows; the limit is 2 to 4 times
# that.  The planted faults of (a) move the prefill logits by 1.41 (every
# row-parallel product keeps one rank's partial sum) and 0.306 (every
# wq holds the other rank's heads): the random weights' layers add
# little to a residual their embedding dominates, so a fault anywhere
# but the logits moves them by tenths.
# (e) and (f), granite-moe at 8 layers, are held with the one-device
# routing pinned to the meshed run's (top-k flips at bf16 resolution move
# their logits by 2.2-2.5 otherwise).  The random expert stacks (init
# scale E^-0.5) give expert outputs near 16, where a bf16 ulp is 2^-3,
# so each layer's rounding moves the residual more than a dense layer's:
# measured on an H100 at --seed 0, (e) 0.1406 at most (prefill 0.0313,
# the straddling decode steps 0.094-0.141) and (f), expert parallel with
# whole groups (the path that predates the straddling split), 0.1445,
# logits up to 5.34 (a bf16 ulp 2^-5).  The limit is 1.7 times that.
# (g) whisper-tiny and (h) mamba2-130m at full width, data 1 x model 2
# under `_seq_rules()` (heads unsplit): the sequence stays split on
# "model" through every block (each rank's query rows, its chunks), so
# no partial sum is rounded before it is added: each product runs the
# same rows at half the count (another cuBLAS tiling), the attention's
# rows see the whole k / v, and the scan folds the other rank's f32
# summaries in.  Measured on an H100 at --seed 0: (g) 0.03125 at most
# (one bf16 ulp of logits up to 4.94); (h) prefill 0.0156, then the
# decode steps 0.055-0.125 (logits up to 4.84): the prefill's bf16
# roundings enter the SSM state and conv window, which every later
# step reads (24 layers).  (g) is held to the dense limit, 4 times its
# reading; (h) to 2 times its reading.  Since its decode step is
# divided over "model" (out_proj's partial sums rounded to bf16 before
# they are added), (h) read 0.1016 at most.  (i) zamba2-2.7b at 6
# layers, data 1 x model 2, its 80 heads split: each rank scans its
# heads and adds out_proj's bf16 partial sums, and the prefill's
# roundings enter the SSM states and conv windows every decode step
# reads; measured on an H100 at --seed 0: 0.1006 at most (the prefill;
# decode steps 0.047-0.082, logits up to 4.97), held to 2.5 times its
# reading, (h)'s limit.
MESH_SERVE_TOL = {"a": 0.125, "b": 0.125, "c": 0.125, "e": 0.25,
                  "f": 0.25, "g": 0.125, "h": 0.25, "i": 0.25}
# (h): a rank's decode FLOPs over one device's.  Every product of
# mamba2-130m's decode step splits evenly on model 2 (in_proj's pieces
# 1536 / 1536 / 128 / 128 / 24 columns, out_proj's 1536 rows, the 24
# heads of the state, the 50280-wide vocab), so each rank does half;
# the elementwise ops count no FLOPs.  The band allows a 1 % slack.
MESH_DECODE_FLOP_SHARE = (0.495, 0.505)
# (i): zamba2-2.7b at full width, one shared-attention group (6 of 54
# layers), data 1 x model 2 (its 80 heads on "model"), 4 prompts of
# 1024 tokens: 4096 rows a rank at prefill, more than the 3840 weight
# rows its in_proj pieces gather (2560 + 2560 / 2), so in_proj runs one
# product per piece on the heads' columns (`mamba2._in_proj_pieces`);
# at decode (4 rows) the output is gathered.
HYBRID_MESH_LAYERS = 6
HYBRID_MESH_PROMPT = 1024


def _serve_rank(rank: int, world: int, backend: str, tmp: str,
                job: dict) -> None:
    """One spawned rank of phase 17: join the group, run each of
    `job["runs"]` on the card, save their results."""
    import faulthandler
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    dev = torch.device("cuda", 0)                  # both on the one card
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{tmp}/store-{job['name']}",
        rank=rank, world_size=world,
        timeout=timedelta(seconds=SHARD_GROUP_TIMEOUT_S))
    try:
        res = [_mesh_serve(rank, dev, run, tmp) for run in job["runs"]]
        torch.save(res, f"{tmp}/{job['name']}-rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _serve_mesh_model(run: dict, tmp: str, dev):
    """granite-3-2b (or `run["arch"]`) at full width with `run["layers"]`
    layers, bf16, from the port's init seeded as phase 6's; or, for a C3
    run, the quantized leaves the parent saved."""
    import dataclasses

    import torch

    from repro_torch.configs import registry as R
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(R.get_arch(run.get("arch", LM_ARCH)),
                              n_layers=run["layers"])
    if not run.get("c3"):
        return cfg, T.init_model(cfg, torch.Generator(device=dev).manual_seed(
            run["seed"]))
    leaves = torch.load(f"{tmp}/c3.pt", weights_only=True)
    to = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
              else v.to(dev)) for k, v in leaves.items()}
    return (dataclasses.replace(cfg, quant_serving=True),
            T.model_from(cfg, to))


def _teacher_forced(cfg, model, batch: dict, tokens: list,
                    cache: int = LM_CACHE) -> list:
    """The one-device model's logits of every step of a served run: its
    prefill over `batch`, then one decode step per emitted token but the
    last (the meshed run's own tokens)."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.quant.lm_quant import make_param_transform

    pt = make_param_transform(cfg.dtype) if cfg.quant_serving else None
    logits, state = T.forward_prefill(model, cfg, batch, cache,
                                      param_transform=pt)
    out = [logits.float()]
    for tok in tokens[:-1]:
        logits, state = T.forward_decode(
            model, cfg, state, tok.to(torch.int32)[:, None],
            param_transform=pt)
        out.append(logits.float())
    return out


def _gaps(got: list, want: list) -> dict:
    """Per step, the max |logit difference| of two runs' logits, and
    the rows whose greedy token differs with the one-device top-2 gap."""
    diffs, flips, gaps, tops = [], [], [], []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if g.shape != w.shape or not bool(g.isfinite().all()):
            raise AssertionError(f"phase 17: bad logits {tuple(g.shape)}")
        diffs.append(float((g - w).abs().max()))
        tops.append(float(w.abs().max()))
        top2 = w.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        gaps.append(float(gap.min()))
        flips.extend(float(x) for x in gap[g.argmax(-1) != w.argmax(-1)])
    return {"diffs": diffs, "flip_gaps": flips, "min_gaps": gaps,
            "max_abs": max(tops)}


def _mesh_serve(rank: int, dev, run: dict, tmp: str) -> dict:
    """One served run on a ("data", "model") mesh of `run["model"]`: a
    warm-up request batch, then phase 6's first 4 prompts, 16 new tokens
    each, with every LM launch count from 0 just before it and read just
    after (the first flash call and the first codebook call of each
    local shape held against their plain versions); one more decode
    step profiled and its collectives counted; (a) the planted faults'
    prefill; then the one-device model on the run's own tokens."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import trace_analysis as TA
    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import attention as ATT
    from repro_torch.serve.server import Request, Server

    mesh = MESH.make_host_mesh(model=run["model"], device=dev)
    cfg, model = _serve_mesh_model(run, tmp, dev)
    cache = run.get("cache", LM_CACHE)
    prompts = _prompts(run["seed"], cfg.vocab,
                       run.get("prompt", LM_PROMPT))[:LM_SLOTS]
    batch = {"tokens": torch.as_tensor(np.stack(prompts), device=dev)}
    if cfg.family == "audio":               # the server's stub frames
        batch["frames"] = torch.zeros((LM_SLOTS, cfg.enc_frames,
                                       cfg.d_model), device=dev)
    srv = Server(cfg, model, batch_slots=LM_SLOTS, cache_len=cache,
                 mesh=mesh, rules=(_seq_rules() if run.get("seq")
                                   else SH.ShardingRules()))
    del model
    timed = {"prefill": [], "decode": []}
    last = {}

    def clocked(fn, key):
        def call(*args, **kw):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync(dev)
            timed[key].append((time.perf_counter() - t0) * 1e3)
            last["state"] = out[1]
            return out
        return call

    prefill, decode = srv.prefill, srv.decode
    srv.prefill = clocked(prefill, "prefill")
    srv.decode = clocked(decode, "decode")
    flash, kernel = ATT.flash_attention, CBM.codebook_matmul
    seen = {"flash": [], "flash_err": [], "codebook": {}, "cb_err": []}

    def flash_spy(q, k, v, causal=True):
        out = flash(q, k, v, causal=causal)
        if seen["on"]:
            if not seen["flash"]:
                seen["flash_err"].append(_flash_diff(
                    out, FA.flash_attention_plain(q, k, v, causal)))
            seen["flash"].append((tuple(q.shape), tuple(k.shape)))
        return out

    def codebook_spy(x, idx, cb):
        out = kernel(x, idx, cb)
        if seen["on"]:
            key = (x.shape[0], idx.shape[0], idx.shape[1])
            if key not in seen["codebook"]:
                seen["cb_err"].append(_assert_close(
                    f"phase 17 codebook_matmul {key}", out,
                    _exact_product(x, CBM.dequantize(idx, cb))))
            seen["codebook"][key] = seen["codebook"].get(key, 0) + 1
        return out

    seen["on"] = False
    ATT.flash_attention, CBM.codebook_matmul = flash_spy, codebook_spy
    routes_taken, undo = _seq_spies()
    try:
        for uid, p in enumerate(prompts):                   # warm up
            srv.submit(Request(uid=uid, prompt=p, max_new_tokens=2))
        srv.run()
        timed = {"prefill": [], "decode": []}
        logits, tokens = [], []

        def sample(lg):
            logits.append(lg.float())
            tokens.append(lg.argmax(-1))
            return tokens[-1]

        for uid, p in enumerate(prompts):
            srv.submit(Request(uid=uid, prompt=p, max_new_tokens=LM_NEW))
        _sync(dev)
        torch.cuda.reset_peak_memory_stats()
        FA.reset_launches()
        CBM.reset_launches()
        seen["on"] = True
        routes = []
        routes_taken.update(dict.fromkeys(routes_taken, 0))
        t0 = time.perf_counter()
        done = _dispatching(_recorder(routes), lambda: srv.run(
            sample=sample)) if cfg.family == "moe" else srv.run(sample=sample)
        _sync(dev)
        wall = time.perf_counter() - t0
        seen["on"] = False
        launches = {**FA.launches, **CBM.launches}
        seq_routes = dict(routes_taken)
    finally:
        ATT.flash_attention, CBM.codebook_matmul = flash, kernel
        undo()
    res = {"rank": rank, "launches": launches,
           "flash_shapes": sorted(set(seen["flash"])),
           "flash_calls": len(seen["flash"]),
           "flash_max_err": max(seen["flash_err"], default=0.0),
           "codebook_calls": {"x".join(map(str, k)): n
                              for k, n in seen["codebook"].items()},
           "codebook_max_err": max(seen["cb_err"], default=0.0),
           "out_tokens": [r.out_tokens for r in done],
           "tokens_per_s": sum(len(r.out_tokens) for r in done) / wall,
           "ms_per_run": wall * 1e3,
           "prefill_ms": timed["prefill"],
           "decode_ms_per_step": statistics.median(timed["decode"]),
           "decode_steps": len(timed["decode"]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seq_routes": seq_routes}
    if run.get("seq") or run.get("trace_prefill"):
        # one more prefill, its collectives counted
        costs = TA.trace(lambda: prefill(srv.params, batch=batch))
        res["prefill_collective_bytes"] = dict(costs.per_kind,
                                               total=costs.coll_bytes)
        res["prefill_collective_ops"] = costs.op_counts
        res["prefill_largest_gather"] = costs.largest["all-gather"]
    # one more decode step, profiled, its collectives counted
    counted = {}
    step_toks = tokens[-1].to(torch.int32)[:, None]

    def traced_step():
        counted["costs"] = TA.trace(lambda: decode(
            srv.params, state=last["state"], tokens=step_toks))

    res.update(_device_breakdown(
        traced_step, res["decode_ms_per_step"],
        (("flash_kernel_ms", "flash_attention"),
         ("codebook_kernel_ms", "codebook_matmul"),
         ("copy_ms", "Memcpy"))))
    costs = counted["costs"]
    res["decode_collective_bytes"] = dict(costs.per_kind,
                                          total=costs.coll_bytes)
    res["decode_collective_ops"] = costs.op_counts
    res["decode_flops"] = costs.flops
    faults = {}
    if run.get("fault"):
        faults = _planted_faults(rank, srv, prefill, batch, mesh)
    del srv, last, counted
    torch.cuda.empty_cache()
    # the one-device model on the meshed run's own tokens (a moe model's
    # routing pinned to the meshed run's, `_mesh_routes`)
    cfg1, one = _serve_mesh_model(run, tmp, dev)
    if cfg.family == "moe":
        pinned = _mesh_routes(routes, dev)
        if len(pinned) != len(tokens) * cfg.n_layers:
            raise AssertionError(f"phase 17: {len(pinned)} routed moe "
                                 f"layers for {len(tokens)} forward passes "
                                 f"of {cfg.n_layers} layers")
        want = _dispatching(_replayer(pinned), lambda: _teacher_forced(
            cfg1, one, batch, tokens))
        free = _gaps(logits, _teacher_forced(cfg1, one, batch, tokens))
        res["routing_free_max_diff"] = max(free["diffs"])
        res["routes_pinned"] = len(pinned)
    else:
        want = _teacher_forced(cfg1, one, batch, tokens, cache)
    res["held"] = _gaps(logits, want)
    if run.get("flops"):
        # one decode step of the one-device model, its FLOPs counted
        from repro_torch.models import transformer as T

        _, state1 = T.forward_prefill(one, cfg1, batch, cache)
        res["one_device_decode_flops"] = TA.trace(lambda: T.forward_decode(
            one, cfg1, state1, step_toks)).flops
        del state1
    res["fault_diff"] = {k: float((f - want[0]).abs().max())
                         for k, f in faults.items()}
    if run.get("bitwise"):
        # (d): the one-device Server over the same requests
        srv1 = Server(cfg1, one, device=dev, batch_slots=LM_SLOTS,
                      cache_len=LM_CACHE)
        for uid, p in enumerate(prompts):
            srv1.submit(Request(uid=uid, prompt=p, max_new_tokens=LM_NEW))
        got1 = []
        done1 = srv1.run(sample=lambda lg: (got1.append(lg.float()),
                                            lg.argmax(-1))[1])
        res["bitwise"] = (
            [r.out_tokens for r in done1] == res["out_tokens"]
            and len(got1) == len(logits)
            and all(torch.equal(a, b) for a, b in zip(got1, logits)))
    del one
    torch.cuda.empty_cache()
    return res


def _mesh_routes(routes: list, dev) -> list:
    """The dispatch tensors every moe layer of a meshed run used, as the
    one-device model meets them: a decode group straddles the ranks'
    batch shards, so every rank routed all of it (held equal across
    ranks, so taken once); a prefill's groups fit in a shard, so each
    rank routed its own rows, concatenated here in rank order (the
    batch's); a misaligned replay fails on its shapes."""
    import torch
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, [r.bool().cpu() for r in routes])
    out = []
    for parts in zip(*every):
        if all(torch.equal(parts[0], q) for q in parts[1:]):
            out.append(parts[0])
        else:
            out.append(torch.cat(parts))
    return [r.to(dev, torch.float32) for r in out]


def _planted_faults(rank: int, srv, prefill, batch: dict, mesh) -> dict:
    """The full prefill logits of the meshed model under two planted
    faults, each undone before the next: "partial_sum", every
    row-parallel product (wo, mlp_wo) keeping rank 0's partial sum (rank
    1's shards zeroed); "head_swap", every layer's wq holding the other
    rank's heads."""
    import torch
    import torch.nn as nn

    from repro_torch.distributed import sharding as SH

    blocks, out = srv.params.blocks, {}
    with torch.no_grad():
        kept = [(b.wo.to_local().clone(), b.mlp_wo.to_local().clone())
                for b in blocks]
        if rank:
            for b in blocks:
                b.wo.to_local().zero_()
                b.mlp_wo.to_local().zero_()
        out["partial_sum"] = SH.full(prefill(srv.params, batch=batch)[0])
        for b, (wo, mo) in zip(blocks, kept):
            b.wo.to_local().copy_(wo)
            b.mlp_wo.to_local().copy_(mo)
        for b in blocks:
            full = b.wq.full_tensor()
            half = full.shape[1] // 2
            b.wq = nn.Parameter(SH.shard(
                torch.cat([full[:, half:], full[:, :half]], dim=1),
                SH.spec_of(b.wq.placements, 2, mesh), mesh),
                requires_grad=False)
        out["head_swap"] = SH.full(prefill(srv.params, batch=batch)[0])
    return {k: v.float() for k, v in out.items()}


def _hold_served(what: str, ranks: list, want: dict, tol: float | None,
                 local_shapes: tuple) -> dict:
    """Every rank: the launches `want`, all flash calls at
    `local_shapes`; the ranks' tokens equal; every step's logits within
    `tol` of the one-device model on the run's own tokens, and no token
    differing where the one-device top-2 gap exceeds `tol`."""
    for r in ranks:
        got = {k: r["launches"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"{what} rank {r['rank']}: launches "
                                 f"{r['launches']}, expected {want}")
        if want["flash_attention"] and r["flash_shapes"] != [local_shapes]:
            raise AssertionError(f"{what} rank {r['rank']}: flash shapes "
                                 f"{r['flash_shapes']}, expected "
                                 f"{[local_shapes]}")
        toks = r["out_tokens"]
        if len(toks) != LM_SLOTS or any(len(t) != LM_NEW for t in toks):
            raise AssertionError(f"{what}: bad served tokens {toks}")
    if any(r["out_tokens"] != ranks[0]["out_tokens"] for r in ranks):
        raise AssertionError(f"{what}: the ranks' tokens differ")
    worst = max(max(r["held"]["diffs"]) for r in ranks)
    out = {"max_logit_diff": worst,
           "step_diffs": ranks[0]["held"]["diffs"],
           "flips": [r["held"]["flip_gaps"] for r in ranks],
           "min_top2_gap": min(ranks[0]["held"]["min_gaps"]),
           "flash_max_err": max(r["flash_max_err"] for r in ranks),
           "codebook_max_err": max(r["codebook_max_err"] for r in ranks)}
    log(f"{what}: every step's logits within {worst:.4g} of the one-device "
        f"model on the run's own tokens (limit {tol}; by step "
        f"{[round(d, 5) for d in out['step_diffs']]}; logits up to "
        f"{ranks[0]['held']['max_abs']:.4g}); greedy tokens "
        f"differ at top-2 gaps {out['flips']}; the first flash call "
        f"within {out['flash_max_err']:.3g} of the plain version "
        f"(tolerance {FLASH_BF16_TOL}); codebook calls per local (M, K, N) "
        f"{ranks[0]['codebook_calls']}, the first of each within "
        f"{out['codebook_max_err']:.3g} of the f64 product")
    if tol is not None:
        if worst > tol:
            raise AssertionError(f"{what}: logits {worst} off the "
                                 f"one-device model (limit {tol})")
        bad = [g for r in ranks for g in r["held"]["flip_gaps"] if g > tol]
        if bad:
            raise AssertionError(f"{what}: greedy tokens differ at top-2 "
                                 f"gaps {bad} above {tol}")
    return out


def _hold_seq_served(per: dict, smi: str) -> dict:
    """Phase 17 (g), (h): each rank's served run held as `_hold_served`
    holds it (no flash and no codebook launch: a rank's query rows at an
    offset take `_sdpa`), and the sequence-split routes taken: every
    prefill attention on its query rows (whisper-tiny's decoder self- and
    cross-attention, its encoder's 1500 frames split too), every mamba2
    layer's scan by chunks."""
    from repro_torch.configs import registry as R

    out = {}
    audio, ssm = R.get_arch(AUDIO_ARCH), R.get_arch(SSM_ARCH)
    for p, cfg, want_routes in (
            ("g", audio, {"query_rows": 2 * audio.n_layers
                          + audio.enc_layers, "scan_by_chunks": 0,
                          "in_proj_pieces": 0}),
            ("h", ssm, {"query_rows": 0, "scan_by_chunks": ssm.n_layers,
                        "in_proj_pieces": ssm.n_layers * (LM_NEW - 1)})):
        out[p] = _hold_served(
            f"phase 17 ({p}) {cfg.name} data 1 x model 2, heads unsplit, "
            f"{cfg.n_layers} layers", per[p],
            {"flash_attention": 0, "codebook_matmul": 0},
            MESH_SERVE_TOL[p], ())
        for r in per[p]:
            if r["seq_routes"] != want_routes:
                raise AssertionError(f"phase 17 ({p}) rank {r['rank']}: "
                                     f"routes {r['seq_routes']}, expected "
                                     f"{want_routes}")
        log(f"phase 17 ({p}) {cfg.name} ({smi}): sequence-split routes a "
            f"rank {per[p][0]['seq_routes']}; a prefill's collective bytes "
            f"per rank {[r['prefill_collective_bytes'] for r in per[p]]}, "
            f"ops {per[p][0]['prefill_collective_ops']}; tokens/s "
            f"{[r['tokens_per_s'] for r in per[p]]}, prefill ms "
            f"{[r['prefill_ms'] for r in per[p]]}, decode ms a step "
            f"{[r['decode_ms_per_step'] for r in per[p]]}")
    # (h): every rank's decode step does half of one device's FLOPs (each
    # piece of in_proj on half its columns, out_proj on half its rows,
    # the state's and the vocab's halves)
    flops = [(r["decode_flops"], r["one_device_decode_flops"])
             for r in per["h"]]
    log(f"phase 17 (h) {ssm.name}: a decode step's FLOPs per rank "
        f"{[f for f, _ in flops]} beside one device's "
        f"{[o for _, o in flops]} (ratio "
        f"{[round(f / o, 5) for f, o in flops]}; limit "
        f"{MESH_DECODE_FLOP_SHARE[0]}-{MESH_DECODE_FLOP_SHARE[1]})")
    for f, o in flops:
        if not MESH_DECODE_FLOP_SHARE[0] <= f / o <= \
                MESH_DECODE_FLOP_SHARE[1]:
            raise AssertionError(f"phase 17 (h): a rank's decode FLOPs "
                                 f"{f} against one device's {o}")
    out["h"]["decode_flops"] = flops
    return out


def _hold_hybrid_served(per: dict, smi: str) -> dict:
    """Phase 17 (i): zamba2-2.7b's served run held as `_hold_served` holds
    it (no flash launch: its window keeps the shared attention off the
    flash route; no codebook launch), its prefill's in_proj one product
    per piece on the heads' columns in every layer and none at a decode
    step (4 rows: the output gather moves less than the pieces' weights),
    and no all-gather of a prefill as large as a rank's in_proj output."""
    import dataclasses

    from repro_torch.configs import registry as R

    cfg = dataclasses.replace(R.get_arch(HYBRID_ARCH),
                              n_layers=HYBRID_MESH_LAYERS)
    out = _hold_served(
        f"phase 17 (i) {cfg.name} data 1 x model 2, {cfg.n_layers} layers, "
        f"{LM_SLOTS} x {HYBRID_MESH_PROMPT} prompt tokens", per["i"],
        {"flash_attention": 0, "codebook_matmul": 0}, MESH_SERVE_TOL["i"],
        ())
    d_in = cfg.ssm_expand * cfg.d_model
    cols = 2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim
    output = LM_SLOTS * HYBRID_MESH_PROMPT * cols * 2          # bf16
    for r in per["i"]:
        if r["seq_routes"]["in_proj_pieces"] != cfg.n_layers:
            raise AssertionError(f"phase 17 (i) rank {r['rank']}: routes "
                                 f"{r['seq_routes']}, expected "
                                 f"{cfg.n_layers} in_proj by pieces")
        if not 0 < r["prefill_largest_gather"] < output:
            raise AssertionError(f"phase 17 (i) rank {r['rank']}: a "
                                 f"prefill all-gather of "
                                 f"{r['prefill_largest_gather']} B, a "
                                 f"rank's in_proj output is {output}")
    log(f"phase 17 (i) {cfg.name} ({smi}): routes a rank "
        f"{per['i'][0]['seq_routes']}; a prefill's largest all-gather "
        f"{[r['prefill_largest_gather'] for r in per['i']]} B (a rank's "
        f"in_proj output {output}), its collective bytes "
        f"{[r['prefill_collective_bytes'] for r in per['i']]}; tokens/s "
        f"{[r['tokens_per_s'] for r in per['i']]}, prefill ms "
        f"{[r['prefill_ms'] for r in per['i']]}, decode ms a step "
        f"{[r['decode_ms_per_step'] for r in per['i']]}")
    return {"i": out}


def mesh_serve_path(seed: int, smi: str) -> dict:
    """Phase 17: granite-3-2b served on a DeviceMesh by `Server(mesh=...)`
    with phase 6's first 4 prompts: two gloo ranks on the card run (a)
    data 1 x model 2 at full depth, bf16, with one planted fault; (b) the
    same mesh at 8 layers, C3 int8; (c) data 2 x model 1 at 8 layers;
    (e) granite-moe-1b-a400m at full width, 8 layers, data 2 x model 1
    (every decode group straddles the two batch shards: each rank does
    its half of the experts' work along their "embed" axis) and (f) the
    same on data 1 x model 2 (expert parallel), both held with the
    one-device routing pinned to the run's; (g) whisper-tiny and (h)
    mamba2-130m at full width and depth, data 1 x model 2 under
    `_seq_rules()` (heads unsplit: the sequence split on "model" through
    every block; one prefill's collectives counted); then (d) one NCCL
    rank, 1 x 1, 8 layers, bitwise the one-device server."""
    import gc
    import tempfile

    import torch

    from repro_torch.configs import registry as R
    from repro_torch.models import transformer as T
    from repro_torch.quant import lm_quant as Q

    dev = torch.device(DEVICE, 0)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seconds": {}}
    cfg = R.get_arch(LM_ARCH)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, s = LM_SLOTS, LM_PROMPT
    with tempfile.TemporaryDirectory() as tmp:
        part = time.perf_counter()
        import dataclasses

        c3cfg = dataclasses.replace(cfg, n_layers=SERVE_SHORT_LAYERS)
        qmodel, out["b_quant"] = _quantize_timed(T.init_model(
            c3cfg, torch.Generator(device=dev).manual_seed(seed)),
            "phase 17 (b)")
        leaves = {n: p.detach().cpu() for n, p in qmodel.named_parameters()}
        for i, block in enumerate(qmodel.blocks):
            for name, v in block.leaves().items():
                if isinstance(v, dict):
                    leaves[f"blocks.{i}.{name}"] = {k: t.cpu()
                                                    for k, t in v.items()}
        torch.save(leaves, f"{tmp}/c3.pt")
        del qmodel, leaves
        torch.cuda.empty_cache()
        out["seconds"]["quantize"] = time.perf_counter() - part
        # (a), (b), (c) on one pair of gloo ranks
        part = time.perf_counter()
        runs = [dict(name="a", model=2, layers=cfg.n_layers, seed=seed,
                     fault=True),
                dict(name="b", model=2, layers=SERVE_SHORT_LAYERS,
                     seed=seed, c3=True),
                dict(name="c", model=1, layers=SERVE_SHORT_LAYERS,
                     seed=seed),
                dict(name="e", model=1, layers=SERVE_SHORT_LAYERS,
                     seed=seed, arch=MOE_ARCH),
                dict(name="f", model=2, layers=SERVE_SHORT_LAYERS,
                     seed=seed, arch=MOE_ARCH),
                dict(name="g", model=2, seed=seed, arch=AUDIO_ARCH,
                     layers=R.get_arch(AUDIO_ARCH).n_layers, seq=True),
                dict(name="h", model=2, seed=seed, arch=SSM_ARCH,
                     layers=R.get_arch(SSM_ARCH).n_layers, seq=True,
                     flops=True),
                dict(name="i", model=2, seed=seed, arch=HYBRID_ARCH,
                     layers=HYBRID_MESH_LAYERS, prompt=HYBRID_MESH_PROMPT,
                     cache=HYBRID_MESH_PROMPT + 2 * LM_NEW,
                     trace_prefill=True)]
        ranks = _spawn_mesh(dict(name="serve-gloo", runs=runs), MESH_RANKS,
                            "gloo", tmp, _serve_rank, "phase 17")
        out["seconds"]["gloo"] = time.perf_counter() - part
        per = {run["name"]: [r[i] for r in ranks]
               for i, run in enumerate(runs)}
        n = SERVE_SHORT_LAYERS
        tp = ((b, h // 2, s, hd), (b, kv // 2, s, hd))
        dp = ((b // 2, h, s, hd), (b // 2, kv, s, hd))
        out["a"] = _hold_served(
            f"phase 17 (a) data 1 x model 2, {cfg.n_layers} layers", per["a"],
            {"flash_attention": cfg.n_layers,
             "flash_attention_wgmma": cfg.n_layers, "codebook_matmul": 0},
            MESH_SERVE_TOL["a"], tp)
        cb_want = n * len(DENSE_PROJECTIONS) * LM_NEW
        out["b"] = _hold_served(
            f"phase 17 (b) C3 int8, data 1 x model 2, {n} layers", per["b"],
            {"flash_attention": n, "flash_attention_wgmma": n,
             "codebook_matmul": cb_want}, MESH_SERVE_TOL["b"], tp)
        for r in per["b"]:
            shapes = r["codebook_calls"]
            if sum(shapes.values()) != cb_want or len(shapes) != 10:
                raise AssertionError(f"phase 17 (b): codebook calls "
                                     f"{shapes}")
        out["c"] = _hold_served(
            f"phase 17 (c) data 2 x model 1, {n} layers", per["c"],
            {"flash_attention": n, "flash_attention_wgmma": n,
             "codebook_matmul": 0}, MESH_SERVE_TOL["c"], dp)
        moe = R.get_arch(MOE_ARCH)
        out["e"] = _hold_served(
            f"phase 17 (e) {MOE_ARCH} data 2 x model 1, {n} layers",
            per["e"], {"flash_attention": n, "flash_attention_wgmma": n,
                       "codebook_matmul": 0}, MESH_SERVE_TOL["e"],
            ((b // 2, moe.n_heads, s, moe.hd),
             (b // 2, moe.n_kv_heads, s, moe.hd)))
        out["f"] = _hold_served(
            f"phase 17 (f) {MOE_ARCH} data 1 x model 2, {n} layers",
            per["f"], {"flash_attention": n, "flash_attention_wgmma": n,
                       "codebook_matmul": 0}, MESH_SERVE_TOL["f"],
            ((b, moe.n_heads // 2, s, moe.hd),
             (b, moe.n_kv_heads // 2, s, moe.hd)))
        out.update(_hold_seq_served(per, smi))
        out.update(_hold_hybrid_served(per, smi))
        log(f"phase 17 (e) {MOE_ARCH} data 2 x model 1 ({smi}): tokens/s "
            f"{[r['tokens_per_s'] for r in per['e']]}, decode ms a step "
            f"{[r['decode_ms_per_step'] for r in per['e']]}, decode "
            f"collectives {[r['decode_collective_ops'] for r in per['e']]}; "
            f"held with the one-device routing pinned to the run's "
            f"({per['e'][0]['routes_pinned']} moe layer calls); routing "
            f"free, the logits move by "
            f"{[r['routing_free_max_diff'] for r in per['e']]} (top-k "
            f"flips at bf16 resolution, as phase 13 logs)")
        # (d) one NCCL rank
        part = time.perf_counter()
        (rank,) = _spawn_mesh(dict(name="serve-nccl", runs=[dict(
            name="d", model=1, layers=n, seed=seed, bitwise=True)]), 1,
            "nccl", tmp, _serve_rank, "phase 17")
        rank = rank[0]
        out["seconds"]["nccl"] = time.perf_counter() - part
        out["d"] = _hold_served(f"phase 17 (d) nccl 1 x 1, {n} layers", [rank],
                                {"flash_attention": n,
                                 "flash_attention_wgmma": n,
                                 "codebook_matmul": 0}, 0.0,
                                ((b, h, s, hd), (b, kv, s, hd)))
        if not rank["bitwise"]:
            raise AssertionError("phase 17 (d): the 1 x 1 mesh's tokens or "
                                 "logits are not bitwise the one-device "
                                 "server's")
        log("phase 17 (d) nccl 1 x 1: tokens and every step's logits "
            "bitwise the one-device server's")
        per["d"] = [rank]
    keys = ("tokens_per_s", "ms_per_run", "prefill_ms",
            "decode_ms_per_step", "decode_steps", "peak_mem_gb",
            "device_busy_ms", "idle_share", "flash_kernel_ms",
            "codebook_kernel_ms", "copy_ms", "decode_collective_bytes",
            "decode_collective_ops", "launches", "codebook_calls",
            "prefill_collective_bytes")
    perf = {p: {k: [r.get(k) for r in per[p]] for k in keys} for p in per}
    for p in per:
        perf[p].update({k: out[p][k] for k in (
            "max_logit_diff", "min_top2_gap", "flash_max_err",
            "codebook_max_err")})
    perf["a"]["fault_diff"] = [r["fault_diff"] for r in per["a"]]
    log(f"phase 17 ({smi}): {json.dumps(perf)}")
    log(f"phase 17 seconds: {json.dumps(out['seconds'])}")
    fault = [r["fault_diff"] for r in per["a"]]
    log(f"phase 17 (a) planted faults (partial_sum: every row-parallel "
        f"product keeps rank 0's partial sum; head_swap: every layer's wq "
        f"holds the other rank's heads): prefill logits {fault} off the "
        f"one-device model (limit {MESH_SERVE_TOL['a']}): the check fails, "
        f"as it must")
    if min(d for r in fault for d in r.values()) <= MESH_SERVE_TOL["a"]:
        raise AssertionError(f"phase 17 (a): a planted fault passed the "
                             f"check ({fault})")
    out["a"]["fault_diff"] = fault
    out["launches"] = {
        k: sum(r["launches"].get(k, 0) for p in per for r in per[p])
        for k in ("flash_attention", "codebook_matmul")}
    out["perf"] = perf
    return out


# instructions a built library must hold: the flash kernel's bf16 wgmma
# (HGMMA) and TMA loads (UTMALDG), the fused timestep's f64 tensor-core
# adds (DMMA)
SASS_NEEDS = {"flash_attention": ("HGMMA", "UTMALDG"),
              "fused_timestep": ("DMMA",)}


# each tensor-core instantiation of the flash kernel (the mangled head
# dim and panel width) must hold both of the flash library's needs
SASS_FLASH_KERNELS = {"hd 64": "wgmma_kernelILi64ELi64E",
                      "hd 96": "wgmma_kernelILi96ELi32E",
                      "hd 128": "wgmma_kernelILi128ELi64E"}


def _sass_functions(sass: str) -> dict:
    """The SASS text of each function, by its mangled name."""
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def _count_ops(lines, needs) -> dict:
    return {op: sum(op in line for line in lines) for op in needs}


def _sass_counts(build) -> dict:
    """SASS_NEEDS counted in each built library's SASS, by
    `cuobjdump -sass`, and in each of SASS_FLASH_KERNELS; raises if one
    is missing."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    out = {}
    for name, needs in SASS_NEEDS.items():
        sass = subprocess.run([str(tool), "-sass", str(build._target(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = _count_ops(sass.splitlines(), needs)
        if not all(counts.values()):
            raise AssertionError(f"{name} SASS lacks one of {needs}: "
                                 f"{counts}")
        out[name] = counts
        if name != "flash_attention":
            continue
        funcs = _sass_functions(sass)
        for what, key in SASS_FLASH_KERNELS.items():
            lines = [x for f, body in funcs.items() if key in f for x in body]
            counts = _count_ops(lines, needs)
            if not lines or not all(counts.values()):
                raise AssertionError(f"flash_attention {what} ({key}) SASS "
                                     f"lacks one of {needs}: {counts}")
            out[f"flash_attention {what}"] = counts
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 18: the examples
# ---------------------------------------------------------------------------

# quickstart: one call each of the C1 product and the C2 update
QUICKSTART_LAUNCHES = {"zspe_spmm": 1, "lif_update": 1,
                       "fused_timestep_codebook": 0,
                       "fused_timestep_dense": 0, "codebook_matmul": 0,
                       "flash_attention": 0}


def _kernel_modules() -> tuple:
    """The kernel wrappers' modules, each with its `launches` counts."""
    from repro_torch.kernels import codebook_matmul as CBM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_timestep as FT
    from repro_torch.kernels import lif_update as LU
    from repro_torch.kernels import zspe_spmm as ZS

    return ZS, LU, FT, CBM, FA


def _example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_path(smi: str) -> dict:
    """Phase 18: examples/torch_quickstart.py on the card (exactly one
    zspe_spmm and one lif_update launch, no other; the product against
    the f64 product of the script's own spikes and weights by phase 3's
    rule, the LIF step against its plain version on the kernel's
    current by `check_step`; how far the card's run lies from the same
    script on the CPU is logged), then examples/torch_snn_nmnist_e2e.py
    at its defaults (train, quantize, compile, simulate on the compiled
    engine; its differential check against the interpretive reference
    engine must pass)."""
    import torch

    from repro_torch.kernels import lif_update as LU

    out = {}
    t0 = time.perf_counter()
    quick = _example("torch_quickstart")
    for mod in _kernel_modules():
        mod.reset_launches()
    got = quick.main([])
    torch.cuda.synchronize()
    launches = {k: v for mod in _kernel_modules()
                for k, v in mod.launches.items() if k in QUICKSTART_LAUNCHES}
    if launches != QUICKSTART_LAUNCHES:
        raise AssertionError(f"phase 18 quickstart: launches {launches}, "
                             f"expected {QUICKSTART_LAUNCHES}")
    cur = got["zspe_out"]
    err = _assert_close("phase 18 quickstart zspe_spmm", cur,
                        _exact_product(got["spikes"], got["weights"]))
    v0, el0 = torch.zeros_like(cur), torch.zeros_like(cur, dtype=torch.int32)
    lif_err = check_step("phase 18 quickstart lif_update", got["lif"],
                         LU.lif_update_plain(v0, el0, cur, threshold=1.0,
                                             leak=0.9, reset=0.0),
                         LIF_INTS, _lif_v_int(v0, el0, cur, 0.9))
    cpu = quick.main(["--device", "cpu"])
    q, qc = got["quantized"], cpu["quantized"]
    out["quickstart"] = {
        "launches": launches, "zspe_max_abs_err": err,
        "lif_v_max_abs_err": lif_err,
        "fit_bitwise_the_cpu_run": bool(
            torch.equal(q.idx.cpu(), qc.idx)
            and torch.equal(q.codebook.cpu(), qc.codebook)),
        "current_vs_cpu_run": float((cur.cpu() - cpu["zspe_out"]).abs().max()),
        "touched_differing_from_cpu_run": int(
            (got["lif"][3].cpu() != cpu["lif"][3]).sum()),
        "seconds": time.perf_counter() - t0}
    log(f"phase 18 quickstart: {json.dumps(out['quickstart'])}")
    t0 = time.perf_counter()
    e2e = _example("torch_snn_nmnist_e2e").main([])
    rep = e2e["report"]
    out["e2e"] = {"acc_fp": e2e["acc_fp"], "acc_q": e2e["acc_q"],
                  "pj_per_sop": rep.pj_per_sop, "power_mw": rep.power_mw,
                  "engine_ms": e2e["seconds"] * 1e3,
                  "differential_check": "passed",
                  "seconds": time.perf_counter() - t0}
    log(f"phase 18 e2e ({smi}): {json.dumps(out['e2e'])}")
    out["launches"] = launches
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside the repo checkout)
    from repro_torch.configs.snn_chip import ARCH
    from repro_torch.kernels import build

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    nvcc_logs = build.build_all()
    log(f"build: {sorted(nvcc_logs)} in {time.perf_counter() - t0:.1f} s")
    for src, text in nvcc_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    log(f"SASS instructions: {json.dumps(_sass_counts(build))}")

    # 3. kernels
    t0 = time.perf_counter()
    kern = kernel_phase(ARCH, args.seed)
    qws = _arch_quantized(ARCH, args.seed)
    kern.update(api_kernel_phase(ARCH, qws, args.seed))
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    # 4. main path
    mp = main_path(ARCH, args.seed)

    # 7. the main path faulted and traced (phase 4's weights and mapping)
    ctx = mp.pop("ctx")
    t0 = time.perf_counter()
    fp = fault_path(ARCH, ctx, smi)
    log(f"fault phase: {time.perf_counter() - t0:.1f} s")

    # 8. on-chip plasticity and the interpretive engine (the same network)
    repaired = fp.pop("repaired")
    t0 = time.perf_counter()
    pp = plasticity_path(ARCH, ctx, smi)
    log(f"plasticity phase: {time.perf_counter() - t0:.1f} s")

    # 9. SNN serving (phase 4's weights; phase 7 b's repaired chip)
    t0 = time.perf_counter()
    sp = serving_snn_path(ARCH, ctx, repaired, mp["perf"], args.seed, smi)
    log(f"SNN serving phase: {time.perf_counter() - t0:.1f} s")
    del repaired

    # 10. SNN training at ARCH widths
    t0 = time.perf_counter()
    training_path(ARCH, args.seed, smi)
    log(f"SNN training phase: {time.perf_counter() - t0:.1f} s")

    # 11. the train -> deploy pipeline and continual adaptation
    t0 = time.perf_counter()
    dp = deploy_path(ARCH, args.seed, smi)
    log(f"deploy phase: {time.perf_counter() - t0:.1f} s")

    # 12. the sharded engine and batch sharding (phase 4's network)
    t0 = time.perf_counter()
    shp = shard_path(ARCH, ctx, smi)
    log(f"shard phase: {time.perf_counter() - t0:.1f} s")
    del ctx

    # 5. kernel-API path
    api = api_path(ARCH, qws, args.seed)

    # 6. LM serving path
    t0 = time.perf_counter()
    kern["flash_attention"] = flash_kernel_phase(args.seed)
    t1 = time.perf_counter()
    lm = serving_path(args.seed)
    log(f"LM serving phase: {time.perf_counter() - t0:.1f} s (kernel "
        f"checks {t1 - t0:.1f} s)")

    # 13. MoE and C3 codebook-quantized LM serving
    t0 = time.perf_counter()
    mq = moe_c3_path(args.seed, smi)
    log(f"MoE and C3 serving phase: {time.perf_counter() - t0:.1f} s")

    # 14. the ssm, hybrid and audio families
    t0 = time.perf_counter()
    fam = families_path(args.seed, smi)
    log(f"ssm, hybrid and audio serving phase: "
        f"{time.perf_counter() - t0:.1f} s")

    # 15. the vlm family and LM training
    t0 = time.perf_counter()
    vt = vlm_train_path(args.seed, smi)
    log(f"vlm and LM training phase: {time.perf_counter() - t0:.1f} s")

    # 16. LM training on a DeviceMesh and one dry-run cell
    t0 = time.perf_counter()
    mt = mesh_train_path(args.seed, smi, vt["d"])
    log(f"mesh training and dry-run phase: {time.perf_counter() - t0:.1f} s")

    # 17. LM serving on a DeviceMesh
    t0 = time.perf_counter()
    ms = mesh_serve_path(args.seed, smi)
    log(f"mesh serving phase: {time.perf_counter() - t0:.1f} s")

    # 18. the examples
    t0 = time.perf_counter()
    ex = examples_path(smi)
    log(f"examples phase: {time.perf_counter() - t0:.1f} s")

    # kernels line, then the result; launches from phase 4 (fused), phase
    # 7 (the faulted runs), phase 8 (the plastic runs), phase 9 (the SNN
    # server), phase 11 (deploy and adaptation), phase 12 (the spawned
    # ranks' batch-sharded fused runs), phase 5 (kernel API, all three
    # loops), phase 6 (the served LM run), phase 13 (the served moe
    # runs, bf16 and C3 int8, and the 4-bit dense run), phase 14 (the
    # served mamba2 C3 run and whisper's served run) and phase 15 (the
    # served phi-3-vision runs, bf16 and C3 int8, and granite-3-2b's
    # training steps, and the remat policies' steps), phase 16 (the
    # meshed training steps of every rank), phase 17 (every rank's meshed
    # served run) and phase 18 (the quickstart's calls)
    launches = dict(mp["launches"])
    for loop in [fp, pp, sp, dp, shp, ex, *api.values()]:
        for kname, count in loop["launches"].items():
            launches[kname] = launches.get(kname, 0) + count
    launches["flash_attention"] = (lm["launches"]["flash_attention"]
                                   + mq["launches"]["flash_attention"]
                                   + fam["launches"]["flash_attention"]
                                   + vt["launches"]["flash_attention"]
                                   + mt["launches"]["flash_attention"]
                                   + ms["launches"]["flash_attention"])
    launches["codebook_matmul"] += (mq["launches"]["codebook_matmul"]
                                    + fam["launches"]["codebook_matmul"]
                                    + vt["launches"]["codebook_matmul"]
                                    + ms["launches"]["codebook_matmul"])
    csrc = "src/repro_torch/kernels/csrc"
    kernels = {
        "fused_timestep_codebook": ("fused_timestep.cu",
                                    "fused_timestep.py:231"),
        "fused_timestep_dense": ("fused_timestep.cu", "fused_timestep.py:266"),
        "lif_update": ("lif_update.cu", "lif_update.py:47"),
        "zspe_spmm": ("zspe_spmm.cu", "zspe_spmm.py:61"),
        "codebook_matmul": ("codebook_matmul.cu", "codebook_matmul.py:62"),
        "flash_attention": ("flash_attention.cu", "flash_attention.py:69")}
    line = {"kernels": [
        {"name": kname, "route": "cuda", "source": f"{csrc}/{src}",
         "replaces": f"src/repro/kernels/{rep}",
         "launches": launches[kname], **kern[kname]}
        for kname, (src, rep) in kernels.items()]}
    for entry in line["kernels"]:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} never ran on the main "
                                 f"path")
    log(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
