"""Drive the torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing falls back to the CPU):

1. the card: its name and power limit, as ``nvidia-smi`` reports them;
   a fresh kernel-cache root for the run (``$REPRO_TORCH_KERNEL_CACHE``
   under ``build/``); the seconds a seeded draw of 10^9 float32 weights
   takes with numpy on the host and on the card (``ParamBuilder``'s two
   routes);
2. build, one nvcc per source, all started together: every kernel the
   serving paths emit (for each architecture of ``SERVED``: the attention
   kernel of each prompt bucket and of the ragged decode step, and the
   SwiGLU kernels of each, 2 at smollm-135m's widths and 3 at the wider
   dense models'), generated by ``repro_torch.core.codegen_cuda``, path
   E's (jamba-1.5-large-398b's attention at 480 and 512 query rows over
   4 sequences and its ragged decode over 512 positions, its SwiGLU at
   1920, 2048 and 4 rows, at d 8192, d_ff 24576, 64/8 heads of 128, each
   printed with its shared memory), the kernels of phases 8 and 9 (each analytic finalist of the measured
   sweeps at its timed blocks and at the base blocks a winner lowers at,
   each unfused program), and
   the three hand-written kernels of ``repro_torch/csrc/`` (flash
   attention, RMSNorm+SwiGLU, LayerNorm+matmul), all for sm_90a; then the
   HMMA (tensor-core) instructions and the registers and stack of each
   hand kernel's instantiations (``cuobjdump``): every hand kernel must
   have HMMA instructions, and every served program and path E's must
   lower on the rung it asked for and emit one kernel for each group its
   plan made;
3. each emitted kernel against its plain PyTorch version on the card, on
   inputs of the shapes its serving path (or path E) gives it, and
   qwen2-7b's at the benchmark cell's (``CELL``: 32 decode rows over 1024
   positions, and its prompt buckets' prefills of 32 to 256 rows; built
   in phase 2) (``rtol = atol = 2e-4``), timed with CUDA events (back to
   back, so a short kernel is timed at the host's enqueue rate) beside the plain version and, where
   one PyTorch call computes the same function, that call
   (``scaled_dot_product_attention`` for attention, ``matmul`` for the
   down projection), and its device time per launch from
   ``torch.profiler`` (one session for all); its row names its launch
   plan (lifted dims, cluster size, blocks, shared memory);
4. ``repro_torch.launch.serve`` at full width for each architecture of
   ``SERVED`` (smollm-135m and llama3.2-1b at full depth, qwen3-moe-
   30b-a3b and qwen2-7b at 2 layers, qwen3-32b at 1, deepseek-v3-671b at
   2: one MLA+SwiGLU and one MLA+MoE layer, its MLA on the plain torch
   attention as the reference's runs plain XLA there; seeded random
   weights drawn on the card, their seconds printed; 8 requests, prompts
   of 4-24 tokens, 4-12 new tokens) through the CUDA kernels, replaying
   each bucket's prefill and the decode step as the CUDA graphs
   ``warmup()`` captured, with every launch counter set to 0 after
   ``warmup()`` and read after the trace (every decode kernel, and every
   prefill kernel of a bucket the trace uses, must have launched); its
   trace is served again under ``torch.profiler``: a replay's launches
   are counted from its graph's capture (``Engine._run``), so each
   emitted kernel's name must appear in the device trace as often as its
   counter says, and in 3 replays of the decode graph alone as often as
   it launched in the capture (a layer each), times 3; its greedy tokens
   are held against the same engine on the plain ``torch`` backend; the
   resilience layer's clean path is
   gated (here and in 4a): no demotion, probe, re-promotion, quarantine
   or emitter split, decode on ``pipeline-cuda``, every program on its
   requested rung, no file in the run's ``<cache>/health/``; then
   ``launch.profile_decode`` breaks 3 decode steps of the same engine
   down by kernel (each decode kernel, torch ops, the device's busy
   share, the step's host time), beside
   ``torch.cuda.max_memory_allocated``.  Each architecture runs in a
   child process (this script with ``--serve``), so its weights and
   profiler session end with it; smollm-135m's on a fresh cache
   directory and a fresh nvcc build directory, where it must miss every
   program, hit none on disk and build its kernels;
4a. a warm start: a second child serves smollm-135m's trace on the same
   two directories and must load every plan from disk, with no miss, no
   fusion or selection run, no nvcc build, and the cold serve's greedy
   tokens; no temporary file may be left in the cache directory;
5. each hand-written kernel against its plain version (which follows the
   kernel's split of the key or d_ff axis) at every shape of paths A, B
   and C and of phase 12 below, plus one bfloat16 case each, SwiGLU at
   llama3.2-1b's widths in bfloat16 and at qwen2-7b's D 3584; phase 12
   adds internvl2-26b's (q (2, 48, 320, 128) over 8 KV heads, causal; x
   (640, 6144), W/V (6144, 16384)), smollm-135m's training batch (q (8,
   9, 512, 64) over 3 KV heads; x (4096, 576)) and the drill's (q (4, 9,
   128, 64); x (512, 576)).  Each wrapper counts its launches by shape,
   and the script fails if a path or phase 12 launched a kernel at a
   shape no case holds (float32: ``2e-4`` for
   attention, ``2e-4 * sqrt(K)`` absolute for LayerNorm+matmul, ``4e-4``
   for SwiGLU; bfloat16: ``5e-2``), with its launch grid, cluster size
   and (SwiGLU) X layout, timed with
   CUDA events beside its plain version (and
   ``scaled_dot_product_attention`` for attention), with its bound; then
   the device time per launch of every case and of its SDPA call, from
   one ``torch.profiler`` session, and, as context (no single PyTorch
   call computes LayerNorm+matmul, so it has no yardstick), the device
   time of the unfused ``F.layer_norm`` then ``torch.matmul`` at each
   LayerNorm+matmul case.  The float32 bound is 3xTF32 on the
   tensor cores (495 / 3 TFLOP/s), the float32 FMA bound beside it;
5b. the grouped expert kernel of the MoE layer (``grouped_phase``, also
   alone: ``chip_smoke.py --grouped-experts``) at the MoE layers of
   deepseek-v3-671b.chat, qwen3-moe-30b-a3b and path E's jamba (``GROUPED``),
   each at its serving paths' rows and on both sides of the layer's
   choice, under random routing (dropped assignments included): against
   its plain version (``2e-4``) and the padded layer, bit for bit on a
   second call, one launch a call (its kernels counted in the timing's
   device trace), timed beside its
   bound, its plain version, the three padded ``torch.bmm``'s it replaces
   and the padded layer (which must not be faster where the layer takes
   the kernel);
6. a plumbing check of each kernel's ``autograd.Function``: its forward
   launches the kernel once, and its backward (autograd of the plain
   oracle, by design) returns finite gradients of the inputs' shapes for
   every input that needs one;
7. path A: ``LM.forward`` and ``LM.prefill`` of full-width smollm-135m
   (30 layers, batch 4 x 512 tokens) on ``attn_impl = mlp_impl = "cuda"``;
   path B: ``EncDec.prefill`` of full-width whisper-tiny (4 + 4 layers,
   1500 frames, batch 2 x 64 tokens); path C: ``LM.forward`` and
   ``LM.prefill`` of full-width llama3.2-1b (16 layers, 4 x 512 tokens);
   each call once with the launch counters set to 0 just before and read
   just after (exact counts), its logits finite and within 1e-3 of the
   same call on the plain impls, then timed over ``PATH_REPEATS`` calls
   (median and spread); path D (``PATH_D``): mamba2-2.7b at full width
   and depth (64 layers) on its plain torch SSD, no kernel on it (the
   reference's SSD is plain XLA): ``LM.prefill`` of 4 x 480 tokens, 32
   greedy ``LM.decode_step``s, then ``LM.forward`` over the 512 tokens
   they made, timed as above and per decode step; every position's
   logits held against the forward pass's by the reference's rule at
   1e-3 on the first 16 layers (at 64 layers float32 itself lies
   further than that from float64, so there the distances to the forward
   pass and to a float64 forward pass are printed); path E
   (``PATH_E``, ``run_path_e``, in a child process: ``--path-e``):
   jamba-1.5-large-398b's first period (8 of 72 layers: Mamba2 and
   attention interleaved, the MoE every other layer) at published widths,
   2 of its 16 experts held (one chip of an 8-way expert-parallel layer;
   router, top-2 and capacity the whole layer's), attention and SwiGLU on
   the emitted kernels: prefill 4 x 480, 32 greedy decode steps and the
   forward pass with exact launches, each within 1e-3 of the emitted
   programs' plain versions (or the tokens' first difference), the plain
   impls' and a float64 forward's distances printed, prefill and decode
   against a float64 forward (layer by layer) at capacity factor 8.0,
   times, the decode step by class
   of work beside its bound, and ``max_memory_allocated``;
8. measured autotune on the card: ``pipeline.compile(...,
   dim_candidates=..., autotune="measured", top_k=3)`` of the programs of
   ``TUNED`` (smollm-135m's SwiGLU at t = 4 and 32, llama3.2-1b's at t =
   4, smollm-135m's GQA decode attention), every candidate timed at the
   published width; per finalist its dims and predicted cost, the
   callable's fenced wall time (what the selector ranks by), its kernels'
   CUDA-event time, or why it was skipped.  Fails if every measurement
   failed, if the winner is slower than the analytic winner (the first
   finalist timed), or if a timed finalist or the winner (lowered at the
   base blocks, as the reference lowers it) is not within ``2e-4`` of
   its plain version;
9. fusion on the card: the same programs at the serving path's dims,
   fused against ``fused=False`` (regions grouped by the planner, a group
   the emitter cannot fit in shared memory split into one kernel a
   member, and one kernel a region): launches, the groups split, the
   predicted traffic reduction, CUDA-event times, outputs within ``2e-4``
   of the fused program's.  A fused program whose planned group the
   emitter had to split fails here, as a served one fails phase 2;
10. the first H100 ``CalibrationProfile``: ``calibrate.fit_profile`` over
   the features and phase 3 device times of every emitted serving
   kernel, saved under the run's cache root and loaded back; its
   coefficients and the Spearman rank agreement of predicted cost and
   measured time under the default and the fitted profile (a finding,
   printed, not gated);
11. resilience on the card: smollm-135m at full width and depth, three
   runs on phase 4's trace, each in a child process (``--resilience``) on
   its own copy of phase 4's filled cache directory and on phase 2's nvcc
   directory, all started together.  On the card nothing demotes to a
   plain version (a compile stops at the ``ungrouped`` rung, decode never
   leaves ``pipeline-cuda``), so the reference's plans are cut to what
   the card may do: **chaos** (the grouped rung of the first compile, the
   first plan read corrupted, a NaN logits row) must land exactly one
   program on the ``ungrouped`` rung, poison exactly one request and
   match every counter to the plan by the reference's rule
   (``resilience_expected``), the other requests' tokens equal to phase
   4's and every kernel launched; **refuse** (the heal plan's decode
   fault) must raise out of ``run`` with no demotion, probe or breaker,
   after exact decode-kernel launches (a layer each for every tick before
   the fault), and a serving program compiled with both cuda rungs
   faulted must raise ``LadderError`` without trying the ``torch`` rung;
   **deadline** (``deadline_trace``, ``max_queue=2``) must give the
   ``queue_full``, ``deadline_queued`` and ``deadline`` records the CPU
   engines give (``DEADLINE_RECORDS``).  Every run: zero nvcc builds,
   zero unexplained compiles, no breaker left open (refuse: no file in
   ``<cache>/health/``);
12. training on the hand kernels, float32, seeded weights drawn on the
   card, ``SyntheticLMData(seed=0)``, remat on (each kernel launched
   twice a layer a step: forward and recompute; its backward is autograd
   of its plain version, by design): **12a** step 0's loss and gradients
   of smollm-135m (full, batch 8 x 512), whisper-tiny (full, 2 x 1500
   frames, 64 tokens) and internvl2-26b (full width, 2 layers, 2 x (256
   vision + 64 text)) on the hand kernels against the plain impls (loss
   within ``1e-4`` relative, every gradient leaf within ``1e-3`` relative
   L2, a miss fails), exact launches; the worst leaf of each model (and
   any leaf that missed), of the hand kernels, the plain impls and each
   family of hand kernel alone, is held against a float64 run of the
   plain impls whose attention is float64 too (SDPA's math path in place
   of the float32 oracle), and the distances are printed; **12b** 30 steps of smollm-135m through
   ``launch/train.py`` (lr 1e-3, 8 x 512), then on the plain impls: every
   loss finite, falling, each within ``1e-3`` of the plain run's, exact
   launches; **12c** llama3.2-1b at full width and depth, 3 steps of 4 x
   512, then on the plain impls: step 0's loss within ``1e-4`` of the
   plain impls', exact launches, the later steps' distances printed;
   a ``torch.profiler`` split of one step of each of these two (hand
   kernels, cuBLAS products, other kernels, optimizer, host); **12d** the
   crash drill in child processes (this script with ``--train``):
   smollm-135m at full width, checkpoints every 10 steps, a crash after
   step 13 (exit 42), a resume to 20, and a clean run to 20 must end on
   bitwise-equal checkpoints, each child with exact launches.  12b, 12c,
   the profiles and the children run under ``launch/train.py``'s
   ``deterministic``; in this process cuBLAS has its workspace from the
   earlier phases, and only the children take ``:4096:8``.  Each run's
   step time, tokens/s, bound and peak memory are printed beside the
   card;
13. the multi-device runtime on the one card, in a child process (this
   script with ``--mesh``, which runs it alone), whose NCCL process group
   (a world of one; no fallback to gloo or the CPU) lives and dies with
   it, on a (1, 1) ``data`` x ``model`` debug mesh: **13a** the
   expert-parallel MoE layer (``moe_impl="shard_map"``) at
   qwen3-moe-30b-a3b's published widths (``MESH_MOE``: 128 experts of d
   2048 and d_ff 768, top-8, capacity factor 1.25, 4 x 512 tokens from
   seed 0) against the dense ``moe_apply`` on the same weights: at world
   size one they differ only by the bfloat16 rounding of the partials,
   so each output element within ``BF16_ROUNDING`` (2^-8) of its
   magnitude and the input gradient within it in relative L2, both
   timed with CUDA events beside the expert weights' read bound; **13b**
   ``distributed_decode_attention`` at jamba-1.5-large-398b's attention
   widths over ``long_500k``'s 524,288 positions (K and V 2.15 GB each)
   against ``attention_ref`` (``DECODE_TOL``) and on the reference test's
   case (``DECODE_CASE_TOL``), timed beside its bytes bound; **13c**
   ``compressed_psum_mean`` over smollm-135m's gradients, bit for bit
   the int8 round trip and its residual; **13d** ``launch/train.py
   --mesh debug`` against ``--mesh none`` (``MESH_TRAIN``: smollm-135m, 3
   steps of 8 x 512 on the hand kernels), parameters equal bit for bit,
   exact launches (counted as the paths ``13d none`` and ``13d debug``).
   NCCL's seconds to its first all-reduce and each part's seconds are
   printed;
14. the step analysis, the dry-run and the examples, in a process of
   its own (this script with ``--analysis``, which also runs it
   alone): **14a**
   ``runtime.op_analysis.analyze_step`` of a smollm-135m train step (8 x
   512, all 30 layers) and a llama3.2-1b decode step (batch 4 over
   ``decode_32k``'s 32,768 positions), bfloat16 on the plain impls,
   counted on ``meta`` and on the card: FLOPs, bytes, argument and
   output bytes must be equal, and each step (CUDA events, median of
   ``ANALYSIS_REPEATS`` after a warmup) no faster than its bound; the
   analysis's arguments + temporaries printed beside the allocator's
   peak; **14b** the dry-run CLI (``launch/dryrun.py``, a child each) on
   ``DRYRUN_CELLS`` on both production meshes under the ``fake``
   backend, every cell ``ok``, its per-rank FLOPs, bytes, collective
   bytes by kind, bottleneck and ``fits_80g_hbm`` printed; **14c** the
   four ``examples/torch_*.py`` on the
   card, each a process (the trained loss must fall);
15. the serving records, the paths' times (path E's record among
   them), the compile driver's record,
   the ``resilience``, ``training``, ``multi-device`` and ``analysis``
   records (with the card), each
   phase's seconds, a ``kernels`` JSON line (the emitted kernels'
   launches on their serving path or path E, the hand kernels' launches
   by path, phase 12's and 13's runs among them, and each case's
   launches by path at its shape), the card line, and the result line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 2e-4          # kernel vs plain version, float32 (summation order)
SERVE_TOL = 1e-3    # logits of the CUDA engine vs the torch engine
PATH_TOL = 1e-3     # logits of a hand-kernel path vs its plain impls
LAYER_TOL = 1e-4    # path E: a layer's increment or cache vs the plain
                    # impls', over the plain one's largest magnitude
BF16_TOL = 5e-2     # hand kernel vs plain version, bfloat16
PATH_REPEATS = 10   # timed calls of each hand-kernel path
#: the serving phases: each architecture at full width, with its depth
#: (None: the config's) cut only where the run's time limit asks
SERVED = (("smollm-135m", None), ("llama3.2-1b", None),
          ("qwen3-moe-30b-a3b", 2), ("qwen2-7b", 2), ("qwen3-32b", 1),
          ("deepseek-v3-671b", 2))
#: path D: mamba2-2.7b at full width and depth on the port's plain torch
#: SSD (the reference runs no kernel there): forward on ``batch`` x
#: ``seq`` tokens; prefill of the first ``prefill`` tokens (max_len
#: ``seq``), then greedy decode steps to ``seq``; the reference's decode
#: rule held on its first ``rule_layers`` layers (see ``run_path_d``)
PATH_D = dict(arch="mamba2-2.7b", batch=4, seq=512, prefill=480,
              rule_layers=16)
#: path E: jamba-1.5-large-398b's first period (8 of its 72 layers:
#: Mamba2 at 0-3 and 5-7, attention at 4, the MoE at 1, 3, 5 and 7) at
#: published widths in float32, holding the ``experts`` (first, count) of
#: its 16: one chip of an 8-way expert-parallel layer, whose router, top-2
#: and capacity are the whole layer's (4 of 16, a 4-way layer's share,
#: peaked at 79.69 GB of the card's 85.5, past the 78 GB this run keeps
#: under; PERF.md).  On the emitted kernels
#: (``with_pipeline(cfg, "cuda")``: attention and SwiGLU); Mamba2 stays
#: plain torch, as the reference has it, and the held experts run on the
#: grouped expert kernel where the layer takes it (the decode step's 4
#: rows) and as ``torch.bmm`` elsewhere (the prefill, the float64 check).
#: Shape as path D; ``repeats`` timed forward and prefill calls,
#: ``profile_steps`` profiled decode steps; prefill and decode held
#: against a float64 forward at ``drop_free_capacity`` (``run_path_e``)
PATH_E = dict(arch="jamba-1.5-large-398b", n_layers=8, experts=(0, 2),
              batch=4, seq=512, prefill=480, drop_free_capacity=8.0,
              repeats=3, profile_steps=3)
#: phase 3's kernels at the benchmark cell's shapes (bench/configs/
#: qwen2-7b.json, bench/traffic/chat-closed32.json): qwen2-7b's SwiGLU
#: (on the tensor cores) and attention at 32 decode rows over 1024
#: positions and at every prompt bucket's prefill, each kernel the cell
#: launches
CELL = dict(name="qwen2-7b.chat", arch="qwen2-7b", max_batch=32,
            max_len=1024, prefill_lens=(32, 64, 128, 256))
#: the engine and trace of every serving phase
SERVE = dict(n_requests=8, prompt_lens=(4, 24), gen_lens=(4, 12), seed=0,
             record_logits=True, max_batch=4, max_len=96,
             prompt_buckets=(8, 16, 32))
#: phase 11, resilience on the card: the served architecture (full width,
#: the config's depth), the reference's seeded chaos plan
#: (benchmarks/serve_bench.py:75-84) and heal plan (:90-100) with its
#: probe window, which the CPU engines run against the reference's
#: (tests/test_torch_resilience_engine.py), the card's cuts of them, and
#: the deadline run's queue bound
RESILIENCE_ARCH = "smollm-135m"
CHAOS_FAULTS = (
    {"site": "compile:grouped", "indices": [0], "kind": "raise",
     "message": "chaos: grouped lowering down"},
    {"site": "compile:ungrouped", "indices": [0], "kind": "raise",
     "message": "chaos: ungrouped lowering down"},
    {"site": "cache:get_plan", "indices": [0], "kind": "corrupt"},
    {"site": "serve:logits", "indices": [2], "kind": "nan"})
HEAL_FAULTS = (
    {"site": "serve:decode", "indices": [2], "kind": "raise",
     "message": "heal: transient decode fault"},
    {"site": "serve:probe", "indices": [0], "kind": "raise",
     "message": "heal: probe still cold"})
HEAL_REPROMOTE_AFTER = 3
#: on the card a compile demotes no further than ``ungrouped`` and decode
#: not at all: the chaos run faults the grouped rung only, and the refuse
#: run holds the card to raising on the heal plan's decode fault
CARD_CHAOS_FAULTS = tuple(f for f in CHAOS_FAULTS
                          if f["site"] != "compile:ungrouped")
REFUSE_FAULTS = HEAL_FAULTS[:1]
DEADLINE_MAX_QUEUE = 2
#: the deadline run's failure records by reason: what the port's and the
#: reference's engines give for its trace on the CPU
#: (tests/test_torch_resilience_engine.py holds both to these)
DEADLINE_RECORDS = {"queue_full": 2, "deadline_queued": 1, "deadline": 2}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
# float32 work within the float32 tolerance: 3xTF32 on the tensor cores,
# the data sheet's dense 495 TFLOP/s TF32 over the three products
FP32_FLOPS = 495e12 / 3
FP32_FMA_FLOPS = 67e12      # H100 SXM data sheet, float32 outside tensor cores
BF16_FLOPS = 989e12         # H100 SXM data sheet, dense bfloat16
HAND_TC = ("flash_attention", "rmsnorm_swiglu",   # hand kernels on HMMA
           "layernorm_matmul")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def weights_route():
    """The seconds per 10^9 seeded float32 values of ``ParamBuilder``'s
    two routes: numpy's ``standard_normal`` on the host (a draw of 10^8)
    and ``normal_`` with a ``torch.Generator`` on the card (a draw of
    10^9, synchronized)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    rng.standard_normal(10 ** 8, dtype=np.float32)
    host_s = (time.perf_counter() - t0) * 10
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.empty(10 ** 9, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w.normal_(0.0, 1.0, generator=gen)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    del w
    torch.cuda.empty_cache()
    print(f"weights: a seeded draw of 10^9 float32 values takes {host_s:.3f}"
          f" s with numpy on the host (from 10^8) and {card_s:.4f} s on the "
          "card", flush=True)
    return {"numpy_host_s_per_1e9": host_s, "card_s_per_1e9": card_s}


def on_requested_rung(label, kern):
    """``kern``, failing unless it was compiled on the ladder rung its
    options asked for: a demoted program would change what a phase
    measures."""
    rr = kern.resilience_report
    if kern.rung != rr.requested:
        fail(f"{label}: compiled on the {kern.rung!r} rung, not the "
             f"{rr.requested!r} one it asked for ({rr.summary()})")
    return kern


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_name(event_name: str) -> str:
    """A kernel's name as the profiler shows it, without its arguments
    (``void emit_group_g0_22_23(KArgs)`` -> ``emit_group_g0_22_23``)."""
    head = event_name.split("(")[0].split()
    return head[-1] if head else event_name


def program_inputs(name, kern, cfg, max_batch, max_len, gen,
                   prefill_batch=1):
    """Inputs of one compiled program at the shapes the serving path (or
    path E) feeds it, with its instance-axis count: decode at
    ``max_batch`` over ``max_len`` cached positions, prefill over
    ``prefill_batch`` sequences."""
    import torch
    dev, f32 = "cuda", torch.float32

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, dtype=f32,
                           device=dev) * scale

    d, dff, dh = cfg.d_model, cfg.d_ff, cfg.d_head
    hkv, group = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    if name.startswith("attention"):
        if name == "attention_decode":
            b, s, skv = max_batch, 1, max_len
            pos = torch.linspace(5, max_len - 1, b, device=dev).round()
            qp = pos.reshape(b, 1, 1)
        else:
            b, s = prefill_batch, int(name[len("attention_prefill"):])
            skv = s
            qp = torch.arange(s, dtype=f32, device=dev).reshape(1, 1, s)
        return {"Q": randn(b, hkv, group, s, dh),
                "KT": randn(b, hkv, skv, dh),
                "VT": randn(b, hkv, dh, skv),
                "QP": qp.contiguous(),
                "KP": torch.arange(skv, dtype=f32, device=dev).reshape(
                    1, 1, skv)}, 2
    t = max_batch if name == "swiglu_decode" else prefill_batch * int(
        name[len("swiglu_prefill"):])
    return {"X": randn(t, d), "WT": randn(dff, d, scale=d ** -0.5),
            "VT": randn(dff, d, scale=d ** -0.5),
            "UT": randn(d, dff, scale=dff ** -0.5)}, 0


def attention_valid(inputs):
    """(pairs the causal mask keeps, pairs in all, key rows needed)."""
    qp, kp = inputs["QP"][..., 0, :], inputs["KP"][..., 0, :]
    keep = qp[..., :, None] >= kp[..., None, :]          # (b|1, 1, s, skv)
    b = inputs["Q"].shape[0]
    keep = keep.expand(b, *keep.shape[1:])
    hkv = inputs["KT"].shape[1]
    rows = keep.any(-2).sum().item() * hkv               # needed key rows
    return keep.sum().item(), keep.numel(), rows


def library_call(name, kin, inputs, kern):
    """One PyTorch call computing the same function, or None."""
    import torch
    import torch.nn.functional as F
    if name.startswith("attention"):
        q = inputs["Q"].flatten(1, 2)                      # (b, hq, s, dh)
        group = inputs["Q"].shape[2]
        k = inputs["KT"].repeat_interleave(group, 1)
        v = inputs["VT"].transpose(-1, -2).repeat_interleave(group, 1)
        qp, kp = inputs["QP"][..., 0, :], inputs["KP"][..., 0, :]
        mask = (qp[..., :, None] >= kp[..., None, :])[:, None]
        scale = 1.0 / math.sqrt(q.shape[-1])
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask,
                                                      scale=scale)
    if kern.entry == "emit_region" and len(kin) == 2:
        # the down projection O = H @ U with U^T (N, K) and H (M, K)
        n_out = kern.out_full[0][1]
        ut, h = kin if kin[0].shape[0] == n_out else kin[::-1]
        return lambda: torch.matmul(h, ut.T)
    return None


# -- the hand-written kernels (phases 5-7) ----------------------------------

HAND = {  # module of repro_torch.kernels: the TPU kernel it replaces
    "flash_attention": "src/repro/kernels/flash_attention.py:70",
    "rmsnorm_swiglu": "src/repro/kernels/rmsnorm_swiglu.py:58",
    "layernorm_matmul": "src/repro/kernels/layernorm_matmul.py:65",
}
HAND_FN = {  # the __global__ function of each hand kernel's source
    "flash_attention": "flash_fwd", "rmsnorm_swiglu": "swiglu_fwd",
    "layernorm_matmul": "ln_mm_fwd"}


def hand_modules():
    import importlib
    return {name: importlib.import_module(f"repro_torch.kernels.{name}")
            for name in HAND}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(in_out_bytes: int, flops: float, bf16: bool = False):
    """(least time in ms, what bounds it, the float32 bound outside the
    tensor cores or None) on the H100 data sheet."""
    t_bytes = in_out_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS if bf16 else FP32_FLOPS) * 1e3
    fma = None if bf16 else max(t_bytes, flops / FP32_FMA_FLOPS * 1e3)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), fma


def hand_cases(gen):
    """Every hand-kernel case: the shapes paths A-C and phase 12 give each
    kernel (the first of each kernel is its main shape; ``key`` is the
    shape as the kernel's ``KERNEL.shapes`` counts it, and ``main`` fails
    a path that launched a kernel at a shape no case holds), plus one
    bfloat16 case per kernel, each with its launch (grid, cluster).
    Inputs scaled as in tests/test_kernels.py.  The plain versions follow
    the kernels' splits of the key (flash), d_ff (SwiGLU) and K
    (LayerNorm+matmul) axes."""
    import torch
    import torch.nn.functional as F
    mods = hand_modules()
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    cases = []

    def attention(label, b, h, sq, skv, dh, causal, hkv=None, dtype=f32):
        hkv = hkv or h
        q = randn(b, h, sq, dh, dtype=dtype)
        k = randn(b, hkv, skv, dh, dtype=dtype)
        v = randn(b, hkv, skv, dh, dtype=dtype)
        mod = mods["flash_attention"]
        shape = mod.launch_shape(b, h, hkv, sq, skv, dh, dtype)
        kept = sum(min(skv, r + 1) for r in range(sq)) if causal \
            else sq * skv
        cases.append(dict(
            kernel="flash_attention", label=label, dtype=dtype,
            tol=(TOL, TOL) if dtype == f32 else (BF16_TOL, BF16_TOL),
            run=lambda: mod.flash_attention_cuda(q, k, v, causal=causal),
            plain=lambda: mod.plain(q, k, v, causal=causal,
                                    split=shape.split),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=hkv != h),
            grid=shape.grid, cluster=shape.split, threads=shape.threads,
            key=mod.shape_key(q, k, causal),
            bytes=nbytes(q, k, v, q), flops=4.0 * dh * kept * b * h))

    def swiglu(label, m, d, kdim, n, dtype=f32):
        x = randn(m, d, dtype=dtype)
        w = randn(d, kdim, scale=d ** -0.5, dtype=dtype)
        v = randn(d, kdim, scale=d ** -0.5, dtype=dtype)
        u = randn(kdim, n, scale=kdim ** -0.5, dtype=dtype)
        g = randn(d, scale=0.1) + 1.0
        mod = mods["rmsnorm_swiglu"]
        shape = mod.launch_shape(m, d, kdim, n, dtype)
        out = torch.empty(m, n, dtype=dtype, device="cuda")
        cases.append(dict(
            kernel="rmsnorm_swiglu", label=label, dtype=dtype,
            tol=(2 * TOL, 2 * TOL) if dtype == f32 else (BF16_TOL, BF16_TOL),
            run=lambda: mod.rmsnorm_swiglu_cuda(x, w, v, u, g),
            plain=lambda: mod.plain(x, w, v, u, g, cluster=shape.cluster,
                                    kslice=shape.kslice), library=None,
            grid=shape.grid, cluster=shape.cluster, threads=shape.threads,
            layout="X panel held" if shape.panel else "X streamed",
            smem=shape.smem, key=mod.shape_key(x, w, u),
            bytes=nbytes(x, w, v, u, g, out),
            flops=4.0 * m * d * kdim + 2.0 * m * kdim * n))

    def lnmm(label, m, kdim, n, dtype=f32):
        x = randn(m, kdim, dtype=dtype)
        y = randn(kdim, n, dtype=dtype)
        g = randn(kdim, scale=0.1) + 1.0
        bt = randn(kdim, scale=0.1)
        mod = mods["layernorm_matmul"]
        shape = mod.launch_shape(m, kdim, n, dtype)
        out = torch.empty(m, n, dtype=dtype, device="cuda")
        gc, btc = g.to(dtype), bt.to(dtype)
        cases.append(dict(
            kernel="layernorm_matmul", label=label, dtype=dtype,
            tol=((TOL * kdim ** 0.5, TOL) if dtype == f32
                 else (BF16_TOL, BF16_TOL)),
            run=lambda: mod.layernorm_matmul_cuda(x, y, g, bt),
            plain=lambda: mod.plain(x, y, g, bt, split=shape.split),
            library=None,
            context=lambda: torch.matmul(
                F.layer_norm(x, (kdim,), gc, btc), y),
            grid=shape.grid, cluster=shape.split, threads=shape.threads,
            key=mod.shape_key(x, y),
            bytes=nbytes(x, y, g, bt, out), flops=2.0 * m * kdim * n))

    attention("smollm prefill q (4,9,512,64) kv (4,3,512,64) causal",
              4, 9, 512, 512, 64, True, hkv=3)
    attention("whisper encoder (2,6,1500,64)", 2, 6, 1500, 1500, 64, False)
    attention("whisper decoder self (2,6,64,64) causal", 2, 6, 64, 64, 64,
              True)
    attention("whisper cross q (2,6,64,64) kv (2,6,1500,64)", 2, 6, 64,
              1500, 64, False)
    attention("smollm prefill bf16", 4, 9, 512, 512, 64, True, hkv=3,
              dtype=bf16)
    attention("llama prefill q (4,32,512,64) kv (4,8,512,64) causal",
              4, 32, 512, 512, 64, True, hkv=8)
    attention("internvl2-26b q (2,48,320,128) kv (2,8,320,128) causal",
              2, 48, 320, 320, 128, True, hkv=8)
    attention("smollm training q (8,9,512,64) kv (8,3,512,64) causal",
              8, 9, 512, 512, 64, True, hkv=3)
    attention("smollm drill q (4,9,128,64) kv (4,3,128,64) causal",
              4, 9, 128, 128, 64, True, hkv=3)
    swiglu("smollm x (2048,576) W/V (576,1536) U (1536,576)", 2048, 576,
           1536, 576)
    swiglu("smollm M=2048 bf16", 2048, 576, 1536, 576, dtype=bf16)
    swiglu("llama x (2048,2048) W/V (2048,8192) U (8192,2048)", 2048, 2048,
           8192, 2048)
    swiglu("llama M=2048 bf16", 2048, 2048, 8192, 2048, dtype=bf16)
    swiglu("qwen2-7b width x (256,3584) W/V (3584,18944) U (18944,3584)",
           256, 3584, 18944, 3584)
    swiglu("internvl2-26b x (640,6144) W/V (6144,16384) U (16384,6144)",
           640, 6144, 16384, 6144)
    swiglu("smollm training x (4096,576) W/V (576,1536) U (1536,576)", 4096,
           576, 1536, 576)
    swiglu("smollm drill x (512,576) W/V (576,1536) U (1536,576)", 512, 576,
           1536, 576)
    lnmm("whisper encoder x (3000,384) Y (384,1536)", 3000, 384, 1536)
    lnmm("whisper decoder x (128,384) Y (384,1536)", 128, 384, 1536)
    lnmm("whisper encoder M=3000 bf16", 3000, 384, 1536, dtype=bf16)
    return cases


def window_device_ms(calls, iters: int = 20, gap_s: float = 40e-3):
    """Device time of each ``(fn, name)`` in ``calls``, from one
    ``torch.profiler`` session: each fn runs ``iters`` times and then
    synchronizes, the runs ``gap_s`` apart on the host clock, so the
    card's timeline shows one burst of kernels a fn, the bursts split by
    idle gaps of about ``gap_s`` (a burst's own gaps are the host's enqueue
    stalls, far shorter).  The bursts are told apart on the card's own
    clock, whatever its offset against the host's
    (``profile_decode.bursts``).  A lead-in burst comes first: the
    profiler can miss a session's first kernels on the card (one run
    recorded 1 of the first fn's 20), so only the last ``len(calls)``
    bursts count.  Every kernel of a burst whose name holds ``name`` (any
    kernel where ``name`` is None) counts toward that fn.  Returns, for
    each fn, (the kernels' summed ms, the kernels recorded)."""
    import torch
    from repro_torch.launch.profile_decode import bursts
    for fn, _ in calls:
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for fn in [calls[0][0]] + [fn for fn, _ in calls]:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(gap_s)
    found = bursts([(ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA],
                   gap_s * 1e6 / 2)
    if len(found) not in (len(calls), len(calls) + 1):
        fail(f"the card's timeline holds {len(found)} bursts of kernels "
             f"for {len(calls)} timed calls and a lead-in")
    out = []
    for i, ((_, want), burst) in enumerate(zip(calls,
                                               found[-len(calls):])):
        mine = [e - s for s, e, n in burst if want is None or want in n]
        if len(mine) < iters // 2:
            fail(f"window {i}: the profiler recorded {len(mine)} kernels "
                 f"for {iters} calls")
        out.append((sum(mine) / 1e3, len(mine)))
    return out


def check_hand_kernels(cases):
    """Phase 5: every case against its plain version, then timed: CUDA
    events back to back, and the device time per call of the kernel and
    of SDPA from one profiler session."""
    import torch
    rows, done = {}, []
    for c in cases:
        name, label = c["kernel"], c["label"]
        got, want = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        if got.dtype != c["dtype"] or not torch.isfinite(got).all():
            fail(f"{name} [{label}]: {got.dtype} output, or not finite")
        err = (got.float() - want.float()).abs().max().item()
        atol, rtol = c["tol"]
        if not torch.allclose(got.float(), want.float(), atol=atol,
                              rtol=rtol):
            fail(f"{name} [{label}]: kernel disagrees with its plain "
                 f"version (max abs err {err:.3e}, atol {atol:.2e})")
        ms, plain_ms = time_ms(c["run"]), time_ms(c["plain"])
        lib_ms = time_ms(c["library"]) if c["library"] else None
        bound_ms, bound_by, fma_ms = bound(
            c["bytes"], c["flops"], c["dtype"] == torch.bfloat16)
        blocks = math.prod(c["grid"])
        case = {"shape": label, "key": c["key"], "max_abs_err": err,
                "atol": atol,
                "ms": ms, "device_ms": None, "plain_ms": plain_ms,
                "library_ms": lib_ms, "library_device_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_fma_ms": fma_ms, "flops": c["flops"],
                "bytes": c["bytes"], "grid": list(c["grid"]),
                "cluster": c["cluster"], "blocks": blocks,
                "threads": c["threads"], "layout": c.get("layout"),
                "smem": c.get("smem")}
        print(f"{name} [{label}]: max_abs_err={err:.3e} (atol {atol:.2e}) "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms} "
              f"bound_ms={bound_ms:.6f} ({bound_by}; float32 FMA bound "
              f"{fma_ms}) grid={list(c['grid'])} cluster={c['cluster']} "
              f"blocks={blocks} threads={c['threads']} layout="
              f"{c.get('layout')} smem={c.get('smem')}", flush=True)
        if name not in rows:        # the first case is the main shape
            rows[name] = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": HAND[name], "launches": 0, "cases": []}
        rows[name]["cases"].append(case)
        done.append((c, case))
    calls = []
    for c, _ in done:
        calls.append((c["run"], HAND_FN[c["kernel"]]))
        if c["library"]:
            calls.append((c["library"], None))
        if c.get("context"):
            calls.append((c["context"], None))
    iters = 20
    dev = iter(window_device_ms(calls, iters))
    for c, case in done:
        total, n = next(dev)
        if n > iters:
            fail(f"{c['kernel']} [{c['label']}]: {n} kernels in the "
                 f"profile of {iters} calls, not one a call")
        case["device_ms"] = total / n       # per launch, of those recorded
        if c["library"]:
            total, _ = next(dev)
            case["library_device_ms"] = total / iters   # per call
        if c.get("context"):
            total, n = next(dev)
            case["unfused_device_ms"] = total / iters   # per call
            print(f"{c['kernel']} [{c['label']}]: context, not the "
                  f"yardstick: unfused F.layer_norm then torch.matmul "
                  f"device_ms={case['unfused_device_ms']:.4f} per call "
                  f"({n} kernels in {iters} calls)", flush=True)
        print(f"{c['kernel']} [{c['label']}]: device_ms="
              f"{case['device_ms']:.4f} per launch (torch.profiler; CUDA "
              f"events {case['ms']:.4f}); library device_ms="
              f"{case['library_device_ms']}", flush=True)
    for row in rows.values():
        main = row["cases"][0]
        row.update({k: main[k] for k in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "bound_fma_ms", "library_ms", "library_device_ms")})
    return rows


def tensor_core_report(hand):
    """The HMMA instructions and resource use (cuobjdump) of each hand
    kernel's library; fails if a kernel redesigned for the tensor cores
    has none."""
    import shutil
    from repro_torch.core import cuda_build as CB
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, k in hand.items():
        lib = str(CB.library_path(k.key))
        sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, timeout=300)
        if sass.returncode != 0:
            fail(f"cuobjdump -sass {name}: {sass.stderr.strip()}")
        hmma = sum("HMMA" in line for line in sass.stdout.splitlines())
        res = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                             text=True, timeout=300)
        usage, func = {}, None
        for line in res.stdout.splitlines():
            if line.strip().startswith("Function "):
                # the template arguments of a mangled kernel name
                func = line.strip()[len("Function "):].rstrip(":")
                m = re.search(r"(flash_fwd|swiglu_fwd|ln_mm_fwd)I(.*?)EEv",
                              func)
                func = f"{m.group(1)}<{m.group(2)}>" if m else func
            elif "REG:" in line and func:
                regs = re.search(r"REG:(\d+) STACK:(\d+)", line)
                usage[func] = (f"{regs.group(1)} registers, "
                               f"{regs.group(2)} B stack")
        print(f"{name}: {hmma} HMMA instructions in {Path(lib).name}; "
              f"resources: {json.dumps(usage)}", flush=True)
        if name in HAND_TC and hmma == 0:
            fail(f"{name}: no HMMA instruction, the kernel does not run on "
                 "the tensor cores")


# -- the grouped expert kernel (phase 5b) ------------------------------------

#: the MoE layers phase 5b holds the grouped expert kernel to, at published
#: widths with uniformly random top-k routing: deepseek-v3-671b.chat's
#: (experts 0..7 of 256 held, top-8, drop-free at capacity factor 32),
#: qwen3-moe-30b-a3b's (all 128 held, top-8, capacity factor 1.25: some
#: assignments dropped) and path E's jamba-1.5-large-398b (2 of 16 held,
#: top-2, capacity factor 1.25), each at the rows its serving paths run
#: (deepseek: the cell's decode step and prompt buckets; qwen3-moe: phase
#: 4's; jamba: path E's decode) and on both sides of the layer's choice
#: (``layers._takes_grouped``)
GROUPED = (
    dict(arch="deepseek-v3-671b", held=8, capacity_factor=32.0,
         rows=(32, 64, 128, 256, 512)),
    dict(arch="qwen3-moe-30b-a3b", held=128, capacity_factor=1.25,
         rows=(4, 32, 64, 128, 256, 512)),
    dict(arch="jamba-1.5-large-398b", held=2, capacity_factor=1.25,
         rows=(4, 16, 32, 64, 128, 256)),
)

#: the padded layer's device time times this is the most the kernel may
#: take where the layer takes it: where a draw touches every held expert
#: (jamba's 2 at 4 rows), both read the same bytes once and tie, and the
#: two timings' noise (under 1 %) splits a tie either way
GROUPED_TIE = 1.02


def grouped_phase():
    """Phase 5b: the grouped expert kernel (``kernels/grouped_experts.py``)
    at each layer of ``GROUPED``, each row count under a uniformly random
    top-k: against its plain version and the padded layer it replaces
    (``layers._held_experts_out``: the dispatch, the three padded
    ``torch.bmm``'s and the combine), two calls bit for bit, one launch a
    call, then timed (CUDA events and one profiler session: its expert
    products alone and its four kernels, with the kernels the trace shows
    a call) beside its bound (the touched experts' weights, the
    rows in and out), its plain version, the three padded ``torch.bmm``'s
    with their SwiGLU product (the library column) and the padded layer.
    Fails where the layer takes the kernel (``layers._takes_grouped``) and
    it gives more device time than the padded layer (past
    ``GROUPED_TIE``), or where no case drops an assignment (the kernel's
    capacity branch untested)."""
    import dataclasses
    import torch
    from repro_torch import configs as C
    from repro_torch.kernels import grouped_experts as GE
    from repro_torch.kernels import ref as R
    from repro_torch.models import layers as L
    GE.KERNEL.build()
    tensor_core_report({"grouped_experts": GE.KERNEL})
    gen = torch.Generator(device="cuda").manual_seed(31)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    out, slow = [], []
    for spec in GROUPED:
        cfg = dataclasses.replace(
            C.get_config(spec["arch"]), expert_share=(0, spec["held"]),
            capacity_factor=spec["capacity_factor"])
        d, f, e, k = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, cfg.top_k
        held = spec["held"]
        p = {"we_gate": randn(held, d, f, scale=d ** -0.5),
             "we_up": randn(held, d, f, scale=d ** -0.5),
             "we_down": randn(held, f, d, scale=f ** -0.5)}
        wg, wu, wd = p["we_gate"], p["we_up"], p["we_down"]
        cases = []
        for t in spec["rows"]:
            cap = L.moe_capacity(t, cfg)
            x = randn(t, d)
            ids = torch.rand(t, e, generator=gen, device="cuda").topk(
                k, -1)[1]
            w = torch.rand(t, k, generator=gen, device="cuda")
            eb = randn(held, cap, d)     # the padded path's buffer

            def kernel(x=x, w=w, ids=ids, cap=cap):
                return GE.grouped_moe_cuda(x, w, ids, wg, wu, wd, 0, cap)

            def plain(x=x, w=w, ids=ids, cap=cap):
                return GE.plain(x, w, ids, wg, wu, wd, 0, cap)

            def library(eb=eb):
                return torch.bmm(R.swish(torch.bmm(eb, wg))
                                 * torch.bmm(eb, wu), wd)

            def padded(x=x, w=w, ids=ids, cap=cap):
                return L._held_experts_out(p, x, w, ids, cap, 0, held, e)

            label = f"grouped experts [{spec['arch']} t {t} cap {cap}]"
            before = GE.KERNEL.launches
            got = kernel()
            launches = GE.KERNEL.launches - before
            want = plain()
            torch.cuda.synchronize()
            err = (got[0] - want[0]).abs().max().item()
            if launches != 1 or not (
                    torch.equal(got[1], want[1])
                    and torch.equal(got[2], want[2])
                    and torch.allclose(got[0], want[0], atol=TOL, rtol=TOL)):
                fail(f"{label}: {launches} launches; the kernel disagrees "
                     f"with its plain version (max abs err {err:.3e})")
            if not all(torch.equal(a, b) for a, b in zip(kernel(), got)):
                fail(f"{label}: two calls differ")
            pad_err = (got[0] - padded()).abs().max().item()
            if pad_err > TOL * max(1.0, got[0].abs().max().item()):
                fail(f"{label}: the kernel disagrees with the padded layer "
                     f"(max abs err {pad_err:.3e})")
            n_host = got[1].cpu()
            demand = torch.bincount(ids[ids < held].cpu(), minlength=held)
            rows = int(n_host.sum())
            if int(got[2][t]) != rows:
                fail(f"{label}: rows computed {int(got[2][t])} != {rows}")
            touched = int((n_host > 0).sum())
            # the touched experts' three matrices, x in, the routed output
            nbytes_ = (touched * 3 * d * f + 2 * t * d) * 4
            flops = 2.0 * rows * 3 * d * f
            bound_ms, bound_by, _ = bound(nbytes_, flops)
            cases.append(dict(
                t=t, capacity=cap, takes_kernel=L._takes_grouped(p, x, ids,
                                                                 e),
                touched=touched, rows=rows,
                passes=int(sum(-(-n // GE.RT) for n in n_host.tolist())),
                dropped=int((demand - n_host.long()).sum()),
                max_abs_err=err, padded_max_abs_err=pad_err,
                launches_a_call=launches,
                ms=time_ms(kernel), plain_ms=time_ms(plain, 5),
                library_ms=time_ms(library), padded_layer_ms=time_ms(padded),
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes_,
                flops=flops, grid_gate_up=[-(-f // GE.BN), held],
                grid_down=[-(-d // GE.BN), held],
                calls=(kernel, kernel, library, padded)))
        iters = 20
        dev = iter(window_device_ms(
            [(fn, name) for c in cases for fn, name in
             zip(c["calls"], ("grouped_fwd", None, None, None))], iters))
        for c in cases:
            for key in ("products_device_ms", "device_ms",
                        "library_device_ms", "padded_layer_device_ms"):
                ms_, seen = next(dev)
                c[key] = ms_ / iters                   # per call
                if key in ("products_device_ms", "device_ms"):
                    # the kernels the trace shows a call: gate/up and
                    # down; all four
                    c[key.replace("device_ms", "traced_a_call")] = (
                        seen / iters)
            c["device_over_bound"] = c["device_ms"] / c["bound_ms"]
            c["over_padded"] = c["device_ms"] / c["padded_layer_device_ms"]
            del c["calls"]
            print(f"grouped experts [{spec['arch']} t {c['t']} cap "
                  f"{c['capacity']}] takes kernel {c['takes_kernel']}: "
                  f"touched {c['touched']} of {held}, rows {c['rows']} in "
                  f"{c['passes']} passes, dropped {c['dropped']}, "
                  f"max_abs_err={c['max_abs_err']:.3e} device_ms="
                  f"{c['device_ms']:.4f} (expert products "
                  f"{c['products_device_ms']:.4f}; events {c['ms']:.4f}) "
                  f"bound_ms={c['bound_ms']:.4f} ({c['bound_by']}; "
                  f"x{c['device_over_bound']:.2f}) plain_ms="
                  f"{c['plain_ms']:.4f} library (3 bmm + SwiGLU) "
                  f"device_ms={c['library_device_ms']:.4f} (events "
                  f"{c['library_ms']:.4f}); padded layer "
                  f"{c['padded_layer_device_ms']:.4f} device ms (kernel "
                  f"x{c['over_padded']:.2f}); traced a call: "
                  f"{c['traced_a_call']:g} kernels, "
                  f"{c['products_traced_a_call']:g} grouped_fwd",
                  flush=True)
            if c["takes_kernel"] and c["over_padded"] > GROUPED_TIE:
                slow.append(f"{spec['arch']} t {c['t']}")
        out.append(dict(arch=spec["arch"], d=d, f=f, experts=e, held=held,
                        top_k=k, capacity_factor=spec["capacity_factor"],
                        cases=cases))
        del p, wg, wu, wd
        torch.cuda.empty_cache()
    if not any(c["dropped"] for o in out for c in o["cases"]):
        fail("grouped experts: no case dropped an assignment")
    if slow:
        fail(f"grouped experts: the kernel is slower than the padded layer "
             f"where the layer takes it: {slow}")
    return {"card": card_line(), "layers": out}


def check_backward(gen):
    """Phase 6, a plumbing check of each kernel's autograd.Function (not
    a test of the kernel: the backward is autograd of the plain oracle by
    design).  The forward must launch the kernel once; the backward must
    give finite gradients of the inputs' shapes, equal to autograd of the
    oracle alone (``impl="ref"``), for a call where only some inputs need
    one (``needs_input_grad``)."""
    import torch
    from repro_torch.kernels import ops as K
    mods = hand_modules()

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale \
            + shift

    calls = {
        "flash_attention": (
            lambda impl, q, k, v: K.flash_attention(q, k, v, causal=True,
                                                    impl=impl),
            [randn(2, 9, 128, 64), randn(2, 3, 128, 64),
             randn(2, 3, 128, 64)]),
        "rmsnorm_swiglu": (
            lambda impl, *a: K.rmsnorm_swiglu(*a, impl=impl),
            [randn(256, 576), randn(576, 1536, scale=576 ** -0.5),
             randn(576, 1536, scale=576 ** -0.5),
             randn(1536, 576, scale=1536 ** -0.5),
             randn(576, scale=0.1, shift=1.0)]),
        "layernorm_matmul": (
            lambda impl, *a: K.layernorm_matmul(*a, impl=impl),
            [randn(256, 384), randn(384, 1536),
             randn(384, scale=0.1, shift=1.0), randn(384, scale=0.1)]),
    }
    for name, (fn, args) in calls.items():
        for a in args[:-1]:           # the last input needs no gradient
            a.requires_grad_(True)
        wanted = args[:-1]
        kernel = mods[name].KERNEL
        before = kernel.launches
        out = fn("cuda", *args)
        if kernel.launches != before + 1:
            fail(f"{name}: the autograd.Function's forward launched the "
                 f"kernel {kernel.launches - before} times, not once")
        ct = torch.randn(out.shape, generator=gen, device="cuda")
        got = torch.autograd.grad(out, wanted, ct)
        want = torch.autograd.grad(fn("ref", *args), wanted, ct)
        torch.cuda.synchronize()
        for a, g, w in zip(wanted, got, want):
            if g.shape != a.shape or not torch.isfinite(g).all():
                fail(f"{name}: gradient of shape {tuple(g.shape)} for an "
                     f"input of {tuple(a.shape)}, or not finite")
            if not torch.allclose(g, w, atol=1e-4, rtol=1e-4):
                fail(f"{name}: the backward is not autograd of the oracle")
        print(f"{name}: autograd.Function plumbing ok (forward launched "
              f"the kernel; {len(wanted)} of {len(args)} gradients, shaped "
              "as their inputs)", flush=True)


def run_path(label, call, plain_call, expect, kernels):
    """Phase 7: one warm call; one call with every launch counter set to 0
    just before and read just after, whose logits are held against the
    same call on the plain impls; then ``PATH_REPEATS`` calls, each timed
    on the host clock between two synchronizations.  Returns the counts,
    the times, the logits' distance and the launches by shape."""
    import torch
    call()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
        k.shapes.clear()
    logits = call()
    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in kernels.items()}
    shapes = {name: dict(k.shapes) for name, k in kernels.items()}
    if counts != expect:
        fail(f"{label}: launches {counts}, expected {expect}")
    if not torch.isfinite(logits).all():
        fail(f"{label}: non-finite logits")
    want = plain_call()
    torch.cuda.synchronize()
    diff = (logits - want).abs().max().item()
    if diff > PATH_TOL:
        fail(f"{label}: logits differ from the plain impls by {diff:.3e}")
    del logits, want
    times = []
    for _ in range(PATH_REPEATS):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    timing = {"median_ms": statistics.median(times), "min_ms": min(times),
              "max_ms": max(times), "calls": len(times)}
    print(f"{label}: median {timing['median_ms']} ms per call over "
          f"{len(times)} calls (min {timing['min_ms']}, max "
          f"{timing['max_ms']}), launches {counts}, logits within "
          f"{diff:.3e} of the plain impls", flush=True)
    return counts, timing, diff, shapes


def run_paths(kernels, phase_s):
    """Path A (smollm-135m forward and prefill), path B (whisper-tiny
    prefill) and path C (llama3.2-1b forward and prefill) on the hand
    kernels, full width and depth, seeded random weights; each path's
    seconds into ``phase_s``."""
    import torch
    from repro_torch import configs as C
    from repro_torch.models.lm import build_model

    def models(arch, **overrides):
        cfg = dataclasses.replace(C.get_config(arch), dtype=torch.float32,
                                  attn_impl="cuda", mlp_impl="cuda",
                                  **overrides)
        plain = dataclasses.replace(cfg, attn_impl="ref",
                                    mlp_impl="fused_ref")
        return cfg, build_model(cfg), build_model(plain)

    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    t0 = time.perf_counter()
    cfg, hand, plain = models("smollm-135m")
    params = hand.init_params(seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab, (4, 512), generator=gen,
                         device="cuda")
    a = {"flash_attention": 30, "rmsnorm_swiglu": 30, "layernorm_matmul": 0}
    with torch.no_grad():
        out["A forward"] = run_path(
            "path A: smollm-135m LM.forward (4 x 512)",
            lambda: hand.forward(params, toks),
            lambda: plain.forward(params, toks), a, kernels)
        out["A prefill"] = run_path(
            "path A: smollm-135m LM.prefill (4 x 512, max_len 512)",
            lambda: hand.prefill(params, toks, max_len=512)[0],
            lambda: plain.prefill(params, toks, max_len=512)[0], a, kernels)
    del params
    phase_s["7 path A"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, hand, plain = models("whisper-tiny")
    params = hand.init_params(seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                         device="cuda")
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=gen,
                         device="cuda")
    b = {"flash_attention": 12, "rmsnorm_swiglu": 0, "layernorm_matmul": 8}
    with torch.no_grad():
        out["B prefill"] = run_path(
            "path B: whisper-tiny EncDec.prefill (2 x 1500 frames, 64 "
            "tokens, max_len 128)",
            lambda: hand.prefill(params, toks, frames, max_len=128)[0],
            lambda: plain.prefill(params, toks, frames, max_len=128)[0], b,
            kernels)
    del params
    phase_s["7 path B"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, hand, plain = models("llama3.2-1b")
    params = hand.init_params(seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab, (4, 512), generator=gen,
                         device="cuda")
    c = {"flash_attention": 16, "rmsnorm_swiglu": 16, "layernorm_matmul": 0}
    with torch.no_grad():
        out["C forward"] = run_path(
            "path C: llama3.2-1b LM.forward (4 x 512)",
            lambda: hand.forward(params, toks),
            lambda: plain.forward(params, toks), c, kernels)
        out["C prefill"] = run_path(
            "path C: llama3.2-1b LM.prefill (4 x 512, max_len 512)",
            lambda: hand.prefill(params, toks, max_len=512)[0],
            lambda: plain.prefill(params, toks, max_len=512)[0], c, kernels)
    del params
    torch.cuda.empty_cache()
    phase_s["7 path C"] = time.perf_counter() - t0
    return out


def greedy_against_forward(model, params, prompt, seq):
    """``LM.prefill`` of ``prompt`` (max_len ``seq``), greedy
    ``LM.decode_step``s to ``seq``, then ``LM.forward`` over the tokens
    they made.  Returns the prefill and decode logits (positions 0 ..
    seq - 1), the forward pass's, the tokens and each decode step's ms
    between two synchronizations."""
    import torch
    p0, step_ms = prompt.shape[1], []
    lg, cache = model.prefill(params, prompt, max_len=seq)
    steps, toks = [lg], [prompt]
    for i in range(seq - p0):
        nxt = steps[-1][:, -1].argmax(-1)[:, None]
        toks.append(nxt)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = model.decode_step(params, cache, nxt, p0 + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        steps.append(lg)
    toks = torch.cat(toks, 1)
    got = torch.cat(steps, 1)
    del steps, lg, cache
    return got, model.forward(params, toks), toks, step_ms


def allowance_used(got, want):
    """The largest share of the reference's allowance, ``|got - want| <=
    atol + rtol |want|`` at ``atol = rtol = PATH_TOL``, that any logit
    uses (1 or less passes), and the max abs difference."""
    err = (got.double() - want.double()).abs()
    return ((err / (PATH_TOL + PATH_TOL * want.double().abs())).max().item(),
            err.max().item())


def run_path_d(phase_s):
    """Path D: ``PATH_D``'s mamba2-2.7b at full width and depth, seeded
    random weights drawn on the card; no kernel runs on it (the
    reference's SSD is plain XLA, layers.py:662-820; the port's is plain
    torch on the card).  :func:`greedy_against_forward` from ``prefill``
    tokens to ``seq``: the logits finite and of their shapes, then the
    medians of ``PATH_REPEATS`` forward and prefill calls and each decode
    step's time.

    The prefill and decode logits are held against the forward pass's by
    the reference's own rule (tests/test_models_decode.py:21-37:
    ``assert_allclose`` at ``atol = rtol = 1e-4`` on the CPU), here at
    ``atol = rtol = PATH_TOL``, on the first ``rule_layers`` layers of the
    same weights at the same widths and tokens.  At the full 64 layers
    two float32 evaluations cannot be held to it: the float32 forward pass
    itself lies several times the allowance from the same model's float64
    forward pass (PERF.md).  So the full depth's distances (prefill and
    decode against forward, each against the float64 forward) are
    measured and printed, not gated."""
    import torch
    from repro_torch import configs as C
    from repro_torch.launch import profile_decode as PD
    from repro_torch.models.lm import build_model
    t0 = time.perf_counter()
    cfg = dataclasses.replace(C.get_config(PATH_D["arch"]),
                              dtype=torch.float32)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(seed=0, device="cuda")
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    b, seq, p0 = PATH_D["batch"], PATH_D["seq"], PATH_D["prefill"]
    n_rule = PATH_D["rule_layers"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    prompt = torch.randint(0, cfg.vocab, (b, p0), generator=gen,
                           device="cuda")
    label = (f"path D: {cfg.name} ({cfg.n_layers} layers, d "
             f"{cfg.d_model}, {cfg.n_ssm_heads} SSM heads of "
             f"{cfg.ssm_head_dim}, state {cfg.ssm_state})")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    with torch.no_grad():
        got, full, toks, step_ms = greedy_against_forward(model, params,
                                                          prompt, seq)
        if got.shape != (b, seq, cfg.vocab) or full.shape != got.shape \
                or not torch.isfinite(got).all() \
                or not torch.isfinite(full).all():
            fail(f"{label}: logits {tuple(got.shape)} against "
                 f"{tuple(full.shape)}, or not finite")
        used, diff = allowance_used(got, full)
        used_dec, diff_dec = allowance_used(got[:, p0:], full[:, p0:])
        # the float64 yardstick: the same model and tokens in float64
        m64 = build_model(dataclasses.replace(cfg, dtype=torch.float64))
        p64 = {k: ([{n: ({w: t.double() for w, t in v.items()}
                         if isinstance(v, dict) else v.double())
                     for n, v in lay.items()} for lay in val]
                   if k == "layers" else val.double())
               for k, val in params.items()}
        full64 = m64.forward(p64, toks)
        del p64
        used_f64, diff_f64 = allowance_used(full, full64)
        used_g64, diff_g64 = allowance_used(got, full64)
        del got, full, full64
        # the reference's rule where float32 can hold it
        cut = dataclasses.replace(cfg, n_layers=n_rule)
        got_c, full_c, _, _ = greedy_against_forward(
            build_model(cut), dict(params, layers=params["layers"][:n_rule]),
            prompt, seq)
        used_c, diff_c = allowance_used(got_c, full_c)
        del got_c, full_c
        if used_c > 1.0:
            fail(f"{label}: at {n_rule} layers the prefill and decode "
                 f"logits differ from the forward pass's by {diff_c:.3e}, "
                 f"{used_c:.3f} of the allowance atol = rtol = {PATH_TOL}")
        fwd = [timed(lambda: model.forward(params, toks))
               for _ in range(PATH_REPEATS)]
        pre = [timed(lambda: model.prefill(params, prompt, max_len=seq))
               for _ in range(PATH_REPEATS)]
    peak = torch.cuda.max_memory_allocated()
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": b,
           "seq": seq, "prefill": p0, "decode_steps": seq - p0,
           "rule_layers": n_rule, "rule_max_abs_diff": diff_c,
           "rule_allowance_used": used_c,
           "max_abs_diff_vs_forward": diff, "allowance_used": used,
           "decode_max_abs_diff_vs_forward": diff_dec,
           "decode_allowance_used": used_dec,
           "forward_vs_float64": diff_f64,
           "forward_vs_float64_allowance_used": used_f64,
           "prefill_decode_vs_float64": diff_g64,
           "prefill_decode_vs_float64_allowance_used": used_g64,
           "forward_median_ms": statistics.median(fwd),
           "forward_min_ms": min(fwd), "forward_max_ms": max(fwd),
           "prefill_median_ms": statistics.median(pre),
           "prefill_min_ms": min(pre), "prefill_max_ms": max(pre),
           "decode_step_median_ms": statistics.median(step_ms),
           "decode_step_min_ms": min(step_ms),
           "decode_step_max_ms": max(step_ms), "calls": PATH_REPEATS,
           "weights": sum(t.numel() for t in PD._tensors(params)),
           "weights_s": weights_s, "max_memory_allocated": peak}
    print(f"{label}: at {n_rule} layers prefill + {seq - p0} greedy decode "
          f"steps within {diff_c:.3e} of LM.forward ({b} x {seq}; "
          f"{used_c:.3f} of the allowance atol = rtol = {PATH_TOL}); at "
          f"{cfg.n_layers} layers {diff:.3e} ({used:.3f}; decode steps "
          f"{diff_dec:.3e}, {used_dec:.3f}), where the float32 forward "
          f"lies {diff_f64:.3e} ({used_f64:.3f}) and prefill + decode "
          f"{diff_g64:.3e} ({used_g64:.3f}) from the float64 forward; "
          f"median of {PATH_REPEATS} calls: forward "
          f"{rec['forward_median_ms']} ms, prefill ({p0} tokens) "
          f"{rec['prefill_median_ms']} ms; decode step median "
          f"{rec['decode_step_median_ms']} ms (min "
          f"{rec['decode_step_min_ms']}, max {rec['decode_step_max_ms']}); "
          f"weights drawn in {weights_s:.2f} s; max_memory_allocated "
          f"{peak} B; {card_line()}", flush=True)
    del params
    torch.cuda.empty_cache()
    phase_s["7 path D"] = time.perf_counter() - t0
    return rec


def cell_config():
    """qwen2-7b's model config as :data:`CELL`'s kernels are compiled for
    it (one layer: phase 3 draws no weights of its own)."""
    from repro_torch.launch import serve as S
    return S.model_config(S.ServeConfig(
        arch=CELL["arch"], n_layers=1, max_batch=CELL["max_batch"],
        max_len=CELL["max_len"], prompt_buckets=CELL["prefill_lens"]))


def path_e_config(**over):
    """Path E's model configuration (``PATH_E``) on the emitted kernels;
    ``over`` replaces fields (the plain impls, a capacity factor)."""
    import torch
    from repro_torch import configs as C
    from repro_torch.launch import serve as S
    cfg = S.cut_depth(C.get_config(PATH_E["arch"]), PATH_E["n_layers"])
    cfg = dataclasses.replace(cfg, dtype=torch.float32,
                              expert_share=PATH_E["experts"])
    return dataclasses.replace(C.with_pipeline(cfg, backend="cuda"), **over)


def path_e_programs(cfg, device="cuda"):
    """The emitted programs path E runs, by name: attention and SwiGLU at
    the prefill's and the forward pass's lengths over the batch, and the
    decode pair over ``seq`` cached positions."""
    from repro_torch.models import layers as L
    return L.pipeline_kernels(
        cfg, prefill_lens=(PATH_E["prefill"], PATH_E["seq"]),
        decode_batch=PATH_E["batch"], max_len=PATH_E["seq"], device=device,
        prefill_batch=PATH_E["batch"])


def path_e_launches(cfg, programs):
    """Each emitted kernel's launches in path E's counted run (prefill,
    the greedy decode steps, then the forward pass): one a call of each
    attention layer's program, one a call of each SwiGLU layer's."""
    n_attn = sum(cfg.mixer_of(i) == "attn" for i in range(cfg.n_layers))
    n_mlp = sum(cfg.mlp_of(i) == "swiglu" for i in range(cfg.n_layers))
    steps = PATH_E["seq"] - PATH_E["prefill"]
    per = {"attention_decode": n_attn * steps, "swiglu_decode": n_mlp * steps}
    for s_ in (PATH_E["prefill"], PATH_E["seq"]):
        per[f"attention_prefill{s_}"] = n_attn
        per[f"swiglu_prefill{s_}"] = n_mlp
    return {f"{cfg.name}/{prog}/{k.gid}": per[prog]
            for prog, ck in programs.items() for k in ck.kernels}


def path_e_decode_split(model, params, prompt, seq, programs, steps):
    """Path E's decode step by class of work, from
    ``profile_decode.profile_steps`` over ``steps`` decode steps after a
    prefill of ``prompt``: the emitted attention and SwiGLU kernels by
    name; the torch ops' kernels by the model span they were launched in
    (``repro_torch.tracing``: ``mamba``, ``moe``), the rest (embedding,
    attention layers' norms and projections, the SwiGLU layers, the head)
    as other torch ops; the card's busy time and the host's idle time, the
    steps' wall time less the busy time.  Returns ms per step."""
    from repro_torch.launch import profile_decode as PD
    p0 = prompt.shape[1]
    _, cache = model.prefill(params, prompt, max_len=seq)
    tok = prompt[:, -1:].contiguous()
    prof = PD.profile_steps(
        lambda i: model.decode_step(params, cache, tok, p0 + i), steps)
    classes = {"mamba": {}, "moe": {}, "other": {}}
    for span, part in prof["device_ms_per_step_by_class"].items():
        into = classes[span if span in ("mamba", "moe") else "other"]
        for n, ms in part.items():
            into[n] = into.get(n, 0.0) + ms
    emitted = {part: {k.kname for k in programs[f"{part}_decode"].kernels}
               for part in ("attention", "swiglu")}
    out = {f"{part} kernels": sum(
        ms for n, ms in prof["device_ms_per_step_by_kernel"].items()
        if kernel_name(n) in names) for part, names in emitted.items()}
    every = set().union(*emitted.values())
    for cls, part in classes.items():
        out[f"{cls} torch ops"] = sum(
            ms for n, ms in part.items() if kernel_name(n) not in every)
    missing = [k for k, v in out.items() if v <= 0]
    if missing:
        fail(f"path E: the decode profile saw no device time of {missing}")
    busy = prof["device_busy_ms"] / steps
    wall = prof["profiled_window_ms"] / steps
    out.update({"device busy": busy, "host idle": max(wall - busy, 0.0),
                "step_wall_ms": wall, "host_step_ms": prof["host_step_ms"],
                "unattributed_ms": busy - sum(out.values())})
    return out


def rel_max(got, want) -> float:
    """The largest difference over the largest magnitude of ``want``."""
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def path_e_layers(model, plain, params, prompt, seq):
    """Path E's layers one at a time, each on the emitted kernels
    (``model``) and on the plain impls (``plain``: ``ref`` attention, the
    ``unfused`` SwiGLU), both fed the emitted chain's input: the mixer's
    and the MLP's residual increments over the prompt and for one decode
    step after it, and the cache entries each mixer writes (prefill: also
    the slot of ``LM.prefill``'s own cache).  Every kernel of the path
    feeds the stream here, where the logits see only what rises above the
    residual stream's float32 rounding (PERF.md, C18).  Returns each
    quantity's :func:`rel_max`, by name."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.lm import CACHE_NAMES
    cfg, p0 = model.cfg, prompt.shape[1]
    out = {}
    _, caches = model.prefill(params, prompt, max_len=seq)
    x = model._embed(params, prompt)
    xd = model._embed(params, prompt[:, -1:])
    for i, p in enumerate(params["layers"]):
        mixer, slot = model.mixers[i], model.slots[i]
        y, cache = model._prefill_mixer(p, x, i, seq)
        y_p, cache_p = plain._prefill_mixer(p, x, i, seq)
        out[f"prefill {i} {mixer}"] = rel_max(y, y_p)
        for name, t in cache_p.items():
            out[f"prefill {i} {name}"] = rel_max(cache[name], t)
            out[f"prefill {i} {name} slot {slot}"] = rel_max(
                caches[name][slot], t)
        del cache, cache_p
        step = {name: caches[name][slot]
                for name in CACHE_NAMES[mixer]}
        step_p = {name: t.clone() for name, t in step.items()}
        yd = model._decode_mixer(p, xd, i, step, p0)
        yd_p = plain._decode_mixer(p, xd, i, step_p, p0)
        out[f"decode {i} {mixer}"] = rel_max(yd, yd_p)
        for name, t in step_p.items():
            out[f"decode {i} {name}"] = rel_max(step[name], t)
        del step_p
        x, xd = x + y, xd + yd
        if cfg.mlp_of(i) != "none":
            for what, h in (("prefill", x), ("decode", xd)):
                m = L.mlp_apply(p["mlp"], h, p["ln2"], cfg, i)
                m_p = L.mlp_apply(p["mlp"], h, p["ln2"], plain.cfg, i)
                out[f"{what} {i} {cfg.mlp_of(i)}"] = rel_max(m, m_p)
                if what == "prefill":
                    x = x + m
                else:
                    xd = xd + m
    torch.cuda.synchronize()
    return out


def float64_forward(cfg, params, toks):
    """``LM.forward`` of ``cfg`` over ``toks`` in float64 on the plain
    impls, attention too (``attention_at_input_precision``), one layer at
    a time on the card: each layer's float32 weights are copied to float64
    only while it runs, since a float64 copy of path E would not fit
    beside them.  The folded SwiGLU copies of the emitted path are freed
    first.  Returns the logits on the host."""
    import torch
    from unittest import mock
    from torch.utils import _pytree as pytree
    from repro_torch.kernels import ref as R
    from repro_torch.models import layers as L
    from repro_torch.models.lm import LM
    L._FOLDED.clear()
    torch.cuda.empty_cache()
    m64 = LM(dataclasses.replace(cfg, dtype=torch.float64, **PLAIN_IMPLS))

    def f64(tree):
        return pytree.tree_map(lambda t: t.double(), tree)

    with mock.patch.object(R, "attention_ref",
                           attention_at_input_precision):
        x = params["embed"][toks].double()
        for i, layer in enumerate(params["layers"]):
            x = m64._layer(f64(layer), x, i)
        logits = m64._logits(f64({k: params[k] for k in ("ln_f", "head")}),
                             x)
    return logits.cpu()


def greedy_distance(got, toks, want, want_toks, p0):
    """Two greedy runs from the same prompt (:func:`greedy_against_forward`
    logits and tokens): the prefill logits' max abs difference, the decode
    logits' up to each sequence's first differing token, the sequences
    whose tokens are all equal, and each one's first differing step."""
    seq = toks.shape[1]
    pre = (got[:, :p0] - want[:, :p0]).abs().max().item()
    dec, same, first = 0.0, 0, []
    for r in range(toks.shape[0]):
        neq = (toks[r, p0:] != want_toks[r, p0:]).nonzero()
        upto = seq if len(neq) == 0 else p0 + neq[0].item()
        same += len(neq) == 0
        first.append(None if len(neq) == 0 else upto - p0)
        if upto > p0:
            dec = max(dec, (got[r, p0:upto] - want[r, p0:upto]
                            ).abs().max().item())
    return pre, dec, same, first


def run_path_e():
    """Path E (``PATH_E``), in a child process of its own (this script with
    ``--path-e``), so that its ~60 GB and its profiler session end with it:
    jamba-1.5-large-398b's first period at published widths, float32,
    seeded weights drawn on the card, 2 of its 16 experts held, attention
    and SwiGLU on the emitted kernels (phase 2 built them; here they load).

    * The counted run: with every launch counter of path E's kernels set
      to 0 just before and read just after, ``LM.prefill`` of ``prefill``
      tokens, greedy ``LM.decode_step``s to ``seq``, then ``LM.forward``
      over the tokens they made (:func:`greedy_against_forward`); the
      counts exact (:func:`path_e_launches`), the logits finite.
    * The same run with the emitted programs' plain versions (the
      pipeline's ``torch`` backend: the serving phases' yardstick), on the
      same weights: the prefill logits within ``PATH_TOL``; the greedy
      tokens equal, or the decode logits within ``PATH_TOL`` up to each
      sequence's first differing token; the forward pass's logits over
      the counted run's tokens within ``PATH_TOL``.  All at the published
      capacity factor, 1.25, where the tokens of a call decide the drops,
      so prefill and decode cannot equal the forward pass (in the
      reference either).  The forward pass on the plain impls
      (``PLAIN_IMPLS``) is printed beside them: at these widths two
      float32 evaluations that sum in other orders lie about ``PATH_TOL``
      apart at the logits, as each lies from a float64 one (the
      reference's expert init, fan-in the expert count, puts the
      residual stream near 10^4; PERF.md), so the logits see a layer's
      work only where it rises above that stream's rounding: past the
      first MoE layer, an attention or SwiGLU layer hardly at all.
    * Layer by layer (:func:`path_e_layers`): each mixer's and MLP's
      increment and each cache entry, prefill and one decode step, on the
      emitted kernels and on the plain impls from the same input, within
      ``LAYER_TOL`` of the plain one's largest magnitude.
    * At ``drop_free_capacity`` (8.0: no assignment dropped at any of the
      run's token counts) prefill then decode on the emitted kernels held
      against the forward pass over the tokens they made by the
      reference's rule (tests/test_models_decode.py:17-37) at ``atol =
      rtol = PATH_TOL``, the forward pass in float64
      (:func:`float64_forward`); the float32 forward pass's distances to
      both printed beside it.
    * Times: the weights' draw, the median of ``repeats`` forward and
      prefill calls, each decode step of the counted run; the decode
      step's device ms by class (:func:`path_e_decode_split`) beside its
      bound (``profile_decode.step_cost``); ``max_memory_allocated``.
    Returns the record, with the launches by kernel."""
    import torch
    from repro_torch.core import codegen_cuda as CC
    from repro_torch.launch import profile_decode as PD
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    cfg = path_e_config()
    programs = path_e_programs(cfg)
    for prog, ck in programs.items():
        on_requested_rung(f"path E {prog}", ck)
        if ck.lowering_report.degraded:
            fail(f"path E {prog}: planned groups split into per-region "
                 f"kernels: {ck.lowering_report.degraded}")
    kernels = {f"{cfg.name}/{prog}/{k.gid}": k
               for prog, ck in programs.items() for k in ck.kernels}
    CC.build(list(kernels.values()))
    compile_s = time.perf_counter() - t0
    b, seq, p0 = PATH_E["batch"], PATH_E["seq"], PATH_E["prefill"]
    base, count = cfg.held_experts
    model = LM(cfg)
    lowering = LM(dataclasses.replace(cfg, pipeline_backend="torch"))
    plain = LM(dataclasses.replace(cfg, **PLAIN_IMPLS))
    drop_free = dataclasses.replace(
        cfg, capacity_factor=PATH_E["drop_free_capacity"])
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    params = model.init_params(seed=0, device="cuda")
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t1
    weights = sum(t.numel() for t in PD._tensors(params))
    gen = torch.Generator(device="cuda").manual_seed(17)
    toks = torch.randint(0, cfg.vocab, (b, seq), generator=gen,
                         device="cuda")
    prompt = toks[:, :p0]
    label = (f"path E: {cfg.name} ({cfg.n_layers} of 72 layers, d "
             f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
             f"{cfg.d_head}, no rope, d_ff {cfg.d_ff}, experts {base}.."
             f"{base + count - 1} of {cfg.n_experts}, top-{cfg.top_k})")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    expect = path_e_launches(cfg, programs)
    with torch.no_grad():
        for k in kernels.values():
            k.launches = 0
        got, full, toks_e, step_ms = greedy_against_forward(
            model, params, prompt, seq)
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items()}
        if launches != expect:
            fail(f"{label}: launches {launches}, expected {expect}")
        if got.shape != (b, seq, cfg.vocab) or full.shape != got.shape \
                or not torch.isfinite(got).all() \
                or not torch.isfinite(full).all():
            fail(f"{label}: logits {tuple(got.shape)} against "
                 f"{tuple(full.shape)}, or not finite")
        used_125, diff_125 = allowance_used(got, full)
        got_t, full_t, toks_t, step_ms_t = greedy_against_forward(
            lowering, params, prompt, seq)
        pre_diff, dec_diff, same, first_diff = greedy_distance(
            got, toks_e, got_t, toks_t, p0)
        if not torch.equal(toks_e, toks_t):
            full_t = lowering.forward(params, toks_e)
        fwd_diff = (full - full_t).abs().max().item()
        del got, got_t, full_t
        for what, d in (("prefill", pre_diff), ("decode", dec_diff),
                        ("forward", fwd_diff)):
            if d > PATH_TOL:
                fail(f"{label}: {what} logits differ from the emitted "
                     f"programs' plain versions' by {d:.3e}")
        used_plain, diff_plain = allowance_used(
            full, plain.forward(params, toks_e))
        del full
        layers = path_e_layers(model, plain, params, prompt, seq)
        worst = max(layers, key=layers.get)
        if layers[worst] > LAYER_TOL:
            fail(f"{label}: layer by layer against the plain impls, "
                 f"{worst} differs by {layers[worst]:.3e} of its largest "
                 f"value (limit {LAYER_TOL}): {json.dumps(layers)}")
        got8, full8, toks8, _ = greedy_against_forward(
            LM(drop_free), params, prompt, seq)
        got8, full8 = got8.cpu(), full8.cpu()
        used8_f32, diff8_f32 = allowance_used(got8, full8)
        fwd = [timed(lambda: model.forward(params, toks))
               for _ in range(PATH_E["repeats"])]
        pre = [timed(lambda: model.prefill(params, prompt, max_len=seq))
               for _ in range(PATH_E["repeats"])]
        split = path_e_decode_split(model, params, prompt, seq, programs,
                                    PATH_E["profile_steps"])
        _, cache = model.prefill(params, prompt, max_len=seq)
        step_bytes, step_ops = PD.step_cost(cfg, params, cache, b, p0, seq)
        del cache
        peak = torch.cuda.max_memory_allocated()
        full64 = float64_forward(drop_free, params, toks8)
    used64, diff64 = allowance_used(full8, full64)
    used8, diff8 = allowance_used(got8, full64)
    del got8, full8, full64
    if used8 > 1.0:
        fail(f"{label}: at capacity factor {PATH_E['drop_free_capacity']} "
             f"prefill and decode differ from the float64 forward pass by "
             f"{diff8:.3e}, {used8:.3f} of the allowance atol = rtol = "
             f"{PATH_TOL} (from the float32 forward pass {diff8_f32:.3e}, "
             f"{used8_f32:.3f}; the float32 forward from the float64 one "
             f"{diff64:.3e}, {used64:.3f})")
    t_bytes = step_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = step_ops / FP32_FMA_FLOPS * 1e3
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "experts_held": [base, count], "n_experts": cfg.n_experts,
           "batch": b, "seq": seq, "prefill": p0, "decode_steps": seq - p0,
           "capacity_factor": cfg.capacity_factor,
           "prefill_max_abs_diff_vs_lowering": pre_diff,
           "decode_max_abs_diff_vs_lowering": dec_diff,
           "forward_max_abs_diff_vs_lowering": fwd_diff,
           "same_tokens": same, "first_differing_token": first_diff,
           "forward_max_abs_diff_vs_plain_impls": diff_plain,
           "forward_vs_plain_impls_allowance_used": used_plain,
           "layers_vs_plain_impls": layers, "layers_worst": worst,
           "drop_free_forward_vs_float64": diff64,
           "drop_free_forward_vs_float64_allowance_used": used64,
           "decode_vs_forward_at_published_capacity": diff_125,
           "decode_vs_forward_at_published_capacity_allowance_used": used_125,
           "drop_free_capacity": PATH_E["drop_free_capacity"],
           "drop_free_max_abs_diff_vs_float64_forward": diff8,
           "drop_free_allowance_used": used8,
           "drop_free_max_abs_diff_vs_forward": diff8_f32,
           "drop_free_allowance_used_vs_forward": used8_f32,
           "forward_median_ms": statistics.median(fwd),
           "forward_ms": fwd, "prefill_median_ms": statistics.median(pre),
           "prefill_ms": pre,
           "decode_step_median_ms": statistics.median(step_ms),
           "decode_step_min_ms": min(step_ms),
           "decode_step_max_ms": max(step_ms), "decode_step_ms": step_ms,
           "lowering_decode_step_median_ms": statistics.median(step_ms_t),
           "decode_step_by_class_ms": split,
           "step_bytes": step_bytes, "step_ops": step_ops,
           "step_bound_ms": max(t_bytes, t_ops),
           "step_bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "weights": weights, "weights_bytes": 4 * weights,
           "weights_s": weights_s, "compile_s": compile_s,
           "max_memory_allocated": peak, "launches": launches,
           "smem_bytes": {name: k.smem_bytes for name, k in kernels.items()},
           "card": card_line()}
    print(f"{label}: counted run {json.dumps(launches)}; against the "
          f"emitted programs' plain versions prefill {pre_diff:.3e}, decode "
          f"{dec_diff:.3e} (greedy tokens equal for {same}/{b} sequences, "
          f"first differences {first_diff}), forward {fwd_diff:.3e}; the "
          f"forward pass on the plain impls {diff_plain:.3e} ({used_plain:.3f}"
          f" of the allowance atol = rtol = {PATH_TOL}); layer by layer "
          f"against the plain impls at most {layers[worst]:.3e} of the "
          f"largest value ({worst}; limit {LAYER_TOL}); at capacity "
          f"factor {PATH_E['drop_free_capacity']} prefill + {seq - p0} "
          f"decode steps within {diff8:.3e} of the float64 LM.forward "
          f"({used8:.3f} of the allowance), {diff8_f32:.3e} "
          f"({used8_f32:.3f}) of the float32 one, which lies {diff64:.3e} "
          f"({used64:.3f}) from the float64 one (at {cfg.capacity_factor}: "
          f"{diff_125:.3e}); median "
          f"of {PATH_E['repeats']} calls: forward {rec['forward_median_ms']} "
          f"ms, prefill ({b} x {p0}) {rec['prefill_median_ms']} ms; decode "
          f"step median {rec['decode_step_median_ms']} ms (min "
          f"{rec['decode_step_min_ms']}, max {rec['decode_step_max_ms']}; "
          f"plain versions {rec['lowering_decode_step_median_ms']}), bound "
          f"{rec['step_bound_ms']:.3f} ms ({rec['step_bound_by']}: "
          f"{step_bytes} B); by class {json.dumps(split)}; {weights} "
          f"weights drawn in {weights_s:.2f} s; max_memory_allocated {peak} "
          f"B; {rec['card']}", flush=True)
    return rec


def path_e_in_child():
    """:func:`run_path_e` in a process of its own (this script with
    ``--path-e``), on this process's kernel cache and nvcc build
    directory, where phase 2 compiled and built its kernels."""
    import torch
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--path-e"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    lines = out.stdout.splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if out.returncode != 0 or not lines or not lines[-1].startswith("{"):
        fail(f"path E (child process, rc {out.returncode}): "
             f"{out.stderr.strip()[-3000:]}")
    rec = json.loads(lines[-1])
    rec.update(process_s=time.perf_counter() - t0,
               parent_reserved_bytes=reserved)
    return rec


def check_emitted(served, gen, shapes):
    """Phase 3: every emitted kernel of every served architecture and of
    path E against its plain version on the card, at the shapes its path
    gives it (``shapes[arch]``: decode batch, max_len, prefill batch),
    timed beside the plain version and the library call; a kernel two
    architectures share (the same source) is checked once.  Then the
    device time per launch of every distinct kernel from one profiler
    session (by burst: two kernels whose bodies differ only in their
    grid share a name).  Returns the rows by ``<arch>/<program>/<kernel id>``."""
    import torch
    rows, calls, by_key, dups = {}, [], {}, []
    for arch, (mc, programs) in served.items():
        max_batch, max_len, prefill_batch = shapes[arch]
        for prog, ck in programs.items():
            inputs, inst = program_inputs(prog, ck, mc, max_batch, max_len,
                                          gen, prefill_batch)
            raw = ck._fn.raw_program
            env = {ref: inputs[name]
                   for ref, name in zip(raw.input_refs, ck.in_names)}
            for kr, kern in raw.region_runners:
                name = f"{arch}/{prog}/{kern.gid}"
                kin = [env[r] for r in kr.in_refs]
                got = kern.launch(*kin, instances=inst)
                want = kern.plain(*kin, instances=inst)
                torch.cuda.synchronize()
                err = 0.0
                for g_, w_ in zip(got, want):
                    if not torch.isfinite(g_).all():
                        fail(f"{name}: non-finite kernel output")
                    if not torch.allclose(g_, w_, rtol=TOL, atol=TOL):
                        fail(f"{name}: kernel disagrees with its plain "
                             "version (max abs err "
                             f"{(g_ - w_).abs().max().item():.3e})")
                    err = max(err, (g_ - w_).abs().max().item())
                for ref, o in zip(kr.out_refs, got):
                    env[ref] = o
                if kern.key in by_key:      # the same kernel, checked
                    dups.append((name, by_key[kern.key], err))
                    print(f"{name}: the kernel of {by_key[kern.key]}, "
                          f"max_abs_err={err:.3e}", flush=True)
                    continue
                by_key[kern.key] = name
                launch = functools.partial(kern.launch, *kin,
                                           instances=inst)
                ms = time_ms(launch)
                plain_ms = time_ms(lambda: kern.plain(*kin, instances=inst))
                lib = library_call(prog, kin, inputs, kern)
                lib_ms = time_ms(lib) if lib is not None else None
                n_inst = got[0].numel() // math.prod(kern.out_full[0])
                in_bytes = sum(t.numel() * 4 for t in kin)
                out_bytes = sum(t.numel() * 4 for t in got)
                flops = kern.flops * n_inst
                if prog.startswith("attention"):
                    kept, total, key_rows = attention_valid(inputs)
                    kv_all = (inputs["KT"].numel()
                              + inputs["VT"].numel()) * 4
                    kv_need = key_rows * (inputs["KT"].shape[-1]
                                          + inputs["VT"].shape[-2]) * 4
                    in_bytes += kv_need - kv_all
                    flops = flops * kept / total
                bound_ms, bound_by, fma_ms = bound(in_bytes + out_bytes,
                                                   flops)
                plan = kern.plan
                rows[name] = {
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/core/codegen_cuda.py",
                    "replaces": ("src/repro/core/codegen_pallas.py:409"
                                 if kern.entry == "emit_region"
                                 else "src/repro/core/codegen_pallas.py:634"),
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bound_fma_ms": fma_ms,
                    "library_ms": lib_ms, "device_ms": None,
                    "launch_dims": list(plan.launch_dims),
                    "lifted": list(plan.lifted),
                    "cluster_dim": plan.cluster_dim,
                    "cluster_size": plan.cluster_size,
                    "blocks": kern.blocks * n_inst,
                    "smem_bytes": kern.smem_bytes}
                print(f"{name}: max_abs_err={err:.3e} ms={ms:.4f} "
                      f"plain_ms={plain_ms:.4f} library_ms={lib_ms} "
                      f"bound_ms={bound_ms:.6f} ({bound_by}) launch grid "
                      f"{list(plan.launch_dims)} cluster="
                      f"{plan.cluster_size} blocks={rows[name]['blocks']} "
                      f"smem={kern.smem_bytes}", flush=True)
                calls.append((name, kern.kname, launch))
            del env, inputs
    dev = window_device_ms([(fn, kn) for _, kn, fn in calls])
    for (name, _, _), (total, n) in zip(calls, dev):
        d_ms = rows[name]["device_ms"] = total / n
        print(f"{name}: device_ms={d_ms:.4f} per launch (torch.profiler) "
              f"against ms={rows[name]['ms']:.4f} (CUDA events, back to "
              "back)", flush=True)
    for name, first, err in dups:
        rows[name] = dict(rows[first], name=name,
                          max_abs_err=max(err, rows[first]["max_abs_err"]))
    return rows


def serve_phase(arch, n_layers, warm=False):
    """Phase 4 for one architecture: ``launch.serve`` at full width
    (``n_layers`` cuts the depth; None: the config's), with every launch
    counter of its emitted kernels set to 0 just before and read just
    after; its greedy tokens held against the same engine on the plain
    ``torch`` backend (or its logits within 1e-3 up to the first
    differing token); then 3 decode steps of the same engine broken down
    by kernel (``launch.profile_decode``).  The engine's kernel-cache
    counters (``ServeReport.cache_*``), this process's fusion and
    selection runs and its nvcc builds go into the record, with
    ``compile_s`` (compiling its programs and building or loading their
    kernels) and ``serve_s`` (the engine's construction, warmup and the
    trace, weights included).  ``warm`` (phase 4a) serves only: no plain
    run, no profile.  Returns the phase's record."""
    import torch
    from repro_torch import pipeline as PL
    from repro_torch.core import codegen_cuda as CC
    from repro_torch.core import cuda_build as CB
    from repro_torch.kernels import grouped_experts as GE
    from repro_torch.launch import profile_decode as PD
    from repro_torch.launch import serve as S
    from repro_torch.models import layers as L
    from repro_torch.models.lm import build_model

    cfg = S.ServeConfig(arch=arch, n_layers=n_layers, **SERVE)
    mc = S.model_config(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the weights the engine would draw from the seed, timed on their own
    params = build_model(mc).init_params(cfg.seed, "cuda")
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    # the engine first: its cache counters start here, and the programs
    # compiled next are the ones its warmup finds
    engine = S.build_engine(cfg, params)
    t1 = time.perf_counter()
    programs = L.pipeline_kernels(mc, prefill_lens=cfg.prompt_buckets,
                                  decode_batch=cfg.max_batch,
                                  max_len=cfg.max_len,
                                  device=engine.device.type)
    kernels = {f"{arch}/{prog}/{k.gid}": k for prog, ck in programs.items()
               for k in ck.kernels}
    CC.build(list(kernels.values()))
    t2 = time.perf_counter()
    compile_s = t2 - t1
    engine.warmup()
    # the served trace's launches alone: a replayed graph's are the
    # launches of its capture, added a replay (held against a device
    # trace below); with MoE layers, the grouped expert kernel's too
    moe_layers = sum(mc.mlp_of(i) == "moe" for i in range(mc.n_layers))
    counted = {**kernels, **({"grouped_experts": GE.KERNEL}
                             if moe_layers else {})}
    for k in counted.values():
        k.launches = 0
    replays0 = engine.graph_replays
    trace = S.trace_for(cfg, engine.cfg.vocab)
    report = engine.run(trace)
    torch.cuda.synchronize()
    serve_s = (t1 - t0) + (time.perf_counter() - t2)
    launches = {name: k.launches for name, k in kernels.items()}
    grouped = GE.KERNEL.launches if moe_layers else None
    label = f"serve {arch} ({mc.n_layers} layers, cuda)"
    # output tokens (each prefill's first included) over the run, and the
    # median engine step (its ``tick`` span)
    output_tok_s = report.decode_tokens / report.wall_s
    tick_ms = statistics.median(r.wall_ms for r in report.per_step)
    print(f"{label}: {report.n_completed}/{report.n_requests} requests, "
          f"{report.steps} steps, {output_tok_s:.2f} output tok/s, median "
          f"tick {tick_ms:.2f} ms, recompiles {report.decode_recompiles}, {serve_s:.1f} s with "
          f"weights and warmup ({weights_s:.2f} s drawing the "
          f"{sum(t.numel() for t in PD._tensors(params))} weights on the "
          f"card), {compile_s:.1f} s compiling and building", flush=True)
    if report.n_completed != cfg.n_requests:
        fail(f"{label}: only {report.n_completed}/{cfg.n_requests} "
             "requests completed")
    if report.decode_recompiles != 0:
        fail(f"{label}: {report.decode_recompiles} recompiles after warmup")
    used = {engine._bucket(len(r.prompt)) for r in trace}
    idle = [n for n, c in launches.items() if c <= 0
            and served_program(n.split("/")[1], used)]
    if idle:
        fail(f"{label}: kernels never launched on the serving path: {idle}")
    if moe_layers:
        # every prefill bucket and the decode step run the grouped expert
        # kernel in each MoE layer, so each replay adds moe_layers
        captured = {key: dict((id(k), n) for k, n in g[3]).get(
            id(GE.KERNEL), 0) for key, g in engine._graphs.items()}
        n_replays = engine.graph_replays - replays0
        print(f"{label}: grouped expert kernel launches {grouped} over "
              f"{n_replays} graph replays ({moe_layers} MoE layers; captured "
              f"a replay by graph {captured}; ServeReport "
              f"{report.kernel_launches.get('grouped_experts')})",
              flush=True)
        if (set(captured.values()) != {moe_layers}
                or grouped != moe_layers * n_replays
                or report.kernel_launches.get("grouped_experts") != grouped):
            fail(f"{label}: grouped expert kernel launches {grouped}, "
                 f"ServeReport {report.kernel_launches.get('grouped_experts')}"
                 f", captured a replay {captured}; want {moe_layers} a "
                 f"replay of {n_replays}")
    for rid, rows_l in report.logits.items():
        if not all(torch.isfinite(r).all() for r in rows_l):
            fail(f"{label}: request {rid}: non-finite logits")
    clean = check_clean_path(label, report, programs)
    rec = {"arch": arch, "n_layers": mc.n_layers, "programs": len(programs),
           "resilience": clean,
           "cache": {"memory_hits": report.cache_memory_hits,
                     "disk_hits": report.cache_disk_hits,
                     "misses": report.cache_misses,
                     "hit_rate": report.cache_hit_rate,
                     "quarantined": report.quarantined,
                     "fusions": PL.STATS["fusions"],
                     "selections": PL.STATS["selections"],
                     "nvcc_builds": CB.STATS["builds"]},
           "compile_s": compile_s, "weights_s": weights_s,
           "tokens": {str(r): t for r, t in report.tokens.items()}}
    print(f"{label}: kernel cache {json.dumps(rec['cache'])} for "
          f"{len(programs)} programs", flush=True)
    if warm:
        return dict(rec, serve_s=serve_s, output_tok_s=output_tok_s)

    # before the plain run, whose compiles this engine's run would count
    replays = check_replays_on_trace(label, engine, trace, counted)
    plain = S.run(dataclasses.replace(cfg, backend="torch"),
                  params=engine.params)
    same = 0
    for rid, toks in report.tokens.items():
        ref = plain.tokens[rid]
        if toks == ref:
            same += 1
            continue
        j = next(i for i, (a, b) in enumerate(zip(toks, ref)) if a != b)
        diff = max((a - b).abs().max().item() for a, b in zip(
            report.logits[rid][:j + 1], plain.logits[rid][:j + 1]))
        print(f"{label}: request {rid}: first differing token at step "
              f"{j}; logits up to it agree within {diff:.3e}", flush=True)
        if diff > SERVE_TOL:
            fail(f"{label}: request {rid}: logits differ by {diff:.3e} "
                 "from the torch backend")
    print(f"{label}: greedy tokens equal to the torch backend for {same}/"
          f"{len(report.tokens)} requests", flush=True)

    prof = PD.profile_decode(engine, steps=3)
    by = {}
    for n, ms_ in prof["device_ms_per_step_by_kernel"].items():
        by[kernel_name(n)] = by.get(kernel_name(n), 0.0) + ms_
    names = {f"{prog}/{k.gid}": k.kname for prog in ("attention_decode",
                                                    "swiglu_decode")
             if prog in programs for k in programs[prog].kernels}
    step = {part: by.get(kn, 0.0) for part, kn in names.items()}
    missing = [part for part, ms_ in step.items() if ms_ <= 0]
    if missing:
        fail(f"{label}: the decode profile saw no device time of {missing}")
    step["torch_ops"] = sum(v for n, v in by.items()
                            if n not in names.values())
    step.update(device_busy_share=prof["device_busy_share"],
                host_step_ms=prof["host_step_ms"],
                step_bound_ms=prof["step_bound_ms"],
                n_layers=prof["n_layers"], batch=prof["batch"])
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: decode step (ms per step, torch.profiler over 3 "
          f"steps): {json.dumps(step)}; max_memory_allocated {peak} B",
          flush=True)
    return {**rec, "completed": report.n_completed,
            "requests": report.n_requests,
            "steps": report.steps, "output_tok_s": output_tok_s,
            "tick_ms": tick_ms,
            "recompiles": report.decode_recompiles, "serve_s": serve_s,
            "same_tokens": same, "decode_step": step,
            "max_memory_allocated": peak, "launches": launches,
            "grouped_launches": grouped, "replays_on_trace": replays}


def served_program(prog: str, buckets) -> bool:
    """Whether a serving trace whose prompts took ``buckets`` runs program
    ``prog``: the decode programs always, a prefill program
    (``*_prefill<bucket>``) where its bucket is among them."""
    m = re.fullmatch(r".*_prefill(\d+)", prog)
    return m is None or int(m.group(1)) in buckets


def device_kernels(fn) -> dict:
    """``fn()`` under ``torch.profiler`` after a lead-in kernel and a pause
    (the profiler can miss the first kernels of a session): the kernels
    the device trace shows, counted by name (:func:`kernel_name`)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.2)
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    seen = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            name = kernel_name(e.name())
            seen[name] = seen.get(name, 0) + 1
    return seen


def trace_names(k):
    """The names a device trace gives the kernels one counted launch of
    ``k`` runs: an emitted kernel's ``kname``; the grouped expert kernel's
    four (``grouped_experts.TRACE_NAMES``)."""
    from repro_torch.kernels import grouped_experts as GE
    return GE.TRACE_NAMES if k is GE.KERNEL else (k.kname,)


def check_replays_on_trace(label, engine, trace, kernels):
    """Phase 4's replays against the device trace.  A graph's replay
    counts the launches its capture made (``Engine._run``), so: the
    served ``trace`` again, every counter at 0 before, must show each
    kernel's names (:func:`trace_names`: an emitted kernel's
    ``CudaKernel.kname``, summed over kernels that share one, and the
    grouped expert kernel's four) in the device trace as often as the
    counters say; and 3 replays of the decode graph alone must show each
    of its kernels 3 times as often as its capture launched it (a layer
    each).  Returns the counts by name."""
    if "decode" not in engine._graphs:
        fail(f"{label}: warmup() captured no decode graph")
    for k in kernels.values():
        k.launches = 0
    replays = engine.graph_replays
    report = {}
    seen = device_kernels(lambda: report.update(r=engine.run(trace)))
    counted = {}
    for k in kernels.values():
        for name in trace_names(k):
            counted[name] = counted.get(name, 0) + k.launches
    off = {n: (c, seen.get(n, 0)) for n, c in counted.items()
           if seen.get(n, 0) != c}
    if off or engine.graph_replays == replays:
        fail(f"{label}: launches counted against the device trace's "
             f"{off} (name: (counted, traced)), "
             f"{engine.graph_replays - replays} graph replays")
    if report["r"].n_completed != len(trace):
        fail(f"{label}: the traced run completed "
             f"{report['r'].n_completed}/{len(trace)} requests")
    toks, pos = engine._decode_inputs()
    step = {}
    for k, n in engine._graphs["decode"][3]:
        for name in trace_names(k):
            step[name] = step.get(name, 0) + n
    decode = device_kernels(lambda: [
        engine._run("decode", engine._step, toks, pos) for _ in range(3)])
    off = {n: (3 * c, decode.get(n, 0)) for n, c in step.items()
           if decode.get(n, 0) != 3 * c}
    if not step or off:
        fail(f"{label}: 3 decode replays against the device trace: {off} "
             f"(name: (captured x 3, traced)) of {len(step)} kernels")
    print(f"{label}: {engine.graph_replays - replays - 3} graph replays "
          f"served the trace again under the profiler; every emitted "
          f"kernel's counted launches appear in the device trace "
          f"({sum(counted.values())} launches), each decode kernel "
          f"{sorted(set(step.values()))} times a replay", flush=True)
    return {"window": {n: c for n, c in counted.items() if c},
            "decode_replay": step}


def check_clean_path(label, report, programs):
    """The resilience layer's clean-path gates of a serving phase: no
    demotion, probe, re-promotion, quarantine or emitter split, decode on
    ``pipeline-cuda``, every served program on the rung it asked for, and
    nothing in the run's health ledger.  Returns the counters."""
    from repro_torch import pipeline as PL
    clean = {"degradations": report.degradations,
             "probes": report.probes,
             "repromotions": report.repromotions,
             "quarantined": report.quarantined,
             "cuda_degraded": report.cuda_degraded,
             "decode_backend": report.decode_backend}
    if any(v for k, v in clean.items() if k != "decode_backend") \
            or report.decode_backend != "pipeline-cuda":
        fail(f"{label}: the clean path degraded: {json.dumps(clean)}")
    off = {prog: (ck.resilience_report.requested, ck.rung)
           for prog, ck in programs.items()
           if ck.rung != ck.resilience_report.requested}
    if off:
        fail(f"{label}: programs off their requested rung: {off}")
    health = sorted(str(p) for p in
                    (PL.default_cache().root / "health").rglob("*")
                    if p.is_file())
    if health:
        fail(f"{label}: files in the health ledger: {health}")
    return clean


def serve_in_child(arch, n_layers, cache_dir=None, build_dir=None,
                   warm=False):
    """:func:`serve_phase` in a process of its own (this script with
    ``--serve``), so that the architecture's weights, caches and profiler
    session end with it.  ``cache_dir`` is its kernel-cache directory
    (``$REPRO_TORCH_KERNEL_CACHE``) and ``build_dir`` its nvcc build
    directory (``$REPRO_TORCH_BUILD_DIR``); None: this process's, where
    phase 2 built its kernels, so it only loads them."""
    t0 = time.perf_counter()
    env = dict(os.environ)
    if cache_dir is not None:
        env["REPRO_TORCH_KERNEL_CACHE"] = str(cache_dir)
    if build_dir is not None:
        env["REPRO_TORCH_BUILD_DIR"] = str(build_dir)
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--serve", arch,
         "--n-layers", str(n_layers or 0)] + (["--warm"] if warm else []),
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    lines = out.stdout.splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if out.returncode != 0 or not lines or not lines[-1].startswith("{"):
        fail(f"serving {arch} (child process, rc {out.returncode}): "
             f"{out.stderr.strip()[-3000:]}")
    rec = json.loads(lines[-1])
    rec["process_s"] = time.perf_counter() - t0
    return rec


# -- the compile driver on the card (phases 4a, 8-10) -----------------------

#: phases 8 and 9: (label, architecture, program, tokens or max_len, the
#: candidate block counts of each dim).  A dim's base block is its width
#: over the lcm of its counts, so every candidate runs the published
#: width, and the serving path's own counts
#: (``layers._pipeline_dims_blocks``) are among them; GQA's head-group
#: dim ``H`` is a stack axis (block 1), so it has one count
TUNED = (
    ("smollm-135m SwiGLU t=4", "smollm-135m", "swiglu", 4,
     {"M": (1, 2), "D": (3, 6), "K": (6, 12), "N": (3, 6)}),
    ("smollm-135m SwiGLU t=32", "smollm-135m", "swiglu", 32,
     {"M": (1, 2), "D": (3, 6), "K": (6, 12), "N": (3, 6)}),
    ("llama3.2-1b SwiGLU t=4", "llama3.2-1b", "swiglu", 4,
     {"M": (1, 2), "D": (8, 16), "K": (32, 64), "N": (8, 16)}),
    ("smollm-135m GQA decode attention", "smollm-135m", "attention", 96,
     {"H": (3,), "M": (1,), "D": (1, 2), "N": (1, 2, 3), "L": (1, 2)}),
)
TOP_K = 3


def tuned_programs(served):
    """The programs of ``TUNED``: each with its graph (the one the
    serving path compiles), the serving path's dims and blocks, its
    candidate counts and base blocks, and the measured-autotune options."""
    from repro_torch import pipeline as PL
    from repro_torch.core import array_program as AP
    from repro_torch.models import layers as L
    out = []
    for label, arch, prog, n, cands in TUNED:
        mc = served[arch][0]
        if prog == "swiglu":
            g = AP.rmsnorm_ffn_swiglu_program(float(mc.d_model),
                                              eps=float(mc.norm_eps))
            sizes = {"M": n, "D": mc.d_model, "K": mc.d_ff, "N": mc.d_model}
        else:
            g = AP.gqa_attention_program(1.0 / mc.d_head ** 0.5, causal=True)
            sizes = {"M": 1, "D": mc.d_head, "N": n, "L": mc.d_head}
        dims, blocks = L._pipeline_dims_blocks(sizes)
        base = {d: sizes[d] // math.lcm(*cands[d]) for d in sizes}
        if prog != "swiglu":
            dims["H"] = mc.n_heads // mc.n_kv_heads
            blocks["H"] = base["H"] = 1
        for d, c in cands.items():
            if base[d] * math.lcm(*c) != sizes.get(d, dims[d]) \
                    or dims[d] not in c:
                fail(f"{label}: candidates {c} of {d} miss the width or "
                     f"the serving path's count {dims[d]}")
        out.append(dict(label=label, graph=g, dims=dims, blocks=blocks,
                        cands=cands, options=PL.CompileOptions(
                            backend="cuda", blocks=base,
                            autotune="measured", top_k=TOP_K)))
    return out


def tuned_kernels(tuned):
    """Phase 2's share of phases 8 and 9: the kernels of every analytic
    finalist a measured sweep will time (``pipeline.autotune_candidates``),
    at its timed blocks and at the base blocks the winner lowers at, and
    of each program's unfused version, its regions grouped into
    megakernels as the fused program's are (``unfused``) and one kernel a
    region (``per_region``), compiled (not run) so that they build with
    the rest.  A finalist that does not compile is left for its sweep to
    skip."""
    from repro_torch import pipeline as PL
    kernels = []
    for tp in tuned:
        g = tp["graph"]
        at_base = tp["options"].replace(autotune="analytic")
        for rec in PL.autotune_candidates(g, tp["cands"],
                                          options=tp["options"]):
            for opts in ([rec["options"]] if "options" in rec else []) + [
                    at_base]:
                try:
                    ck = PL.compile(g, rec["dims"], options=opts)
                except Exception as err:
                    print(f"{tp['label']}: finalist {rec['dims']} does not "
                          f"compile ({type(err).__name__}: {err})",
                          flush=True)
                    continue
                kernels += on_requested_rung(
                    f"{tp['label']} finalist {rec['dims']}", ck).kernels
        for name, group in (("unfused", True), ("per_region", False)):
            tp[name] = on_requested_rung(f"{tp['label']} {name}", PL.compile(
                g, tp["dims"], options=PL.CompileOptions(
                    backend="cuda", blocks=tp["blocks"], fused=False,
                    group=group)))
            kernels += tp[name].kernels
    return kernels


def check_warm_start(cold, warm, cache_dir):
    """Phase 4a's checks: the cold serve on a fresh cache directory and a
    fresh nvcc build directory missed every program, hit none on disk and
    built its kernels; the warm serve, a new process on the same two
    directories, loaded every plan from disk with no miss, no fusion, no
    selection and no nvcc build, and sampled the same greedy tokens; no
    temporary file is left in the cache directory."""
    n, c, w = cold["programs"], cold["cache"], warm["cache"]
    if (c["misses"], c["disk_hits"]) != (n, 0) or c["nvcc_builds"] <= 0:
        fail(f"cold serve: {c['misses']} misses, {c['disk_hits']} disk "
             f"hits and {c['nvcc_builds']} nvcc builds for {n} programs on "
             "fresh cache and build directories")
    if (w["misses"], w["disk_hits"], w["nvcc_builds"], w["fusions"],
            w["selections"]) != (0, n, 0, 0, 0):
        fail(f"warm serve: {json.dumps(w)} for {n} programs; expected 0 "
             f"misses, {n} disk hits, 0 nvcc builds, fusions, selections")
    if warm["tokens"] != cold["tokens"]:
        fail("warm serve: greedy tokens differ from the cold serve's")
    left = sorted(str(p) for p in Path(cache_dir).rglob("*.tmp"))
    if left:
        fail(f"temporary files left in the kernel cache: {left}")
    print(f"warm start: {n} programs loaded from disk, tokens equal to the "
          f"cold serve's for {len(warm['tokens'])} requests; compiling and "
          f"building {warm['compile_s']:.2f} s against the cold "
          f"{cold['compile_s']:.2f} s ({c['nvcc_builds']} nvcc builds); "
          f"serving {warm['serve_s']:.1f} s against {cold['serve_s']:.1f} s "
          "(each with weights and warmup)", flush=True)


def plain_outputs(kern, inputs):
    """The merged outputs of a cuda-backend ``CompiledKernel`` through
    its kernels' plain versions, chained as its kernels chain."""
    raw = kern._fn.raw_program
    env = {ref: inputs[n] for ref, n in zip(raw.input_refs, kern.in_names)}
    for kr, k in raw.region_runners:
        env.update(zip(kr.out_refs, k.plain(*[env[r] for r in kr.in_refs])))
    return dict(zip(kern.out_names, (env[r] for r in raw.output_refs)))


def event_ms(kern, inputs):
    """The sum of a compiled program's kernels' CUDA-event times (ms),
    each over back-to-back launches (``timing.region_times``)."""
    from repro_torch.core import timing as T
    return sum(r.median_s for r in T.region_times(kern, inputs)) * 1e3


def check_close(label, got, want):
    """Every output finite and within ``rtol = atol = TOL``; returns the
    max abs error."""
    import torch
    err = 0.0
    for name in want:
        if not torch.isfinite(got[name]).all():
            fail(f"{label}: non-finite output {name}")
        if not torch.allclose(got[name], want[name], rtol=TOL, atol=TOL):
            fail(f"{label}: {name} differs by "
                 f"{(got[name] - want[name]).abs().max().item():.3e}")
        err = max(err, (got[name] - want[name]).abs().max().item())
    return err


def autotune_phase(tuned):
    """Phase 8: ``pipeline.compile(..., dim_candidates=...,
    autotune="measured", top_k=3)`` of each program of ``TUNED`` on the
    card.  Per finalist: its dims, blocks and predicted cost, the
    callable's fenced wall time (what the selector ranks by), the sum of
    its kernels' CUDA-event times and its outputs' distance from their
    plain versions, or why it was skipped.  Fails if every measurement
    failed, if the winner is slower than the analytic winner's measured
    time (the analytic winner is the first finalist timed), or if a
    timed finalist's or the winner's outputs are not within ``2e-4`` of
    their plain version.  The winner lowers at the base blocks, as the
    reference's does: a smaller problem than the one it was timed at."""
    import warnings
    from repro_torch import pipeline as PL
    from repro_torch.core import timing as T
    out = []
    for tp in tuned:
        g, label = tp["graph"], tp["label"]
        skips = PL.STATS["measure_skips"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            kern = on_requested_rung(f"{label} winner", PL.compile(
                g, dim_candidates=tp["cands"], options=tp["options"]))
        for w in caught:
            print(f"{label}: warning: {w.message}", flush=True)
        if kern.measured_s is None:
            fail(f"{label}: every measurement failed")
        analytic = kern.autotune_report[0]["dims"]
        times = dict(kern.autotune_timings)
        akey = tuple(sorted(analytic.items()))
        if akey not in times:
            fail(f"{label}: the analytic winner {analytic} was not timed")
        if kern.measured_s > times[akey]:
            fail(f"{label}: the measured winner ({kern.measured_s} s) is "
                 f"slower than the analytic winner ({times[akey]} s)")
        rows = []
        for rec in kern.autotune_report:
            ev = cerr = None
            if rec["skipped"] is None:
                ck = on_requested_rung(
                    f"{label} finalist {rec['dims']}",
                    PL.compile(g, rec["dims"], options=rec["options"]))
                feed = T.synth_inputs(g, rec["dims"], rec["blocks"],
                                      device="cuda")
                ev = event_ms(ck, feed)
                cerr = check_close(f"{label} finalist {rec['dims']}",
                                   ck(feed), plain_outputs(ck, feed))
            row = {"dims": rec["dims"], "blocks": rec["blocks"],
                   "predicted_cost": rec["cost"],
                   "wall_ms": (rec["seconds"] * 1e3
                               if rec["seconds"] is not None else None),
                   "kernel_event_ms": ev, "max_abs_err": cerr,
                   "skipped": rec["skipped"],
                   "serving": rec["dims"] == tp["dims"]}
            rows.append(row)
            print(f"{label}: candidate {json.dumps(row)}", flush=True)
        inputs = T.synth_inputs(g, kern.dims, kern.blocks, device="cuda")
        err = check_close(f"{label} winner", kern(inputs),
                          plain_outputs(kern, inputs))
        res = {"label": label, "winner": kern.dims,
               "winner_blocks": kern.blocks,
               "winner_wall_ms": kern.measured_s * 1e3,
               "analytic_winner": analytic,
               "analytic_wall_ms": times[akey] * 1e3,
               "serving_dims": tp["dims"], "max_abs_err": err,
               "skipped": PL.STATS["measure_skips"] - skips,
               "candidates": rows}
        print(f"{label}: measured winner {kern.dims} at "
              f"{res['winner_wall_ms']:.4f} ms against the analytic "
              f"winner {analytic} at {res['analytic_wall_ms']:.4f} ms; "
              f"{res['skipped']} skipped; outputs within {err:.3e} of the "
              "plain version", flush=True)
        out.append(res)
    return out


def fusion_phase(tuned):
    """Phase 9: each program of ``TUNED`` at the serving path's dims and
    blocks, fused (the served kernels) against ``fused=False`` on the
    cuda backend, its regions grouped by the planner (``unfused``; a group
    past the card's shared memory split into one kernel a member, listed
    under ``unfused_split``) and one kernel a region (``per_region``):
    launches, the predicted traffic reduction, the whole callable and the
    kernels' sum in CUDA-event time, and the outputs within ``2e-4`` of
    the fused program's.  Fails if the fused program split a group."""
    from repro_torch import pipeline as PL
    from repro_torch.core import timing as T
    out = []
    for tp in tuned:
        g, label = tp["graph"], tp["label"]
        fused = on_requested_rung(f"{label} fused", PL.compile(
            g, tp["dims"], options=PL.CompileOptions(
                backend="cuda", blocks=tp["blocks"])))
        if fused.lowering_report.degraded:
            fail(f"{label}: the fused program split planned groups: "
                 f"{fused.lowering_report.degraded}")
        inputs = T.synth_inputs(g, tp["dims"], tp["blocks"], device="cuda")
        want = fused(inputs)
        res = {"label": label, "dims": tp["dims"],
               "predicted_traffic_reduction":
                   fused.initial_cost / max(fused.cost, 1e-30),
               "unfused_split": [d.split(": ")[0] for d in
                                 tp["unfused"].lowering_report.degraded],
               "max_abs_diff": max(
                   check_close(f"{label} {name} vs fused", tp[name](inputs),
                               want) for name in ("unfused", "per_region"))}
        for name, k in (("fused", fused), ("unfused", tp["unfused"]),
                        ("per_region", tp["per_region"])):
            res[f"{name}_launches"] = k.launches
            res[f"{name}_call_ms"] = time_ms(lambda k=k: k(inputs))
            res[f"{name}_kernel_event_ms"] = event_ms(k, inputs)
        print(f"{label}: fusion {json.dumps(res)}", flush=True)
        out.append(res)
    return out


def calibration_phase(served, rows, root):
    """Phase 10: the first H100 ``CalibrationProfile``: ``fit_profile``
    over ``(group_features, seconds)`` of every emitted serving kernel
    phase 3 timed (its profiler device time), saved under the run's
    cache root, loaded back and compared; then the Spearman rank
    agreement of predicted cost and measured time under the default and
    the fitted profile.  A finding: printed, not gated."""
    import torch
    from repro_torch.core import calibrate as CAL
    from repro_torch.core import timing as T
    feats, secs = [], []
    for arch, (_, programs) in served.items():
        for prog, ck in programs.items():
            rows_f = CAL.group_features(ck.graph, ck.dims, ck.blocks)
            for gid, f in rows_f or []:
                row = rows.get(f"{arch}/{prog}/{gid}")
                if row is None:
                    fail(f"{arch}/{prog}/{gid}: no phase 3 time to fit")
                feats.append(f)
                secs.append(row["device_ms"] / 1e3)
    kind = torch.cuda.get_device_name(0)
    prof = CAL.fit_profile(feats, secs, backend="cuda", device_kind=kind)
    path = CAL.save_profile(prof, root)
    back = CAL.load_profile(root, backend="cuda", device_kind=kind)
    if back is None or back.to_json() != prof.to_json():
        fail(f"the profile saved at {path} does not load back equal")
    res = {"samples": len(secs), "path": str(path.relative_to(root)),
           "profile": prof.to_json(),
           "spearman_default": T.spearman(
               [CAL.DEFAULT_PROFILE.predict(f) for f in feats], secs),
           "spearman_fitted": T.spearman([prof.predict(f) for f in feats],
                                         secs)}
    print(f"calibration: {json.dumps(res)}", flush=True)
    return res


# -- resilience on the card (phase 11) --------------------------------------

def resilience_faults(run):
    return {"chaos": CARD_CHAOS_FAULTS, "refuse": REFUSE_FAULTS,
            "deadline": ()}[run]


def deadline_trace(trace):
    """Phase 4's requests for phase 11's deadline run: two arriving a
    step, and a deadline on every odd one, 4 steps after its arrival in
    the trace's first half and 1 step in its second."""
    half = len(trace) // 2
    return [dataclasses.replace(
        r, arrival_step=r.rid // 2,
        deadline_step=(r.rid // 2 + (4 if r.rid < half else 1)
                       if r.rid % 2 else None)) for r in trace]


def resilience_expected(run, n_programs):
    """The counters a phase 11 chaos or deadline run must end with, by the
    reference's counting rule (benchmarks/serve_bench.py:184-285): a
    demotion per grouped-rung compile fault, which lands its program on
    the ``ungrouped`` rung (its kernel's source is the grouped one's:
    nothing to build), one plan miss and two quarantined files (the plan
    and its graph) per corrupted plan read, a poisoned request per NaN
    fault; no probe and no plain rung.  The deadline run degrades
    nothing."""
    from repro_torch import resilience as RZ
    n = RZ.FaultPlan.from_json({"faults": list(resilience_faults(run))
                                }).expected_count
    return {"degradations": n("compile:"),
            "cache_misses": n("cache:"),
            "cache_disk_hits": n_programs - n("cache:"),
            "quarantined": 2 * n("cache:"),
            "n_poisoned": n("serve:logits"),
            "repromotions": 0, "probes": 0, "probe_failures": 0,
            "ungrouped_programs": n("compile:grouped"),
            "torch_programs": 0,
            "cuda_degraded": 0, "decode_recompiles": 0, "nvcc_builds": 0}


def refuse_run(engine, trace, plan, mc):
    """The refuse run's serve and compile under their faults: what a
    cuda engine does where a CPU one would demote.  Returns the run's
    record: the error ``run`` raised, the watchdog's counters, the decode
    rung, the engine's launch counts, and the ladder attempts and torch
    rung calls of a serving program compiled with both cuda rungs
    faulted."""
    from repro_torch import resilience as RZ
    from repro_torch.launch.engine import _backend_label
    from repro_torch.models import layers as L
    rec = {"error": None}
    with RZ.faults(plan):
        try:
            engine.run(trace)
        except Exception as err:
            rec["error"] = f"{type(err).__name__}: {err}"
    rec.update(
        watchdog_demotions=engine.watchdog_demotions, probes=engine.probes,
        ledger=engine._ledger is not None,
        decode_backend=_backend_label(engine.cfg),
        n_layers=mc.n_layers, ticks_before_fault=plan.specs[0].indices[0],
        kernel_launches={n: k.launches - engine._launch_base[n]
                         for n, k in engine.kernels.items()})
    # the decode SwiGLU program, under a policy that keys it apart from
    # the served one (so it compiles anew) and keeps no breaker
    opts = L._pipeline_options(mc).replace(
        resilience=RZ.ResiliencePolicy(breaker_threshold=0))
    both = RZ.FaultPlan([RZ.FaultSpec(site="compile:grouped"),
                         RZ.FaultSpec(site="compile:ungrouped")])
    rec["ladder"] = None
    with RZ.faults(both):
        try:
            L.swiglu_kernel(engine.max_batch, mc.d_model, mc.d_ff,
                            float(mc.norm_eps), opts, "cuda")
        except RZ.LadderError as err:
            rec["ladder"] = [a.rung for a in err.report.attempts]
    rec["torch_calls"] = both.calls("compile:torch")
    return rec


def resilience_run(run, n_layers):
    """One run of phase 11 in this (child) process: smollm-135m served
    on phase 4's trace (``deadline``: :func:`deadline_trace`, with
    ``max_queue``) under the run's fault plan, on the kernel-cache
    directory and nvcc build directory its parent gave it.  Returns its
    record: the report's counters and failure records, each served
    program's rung, the engine's launch counts, nvcc builds, the
    quarantine and health-ledger files, and seconds (the refuse run:
    :func:`refuse_run`'s record)."""
    import warnings

    import torch
    from repro_torch import pipeline as PL
    from repro_torch import resilience as RZ
    from repro_torch.core import cuda_build as CB
    from repro_torch.launch import serve as S
    from repro_torch.models import layers as L

    plan = RZ.FaultPlan.from_json({"faults": list(resilience_faults(run))})
    cfg = S.ServeConfig(
        arch=RESILIENCE_ARCH, n_layers=n_layers, **SERVE,
        max_queue=DEADLINE_MAX_QUEUE if run == "deadline" else None)
    t0 = time.perf_counter()
    engine = S.build_engine(cfg)
    trace = S.trace_for(cfg, engine.cfg.vocab)
    if run == "deadline":
        trace = deadline_trace(trace)
    t1 = time.perf_counter()
    mc = S.model_config(cfg)
    root = PL.default_cache().root

    def health_files():
        return sorted(p.name for p in (root / "health").rglob("*")
                      if p.is_file())

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if run == "refuse":
            engine.warmup()
            t2 = time.perf_counter()
            programs = L.pipeline_kernels(
                mc, prefill_lens=cfg.prompt_buckets,
                decode_batch=cfg.max_batch, max_len=cfg.max_len,
                device=engine.device.type)
            rec = refuse_run(engine, trace, plan, mc)
            torch.cuda.synchronize()
            return {"run": run, **rec,
                    "rungs": {p: ck.rung for p, ck in programs.items()},
                    "nvcc_builds": CB.STATS["builds"],
                    "health_files": health_files(),
                    "warnings": [str(w.message)[:160] for w in caught
                                 if issubclass(w.category,
                                               RuntimeWarning)],
                    "build_s": t1 - t0, "warmup_s": t2 - t1,
                    "run_s": time.perf_counter() - t2}
        with RZ.faults(plan):
            engine.warmup()
            t2 = time.perf_counter()
            report = engine.run(trace)
            torch.cuda.synchronize()
    t3 = time.perf_counter()
    programs = L.pipeline_kernels(mc, prefill_lens=cfg.prompt_buckets,
                                  decode_batch=cfg.max_batch,
                                  max_len=cfg.max_len,
                                  device=engine.device.type)
    finite = all(bool(torch.isfinite(r).all())
                 for rows in report.logits.values() for r in rows)
    return {"run": run, "n_layers": mc.n_layers, "programs": len(programs),
            "fired": [list(f) for f in plan.fired],
            "planned": plan.expected_count(),
            **{k: getattr(report, k) for k in (
                "degradations", "quarantined", "cache_misses",
                "cache_disk_hits", "n_poisoned", "repromotions", "probes",
                "probe_failures", "decode_backend", "cuda_degraded",
                "decode_recompiles", "n_completed", "n_rejected",
                "n_deadline_evicted", "steps", "decode_tokens", "wall_s",
                "kernel_launches")},
            "failures": [{k: (v[:160] if isinstance(v, str) else v)
                          for k, v in f.items()} for f in report.failures],
            "decode_ticks": [r.step for r in report.per_step
                             if r.n_decode > 0],
            "tokens": {str(r): t for r, t in report.tokens.items()},
            "finite": finite,
            "rungs": {prog: ck.rung for prog, ck in programs.items()},
            "nvcc_builds": CB.STATS["builds"],
            "quarantine_files": len([p for p in (root / "quarantine").glob(
                "*") if p.is_file()]),
            # the breakers on disk: (rung, state, consecutive failures)
            "breakers": sorted([e.rung, e.state, e.failures] for e in
                               RZ.HealthLedger(root / "health").entries()),
            "warnings": len([w for w in caught
                             if issubclass(w.category, RuntimeWarning)]),
            "build_s": t1 - t0, "warmup_s": t2 - t1, "run_s": t3 - t2}


def resilience_phase(cache_root, n_layers):
    """Phase 11: the chaos, refuse and deadline runs, each in a child
    process (this script with ``--resilience``) on its own copy of phase
    4's filled cache directory (so the chaos run's first plan read is a
    real plan) and on phase 2's nvcc build directory, all started
    together.  Returns their records, with each child's wall seconds."""
    procs = {}
    t0 = time.perf_counter()
    for run in ("chaos", "refuse", "deadline"):
        cache_dir = cache_root / run
        shutil.copytree(cache_root / "serve", cache_dir)
        env = dict(os.environ, REPRO_TORCH_KERNEL_CACHE=str(cache_dir))
        env.pop("REPRO_TORCH_BUILD_DIR", None)
        procs[run] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--resilience",
             run, "--n-layers", str(n_layers or 0)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=env)
    recs = {}
    for run, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for other in procs.values():
                other.kill()
            fail(f"phase 11 {run}: the child did not end within 600 s")
        lines = out.splitlines()
        if proc.returncode != 0 or not lines or not lines[-1].startswith(
                "{"):
            fail(f"phase 11 {run} (child process, rc {proc.returncode}): "
                 f"{err.strip()[-3000:]}")
        recs[run] = json.loads(lines[-1])
        recs[run]["process_s"] = time.perf_counter() - t0
    return recs


def check_refuse(rec, label):
    """The refuse run's checks: the decode fault raised out of ``run`` as
    it was, nothing demoted, probed or kept in a ledger, each decode
    kernel launched once a layer for every tick before the fault, and the
    compile with both cuda rungs faulted raised ``LadderError`` after the
    two cuda rungs, never trying ``torch``."""
    want_err = f"InjectedFault: serve:decode[{REFUSE_FAULTS[0]['message']}]"
    got = {k: rec[k] for k in ("error", "watchdog_demotions", "probes",
                               "ledger", "decode_backend", "ladder",
                               "torch_calls", "nvcc_builds",
                               "health_files")}
    want = {"error": want_err, "watchdog_demotions": 0, "probes": 0,
            "ledger": False, "decode_backend": "pipeline-cuda",
            "ladder": ["grouped", "ungrouped"], "torch_calls": 0,
            "nvcc_builds": 0, "health_files": []}
    if got != want:
        fail(f"{label}: {json.dumps(got)} != {json.dumps(want)}")
    off = {p: r for p, r in rec["rungs"].items() if r != "grouped"}
    if off:
        fail(f"{label}: programs off the grouped rung: {off}")
    n = rec["ticks_before_fault"] * rec["n_layers"]
    decode = {k: v for k, v in rec["kernel_launches"].items()
              if k.split("/")[0] in ("attention_decode", "swiglu_decode")}
    if not decode or any(v != n for v in decode.values()):
        fail(f"{label}: decode launches {decode}, expected {n} each "
             f"({rec['ticks_before_fault']} ticks x {rec['n_layers']} "
             "layers)")
    return got


def check_resilience(recs, phase4):
    """Phase 11's checks against the plans, phase 4's record (tokens,
    launched kernels) and the CPU-computed deadline records."""
    base_tokens = phase4["tokens"]
    n_prog = phase4["programs"]
    for run, rec in recs.items():
        label = f"phase 11 {run}"
        if run == "refuse":
            got = check_refuse(rec, label)
            print(f"{label}: {json.dumps(got)}; child "
                  f"{rec['process_s']:.1f} s (engine {rec['build_s']:.1f}, "
                  f"warmup {rec['warmup_s']:.1f}, run {rec['run_s']:.1f})",
                  flush=True)
            continue
        want = resilience_expected(run, n_prog)
        if len(rec["fired"]) != rec["planned"]:
            fail(f"{label}: {len(rec['fired'])} of {rec['planned']} "
                 f"planned faults fired: {rec['fired']}")
        by_rung = {r: sorted(p for p, pr in rec["rungs"].items() if pr == r)
                   for r in ("ungrouped", "torch")}
        got = {k: (len(by_rung[k.split("_")[0]])
                   if k in ("ungrouped_programs", "torch_programs")
                   else rec[k]) for k in want}
        if got != want:
            fail(f"{label}: counters {json.dumps(got)} != the plan's "
                 f"{json.dumps(want)}")
        off = {p: r for p, r in rec["rungs"].items()
               if r not in ("grouped", "ungrouped")}
        if off:
            fail(f"{label}: programs on a plain rung: {off}")
        if rec["quarantine_files"] != rec["quarantined"]:
            fail(f"{label}: {rec['quarantine_files']} quarantine files for "
                 f"{rec['quarantined']} quarantined")
        # a compile fault leaves its rung's failure count below the
        # threshold (closed, until a success of the same program resets
        # it); no breaker may be left open
        if any(state != "closed" for _, state, _ in rec["breakers"]) or (
                rec["breakers"] and run != "chaos"):
            fail(f"{label}: breakers left on disk: {rec['breakers']}")
        if not rec["finite"]:
            fail(f"{label}: a served logits row is not finite")
        idle = [k for k, n in rec["kernel_launches"].items() if n <= 0]
        if idle:
            fail(f"{label}: kernels never launched: {idle}")
        reasons = [f["reason"] for f in rec["failures"]]
        if run == "chaos":
            bad = [f for f in rec["failures"]
                   if f["reason"] == "nonfinite_logits"]
            if reasons != ["nonfinite_logits"] or "rid" not in bad[0]:
                fail(f"{label}: failure records {rec['failures']}")
            poisoned = str(bad[0]["rid"])
            served = {k.split("/")[1] for k in phase4["launches"]}
            if {k.split("/")[0] for k in rec["kernel_launches"]} != served:
                fail(f"{label}: launched programs "
                     f"{sorted(rec['kernel_launches'])} != {sorted(served)}")
            same = {r: t for r, t in rec["tokens"].items()
                    if r != poisoned}
            if rec["n_completed"] != len(base_tokens) - 1 or any(
                    t != base_tokens[r] for r, t in same.items()):
                fail(f"{label}: tokens of unpoisoned requests differ from "
                     "phase 4's")
        else:
            counts = {k: reasons.count(k) for k in DEADLINE_RECORDS}
            if counts != DEADLINE_RECORDS or len(reasons) != sum(
                    DEADLINE_RECORDS.values()):
                fail(f"{label}: failure records {rec['failures']} != "
                     f"{DEADLINE_RECORDS}")
            if rec["n_completed"] + rec["n_rejected"] \
                    + rec["n_deadline_evicted"] != len(base_tokens):
                fail(f"{label}: requests unaccounted for")
        print(f"{label}: {json.dumps(got)}; failure records "
              f"{json.dumps(reasons)}; child "
              f"{rec['process_s']:.1f} s (engine {rec['build_s']:.1f}, "
              f"warmup {rec['warmup_s']:.1f}, run {rec['run_s']:.1f})",
              flush=True)


# -- phase 12: training on the hand kernels ---------------------------------

#: phase 12's impls: the paper's hand kernels, and the plain versions they
#: are held against (float32 both)
HAND_IMPLS = dict(attn_impl="cuda", mlp_impl="cuda")
PLAIN_IMPLS = dict(attn_impl="ref", mlp_impl="unfused")
#: 12a's float64 comparison also takes each family of hand kernel alone,
#: the other on its plain impl (whisper-tiny's MLP kernel is
#: LayerNorm+matmul)
ONE_HAND = {"attention kernel alone": dict(attn_impl="cuda",
                                           mlp_impl="unfused"),
            "MLP kernel alone": dict(attn_impl="ref", mlp_impl="cuda")}
#: 12a, gradient parity at full width: (architecture, depth (None: the
#: config's), batch, text tokens a sequence)
TRAIN_PARITY = (("smollm-135m", None, 8, 512), ("whisper-tiny", None, 2, 64),
                ("internvl2-26b", 2, 2, 64))
TRAIN_LOSS_RTOL = 1e-4    # a step's loss, hand kernels against plain impls
TRAIN_GRAD_RTOL = 1e-3    # each gradient leaf, relative L2
TRAIN_STEP_RTOL = 1e-3    # 12b: each step's loss against the plain run's
TRAIN_TIMED = 3           # 12a: timed steps of each model
#: 12b: steps through launch/train.py on the hand kernels, then the plain
#: impls; 12c: the wider model; 12d: the fault drill, in child processes
TRAIN_STEPS = dict(arch="smollm-135m", steps=30, lr=1e-3, batch=8, seq=512)
TRAIN_WIDE = dict(arch="llama3.2-1b", steps=3, lr=1e-3, batch=4, seq=512)
TRAIN_DRILL = dict(arch="smollm-135m", steps=20, lr=1e-3, batch=4, seq=128,
                   ckpt_every=10, fail_at=13)


def train_argv(run, **extra):
    """``launch/train.py``'s flags for one of phase 12's runs."""
    argv = ["--arch", run["arch"], "--steps", str(run["steps"]),
            "--batch", str(run["batch"]), "--seq", str(run["seq"]),
            "--lr", str(run["lr"]), "--log-every", "1"]
    for k, v in {"ckpt_every": 0, **extra}.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    return argv


def forward_launches(cfg):
    """Each hand kernel's launches in one forward pass of ``cfg`` on the
    hand impls: a flash attention a self- or cross-attention, an
    RMSNorm+SwiGLU a SwiGLU layer, a LayerNorm+matmul a whisper MLP."""
    if cfg.family == "encdec":
        return {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers,
                "rmsnorm_swiglu": 0,
                "layernorm_matmul": cfg.n_enc_layers + cfg.n_layers}
    layers = range(cfg.n_layers)
    return {"flash_attention": sum(cfg.mixer_of(i) == "attn"
                                   for i in layers),
            "rmsnorm_swiglu": sum(cfg.mlp_of(i) == "swiglu" for i in layers),
            "layernorm_matmul": 0}


def step_bound(cfg, params, batch, optimizer: bool):
    """A training step's least time on the card: 8 N T float32 operations
    (forward 2, recompute 2, backward 4; attention's scores not counted)
    over 3xTF32's 165 TFLOP/s, against its bytes over 3.35 TB/s: the
    weights read and their gradients written (``optimizer``: the weights
    and both moments read and written, 24 N).  N counts the weights in a
    product (an untied embedding's lookup is none), T the positions each
    passes (whisper: the encoder's frames, the decoder's tokens; a VLM's
    vision positions too)."""
    from torch.utils import _pytree as pytree

    def numel(tree):
        return sum(t.numel() for t in pytree.tree_leaves(tree))

    n_all = numel(params)
    b, s = batch["tokens"].shape
    if cfg.family == "encdec":
        n_enc = numel(params["enc"])
        ops = 8.0 * (n_enc * b * cfg.enc_seq + (n_all - n_enc) * b * s)
    else:
        n = n_all - (0 if cfg.tie_embeddings else params["embed"].numel())
        t = b * (s + (cfg.n_vision_tokens if cfg.family == "vlm" else 0))
        ops = 8.0 * n * t
    nbytes_ = (24 if optimizer else 8) * n_all
    t_ops, t_bytes = ops / FP32_FLOPS * 1e3, nbytes_ / HBM_BYTES_PER_S * 1e3
    return {"weights": n_all, "ops": ops, "bytes": nbytes_,
            "ops_ms": t_ops, "bytes_ms": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def by_path(tree):
    """The leaves of ``tree`` by their paths."""
    from torch.utils import _pytree as pytree
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(path): leaf for path, leaf in flat}


def rel_l2(got, want) -> float:
    """``||got - want|| / ||want||``, at ``want``'s precision."""
    den = want.norm().item()
    return (got.to(want.dtype) - want).norm().item() / (den or 1.0)


def leaf_distances(got, want):
    """``||g - w|| / ||w||`` of every gradient leaf, by its path."""
    got = by_path(got)
    return {k: rel_l2(got[k].float(), w.float())
            for k, w in by_path(want).items()}


def counted(kernels, fn):
    """``fn()`` with every launch counter set to 0 just before and read
    just after (synchronized): its result, the counts and the counts by
    shape."""
    import torch
    for k in kernels.values():
        k.launches = 0
        k.shapes.clear()
    out = fn()
    torch.cuda.synchronize()
    return (out, {name: k.launches for name, k in kernels.items()},
            {name: dict(k.shapes) for name, k in kernels.items()})


def attention_at_input_precision(q, k, v, *, scale=None, causal=False,
                                 q_offset=0):
    """``kernels.ref.attention_ref`` at its inputs' precision (the oracle
    itself computes in float32): SDPA's math path, for the float64 run.
    A training step's attention starts at position 0."""
    import torch.nn.functional as F
    if not (isinstance(q_offset, int) and q_offset == 0):
        raise ValueError(f"the float64 run takes q_offset 0, not {q_offset}")
    return F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, scale=scale,
        enable_gqa=q.shape[1] != k.shape[1])


def float64_yardstick(cfg, params, batch, leaves):
    """The relative L2 distance of each gradient of ``leaves`` (``{path:
    {impls: gradient}}``) from a float64 run of the plain impls on the
    same weights and batch, its attention in float64 too; only those
    leaves' gradients are taken."""
    import torch
    from unittest import mock
    from torch.utils import _pytree as pytree
    from repro_torch.kernels import ref as R
    from repro_torch.models.lm import build_model
    m64 = build_model(dataclasses.replace(cfg, dtype=torch.float64,
                                          **PLAIN_IMPLS))
    flat, spec = pytree.tree_flatten_with_path(params)
    names = [pytree.keystr(path) for path, _ in flat]
    p64 = [t.detach().double().requires_grad_(n in leaves)
           for n, (_, t) in zip(names, flat)]
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items()}
    with mock.patch.object(R, "attention_ref",
                           attention_at_input_precision), \
            torch.enable_grad():
        loss = m64.loss(pytree.tree_unflatten(p64, spec), b64.pop("tokens"),
                        b64.pop("labels"), **b64)
        wanted = [n for n in names if n in leaves]
        g64 = torch.autograd.grad(loss, [t for n, t in zip(names, p64)
                                         if n in leaves])
    del p64, loss
    return {n: {what: rel_l2(got, g) for what, got in leaves[n].items()}
            for n, g in zip(wanted, g64)}


def train_parity(kernels, card):
    """12a: step 0's loss and gradients of each ``TRAIN_PARITY`` model at
    full width, seeded weights drawn on the card and
    ``SyntheticLMData(seed=0)``'s step 0, on the hand kernels (remat on:
    each kernel launched twice a layer, forward and recompute) and on the
    plain impls; the worst gradient leaf of the two (and any leaf past the
    gate) of these and of ``ONE_HAND``'s impls against a float64 run; then
    ``TRAIN_TIMED`` timed steps on the hand kernels."""
    import torch
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as TS
    from repro_torch.models.lm import build_model
    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for arch, n_layers, b, s in TRAIN_PARITY:
        t0 = time.perf_counter()
        cfg = train_model_config(arch, n_layers)
        hand = build_model(cfg)
        plain = build_model(dataclasses.replace(cfg, **PLAIN_IMPLS))
        vision = (f" + {cfg.n_vision_tokens} vision"
                  if cfg.family == "vlm" else "")
        label = (f"12a {arch} ({cfg.n_layers} layers, d {cfg.d_model}, "
                 f"batch {b} x ({s} text{vision}))")
        torch.cuda.reset_peak_memory_stats()
        params = hand.init_params(seed=0, device="cuda")
        batch = SyntheticLMData(cfg.vocab, s, b, seed=0).batch(0, "cuda")
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.randn(
                b, cfg.n_vision_tokens, cfg.d_model, generator=gen,
                device="cuda")
        if cfg.family == "encdec":
            batch["frames"] = torch.randn(b, cfg.enc_seq, cfg.d_model,
                                          generator=gen, device="cuda")
        expect = {k: 2 * n for k, n in forward_launches(cfg).items()}
        (loss_h, grads_h), counts, shapes = counted(
            kernels, lambda: TS.value_and_grad(hand, params, batch))
        if counts != expect:
            fail(f"{label}: launches {counts} in a step, expected {expect} "
                 "(forward and recompute)")
        loss_p, grads_p = TS.value_and_grad(plain, params, batch)
        lh, lp = loss_h.item(), loss_p.item()
        if not (math.isfinite(lh) and abs(lh - lp) <= TRAIN_LOSS_RTOL
                * abs(lp)):
            fail(f"{label}: loss {lh} against the plain impls' {lp}")
        dist = leaf_distances(grads_h, grads_p)
        worst = max(dist, key=dist.get)
        missed = [k for k, d in dist.items() if not d <= TRAIN_GRAD_RTOL]
        flat_h, flat_p = by_path(grads_h), by_path(grads_p)
        kept = {k: {"hand kernels": flat_h[k], "plain impls": flat_p[k]}
                for k in [worst, *missed]}
        del grads_h, grads_p, flat_h, flat_p
        for what, impls in ONE_HAND.items():
            one = build_model(dataclasses.replace(cfg, **impls))
            grads = by_path(TS.value_and_grad(one, params, batch)[1])
            for k in kept:
                kept[k][what] = grads[k]
            del grads
        f64 = float64_yardstick(cfg, params, batch, kept)
        del kept
        for k, d in f64.items():
            print(f"{label}: {k} (hand against plain {dist[k]:.3e}) from "
                  "the float64 run, relative L2: " + ", ".join(
                      f"{what} {x:.3e}" for what, x in d.items()),
                  flush=True)
        if missed:
            fail(f"{label}: gradient leaves past {TRAIN_GRAD_RTOL}: "
                 f"{ {k: dist[k] for k in missed} }")
        times = []
        for _ in range(TRAIN_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            TS.value_and_grad(hand, params, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        ms = statistics.median(times)
        tokens = b * s
        bound = step_bound(cfg, params, batch, optimizer=False)
        rec = {"loss": lh, "plain_loss": lp, "launches": counts,
               "launch_shapes": shapes, "worst_leaf": worst,
               "worst_leaf_rel_l2": dist[worst], "float64": f64,
               "leaves": len(dist), "step_ms": ms, "step_ms_all": times,
               "text_tok_s": tokens / ms * 1e3,
               "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "bound": bound, "seconds": time.perf_counter() - t0}
        print(f"{label}: loss {lh} (plain {lp}), launches {counts}, "
              f"{len(dist)} gradient leaves, worst {worst} at "
              f"{dist[worst]:.3e} relative L2; loss and gradients step "
              f"median {ms:.2f} ms of {times}, "
              f"{rec['text_tok_s']:.1f} text tokens/s, bound "
              f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}; ops "
              f"{bound['ops_ms']:.3f}, bytes {bound['bytes_ms']:.3f}), max "
              f"memory "
              f"{rec['max_memory_gb']:.2f} GB [{card}]", flush=True)
        out[f"12a {arch}"] = rec
        del params, batch, hand, plain
        torch.cuda.empty_cache()
    return out


def train_run(kernels, run, impls, steps=None):
    """``train.main`` in this process on ``run``'s flags and ``impls``
    (float32): its result (with the peak memory), and the launches of the
    whole run, in all and by shape."""
    import torch
    from repro_torch.launch import train as TT
    r = dict(run, steps=steps or run["steps"])
    torch.cuda.reset_peak_memory_stats()
    res, counts, shapes = counted(kernels, lambda: TT.main(
        train_argv(r), dtype=torch.float32, **impls))
    res["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res, counts, shapes


def train_record(label, cfg, run, res, counts, card):
    """A run's losses, step times (the first step, which builds nothing
    here but warms the allocator, left out of the median), tokens/s and
    memory, printed beside the card."""
    import torch
    from repro_torch.data import SyntheticLMData
    steps = res["step_s"][1:] or res["step_s"]
    ms = statistics.median(steps) * 1e3
    tokens = run["batch"] * run["seq"]
    batch = SyntheticLMData(cfg.vocab, run["seq"], run["batch"]).batch(
        0, "cuda")
    bound = step_bound(cfg, res["params"], batch, optimizer=True)
    rec = {"losses": [l for _, l in res["losses"]], "launches": counts,
           "step_ms": ms, "step_ms_min": min(steps) * 1e3,
           "step_ms_max": max(steps) * 1e3,
           "tok_s": tokens / ms * 1e3,
           "max_memory_gb": res["max_memory_gb"], "bound": bound}
    print(f"{label}: losses {rec['losses'][0]:.4f} -> "
          f"{rec['losses'][-1]:.4f} over {len(rec['losses'])} steps, "
          f"launches {counts}, step median {ms:.2f} ms (min "
          f"{rec['step_ms_min']:.2f}, max {rec['step_ms_max']:.2f}), "
          f"{rec['tok_s']:.1f} tokens/s, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}; ops "
          f"{bound['ops_ms']:.3f}, bytes {bound['bytes_ms']:.3f}), max "
          f"memory {rec['max_memory_gb']:.2f} GB [{card}]", flush=True)
    del batch
    torch.cuda.empty_cache()
    return rec


def train_model_config(arch, n_layers=None):
    """``arch`` at full width on the hand kernels in float32, cut to
    ``n_layers`` as ``launch/train.py --n-layers`` cuts it."""
    import torch
    from repro_torch import configs as C
    from repro_torch.launch.serve import cut_depth
    cfg = C.get_config(arch)
    if n_layers:
        cfg = cut_depth(cfg, n_layers)
    return dataclasses.replace(cfg, dtype=torch.float32, **HAND_IMPLS)


def train_steps(kernels, card):
    """12b: ``TRAIN_STEPS`` through ``launch/train.py`` on the hand
    kernels, then on the plain impls: every loss finite, the last below
    the first, each step's within ``TRAIN_STEP_RTOL`` of the plain run's,
    exact launches (every step twice the forward's)."""
    run = TRAIN_STEPS
    cfg = train_model_config(run["arch"])
    res, counts, shapes = train_run(kernels, run, HAND_IMPLS)
    expect = {k: run["steps"] * 2 * n
              for k, n in forward_launches(cfg).items()}
    if counts != expect:
        fail(f"12b: launches {counts} over {run['steps']} steps, expected "
             f"{expect}")
    rec = train_record(f"12b {run['arch']} ({run['steps']} steps, batch "
                       f"{run['batch']} x {run['seq']}, hand kernels)",
                       cfg, run, res, counts, card)
    del res
    plain, _, _ = train_run(kernels, run, PLAIN_IMPLS)
    plain_rec = train_record(f"12b {run['arch']} plain impls", cfg, run,
                             plain, {}, card)
    del plain
    got, want = rec["losses"], plain_rec["losses"]
    if len(got) != run["steps"] or not all(map(math.isfinite, got)):
        fail(f"12b: losses {got}")
    if not got[-1] < got[0]:
        fail(f"12b: the loss did not fall: {got[0]} -> {got[-1]}")
    worst = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    if worst > TRAIN_STEP_RTOL:
        fail(f"12b: a step's loss lies {worst:.3e} from the plain run's "
             f"(hand {got}, plain {want})")
    print(f"12b: every step's loss within {worst:.3e} (relative) of the "
          "plain run's", flush=True)
    return {"launches": counts, "launch_shapes": shapes, "hand": rec,
            "plain": plain_rec, "max_rel_diff": worst}


def train_wide(kernels, card):
    """12c: ``TRAIN_WIDE`` (llama3.2-1b at full width and depth) through
    ``launch/train.py`` on the hand kernels, then on the plain impls:
    exact launches, step 0's loss within ``TRAIN_LOSS_RTOL`` of the plain
    impls'; the later steps' distances are printed, not gated (three steps
    from a random start need not fall)."""
    run = TRAIN_WIDE
    cfg = train_model_config(run["arch"])
    res, counts, shapes = train_run(kernels, run, HAND_IMPLS)
    expect = {k: run["steps"] * 2 * n
              for k, n in forward_launches(cfg).items()}
    if counts != expect:
        fail(f"12c: launches {counts} over {run['steps']} steps, expected "
             f"{expect}")
    rec = train_record(f"12c {run['arch']} ({run['steps']} steps, batch "
                       f"{run['batch']} x {run['seq']}, hand kernels)",
                       cfg, run, res, counts, card)
    rec["launch_shapes"] = shapes
    del res
    plain, _, _ = train_run(kernels, run, PLAIN_IMPLS)
    rec["plain_losses"] = [l for _, l in plain["losses"]]
    del plain
    got, want = rec["losses"][0], rec["plain_losses"][0]
    if not all(map(math.isfinite, rec["losses"])) or abs(
            got - want) > TRAIN_LOSS_RTOL * abs(want):
        fail(f"12c: step 0's loss {got} against the plain impls' {want}")
    rec["max_rel_diff"] = max(abs(g - w) / abs(w) for g, w in zip(
        rec["losses"], rec["plain_losses"]))
    print(f"12c: step 0's loss {got} against the plain impls' {want}; "
          f"losses {rec['losses']} against the plain impls' "
          f"{rec['plain_losses']} (largest relative distance "
          f"{rec['max_rel_diff']:.3e})", flush=True)
    return rec


def profile_step(run, card):
    """One training step of ``run``'s model on the hand kernels, split by
    ``torch.profiler``: the loss and gradients, then the optimizer, each
    its own burst on the card's timeline (synchronized, 40 ms apart, after
    a lead-in burst the profiler may clip).  Device ms of the hand
    kernels, of the products (cuBLAS: names with ``gemm``/``gemv``), of the
    other kernels of forward and backward, and of the optimizer; the host
    ms is the step's wall time the card sat idle.  Run under
    ``launch/train.py``'s ``deterministic``, as 12b and 12c are."""
    from repro_torch.launch import train as TT
    with TT.deterministic("cuda"):
        return _profile_step(run, card)


def _profile_step(run, card):
    import torch
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import steps as TS
    from repro_torch.launch.profile_decode import _busy_us, bursts
    from repro_torch.models.lm import build_model
    cfg = train_model_config(run["arch"])
    model = build_model(cfg)
    params = model.init_params(seed=0, device="cuda")
    opt = TS.default_optimizer()
    state = opt.init(params)
    batch = SyntheticLMData(cfg.vocab, run["seq"], run["batch"]).batch(
        0, "cuda")
    opt.update(TS.value_and_grad(model, params, batch)[1], state, params)
    torch.cuda.synchronize()
    walls = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.04)
        t = time.perf_counter()
        _, grads = TS.value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        time.sleep(0.04)
        t = time.perf_counter()
        opt.update(grads, state, params)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    found = bursts([(ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA],
                   20e3)
    if len(found) < 2:
        fail(f"profile of a {run['arch']} step: {len(found)} bursts of "
             "kernels on the card's timeline, expected the step's 2")
    grad, upd = found[-2:]

    def ms(burst, keep=lambda n: True):
        return sum(e - s for s, e, n in burst if keep(n)) / 1e3

    def is_hand(n):
        return any(fn in n for fn in HAND_FN.values())

    def is_product(n):
        return not is_hand(n) and ("gemm" in n.lower()
                                   or "gemv" in n.lower())

    busy = (_busy_us([(s, e) for s, e, _ in grad])
            + _busy_us([(s, e) for s, e, _ in upd])) / 1e3
    rec = {"hand_kernels_ms": ms(grad, is_hand),
           "products_ms": ms(grad, is_product),
           "other_kernels_ms": ms(grad, lambda n: not is_hand(n)
                                  and not is_product(n)),
           "optimizer_ms": ms(upd), "step_wall_ms": sum(walls) * 1e3,
           "device_busy_ms": busy, "kernels": len(grad) + len(upd)}
    rec["host_ms"] = rec["step_wall_ms"] - busy
    print(f"12 profile {run['arch']} step (batch {run['batch']} x "
          f"{run['seq']}, hand kernels): " + json.dumps(rec)
          + f" [{card}]", flush=True)
    del params, state, grads, batch
    torch.cuda.empty_cache()
    return rec


def train_child(args):
    """This script with ``--train``: ``launch/train.py`` on the hand
    kernels in a process of its own."""
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--train"] + args,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT)


def train_drill(root):
    """12d: the reference's crash drill (tests/test_train_integration.py:22)
    on the card, at full width: ``TRAIN_DRILL`` checkpointing every 10
    steps, crashed after step 13 (exit 42), resumed from step 10 to 20 in a
    second process, against a clean run to 20 in another directory started
    beside the crash; the two step-20 checkpoints (weights, moments, step)
    must be equal bit for bit, and each child must launch each hand kernel
    exactly twice a layer a step it ran."""
    from collections import Counter
    from torch.utils import _pytree as pytree
    from repro_torch.checkpoint import CheckpointManager
    run = TRAIN_DRILL
    per_step = {k: 2 * n for k, n in forward_launches(
        train_model_config(run["arch"])).items()}
    dirs = {k: str(root / f"drill-{k}") for k in ("crash", "clean")}
    argv = train_argv(run, ckpt_every=run["ckpt_every"])
    crash = train_child(argv + ["--ckpt-dir", dirs["crash"], "--fail-at",
                                str(run["fail_at"])])
    clean = train_child(argv + ["--ckpt-dir", dirs["clean"]])
    outs = {}
    for name, proc in (("crash", crash), ("clean", clean)):
        out, err = proc.communicate(timeout=600)
        outs[name] = (proc.returncode, out, err)
    rc, out, err = outs["crash"]
    if rc != 42 or "injected failure!" not in out:
        fail(f"12d: the crashed run exited {rc}, not 42: {err[-2000:]}")
    if outs["clean"][0] != 0:
        fail(f"12d: the clean run exited {outs['clean'][0]}: "
             f"{outs['clean'][2][-2000:]}")
    resume = train_child(argv + ["--ckpt-dir", dirs["crash"]])
    out, err = resume.communicate(timeout=600)
    if resume.returncode != 0 or "resumed from step 10" not in out:
        fail(f"12d: the resumed run exited {resume.returncode}: "
             f"{err[-2000:]}")
    outs["resume"] = (0, out, err)
    launches, shapes = Counter(), {k: Counter() for k in per_step}
    for name, steps in (("crash", run["fail_at"] + 1),
                        ("resume", run["steps"] - run["ckpt_every"]),
                        ("clean", run["steps"])):
        rec = json.loads(outs[name][1].strip().splitlines()[-1])
        if rec["launches"] != {k: steps * n for k, n in per_step.items()}:
            fail(f"12d: the {name} run launched {rec['launches']} in "
                 f"{steps} steps, expected {per_step} a step")
        launches.update(rec["launches"])
        for k, by_shape in rec["shapes"].items():
            shapes[k].update(by_shape)
    got, want = (CheckpointManager(d).restore(run["steps"], device="cpu")
                 for d in (dirs["crash"], dirs["clean"]))
    flat_g, spec_g = pytree.tree_flatten(got)
    flat_w, spec_w = pytree.tree_flatten(want)
    differ = sum(not (a.dtype == b.dtype and a.shape == b.shape
                      and bool((a == b).all()))
                 for a, b in zip(flat_g, flat_w))
    if spec_g != spec_w or differ:
        fail(f"12d: the resumed run's step-{run['steps']} checkpoint "
             f"differs from the clean run's in {differ} of {len(flat_w)} "
             "leaves")
    print(f"12d: crashed after step {run['fail_at']} (exit 42), resumed "
          f"from step 10, step {run['steps']}'s {len(flat_w)} leaves "
          "(weights, moments, step) equal the clean run's bit for bit; "
          f"launches {dict(launches)}", flush=True)
    return {"leaves": len(flat_w), "equal": True,
            "launches": dict(launches),
            "launch_shapes": {k: dict(v) for k, v in shapes.items()}}


def train_phase(kernels, card, root, phase_s):
    """Phase 12, training on the hand kernels: 12a-12d, each one's
    seconds into ``phase_s``."""
    out = {}
    t0 = time.perf_counter()
    out.update(train_parity(kernels, card))
    phase_s["12a gradient parity"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["12b"] = train_steps(kernels, card)
    out["12b"]["profile"] = profile_step(TRAIN_STEPS, card)
    phase_s["12b steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["12c"] = train_wide(kernels, card)
    out["12c"]["profile"] = profile_step(TRAIN_WIDE, card)
    phase_s["12c wide"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["12d"] = train_drill(root)
    phase_s["12d drill"] = time.perf_counter() - t0
    return out


#: phase 13, the multi-device runtime on a world of one over NCCL: (a) the
#: expert-parallel MoE layer at qwen3-moe-30b-a3b's published widths (d
#: 2048, 128 experts, top-8, moe_d_ff 768, capacity factor 1.25) on
#: ``batch`` x ``seq`` tokens; (b) sequence-parallel decode attention at
#: jamba-1.5-large-398b's attention widths (64 query heads over 8 KV
#: heads of 128) and ``long_500k``'s cache; (d) ``launch/train.py
#: --mesh debug`` against ``--mesh none`` on the hand kernels
MESH_MOE = dict(arch="qwen3-moe-30b-a3b", batch=4, seq=512)
MESH_DECODE = dict(arch="jamba-1.5-large-398b", shape="long_500k")
MESH_TRAIN = dict(TRAIN_STEPS, steps=3)
#: (a): a bfloat16 rounding, relative (8 significant bits)
BF16_ROUNDING = 2.0 ** -8
DECODE_TOL = 1e-4           # (b) against attention_ref on the valid prefix
DECODE_CASE_TOL = 2e-5      # (b) the reference test's case, its tolerance


def mesh_moe(mesh, gen):
    """13a: ``moe_impl="shard_map"`` under the (1, 1) mesh against the
    dense ``moe_apply`` on the same weights and input.  At world size one
    the local capacity is the whole layer's, so the layers differ only by
    the bfloat16 rounding of the partials before their sum: each output
    element within ``BF16_ROUNDING`` of the dense one's magnitude (plus
    1e-6 of the largest, for float32 order), the input gradient within
    ``BF16_ROUNDING`` relative L2 (the cotangent of the expert path is
    rounded to bfloat16, as the reference's is)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.common import ParamBuilder, init_moe
    from repro_torch.runtime.sharding import use_mesh
    cfg = dataclasses.replace(get_config(MESH_MOE["arch"]),
                              dtype=torch.float32)
    sharded = dataclasses.replace(cfg, moe_impl="shard_map")
    p = init_moe(ParamBuilder(np.random.default_rng(0), torch.float32,
                              "cuda"), cfg)
    shape = (MESH_MOE["batch"], MESH_MOE["seq"], cfg.d_model)
    x = torch.randn(shape, device="cuda", generator=gen)
    gamma = 1 + 0.1 * torch.randn(cfg.d_model, device="cuda", generator=gen)
    ct = torch.randn(shape, device="cuda", generator=gen)

    def dense():
        return L.moe_apply(p, x, gamma, cfg)

    def ep():
        with use_mesh(mesh):
            return L.moe_apply(p, x, gamma, sharded)

    def grad(fn):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            with use_mesh(mesh):
                y = L.moe_apply(p, xg, gamma, cfg if fn is dense
                                else sharded)
            (y * ct).sum().backward()
        return xg.grad

    with torch.no_grad():
        want, got = dense(), ep()
    gap = (got - want).abs()
    limit = BF16_ROUNDING * want.abs() + 1e-6 * want.abs().max()
    if not bool(torch.isfinite(got).all()) or bool((gap > limit).any()):
        fail(f"13a: the expert-parallel MoE layer lies {gap.max().item():.4g}"
             f" from the dense one, past the bfloat16 rounding of its "
             f"magnitude ({BF16_ROUNDING:.4g} relative)")
    gx_d, gx_s = grad(dense), grad(ep)
    g_rel = rel_l2(gx_s, gx_d)
    if not g_rel <= BF16_ROUNDING:
        fail(f"13a: the input gradient lies {g_rel:.4g} (relative L2) from "
             f"the dense layer's, past {BF16_ROUNDING:.4g}")
    weights = nbytes(p["we_gate"], p["we_up"], p["we_down"])
    cap = L.moe_capacity(shape[0] * shape[1], cfg)
    flops = 2.0 * 3 * cfg.n_experts * cap * cfg.d_model * cfg.moe_d_ff
    with torch.no_grad():
        ms = {"dense_ms": time_ms(dense, 10), "sharded_ms": time_ms(ep, 10)}
    b_ms, b_by, fma_ms = bound(weights, flops)
    rec = {"shape": list(shape), "experts": cfg.n_experts,
           "top_k": cfg.top_k, "moe_d_ff": cfg.moe_d_ff, "capacity": cap,
           "expert_weight_bytes": weights, **ms,
           "bytes_bound_ms": weights / HBM_BYTES_PER_S * 1e3,
           "bound_ms": b_ms, "bound_by": b_by, "fma_bound_ms": fma_ms,
           "max_abs_diff": gap.max().item(),
           "max_rel_diff": (gap / want.abs().clamp_min(1e-30)).max().item(),
           "out_max_abs": want.abs().max().item(),
           "grad_rel_l2": g_rel,
           "grad_max_abs_diff": (gx_s - gx_d).abs().max().item()}
    print(f"13a expert-parallel MoE ({MESH_MOE['arch']}, "
          f"{shape[0]} x {shape[1]} tokens): " + json.dumps(rec), flush=True)
    del p, x, ct, gx_d, gx_s
    torch.cuda.empty_cache()
    return rec


def mesh_decode(mesh, gen):
    """13b: ``distributed_decode_attention`` over the mesh's ``data`` axis
    (one shard: the whole cache) at jamba's attention widths against
    ``attention_ref`` on the valid prefix (``DECODE_TOL``), and on the
    reference test's case (``DECODE_CASE_TOL``); timed beside its bytes
    bound (K and V read once) and the plain oracle."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.runtime.collectives import distributed_decode_attention
    small = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shp, device="cuda", generator=small)
               for shp in ((2, 4, 1, 32), (2, 2, 64, 32), (2, 2, 64, 32)))
    got = distributed_decode_attention(q, k, v, 45, mesh)
    want = attention_ref(q, k[:, :, :46], v[:, :, :46])
    if not torch.allclose(got, want, rtol=DECODE_CASE_TOL,
                          atol=DECODE_CASE_TOL):
        fail("13b: the reference test's decode case misses "
             f"{DECODE_CASE_TOL}: {(got - want).abs().max().item():.4g}")
    cfg = get_config(MESH_DECODE["arch"])
    s = SHAPES[MESH_DECODE["shape"]].seq_len
    q = torch.randn(1, cfg.n_heads, 1, cfg.d_head, device="cuda",
                    generator=gen)
    k, v = (torch.randn(1, cfg.n_kv_heads, s, cfg.d_head, device="cuda",
                        generator=gen) for _ in range(2))
    pos = s - 1

    def call():
        return distributed_decode_attention(q, k, v, pos, mesh)

    got, want = call(), attention_ref(q, k[:, :, :pos + 1],
                                      v[:, :, :pos + 1])
    err = (got - want).abs().max().item()
    if not bool(torch.isfinite(got).all()) or not torch.allclose(
            got, want, rtol=DECODE_TOL, atol=DECODE_TOL):
        fail(f"13b: decode attention at {s} positions lies {err:.4g} from "
             f"attention_ref, past {DECODE_TOL}")
    byts = nbytes(q, k, v, got)
    flops = 4.0 * cfg.n_heads * s * cfg.d_head
    b_ms, b_by, _ = bound(byts, flops)
    # where the time goes: the partial's two products alone, and SDPA on
    # the same inputs as context
    qf = q.reshape(1, cfg.n_kv_heads, -1, cfg.d_head)
    probs = torch.softmax(torch.einsum("bhgd,bhkd->bhgk", qf, k), -1)
    rec = {"q": list(q.shape), "kv": list(k.shape), "pos": pos,
           "kv_bytes": nbytes(k, v), "max_abs_diff": err,
           "ms": time_ms(call, 10),
           "plain_ms": time_ms(lambda: attention_ref(q, k, v), 10),
           "scores_ms": time_ms(lambda: torch.einsum(
               "bhgd,bhkd->bhgk", qf, k), 10),
           "pv_ms": time_ms(lambda: torch.einsum(
               "bhgk,bhkd->bhgd", probs, v), 10),
           "sdpa_ms": time_ms(lambda: torch.nn.functional.
                              scaled_dot_product_attention(
                                  q, k, v, enable_gqa=True), 10),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"13b decode attention ({MESH_DECODE['arch']} widths, "
          f"{MESH_DECODE['shape']}): " + json.dumps(rec), flush=True)
    del q, k, v, probs
    torch.cuda.empty_cache()
    return rec


def mesh_compressed(mesh):
    """13c: ``compressed_psum_mean`` over smollm-135m's whole gradient
    tree (full width, float32, plain impls, 2 x 128 tokens), two steps
    (the second with the first's error feedback): at world size one each
    synced leaf must equal the int8 round trip of gradient plus error bit
    for bit, and each new error the residual."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.lm import build_model
    from repro_torch.optim.compression import (compressed_psum_mean,
                                               dequantize_int8,
                                               quantize_int8)
    cfg = dataclasses.replace(get_config("smollm-135m"), dtype=torch.float32)
    model = build_model(cfg)
    params = model.init_params(seed=0, device="cuda")
    data = SyntheticLMData(cfg.vocab, 128, 2, seed=0)
    errors, leaves, grad_s, mean_s = None, 0, 0.0, 0.0
    for step in range(2):
        t0 = time.perf_counter()
        _, grads = value_and_grad(model, params, data.batch(step, "cuda"))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        synced, new = compressed_psum_mean(grads, mesh, ("data",), errors)
        torch.cuda.synchronize()
        grad_s, mean_s = grad_s + t1 - t0, mean_s + time.perf_counter() - t1
        flat_e = (pytree.tree_leaves(errors) if errors is not None
                  else [torch.zeros_like(g) for g in
                        pytree.tree_leaves(grads)])
        for g, e, got, err in zip(pytree.tree_leaves(grads), flat_e,
                                  pytree.tree_leaves(synced),
                                  pytree.tree_leaves(new)):
            corrected = g + e
            back = dequantize_int8(*quantize_int8(corrected))
            if not (torch.equal(got, back)
                    and torch.equal(err, corrected - back)):
                fail(f"13c: step {step}: a synced leaf or its error is not "
                     "the int8 round trip bit for bit")
            leaves += 1
        errors = new
    n = sum(g.numel() for g in pytree.tree_leaves(grads))
    rec = {"leaves_checked": leaves, "values": n, "bitwise": True,
           "gradient_s": grad_s, "mean_s": mean_s}
    print("13c compressed gradient mean (smollm-135m): " + json.dumps(rec),
          flush=True)
    del params, grads, synced, new, errors
    torch.cuda.empty_cache()
    return rec


def mesh_train(kernels):
    """13d: ``launch/train.py`` on the hand kernels, ``MESH_TRAIN``'s 3
    steps with ``--mesh none`` and then ``--mesh debug`` (data parallel
    over the world of one): every parameter equal bit for bit, each run
    with exact launches (twice a layer a step)."""
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.launch import train as TT
    per_step = {k: 2 * n for k, n in forward_launches(
        train_model_config(MESH_TRAIN["arch"])).items()}
    runs = {}
    for kind in ("none", "debug"):
        t0 = time.perf_counter()
        res, counts, shapes = counted(kernels, lambda: TT.main(
            train_argv(MESH_TRAIN) + ["--mesh", kind], dtype=torch.float32,
            **HAND_IMPLS))
        want = {k: MESH_TRAIN["steps"] * n for k, n in per_step.items()}
        if counts != want:
            fail(f"13d --mesh {kind}: launched {counts}, expected {want}")
        runs[kind] = (res, counts, shapes, time.perf_counter() - t0)
    a, b = (pytree.tree_leaves(runs[k][0]["params"])
            for k in ("none", "debug"))
    differ = sum(not torch.equal(x, y) for x, y in zip(a, b))
    if differ or len(a) != len(b):
        fail(f"13d: --mesh debug's parameters differ from --mesh none's "
             f"in {differ} of {len(a)} leaves")
    rec = {"steps": MESH_TRAIN["steps"], "leaves": len(a), "equal": True,
           "losses": {k: r[0]["losses"] for k, r in runs.items()},
           "run_s": {k: r[3] for k, r in runs.items()},
           "launches": {f"13d {k}": r[1] for k, r in runs.items()},
           "launch_shapes": {f"13d {k}": r[2] for k, r in runs.items()}}
    print(f"13d train.py --mesh debug against --mesh none "
          f"({MESH_TRAIN['arch']}, {MESH_TRAIN['steps']} steps, hand "
          f"kernels): {len(a)} leaves equal bit for bit; "
          + json.dumps({k: rec[k] for k in ("losses", "run_s")}), flush=True)
    return rec


def mesh_phase():
    """Phase 13 in this (child) process: NCCL's process group over a world
    of one and a (1, 1) debug mesh, then 13a-13d; the group is destroyed
    at the end.  Any NCCL or collective error fails the phase: there is no
    fallback to gloo or the CPU."""
    # cuBLAS reads its workspace setting at its first use in the process:
    # set it before any product, so that 13d's runs are deterministic
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    t0 = time.perf_counter()
    M.init_distributed("cuda")
    mesh = M.make_debug_mesh((1, 1))
    one = torch.ones(1, device="cuda")
    dist.all_reduce(one)                  # NCCL makes its communicator
    torch.cuda.synchronize()
    if dist.get_backend() != "nccl" or one.item() != 1.0:
        fail(f"13: the process group runs {dist.get_backend()!r}, not NCCL")
    rec = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "nccl_init_s": time.perf_counter() - t0}
    print(f"13 NCCL: world {rec['world']}, mesh {rec['mesh']}, "
          f"{rec['nccl_init_s']:.3f} s to the first all-reduce", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = {}
    for name, fn in (("a", lambda: mesh_moe(mesh, gen)),
                     ("b", lambda: mesh_decode(mesh, gen)),
                     ("c", lambda: mesh_compressed(mesh)),
                     ("d", lambda: mesh_train(
                         {n: m.KERNEL for n, m in hand_modules().items()}))):
        t1 = time.perf_counter()
        rec[name] = fn()
        steps[name] = time.perf_counter() - t1
    rec["seconds"] = steps
    rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    dist.destroy_process_group()
    return rec


def mesh_in_child():
    """Phase 13 in a process of its own (this script with ``--mesh``), so
    that its NCCL group lives and dies with it, on this process's nvcc
    build directory, where phase 2 built the hand kernels."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--mesh"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    lines = out.stdout.splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if out.returncode != 0 or not lines or not lines[-1].startswith("{"):
        fail(f"phase 13 (child process, rc {out.returncode}): "
             f"{out.stderr.strip()[-3000:]}")
    rec = json.loads(lines[-1])
    rec["process_s"] = time.perf_counter() - t0
    return rec

# -- phase 14: the step analysis, the dry-run and the examples --------------

#: (a)'s cells at world 1 on the card, plain impls in bfloat16: (label,
#: arch, batch, sequence (a decode cell's cache positions), kind)
ANALYSIS_CELLS = (("smollm-135m train 8x512", "smollm-135m", 8, 512,
                   "train"),
                  ("llama3.2-1b decode 4x32768", "llama3.2-1b", 4, 32768,
                   "decode"))
ANALYSIS_IMPLS = dict(attn_impl="chunked", mlp_impl="fused_ref")
ANALYSIS_REPEATS = 5
#: (b)'s dry-run cells, each on both meshes, in a child of its own
DRYRUN_CELLS = (("qwen3-moe-30b-a3b", "train_4k"),
                ("qwen2-7b", "decode_32k"))
#: (c)'s examples and their arguments
EXAMPLES = (("torch_quickstart.py", []),
            ("torch_fusion_megakernels.py", []),
            ("torch_serve_lm.py", ["--arch", "smollm-135m"]),
            ("torch_train_lm.py", ["--full", "--steps", "40"]))


def analysis_inputs(model, args, gen, pos=None):
    """``make_step``'s ``meta`` arguments as tensors on the card: seeded
    weights, token ids, zeros elsewhere (the optimizer's state, a
    cache), and a decode step's ``pos``."""
    import torch
    from torch.utils import _pytree as pytree
    params = model.init_params(seed=0, device="cuda")

    def fill(t):
        if t.dtype in (torch.int32, torch.int64) and t.dim() == 2:
            return torch.randint(0, model.cfg.vocab, t.shape, generator=gen,
                                 device="cuda", dtype=t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype, device="cuda")
    rest = pytree.tree_map(fill, args[1:])
    if pos is not None:
        rest[-1]["pos"] = torch.tensor(pos, dtype=torch.int32,
                                       device="cuda")
    return (params, *rest)


def analysis_cell(label, arch, batch, seq, kind, gen):
    """(a) one cell: the op analysis of the step on ``meta`` and on the
    card's tensors (FLOPs and bytes equal, exactly), the step timed (CUDA
    events, median of ``ANALYSIS_REPEATS`` after a warmup) against its
    bound, and the analysis's memory against the allocator's peak."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.steps import make_step
    from repro_torch.runtime.op_analysis import analyze_step
    cfg = dc.replace(get_config(arch), **ANALYSIS_IMPLS)
    step, args, _ = make_step(cfg, ShapeSpec(label, seq, batch, kind))
    meta = analyze_step(step, args)
    from repro_torch.models.lm import build_model
    real = analysis_inputs(build_model(cfg), args, gen,
                           seq - 768 if kind == "decode" else None)
    step(*real)                                   # warmup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    card = analyze_step(step, real)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    for name in ("flops", "hbm_bytes"):
        a, b = getattr(meta.roofline, name), getattr(card.roofline, name)
        if a != b or not a > 0:
            fail(f"14a {label}: {name} on meta {a} against {b} on the card")
    for name in ("argument_size_in_bytes", "output_size_in_bytes"):
        if getattr(meta, name) != getattr(card, name):
            fail(f"14a {label}: {name} on meta {getattr(meta, name)} "
                 f"against {getattr(card, name)} on the card")
    times = []
    for _ in range(ANALYSIS_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(*real)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    roof = card.roofline
    bound_ms = roof.t_bound * 1e3
    if ms < bound_ms:
        fail(f"14a {label}: the step took {ms:.4f} ms, under its bound "
             f"{bound_ms:.4f} ms: the count misses work")
    rec = {"flops": roof.flops, "hbm_bytes": roof.hbm_bytes,
           "t_compute_ms": roof.t_compute * 1e3,
           "t_memory_ms": roof.t_memory * 1e3, "bound_ms": bound_ms,
           "bottleneck": roof.bottleneck, "ms": ms, "ms_all": times,
           "ratio": ms / bound_ms, "n_ops": card.n_ops,
           **card.memory(),
           "meta_temp_size_in_bytes": meta.temp_size_in_bytes,
           "analysis_peak_bytes": card.argument_size_in_bytes
           + card.temp_size_in_bytes,
           "allocator_peak_bytes": peak, "allocated_before_bytes": base}
    print(f"14a {label}: {roof.flops:.6e} FLOPs, {roof.hbm_bytes:.6e} B "
          f"(meta = card), bound {bound_ms:.4f} ms ({roof.bottleneck}), "
          f"step {ms:.4f} ms = {rec['ratio']:.3f} x bound; arguments + "
          f"temp {rec['analysis_peak_bytes'] / 1e9:.3f} GB, allocator "
          f"peak {peak / 1e9:.3f} GB", flush=True)
    return rec


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def analysis_phase():
    """Phase 14 in this (child) process: (b)'s dry-run children and (c)'s
    examples start first, each a process of its own, then (a) runs here;
    every child must exit 0, every dry-run cell be ``ok`` and the trained
    loss fall."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="phase14-", dir=ROOT / "build"))
    t0 = time.perf_counter()
    procs = {}

    def start(name, dest, argv):
        # each child's output to files: nothing blocks on a full pipe
        # while (a) runs here
        log = out_dir / f"{len(procs)}"
        with open(f"{log}.out", "w") as out, open(f"{log}.err", "w") as err:
            procs[name] = (dest, log, subprocess.Popen(
                argv, stdout=out, stderr=err, cwd=ROOT, env=_child_env()))

    for arch, shape in DRYRUN_CELLS:
        dest = out_dir / f"dryrun_{arch}_{shape}.json"
        start(f"dryrun {arch} {shape}", dest,
              [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", "both", "--out",
               str(dest)])
    for name, argv in EXAMPLES:
        start(f"example {name}", None,
              [sys.executable, str(ROOT / "examples" / name), *argv])
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {"a": {}}
    for cell in ANALYSIS_CELLS:
        t1 = time.perf_counter()
        rec["a"][cell[0]] = analysis_cell(*cell, gen)
        rec["a"][cell[0]]["seconds"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    rec["a_s"] = time.perf_counter() - t0
    rec["b"], rec["c"] = {}, {}
    failures = []
    for name, (dest, log, proc) in procs.items():
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            for _, _, p in procs.values():
                p.kill()
            fail(f"14 {name}: no exit within 600 s")
        stdout = Path(f"{log}.out").read_text()
        stderr = Path(f"{log}.err").read_text()
        if proc.returncode != 0:
            failures.append(f"14 {name} (rc {proc.returncode}): "
                            f"{(stdout[-1500:] + stderr[-2000:]).strip()}")
            if dest is None or not dest.exists():
                continue
        if dest is not None:
            cells = json.loads(dest.read_text())
            for c in cells:
                if c["status"] != "ok":
                    failures.append(f"14b {name}: {c}")
                    continue
                key = f"{c['arch']} {c['shape']} {c['mesh']}"
                rec["b"][key] = {k: c[k] for k in (
                    "n_chips", "compile_s", "flops_per_chip",
                    "hbm_bytes_per_chip", "coll_bytes_per_chip",
                    "t_compute_s", "t_memory_s", "t_collective_s",
                    "bottleneck", "argument_size_in_bytes",
                    "temp_size_in_bytes", "fits_80g_hbm")}
                print(f"14b {key}: {c['flops_per_chip']:.6e} FLOPs/rank, "
                      f"{c['hbm_bytes_per_chip']:.6e} HBM B/rank, "
                      f"collectives {json.dumps(c['coll_bytes_per_chip'])}"
                      f", bottleneck {c['bottleneck']}, fits_80g_hbm "
                      f"{c['fits_80g_hbm']}", flush=True)
        else:
            lines = stdout.strip().splitlines()
            rec["c"][name] = lines[-3:]
            print(f"14c {name}: " + " | ".join(lines[-3:]), flush=True)
            if name.endswith("torch_train_lm.py"):
                loss = re.search(r"loss: ([\d.]+) -> ([\d.]+)", stdout)
                if not loss or float(loss[2]) >= float(loss[1]):
                    failures.append(f"14c {name}: the loss did not fall: "
                                    f"{lines[-1:]}")
                    continue
                rec["c"]["train_loss"] = [float(loss[1]), float(loss[2])]
    shutil.rmtree(out_dir, ignore_errors=True)
    if failures:
        fail("\n".join(failures))
    rec["seconds"] = time.perf_counter() - t0
    return rec


def analysis_in_child():
    """Phase 14 in a process of its own (this script with
    ``--analysis``), so that its cells' weights and caches, and its
    children, end with it."""
    import torch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--analysis"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    lines = out.stdout.splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if out.returncode != 0 or not lines or not lines[-1].startswith("{"):
        fail(f"phase 14 (child process, rc {out.returncode}): "
             f"{out.stderr.strip()[-3000:]}")
    rec = json.loads(lines[-1])
    rec["process_s"] = time.perf_counter() - t0
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test runs on "
             "the card only")
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--serve"]:        # a serving phase's child
        torch.backends.cuda.matmul.allow_tf32 = False
        rec = serve_phase(sys.argv[2], int(sys.argv[4]) or None,
                          warm="--warm" in sys.argv[5:])
        print(json.dumps(rec))
        return 0
    if sys.argv[1:2] == ["--train"]:        # a phase 12d child
        from repro_torch.launch import train as TT
        torch.backends.cuda.matmul.allow_tf32 = False
        kernels = {name: mod.KERNEL for name, mod in hand_modules().items()}
        code = 0
        try:
            TT.main(sys.argv[2:], dtype=torch.float32, **HAND_IMPLS)
        except SystemExit as e:             # --fail-at's exit 42
            code = e.code
        print(json.dumps({
            "launches": {n: k.launches for n, k in kernels.items()},
            "shapes": {n: dict(k.shapes) for n, k in kernels.items()}}))
        return code
    if sys.argv[1:2] == ["--path-e"]:       # path E's child
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(run_path_e()))
        return 0
    if sys.argv[1:2] == ["--grouped-experts"]:   # phase 5b alone
        torch.backends.cuda.matmul.allow_tf32 = False
        print("grouped experts: " + json.dumps(grouped_phase()))
        return 0
    if sys.argv[1:2] == ["--mesh"]:         # phase 13's child
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(mesh_phase()))
        return 0
    if sys.argv[1:2] == ["--analysis"]:     # phase 14's child
        print(json.dumps(analysis_phase()))
        return 0
    if sys.argv[1:2] == ["--resilience"]:   # a phase 11 child
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps(resilience_run(sys.argv[2],
                                        int(sys.argv[4]) or None)))
        return 0
    from repro_torch.core import codegen_cuda as CC
    from repro_torch.core import cuda_build as CB
    from repro_torch.launch import serve as S
    from repro_torch.models import layers as L

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    route = weights_route()
    phase_s = {}
    # a fresh kernel-cache root for this run: the plans this process
    # compiles go to <root>/main, phase 4's cold and warm smollm-135m
    # serves share <root>/serve and the nvcc build directory
    # <root>/serve-nvcc
    (ROOT / "build").mkdir(exist_ok=True)
    cache_root = Path(tempfile.mkdtemp(prefix="chip_smoke-cache-",
                                       dir=ROOT / "build"))
    os.environ["REPRO_TORCH_KERNEL_CACHE"] = str(cache_root / "main")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    served = {}
    for arch, n_layers in SERVED:
        mc = S.model_config(S.ServeConfig(arch=arch, n_layers=n_layers,
                                          **SERVE))
        served[arch] = (mc, L.pipeline_kernels(
            mc, prefill_lens=SERVE["prompt_buckets"],
            decode_batch=SERVE["max_batch"], max_len=SERVE["max_len"]))
        for prog, ck in served[arch][1].items():
            on_requested_rung(f"{arch}/{prog}", ck)
            print(f"{arch}/{prog}: {ck.lowering_report.summary()}",
                  flush=True)
            if ck.lowering_report.degraded:
                fail(f"{arch}/{prog}: planned groups split into per-region "
                     f"kernels: {ck.lowering_report.degraded}")
    cell_cfg = cell_config()
    cell_programs = {CELL["name"]: (cell_cfg, L.pipeline_kernels(
        cell_cfg, prefill_lens=CELL["prefill_lens"],
        decode_batch=CELL["max_batch"], max_len=CELL["max_len"]))}
    pe_cfg = path_e_config()
    path_e_served = {pe_cfg.name: (pe_cfg, path_e_programs(pe_cfg))}
    for prog, ck in path_e_served[pe_cfg.name][1].items():
        on_requested_rung(f"path E {prog}", ck)
        print(f"path E {prog}: {ck.lowering_report.summary()}; shared "
              f"memory {[k.smem_bytes for k in ck.kernels]} B", flush=True)
        if ck.lowering_report.degraded:
            fail(f"path E {prog}: planned groups split into per-region "
                 f"kernels: {ck.lowering_report.degraded}")
    emitted = {k.key: k for _, programs in [*served.values(),
                                            *cell_programs.values(),
                                            *path_e_served.values()]
               for ck in programs.values() for k in ck.kernels}
    tuned = tuned_programs(served)
    more = {k.key: k for k in tuned_kernels(tuned) if k.key not in emitted}
    hand = {name: mod.KERNEL for name, mod in hand_modules().items()}
    CB.build_many([(k.key, k.source) for k in emitted.values()]
                  + [(k.key, k.source) for k in more.values()]
                  + [(k.key, k.source) for k in hand.values()])
    CC.build(list(emitted.values()) + list(more.values()))
    for k in hand.values():
        k.build()
    build_s = time.perf_counter() - t0
    print(f"built {len(emitted)} emitted, {len(more)} more for phases 8 "
          f"and 9, and {len(hand)} hand-written kernels "
          f"({', '.join(hand)}) with nvcc (sm_90a), one process each, in "
          f"{build_s:.2f} s", flush=True)
    tensor_core_report(hand)
    phase_s["2 build"] = time.perf_counter() - t0

    # -- 3. each emitted kernel against its plain version -------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {arch: (SERVE["max_batch"], SERVE["max_len"], 1)
              for arch in served}
    shapes[pe_cfg.name] = (PATH_E["batch"], PATH_E["seq"], PATH_E["batch"])
    shapes[CELL["name"]] = (CELL["max_batch"], CELL["max_len"], 1)
    rows = check_emitted({**served, **cell_programs, **path_e_served}, gen,
                         shapes)
    torch.cuda.empty_cache()   # the wide inputs' blocks, before the serves
    phase_s["3 emitted kernels"] = time.perf_counter() - t0

    # -- 4. the serving paths -------------------------------------------------
    serving, warm = {}, None
    for arch, n_layers in SERVED:
        t0 = time.perf_counter()
        first = arch == SERVED[0][0]
        dirs = (dict(cache_dir=cache_root / "serve",
                     build_dir=cache_root / "serve-nvcc") if first else {})
        serving[arch] = serve_in_child(arch, n_layers, **dirs)
        phase_s[f"4 serve {arch}"] = time.perf_counter() - t0
        if first:
            t0 = time.perf_counter()
            warm = serve_in_child(arch, n_layers, warm=True, **dirs)
            check_warm_start(serving[arch], warm, cache_root / "serve")
            phase_s[f"4a warm serve {arch}"] = time.perf_counter() - t0

    # -- 5-7. the hand-written kernels and their paths ---------------------
    t0 = time.perf_counter()
    hand_rows = check_hand_kernels(hand_cases(gen))
    phase_s["5 hand kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    check_backward(gen)
    phase_s["6 backward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grouped = grouped_phase()
    phase_s["5b grouped experts"] = time.perf_counter() - t0
    paths = run_paths(hand, phase_s)
    path_d = run_path_d(phase_s)
    t0 = time.perf_counter()
    path_e = path_e_in_child()
    phase_s["7 path E"] = time.perf_counter() - t0

    # -- 8-10. the compile driver: measured autotune, fusion, calibration --
    t0 = time.perf_counter()
    tuned_res = autotune_phase(tuned)
    phase_s["8 measured autotune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fusion_res = fusion_phase(tuned)
    phase_s["9 fused vs unfused"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    calib = calibration_phase(served, rows, cache_root / "main")
    phase_s["10 calibration"] = time.perf_counter() - t0

    # -- 11. resilience on the card -----------------------------------------
    t0 = time.perf_counter()
    res = resilience_phase(cache_root, dict(SERVED)[RESILIENCE_ARCH])
    check_resilience(res, serving[RESILIENCE_ARCH])
    phase_s["11 resilience"] = time.perf_counter() - t0

    # -- 12. training on the hand kernels ------------------------------------
    t0 = time.perf_counter()
    training = train_phase(hand, card, cache_root, phase_s)
    phase_s["12 training"] = time.perf_counter() - t0

    # -- 13. the multi-device runtime over NCCL ------------------------------
    t0 = time.perf_counter()
    mesh = mesh_in_child()
    phase_s["13 multi-device"] = time.perf_counter() - t0

    # -- 14. the step analysis, the dry-run and the examples ----------------
    t0 = time.perf_counter()
    analysis = analysis_in_child()
    phase_s["14 analysis"] = time.perf_counter() - t0

    for arch, rec in serving.items():
        for name, n in rec["launches"].items():
            rows[name]["launches"] = n
    for name, n in path_e["launches"].items():
        rows[name]["launches"] = n
    path_shapes = {p: s for p, (_, _, _, s) in paths.items()}
    path_shapes.update({p: r["launch_shapes"] for p, r in training.items()
                        if "launch_shapes" in r})
    path_shapes.update(mesh["d"]["launch_shapes"])
    for name, row in hand_rows.items():
        row["launches_by_path"] = {p: c[name] for p, (c, _, _, _) in
                                   paths.items()}
        row["launches_by_path"].update(
            {p: r["launches"][name] for p, r in training.items()
             if "launches" in r})
        row["launches_by_path"].update(
            {p: c[name] for p, c in mesh["d"]["launches"].items()})
        row["launches"] = sum(row["launches_by_path"].values())
        held = {case["key"] for case in row["cases"]}
        for case in row["cases"]:
            case["launches_by_path"] = {
                p: s[name][case["key"]] for p, s in path_shapes.items()
                if s.get(name, {}).get(case["key"])}
        for p, s in path_shapes.items():
            unheld = sorted(set(s.get(name, {})) - held)
            if unheld:
                fail(f"{p} launched {name} at {unheld}, where phase 5 did "
                     "not hold it against its plain version")
    print("serving: " + json.dumps({a: {k: v for k, v in r.items()
                                        if k != "launches"}
                                    for a, r in serving.items()}))
    print("paths: " + json.dumps({
        **{p: {**timing, "max_abs_diff_vs_plain": d}
           for p, (_, timing, d, _) in paths.items()}, "D": path_d,
        "E": {k: v for k, v in path_e.items() if k != "launches"}}))
    print("compile driver: " + json.dumps({
        "warm_serve": {k: v for k, v in warm.items() if k != "tokens"},
        "measured_autotune": tuned_res, "fusion": fusion_res,
        "calibration": calib}))
    print("resilience: " + json.dumps({
        "card": card, "seconds": phase_s["11 resilience"],
        **{run: {k: v for k, v in rec.items()
                 if k not in ("tokens", "kernel_launches", "rungs")}
           for run, rec in res.items()}}))
    print("training: " + json.dumps({"card": card, **training}))
    print("multi-device: " + json.dumps({
        "card": card, **{k: v for k, v in mesh.items() if k != "d"},
        "d": {k: v for k, v in mesh["d"].items()
              if k not in ("launch_shapes",)}}))
    print("analysis: " + json.dumps({"card": card, **analysis}))
    print("grouped experts: " + json.dumps(grouped))
    print("weights route: " + json.dumps({"card": card, **route}))
    print("phase seconds: " + json.dumps(phase_s))
    print(json.dumps({"kernels": list(rows.values())
                      + list(hand_rows.values())}))
    shutil.rmtree(cache_root, ignore_errors=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
