"""Continuous-batching LM serving of the torch port: the port of
``repro.launch.serve``.

Programmatic API::

    from repro_torch.launch.serve import ServeConfig, run
    report = run(ServeConfig(arch="smollm-135m", n_requests=8))

On the card the defaults serve the full-width model through the emitted
CUDA kernels (``backend="cuda"``, ``device="cuda"``).  Compiled plans
persist in the kernel cache directory (``$REPRO_TORCH_KERNEL_CACHE``,
default ``build/repro_torch/cache``): a later process serving the same
model loads them from disk (``ServeReport.cache_disk_hits``) without
fusion, selection or nvcc.  ``arch`` is any dense or MoE architecture
of ``repro_torch.configs`` (smollm-135m, llama3.2-1b, qwen2-7b,
qwen3-32b, qwen3-moe-30b-a3b, deepseek-v3-671b); ``n_layers`` cuts the
depth (:func:`cut_depth`), never a width.  ``max_queue`` bounds
admission and ``repromote_after`` is the clean ticks before a demoted
decode rung is probed (None, ``0`` on the CLI: never).  Decode demotes
only on CPU tensors: on the card a failed decode step raises.  The CLI
prints the rung decode ended on and the resilience counters beside the
cache's.  The CLI::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --n-requests 8 --json report.json
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-30b-a3b --reduced --n-layers 2 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.launch.engine import (SUPPORTED_FAMILIES, Engine,
                                       ServeReport, synth_trace)


@dataclass(frozen=True)
class ServeConfig:
    """Everything a serving run needs — model, scheduler, trace, sampling."""
    arch: str = "smollm-135m"
    reduced: bool = False
    n_layers: Optional[int] = None   # cut the depth (None: the config's)
    backend: str = "cuda"            # pipeline codegen backend
    device: str = "cuda"
    dtype: str = "float32"
    # -- scheduler ----------------------------------------------------------
    max_batch: int = 4
    max_len: int = 96
    prompt_buckets: Tuple[int, ...] = (8, 16, 32)
    max_queue: Optional[int] = None  # bounded admission; None = unbounded
    # -- synthetic open-loop trace -------------------------------------------
    n_requests: int = 16
    arrival_rate: float = 1.0
    prompt_lens: Tuple[int, int] = (4, 24)
    gen_lens: Tuple[int, int] = (4, 16)
    # -- sampling -----------------------------------------------------------
    sampling: str = "greedy"
    temperature: float = 1.0
    seed: int = 0
    # -- run ----------------------------------------------------------------
    max_steps: Optional[int] = None
    record_logits: bool = False      # keep each sampled logits row
    # -- self-healing -------------------------------------------------------
    # clean decode ticks on a demoted rung before a half-open probe may
    # re-promote the rung above; None disables re-promotion (decode
    # demotes on the CPU only)
    repromote_after: Optional[int] = 8


def model_config(cfg: ServeConfig):
    """The model configuration a serving run uses."""
    mc = (configs.get_reduced_config(cfg.arch) if cfg.reduced
          else configs.get_config(cfg.arch))
    mc = dataclasses.replace(mc, dtype=getattr(torch, cfg.dtype))
    if cfg.n_layers is not None:
        mc = cut_depth(mc, cfg.n_layers)
    return configs.with_pipeline(mc, backend=cfg.backend)


def cut_depth(mc, n_layers: int):
    """``mc`` at ``n_layers`` layers with its layer mix kept: a model with
    MoE layers keeps at least one (its leading dense layers cut to
    ``n_layers - 1``, the split of the reference's ``reduced_config``), so
    deepseek-v3 cut to 2 layers is 1 dense + 1 MoE layer; a hybrid keeps
    whole periods of ``attn_period`` layers (jamba: 8, 16, ...), and any
    other count raises."""
    if mc.family == "hybrid" and (n_layers < mc.attn_period
                                  or n_layers % mc.attn_period):
        raise ValueError(f"{mc.name}: a hybrid's depth is whole periods of "
                         f"{mc.attn_period} layers, not {n_layers}")
    over = {"n_layers": n_layers}
    if mc.n_experts and mc.n_dense_layers < mc.n_layers:
        over["n_dense_layers"] = min(mc.n_dense_layers, n_layers - 1)
    return dataclasses.replace(mc, **over)


def build_engine(cfg: ServeConfig, params=None) -> Engine:
    """The configured engine (kernels compiled by ``warmup()``); weights
    are drawn from ``cfg.seed`` unless ``params`` are given."""
    mc = model_config(cfg)
    return Engine(mc, params=params, device=cfg.device,
                  max_batch=cfg.max_batch, max_len=cfg.max_len,
                  prompt_buckets=cfg.prompt_buckets,
                  sampling=cfg.sampling, temperature=cfg.temperature,
                  seed=cfg.seed, record_logits=cfg.record_logits,
                  max_queue=cfg.max_queue,
                  repromote_after=cfg.repromote_after)


def trace_for(cfg: ServeConfig, vocab: int):
    return synth_trace(cfg.n_requests, seed=cfg.seed,
                       arrival_rate=cfg.arrival_rate,
                       prompt_lens=cfg.prompt_lens, gen_lens=cfg.gen_lens,
                       vocab=vocab)


def run(cfg: ServeConfig, params=None) -> ServeReport:
    """Build the engine, warm the kernel set, replay the trace."""
    engine = build_engine(cfg, params)
    trace = trace_for(cfg, engine.cfg.vocab)
    engine.warmup()
    return engine.run(trace, max_steps=cfg.max_steps)


def main(argv=None) -> ServeReport:
    ap = argparse.ArgumentParser(
        description="continuous-batching serving on emitted CUDA kernels")
    ap.add_argument("--arch", default="smollm-135m",
                    choices=sorted(n for n, c in configs.ARCHS.items()
                                   if c.family in SUPPORTED_FAMILIES))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--backend", default="cuda",
                    choices=("py", "torch", "cuda"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--buckets", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission: reject arrivals past this "
                         "queue depth (default: unbounded)")
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=1.0)
    ap.add_argument("--prompt-lens", type=int, nargs=2, default=[4, 24])
    ap.add_argument("--gen-lens", type=int, nargs=2, default=[4, 16])
    ap.add_argument("--sampling", default="greedy",
                    choices=("greedy", "categorical"))
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--repromote-after", type=int, default=8,
                    help="clean decode ticks on a demoted rung before a "
                         "half-open probe may re-promote the rung above "
                         "(0 disables re-promotion; decode demotes only "
                         "with --device cpu)")
    ap.add_argument("--json", dest="json_out", default=None)
    args = ap.parse_args(argv)
    cfg = ServeConfig(arch=args.arch, reduced=args.reduced,
                      n_layers=args.n_layers, backend=args.backend,
                      device=args.device, max_batch=args.max_batch,
                      max_len=args.max_len,
                      prompt_buckets=tuple(args.buckets),
                      max_queue=args.max_queue,
                      n_requests=args.n_requests,
                      arrival_rate=args.arrival_rate,
                      prompt_lens=tuple(args.prompt_lens),
                      gen_lens=tuple(args.gen_lens), sampling=args.sampling,
                      temperature=args.temperature, seed=args.seed,
                      max_steps=args.max_steps,
                      repromote_after=(args.repromote_after
                                       if args.repromote_after > 0
                                       else None))
    report = run(cfg)
    # the median engine step is the median ``tick`` span
    tick_ms = statistics.median(r.wall_ms for r in report.per_step) \
        if report.per_step else 0.0
    print(f"arch={args.arch} backend={args.backend} device={report.device} "
          f"requests={report.n_completed}/{report.n_requests} "
          f"steps={report.steps} tokens={report.decode_tokens} "
          f"({report.decode_tokens / max(report.wall_s, 1e-9):.1f} output "
          f"tok/s) tick_p50={tick_ms:.2f}ms "
          f"recompiles={report.decode_recompiles}")
    print(f"kernel cache: memory_hits={report.cache_memory_hits} "
          f"disk_hits={report.cache_disk_hits} "
          f"misses={report.cache_misses} "
          f"hit_rate={report.cache_hit_rate:.3f} "
          f"quarantined={report.quarantined} "
          f"nvcc_builds={report.warmup_builds}")
    print(f"resilience: decode_backend={report.decode_backend} "
          f"degradations={report.degradations} "
          f"quarantined={report.quarantined} "
          f"repromotions={report.repromotions} probes={report.probes} "
          f"probe_failures={report.probe_failures} "
          f"cuda_degraded={report.cuda_degraded} "
          f"deadline_evicted={report.n_deadline_evicted} "
          f"rejected={report.n_rejected}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report.to_json(), f, indent=1)
    return report


if __name__ == "__main__":
    main()
