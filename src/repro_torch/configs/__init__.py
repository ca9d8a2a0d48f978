"""Architecture registry of the torch port (the port of ``repro.configs``
for the architectures ported so far)."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (deepseek_v3_671b, internvl2_26b,
                                 llama3_2_1b, mamba2_2_7b, qwen2_7b,
                                 qwen3_32b, qwen3_moe_30b_a3b, smollm_135m,
                                 whisper_tiny)
from repro_torch.models.common import ModelConfig, reduced_config

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [smollm_135m.CONFIG, llama3_2_1b.CONFIG,
                        qwen2_7b.CONFIG, qwen3_32b.CONFIG,
                        qwen3_moe_30b_a3b.CONFIG, whisper_tiny.CONFIG,
                        deepseek_v3_671b.CONFIG, mamba2_2_7b.CONFIG,
                        internvl2_26b.CONFIG]}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_reduced_config(arch: str, **overrides) -> ModelConfig:
    return reduced_config(get_config(arch), **overrides)


def with_pipeline(cfg: ModelConfig, backend: str = "torch",
                  attn: bool = True, mlp: bool = True,
                  options=None) -> ModelConfig:
    """Route attention and the gated MLP through the port's fusion
    pipeline (``repro_torch.pipeline``) on codegen backend ``backend``.
    ``options`` (a ``pipeline.CompileOptions``) sets the whole compile
    configuration; its ``backend`` wins over ``backend``."""
    return dataclasses.replace(
        cfg,
        attn_impl="pipeline" if attn else cfg.attn_impl,
        mlp_impl="pipeline" if mlp else cfg.mlp_impl,
        pipeline_backend=options.backend if options is not None else backend,
        pipeline_options=options)
