"""Architecture registry of the torch port and the assigned input-shape
sets: the port of ``repro.configs``.

Every architecture is selectable by ``--arch <id>``; each is paired with
the LM shape set.  ``decode_*`` / ``long_*`` are serve steps (one token
against a filled cache), not train steps.  ``long_500k`` needs
sub-quadratic attention and is run only for the SSM/hybrid architectures
(:func:`cell_supported`)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.configs import (deepseek_v3_671b, internvl2_26b,
                                 jamba_1_5_large_398b, llama3_2_1b,
                                 mamba2_2_7b, qwen2_7b, qwen3_32b,
                                 qwen3_moe_30b_a3b, smollm_135m,
                                 whisper_tiny)
from repro_torch.models.common import ModelConfig, reduced_config

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        qwen2_7b.CONFIG,
        smollm_135m.CONFIG,
        llama3_2_1b.CONFIG,
        qwen3_32b.CONFIG,
        internvl2_26b.CONFIG,
        whisper_tiny.CONFIG,
        mamba2_2_7b.CONFIG,
        deepseek_v3_671b.CONFIG,
        qwen3_moe_30b_a3b.CONFIG,
        jamba_1_5_large_398b.CONFIG,
    ]
}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

#: architectures whose token mixing is sub-quadratic in sequence length
#: (SSM / hybrid)
SUBQUADRATIC = {"mamba2-2.7b", "jamba-1.5-large-398b"}


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


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    """Is the (arch x shape) cell runnable?  Returns (ok, reason)."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("pure full-attention arch: 512k dense-attention "
                       "decode skipped per assignment (sub-quadratic "
                       "attention required)")
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]
