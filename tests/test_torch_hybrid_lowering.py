"""Path E's emitted programs (chip_smoke.py: jamba-1.5-large-398b's
attention and SwiGLU at published widths, on the ``cuda`` backend)
lowered on the CPU, without nvcc, at the card run's shapes: attention
over 64 query heads and 8 KV heads of 128 at 480 and 512 query rows and
its ragged decode over 512 positions, the SwiGLU at d 8192, d_ff 24576
over 1920, 2048 and 4 rows.

* every program lowers on the rung it asks for, no planned group split;
* every kernel's shared memory fits one H100 block
  (``codegen_cuda.SMEM_LIMIT``, 232,448 B): past 32 rows the layers take
  the widest row block of ``layers.CUDA_ROW_BLOCKS`` that lowers whole
  (attention 32 rows, the SwiGLU 64), not the reference's 128, which
  overruns it at these widths, and every wider block fails to;
* each kernel has its CUDA source, launch plan and a block count.
"""

import sys
from pathlib import Path

import pytest

from repro_torch.core import codegen_cuda as CC
from repro_torch.models import layers as L
import torch_port  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402


@pytest.fixture(scope="module")
def programs():
    cfg = CS.path_e_config()
    return cfg, CS.path_e_programs(cfg, device="cpu")


def test_path_e_programs(programs):
    cfg, progs = programs
    assert (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.rope_theta) == (8192, 24576, 64, 8, 128, 0.0)
    assert cfg.held_experts == (0, 2) and cfg.n_experts == 16
    assert sorted(progs) == sorted(
        ["attention_prefill480", "attention_prefill512", "attention_decode",
         "swiglu_prefill480", "swiglu_prefill512", "swiglu_decode"])


#: rows a block past 32 rows: the widest of ``layers.CUDA_ROW_BLOCKS``
#: that lowers whole at jamba's widths
WIDEST = {"attention": 32, "swiglu": 64}


def _program(cfg, kind, rows):
    """The program, sizes and stack dims of path E's ``kind`` at ``rows``
    (query rows of one sequence, or token rows)."""
    from repro_torch.core import array_program as AP
    if kind == "attention":
        g = AP.gqa_attention_program(1.0 / cfg.d_head ** 0.5, causal=True)
        return g, {"M": rows, "D": cfg.d_head, "N": rows,
                   "L": cfg.d_head}, {"H": cfg.n_heads // cfg.n_kv_heads}
    g = AP.rmsnorm_ffn_swiglu_program(float(cfg.d_model), eps=cfg.norm_eps)
    return g, {"M": rows, "D": cfg.d_model, "K": cfg.d_ff,
               "N": cfg.d_model}, {}


@pytest.mark.parametrize("name", ["attention_prefill480",
                                  "attention_prefill512", "attention_decode",
                                  "swiglu_prefill480", "swiglu_prefill512",
                                  "swiglu_decode"])
def test_lowers_on_its_rung_within_shared_memory(programs, name):
    cfg, progs = programs
    ck = progs[name]
    rr = ck.resilience_report
    assert ck.rung == rr.requested == "grouped", rr.summary()
    assert not ck.lowering_report.degraded
    rows = {"attention_prefill480": 480, "attention_prefill512": 512,
            "attention_decode": 1, "swiglu_prefill480": 1920,
            "swiglu_prefill512": 2048, "swiglu_decode": 4}[name]
    assert ck.dims["M"] * ck.blocks["M"] == rows
    kind = name.split("_")[0]
    assert ck.blocks["M"] == (rows if rows <= 32 else WIDEST[kind])
    if rows > 32:
        # every wider row block overruns the emitter's shared memory
        g, sizes, stack = _program(cfg, kind, rows)
        for target in L.CUDA_ROW_BLOCKS[:L.CUDA_ROW_BLOCKS.index(
                WIDEST[kind])]:
            dims, blocks = L._pipeline_dims_blocks(sizes, target)
            dims.update(stack)
            blocks.update({d: 1 for d in stack})
            assert not L._lowers_whole(g, dims, L._pipeline_options(
                cfg).replace(blocks=blocks), "cpu"), (name, target)
    assert len(ck.kernels) == (1 if name.startswith("attention") else 3)
    for k in ck.kernels:
        assert 0 < k.smem_bytes <= CC.SMEM_LIMIT, (k.gid, k.smem_bytes)
        assert k.blocks > 0 and k.plan.launch_dims
        assert f"{k.plan.blocks} blocks x instances" in k.source
        assert k.kname in k.source
