"""The plain reference (``reference/decoder.py``) against the program at
small widths on the CPU, dense and MoE with an expert share, on the
weights the benchmark draws; and the reference stands alone."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from bench_small import small_config
from benchlib import runner, weights
from reference.decoder import Decoder, _tf32

REFERENCE = Path(__file__).resolve().parent / "reference"


def _pair(name, seed=11):
    cfg = small_config(name)
    mc = runner.port_config(cfg, torch.device("cpu"))
    mc = dataclasses.replace(mc, attn_impl="ref", mlp_impl="unfused")
    from repro_torch.models.lm import LM
    lm = LM(mc)
    meta = lm.init_params(0, "meta")
    flat = weights.draw(meta, cfg["init"], seed, "cpu")
    return cfg, lm, weights.rebuild(meta, flat), \
        weights.reference_names(flat, cfg["param_map"])


@pytest.mark.parametrize("name", ["qwen2-7b", "qwen3-moe-30b-a3b"])
def test_reference_matches_the_program(name):
    cfg, lm, params, ref_w = _pair(name)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg["vocab_size"], (3, 40), generator=g)
    with torch.no_grad():
        prog = lm.forward(params, tokens)
    ref = Decoder(cfg, ref_w)
    for b in range(tokens.shape[0]):
        want = ref.logits(tokens[b])
        assert want.shape == prog[b].shape
        err = (prog[b] - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
    # the last rows alone are the same rows
    assert torch.equal(ref.logits(tokens[0], last=5),
                       ref.logits(tokens[0])[-5:])


def test_expert_shares_add_up():
    cfg = small_config("qwen3-moe-30b-a3b")
    cfg["reference"]["experts_held"] = [0, 8]
    cfg["num_experts"] = 8
    g = torch.Generator().manual_seed(0)
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    w = {"layers.0.gate": torch.randn(d, 8, generator=g),
         "layers.0.experts_gate_proj": torch.randn(8, d, f, generator=g),
         "layers.0.experts_up_proj": torch.randn(8, d, f, generator=g),
         "layers.0.experts_down_proj": torch.randn(8, f, d, generator=g)}
    x = torch.randn(10, d, generator=g)
    whole = Decoder(cfg, w).mlp(0, x)
    parts = torch.zeros_like(whole)
    for first in (0, 4):
        c = dict(cfg, reference=dict(cfg["reference"],
                                     experts_held=[first, 4]))
        share = {k: (v[first:first + 4] if "experts_" in k else v)
                 for k, v in w.items()}
        parts += Decoder(c, share).mlp(0, x)
    assert torch.allclose(parts, whole, rtol=1e-5, atol=1e-4)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0000002])
    assert _tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                                 -3.0]


def test_control_precision_differs():
    cfg, _, _, ref_w = _pair("qwen2-7b")
    tokens = torch.arange(30) % cfg["vocab_size"]
    a = Decoder(cfg, ref_w).logits(tokens)
    b = Decoder(cfg, ref_w, "tf32").logits(tokens)
    diff = (a - b).abs().max().item()
    assert 1e-6 < diff < 1e-1


@pytest.mark.parametrize("path", sorted(REFERENCE.rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("repro_torch", "repro", "jax",
                                           "benchlib"), n
