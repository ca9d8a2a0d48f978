"""The control at a size a test run holds, on the CPU: the reference at
TF32 put in the program's place (``reference.decoder``,
``precision="tf32"``) reads above each configuration's limit, on every
seed tried.
On the chip ``calibrate.py`` reads it at the cells' own sizes (PERF.md
§2)."""

import pytest
import torch

from bench_small import config_names, load_config, small_config
from benchlib import check, runner, weights
from reference.decoder import Decoder

POSITIONS = 256


def _larger(name):
    """The small configuration at widths where TF32's rounding shows:
    d 128, 6 layers, a vocabulary of 32768."""
    cfg = small_config(name)
    cfg.update(hidden_size=128, num_hidden_layers=6, vocab_size=32768)
    cfg["reference"]["head_dim"] = 32
    if "head_dim" in cfg:
        cfg["head_dim"] = 32
    cfg["port"].update(d_model=128, n_layers=6, vocab=32768, d_head=32)
    return cfg


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", config_names())
def test_control_fails_the_limit(name, seed):
    from repro_torch.models.lm import LM
    cfg = _larger(name)
    meta = LM(runner.port_config(cfg, torch.device("cpu"))).init_params(
        0, "meta")
    flat = weights.draw(meta, cfg["init"], seed, "cpu")
    w = weights.reference_names(flat, cfg["param_map"])
    ref, ctl = Decoder(cfg, w), Decoder(cfg, w, "tf32")
    g = torch.Generator().manual_seed(seed)
    parts = []
    for _ in range(load_config(name)["check"]["sample_requests"]):
        seq = torch.randint(0, cfg["vocab_size"], (POSITIONS,), generator=g)
        logits = ref.logits(seq)
        best = logits.max(-1).values
        first = ctl.logits(seq).argmax(-1)
        parts.append({"gap": best - logits.max(-1).values,
                      "control_gap": best - logits.gather(
                          1, first[:, None])[:, 0]})
    limits = load_config(name)["check"]["limits"]
    program = check.reading(parts, "gap")
    control = check.reading(parts, "control_gap")
    for number, limit in limits.items():
        assert program[number] <= limit
    assert any(control[number] > limit for number, limit in limits.items()
               ), (control, limits)
