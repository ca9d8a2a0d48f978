"""Small configurations and mixes for the benchmark's CPU tests: the
cells' own files at widths a CPU runs in seconds."""

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
# the program, as bench/run.py puts it on the path
if str(BENCH.parent / "src") not in sys.path:
    sys.path.insert(0, str(BENCH.parent / "src"))


def config_names() -> list:
    """Every configuration under ``configs/``: the cells' and the one kept
    for a cell that is out of ``BENCHMARK.json`` (PERF.md §7)."""
    return sorted(p.stem for p in (BENCH / "configs").glob("*.json"))


def load_config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def small_config(name: str) -> dict:
    """``bench/configs/<name>.json`` at small widths: the same keys, the
    published and the program's sizes changed together."""
    cfg = load_config(name)
    sizes = {"hidden_size": 64, "num_hidden_layers": 2,
             "num_attention_heads": 4, "num_key_value_heads": 2,
             "intermediate_size": 128, "vocab_size": 256}
    cfg.update(sizes)
    cfg["reference"]["head_dim"] = 16
    if "head_dim" in cfg:
        cfg["head_dim"] = 16
    port = cfg["port"]
    port.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                d_ff=128, vocab=256)
    if cfg["reference"]["mlp"] == "moe":
        cfg.update(num_experts=4, num_experts_per_tok=2,
                   moe_intermediate_size=32)
        cfg["reference"].update(router_experts=8, experts_held=[2, 4])
        port.update(n_experts=8, top_k=2, moe_d_ff=32, capacity_factor=4.0,
                    expert_share=[2, 4])
    cfg["check"]["limits"] = {"served_gap": 1e-3}
    return cfg


#: the profiled ticks of the small runs (start share, ticks, of each kind)
SMALL_PROFILE = (0.3, 4, 1)


def small_mix() -> dict:
    """The chat mix at lengths that finish within a few ticks."""
    mix = json.loads((BENCH / "traffic" / "chat-closed32.json").read_text())
    mix.update(clients=8,
               prompt_tokens={"dist": "lognormal", "mean": 8, "sigma": 0.5,
                              "min": 2, "max": 16},
               output_tokens={"dist": "lognormal", "mean": 12, "sigma": 0.5,
                              "min": 1, "max": 24})
    mix["engine"] = {"max_batch": 8, "max_len": 40,
                     "prompt_buckets": [8, 16]}
    return mix
