"""``BENCHMARK.json`` keeps the benchmark's contract as far as the files
show it, and each metric's reader is found by name."""

import json

import pytest

from bench_small import config_names, load_config
from benchlib import spec

BENCH = spec.load()
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_benchmark_json_keeps_the_contract():
    assert spec.problems(BENCH) == []
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_has_a_reader(name):
    read = spec.reader(name)
    assert callable(read)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    w = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    mix = spec.traffic(w["traffic"])
    assert cfg["check"]["sample_requests"] >= 4
    eng = mix["engine"]
    assert eng["max_len"] >= (mix["prompt_tokens"]["max"]
                              + mix["output_tokens"]["max"])
    assert mix["prompt_tokens"]["max"] <= eng["prompt_buckets"][-1] \
        < eng["max_len"]
    traced = spec.metrics_of(BENCH, cell, True)
    assert traced and all(m["source"] for m in traced)
    assert {m["name"] for m in spec.metrics_of(BENCH, cell, False)} >= {
        "setup_s", "output_tok_s"}


@pytest.mark.parametrize("name", config_names())
def test_config_ports_the_published_sizes(name):
    cfg = load_config(name)
    port = cfg["port"]
    assert port["d_model"] == cfg["hidden_size"]
    assert port["n_layers"] == cfg["num_hidden_layers"]
    assert port["n_heads"] == cfg["num_attention_heads"]
    assert port["n_kv_heads"] == cfg["num_key_value_heads"]
    assert port["d_head"] == cfg["reference"]["head_dim"]
    assert port["vocab"] == cfg["vocab_size"]
    assert port["rope_theta"] == cfg["rope_theta"]
    assert port["norm_eps"] == cfg["rms_norm_eps"]
    assert port["tie_embeddings"] == cfg["tie_word_embeddings"]
    if cfg["reference"]["mlp"] == "moe":
        assert port["n_experts"] == cfg["published"]["num_experts"] \
            == cfg["reference"]["router_experts"]
        assert port["expert_share"] == cfg["reference"]["experts_held"]
        assert port["expert_share"][1] == cfg["num_experts"]
        assert port["top_k"] == cfg["num_experts_per_tok"]
        assert port["moe_d_ff"] == cfg["moe_intermediate_size"]
        # dropless: an expert's capacity is every token of a step
        assert port["capacity_factor"] * port["top_k"] >= port["n_experts"]
    else:
        assert port["d_ff"] == cfg["intermediate_size"]
    for key in cfg["reduced"]:
        assert key in cfg and key in cfg.get("published", {})
    json.dumps(cfg)
