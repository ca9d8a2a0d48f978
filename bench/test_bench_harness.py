"""The harness's own run on the CPU at small widths (the program's plain
kernel versions): the last line's keys, the check that passes a sound run
and fails each fault a serving cell can have, and the import boundary."""

import json
import os
import subprocess
import sys

import pytest
import torch

from bench_small import SMALL_PROFILE, config_names, small_config, small_mix
from benchlib import runner, spec

BENCH = spec.load()
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture
def kernel_cache(tmp_path, monkeypatch):
    """The program's plan cache in a directory of the test's own, and one
    torch thread: the small model's ticks last milliseconds, and with
    every test process holding a thread per core they stretch past the
    window on a loaded machine, so that no request finishes in it."""
    monkeypatch.setenv("REPRO_TORCH_KERNEL_CACHE", str(tmp_path / "cache"))
    from repro_torch import pipeline
    pipeline.reset_default_cache()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path / "cache"
    torch.set_num_threads(threads)
    pipeline.reset_default_cache()


def _run(cell="qwen2-7b.chat", config="qwen2-7b", seed=21, seconds=3.0,
         trace=False):
    return runner.run_cell(BENCH, cell, seed, seconds, trace, device="cpu",
                           cfg=small_config(config), mix=small_mix(),
                           log=lambda msg: None, profile=SMALL_PROFILE)


@pytest.mark.parametrize("config", config_names())
def test_sound_run_is_correct(kernel_cache, config):
    # the cell's traffic and the run; the configuration's file in small
    out = _run(config=config)
    assert set(out) == KEYS
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["served_gap"]["value"] == 0.0
    assert {"output_tok_s", "ttft_p75_ms", "itl_p95_ms",
            "setup_s"} <= set(out["metrics"])
    assert all(set(m) == {"value", "unit"}
               for m in out["metrics"].values())


def test_traced_run_reports_per_layer_metrics(kernel_cache):
    # long enough that ticks before the profiler include decode-only ones
    # on a loaded machine
    out = _run(trace=True, seconds=4.0)
    assert out["correct"] is True
    assert "breakdown" in out and list(out)[-1] == "checks"
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"decode_tick_ms", "prefill_ms", "mfu_pct"} <= set(out["metrics"])
    assert "window_s" in out["device"] and "busy_s" in out["device"]


def _state_unchanged(monkeypatch):
    from repro_torch.models.lm import LM
    orig = LM.decode_step

    def step(self, params, caches, tokens, pos):
        scratch = {k: v.clone() for k, v in caches.items()}
        logits, _ = orig(self, params, scratch, tokens, pos)
        return logits, caches
    monkeypatch.setattr(LM, "decode_step", step)


def _half_batch(monkeypatch):
    from repro_torch.models.lm import LM
    orig = LM.decode_step

    def step(self, params, caches, tokens, pos):
        logits, caches = orig(self, params, caches, tokens, pos)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:logits.shape[0] - half]
        return logits, caches
    monkeypatch.setattr(LM, "decode_step", step)


def _token_altered(monkeypatch):
    from repro_torch.launch.engine import Engine
    orig = Engine._sample
    calls = {"n": 0}

    def sample(self, logits):
        calls["n"] += 1
        toks = orig(self, logits)
        if calls["n"] % 5 == 0:
            toks = (toks + 1) % self.cfg.vocab
        return toks
    monkeypatch.setattr(Engine, "_sample", sample)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=["state_unchanged", "half_batch",
                              "token_altered"])
def test_fault_fails_the_check(kernel_cache, monkeypatch, plant):
    plant(monkeypatch)
    out = _run(seed=22)
    assert out["correct"] is False
    assert out["checks"]["served_gap"]["value"] > \
        out["checks"]["served_gap"]["limit"]


ROOT = spec.ROOT


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "qwen2-7b.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_run_loads_no_jax(tmp_path):
    """A harness run in its CPU test mode, in a process of its own, loads
    no module whose top-level name is jax, jaxlib, flax or repro."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'bench')!r}, {str(ROOT / 'src')!r}]\n"
        "from bench_small import SMALL_PROFILE, config_names, small_config, small_mix\n"
        "from benchlib import runner, spec\n"
        "out = runner.run_cell(spec.load(), 'qwen2-7b.chat', 3, 2.0, False,"
        " device='cpu', cfg=small_config('qwen2-7b'), mix=small_mix(),"
        " log=lambda m: None)\n"
        "print(json.dumps({'correct': out['correct'],"
        " 'bad': runner.forbidden_modules()}))\n")
    env = dict(os.environ, REPRO_TORCH_KERNEL_CACHE=str(tmp_path / "c"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last == {"correct": True, "bad": []}
