"""chip_smoke.py's path E checks that need no card, on the CPU at
jamba-1.5-large-398b's reduced period (8 layers, d 128), float32, the
``pipeline`` impls on the ``cuda`` backend (each emitted kernel's plain
version on CPU tensors) against the plain impls:

* ``path_e_layers`` holds every mixer's and MLP's increment and every
  cache entry, prefill and decode, within ``LAYER_TOL``; a zeroed
  attention (prefill or decode) or SwiGLU output, or a wrong cache slot,
  exceeds it;
* ``profile_decode.step_cost`` counts a hybrid's caches (k/v rows attended,
  the Mamba2 state and conv window read and written), the untied
  embedding's looked-up rows only, the held experts' capacity rows, and a
  tied embedding whole (it is the head).
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs as C
from repro_torch.launch import profile_decode as PD
from repro_torch.models import layers as L
from repro_torch.models.lm import LM
import torch_port  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

B, SEQ, P0 = 2, 40, 36


@pytest.fixture(scope="module")
def period():
    cfg = dataclasses.replace(C.get_reduced_config("jamba-1.5-large-398b"),
                              dtype=torch.float32, expert_share=(0, 2))
    cfg = C.with_pipeline(cfg, backend="cuda")
    model = LM(cfg)
    params = model.init_params(seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (B, SEQ),
                         generator=torch.Generator().manual_seed(0))
    return model, LM(dataclasses.replace(cfg, **CS.PLAIN_IMPLS)), params, \
        toks[:, :P0]


def _layers(period, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    model, plain, params, prompt = period
    with torch.no_grad():
        return CS.path_e_layers(model, plain, params, prompt, SEQ)


def test_layer_gate_holds_every_layer(period, monkeypatch):
    out = _layers(period, monkeypatch)
    model = period[0]
    n = model.cfg.n_layers
    assert sum(k.startswith("prefill") and k.endswith(("attn", "mamba"))
               for k in out) == n
    assert sum(k.startswith("decode") and k.endswith(("swiglu", "moe"))
               for k in out) == n
    assert {k for k in out if k.endswith("slot 0")} == {
        "prefill 0 h slot 0", "prefill 0 conv slot 0", "prefill 4 k slot 0",
        "prefill 4 v slot 0"}
    assert max(out.values()) <= CS.LAYER_TOL, max(out, key=out.get)


def _zero_attention(decode_only):
    orig = L._attention_pipeline

    def zeroed(q, *a, **kw):
        o = orig(q, *a, **kw)
        return o * 0 if not decode_only or q.shape[-2] == 1 else o
    return zeroed


@pytest.mark.parametrize("fault,where", [
    ("attention", "prefill 4 attn"), ("decode attention", "decode 4 attn"),
    ("swiglu", "prefill 0 swiglu"), ("slots", "prefill 1 h slot 0")])
def test_layer_gate_sees_each_fault(period, monkeypatch, fault, where):
    if fault == "slots":
        model = period[0]
        slots = list(model.slots)
        slots[0], slots[1] = slots[1], slots[0]
        monkeypatch.setattr(model, "slots", tuple(slots))
    elif fault == "swiglu":
        orig = L._swiglu_pipeline
        monkeypatch.setattr(L, "_swiglu_pipeline",
                            lambda *a, **kw: orig(*a, **kw) * 0)
    else:
        monkeypatch.setattr(L, "_attention_pipeline",
                            _zero_attention(fault == "decode attention"))
    out = _layers(period, monkeypatch)
    assert out[where] > CS.LAYER_TOL


def test_step_cost_of_a_hybrid(period):
    model, _, params, prompt = period
    cfg = model.cfg
    with torch.no_grad():
        _, cache = model.prefill(params, prompt, max_len=SEQ)
    assert set(cache) == {"k", "v", "h", "conv"}
    values = sum(t.numel() for t in PD._tensors(params))
    read = values - (cfg.vocab - B) * cfg.d_model
    experts = sum(t.numel() for layer in params["layers"]
                  for k, t in layer["mlp"].items() if k.startswith("we_"))
    kv = 2 * cache["k"][0].numel() // SEQ * (P0 + 1)
    state = 2 * (cache["h"].numel() + cache["conv"].numel())
    nbytes, ops = PD.step_cost(cfg, params, cache, B, P0, SEQ)
    assert nbytes == 4 * (read + kv + state + B * cfg.vocab)
    assert ops == 2 * (B * (read - experts)
                       + L.moe_capacity(B, cfg) * experts)


def test_step_cost_reads_a_tied_embedding_whole():
    cfg = dataclasses.replace(C.get_reduced_config("smollm-135m"),
                              dtype=torch.float32)
    assert cfg.tie_embeddings
    model = LM(cfg)
    params = model.init_params(seed=0, device="cpu")
    cache = model.init_cache(3, 16, device="cpu")
    values = sum(t.numel() for t in PD._tensors(params))
    kv = sum(t.numel() for t in cache.values()) // 16 * 5
    nbytes, ops = PD.step_cost(cfg, params, cache, 3, 4, 16)
    assert nbytes == 4 * (values + kv + 3 * cfg.vocab)
    assert ops == 2 * 3 * values
