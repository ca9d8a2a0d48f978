"""The frozen count functions against worked examples of both
configurations."""

import pytest

from bench_small import load_config
from benchlib.counts import ModelShape, tick_work
from benchlib.peaks import bound_s


def shape(name):
    return ModelShape.of(load_config(name))


def test_qwen2_7b_decode_row():
    m = shape("qwen2-7b")
    per_layer = 3584 * (2 * 3584 + 2 * 512) + 3 * 3584 * 18944
    assert m.attn_weights + m.dense_mlp_weights == per_layer == 233_046_016
    ops, nbytes = tick_work(m, [], [100])
    assert ops == (2 * 28 * per_layer + 4 * 28 * 28 * 128 * 100
                   + 2 * 3584 * 152064)
    assert ops == 14_180_712_448
    small = 2 * 3584 + (28 + 2 * 4) * 128
    weights = 28 * (per_layer + small) + 3584 + 3584 * 152064
    assert nbytes == 4 * (weights + 3584) + 2 * 28 * 4 * 128 * 100 * 4 \
        + 4 * 152064
    assert nbytes == 28_294_567_936
    assert bound_s(ops, nbytes) == nbytes / 3.35e12


def test_qwen2_7b_prefill_and_decode_tick():
    m = shape("qwen2-7b")
    ops, nbytes = tick_work(m, [70], [100] * 31)
    tokens = 70 + 31
    per_layer = 233_046_016
    want = (2 * tokens * 28 * per_layer
            + 4 * 28 * 28 * 128 * (70 * 71 // 2 + 31 * 100)
            + 2 * 32 * 3584 * 152064)
    assert ops == want
    one_ops, one_bytes = tick_work(m, [], [100])
    # the weights are read once a tick, however many rows share them
    assert nbytes < 2 * one_bytes


def test_qwen3_moe_decode_tick():
    m = shape("qwen3-moe-30b-a3b")
    assert (m.experts, m.held, m.top_k, m.expert_ff) == (128, 64, 8, 768)
    attn = 2048 * (2 * 4096 + 2 * 512)
    expert = 3 * 2048 * 768
    ops, nbytes = tick_work(m, [], [100] * 32)
    per_token = attn + 2048 * 128 + 8 * 64 / 128 * expert
    assert ops == pytest.approx(2 * 32 * 48 * per_token
                                + 4 * 48 * 32 * 128 * 3200
                                + 2 * 32 * 2048 * 151936)
    touched = 64 * (1 - (1 - 8 / 128) ** 32)
    assert touched == pytest.approx(55.885, abs=1e-3)
    small = 2 * 2048
    weights = (48 * (attn + 2048 * 128 + small) + 2048 + 2048 * 151936)
    want_bytes = (4 * (weights + 32 * 2048) + 4 * 48 * touched * expert
                  + 2 * 48 * 4 * 128 * 3200 * 4 + 4 * 32 * 151936)
    assert nbytes == pytest.approx(want_bytes)
    assert bound_s(ops, nbytes) == pytest.approx(want_bytes / 3.35e12)


def test_empty_tick_needs_nothing():
    assert tick_work(shape("qwen2-7b"), [], []) == (0.0, 0.0)
