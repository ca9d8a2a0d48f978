"""The port's compile driver on the five block programs, against the JAX
reference on the same inputs.

Every program goes through the port's ``torch`` backend (the plain
whole-program lowering), its ``cuda`` backend's kernel schedule (on CPU
tensors each emitted kernel runs its plain version, chained by
``KernelRun``), and its ``py`` interpreter, and is held against
``repro.pipeline.compile(..., backend="jax")`` and the numpy interpreter
at ``rtol = atol = 1e-5`` (float32; only summation order differs).  The
|logit| ~ 1e4 attention cases must stay finite and match the stabilized
oracle within 2e-4, as the reference's ``tests/test_huge_logits.py``
asks of its own backends.
"""

import numpy as np
import pytest
import torch

from repro import pipeline as JP
from repro.core import array_program as JAP
from repro.core import interpreter as JI
from repro.core import numerics as JNU
from repro.pipeline import packing as JPK
from repro_torch import pipeline as TP
from repro_torch.core import array_program as TAP
import torch_port  # noqa: F401

TOL = 1e-5
B = 8  # block size of every dim (the reference fixtures' size)


def _programs():
    """name -> (builder(array_program module), dims, blocks, input shapes)"""
    att = {"M": 2, "D": 2, "N": 3, "L": 2}
    att_in = {"Q": (16, 16), "KT": (24, 16), "VT": (16, 24)}
    causal_in = dict(att_in, QP=(16,), KP=(24,))
    gqa_in = dict(causal_in, Q=(3, 16, 16))
    ln = {"M": 2, "K": 3, "N": 2}
    sw = {"M": 2, "D": 3, "K": 4, "N": 2}
    return {
        "attention": (lambda A: A.attention_program(0.25), att, att_in),
        "causal_attention": (lambda A: A.causal_attention_program(0.25),
                             att, causal_in),
        "gqa_attention": (lambda A: A.gqa_attention_program(0.25,
                                                            causal=True),
                          dict(att, H=3), gqa_in),
        "layernorm_matmul": (lambda A: A.layernorm_matmul_program(24.0), ln,
                             {"X": (16, 24), "YT": (16, 24)}),
        "rmsnorm_ffn_swiglu": (
            lambda A: A.rmsnorm_ffn_swiglu_program(24.0, eps=1e-6), sw,
            {"X": (16, 24), "WT": (32, 24), "VT": (32, 24),
             "UT": (16, 32)}),
    }


PROGRAMS = _programs()


def _blocks(dims):
    return {d: (1 if d == "H" else B) for d in dims}


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if name in ("QP", "KP"):
            out[name] = np.arange(shape[0], dtype=np.float32)
        else:
            out[name] = rng.normal(size=shape).astype(np.float32)
    return out


@pytest.fixture()
def jcache(tmp_path):
    return JP.KernelCache(tmp_path)


def _reference(name, inputs, jcache):
    build, dims, _ = PROGRAMS[name]
    k = JP.compile(build(JAP), dims,
                   options=JP.CompileOptions(backend="jax"), cache=jcache)
    return np.asarray(k(inputs)[k.out_names[0]])


def _port(name, backend, inputs):
    build, dims, _ = PROGRAMS[name]
    k = TP.compile(build(TAP), dims, options=TP.CompileOptions(
        backend=backend, blocks=_blocks(dims)))
    feed = (inputs if backend == "py"
            else {n: torch.from_numpy(v) for n, v in inputs.items()})
    return k, np.asarray(k(feed)[k.out_names[0]])


@pytest.mark.parametrize("backend", ["torch", "cuda", "py"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_jax_reference(name, backend, jcache):
    inputs = _inputs(PROGRAMS[name][2], seed=len(name))
    ref = _reference(name, inputs, jcache)
    kern, got = _port(name, backend, inputs)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    if backend == "cuda":
        assert kern.launches == len(kern.kernels) >= 1


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_numpy_interpreter(name):
    """The torch lowering against the reference's numpy interpreter on
    the unfused program (stabilized where the driver stabilizes)."""
    build, dims, shapes = PROGRAMS[name]
    inputs = _inputs(shapes, seed=7)
    g = build(JAP)
    nested = {g.nodes[i].name: JPK.to_nested(inputs[g.nodes[i].name],
                                             g.nodes[i].vtype, dims)
              for i in g.input_ids}
    run = (JNU.run_stabilized if JNU.needs_stabilization(g) else JI.run)
    out = run(g, nested, dims)
    want = JPK.from_nested(out[g.nodes[g.output_ids[0]].name],
                           JPK.output_types(g)[0], dims)
    _, got = _port(name, "torch", inputs)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_cuda_schedule_matches_reference_lowering_report(name, jcache):
    """Same snapshot, same regions, same groups: the port's cuda report
    equals the reference's pallas report at the test shapes."""
    build, dims, _ = PROGRAMS[name]
    ref = JP.compile(build(JAP), dims, options=JP.CompileOptions(
        backend="pallas", blocks=_blocks(dims)), cache=jcache)
    port = TP.compile(build(TAP), dims, options=TP.CompileOptions(
        backend="cuda", blocks=_blocks(dims)))
    assert port.lowering_report.summary() == ref.lowering_report.summary()
    assert port.snapshot_index == ref.snapshot_index
    assert port.kernel_ids == ref.kernel_ids


def test_instance_axes_match_a_loop_over_instances():
    """A batched call (two instance axes, one input shared through a
    size-1 axis) equals calling the kernel once per instance."""
    build, dims, shapes = PROGRAMS["gqa_attention"]
    k = TP.compile(build(TAP), dims, options=TP.CompileOptions(
        backend="cuda", blocks=_blocks(dims)))
    rng = np.random.default_rng(3)
    feed = {"Q": rng.normal(size=(2, 3) + shapes["Q"]),
            "KT": rng.normal(size=(2, 3) + shapes["KT"]),
            "VT": rng.normal(size=(2, 3) + shapes["VT"]),
            "QP": np.arange(16.0)[None, None].repeat(2, 0) + [[[0]], [[5]]],
            "KP": np.arange(24.0)[None, None]}
    feed = {n: torch.tensor(v, dtype=torch.float32) for n, v in feed.items()}
    got = k(feed, instances=2)["O"]
    for b in range(2):
        for h in range(3):
            one = {n: v[min(b, v.shape[0] - 1), min(h, v.shape[1] - 1)]
                   for n, v in feed.items()}
            torch.testing.assert_close(got[b, h], k(one)["O"], rtol=TOL,
                                       atol=TOL)


# ---------------------------------------------------------------------------
# |logit| ~ 1e4 (the reference's huge-logit matrix)
# ---------------------------------------------------------------------------

QSCALE = 2000.0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("variant", ["plain", "causal", "gqa"])
def test_huge_logits_stay_finite(variant, backend):
    name = {"plain": "attention", "causal": "causal_attention",
            "gqa": "gqa_attention"}[variant]
    build, dims, shapes = PROGRAMS[name]
    inputs = _inputs(shapes, seed=11)
    inputs["Q"] = inputs["Q"] * QSCALE
    g = build(JAP)
    nested = {g.nodes[i].name: JPK.to_nested(inputs[g.nodes[i].name],
                                             g.nodes[i].vtype, dims)
              for i in g.input_ids}
    oracle = JPK.from_nested(JNU.run_stabilized(g, nested, dims)["O"],
                             JPK.output_types(g)[0], dims)
    kern, got = _port(name, backend, inputs)
    assert kern.stabilized
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
