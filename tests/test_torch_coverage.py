"""Emitter coverage: EVERY fusion snapshot of every in-repo program lowers
through the port's ``codegen_cuda.emit_program`` (which has no fallback:
it emits a CUDA kernel per group or raises), in both grouped and
one-kernel-per-region modes, with the reference Pallas emitter's report,
and its kernels' plain versions (chained by ``KernelRun``) reproduce the
numpy interpreter on the original program.

The CUDA side of the same matrix (every snapshot's kernels built and run
on the card) is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import array_program as JAP
from repro.core import codegen_pallas as JCP
from repro.core.fusion import fuse as j_fuse
from repro.core.interpreter import run as j_run
from repro.pipeline import packing as JPK
from repro_torch.core import array_program as TAP
from repro_torch.core import codegen_cuda as CC
from repro_torch.core.fusion import fuse
from repro_torch.pipeline import packing as P
from test_torch_cuda import PROGRAMS, merged_inputs  # noqa: E402
import torch_port  # noqa: F401


@pytest.mark.parametrize("group", [True, False], ids=["grouped",
                                                      "ungrouped"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_every_snapshot_emits_like_the_reference(name, group):
    build, dims, blocks = PROGRAMS[name]
    g, jg = build(TAP), build(JAP)
    inputs = merged_inputs(g, dims, blocks)
    nested = {jg.nodes[i].name: JPK.to_nested(inputs[jg.nodes[i].name],
                                              jg.nodes[i].vtype, dims)
              for i in jg.input_ids}
    oracle = j_run(jg, nested, dims)
    out_types = P.output_types(g)
    snaps, jsnaps = fuse(g), j_fuse(jg)
    assert len(snaps) == len(jsnaps) >= 2
    for i, (snap, jsnap) in enumerate(zip(snaps, jsnaps)):
        fn, report = CC.emit_program(snap, dims, blocks, group=group)
        _, jreport = JCP.emit_program(jsnap, dims, blocks, interpret=True,
                                      group=group)
        assert jreport.fallbacks == 0
        assert report.summary() == jreport.summary(), f"{name}[{i}]"
        for _, kern in fn.region_runners:
            assert isinstance(kern, CC.CudaKernel)
            assert kern.smem_bytes <= CC.SMEM_LIMIT
        feed = [torch.from_numpy(inputs[snap.nodes[j].name])
                for j in snap.input_ids]
        outs = fn(*feed)
        for o, oid, vt in zip(outs, snap.output_ids, out_types):
            want = P.from_nested(oracle[snap.nodes[oid].name], vt, dims)
            np.testing.assert_allclose(o.numpy(), want, rtol=2e-4,
                                       atol=2e-4, err_msg=f"{name}[{i}]")


def test_multi_output_program_emits_every_output():
    """A program with two outputs (the fused result AND an intermediate)
    lowers to kernels that write both."""
    ap = TAP.ArrayProgramBuilder()
    x = ap.input("X", ("M", "K"))
    yt = ap.input("YT", ("N", "K"))
    ln = ap.layernorm_rows(x, 32.0)
    ap.output("Z", ap.matmul_t(ln, yt, out_dim="N"))
    ap.output("XN", ln)
    g = ap.build()
    dims, blocks = {"M": 2, "K": 4, "N": 2}, {"M": 4, "K": 8, "N": 8}
    snap = fuse(g)[-1]
    fn, report = CC.emit_program(snap, dims, blocks)
    assert report.launches == 1
    rng = np.random.default_rng(0)
    X = rng.normal(size=(8, 32)).astype(np.float32)
    Y = rng.normal(size=(32, 16)).astype(np.float32)
    outs = dict(zip([snap.nodes[o].name for o in snap.output_ids],
                    fn(torch.from_numpy(X), torch.from_numpy(Y.T.copy()))))
    mu = X.mean(1, keepdims=True)
    xn = (X - mu) / np.sqrt((X ** 2).mean(1, keepdims=True) - mu ** 2)
    np.testing.assert_allclose(outs["XN"].numpy(), xn, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(outs["Z"].numpy(), xn @ Y, rtol=1e-4,
                               atol=1e-4)
