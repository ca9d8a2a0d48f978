"""Quickstart of the PyTorch/CUDA port: rediscover Flash Attention with
the Blockbuster fusion algorithm (paper Example 1), then run the fused
programs as emitted CUDA kernels through ``repro_torch.pipeline``.  The
port's counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On the card every ``backend="cuda"`` compile launches the emitted
kernel; with ``--device cpu`` each kernel runs its plain torch version.
Without a card and without ``--device cpu`` it raises.
"""

import argparse
import warnings

import numpy as np
import torch

from repro_torch import pipeline
from repro_torch.core import array_program as AP
from repro_torch.core import blocks as B
from repro_torch.core import cost as C
from repro_torch.core.codegen_py import render
from repro_torch.core.fusion import FusionTrace, fuse
from repro_torch.core.graph import internal_buffered_edges
from repro_torch.core.numerics import run_stabilized


def device_of(argv=None) -> torch.device:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "kernels' plain versions on the CPU")
    return dev


def t(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                           device=dev)


def main(argv=None):
    dev = device_of(argv)

    # 1. the array program: Attention = Q@K^T -> /sqrt(d) -> softmax -> @V
    dims = {"M": 4, "D": 2, "N": 8, "L": 2}
    d_model = 64
    graph = AP.attention_program(scale=1.0 / np.sqrt(d_model))
    print("=" * 72)
    print("INITIAL block program (paper Table 2 expansion, fully unfused):")
    print("=" * 72)
    print(render(graph))

    # 2. the fusion algorithm (rules in priority 8->4->5->9->3->1->2)
    trace = FusionTrace()
    snapshots = fuse(graph, trace)
    print(f"\nfusion applied {len(trace.steps)} rules "
          "(the paper's Example 1 trace has 17 steps)")
    print("=" * 72)
    print("FINAL fused program == Flash Attention:")
    print("=" * 72)
    print(render(snapshots[-1]))
    assert internal_buffered_edges(snapshots[-1]) == [], "fully fused!"

    # 3. the objective: global-memory traffic collapse
    t0, t1 = C.traffic(graph, dims), C.traffic(snapshots[-1], dims)
    print(f"\nkernel launches : {t0.launches} -> {t1.launches}")
    print(f"block stores    : {sum(t0.stores.values())} -> "
          f"{sum(t1.stores.values())}")
    print(f"block loads     : {sum(t0.loads.values())} -> "
          f"{sum(t1.loads.values())}")

    # 4. logic preservation: interpret the fused program against numpy
    rng = np.random.default_rng(0)
    Q = rng.normal(size=(4 * 8, d_model))
    K = rng.normal(size=(8 * 8, d_model))
    V = rng.normal(size=(8 * 8, 2 * 16))
    inputs = {"Q": B.split(Q, 4, 2), "KT": B.split(K, 8, 2),
              "VT": B.split(V.T, 2, 8)}
    S = (Q @ K.T) / np.sqrt(d_model)
    P = np.exp(S - S.max(1, keepdims=True))
    ref = (P / P.sum(1, keepdims=True)) @ V
    out = B.merge(run_stabilized(snapshots[-1], inputs, dims)["O"])
    err = np.abs(out - ref).max()
    print(f"max |fused IR - numpy| = {err:.2e}")
    assert err < 1e-9

    # 5. the pipeline: fuse -> select -> emit CUDA -> one cached kernel
    blocks = {"M": 8, "D": 32, "N": 8, "L": 16}
    opts = pipeline.CompileOptions(backend="cuda", blocks=blocks)
    kern = pipeline.compile(graph, dims, options=opts, device=dev)
    got = kern({"Q": t(Q, dev), "KT": t(K, dev), "VT": t(V.T, dev)})["O"]
    err = np.abs(got.cpu().double().numpy() - ref).max()
    print(f"\npipeline.compile: backend={kern.backend} rung={kern.rung} "
          f"{kern.lowering_report.summary()}\n  predicted traffic "
          f"x{kern.predicted_traffic_reduction:.2f}, max |kernel - numpy| "
          f"= {err:.2e}")
    assert err < 1e-4
    again = pipeline.compile(graph, dims, options=opts, device=dev)
    print(f"second compile: cache_hit={again.cache_hit!r}")

    # 6. causal attention: the mask is a block operator fed by position
    #    vectors, so one kernel serves every decode position
    cdims = {"M": dims["N"], "D": dims["D"], "N": dims["N"],
             "L": dims["L"]}
    seq = K.shape[0]
    ckern = pipeline.compile(
        AP.causal_attention_program(scale=1.0 / np.sqrt(d_model)), cdims,
        options=opts, device=dev)
    pos = np.arange(seq, dtype=np.float32)
    Qc = np.concatenate([Q, Q], axis=0)[:seq]
    cout = ckern({"Q": t(Qc, dev), "KT": t(K, dev), "VT": t(V.T, dev),
                  "QP": t(pos, dev), "KP": t(pos, dev)})["O"]
    Sc = (Qc @ K.T) / np.sqrt(d_model)
    Sc = np.where(pos[:, None] >= pos[None, :], Sc, -np.inf)
    Pc = np.exp(Sc - Sc.max(1, keepdims=True))
    cref = (Pc / Pc.sum(1, keepdims=True)) @ V
    err = np.abs(cout.cpu().double().numpy() - cref).max()
    print(f"causal kernel: {ckern.lowering_report.summary()}, "
          f"max |kernel - numpy| = {err:.2e}")
    assert err < 1e-4

    # 7. multi-output lowering: LayerNorm(X) @ Y and the normalised rows
    apb = AP.ArrayProgramBuilder()
    x_in = apb.input("X", ("M", "K"))
    yt_in = apb.input("YT", ("N", "K"))
    ln = apb.layernorm_rows(x_in, 32.0)
    apb.output("Z", apb.matmul_t(ln, yt_in, out_dim="N"))
    apb.output("XN", ln)
    multi = apb.build()
    mdims, mblocks = {"M": 2, "K": 4, "N": 2}, {"M": 8, "K": 8, "N": 8}
    mkern = pipeline.compile(multi, mdims, options=pipeline.CompileOptions(
        backend="cuda", blocks=mblocks), device=dev)
    X = rng.normal(size=(16, 32))
    Y = rng.normal(size=(32, 16))
    mout = mkern({"X": t(X, dev), "YT": t(Y.T, dev)})
    mu = X.mean(1, keepdims=True)
    xn_ref = (X - mu) / np.sqrt((X ** 2).mean(1, keepdims=True) - mu ** 2)
    ez = np.abs(mout["Z"].cpu().double().numpy() - xn_ref @ Y).max()
    ex = np.abs(mout["XN"].cpu().double().numpy() - xn_ref).max()
    print(f"\nmulti-output kernel: {mkern.lowering_report.summary()}\n"
          f"  max |Z - numpy| = {ez:.2e}, max |XN - numpy| = {ex:.2e}")
    assert max(ez, ex) < 1e-4

    # 8. region-group megakernels: RMSNorm -> two products + swish ->
    #    product (paper Example 3) partitions into regions that share the
    #    M spine, and the emitter packs them into one kernel
    swiglu = AP.rmsnorm_ffn_swiglu_program(64.0)
    sdims = {"M": 4, "D": 4, "K": 8, "N": 4}
    sblocks = {"M": 16, "D": 16, "K": 16, "N": 16}
    skern = pipeline.compile(swiglu, sdims, options=pipeline.CompileOptions(
        backend="cuda", blocks=sblocks), device=dev)
    srep = skern.lowering_report
    print(f"\ngrouped lowering: {srep.summary()}\n  {srep.n_regions} "
          f"regions -> {srep.launches} launch(es), {srep.resident_edges} "
          "resident edges")
    X3 = rng.normal(size=(64, 64))
    W, Vw = (rng.normal(size=(64, 128)) / 8 for _ in range(2))
    U = rng.normal(size=(128, 64)) / np.sqrt(128)
    o3 = skern({"X": t(X3, dev), "WT": t(W.T, dev), "VT": t(Vw.T, dev),
                "UT": t(U.T, dev)})["O"]
    xn = X3 / np.sqrt((X3 ** 2).mean(1, keepdims=True))
    gsw = xn @ W
    ref3 = ((gsw / (1 + np.exp(-gsw))) * (xn @ Vw)) @ U
    err = np.abs(o3.cpu().double().numpy() - ref3).max()
    print(f"  max |kernel - numpy| = {err:.2e}")
    assert err < 1e-3

    # 9. numerical safety: softmax programs are stabilised by default
    #    (the appendix's online softmax), finite at |logit| ~ 1e4
    huge = {"Q": t(Q * 2000, dev), "KT": t(K, dev), "VT": t(V.T, dev)}
    safe = pipeline.compile(graph, dims, options=opts, device=dev)
    raw = pipeline.compile(graph, dims, options=opts.replace(
        stabilize=False), device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fin_safe = bool(torch.isfinite(safe(huge)["O"]).all())
        fin_raw = bool(torch.isfinite(raw(huge)["O"]).all())
    print(f"\nat |logit| ~ 1e4: stabilized finite={fin_safe}, "
          f"stabilize=False finite={fin_raw}")
    assert safe.stabilized and fin_safe and not fin_raw

    # 10. serving: continuous batching through the emitted kernels, one
    #     ragged decode step whose cache positions are kernel data
    from repro_torch import configs
    from repro_torch.launch.engine import Engine, synth_trace
    serve_cfg = configs.with_pipeline(
        configs.get_reduced_config("smollm-135m", n_layers=2, d_model=64,
                                   n_heads=2, n_kv_heads=2, d_head=32,
                                   d_ff=128, vocab=256),
        backend="cuda")
    engine = Engine(serve_cfg, device=dev, max_batch=2, max_len=32,
                    prompt_buckets=(8,), sampling="greedy", seed=0)
    trace = synth_trace(4, seed=0, arrival_rate=1.0, prompt_lens=(3, 8),
                        gen_lens=(2, 4), vocab=serve_cfg.vocab)
    report = engine.run(trace)
    print(f"\nserving: {report.n_completed}/{report.n_requests} requests "
          f"in {report.steps} steps, {report.decode_tokens} tokens, "
          f"recompiles after warmup = {report.decode_recompiles}")
    assert report.n_completed == len(trace)
    assert report.decode_recompiles == 0
    print("\nquickstart ok on", dev)


if __name__ == "__main__":
    main()
