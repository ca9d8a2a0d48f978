"""The paper's two novel kernels, derived automatically and executed, on
the PyTorch/CUDA port: the port's counterpart of
``examples/fusion_megakernels.py``.

  * Flash-LayerNorm+Matmul          (paper Example 2)
  * Flash-RMSNorm+FFN-SwiGLU        (paper Example 3)

Each is derived by the fusion algorithm and interpreted, then computed by
the hand-written CUDA kernel (``kernels.ops``, ``impl="cuda"``): IR-derived
== kernel == numpy.

    PYTHONPATH=src python examples/torch_fusion_megakernels.py   # card
    PYTHONPATH=src python examples/torch_fusion_megakernels.py --device cpu

On the card the hand kernels launch; with ``--device cpu`` each runs its
plain torch version.  Without a card and without ``--device cpu`` it
raises.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import array_program as AP
from repro_torch.core import blocks as B
from repro_torch.core import cost as C
from repro_torch.core.codegen_py import render
from repro_torch.core.fusion import fuse
from repro_torch.core.interpreter import run
from repro_torch.kernels import ops as K


def device_of(argv=None) -> torch.device:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "kernels' plain versions on the CPU")
    return dev


def main(argv=None):
    dev = device_of(argv)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    # --- Example 2: LayerNorm + Matmul -------------------------------------
    M, Kd, N = 3, 4, 2
    KK = Kd * 16
    X = rng.normal(size=(M * 8, KK))
    Y = rng.normal(size=(KK, N * 16))
    snaps = fuse(AP.layernorm_matmul_program(float(KK)))
    print("=" * 72)
    print("Flash-LayerNorm+Matmul (derived by the fusion algorithm):")
    print("=" * 72)
    print(render(snaps[-1]))
    out = B.merge(run(snaps[-1],
                      {"X": B.split(X, M, Kd), "YT": B.split(Y.T, N, Kd)},
                      {"M": M, "K": Kd, "N": N})["Z"])
    mu = X.mean(1, keepdims=True)
    ref = ((X - mu) / np.sqrt((X ** 2).mean(1, keepdims=True) - mu ** 2)) @ Y
    e_ir = np.abs(out - ref).max()
    kout = K.layernorm_matmul(t(X), t(Y), t(np.ones(KK)), t(np.zeros(KK)),
                              eps=0.0, impl="cuda")
    e_k = np.abs(kout.cpu().double().numpy() - ref).max()
    print(f"IR-derived vs numpy: {e_ir:.2e}")
    print(f"CUDA kernel ({dev.type}) vs numpy: {e_k:.2e}")
    assert e_ir < 1e-9 and e_k < 1e-3

    # --- Example 3: RMSNorm + FFN-SwiGLU ------------------------------------
    Mr, Dr, Kr, Nr = 2, 3, 4, 2
    DD = Dr * 16
    X3 = rng.normal(size=(Mr * 8, DD))
    W = rng.normal(size=(DD, Kr * 8)) / np.sqrt(DD)
    V = rng.normal(size=(DD, Kr * 8)) / np.sqrt(DD)
    U = rng.normal(size=(Kr * 8, Nr * 8)) / np.sqrt(Kr * 8)
    snaps3 = fuse(AP.rmsnorm_ffn_swiglu_program(float(DD)))
    print()
    print("=" * 72)
    print("Flash-RMSNorm+FFN-SwiGLU mega-kernel (three matmuls, a Hadamard,")
    print("a reduction and elementwise ops in ONE kernel; paper Example 3):")
    print("=" * 72)
    print(render(snaps3[-1]))
    xn = X3 / np.sqrt((X3 ** 2).mean(1, keepdims=True))
    gsw = xn @ W
    ref3 = ((gsw / (1 + np.exp(-gsw))) * (xn @ V)) @ U
    dims3 = {"M": Mr, "D": Dr, "K": Kr, "N": Nr}
    out3 = B.merge(run(snaps3[-1],
                       {"X": B.split(X3, Mr, Dr), "WT": B.split(W.T, Kr, Dr),
                        "VT": B.split(V.T, Kr, Dr),
                        "UT": B.split(U.T, Nr, Kr)}, dims3)["O"])
    e_ir3 = np.abs(out3 - ref3).max()
    kout3 = K.rmsnorm_swiglu(t(X3), t(W), t(V), t(U), t(np.ones(DD)),
                             eps=0.0, impl="cuda")
    e_k3 = np.abs(kout3.cpu().double().numpy() - ref3).max()
    print(f"IR-derived vs numpy: {e_ir3:.2e}")
    print(f"CUDA kernel ({dev.type}) vs numpy: {e_k3:.2e}")
    assert e_ir3 < 1e-9 and e_k3 < 1e-3

    # snapshots: the paper's replication-vs-buffering trade for selection
    print("\nsnapshots returned to the candidate-selection algorithm:")
    for i, s in enumerate(snaps3):
        tr = C.traffic(s, dims3)
        print(f"  snap{i}: stores={sum(tr.stores.values()):4d} "
              f"loads={sum(tr.loads.values()):5d} "
              f"work={sum(tr.work.values()):5d}")
    print("\nmegakernels ok on", dev)


if __name__ == "__main__":
    main()
