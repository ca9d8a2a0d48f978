"""Where the hand flash-attention, RMSNorm+SwiGLU and LayerNorm+matmul
kernels spend their time, on the card: each kernel is rebuilt with one
part taken out and timed against itself at the paths' shapes.

    PYTHONPATH=src python -m repro_torch.launch.hand_variants

Variants (the outputs of all but ``kernel`` are wrong by design):

* ``kernel``: the kernel as it is;
* ``no copies``: the cp.async copies removed (the products run on whatever
  shared memory holds), so what remains is the products and the rest;
* ``no products``: the mma.sync instructions removed (the compiler drops
  the operand loads and splits that feed only them), so what remains is
  the copies, barriers and softmax or epilogue;
* ``one TF32 pass`` (float32): ``ah bh`` alone instead of 3xTF32, which
  reads the rate of one pass of TF32 products.

RMSNorm+SwiGLU is also timed with X streamed instead of its normalised
rows held in shared memory (the layout of every D wider than the panel
fits), and as one cluster of its M = 2048 launch (the first 32 rows, 2
blocks): if that takes as long as all 128 blocks, each SM's own chain of
chunks, not a resource the SMs share, sets the time.
LayerNorm+matmul is timed at path B's encoder and decoder shapes, with
its own variants besides (``LN_VARIANTS``: no register cap, no output
stores, no split pass over gamma * Y, deeper K steps, other ring depths),
and under other launches than ``launch_shape``'s (``LN_LAUNCHES``: rows
a block and K ranks), which shows what its choices buy.

Times are CUDA events over 50 back-to-back launches after 3 warm ones
(a kernel shorter than the host's enqueue of a launch, about 0.012 ms,
reads that enqueue time instead); the card's name and power limit head
the output.  Needs a CUDA card and nvcc (sm_90a).
"""

from __future__ import annotations

import subprocess

import torch

from repro_torch.core import cuda_build as CB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import layernorm_matmul as LN
from repro_torch.kernels import rmsnorm_swiglu as SW

_MMA = ('  asm("mma.sync.aligned.m16n8k', '  if (c == nullptr) asm("mma.sync.aligned.m16n8k')
VARIANTS = {
    "kernel": [],
    "no copies": [('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, '
                   '%2;\\n" ::"r"(', '  if (dst == nullptr) asm volatile('
                   '"cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(')],
    "no products": [_MMA],
    "one TF32 pass": [("  mma_tf32(c, al, bh);\n  mma_tf32(c, ah, bl);\n", "")],
}
KERNEL_FILES = ((FA, "flash_attention.cu"), (SW, "rmsnorm_swiglu.cu"),
                (LN, "layernorm_matmul.cu"))
#: LayerNorm+matmul only: its 128 x 64 blocks without the register cap
#: that lets two share an SM; without its output stores; without the pass
#: that splits gamma * Y (the products read a stale split tile); K steps
#: of 64 (half the barriers a call) and rings of 2 or 4 stages
_BK64 = ("constexpr int BK = 32; ", "constexpr int BK = 64; ")
LN_VARIANTS = {
    "one block an SM": [("WM == 4 ? 2 : 1", "1")],
    "no output stores": [("store(&z[", "if (z == nullptr) store(&z[")],
    "no split pass": [("for (int k = yk; k < BK;", "for (int k = yk; k < 0;")],
    "K steps of 64": [_BK64],
    "K steps of 64, 2 stages": [_BK64, ("NSTAGE = 3;", "NSTAGE = 2;")],
    "2 stages": [("NSTAGE = 3;", "NSTAGE = 2;")],
    "4 stages": [("NSTAGE = 3;", "NSTAGE = 4;")],
}
#: path B's LayerNorm+matmul shapes (M, K, N), and the launches (rows a
#: block, K ranks) timed at each
LN_SHAPES = {"encoder": (3000, 384, 1536), "decoder": (128, 384, 1536)}
LN_LAUNCHES = {"encoder": ((128, 1), (64, 1), (128, 2)),
               "decoder": ((128, 6), (128, 4), (128, 8), (64, 3), (64, 6),
                           (32, 2), (32, 4))}


def variant(file: str, launcher: CB.Launcher, subs) -> CB.Launcher:
    """``launcher``'s kernel with ``mma.cuh`` inlined and edited (an edit
    that ``mma.cuh`` does not hold applies to the kernel's own source)."""
    header = (CB.CSRC / "mma.cuh").read_text()
    body = (CB.CSRC / file).read_text()
    for old, new in subs:
        if old in header:
            header = header.replace(old, new)
        elif old in body:
            body = body.replace(old, new)
        else:
            raise RuntimeError(f"variant edit not found in mma.cuh or "
                               f"{file}: {old!r}")
    source = body.replace('#include "mma.cuh"',
                          header.replace("#pragma once", ""))
    return CB.Launcher(source, launcher.symbol, launcher.argtypes)


def time_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    kernels = {(mod.__name__, name): variant(file, mod.KERNEL, subs)
               for mod, file in KERNEL_FILES
               for name, subs in VARIANTS.items()}
    kernels.update({(LN.__name__, name): variant(
        "layernorm_matmul.cu", LN.KERNEL, subs)
        for name, subs in LN_VARIANTS.items()})
    CB.build_many([(k.key, k.source) for k in kernels.values()])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    stream = torch.cuda.current_stream().cuda_stream
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = int(dtype == torch.bfloat16)
        m, d, k, n = 2048, 576, 1536, 576
        x, g = randn(m, d, dtype=dtype), randn(d, scale=0.1) + 1.0
        w, v = (randn(d, k, scale=d ** -0.5, dtype=dtype) for _ in "wv")
        u = randn(k, n, scale=k ** -0.5, dtype=dtype)
        out = torch.empty(m, n, dtype=dtype, device="cuda")
        shape = SW.launch_shape(m, d, k, n, dtype)
        for name in VARIANTS:
            if bf16 and name == "one TF32 pass":
                continue
            kern = kernels[(SW.__name__, name)]
            ms = time_ms(lambda: kern.launch(
                x.data_ptr(), w.data_ptr(), v.data_ptr(), u.data_ptr(),
                g.data_ptr(), out.data_ptr(), m, d, k, n, 1e-6, bf16,
                shape.cluster, shape.kslice, 1, 1, stream))
            print(f"rmsnorm_swiglu {dtype} (2048,576,1536,576) {name}: "
                  f"{ms:.4f} ms", flush=True)
        ms = time_ms(lambda: SW.KERNEL.launch(
            x.data_ptr(), w.data_ptr(), v.data_ptr(), u.data_ptr(),
            g.data_ptr(), out.data_ptr(), m, d, k, n, 1e-6, bf16,
            shape.cluster, shape.kslice, 1, 0, stream))
        print(f"rmsnorm_swiglu {dtype} (2048,576,1536,576) X streamed, not "
              f"held in shared memory: {ms:.4f} ms", flush=True)
        ms = time_ms(lambda: SW.KERNEL.launch(
            x.data_ptr(), w.data_ptr(), v.data_ptr(), u.data_ptr(),
            g.data_ptr(), out.data_ptr(), SW.BM, d, k, n, 1e-6, bf16,
            shape.cluster, shape.kslice, 1, 1, stream))
        print(f"rmsnorm_swiglu {dtype} one cluster of that launch "
              f"({shape.cluster} blocks, {SW.BM} rows): {ms:.4f} ms",
              flush=True)
        for b, hq, hkv, sq, skv, causal in (
                (4, 9, 3, 512, 512, True), (2, 6, 6, 1500, 1500, False),
                (2, 6, 6, 64, 64, True), (2, 6, 6, 64, 1500, False)):
            q = randn(b, hq, sq, 64, dtype=dtype)
            kk, vv = (randn(b, hkv, skv, 64, dtype=dtype) for _ in "kv")
            o = torch.empty_like(q)
            shape = FA.launch_shape(b, hq, hkv, sq, skv, 64, dtype)
            for name in VARIANTS:
                if bf16 and name == "one TF32 pass":
                    continue
                kern = kernels[(FA.__name__, name)]
                ms = time_ms(lambda: kern.launch(
                    q.data_ptr(), kk.data_ptr(), vv.data_ptr(), o.data_ptr(),
                    b, hq, hkv, sq, skv, 64, 0.125, int(causal), 0, bf16,
                    shape.bq, shape.split, shape.chunk, stream))
                print(f"flash_attention {dtype} q {(b, hq, sq)} kv "
                      f"{(b, hkv, skv)} {name}: {ms:.4f} ms", flush=True)
        for label, (m, k, n) in LN_SHAPES.items():
            x, y = randn(m, k, dtype=dtype), randn(k, n, dtype=dtype)
            g, bt = randn(k, scale=0.1) + 1.0, randn(k, scale=0.1)
            z = torch.empty(m, n, dtype=dtype, device="cuda")

            def ln_launch(kern, bm, split):
                return lambda: kern.launch(
                    x.data_ptr(), y.data_ptr(), g.data_ptr(), bt.data_ptr(),
                    z.data_ptr(), m, k, n, 1e-5, bf16, bm, split,
                    LN.k_slice(k, split), 1, stream)

            shape = LN.launch_shape(m, k, n, dtype)
            for name in (*VARIANTS, *LN_VARIANTS):
                if bf16 and name == "one TF32 pass":
                    continue
                ms = time_ms(ln_launch(kernels[(LN.__name__, name)],
                                       shape.bm, shape.split))
                print(f"layernorm_matmul {dtype} {label} {(m, k, n)} "
                      f"{name}: {ms:.4f} ms", flush=True)
            for bm, split in LN_LAUNCHES[label]:
                blocks = split * -(-m // bm) * -(-n // LN.BN)
                ms = time_ms(ln_launch(LN.KERNEL, bm, split))
                print(f"layernorm_matmul {dtype} {label} launch {bm} x "
                      f"{LN.BN} split={split} ({blocks} blocks): {ms:.4f} ms",
                      flush=True)


if __name__ == "__main__":
    main()
