"""Perf hillclimbing driver: measure one (arch x shape) cell's per-rank
roofline terms under a named variant — a (config override, sharding-rule
override, output-pinning) tuple — so each hypothesis -> change -> measure
cycle is one command.  The port of ``repro.launch.hillclimb``; it runs the
dry-run's ``meta`` step (``launch.dryrun``) and, like it, must run as its
own process (it joins the ``fake`` backend at world 512):

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch qwen2-7b --shape train_4k --variant out_shardings

``out_shardings`` has no ``jit`` to pin here: its counterpart keeps the
updated parameters and optimizer state on their input shardings by
redistributing the step's outputs to them, and the collectives that
costs are counted with the step (``dryrun._pin_outputs``).  The reference
also donates the old state; eager PyTorch frees it when the caller drops
it, which the dry-run's count does not see.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import (active_params, dryrun_config,
                                       extrapolated_roofline,
                                       init_fake_world)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.runtime.op_analysis import model_flops

# ---------------------------------------------------------------------------
# variant registry: name -> dict(cfg=..., rules=..., out_shardings=bool)
# ---------------------------------------------------------------------------

DP_ONLY_RULES = {
    # small models: replicate params, shard batch over ALL 256/512 chips
    "batch": ("pod", "data", "model"),
    "capacity": ("pod", "data"),
    "expert": (),
    "tensor": (),
    "fsdp": (),
    "kv_seq": (),
}

FSDP_DP_RULES = {
    # batch over everything, params sharded over data (storage only)
    "batch": ("pod", "data", "model"),
    "fsdp": ("data",),
    "capacity": ("pod", "data"),
    "tensor": (),
    "expert": ("model",),
    "kv_seq": (),
}

SEQ_TENSOR_RULES = {
    # inference prefill: shard sequence over data instead of batch-only
    "batch": ("pod",),
    "seq": ("data",),
    "tensor": ("model",),
    "expert": ("model",),
    "capacity": ("data",),
    "fsdp": (),
    "kv_seq": ("data",),
}

VARIANTS = {
    "baseline": {},
    "out_shardings": {"out_shardings": True},
    "dp_only": {"rules": DP_ONLY_RULES},
    "dp_only_out": {"rules": DP_ONLY_RULES, "out_shardings": True},
    "fsdp_dp": {"rules": FSDP_DP_RULES, "out_shardings": True},
    "remat_dots": {"cfg": {"remat_policy": "dots"}},
    "no_remat": {"cfg": {"remat": False}},
    "cap_1_0": {"cfg": {"capacity_factor": 1.0}},
    "remat_dots_out": {"cfg": {"remat_policy": "dots"},
                       "out_shardings": True},
    "p_half": {"cfg": {"attn_p_half": True}},
    "p_half_out": {"cfg": {"attn_p_half": True}, "out_shardings": True},
    "dp_p_half_out": {"cfg": {"attn_p_half": True}, "rules": DP_ONLY_RULES,
                      "out_shardings": True},
    "moe_shard_map": {"cfg": {"moe_impl": "shard_map"}},
    "moe_sm_out": {"cfg": {"moe_impl": "shard_map"}, "out_shardings": True},
    "moe_sm_dots_out": {"cfg": {"moe_impl": "shard_map",
                                "remat_policy": "dots"},
                        "out_shardings": True},
}


def measure(arch: str, shape_name: str, variant: str,
            multi_pod: bool = False) -> dict:
    spec = VARIANTS[variant]
    init_fake_world()
    cfg = dryrun_config(get_config(arch))
    if spec.get("cfg"):
        cfg = dataclasses.replace(cfg, **spec["cfg"])
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
    rules = spec.get("rules")
    roof = extrapolated_roofline(cfg, shape, mesh, rules=rules,
                                 out_shardings=spec.get("out_shardings",
                                                        False))
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = model_flops(active_params(cfg), tokens,
                     "train" if shape.kind == "train" else "serve")
    n_chips = mesh.size()
    return {
        "arch": arch, "shape": shape_name, "variant": variant,
        "flops_per_chip": roof.flops,
        "hbm_bytes_per_chip": roof.hbm_bytes,
        "coll_bytes_per_chip": roof.coll_bytes,
        "t_compute_s": roof.t_compute,
        "t_memory_s": roof.t_memory,
        "t_collective_s": roof.t_collective,
        "bottleneck": roof.bottleneck,
        "useful_flops_ratio": (mf / n_chips) / roof.flops if roof.flops
        else 0,
        "roofline_fraction": roof.fraction_of_roofline(mf / n_chips),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline",
                    choices=sorted(VARIANTS))
    ap.add_argument("--multi", action="store_true")
    args = ap.parse_args(argv)
    out = measure(args.arch, args.shape, args.variant, args.multi)
    print(json.dumps(out, indent=2, default=str))


if __name__ == "__main__":
    main()
