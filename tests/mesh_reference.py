"""The reference's multi-device values for the port's mesh tests, computed
in a process of its own, where jax sees several CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/mesh_reference.py collectives OUT_DIR

``collectives`` (4 devices) writes ``collectives.npz``: the inputs and the
reference's outputs of ``_moe_apply_sharded`` (forward and gradients, at
a (data 2, model 2) mesh), ``distributed_decode_attention`` (over 4 and 2
devices) and 8 steps of ``compressed_psum_mean`` (over 4).  ``sharding``
(256 devices) writes ``sharding.json``: ``logical_to_spec`` under every
rule set of ``launch.hillclimb.VARIANTS`` on three mesh layouts, and the
sanitized shardings of ``make_step`` at the (16, 16) production mesh.
``analysis`` (256 devices) writes ``analysis.json``: the dry-run's
``active_params`` and ``layer_knobs`` for every arch,
``attention_intermediate_bytes`` for every cell, ``hillclimb``'s
``VARIANTS`` and rule sets, and each supported cell's per-device
argument bytes at the (16, 16) mesh (the sum of ``NamedSharding
.shard_shape`` bytes over ``make_step``'s arguments; nothing compiles).

The pytest workers' own jax sees one device (``tests/conftest.py``), so
these run here; the test modules start this script and read its files.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: the devices each job needs
DEVICES = {"collectives": 4, "sharding": 256, "analysis": 256}
#: the file each job writes
OUTPUT = {"collectives": "collectives.npz", "sharding": "sharding.json",
          "analysis": "analysis.json"}

#: the MoE cases: (arch, capacity factor); reduced configs (4 experts,
#: top-2, d 128); deepseek-v3 adds a shared expert
MOE_CASES = (("qwen3-moe-30b-a3b", 1.25), ("deepseek-v3-671b", 1.25),
             ("qwen3-moe-30b-a3b", 8.0), ("deepseek-v3-671b", 8.0))
MOE_X = (4, 8)                     # (batch, seq) of the layer's input
#: the decode cases: (world, pos); the reference test's case (pos 45) and
#: one that leaves whole shards empty
DECODE_CASES = ((4, 45), (2, 45), (4, 10), (2, 20))
DECODE_SHAPE = (2, 4, 2, 64, 32)   # b, h, hkv, s, dh (test_extensions.py)
#: the logical axis tuples held under every rule set
LOGICAL = [(), (None,), ("batch",), ("batch", None), ("fsdp", "tensor"),
           ("tensor", "fsdp"), ("expert", "fsdp", None),
           ("expert", None, "fsdp"), ("expert", "capacity", None),
           ("batch", "tensor", "kv_seq", None), ("batch", "kv_seq", None),
           ("batch", "seq", None), ("seq", "tensor"), ("kv_seq", "batch"),
           ("batch", "fsdp"), ("unknown", "tensor"),
           (None, "batch", "tensor", None, None), ("capacity", "batch")]
LAYOUTS = (("data", "model"), ("pod", "data", "model"), ("data",))
STEP_CELLS = (("qwen2-7b", "train_4k"), ("qwen2-7b", "decode_32k"))


def run(job: str, out_dir) -> Path:
    """Run ``job`` in a child process with its devices; returns the file
    it wrote."""
    env = dict(os.environ,
               XLA_FLAGS=("--xla_force_host_platform_device_count="
                          f"{DEVICES[job]}"),
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, __file__, job, str(out_dir)],
                   env=env, check=True, timeout=600)
    return Path(out_dir) / OUTPUT[job]


def _collectives(out: Path):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import get_reduced_config
    from repro.kernels.ref import attention_ref
    from repro.launch.mesh import make_debug_mesh
    from repro.models import layers as L
    from repro.models.common import ParamBuilder
    from repro.optim.compression import compressed_psum_mean
    from repro.runtime.collectives import distributed_decode_attention
    from repro.runtime.sharding import use_mesh

    jax.config.update("jax_default_matmul_precision", "highest")
    res = {}
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    for n, (arch, cf) in enumerate(MOE_CASES):
        cfg = get_reduced_config(arch, capacity_factor=cf,
                                 moe_impl="shard_map")
        pb = ParamBuilder(jax.random.key(n), cfg.dtype)
        L.init_moe(pb, cfg)
        p, _ = pb.build()
        rng = np.random.default_rng(n)
        x = jnp.asarray(rng.normal(size=(*MOE_X, cfg.d_model)), jnp.float32)
        gamma = jnp.asarray(1 + 0.1 * rng.normal(size=(cfg.d_model,)),
                            jnp.float32)
        ct = jnp.asarray(rng.normal(size=x.shape), jnp.float32)

        def f(p, x, gamma, cfg=cfg):
            with use_mesh(mesh):
                return L.moe_apply(p, x, gamma, cfg)

        y = jax.jit(f)(p, x, gamma)
        grads = jax.jit(jax.grad(lambda p, x, g: jnp.sum(f(p, x, g) * ct),
                                 argnums=(0, 1, 2)))(p, x, gamma)
        pre = f"moe{n}_"
        res.update({pre + "x": x, pre + "gamma": gamma, pre + "ct": ct,
                    pre + "out": y, pre + "dx": grads[1],
                    pre + "dgamma": grads[2]})
        for k in p:
            res[pre + "p_" + k] = p[k]
            res[pre + "d_" + k] = grads[0][k]

    b, h, hkv, s, dh = DECODE_SHAPE
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.normal(size=(b, h, 1, dh)), jnp.float32)
    k = jnp.asarray(rng.normal(size=(b, hkv, s, dh)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(b, hkv, s, dh)), jnp.float32)
    res.update(dec_q=q, dec_k=k, dec_v=v)
    for world, pos in DECODE_CASES:
        dm = Mesh(np.asarray(jax.devices()[:world]).reshape(world,),
                  ("data",))
        res[f"dec_{world}_{pos}"] = distributed_decode_attention(
            q, k, v, pos, dm)
        res[f"dec_ref_{pos}"] = attention_ref(q, k[:, :, :pos + 1],
                                              v[:, :, :pos + 1])

    cm = Mesh(np.asarray(jax.devices()[:4]).reshape(4,), ("data",))
    rng = np.random.default_rng(0)
    errors = None
    for step in range(8):
        grads = {"w": jnp.asarray(rng.normal(size=(4, 256)), jnp.float32)}
        synced, errors = compressed_psum_mean(grads, cm, ("data",), errors)
        res[f"cps_g{step}"] = grads["w"]
        res[f"cps_s{step}"] = synced["w"]
        res[f"cps_e{step}"] = errors["w"]
    np.savez(out / "collectives.npz",
             **{k: np.asarray(v) for k, v in res.items()})


def _spec(ps):
    """A PartitionSpec as JSON: one entry per dim, a name, a list of
    names, or None."""
    return [list(e) if isinstance(e, tuple) else e for e in ps]


def _sharding(out: Path):
    import jax
    from jax.tree_util import tree_flatten_with_path

    from repro.configs import SHAPES, get_config
    flags = os.environ["XLA_FLAGS"]
    from repro.launch import hillclimb      # sets XLA_FLAGS on import
    os.environ["XLA_FLAGS"] = flags
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import make_step
    from repro.runtime import sharding as SH

    class Stand:
        def __init__(self, names):
            self.axis_names = names

    rules = {}
    named = [(name, v.get("rules")) for name, v in hillclimb.VARIANTS.items()]
    named += [(name, v) for name, v in vars(hillclimb).items()
              if name.endswith("_RULES")]
    for name, rs in named:
        key = json.dumps(sorted((rs or SH.DEFAULT_RULES).items()))
        rules.setdefault(key, (name, rs))
    specs = []
    for name, rs in rules.values():
        for layout in LAYOUTS:
            with SH.use_mesh(None, rs):
                for axes in LOGICAL:
                    specs.append({"variant": name, "layout": list(layout),
                                  "rules": rs, "axes": list(axes),
                                  "spec": _spec(SH.logical_to_spec(
                                      axes, Stand(layout)))})
    steps = {}
    mesh = make_production_mesh()
    for arch, shape in STEP_CELLS:
        _, args, shardings = make_step(get_config(arch), SHAPES[shape])
        flat, _ = tree_flatten_with_path(
            shardings(mesh), is_leaf=lambda x: x is None)
        steps[f"{arch}/{shape}"] = [
            [[getattr(k, "key", getattr(k, "idx", None)) for k in path],
             None if sh is None else _spec(sh.spec)]
            for path, sh in flat]
    (out / "sharding.json").write_text(json.dumps(
        {"specs": specs, "steps": steps, "jax_devices": jax.device_count()}))


def _analysis(out: Path):
    import math

    import jax
    import numpy as np

    from repro.configs import ARCHS, SHAPES, all_cells, cell_supported
    flags = os.environ["XLA_FLAGS"]
    from repro.launch import dryrun, hillclimb   # set XLA_FLAGS on import
    os.environ["XLA_FLAGS"] = flags
    from repro.launch.mesh import make_production_mesh
    from repro.launch.steps import make_step
    from repro.runtime import sharding as SH

    knobs = {}
    for arch, cfg in ARCHS.items():
        ks, with_counts = dryrun.layer_knobs(cfg)
        c = with_counts({k: 2 for k, _ in ks})
        knobs[arch] = {"knobs": [list(k) for k in ks],
                       "at_2": [c.n_layers, c.n_dense_layers,
                                c.n_enc_layers],
                       "active": dryrun.active_params(cfg)}
    adj, args = {}, {}
    mesh = make_production_mesh()
    for arch, shape in all_cells():
        adj[f"{arch}/{shape}"] = dryrun.attention_intermediate_bytes(
            ARCHS[arch], SHAPES[shape])
        if not cell_supported(arch, shape)[0]:
            continue
        with SH.use_mesh(mesh):
            _, a, shardings = make_step(ARCHS[arch], SHAPES[shape])
            shs = jax.tree.leaves(shardings(mesh))
        leaves = jax.tree.leaves(a)
        args[f"{arch}/{shape}"] = sum(
            math.prod(sh.shard_shape(x.shape)) * np.dtype(x.dtype).itemsize
            for x, sh in zip(leaves, shs))
    rules = {name: v for name, v in vars(hillclimb).items()
             if name.endswith("_RULES")}
    (out / "analysis.json").write_text(json.dumps(
        {"knobs": knobs, "adj": adj, "args": args, "rules": rules,
         "variants": hillclimb.VARIANTS, "n_devices": jax.device_count()}))


if __name__ == "__main__":
    job, out_dir = sys.argv[1], Path(sys.argv[2])
    {"collectives": _collectives, "sharding": _sharding,
     "analysis": _analysis}[job](out_dir)
