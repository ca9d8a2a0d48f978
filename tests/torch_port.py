"""What every port test module (``tests/test_torch_*.py``) shares: its
thread budget, and the port's config fields that the reference's config
has not.

**The thread budget.**  Under pytest-xdist each worker's torch starts one
intra-op thread per core, so ``-n N`` workers would run N times as many
threads as the machine has cores, each waiting on the others.  Imported
by a worker (xdist's ``PYTEST_XDIST_WORKER_COUNT`` is set), this module
caps torch's intra-op threads at the worker's share of the cores,
``max(1, os.cpu_count() // workers)``, and sets ``OMP_NUM_THREADS`` to the
same number in the worker's environment, so every process a port test
starts (the examples, the serve, train and dry-run command lines, the
mesh ranks and the reference's child) inherits it.  Outside xdist it
changes nothing: torch keeps its default.

    import torch_port  # noqa: F401   (the budget alone)
    from torch_port import reference_fields
"""

import dataclasses
import os

import torch


def _budget():
    """The worker's share of the cores, or None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return min(torch.get_num_threads(),
               max(1, (os.cpu_count() or 1) // int(workers)))


#: torch's intra-op threads in this worker (None: outside xdist, untouched)
THREADS = _budget()
if THREADS is not None:
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)

#: fields of the port's ``ModelConfig`` the reference's has not: runtime
#: choices, a deployment's expert share and routing, YaRN, CUDA graphs
PORT_ONLY = ("dtype", "attn_impl", "mlp_impl", "pipeline_backend",
             "expert_share", "router_score", "router_groups",
             "router_groups_kept", "routed_scale", "rope_factor",
             "rope_original_max", "rope_beta_fast", "rope_beta_slow",
             "rope_mscale", "rope_mscale_all_dim", "cuda_graphs")


def reference_fields(cfg) -> dict:
    """The port config's fields that the reference's config shares, by
    name: every field outside :data:`PORT_ONLY`."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in PORT_ONLY}
