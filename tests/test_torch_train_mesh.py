"""Data-parallel ``launch/train.py --mesh debug`` and the resharding
restore of ``checkpoint/manager.py``, over gloo on the CPU, reduced
smollm-135m on the reference's weights:

* 3 steps at world size 2 (each rank on its ``host_slice``, the loss and
  gradients the whole batch's) against one process on the full batch:
  the ranks' parameters equal each other bit for bit, each logged loss
  within 1e-6 of the one-process run's (relative) and each parameter
  within 1e-5 of it; the losses within 1e-4 of the reference's
  ``train.main`` (``tests/test_torch_train_loop.py``'s bound);
* a checkpoint saved by one process restores at world size 2 onto the
  logical shardings (``param_specs``, ``AdamW.state_specs``): each
  ``fsdp`` leaf sharded over ``data``, each rank's shard the global's
  slice, the rest replicated;
* a run resumed at world size 2 from that checkpoint ends within 1e-5 of
  one process run straight through.
"""

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

import torch_mesh_workers as W

from repro import configs as JC
from repro.launch import train as JT
from repro.models import build_model as jbuild
from repro_torch.checkpoint.manager import STATE_FILE
from repro_torch.configs import get_reduced_config
from repro_torch.launch import train as TT
from repro_torch.models.lm import LM as TLM
from repro_torch.models.lm import build_model as tbuild
import torch_port  # noqa: F401

ARGV = ["--arch", "smollm-135m", "--reduced", "--batch", "4", "--seq",
        "16", "--lr", "1e-2", "--log-every", "1", "--ckpt-every", "0",
        "--device", "cpu"]
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    """The reference's smollm-135m weights (reduced, seed 0), numpy."""
    jm = jbuild(JC.get_reduced_config("smollm-135m"))
    params, _ = jm.init_params(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture
def reference_init(monkeypatch, weights):
    def init_params(self, seed=0, device="cuda"):
        return self.from_jax_params(weights, device=device)
    monkeypatch.setattr(TLM, "init_params", init_params)


def _leaves(params):
    return [x.detach() for x in pytree.tree_leaves(params)]


def _max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def two_ranks(weights, tmp_path_factory):
    return W.spawn(W.train_rank, 2, tmp_path_factory.mktemp("dp"),
                   ARGV + ["--steps", "3", "--mesh", "debug"], weights)


def test_ranks_stay_replicated(two_ranks):
    a, b = two_ranks
    assert a["losses"] == b["losses"]
    for x, y in zip(a["params"], b["params"]):
        assert torch.equal(x, y)


def test_data_parallel_matches_one_process(two_ranks, reference_init):
    one = TT.main(ARGV + ["--steps", "3"])
    got = two_ranks[0]
    assert [s for s, _ in got["losses"]] == [0, 1, 2]
    for (_, g), (_, w) in zip(got["losses"], one["losses"]):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got["losses"],
                                                  one["losses"])
    assert _max_diff(got["params"], _leaves(one["params"])) <= PARAM_ATOL
    # the step moved the weights far past the tolerance
    start = _leaves(TLM(get_reduced_config("smollm-135m")).init_params(
        device="cpu"))
    assert _max_diff(got["params"], start) > 100 * PARAM_ATOL


def test_data_parallel_matches_reference(two_ranks):
    want = JT.main([a for a in ARGV if a not in ("--device", "cpu")]
                   + ["--steps", "3"])["losses"]
    got = two_ranks[0]["losses"]
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 1e-4 * abs(w), (got, want)


@pytest.fixture(scope="module")
def saved(tmp_path_factory, weights):
    """A checkpoint of 2 steps from one process (step_2) and a straight
    4-step run's parameters."""
    mp = pytest.MonkeyPatch()
    mp.setattr(TLM, "init_params",
               lambda self, seed=0, device="cuda":
               self.from_jax_params(weights, device=device))
    try:
        ck = tmp_path_factory.mktemp("ck")
        TT.main(ARGV + ["--steps", "2", "--ckpt-dir", str(ck)])
        straight = TT.main(ARGV + ["--steps", "4"])
    finally:
        mp.undo()
    return ck, _leaves(straight["params"])


def test_restore_reshards_onto_two_ranks(saved, tmp_path):
    ck, _ = saved
    glob = pytree.tree_leaves(torch.load(ck / "step_2" / STATE_FILE,
                                         weights_only=True))
    ranks = W.spawn(W.restore_rank, 2, tmp_path, str(ck), "smollm-135m")
    sharded = 0
    for r, leaves in enumerate(ranks):
        assert len(leaves) == len(glob)
        for (local, placements, shape), g in zip(leaves, glob):
            assert shape == tuple(g.shape)
            want = g
            # mesh (data 2, model 1): rank r is data index r
            for p, (size, idx) in zip(placements or [], ((2, r), (1, 0))):
                if isinstance(p, Shard):
                    n = want.shape[p.dim] // size
                    want = want.narrow(p.dim, idx * n, n)
                else:
                    assert p == Replicate()
            assert torch.equal(local, want)
            sharded += bool(placements) and isinstance(placements[0], Shard)
    specs = tbuild(get_reduced_config("smollm-135m")).param_specs()
    fsdp = sum("fsdp" in axes for axes in pytree.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, tuple)))
    assert sharded == 2 * 3 * fsdp     # params, m and v, on both ranks


def test_resume_on_two_ranks_matches_straight_run(saved, weights,
                                                  tmp_path):
    ck, straight = saved
    ranks = W.spawn(W.train_rank, 2, tmp_path,
                    ARGV + ["--steps", "4", "--mesh", "debug",
                            "--ckpt-dir", str(ck)], weights)
    assert [s for s, _ in ranks[0]["losses"]] == [2, 3]
    assert _max_diff(ranks[0]["params"], straight) <= PARAM_ATOL
    assert (ck / "step_4").is_dir()
