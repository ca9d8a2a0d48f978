"""The port's train step and training loop against the JAX reference.

* one ``make_train_step`` step with each side's default optimizer, at a
  constant rate of 1e-2, moves each weight as the reference's does
  (within 1e-5, a thousandth of the update; elements whose gradient
  rounds near 0 left out, under 1%), its moments within the gradients' tolerance, and leaves its
  inputs as they were;
* ``train.main`` logs the reference's ``T.main`` losses on the same argv
  at reduced size (1e-4 relative), starting from the reference's weights;
* a crash at step 13, a resume from the step-10 checkpoint and a clean run
  end on bitwise-equal parameters (the reference's crash drill,
  tests/test_train_integration.py:22, on the CPU);
* ``train.deterministic`` restores the deterministic flag and the cuBLAS
  workspace setting it changed.

Loss and gradients are held in ``test_torch_train.py``, whose helpers
this file uses.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_cpu import reference_on_cpu  # noqa: F401
from repro import configs as JC
from repro.launch import steps as JS
from repro.launch import train as JT
from repro.models.lm import build_model as jbuild
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.models.lm import LM as TLM
from test_torch_train import (_batch, _leaves_with_paths, _models,
                              _reference_value_and_grad, _torch_batch)
import torch_port  # noqa: F401


#: the one-step test's constant rate: an update (about ``LR`` a weight)
#: far above the tolerances, so that a missing or wrong-signed update fails
LR = 1e-2
#: gradient elements below this share of their leaf's largest magnitude
#: are left out of the step's comparison: the gradients themselves are held
#: only to 1e-4 of that magnitude (test_torch_train.py), and Adam's first
#: step moves a weight by about ``LR * sign(g)``, so an element whose two
#: float32 gradients round to opposite signs moves the other way
SIGN_FLOOR = 1e-4
#: the step's change of a weight is held to the reference's within this:
#: 1e-3 of the update; Adam's ``g / (|g| + eps)`` passes on a share
#: ``eps / |g|`` of the gradient's own relative error
STEP_ATOL = 1e-5


@pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-26b"])
def test_one_train_step_matches_reference(arch):
    """One step with each side's default optimizer at the constant rate
    ``LR``: the step's change of every weight (``p_new - p_old``, larger
    than ``10 * STEP_ATOL`` where the gradient is not 0) within ``STEP_ATOL`` of the reference's,
    leaving out the elements whose
    gradient is below ``SIGN_FLOOR`` of its leaf's largest magnitude (a
    zero gradient, on both sides, is kept; under 1% of the elements are
    left out); the first moment within 1e-4 and the second within 2e-4 of
    its leaf's largest magnitude (the gradients' tolerance, once and twice)."""
    jm, tree, tm, tp = _models(arch)
    batch = _batch(tm.cfg)
    jopt = dataclasses.replace(JS.default_optimizer(10), lr=lambda s: LR)
    topt = dataclasses.replace(TS.default_optimizer(10), lr=lambda s: LR)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    jp, jstate, jmet = JS.make_train_step(jm, jopt)(
        jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tp2, tstate, tmet = TS.make_train_step(tm, topt)(
        tp, topt.init(tp), _torch_batch(batch))
    assert abs(tmet["loss"].item() - float(jmet["loss"])) <= 1e-5 * abs(
        float(jmet["loss"]))
    assert abs(tmet["grad_norm"].item() - float(jmet["grad_norm"])) <= (
        1e-5 * float(jmet["grad_norm"]))
    assert int(tstate["step"]) == int(jstate["step"]) == 1

    def port_layout(tree):
        return _leaves_with_paths(tm.from_jax_params(
            jax.tree.map(np.asarray, tree), device="cpu"))

    _, jgrads = _reference_value_and_grad(jm, tree, batch)
    _, tgrads = TS.value_and_grad(tm, tp, _torch_batch(batch))
    want_g, got_g = port_layout(jgrads), _leaves_with_paths(tgrads)
    p0, want_p, got_p = (_leaves_with_paths(tp), port_layout(jp),
                         _leaves_with_paths(tp2))
    dropped = total = 0
    for k, g in want_g.items():
        g = g.numpy()
        keep = (np.abs(g) >= SIGN_FLOOR * np.abs(g).max()) | (
            (g == 0) & (got_g[k].numpy() == 0))
        dropped += int((~keep).sum())
        total += g.size
        want_d = (want_p[k] - p0[k]).numpy()
        got_d = (got_p[k] - p0[k]).numpy()
        moved = keep & (g != 0)   # a zero gradient's weight only decays
        assert np.abs(want_d[moved]).min() > 10 * STEP_ATOL, k
        np.testing.assert_allclose(got_d[keep], want_d[keep], rtol=0,
                                   atol=STEP_ATOL, err_msg=k)
    assert dropped <= 0.01 * total, (dropped, total)
    for name, tol in (("m", 1e-4), ("v", 2e-4)):
        want = port_layout(jstate[name])
        for k, w in want.items():
            w = w.numpy()
            err = np.abs(_leaves_with_paths(tstate[name])[k].numpy() - w)
            assert err.max() <= tol * np.abs(w).max(), (name, k)
    # the inputs are left as they were (the update is functional)
    for k, w in _leaves_with_paths(tm.from_jax_params(
            tree, device="cpu")).items():
        assert torch.equal(p0[k], w), k


def _reference_init(monkeypatch, arch):
    """The port's ``LM.init_params`` replaced by the reference's weights
    for the same seed, so that both training loops start alike."""
    jm = jbuild(JC.get_reduced_config(arch))

    def init_params(self, seed=0, device="cuda"):
        params, _ = jm.init_params(jax.random.key(seed))
        return self.from_jax_params(jax.tree.map(np.asarray, params),
                                    device=device)
    monkeypatch.setattr(TLM, "init_params", init_params)


def test_train_main_logs_the_reference_losses(monkeypatch):
    argv = ["--arch", "smollm-135m", "--reduced", "--steps", "12",
            "--batch", "4", "--seq", "16", "--lr", "1e-2",
            "--log-every", "3", "--ckpt-every", "0"]
    want = JT.main(argv)["losses"]
    _reference_init(monkeypatch, "smollm-135m")
    got = TT.main(argv + ["--device", "cpu"])["losses"]
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 3, 6, 9, 11]
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 1e-4 * abs(w), (got, want)
    assert got[-1][1] < got[0][1]


def test_crash_resume_is_bitwise_identical(tmp_path, capsys):
    common = ["--arch", "smollm-135m", "--reduced", "--batch", "4",
              "--seq", "16", "--lr", "1e-3", "--log-every", "1",
              "--device", "cpu", "--steps", "20", "--ckpt-every", "10"]
    ck1, ck2 = str(tmp_path / "crash"), str(tmp_path / "clean")
    with pytest.raises(SystemExit) as exc:
        TT.main(common + ["--ckpt-dir", ck1, "--fail-at", "13"])
    assert exc.value.code == 42
    resumed = TT.main(common + ["--ckpt-dir", ck1])
    assert "resumed from step 10" in capsys.readouterr().out
    clean = TT.main(common + ["--ckpt-dir", ck2])
    got, want = (_leaves_with_paths(o["params"]) for o in (resumed, clean))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert resumed["losses"][-1] == clean["losses"][-1]


@pytest.mark.parametrize("preset", [None, ":16:8"])
def test_deterministic_setup_is_restored(monkeypatch, preset):
    """``train.deterministic`` on a CUDA device turns deterministic
    algorithms on with the cuBLAS workspace they ask for (a preset value
    kept), and leaves both as they were; on the CPU it changes neither."""
    if preset is None:
        monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    else:
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", preset)
    was = torch.are_deterministic_algorithms_enabled()
    with TT.deterministic("cpu"):
        assert torch.are_deterministic_algorithms_enabled() == was
        assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == preset
    with TT.deterministic("cuda"):
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == (preset
                                                         or ":4096:8")
    assert torch.are_deterministic_algorithms_enabled() == was
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == preset
