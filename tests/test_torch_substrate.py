"""The port's training substrate against the JAX reference: the step-keyed
data pipeline, the optimizer, int8 compression and checkpoints.

* ``SyntheticLMData``'s tokens and labels are the reference's bit for bit
  (values and int32), step-keyed, and ``host_slice`` partitions a batch;
* ``cosine_schedule`` and ``global_norm`` match the reference (1e-6
  relative); ``AdamW.update`` on equal gradients follows the reference's
  parameters and moments over steps with clipping and weight decay
  (1e-6), reduces the reference's quadratic, reports the unclipped norm,
  keeps float32 moments for a bfloat16 parameter and leaves its inputs
  untouched;
* ``quantize_int8`` gives the reference's codes and scale, and the round
  trip its error (1e-6);
* ``CheckpointManager`` round-trips float32, bfloat16 (bit for bit) and
  integer leaves, keeps the last ``keep``, saves asynchronously until
  ``wait``, never publishes a ``tmp.`` directory, and a save followed by
  an update in place leaves the saved step as it was.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_cpu import reference_on_cpu  # noqa: F401
from repro.data import SyntheticLMData as JData
from repro.optim import AdamW as JAdamW, cosine_schedule as jcosine
from repro.optim import adamw as JA
from repro.optim import compression as JZ
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMData
from repro_torch.optim import AdamW, cosine_schedule, global_norm
from repro_torch.optim import compression as TZ
import torch_port  # noqa: F401


@pytest.mark.parametrize("vocab,seq,batch,seed", [(100, 16, 4, 7),
                                                  (49152, 64, 8, 0),
                                                  (512, 33, 3, 123)])
def test_data_is_the_references_bit_for_bit(vocab, seq, batch, seed):
    ours = SyntheticLMData(vocab, seq, batch, seed=seed)
    ref = JData(vocab, seq, batch, seed=seed)
    for step in (0, 1, 13, 1000):
        got, want = ours.batch(step, device="cpu"), ref.batch(step)
        for k in ("tokens", "labels"):
            w = np.asarray(want[k])
            assert got[k].dtype == torch.int32 and w.dtype == np.int32
            np.testing.assert_array_equal(got[k].numpy(), w)


def test_data_is_step_keyed_and_labels_shift_by_one():
    d = SyntheticLMData(vocab=100, seq_len=16, global_batch=4, seed=7)
    b1, b2 = d.batch(3, device="cpu"), d.batch(3, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(d.batch(4, device="cpu")["tokens"],
                           b1["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_host_slices_partition_the_batch():
    d = SyntheticLMData(vocab=100, seq_len=8, global_batch=8, seed=0)
    ref = JData(vocab=100, seq_len=8, global_batch=8, seed=0)
    full = d.batch(0, device="cpu")
    parts = [d.host_slice(0, i, 4, device="cpu") for i in range(4)]
    for k in ("tokens", "labels"):
        assert torch.equal(torch.cat([p[k] for p in parts]), full[k])
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(
            p["tokens"].numpy(), np.asarray(ref.host_slice(0, i, 4)["tokens"]))


def test_cosine_schedule_matches_reference():
    for peak, warmup, total in ((3e-4, 200, 10000), (1e-2, 20, 60),
                                (1e-3, 0, 10)):
        ours, ref = cosine_schedule(peak, warmup, total), jcosine(
            peak, warmup, total)
        for step in (0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                     total - 1, total, total + 50):
            got = ours(torch.tensor(step, dtype=torch.int32)).item()
            want = float(ref(jnp.asarray(step, jnp.int32)))
            assert abs(got - want) <= 1e-6 * abs(want), (step, got, want)


def _trees(seed):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(5, 7)), "layers": [
        {"a": rng.normal(size=(3,)), "b": rng.normal(size=(2, 2)) * 30}
        for _ in range(2)]}
    to_np = jax.tree.map(lambda a: a.astype(np.float32), tree)
    to_t = jax.tree.map(torch.from_numpy, to_np)
    return to_np, to_t


def test_global_norm_matches_reference():
    np_tree, t_tree = _trees(0)
    want = float(JA.global_norm(jax.tree.map(jnp.asarray, np_tree)))
    assert abs(global_norm(t_tree).item() - want) <= 1e-6 * want


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_update_follows_reference_on_equal_gradients(clip_norm):
    """Five steps on the same gradients: clipped (norm ~50 against 1) or
    not, with weight decay and the warmup and cosine of the schedule."""
    np_p, t_p = _trees(1)
    ours = AdamW(lr=cosine_schedule(1e-2, 2, 6), clip_norm=clip_norm)
    ref = JAdamW(lr=jcosine(1e-2, 2, 6), clip_norm=clip_norm)
    j_p = jax.tree.map(jnp.asarray, np_p)
    j_s, t_s = ref.init(j_p), ours.init(t_p)
    for step in range(5):
        np_g, t_g = _trees(10 + step)
        j_p, j_s, j_m = ref.update(jax.tree.map(jnp.asarray, np_g), j_s, j_p)
        t_p, t_s, t_m = ours.update(t_g, t_s, t_p)
        for got, want in ((t_p, j_p), (t_s["m"], j_s["m"]),
                          (t_s["v"], j_s["v"])):
            for g, w in zip(jax.tree.leaves(jax.tree.map(
                    lambda t: t.numpy(), got)), jax.tree.leaves(want)):
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6,
                                           atol=1e-6)
        assert int(t_s["step"]) == int(j_s["step"]) == step + 1
        for k in ("grad_norm", "lr"):
            assert abs(float(t_m[k]) - float(j_m[k])) <= 1e-6 * abs(
                float(j_m[k]))


def test_adamw_reduces_loss_on_quadratic():
    opt = AdamW(lr=cosine_schedule(0.1, 5, 100), weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    l0 = float((params["w"] ** 2).sum())
    for _ in range(60):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert float((params["w"] ** 2).sum()) < 0.05 * l0


def test_adamw_clips_and_reports_the_unclipped_norm():
    opt = AdamW(lr=lambda s: 0.0, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    grads = {"w": torch.tensor([1e6, 1e6, 1e6])}
    _, state, metrics = opt.update(grads, state, params)
    assert float(metrics["grad_norm"]) > 1e5
    # the first moment saw the clipped gradient: norm 1 over 3 equal parts
    torch.testing.assert_close(state["m"]["w"],
                               torch.full((3,), 0.1 / 3 ** 0.5))


def test_adamw_keeps_dtypes_and_leaves_inputs_untouched():
    opt = AdamW(lr=lambda s: 1e-2)
    params = {"w": torch.randn(4, 4).to(torch.bfloat16),
              "b": torch.randn(4)}
    before = {k: v.clone() for k, v in params.items()}
    state = opt.init(params)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    new, state2, _ = opt.update(grads, state, params)
    assert new["w"].dtype == torch.bfloat16 and new["b"].dtype == torch.float32
    assert state2["m"]["w"].dtype == state2["v"]["w"].dtype == torch.float32
    for k in params:
        assert torch.equal(params[k], before[k])
        assert not torch.equal(new[k], before[k])
    assert int(state["step"]) == 0 and int(state2["step"]) == 1


@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((64, 48), 1e-3),
                                         ((5, 6, 7), 40.0)])
def test_int8_roundtrip_matches_reference(shape, scale):
    x = (np.random.default_rng(len(shape)).normal(size=shape)
         * scale).astype(np.float32)
    jq, js = JZ.quantize_int8(jnp.asarray(x))
    tq, ts = TZ.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert abs(ts.item() - float(js)) <= 1e-6 * float(js)
    np.testing.assert_allclose(TZ.dequantize_int8(tq, ts).numpy(),
                               np.asarray(JZ.dequantize_int8(jq, js)),
                               rtol=1e-6, atol=1e-9)
    want = JZ.compress_roundtrip_error(jnp.asarray(x))
    got = TZ.compress_roundtrip_error(torch.from_numpy(x))
    assert abs(got - want) <= 1e-6 * want and got < 0.01


def _state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "layers": [{"g": torch.randn(5).to(torch.bfloat16)}]},
            "opt": {"step": torch.tensor(5, dtype=torch.int32)},
            "step": torch.tensor(5)}


def test_checkpoint_roundtrip_float32_bfloat16_and_int(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    mgr.save(5, state, blocking=True)
    assert mgr.latest_step() == 5
    got = mgr.restore(device="cpu")
    for path, want in (("w", state["params"]["w"]),):
        assert torch.equal(got["params"][path], want)
    g, w = got["params"]["layers"][0]["g"], state["params"]["layers"][0]["g"]
    assert g.dtype == torch.bfloat16
    assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 5 and int(got["step"]) == 5


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.tensor(s)}, blocking=True)
    assert mgr.steps() == [2, 3]
    assert int(mgr.restore(device="cpu")["x"]) == 3
    assert int(mgr.restore(2, device="cpu")["x"]) == 2


def test_checkpoint_async_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones((128, 128))})
    mgr.wait()
    assert mgr.latest_step() == 1
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp.")]


def test_checkpoint_tmp_dirs_are_not_published(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "tmp.step_9")   # a crash mid-save
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(device="cpu")


def test_save_then_update_in_place_leaves_the_saved_step(tmp_path):
    """``t.cpu()`` of a CPU tensor is the tensor itself: the save copies
    each leaf before its thread starts, so an optimizer step in place right
    after ``save`` returns cannot reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.randn(256, 256)
    want = w.clone()
    mgr.save(1, {"w": w})
    w.mul_(0.0).add_(7.0)
    mgr.wait()
    assert torch.equal(mgr.restore(device="cpu")["w"], want)


def test_a_failed_write_raises_at_wait(tmp_path):
    """An error on the writing thread reaches the caller at ``wait``, and
    nothing is published."""
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "tmp.step_2").write_text("")   # a file where a dir goes
    mgr.save(2, {"x": torch.ones(3)})
    with pytest.raises(OSError):
        mgr.wait()
    assert mgr.latest_step() is None
    mgr.wait()                                  # the error is reported once
