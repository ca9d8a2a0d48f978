"""The port's examples (``examples/torch_*.py``), each run as a user
would, with ``--device cpu`` at a reduced size: the kernels' plain
versions stand in for the card's.  Without a card and without
``--device cpu`` each raises, never falling back."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch_port  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

CASES = {
    "torch_quickstart.py": ([], "quickstart ok on cpu"),
    "torch_fusion_megakernels.py": ([], "megakernels ok on cpu"),
    "torch_serve_lm.py": (["--reduced", "--n-layers", "2",
                           "--n-requests", "6"], "requests=6/6"),
    "torch_train_lm.py": (["--steps", "3"], "over 3 steps"),
}


def _run(name, argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_KERNEL_CACHE=str(tmp_path / "cache"),
               TMPDIR=str(tmp_path))
    return subprocess.run([sys.executable, str(ROOT / "examples" / name),
                           *argv], capture_output=True, text=True,
                          timeout=600, cwd=ROOT, env=env)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    argv, marker = CASES[name]
    out = _run(name, ["--device", "cpu", *argv], tmp_path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert marker in out.stdout
    # the training example asserts its loss fell; its checkpoints went to
    # a temporary directory it removed
    assert not list(tmp_path.glob("torch_train_lm-*"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_without_a_card_raises(name, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    out = _run(name, [], tmp_path)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
