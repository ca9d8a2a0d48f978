"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and not the port's examples (``examples/torch_*.py``)
imports ``jax`` or anything of the JAX package ``repro`` (the machine
with the card has no JAX)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch_port  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _examples():
    return sorted((ROOT / "examples").glob("torch_*.py"))


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + _examples())


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {name}")


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}, "
        f"{str(ROOT / 'examples')!r}]\n"
        f"for m in {_modules()!r} + ['chip_smoke'] + "
        f"{[p.stem for p in _examples()]!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT / "tests")
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_boundary_covers_the_hand_kernel_path():
    """The module list is discovered, so it takes in the hand-written
    kernels' API and the encoder-decoder."""
    mods = _modules()
    for m in ("repro_torch.kernels.ops", "repro_torch.kernels.ref",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.rmsnorm_swiglu",
              "repro_torch.kernels.layernorm_matmul",
              "repro_torch.models.encdec", "repro_torch.configs.whisper_tiny"):
        assert m in mods, m


def test_boundary_covers_the_dense_and_moe_zoo():
    """The new configurations and the MoE layer are among the modules
    whose import must leave JAX out, and they import nothing of it."""
    mods = _modules()
    for m in ("repro_torch.configs.llama3_2_1b", "repro_torch.configs.qwen2_7b",
              "repro_torch.configs.qwen3_32b",
              "repro_torch.configs.qwen3_moe_30b_a3b",
              "repro_torch.models.layers", "repro_torch.models.lm"):
        assert m in mods, m
    from repro_torch.models import layers
    assert callable(layers.moe_apply) and callable(layers.moe_ref)


def test_boundary_covers_the_compile_driver():
    """The compile driver's modules (options, the on-disk cache, timing)
    are among the modules whose import must leave JAX out."""
    mods = _modules()
    for m in ("repro_torch.pipeline.options", "repro_torch.pipeline.cache",
              "repro_torch.pipeline.driver", "repro_torch.core.timing"):
        assert m in mods, m
    from repro_torch import pipeline
    for name in ("KernelCache", "CacheStats", "default_cache",
                 "reset_default_cache", "CODEGEN_VERSION",
                 "AUTOTUNE_OBJECTIVES"):
        assert hasattr(pipeline, name), name


def test_resilience_layer_imports_no_jax():
    """``repro_torch.resilience`` keeps its own copy of the reference's
    jax-free module: importing it, and the driver and engine that use it,
    brings in neither ``jax`` nor ``repro``."""
    assert "repro_torch.resilience" in _modules()
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        "import repro_torch.resilience as RZ\n"
        "import repro_torch.pipeline.driver, repro_torch.launch.engine\n"
        "assert RZ.ENV_VAR == 'REPRO_TORCH_FAULT_PLAN'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT / "tests")
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_boundary_covers_the_training_path():
    """The training modules (data, optimizer, compression, checkpoints, the
    step functions, ``launch/train.py``) and the VLM config are among the
    modules whose import must leave JAX out; importing ``launch/train.py``
    and running its argument parser brings in neither ``jax`` nor
    ``repro``."""
    mods = _modules()
    for m in ("repro_torch.data.pipeline", "repro_torch.optim.adamw",
              "repro_torch.optim.compression",
              "repro_torch.checkpoint.manager", "repro_torch.launch.steps",
              "repro_torch.launch.train",
              "repro_torch.configs.internvl2_26b"):
        assert m in mods, m
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}]\n"
        "import repro_torch.launch.train as T\n"
        "import repro_torch.launch.steps, repro_torch.checkpoint\n"
        "import repro_torch.data, repro_torch.optim.compression\n"
        "args = T.parse_args(['--arch', 'internvl2-26b', '--n-layers',"
        " '2'])\n"
        "cfg = T.model_config(args, remat_policy='dots')\n"
        "assert cfg.family == 'vlm' and cfg.n_layers == 2, cfg\n"
        "assert args.device == 'cuda'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT / "tests")
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_boundary_covers_the_analysis_and_the_examples():
    """The dry-run, the hill-climb driver, the step analysis and the four
    examples are among the files whose imports must leave JAX out."""
    mods = _modules()
    for m in ("repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
              "repro_torch.runtime.op_analysis"):
        assert m in mods, m
    assert [p.name for p in _examples()] == [
        "torch_fusion_megakernels.py", "torch_quickstart.py",
        "torch_serve_lm.py", "torch_train_lm.py"]
