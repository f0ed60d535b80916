"""Hygiene of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points never drop to the CPU on their own, and its kernel
wrappers have no fallback that hides a failed build or launch."""

import ast
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "smg_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "smg_tpu")


def _sources():
    # _build/ holds generated outputs (git-ignored), not the package's code
    ported = (p for p in PORT.rglob("*.py") if "_build" not in p.relative_to(PORT).parts)
    return sorted(ported) + [REPO / "chip_smoke.py"]


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    # match the module and its submodules exactly: smg_tpu_torch is allowed
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_prefix_match_is_exact():
    assert _forbidden("smg_tpu") and _forbidden("smg_tpu.ops.attention")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("smg_tpu_torch") and not _forbidden("smg_tpu_torch.ops")
    assert not _forbidden("jaxtyping_like")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the default on a machine without a CUDA device")


def _tiny_config():
    from smg_tpu_torch.engine.config import CacheConfig, EngineConfig, SchedulerConfig
    from smg_tpu_torch.models.config import tiny_test_config

    return EngineConfig(
        model=tiny_test_config(),
        cache=CacheConfig(num_pages=16, auto_size=False, dtype="float32"),
        scheduler=SchedulerConfig(max_batch_size=2, max_seq_len=64, max_prefill_tokens=32),
    )


def test_engine_defaults_to_cuda_and_refuses_the_cpu(no_cuda):
    from smg_tpu_torch.engine.engine import Engine
    from smg_tpu_torch.engine.runner import ModelRunner

    for build in (lambda: ModelRunner(_tiny_config()), lambda: Engine(_tiny_config())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # an explicit CPU request is honoured
    assert ModelRunner(_tiny_config(), device="cpu").k_cache.device.type == "cpu"


@pytest.mark.parametrize("name", ["decode_attention.py", "prefill_attention.py", "build.py"])
def test_kernel_wrappers_have_no_silent_fallback(name):
    """No try/except around build or launch: a CUDA tensor launches the
    kernel or raises."""
    tree = ast.parse((PORT / "ops" / "cuda" / name).read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, (ast.Try, ast.ExceptHandler))]
    assert not handlers, f"{name} has a try/except at line {handlers[0].lineno}"
