"""Hygiene of the PyTorch port: it imports neither JAX nor the JAX package,
nor any third-party package the H100 machine lacks (an optional storage
driver only inside the function that needs it, failing loudly when it is
missing); its entry points never drop to the CPU on their own, and its
kernel wrappers have no fallback that hides a failed build or launch."""

import ast
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "smg_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "smg_tpu")
# third-party packages the port may import: each imports on the H100
# machine (checked there by importing it).  Packages that machine lacks,
# such as orjson, must stay out of the serving path.  safetensors (the
# checkpoint and PEFT loaders), tokenizers and jinja2 (the HF tokenizer and
# its chat templates), regex (the tiktoken pre-tokenizer), PIL (image
# decoding, PIL 12.2.0), grpc and google.protobuf (the gRPC worker, grpc
# 1.80.0 and protobuf 6.33.6) import there.
CARD_PACKAGES = ("torch", "numpy", "aiohttp", "prometheus_client", "pydantic",
                 "safetensors", "tokenizers", "jinja2", "regex", "PIL", "grpc",
                 "google.protobuf")
# drivers a deployment installs only for the storage backend it picks, which
# the card does not have: each may be imported only inside a function body,
# in a ``try`` whose ``except ImportError`` raises (``connect_oracle``)
OPTIONAL_DRIVERS = ("oracledb",)


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


def _is_driver(module: str) -> bool:
    return any(module == d or module.startswith(d + ".") for d in OPTIONAL_DRIVERS)


def _misplaced_driver_imports(tree: ast.AST) -> list:
    """Line numbers of imports of an ``OPTIONAL_DRIVERS`` package that are
    not inside a function body, in the body of a ``try`` with an ``except
    ImportError`` handler that raises."""
    bad = []

    def raises_on_import_error(try_node: ast.Try) -> bool:
        for h in try_node.handlers:
            names = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
            if (any(isinstance(n, ast.Name) and n.id in ("ImportError", "ModuleNotFoundError")
                    for n in names)
                    and any(isinstance(s, ast.Raise) for s in ast.walk(h))):
                return True
        return False

    def visit(node, in_function: bool, guard: "ast.Try | None"):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if node.level == 0 else [])
            if any(_is_driver(m) for m in mods) and not (
                    in_function and guard is not None and raises_on_import_error(guard)):
                bad.append(node.lineno)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            in_function, guard = True, None  # the body runs later, unguarded
        if isinstance(node, ast.Try):
            for stmt in node.body:
                visit(stmt, in_function, node)
            for part in (*node.handlers, *node.orelse, *node.finalbody):
                visit(part, in_function, None)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, in_function, guard)

    visit(tree, False, None)
    return sorted(bad)


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


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_only_packages_the_card_has(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted({m for m in _imported_modules(tree)
                  if m.split(".")[0] not in sys.stdlib_module_names
                  and m.split(".")[0] != "smg_tpu_torch"
                  and not _is_driver(m)
                  and not any(m == p or m.startswith(p + ".") for p in CARD_PACKAGES)})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}, not known on the card"
    lines = _misplaced_driver_imports(tree)
    assert not lines, (f"{path.relative_to(REPO)} imports an optional driver at lines "
                       f"{lines} outside a function's try whose except ImportError raises")


@pytest.mark.parametrize("source,bad", [
    ("import oracledb\n", [1]),
    ("from oracledb import connect\n", [1]),
    ("try:\n    import oracledb\nexcept ImportError as e:\n    raise RuntimeError() from e\n",
     [2]),
    ("def f():\n    import oracledb\n", [2]),
    ("def f():\n    try:\n        import oracledb\n    except ImportError:\n"
     "        oracledb = None\n", [3]),
    ("def f():\n    try:\n        pass\n    except ImportError:\n        import oracledb\n"
     "        raise\n", [5]),
    ("def f():\n    try:\n        import oracledb\n    except ImportError as e:\n"
     "        raise RuntimeError('needs oracledb') from e\n", []),
], ids=["module-level", "module-level-from", "module-level-try", "function-no-try",
        "except-swallows", "import-in-handler", "allowed"])
def test_optional_driver_only_in_a_raising_try_inside_a_function(source, bad):
    assert _misplaced_driver_imports(ast.parse(source)) == bad


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
    from smg_tpu_torch.train.step import make_train_step

    for build in (lambda: ModelRunner(_tiny_config()), lambda: Engine(_tiny_config()),
                  lambda: make_train_step(_tiny_config().model)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # an explicit CPU request is honoured
    assert ModelRunner(_tiny_config(), device="cpu").k_cache.device.type == "cpu"


def test_serve_defaults_to_cuda_and_refuses_the_cpu(no_cuda):
    from smg_tpu_torch.cli import build_parser
    from smg_tpu_torch.gateway.launch import build_engine_from_args

    args = build_parser().parse_args(["serve", "--model-preset", "tiny"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine_from_args(args)


@pytest.mark.parametrize("name", ["decode_attention.py", "prefill_attention.py", "build.py"])
def test_kernel_wrappers_have_no_silent_fallback(name):
    """No try/except around build or launch: a CUDA tensor launches the
    kernel or raises."""
    tree = ast.parse((PORT / "ops" / "cuda" / name).read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, (ast.Try, ast.ExceptHandler))]
    assert not handlers, f"{name} has a try/except at line {handlers[0].lineno}"
