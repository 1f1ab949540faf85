"""Import hygiene of the PyTorch port: no module of
``xllm_service_tpu_torch`` and not ``chip_smoke.py`` imports JAX or
anything of the JAX package ``xllm_service_tpu`` (the port keeps its
own copies). Checked on the syntax tree, so imports inside functions
count too."""

import ast
from pathlib import Path

import pytest
from tests.test_torch_locks import _no_swallowed_port_lock_violations  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "xllm_service_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _bad_imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if (name == "jax" or name.startswith("jax.")
                    or name == "xllm_service_tpu"
                    or name.startswith("xllm_service_tpu.")):
                yield node.lineno, name


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert path.exists()
    assert list(_bad_imports(path)) == []


def test_checker_catches_jax_imports(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\n"
                   "def f():\n    from xllm_service_tpu.ops import norm\n"
                   "from xllm_service_tpu_torch.ops import norm\n")
    assert [n for _, n in _bad_imports(bad)] == [
        "jax.numpy", "xllm_service_tpu.ops"]


def test_every_subpackage_is_checked():
    """The walk reaches every subpackage of the port, ``parallel/``
    (the MoE dispatch) included."""
    pkg = ROOT / "xllm_service_tpu_torch"
    subpackages = {p.parent.relative_to(pkg).as_posix()
                   for p in pkg.rglob("__init__.py")}
    checked = {p.parent.relative_to(pkg).as_posix() for p in FILES[:-1]}
    assert "parallel" in subpackages
    assert subpackages <= checked
    assert pkg / "parallel" / "expert.py" in FILES
