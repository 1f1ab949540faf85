"""Import hygiene of the PyTorch port: no module of
``xllm_service_tpu_torch`` and not ``chip_smoke.py`` imports JAX or
anything of the JAX package ``xllm_service_tpu`` (the port keeps its
own copies). Checked on the syntax tree, so imports inside functions
count too. Nor may a string of ``chip_smoke.py`` or
``tools/chip_phases.py`` name a module of the JAX package (a child's
``-m xllm_service_tpu....``): the card's run starts nothing of it."""

import ast
import re
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


PARALLEL_MODULES = ["parallel/mesh.py", "parallel/sharding.py",
                    "parallel/ring.py", "runtime/ranks.py"]


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_are_checked(module):
    """The mesh, the sharding rules, ring attention and the rank
    processes are on the checked list, and import neither JAX nor the
    JAX package."""
    path = ROOT / "xllm_service_tpu_torch" / module
    assert path in FILES
    assert list(_bad_imports(path)) == []


# A dotted module name under the JAX package: ``xllm_service_tpu`` then
# ``.``, not ``xllm_service_tpu_torch`` (the port) nor the path of the
# Pallas sources that ``chip_smoke.py`` reads as text.
_JAX_MODULE = re.compile(r"(?<![\w.])xllm_service_tpu\.\w")
CHIP_FILES = [ROOT / "chip_smoke.py", ROOT / "tools" / "chip_phases.py"]


def _jax_module_strings(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _JAX_MODULE.search(node.value):
            yield node.lineno, node.value


@pytest.mark.parametrize("path", CHIP_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_chip_scripts_name_no_jax_module(path):
    assert list(_jax_module_strings(path)) == []


def test_checker_catches_a_planted_jax_module(tmp_path):
    """A child started as ``-m xllm_service_tpu.service.master`` (argv
    strings or the script's docstring) is caught; the port's modules and
    the Pallas sources' path are not."""
    bad = tmp_path / "chip_smoke.py"
    bad.write_text(
        '"""Starts ``python -m xllm_service_tpu.service.master``."""\n'
        'PALLAS = "xllm_service_tpu/ops/pallas"\n'
        'ok = ["xllm_service_tpu_torch.service.master", "--port", "0"]\n'
        'args = ["-m", "xllm_service_tpu.service.master", "--host", "h"]\n')
    assert [line for line, _ in _jax_module_strings(bad)] == [1, 4]
