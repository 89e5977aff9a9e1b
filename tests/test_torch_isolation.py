"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, nothing builds on import, and asking for
the card where there is none raises instead of running on the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported_roots(path: Path):
    """Top-level module names a file imports, statically or through
    ``importlib.import_module`` / ``__import__`` with a literal name."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Attribute)
                    and node.func.attr == "import_module")
                   or (isinstance(node.func, ast.Name)
                       and node.func.id == "__import__"))):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_scan_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import importlib\nfrom repro.core import early_exit\n"
                 "importlib.import_module('jax.numpy')\n")
    assert {"repro", "jax"} <= set(_imported_roots(p))


def test_import_builds_nothing():
    code = ("import pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    __import__(m.name)\n"
            "import sys\n"
            "from repro_torch.kernels import _build\n"
            "assert _build._lib is None\n"
            "assert not any(n.split('.')[0] in ('jax', 'repro') "
            "for n in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _run_smoke(script: Path, cwd: Path):
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    res = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repository,
    the script exits non-zero with no result, card or not."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch import resolve_device
    from repro_torch.launch import serve as serve_cli
    from repro_torch.runtime import serve_api
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_api.build({}, None, None, None, mode="prefill")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_cli.main(["--smoke"])
    assert resolve_device("cpu") == torch.device("cpu")
