"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_port_forward_loads_no_jax():
    code = (
        "import sys\n"
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.reduce import reduced\n"
        "from repro_torch.core.spec import QuantSpec\n"
        "from repro_torch.launch import serve\n"
        "assert serve.main(['--arch', 'h2o-danube-1.8b', '--reduced',\n"
        "    '--batch', '1', '--prompt-len', '8', '--gen', '2',\n"
        "    '--device', 'cpu', '--pack4']) == 0\n"
        "import repro_torch.interop\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
