"""The port stands alone: importing tpu_sandbox_torch and its entry module
pulls in neither jax nor the JAX package, and no file of the port (nor
chip_smoke.py) names either in an import."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpu_sandbox")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax_and_no_jax_package():
    code = (
        "import sys\n"
        "import tpu_sandbox_torch, tpu_sandbox_torch.mnist_onegpu\n"
        "import tpu_sandbox_torch.data, tpu_sandbox_torch.models\n"
        "import tpu_sandbox_torch.ops.conv_t, tpu_sandbox_torch.ops.fc_t\n"
        "import tpu_sandbox_torch.ops.build, tpu_sandbox_torch.ops.losses\n"
        "import tpu_sandbox_torch.train, tpu_sandbox_torch.utils\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(','.join(sorted(bad)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"loaded: {proc.stdout.strip()}"


def _port_files():
    files = sorted((ROOT / "tpu_sandbox_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_imports_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"
