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
        "import tpu_sandbox_torch.ops.bn_tail_t\n"
        "import tpu_sandbox_torch.ops.conv5_t\n"
        "import tpu_sandbox_torch.ops.conv1_tail_t\n"
        "import tpu_sandbox_torch.ops.conv, tpu_sandbox_torch.ops.bn_tail\n"
        "import tpu_sandbox_torch.models.convnet_s2d\n"
        "import tpu_sandbox_torch.ops.build, tpu_sandbox_torch.ops.losses\n"
        "import tpu_sandbox_torch.ops.ce, tpu_sandbox_torch.ops.attention\n"
        "import tpu_sandbox_torch.ops.flash_attention\n"
        "import tpu_sandbox_torch.models.transformer\n"
        "import tpu_sandbox_torch.train.optim, tpu_sandbox_torch.lm_train\n"
        "import tpu_sandbox_torch.train, tpu_sandbox_torch.utils\n"
        "import tpu_sandbox_torch.models.convnet\n"
        "import tpu_sandbox_torch.data.native_loader\n"
        "import tpu_sandbox_torch.native.build\n"
        "import tpu_sandbox_torch.utils.profiling\n"
        "import tpu_sandbox_torch.runtime.bootstrap\n"
        "import tpu_sandbox_torch.runtime.mesh\n"
        "import tpu_sandbox_torch.parallel.collectives\n"
        "import tpu_sandbox_torch.parallel.launch\n"
        "import tpu_sandbox_torch.parallel.data_parallel\n"
        "import tpu_sandbox_torch.parallel.buckets\n"
        "import tpu_sandbox_torch.utils.cli\n"
        "import tpu_sandbox_torch.parallel.ring_attention\n"
        "import tpu_sandbox_torch.parallel.ulysses\n"
        "import tpu_sandbox_torch.parallel.flash_ring\n"
        "import tpu_sandbox_torch.parallel.seq_parallel\n"
        "import tpu_sandbox_torch.parallel.pipeline\n"
        "import tpu_sandbox_torch.parallel.pjit_engine\n"
        "import tpu_sandbox_torch.parallel.expert\n"
        "import tpu_sandbox_torch.test_init\n"
        "import tpu_sandbox_torch.allreduce_toy\n"
        "import tpu_sandbox_torch.mnist_distributed\n"
        "import tpu_sandbox_torch.runtime.staging\n"
        "import tpu_sandbox_torch.runtime.kvstore\n"
        "import tpu_sandbox_torch.runtime.watchdog\n"
        "import tpu_sandbox_torch.runtime.faults\n"
        "import tpu_sandbox_torch.runtime.supervisor\n"
        "import tpu_sandbox_torch.obs, tpu_sandbox_torch.obs.record\n"
        "import tpu_sandbox_torch.train.checkpoint\n"
        "import tpu_sandbox_torch.obs.metrics, tpu_sandbox_torch.obs.tsdb\n"
        "import tpu_sandbox_torch.serve, tpu_sandbox_torch.serve.cache\n"
        "import tpu_sandbox_torch.serve.decode\n"
        "import tpu_sandbox_torch.serve.engine\n"
        "import tpu_sandbox_torch.serve.replica\n"
        "import tpu_sandbox_torch.serve.client\n"
        "import tpu_sandbox_torch.runtime.election\n"
        "import tpu_sandbox_torch.runtime.host_agent\n"
        "import tpu_sandbox_torch.runtime.scheduler\n"
        "import tpu_sandbox_torch.obs.health\n"
        "import tpu_sandbox_torch.serve.autoscale\n"
        "import tpu_sandbox_torch.gateway, tpu_sandbox_torch.gateway.fleet\n"
        "import tpu_sandbox_torch.gateway.wire\n"
        "import tpu_sandbox_torch.gateway.routing\n"
        "import tpu_sandbox_torch.gateway.server\n"
        "import tpu_sandbox_torch.gateway.client\n"
        "import tpu_sandbox_torch.gateway.__main__\n"
        "import tpu_sandbox_torch.deploy\n"
        "import tpu_sandbox_torch.deploy.registry\n"
        "import tpu_sandbox_torch.deploy.controller\n"
        "import tpu_sandbox_torch.obs.collect\n"
        "import tpu_sandbox_torch.obs.critpath\n"
        "import tpu_sandbox_torch.obs.workload\n"
        "import tpu_sandbox_torch.runtime.chaos\n"
        "import tpu_sandbox_torch.tools, tpu_sandbox_torch.tools.tracecat\n"
        "import tpu_sandbox_torch.tools.tracediff\n"
        "import tpu_sandbox_torch.tools.fleetop\n"
        "import tpu_sandbox_torch.mpmd, tpu_sandbox_torch.mpmd.transport\n"
        "import tpu_sandbox_torch.mpmd.schedule\n"
        "import tpu_sandbox_torch.mpmd.program\n"
        "import tpu_sandbox_torch.mpmd.driver\n"
        "import tpu_sandbox_torch.mpmd.worker\n"
        "import tpu_sandbox_torch.serve.disagg\n"
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
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "tests" / "torch_dist_workers.py"]


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


def test_native_build_reads_the_ports_own_source():
    """The port's C++ loader builds from its own copy of the source under
    tpu_sandbox_torch/native/src/ into the port's _build/, and its build
    script names no path of the JAX package."""
    from tpu_sandbox_torch.native import build

    assert build.SRC == ROOT / "tpu_sandbox_torch" / "native" / "src"
    assert build.BUILD == ROOT / "tpu_sandbox_torch" / "_build"
    for name in ("dataloader", "kvstore"):
        assert (build.SRC / f"{name}.cpp").is_file()
        assert build.target(name).parent == build.BUILD
    for path in (ROOT / "tpu_sandbox_torch" / "native").rglob("*"):
        if path.is_file() and path.suffix in (".py", ".cpp"):
            text = path.read_text()
            assert "tpu_sandbox/" not in text, path
            assert "tpu_sandbox." not in text, path
