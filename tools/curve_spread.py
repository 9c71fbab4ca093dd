"""Same-function spread of the plain ConvNet's loss curve on the CPU.

    JAX_PLATFORMS=cpu python tools/curve_spread.py [--steps 30]

The protocol of ``tests/test_torch_loss_curve.py`` (``parity_run.py``'s:
128x128 synthetic MNIST, batch 5, fp32, SGD at 1e-4, JAX's plain ConvNet
init from ``jax.random.key(0)`` carried over by the weight bridge), over
the tier-1 window. It prints, as JSON lines, the curve summaries (max abs,
max relative and mean abs deviation, ``curve_summary``) of

- the port's plain ConvNet against itself at torch thread counts 1, 2 and
  8 (the same function, summed in other orders);
- JAX's ConvNet against itself with XLA's CPU runtime on one thread
  (``--xla_cpu_multi_thread_eigen=false``, a second reduction order; run
  in a subprocess, since XLA reads its flags at start);
- JAX's ConvNetS2D against its ConvNet from the same init (the same
  function in a second JAX reduction order);
- each of those curves against JAX's default one, the bar of
  ``test_30_steps_follow_the_jax_curve[plain]``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
THREADS = (1, 2, 8)
ONE_THREAD_XLA = ("--xla_cpu_multi_thread_eigen=false "
                  "intra_op_parallelism_threads=1")


def _curves():
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import test_torch_loss_curve as lc
    return lc


def jax_losses(steps: int) -> list[float]:
    return [float(x) for x in _curves()._jax_run(steps, True)[0]]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--jax-only", action="store_true",
                        help="print this process's JAX curve and stop")
    args = parser.parse_args(argv)
    if args.jax_only:
        print(json.dumps(jax_losses(args.steps)))
        return
    import numpy as np
    import torch

    lc = _curves()
    want, variables, _ = lc._jax_run(args.steps, True)
    port = {}
    for n in THREADS:
        torch.set_num_threads(n)
        port[n] = lc._port_curve("plain", variables, args.steps, True)
    env = dict(os.environ, XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") + " "
                                      + ONE_THREAD_XLA).strip())
    out = subprocess.run(
        [sys.executable, __file__, "--jax-only", "--steps", str(args.steps)],
        env=env, capture_output=True, text=True, check=True).stdout
    jax_one = np.asarray(json.loads(out.strip().splitlines()[-1]))

    def row(what, got, ref):
        print(json.dumps({"what": what, "steps": args.steps,
                          **lc.curve_summary(got, ref)}))

    row("port plain, 2 threads vs 1", port[2], port[1])
    row("port plain, 8 threads vs 1", port[8], port[1])
    row("port plain, 8 threads vs 2", port[8], port[2])
    row("JAX ConvNet, one-thread XLA vs default", jax_one, want)
    row("JAX ConvNetS2D vs JAX ConvNet", lc._jax_run(args.steps, True,
                                                     s2d=True)[0], want)
    for n in THREADS:
        row(f"port plain, {n} threads vs JAX ConvNet", port[n], want)
    print(json.dumps({"what": "bar", "steps": args.steps,
                      **lc._record_summary(args.steps)}))


if __name__ == "__main__":
    main()
