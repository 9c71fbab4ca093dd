"""The compiler-driven engine's image phases of ``chip_smoke.py`` alone, and
where their steps go, on one CUDA card.

    python tools/pjit_step_profile.py             # the phases
    python tools/pjit_step_profile.py --profile   # torch.profiler tables

Without ``--profile``: builds the kernels, runs the three ``PATHS`` phases
that ``PJIT_PATHS`` are held against (``main_path``, ``path_s2d``,
``path_plain``), then ``phase_path_pjit`` for each, and prints their JSON
lines and the phases' seconds, as the whole script would. With
``--profile``: for the plain plan and the card's default plan, one step
of the Trainer's ``make_train_step`` and one of ``PjitEngine`` (the
phases' meshes, rules and input specs, TrainState's SGD), each after two
warm-up steps, under ``torch.profiler``: the step's wall ms and the ops
by device time. Run from the root of a checkout.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ROWS = 22


def run_phases(mnist_onegpu, ops, build) -> None:
    t0 = time.monotonic()
    smi = cs.phase_env(build)
    refs = {ref: {} for _, ref, *_ in cs.PJIT_PATHS}
    for phase, plan, options, steps, kinds in cs.PATHS:
        if phase not in refs:
            continue
        with cs.timed(phase):
            res, _, trainer = cs.phase_main_path(
                ops, mnist_onegpu, kinds, phase=phase, plan=plan,
                steps=steps, model_options=options,
                flags=cs.PATH_FLAGS.get(phase), keep=refs[phase])
            del trainer
            refs[phase].update(phase=phase, plan=plan, options=options,
                               kinds=kinds,
                               step_ms=res["step_ms_median_after_first"],
                               peak=res["peak_memory_bytes"])
            cs.emit(phase, **{k: res[k] for k in (
                "losses", "step_ms_median_after_first", "peak_memory_bytes")})
    for phase, ref, mesh, rules, spec in cs.PJIT_PATHS:
        with cs.timed(phase):
            res, _ = cs.phase_path_pjit(ops, mnist_onegpu, smi, phase,
                                        refs.pop(ref), mesh, rules, spec)
            cs.emit(phase, **res)
    cs.emit("seconds", phases=cs.SECONDS, total=time.monotonic() - t0)
    print(smi)


def _profile(name: str, step, batches) -> None:
    for x, y in batches[:2]:
        step(x, y)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(*batches[2])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    print(f"=== {name}: {dt * 1e3:.1f} ms", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=ROWS), flush=True)


def run_profiles(mnist_onegpu) -> None:
    from tpu_sandbox_torch.models import pick_convnet
    from tpu_sandbox_torch.parallel.pjit_engine import P, PjitEngine
    from tpu_sandbox_torch.runtime import bootstrap
    from tpu_sandbox_torch.runtime.mesh import make_mesh
    from tpu_sandbox_torch.train import TrainState, make_train_step
    from tpu_sandbox_torch.train.trainer import to_device

    shape = (cs.IMAGE, cs.IMAGE)
    batches = cs._onegpu_batches(mnist_onegpu, 3)
    cuda = torch.device("cuda")
    paths = {"plain": "path_pjit_plain_bn", "auto": "path_pjit_s2dt_bn"}
    for plan, phase in paths.items():
        _, _, mesh, rules, spec = next(p for p in cs.PJIT_PATHS
                                       if p[0] == phase)

        def model():
            return pick_convnet(shape, plan=plan, num_classes=10,
                                dtype=torch.bfloat16, seed=0, device=cuda)

        step = make_train_step(TrainState(model(), lr=1e-4),
                               image_size=shape)
        _profile(f"{plan} trainer", lambda x, y: float(
            step(*to_device(x, y, cuda))), batches)
        del step
        torch.cuda.empty_cache()
        bootstrap.init(device="cuda")
        try:
            eng = PjitEngine(model(), lambda params: None, make_mesh(mesh),
                             rules=[(r, P(*a)) for r, a in rules],
                             input_spec=P(*spec), image_size=shape)
            state = eng.shard_state()
            _profile(f"{plan} engine", lambda x, y: float(eng.train_step(
                state, *eng.shard_batch(x, y))), batches)
        finally:
            bootstrap.cleanup()
        del eng, state
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile one Trainer and one engine step")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("pjit_step_profile: no CUDA device", file=sys.stderr)
        return 1
    from tpu_sandbox_torch import mnist_onegpu, ops
    from tpu_sandbox_torch.ops import build
    from tpu_sandbox_torch.utils import exact_fp32

    exact_fp32()
    if args.profile:
        run_profiles(mnist_onegpu)
    else:
        run_phases(mnist_onegpu, ops, build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
