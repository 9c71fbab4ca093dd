"""Smoke run of the PyTorch/CUDA port (tpu_sandbox_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card, nvcc
and nvidia-smi. It exits non-zero, printing no result, when there is no
card or when the port is not beside it. Phases, one JSON line each:

1. env: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the build of every kernel in tpu_sandbox_torch/csrc/.
2. kernel: each kernel launch of the main path, at the main path's
   shapes (3000x3000 images, batch 5), against its plain PyTorch version
   on the same inputs: fp32 within 1e-4 of max|plain|, bf16 within 1e-2
   (one bf16 rounding on each side); its CUDA-event median time over 10
   runs after warm-up beside the plain version's, one PyTorch library
   call's (cuDNN conv / its gradients, einsum; timed here only, never
   called by the port) and the least time the H100 could take (bytes over
   3.35 TB/s or operations over 989 TFLOP/s bf16, whichever is larger).
   Plus a ragged-shape check of each kernel (W not a tile multiple).
3. main_path: tpu_sandbox_torch.mnist_onegpu's own train function at
   3000x3000, batch 5, bf16, synthetic MNIST, 5 steps, with every kernel
   launch counter zeroed just before and read just after: each main-path
   launch must happen once per step. Step time (median after the first),
   images/s and peak device memory.
   Then profile: two more steps under torch.profiler, device time per
   op or kernel, busy time and idle share of the step.
4. card_vs_cpu: the port on the card against the port on the CPU, 64x64,
   fp32, 3 SGD steps from the same bridged weights on the same batches:
   losses within rtol 1e-4.
5. the {"kernels": [...]} summary, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

fp32 matmuls and convolutions run without TF32 throughout (the plain
versions are references).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

STEPS = 5
BATCH = 5
IMAGE = 3000
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL = {"fp32": 1e-4, "bf16": 1e-2}
CONV_SRC = "tpu_sandbox_torch/csrc/conv_t.cu"
FC_SRC = "tpu_sandbox_torch/csrc/fc_t.cu"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, bytes_: int) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, bytes_ / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def compare(got, want, dtype_name: str, what: str) -> dict:
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item() or 1.0
    finite = bool(torch.isfinite(got.float()).all().item())
    rel = err / scale
    require(finite, f"{what} {dtype_name}: non-finite output")
    require(rel <= TOL[dtype_name],
            f"{what} {dtype_name}: max abs err {err} = {rel:.3g} of "
            f"max|plain| {scale}, tolerance {TOL[dtype_name]}")
    return {"max_abs_err": err, "max_abs_ref": scale, "rel_err": rel,
            "tolerance": TOL[dtype_name]}


def phase_env(build) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    info = build.build_all()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         build_seconds=info["seconds"], built=info["built"],
         ptxas=info["ptxas"])
    return smi


def _conv_case(gen, n, h, c, w, co, dtype):
    dev = "cuda"
    x = torch.randn((n, h, c, w), generator=gen, device=dev).to(dtype)
    wt = (torch.randn((3, 3, c, co), generator=gen, device=dev)
          / math.sqrt(9 * c)).to(dtype)
    b = torch.randn((co,), generator=gen, device=dev).to(dtype)
    return x, wt, b


def phase_kernels(conv_t, fc_t) -> dict:
    """Every launch kind at its main-path shape; returns the summary
    entries keyed by launch-counter name."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w = BATCH, IMAGE // 4, IMAGE // 4
    entries = {}

    def record(name, source, replaces, rec, ms, plain_ms, library_ms, *,
               flops, bytes_):
        b_ms, b_by = bound(flops, bytes_)
        entries[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            max_abs_err=rec["bf16"]["max_abs_err"], ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            fp32_rel_err=rec["fp32"]["rel_err"],
            bf16_rel_err=rec["bf16"]["rel_err"])
        emit("kernel", **entries[name], checks=rec)

    def conv_fwd(c, co, kind):
        name = f"conv3x3_t {kind} C{c} CO{co}"
        rec = {}
        for dt_name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x, wt, b = _conv_case(gen, n, h, c, w, co, dt)
            if kind == "dgrad":
                b = torch.zeros_like(b)
            got = conv_t.conv3x3_t_forward(x, wt, b, kind=kind)
            want = conv_t.conv3x3_t_plain(x, wt, b)
            rec[dt_name] = compare(got, want, dt_name, name)
            del got, want
        # time in the main path's dtype, on the bf16 inputs
        ms = cuda_ms(lambda: conv_t.conv3x3_t_forward(x, wt, b, kind=kind))
        plain_ms = cuda_ms(lambda: conv_t.conv3x3_t_plain(x, wt, b), reps=5)
        xn = x.permute(0, 2, 1, 3).contiguous()          # NCHW
        wo = wt.permute(3, 2, 0, 1).contiguous()         # OIHW
        if kind == "fwd":
            lib = lambda: F.conv2d(xn, wo, b, padding=1)  # noqa: E731
        else:
            # the input gradient of the conv whose flipped weights these
            # are: cuDNN's dgrad of the forward conv (weights flipped back)
            wf = conv_t.flip_transpose(wt).permute(3, 2, 0, 1).contiguous()
            shape = (n, co, h, w)
            lib = lambda: torch.nn.grad.conv2d_input(  # noqa: E731
                shape, wf, xn, padding=1)
        library_ms = cuda_ms(lib, reps=5)
        y_bytes = n * h * co * w * x.element_size()
        record(name, CONV_SRC, "tpu_sandbox/ops/pallas_conv_t.py:133", rec,
               ms, plain_ms, library_ms,
               flops=2.0 * n * h * w * co * 9 * c,
               bytes_=nbytes(x, wt, b) + y_bytes)

    def conv_wgrad(c, co):
        name = f"conv3x3_t_wgrad C{c} CO{co}"
        rec = {}
        for dt_name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x = torch.randn((n, h, c, w), generator=gen, device="cuda").to(dt)
            g = torch.randn((n, h, co, w), generator=gen, device="cuda").to(dt)
            dwt, db = conv_t.conv3x3_t_wgrad(x, g)
            pdwt, pdb = conv_t.conv3x3_t_wgrad_plain(x, g)
            rec[dt_name] = compare(dwt, pdwt, dt_name, name)
            rec[dt_name + "_db"] = compare(db, pdb, dt_name, name + " db")
            again = conv_t.conv3x3_t_wgrad(x, g)
            require(torch.equal(again[0], dwt) and torch.equal(again[1], db),
                    f"{name} {dt_name}: two runs differ (not deterministic)")
        ms = cuda_ms(lambda: conv_t.conv3x3_t_wgrad(x, g))
        plain_ms = cuda_ms(lambda: conv_t.conv3x3_t_wgrad_plain(x, g),
                           reps=5)
        xn = x.permute(0, 2, 1, 3).contiguous()
        gn = g.permute(0, 2, 1, 3).contiguous()
        library_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(
            xn, (co, c, 3, 3), gn, padding=1), reps=5)
        record(name, CONV_SRC, "tpu_sandbox/ops/pallas_conv_t.py:167", rec,
               ms, plain_ms, library_ms,
               flops=2.0 * n * h * w * co * 9 * c,
               bytes_=nbytes(x, g) + 4 * (co * 9 * c + co))

    def fc_dgrad():
        name = "fc_dgrad_t"
        rec = {}
        for dt_name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            g = torch.randn((n, 10), generator=gen, device="cuda")
            wt = (0.01 * torch.randn((10, h, 32, w), generator=gen,
                                     device="cuda")).to(dt)
            got = fc_t.fc_dgrad_t(g, wt, dt)
            want = fc_t.fc_dgrad_t_plain(g, wt, dt)
            rec[dt_name] = compare(got, want, dt_name, name)
            del got, want
        ms = cuda_ms(lambda: fc_t.fc_dgrad_t(g, wt, wt.dtype))
        plain_ms = cuda_ms(lambda: fc_t.fc_dgrad_t_plain(g, wt, wt.dtype),
                           reps=5)
        gb = g.to(wt.dtype)
        library_ms = cuda_ms(
            lambda: torch.einsum("nk,khcw->nhcw", gb, wt), reps=5)
        dy_bytes = n * wt[0].numel() * wt.element_size()
        record(name, FC_SRC, "tpu_sandbox/ops/pallas_fc_t.py:63", rec,
               ms, plain_ms, library_ms,
               flops=2.0 * n * 10 * wt[0].numel(),
               bytes_=nbytes(g, wt) + dy_bytes)

    conv_fwd(16, 256, "fwd")
    torch.cuda.empty_cache()
    conv_fwd(64, 128, "fwd")
    conv_fwd(128, 64, "dgrad")
    torch.cuda.empty_cache()
    conv_wgrad(16, 256)
    torch.cuda.empty_cache()
    conv_wgrad(64, 128)
    fc_dgrad()
    torch.cuda.empty_cache()
    return entries


def phase_ragged(conv_t, fc_t) -> None:
    """Shapes off every tile edge: W=70, H=5, CO=24, C=16, N*H rows not a
    multiple of the wgrad slab; fc with F not a multiple of the block."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for dt_name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        x, wt, b = _conv_case(gen, 2, 5, 16, 70, 24, dt)
        out[f"conv fwd {dt_name}"] = compare(
            conv_t.conv3x3_t_forward(x, wt, b),
            conv_t.conv3x3_t_plain(x, wt, b), dt_name, "ragged conv fwd")
        g = torch.randn((2, 5, 24, 70), generator=gen, device="cuda").to(dt)
        dwt, db = conv_t.conv3x3_t_wgrad(x, g)
        pdwt, pdb = conv_t.conv3x3_t_wgrad_plain(x, g)
        out[f"wgrad {dt_name}"] = compare(dwt, pdwt, dt_name,
                                          "ragged wgrad")
        out[f"wgrad db {dt_name}"] = compare(db, pdb, dt_name,
                                             "ragged wgrad db")
        gf = torch.randn((3, 10), generator=gen, device="cuda")
        w4 = torch.randn((10, 3, 8, 7), generator=gen, device="cuda").to(dt)
        out[f"fc dgrad {dt_name}"] = compare(
            fc_t.fc_dgrad_t(gf, w4, dt),
            fc_t.fc_dgrad_t_plain(gf, w4, dt), dt_name, "ragged fc dgrad")
    torch.cuda.synchronize()
    emit("ragged", checks=out)


def phase_main_path(ops, mnist_onegpu, expected: list[str]):
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    trainer, state = mnist_onegpu.main([
        "--image-size", str(IMAGE), "--batch-size", str(BATCH),
        "--dtype", "bf16", "--synthetic-n", str(STEPS * BATCH),
        "--limit-steps", str(STEPS), "--epochs", "1", "--log-every", "1"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.monotonic() - t0
    require(len(trainer.losses) == STEPS,
            f"main path logged {len(trainer.losses)} losses, not {STEPS}")
    require(all(math.isfinite(v) for v in trainer.losses),
            f"main path non-finite loss: {trainer.losses}")
    require(state.step == STEPS, f"main path took {state.step} steps")
    for key in expected:
        require(counts.get(key, 0) == STEPS,
                f"main path launched {key} {counts.get(key, 0)} times in "
                f"{STEPS} steps, expected one per step")
    require(set(counts) == set(expected),
            f"unexpected launches on the main path: {counts}")
    step_ms = statistics.median(trainer.step_seconds[1:]) * 1e3
    res = dict(image=IMAGE, batch=BATCH, dtype="bf16", steps=STEPS,
               losses=trainer.losses,
               step_ms_each=[s * 1e3 for s in trainer.step_seconds],
               step_ms_median_after_first=step_ms,
               images_per_s=BATCH / (step_ms / 1e3),
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               wall_s_with_init=wall, launches=counts)
    emit("main_path", **res)
    return counts, trainer


def phase_profile(trainer, steps: int = 2) -> None:
    """Where a main-path step's device time goes: ``steps`` more steps of
    the trained model under ``torch.profiler``, after the timed run (the
    profiler's own cost stays out of ``main_path``). Device time per step
    by op or kernel (self time), the busy total, and the idle share of the
    step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_sandbox_torch.data import normalize, synthetic_mnist
    from tpu_sandbox_torch.train.trainer import to_device

    images, labels = synthetic_mnist(n=BATCH, seed=2)
    batch = to_device(normalize(images), labels.astype("int32"),
                      torch.device("cuda"))
    trainer.train_step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            trainer.train_step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3 / steps
    # a kernel's time appears twice: as a device event, and as the self
    # device time of the op that launched it; sum each view on its own
    ops, kernels = {}, {}
    for ev in prof.key_averages():
        ms = ev.self_device_time_total / 1e3 / steps
        if ms > 0:
            view = kernels if ev.device_type == DeviceType.CUDA else ops
            view[ev.key[:80]] = view.get(ev.key[:80], 0.0) + ms
    busy = sum(kernels.values())
    top = lambda d, k: dict(sorted(d.items(), key=lambda kv: -kv[1])[:k])  # noqa: E731
    emit("profile", steps=steps, wall_ms_per_step=wall_ms,
         device_busy_ms_per_step=busy,
         idle_share=(1 - busy / wall_ms) if busy else None,
         ops_ms_per_step=top(ops, 15), kernels_ms_per_step=top(kernels, 10))


def phase_card_vs_cpu() -> None:
    import numpy as np

    from tpu_sandbox_torch.data import BatchLoader, normalize, synthetic_mnist
    from tpu_sandbox_torch.models import ConvNetS2DT
    from tpu_sandbox_torch.train import TrainState, make_train_step
    from tpu_sandbox_torch.train.trainer import to_device
    from tpu_sandbox_torch.utils import params_from_flax, params_to_flax

    hw, steps, bs = (64, 64), 3, 2
    tree = params_to_flax(ConvNetS2DT(hw, seed=0, device="cpu"))
    images, labels = synthetic_mnist(n=steps * bs, seed=0)
    losses = {}
    for dev in ("cpu", "cuda"):
        model = ConvNetS2DT(hw, dtype=torch.float32, seed=1, device=dev)
        model.load_state_dict(params_from_flax(tree))
        step = make_train_step(TrainState(model, lr=1e-4), image_size=hw)
        loader = BatchLoader(normalize(images), labels.astype("int32"), bs,
                             shuffle=True, seed=0)
        losses[dev] = [float(step(*to_device(im, lb, torch.device(dev))))
                       for im, lb in loader]
    ok = np.allclose(losses["cuda"], losses["cpu"], rtol=1e-4, atol=0)
    emit("card_vs_cpu", image=64, dtype="fp32", steps=steps,
         losses_cpu=losses["cpu"], losses_cuda=losses["cuda"], rtol=1e-4,
         agree=bool(ok))
    require(ok, f"card and CPU losses differ: {losses}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from tpu_sandbox_torch import mnist_onegpu, ops
        from tpu_sandbox_torch.ops import build, conv_t, fc_t
        from tpu_sandbox_torch.utils import exact_fp32
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e}); run "
              "it from the root of a checkout", file=sys.stderr)
        return 1

    exact_fp32()
    smi = phase_env(build)
    entries = phase_kernels(conv_t, fc_t)
    phase_ragged(conv_t, fc_t)
    counts, trainer = phase_main_path(ops, mnist_onegpu, list(entries))
    phase_profile(trainer)
    del trainer
    phase_card_vs_cpu()
    for name, e in entries.items():
        e["launches"] = counts[name]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "fp32_rel_err", "bf16_rel_err")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in entries.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
