"""Where a flash-ring hop's device time goes, on one CUDA card.

    python3 tools/ring_hop_profile.py

Builds the port's kernels, then runs each case five times under
torch.profiler after a warm-up (``chip_smoke.device_times``) and prints
the summed device time a call and its largest kernels and copies: ``flash_attention_with_lse`` (one
forward hop) and ``make_flash_bwd_lse``'s closure (one backward hop) at
the LM's shapes (B 16, H 8, D 128, bf16, causal) on 512-token blocks
(``chip_smoke.py``'s ring_kernels: a diagonal, a wholly-future and a
wholly-past hop) and on the whole 2048-token sequence (the one hop a
layer of ``SeqParallel`` at one rank); the merge of two partials; and a
layer's attention forward and backward through the port's flash
attention (the dp path) and through ``FlashRingAttention`` at one rank
(the sp path). Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
B, H, D = 16, 8, 128


def top(fn, what: str, calls: int = 5, rows: int = 8) -> None:
    from chip_smoke import device_times

    found = device_times(fn, calls)
    print(f"{what}: device {sum(r[0] for r in found):.4f} ms a call")
    for ms, count, name in found[:rows]:
        print(f"   {ms:.4f} ms  x{count:.1f}  {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_hop_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from tpu_sandbox_torch.ops import build
    from tpu_sandbox_torch.ops import flash_attention as fa
    from tpu_sandbox_torch.parallel.collectives import CollectiveGroup
    from tpu_sandbox_torch.parallel.flash_ring import FlashRingAttention, merge
    from tpu_sandbox_torch.runtime import bootstrap

    build.build_all()
    print(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = ((512, {"diagonal": (1024, 1024), "future": (1024, 1536),
                    "past": (1024, 0)}),
             (2048, {"diagonal": (0, 0)}))
    for s, hops in cases:
        q, k, v, g = (torch.randn((B, s, H, D), generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention_with_lse(q, k, v)
        bwd = fa.make_flash_bwd_lse(q, o.to(torch.bfloat16), g, lse)
        for kind, (qo, ko) in hops.items():
            top(lambda: fa.flash_attention_with_lse(
                q, k, v, causal=True, q_offset=qo, kv_offset=ko),
                f"S{s} forward hop, {kind}")
            bwd_at = fa.make_flash_bwd_lse(
                q, o.to(torch.bfloat16), g, lse, q_offset=qo) if qo else bwd
            top(lambda: bwd_at(k, v, ko), f"S{s} backward hop, {kind}")
    o0 = torch.zeros(o.shape, device="cuda")
    l0 = torch.full(lse.shape, fa.NEG, device="cuda")
    top(lambda: merge(o0, l0, o, lse), "S2048 merge of two partials")
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def dp_layer():
        torch.autograd.grad(fa.flash_attention(qr, kr, vr), (qr, kr, vr), g)

    top(dp_layer, "S2048 flash_attention forward and backward (dp path)")
    bootstrap.init(device="cuda")
    try:
        group = CollectiveGroup(None)

        def sp_layer():
            out = FlashRingAttention.apply(qr, kr, vr, group, True, 128, 128)
            torch.autograd.grad(out, (qr, kr, vr), g)

        top(sp_layer, "S2048 FlashRingAttention forward and backward at one "
            "rank (sp path)")
    finally:
        bootstrap.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
