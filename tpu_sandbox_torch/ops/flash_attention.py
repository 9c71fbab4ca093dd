"""Flash attention whose forward and two backward passes are CUDA kernels.

Counterpart of ``tpu_sandbox/ops/pallas_attention.py``: ``_to_bhsd`` /
``_from_bhsd`` (:52-67), ``_flash_fwd`` (:139) and ``_flash_bwd`` (:314),
each with its ``out_dtype`` (float32 outputs for bfloat16 inputs), the
custom VJP ``_flash_core`` (:440-460), ``flash_attention`` (:463) and
``flash_attention_fn`` (:572). On a CUDA tensor each pass is a kernel of
``csrc/flash_attention.cu``; on a CPU tensor it is the plain version
beside it, which materialises the [S, S] scores. ``delta = rowsum(g * out)``
stays plain PyTorch, as in ``_core_bwd`` (:453-457).

Layouts: the public functions take [B, S, H, D]; the kernels take
[B, H, S, D] with S padded to ``lcm(block_q, block_k)`` (zero rows, keys at
or past ``kv_len`` masked inside) and D padded to the kernels' head width
(32, 64 or 128; zero lanes). The kernels walk 64-row tiles and mask the
ragged edge themselves, so ``block_q`` and ``block_k`` set the padding of
the public contract, not the kernels' tiles.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch
import torch.nn.functional as F

from tpu_sandbox_torch.ops import build

#: launches of the CUDA kernels ("flash_fwd", "flash_bwd_dkv",
#: "flash_bwd_dq"); only a kernel launch adds to it
LAUNCHES: Counter = Counter()

NEG = -1e30                  # the mask filler of the Pallas kernels
HEAD_WIDTHS = (32, 64, 128)  # the kernels' head widths

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ROW = [_I, _I, _I, ctypes.c_float, _I, _I, _I, _I, _P]


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_bound", False):
        lib.flash_fwd.argtypes = [_I, _I, _I, _P, _P, _P, _P, _P] + _ROW
        lib.flash_bwd_dkv.argtypes = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                      _P] + _ROW
        lib.flash_bwd_dq.argtypes = [_I, _I, _I, _P, _P, _P, _P, _P, _P,
                                     _P] + _ROW
        lib.flash_tc_attrs.argtypes = [_I, _I, ctypes.POINTER(_I),
                                       ctypes.POINTER(_I)]
        for fn in (lib.flash_fwd, lib.flash_bwd_dkv, lib.flash_bwd_dq,
                   lib.flash_tc_attrs):
            fn.restype = _I
        lib._bound = True
    return lib


def head_width(d: int) -> int:
    """The kernels' head width for head dim ``d``: the smallest of
    ``HEAD_WIDTHS`` that holds it (``d`` itself when none does, which the
    kernels refuse)."""
    return next((w for w in HEAD_WIDTHS if w >= d), d)


def _valid(sq, sk, causal, kv_len, q_offset, kv_offset, device):
    """[sq, sk] bool: the key exists (local index < kv_len) and, with
    causal, its global position is at most the query's."""
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = kv_offset + torch.arange(sk, device=device)[None, :]
    valid = k_pos < kv_offset + kv_len
    if causal:
        valid = valid & (q_pos >= k_pos)
    return valid


def flash_fwd_plain(q, k, v, *, scale, causal, kv_len, q_offset=0,
                    kv_offset=0, out_dtype=None):
    """q [B,H,Sq,D], k, v [B,H,Sk,D] -> (out [B,H,Sq,D] in ``out_dtype``,
    by default q's dtype, lse [B,H,Sq] f32): f32 scores, p rounded to v's
    dtype before p.v, out = acc / max(l, 1e-30) in f32 and cast once, lse
    = m + log(max(l, 1e-30)). A row with no visible key spreads p = 1 over
    every key here and over the visited tiles in the kernel: its output is
    defined by neither."""
    out_dtype = _out_dtype("flash_fwd", q, out_dtype)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = _valid(q.shape[2], k.shape[2], causal, kv_len, q_offset,
                   kv_offset, q.device)
    s = torch.where(valid, s, torch.full_like(s, NEG))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    del s
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out.to(out_dtype), (m + torch.log(l))[..., 0]


def _p_ds(q, k, v, g, lse, delta, scale, causal, kv_len, q_offset,
          kv_offset):
    """The backward's f32 tiles over the whole sequence: p = exp(s - lse)
    where the key is visible, else 0, and ds = p * (do.v^T - delta) * scale."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = _valid(q.shape[2], k.shape[2], causal, kv_len, q_offset,
                   kv_offset, q.device)
    p = torch.where(valid, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    del s
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, *, scale, causal, kv_len,
                        q_offset=0, kv_offset=0, out_dtype=None):
    """(dk, dv) in ``out_dtype``, by default k's and v's dtype: dv = p^T.do
    and dk = ds^T.q in f32."""
    p, ds = _p_ds(q, k, v, g, lse, delta, scale, causal, kv_len, q_offset,
                  kv_offset)
    dv = torch.matmul(p.transpose(-1, -2), g.float())
    del p
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


def flash_bwd_dq_plain(q, k, v, g, lse, delta, *, scale, causal, kv_len,
                       q_offset=0, kv_offset=0, out_dtype=None):
    """dq in ``out_dtype``, by default q's dtype: ds.k in f32."""
    _, ds = _p_ds(q, k, v, g, lse, delta, scale, causal, kv_len, q_offset,
                  kv_offset)
    return torch.matmul(ds, k.float()).to(out_dtype or q.dtype)


def _check(name, tensors, rows):
    """Refuse what the kernels do not take; returns (dtype code, width)."""
    q = tensors[0]
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} kernel takes tensors on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in tensors[:4] if t is not None):
        raise ValueError(f"{name} kernel takes q, k, v (and do) all float32 "
                         f"or all bfloat16, got {[t.dtype for t in tensors]}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned")
    b, h, _, d = q.shape
    if d not in HEAD_WIDTHS:
        raise ValueError(f"{name} kernel takes head widths {HEAD_WIDTHS}, "
                         f"got {d}")
    if b * h > 65535:
        raise ValueError(f"{name} kernel takes at most 65535 (batch, head) "
                         f"pairs, got {b * h}")
    for t in tensors[4:]:                       # lse, delta
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, rows):
            raise ValueError(f"{name}: lse and delta are f32 [B,H,Sq]")
    return _DTYPES[q.dtype], d


def _row_args(q, k, scale, causal, kv_len, q_offset, kv_offset):
    b, h, sq, _ = q.shape
    if not 0 <= kv_len <= k.shape[2]:
        raise ValueError(f"kv_len {kv_len} outside [0, {k.shape[2]}]")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return [b * h, sq, k.shape[2], scale, int(causal), kv_len, int(q_offset),
            int(kv_offset), stream]


def flash_fwd(q, k, v, *, scale, causal, kv_len, q_offset=0, kv_offset=0,
              out_dtype=None):
    """q [B,H,Sq,D], k, v [B,H,Sk,D] -> (out in ``out_dtype``, by default
    q's dtype (float32 for bfloat16 inputs is the other choice), lse
    [B,H,Sq] f32): the kernel on CUDA tensors, the plain version on CPU
    tensors."""
    kw = dict(scale=scale, causal=causal, kv_len=kv_len, q_offset=q_offset,
              kv_offset=kv_offset)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, out_dtype=out_dtype, **kw)
    dt, d = _check("flash_fwd", (q, k, v), q.shape[2])
    out_dtype, ot = _out_code("flash_fwd", q, out_dtype)
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match")
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(dt, ot, d, q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                            *_row_args(q, k, **kw))
    build.check(lib, err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def _out_dtype(name, q, out_dtype):
    """An output dtype: the input dtype, or float32 for bfloat16 inputs
    (``_flash_fwd``'s and ``_flash_bwd``'s ``out_dtype``); None is the
    input dtype."""
    out_dtype = out_dtype or q.dtype
    if out_dtype not in (q.dtype, torch.float32):
        raise ValueError(f"{name} kernel writes {q.dtype} or float32 for "
                         f"{q.dtype} inputs, not {out_dtype}")
    return out_dtype


def _out_code(name, q, out_dtype):
    """(output dtype, the kernels' code of it), by ``_out_dtype``'s rule."""
    out_dtype = _out_dtype(name, q, out_dtype)
    return out_dtype, _DTYPES[out_dtype]


def flash_bwd_dkv(q, k, v, g, lse, delta, *, scale, causal, kv_len,
                  q_offset=0, kv_offset=0, out_dtype=None):
    """(dk, dv) in ``out_dtype``, by default k's dtype (float32 for
    bfloat16 inputs is the other choice): the kv-major kernel on CUDA
    tensors, the plain version on CPU tensors."""
    kw = dict(scale=scale, causal=causal, kv_len=kv_len, q_offset=q_offset,
              kv_offset=kv_offset)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, out_dtype=out_dtype,
                                   **kw)
    dt, d = _check("flash_bwd_dkv", (q, k, v, g, lse, delta), q.shape[2])
    out_dtype, ot = _out_code("flash_bwd_dkv", q, out_dtype)
    dk = torch.empty(k.shape, dtype=out_dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=out_dtype, device=v.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dkv(dt, ot, d, q.data_ptr(), k.data_ptr(),
                                v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dk.data_ptr(),
                                dv.data_ptr(), *_row_args(q, k, **kw))
    build.check(lib, err, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, g, lse, delta, *, scale, causal, kv_len,
                 q_offset=0, kv_offset=0, out_dtype=None):
    """dq in ``out_dtype``, by default q's dtype (float32 for bfloat16
    inputs is the other choice): the q-major kernel on CUDA tensors, the
    plain version on CPU tensors."""
    kw = dict(scale=scale, causal=causal, kv_len=kv_len, q_offset=q_offset,
              kv_offset=kv_offset)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, out_dtype=out_dtype,
                                  **kw)
    dt, d = _check("flash_bwd_dq", (q, k, v, g, lse, delta), q.shape[2])
    out_dtype, ot = _out_code("flash_bwd_dq", q, out_dtype)
    dq = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dq(dt, ot, d, q.data_ptr(), k.data_ptr(),
                               v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dq.data_ptr(),
                               *_row_args(q, k, **kw))
    build.check(lib, err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def kernel_attrs(name: str, out_dtype: torch.dtype) -> dict:
    """Registers a thread and local memory bytes a thread (spills
    included) of the loaded bfloat16-input kernel ``name`` ("flash_fwd",
    "flash_bwd_dkv" or "flash_bwd_dq") at D 128 writing ``out_dtype``, as
    the CUDA runtime reports them for the module in use."""
    which = {"flash_fwd": 0, "flash_bwd_dkv": 1, "flash_bwd_dq": 2}[name]
    regs, local = _I(0), _I(0)
    lib = _lib()
    err = lib.flash_tc_attrs(which, _DTYPES[out_dtype], ctypes.byref(regs),
                             ctypes.byref(local))
    build.check(lib, err, name + " attributes")
    return {"registers": regs.value, "local_bytes": local.value}


class _FlashCore(torch.autograd.Function):
    """out = attention(q, k, v) on [B,H,S,D]; saves (q, k, v, out, lse)
    and recomputes p in the backward, no [S, S] residual."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_len):
        out, lse = flash_fwd(q, k, v, scale=scale, causal=causal,
                             kv_len=kv_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(scale=scale, causal=causal, kv_len=kv_len)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(-1)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, **ctx.kw)
        dq = flash_bwd_dq(q, k, v, g, lse, delta, **ctx.kw)
        return dq, dk, dv, None, None, None


def _to_bhsd(x: torch.Tensor, s_target: int, d_target: int) -> torch.Tensor:
    """[B, S, H, D] -> [B, H, s_target, d_target], zero-padded, contiguous."""
    x = x.movedim(2, 1)
    return F.pad(x, (0, d_target - x.shape[3], 0, s_target - x.shape[2])
                 ).contiguous()


def _from_bhsd(x: torch.Tensor, s: int, d: int) -> torch.Tensor:
    return x[:, :, :s, :d].movedim(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Flash attention over [B, S, H, D] inputs, differentiable in q, k, v.
    S is padded to a multiple of ``lcm(block_q, block_k)`` and the padded
    keys masked; D is padded to the kernels' head width."""
    b, s, h, d = q.shape
    scale = 1.0 / float(d) ** 0.5
    lcm = math.lcm(block_q, block_k)
    sp = -(-max(s, lcm) // lcm) * lcm
    dp = head_width(d)
    out = _FlashCore.apply(_to_bhsd(q, sp, dp), _to_bhsd(k, sp, dp),
                           _to_bhsd(v, sp, dp), scale, causal, s)
    return _from_bhsd(out, s, d)


def flash_attention_with_lse(q, k, v, *, causal: bool = True, q_offset=0,
                             kv_offset=0, block_q: int = 128,
                             block_k: int = 128):
    """Forward only, with global offsets: (out [B,S,H,D] f32, lse [B,S,H]
    f32), padding as ``flash_attention_lse`` (:493) does: q to
    ``block_q``, k and v to ``block_k``, keys past their true length
    masked. out is float32 whatever q's dtype, as there: a caller's
    logsumexp merge of partials never sees a rounded partial."""
    b, s, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / float(d) ** 0.5
    sp = -(-max(s, block_q) // block_q) * block_q
    skp = -(-max(sk, block_k) // block_k) * block_k
    dp = head_width(d)
    out, lse = flash_fwd(_to_bhsd(q, sp, dp), _to_bhsd(k, skp, dp),
                         _to_bhsd(v, skp, dp), scale=scale, causal=causal,
                         kv_len=sk, q_offset=q_offset, kv_offset=kv_offset,
                         out_dtype=torch.float32)
    return _from_bhsd(out, s, d), lse[:, :, :s].movedim(1, 2)


def flash_attention_fn(*, causal: bool = True, block_q: int = 128,
                       block_k: int = 128):
    """An ``attention_fn`` for ``models.transformer.TransformerLM``."""

    def fn(q, k, v):
        return flash_attention(q, k, v, causal=causal, block_q=block_q,
                               block_k=block_k)

    return fn
