"""conv1 and its BN/ReLU/pool tail as one differentiable unit, whose
backward never writes conv1's output cotangent to device memory.

Counterpart of ``tpu_sandbox/ops/pallas_conv1_tail_t.py``:
``conv1_tail_t`` (:198) with ``_fwd_impl`` (:212-216) and ``_vjp_bwd``
(:226-244), ``_fused_wgrad`` (:142) and ``conv1_tail_t_reference``
(:250-258). The forward is the sparse conv1 with fused statistics
(``conv5_t``) then the fused tail forward (``bn_tail_t``). The backward
runs the tail's reduce pass (bn1's s1/s2 are sums over the whole batch),
the per-channel columns, then ONE kernel that recomputes each row's tail
dy on chip, rounds it to the activation dtype as the stored tensor would
be, and feeds it straight into the sparse conv1's weight gradient:
(dW1, db), gathered back onto k5 and the conv bias. dgamma = s2 and
dbeta = s1, as in the tail's own backward.

Like ``conv1_s2d_t``, the unit's x is data: a forward whose x requires
grad raises, outside the Function, as JAX's guard sits outside its
custom VJP.

The fused wgrad dispatches on the device of its tensors: on the CPU it
runs its plain PyTorch version (the tail's apply pass, then the sparse
wgrad); on a CUDA tensor it launches the kernel of
``csrc/conv1_tail_t.cu`` or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from tpu_sandbox_torch.ops import build, bn_tail_t, conv5_t
from tpu_sandbox_torch.ops.conv_t import _check_cuda, wgrad_slabs

#: launches of the CUDA kernel, by output channels of conv1
#: ("conv1_tail_t wgrad CO256"); only a kernel launch adds to it
LAUNCHES: Counter = Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("conv1_tail_t")
    if not getattr(lib, "_bound", False):
        lib.conv1_tail_t_wgrad.argtypes = (
            [_I] + [_P] * 12 + [_I] * 8 + [_P])
        lib.conv1_tail_t_wgrad.restype = _I
        lib.conv1_tail_t_wgrad_plan.argtypes = [_I]
        lib.conv1_tail_t_wgrad_plan.restype = _I
        lib._bound = True
    return lib


def fused_wgrad_plain(x, y1, g, co: int, blk: int, a_col, b_col, mu, inv,
                      gi_col, c1_col, c2_col):
    """(dW1 [CO, 64] f32, db [CO, 1] f32): the tail's apply pass (dy
    rounded to y1's dtype), then the sparse conv1's weight gradient."""
    dy = bn_tail_t.bwd_apply_plain(y1, g, co, blk, a_col, b_col, mu, inv,
                                   gi_col, c1_col, c2_col)
    return conv5_t.conv1_s2d_t_wgrad_plain(x, dy)


def fused_wgrad(x: torch.Tensor, y1: torch.Tensor, g: torch.Tensor, co: int,
                blk: int, a_col, b_col, mu, inv, gi_col, c1_col, c2_col):
    """The fused backward pass: x [N,H4,16,W4], conv1's output y1
    [N,H4,C,W4], the pooled cotangent g [N,H4,C/4,W4], the tail's f32
    columns (a, b, gi, c1, c2 [C]) and statistics (mu, inv [co]) ->
    (dW1 [C, 64] f32, db [C, 1] f32)."""
    bn_tail_t._check_geometry(y1, co, blk)
    if x.device.type == "cpu":
        return fused_wgrad_plain(x, y1, g, co, blk, a_col, b_col, mu, inv,
                                 gi_col, c1_col, c2_col)
    reps = blk * blk
    mu_col, inv_col = bn_tail_t.col_expand(mu, reps), bn_tail_t.col_expand(
        inv, reps)
    cols = (a_col, b_col, mu_col, inv_col, gi_col, c1_col, c2_col)
    bn_tail_t._cuda_operands("conv1_tail_t wgrad", y1, g, cols)
    n, h, c, wd = y1.shape
    _check_cuda("x", x, y1.dtype, (n, h, conv5_t.R * conv5_t.R, wd))
    lib = _lib()
    if y1.dtype == torch.float32:
        parts, per = wgrad_slabs(n * h)
    else:
        parts, per = conv5_t.bf16_units(lib.conv1_tail_t_wgrad_plan, x, c,
                                        "conv1_tail_t wgrad")
    m = c * conv5_t.NT + c
    part = torch.empty((parts, m), dtype=torch.float32, device=x.device)
    out = torch.empty((m,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv1_tail_t_wgrad(
            bn_tail_t._DTYPES[y1.dtype], x.data_ptr(), y1.data_ptr(),
            g.data_ptr(), *[t.data_ptr() for t in cols], part.data_ptr(),
            out.data_ptr(), n, h, c, co, blk, wd, parts, per, stream)
    build.check(lib, err, "conv1_tail_t_wgrad")
    LAUNCHES[f"conv1_tail_t wgrad CO{c}"] += 1
    nt = conv5_t.NT
    return out[: c * nt].view(c, nt), out[c * nt:].view(c, 1)


class _Conv1TailT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k5, cbias, gamma, beta, co, blk, eps, group):
        y1, s, ss = conv5_t.conv1_s2d_t_stats_forward(
            x, *conv5_t.prep(k5, cbias, x.dtype))
        out, mu, var, inv, a_col, b_col = bn_tail_t.tail_forward(
            y1, gamma, beta, co, blk, eps, s, ss, group)
        ctx.save_for_backward(x, y1, gamma, mu, inv, a_col, b_col)
        ctx.co, ctx.blk, ctx.group = co, blk, group
        ctx.f1, ctx.dtypes = k5.shape[-1], (k5.dtype, cbias.dtype)
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, g, _dmu, _dvar):
        # the mu/var cotangents are ignored, as in JAX: the running-stats
        # update is not differentiated
        x, y1, gamma, mu, inv, a_col, b_col = ctx.saved_tensors
        co, blk = ctx.co, ctx.blk
        g = g.contiguous()
        s1_co, s2_co = bn_tail_t.bwd_reduce(y1, g, co, blk, a_col, b_col, mu,
                                            inv)
        n, h, _, w = y1.shape
        groups = blk * blk
        gi_col, c1_col, c2_col = bn_tail_t.global_scales(
            s1_co, s2_co, gamma, inv, groups, n * h * w * groups, ctx.group)
        dw1, db = fused_wgrad(x, y1, g, co, blk, a_col, b_col, mu, inv,
                              gi_col, c1_col, c2_col)
        dk5, dcbias = conv5_t.fold_param_grads(dw1, db, ctx.f1, *ctx.dtypes)
        return (None, dk5, dcbias, s2_co.to(gamma.dtype),
                s1_co.to(gamma.dtype), None, None, None, None)


def conv1_tail_t(x: torch.Tensor, k5: torch.Tensor, cbias: torch.Tensor,
                 gamma: torch.Tensor, beta: torch.Tensor, co: int, blk: int,
                 eps: float = 1e-5, group=None):
    """x [N,H4,16,W4] (the s2d image, data only), k5 [5,5,1,co] canonical,
    cbias [co], gamma/beta [co] -> (pooled [N,H4,4*co,W4], mu [co], var
    [co]): ``conv1_s2d_t_stats`` then the fused tail forward, with the
    fused backward. ``group`` (a ``StatsGroup``) makes the statistics the
    whole batch's, as in ``fused_bn_relu_pool_t``. mu and var are not
    differentiable."""
    conv5_t.require_data_input(x, "conv1_tail_t")
    return _Conv1TailT.apply(x.contiguous(), k5, cbias, gamma, beta, co, blk,
                             eps, group)


def conv1_tail_t_reference(x, k5, cbias, gamma, beta, co: int, blk: int,
                           eps: float = 1e-5):
    """The unfused composition (the ops the model runs with
    ``fused_conv1_bwd=False``): the equality contract for the tests."""
    y1, s, ss = conv5_t.conv1_s2d_t_stats(x, k5, cbias)
    return bn_tail_t.fused_bn_relu_pool_t(y1, gamma, beta, co, blk, eps,
                                          (s, ss))
