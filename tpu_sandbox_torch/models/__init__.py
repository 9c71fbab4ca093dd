"""The port's model plans. Counterpart of ``tpu_sandbox/models/__init__.py``.

Only the transposed space-to-depth plan with unfused BN tails and the
scattered-3x3 conv1 is ported. Every other plan or option raises
``NotImplementedError`` rather than running something else in its place;
ROADMAP.md (queue 2) lists what is still to port.
"""

from __future__ import annotations

from tpu_sandbox_torch.models.convnet_s2d_t import ConvNetS2DT

__all__ = ["ConvNetS2DT", "pick_convnet"]

#: s2dt options of the JAX plan that need kernels this port lacks, with
#: the only value this port runs
_S2DT_OPTIONS = {"fused_tail": False, "sparse_conv1": False,
                 "fused_conv1_bwd": False}


def pick_convnet(image_size, *, plan: str = "auto", **kwargs) -> ConvNetS2DT:
    """The execution-plan switch. 'auto' and 's2dt' give ``ConvNetS2DT``
    with ``fused_tail=False, sparse_conv1=False``; the NHWC 's2d' plan,
    the 'plain' ConvNet, image sizes not divisible by 4 and the fused or
    sparse s2dt options are not ported yet and raise."""
    h, w = (image_size, image_size) if isinstance(image_size, int) else image_size
    if plan not in ("auto", "s2dt"):
        raise NotImplementedError(
            f"plan {plan!r} is not ported to PyTorch yet (ROADMAP.md, queue "
            "2); only the transposed space-to-depth plan 's2dt' is")
    if h % 4 or w % 4:
        raise NotImplementedError(
            f"image size {(h, w)} resolves to the plain ConvNet, which is "
            "not ported to PyTorch yet (ROADMAP.md, queue 2)")
    for name, ported in _S2DT_OPTIONS.items():
        value = kwargs.pop(name, ported)
        if value != ported:
            raise NotImplementedError(
                f"ConvNetS2DT({name}={value!r}) needs kernels not ported to "
                "PyTorch yet (ROADMAP.md, queue 2)")
    return ConvNetS2DT((h, w), **kwargs)
