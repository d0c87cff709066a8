"""A kernel's share of its roofline over a traced slide.

The numerator is the least time of every launch the cell's work needs,
the denominator the device time its launches took.  A launch count that
differs from the wrapper's counter means the shapes no longer describe
the work: then nothing is reported, and the run says why.
"""

from __future__ import annotations

#: each wrapper's device kernels (``csrc/conv3x3_igemm.cuh``)
NAMES = {"fused_conv3x3": ("conv_wgmma", "splitk_reduce", "conv_fma")}
#: wrappers that launch kernels of the same names: while one of them
#: launches in the traced slide, device time cannot be told apart by name
SHARED = {"fused_conv3x3": ("fused_up_stage",)}


def share(ctx, wrapper: str, least) -> float:
    if ctx.trace is None:
        return None
    shapes = ctx.expected_launches.get(wrapper, [])
    counted = ctx.launches.get(wrapper)
    if not shapes:
        return None
    if counted != len(shapes):
        ctx.note(f"{wrapper} roofline: not reported, the wrapper counted "
                 f"{counted} launches and the work's shapes give "
                 f"{len(shapes)}")
        return None
    others = [w for w in SHARED[wrapper] if ctx.launches.get(w)]
    if others:
        ctx.note(f"{wrapper} roofline: not reported, {others} launched "
                 f"kernels of the same names")
        return None
    spent = sum(t for name, t in ctx.trace.kernel_seconds().items()
                if any(k in name for k in NAMES[wrapper]))
    if not spent:
        ctx.note(f"{wrapper} roofline: not reported, no device time found "
                 f"for its kernels")
        return None
    return 100.0 * sum(least(s) for s in shapes) / spent
