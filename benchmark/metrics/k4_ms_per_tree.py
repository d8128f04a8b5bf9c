"""Device milliseconds a tree of the histogram kernels (K4 and K5's
``histogram_kernel`` and ``histogram_wide_kernel``, and the conversion
``to_float_kernel``) in the traced job."""

KERNELS = r"histogram_kernel|histogram_wide_kernel|to_float_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.traced.get("trees"):
        return None
    s = ctx.trace.kernel_seconds(KERNELS)
    return s * 1e3 / ctx.traced["trees"] if s > 0 else None
