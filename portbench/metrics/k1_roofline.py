"""k1_roofline: kernel 1's share of its roofline over the traced window,
in %: the least time of the launches it made (``roofline.k1_bound`` of
each launch's rows, segments, banks and pairs from the port's launch
counter; bf16 operands and DC sums, as the fused and overlapped paths
feed it) over the device time of its kernels in the trace. Nothing where
it did not run."""

from portbench import roofline

KERNELS = ("corr_accum_kernel",)


def read(run):
    shapes = run.launches.get("corr_accum", {})
    device_s = run.trace.kernel_s(KERNELS) if run.trace else 0.0
    if not shapes or device_s <= 0.0:
        return None
    least = sum(n * roofline.k1_bound(rows, pairs, segs, banks)["seconds"]
                for (rows, segs, banks, pairs), n in shapes.items())
    return 100.0 * least / device_s
