"""k3_roofline: kernel 3's share of its roofline over the traced window,
in %: the least time of its launches (``roofline.k3_bound`` of each
launch's channels, samples and decimation from the port's launch
counter) over the device time of ``fm_demod_kernel`` in the trace.
Nothing where it did not run."""

from portbench import roofline

KERNELS = ("fm_demod_kernel",)


def read(run):
    shapes = run.launches.get("fm_demod", {})
    device_s = run.trace.kernel_s(KERNELS) if run.trace else 0.0
    if not shapes or device_s <= 0.0:
        return None
    least = sum(n * roofline.k3_bound(c, samples, decim)["seconds"]
                for (c, samples, decim), n in shapes.items())
    return 100.0 * least / device_s
