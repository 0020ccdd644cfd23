"""Command-line tools of the PyTorch/CUDA port, each ``python -m
tdoa_tpu_torch.cli.<name>`` with the argument contract of its
``tdoa_tpu.cli`` counterpart. The tools that compute on tensors run on
the card unless ``--device cpu`` is given (``--torch-device cpu`` for the
collector and the gain calibrator, whose ``--device`` is the reference's
USB dongle index); ``coverage`` and ``snr_analysis`` are numpy and
arithmetic only."""

import sys


def tool_device(spec, flag: str = "--device"):
    """The torch device a tool runs on: ``spec`` (``"cpu"``, ``"cuda"``,
    ``"cuda:1"``), or the card when ``spec`` is None. Without a card it
    prints the error, naming the tool's own ``flag``, and returns None:
    the tool then exits with 2."""
    import torch

    from tdoa_tpu_torch.utils.platform import default_device

    try:
        return default_device() if spec is None else torch.device(spec)
    except RuntimeError as e:
        hint = "" if flag == "--device" else f" (this tool: {flag} cpu)"
        print(f"error: {e}{hint}", file=sys.stderr)
        return None


def rewrite_prior_argv(argv):
    """argparse treats "-33.9,18.4,25" (southern-hemisphere prior) as an
    option string, not a value; rewrite to the --prior=VALUE form."""
    argv = list(argv)
    for k, a in enumerate(argv[:-1]):
        if a == "--prior" and argv[k + 1].startswith("-"):
            argv[k:k + 2] = ["--prior=" + argv[k + 1]]
            break
    return argv


def parse_prior(spec, error):
    """Parse a ``LAT,LON,RADIUS_KM`` coverage-prior spec into the
    ``(lat_deg, lon_deg, radius_m)`` tuple ProcessorConfig.prior takes;
    calls ``error(msg)`` (argparse-style, does not return) on bad input."""
    try:
        lat_s, lon_s, rad_s = spec.split(",")
        prior = (float(lat_s), float(lon_s), float(rad_s) * 1000.0)
    except ValueError:
        error("--prior expects LAT,LON,RADIUS_KM (e.g. 41.2,-96.0,25)")
    if not (-90.0 <= prior[0] <= 90.0 and -180.0 <= prior[1] <= 180.0
            and prior[2] > 0.0):
        error("--prior out of range: |lat|<=90, |lon|<=180, radius>0")
    return prior
