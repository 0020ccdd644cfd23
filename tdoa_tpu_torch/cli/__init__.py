"""Command-line tools of the PyTorch/CUDA port, each ``python -m
tdoa_tpu_torch.cli.<name>`` with the argument contract of its
``tdoa_tpu.cli`` counterpart. They run on the card unless ``--device cpu``
is given."""


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
