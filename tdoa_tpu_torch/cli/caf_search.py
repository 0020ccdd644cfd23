"""Delay-Doppler (CAF) search CLI on the PyTorch/CUDA port: joint
TDOA/FDOA for a station pair.

For moving emitters or drifting receiver clocks, plain correlation
collapses over long integrations; the CAF searches both axes:

    python -m tdoa_tpu_torch.cli.caf_search <a.dat> <b.dat> \
        [--block ref1|tgt|ref2] [--max-lag N] [--doppler-span HZ]

Prints the joint (delay, Doppler) peak per station pair and an ASCII
rendering of the ambiguity surface. Runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

_BLOCKS = {"ref1": 0, "tgt": 1, "ref2": 2}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="caf_search")
    p.add_argument("dat_a")
    p.add_argument("dat_b")
    p.add_argument("--block", choices=list(_BLOCKS), default="tgt")
    p.add_argument("--max-lag", type=int, default=1024)
    p.add_argument("--seg-len", type=int, default=1 << 15,
                   help="segment length; Doppler span = +/-1/(2*T_seg)")
    p.add_argument("--n-doppler", type=int, default=41)
    p.add_argument("--doppler-span", type=float, default=None,
                   help="Hz (default: full unambiguous span)")
    p.add_argument("--sample-rate", type=float, default=2e6)
    p.add_argument("--max-samples", type=int, default=1 << 22)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; an error when "
                        "none is visible — pass cpu to run on the CPU)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from tdoa_tpu_torch.io import load_dat
    from tdoa_tpu_torch.ops.caf import caf_pairs

    bi = _BLOCKS[args.block]
    try:
        caps = [load_dat(args.dat_a, device=args.device),
                load_dat(args.dat_b, device=args.device)]
    except RuntimeError as e:  # no card visible and no --device
        print(f"error: {e}", file=sys.stderr)
        return 2
    blocks = [(c.ref1, c.tgt, c.ref2)[bi] for c in caps]
    n = min(int(b.shape[-1]) for b in blocks)
    n = min(n, args.max_samples)
    x = torch.stack([b[:, :n] for b in blocks], dim=1)  # [2, 2, n]
    print(f"CAF over {n:,} samples of the {args.block.upper()} block "
          f"({n/args.sample_rate:.2f} s) on {x.device}")
    res = caf_pairs(
        x, np.array([[0, 1]]), args.sample_rate,
        max_lag=args.max_lag, seg_len=args.seg_len,
        n_doppler=args.n_doppler, doppler_span_hz=args.doppler_span,
    )
    delay = float(res.delay[0])
    dop = float(res.doppler_hz[0])
    print(f"peak: delay {delay:+.3f} samples "
          f"({delay/args.sample_rate*1e6:+.3f} us), "
          f"Doppler {dop:+.3f} Hz, magnitude {float(res.peak_value[0]):.3f}")

    # ASCII surface: Doppler rows x coarse lag columns.
    surf = res.surface[0].cpu().numpy()  # [D, W]
    w = surf.shape[1]
    cols = 64
    step = max(w // cols, 1)
    surf_c = surf[:, : (w // step) * step].reshape(surf.shape[0], -1, step).max(-1)
    lo, hi = surf_c.min(), surf_c.max()
    ramp = " .:-=+*#%@"
    print("\nambiguity surface (rows: Doppler; cols: lag):")
    for r in range(surf_c.shape[0]):
        line = "".join(
            ramp[int((v - lo) / max(hi - lo, 1e-12) * (len(ramp) - 1))]
            for v in surf_c[r]
        )
        print(f"  {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
