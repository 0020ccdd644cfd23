"""The least time the card could take for a kernel's work, from the
shapes of its launches: the larger of its operations over the f32 peak
and its bytes over the memory rate (NVIDIA H100 SXM data sheet).

Frozen copies of ``chip_smoke.py``'s ``_bound``, ``_k1_bound`` and
``_k3_bound`` with the port's geometry written in as constants, so that
a change to the program cannot move its own yardstick."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Kernel 1's fixed geometry and kernel 3's FIR length.
FFT_LEN = 65536
SEG_LEN = 45056
NUM_TAPS = 128


def bound(n_bytes: float, n_ops: float) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_FLOPS_PER_S
    return {"seconds": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def k1_bound(n_st: int, m: int, n_seg: int, n_banks: int,
             elem_bytes: int = 2, sums: bool = True) -> dict:
    """Kernel 1 (segment FFTs, cross and power spectra into banks): the
    planar input read once (bf16: 2 bytes an element, f32: 4), the
    cross, power and (with DC sums) sum banks written once; a
    5·F·log2(F) complex FFT per station and segment, 8 operations per
    bin per pair, 4 (power) and 2 (sums) per bin per station."""
    return bound(
        2 * n_st * n_seg * SEG_LEN * elem_bytes
        + n_banks * FFT_LEN * (8 * m + 4 * n_st + (8 * n_st if sums else 0)),
        n_seg * FFT_LEN * (n_st * 5 * 16 + 8 * m + (6 if sums else 4) * n_st))


def k3_bound(channels: int, n: int, decim: int) -> dict:
    """Kernel 3 (FM discriminator and decimating FIR): the f32 I/Q read
    once (8 bytes a sample), the audio written once; the conjugate
    product and scale (7) and atan2 (~20) per sample, a multiply-add per
    tap per output."""
    n_out = n // decim
    return bound(channels * n * 8 + channels * n_out * 4,
                 channels * n * 27 + channels * n_out * 2 * NUM_TAPS)
