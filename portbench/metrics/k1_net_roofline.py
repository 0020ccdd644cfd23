"""k1_net_roofline: kernel 1's share of its roofline over the traced
window, in %, with each block's work counted once: the segment FFTs of
its stations once and the cross spectra of all its pairs once, however
many pair-tile launches carried them. The device time is every
``corr_accum_kernel*`` in the trace (the streamed branch's ``_s1`` and
``_s2`` among them). Nothing where kernel 1 did not run.

The blocks are inferred from the port's launch counter (``(rows,
segments, banks, pairs)`` by launch): a block's tiles have the block's
rows, and their pairs add up to C(rows, 2), so the launches of one
``(rows, segments, banks)`` carried (their pairs) / C(rows, 2) blocks.
That holds for the batch path's launches, a block's pairs over its
stations; the overlapped ingest's stacked rows are not such blocks.

The bound is a frozen copy of ``roofline.k1_bound`` (bf16 operands, DC
sums, as the fused path feeds kernel 1), kept here so that neither a
change to the program nor to the tile plan moves it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
FFT_LEN = 65536
SEG_LEN = 45056
ELEM_BYTES = 2
KERNELS = ("corr_accum_kernel",)


def block_seconds(n_st: int, n_seg: int, n_banks: int) -> float:
    """The least time of one block on ``n_st`` stations, all C(n_st, 2)
    pairs: the planar bf16 input read once and the cross, power and sum
    banks written once; a 5·F·log2(F) FFT per station and segment, 8
    operations per bin per pair, 6 per bin per station (power, sums)."""
    m = n_st * (n_st - 1) // 2
    n_bytes = (2 * n_st * n_seg * SEG_LEN * ELEM_BYTES
               + n_banks * FFT_LEN * (8 * m + 4 * n_st + 8 * n_st))
    n_ops = n_seg * FFT_LEN * (n_st * 5 * 16 + 8 * m + 6 * n_st)
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S)


def least_seconds(shapes) -> float:
    """The least time of the blocks that the launches ``{(rows, segments,
    banks, pairs): count}`` carried."""
    pairs = {}
    for (rows, segs, banks, m), n in shapes.items():
        pairs[rows, segs, banks] = pairs.get((rows, segs, banks), 0) + n * m
    return sum(p / (rows * (rows - 1) // 2) * block_seconds(rows, segs, banks)
               for (rows, segs, banks), p in pairs.items())


def read(run):
    shapes = run.launches.get("corr_accum", {})
    device_s = run.trace.kernel_s(KERNELS) if run.trace else 0.0
    if not shapes or device_s <= 0.0:
        return None
    return 100.0 * least_seconds(shapes) / device_s
