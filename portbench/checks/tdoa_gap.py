"""tdoa_gap: the widest gap over a window's receiver pairs between the
program's clock-corrected TDOA and the reference's, in samples. Both
answers carry their TDOAs (``Answer.tdoa``), so nothing more is taken
from the program's result."""


def gap(got, want, cfg: dict) -> float:
    return max(abs(got.tdoa[p] - want.tdoa[p]) for p in want.tdoa)
