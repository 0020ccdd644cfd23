from tdoa_tpu_torch.solve.ghost import (
    GhostVerdict,
    ghost_posterior,
)
from tdoa_tpu_torch.solve.multilateration import (
    FixResult,
    rank_candidates_by_power,
    refit_to_candidate,
    solve_fix,
    solve_tdoa_enu,
    solve_tdoa_enu_multistart,
    station_pairs,
)

__all__ = [
    "GhostVerdict",
    "ghost_posterior",
    "solve_tdoa_enu",
    "solve_tdoa_enu_multistart",
    "solve_fix",
    "station_pairs",
    "rank_candidates_by_power",
    "refit_to_candidate",
    "FixResult",
]
