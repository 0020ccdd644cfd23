"""solve_ms: the program's stage ``solve`` (a span of
``TDOAProcessor.timer``, the card synchronised at its end) per traced
window, in ms. Nothing where the stage never opened."""

STAGE = "solve"


def read(run):
    got = [w["stages"][STAGE] for w in run.windows if STAGE in w["stages"]]
    return 1e3 * sum(got) / len(run.windows) if got else None
