"""load_ms: the program's stage ``load+decode`` (a span of
``TDOAProcessor.timer``, the card synchronised at its end) per traced
window, in ms. Nothing where the stage never opened."""

STAGE = "load+decode"


def read(run):
    got = [w["stages"][STAGE] for w in run.windows if STAGE in w["stages"]]
    return 1e3 * sum(got) / len(run.windows) if got else None
