"""analyze_ms: the program's host analysis, the stages ``checks``,
``multipath``, ``analyze`` and ``assemble`` (spans of
``TDOAProcessor.timer``, the card synchronised at each end) summed per
traced window, in ms. Nothing where none of them opened."""

STAGES = ("checks", "multipath", "analyze", "assemble")


def read(run):
    got = [sum(w["stages"][s] for s in STAGES if s in w["stages"])
           for w in run.windows
           if any(s in w["stages"] for s in STAGES)]
    return 1e3 * sum(got) / len(run.windows) if got else None
