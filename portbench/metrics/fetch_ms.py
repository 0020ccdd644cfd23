"""fetch_ms: the stage ``checks``' ``fetch_s`` in
``TDOAProcessor.ingest_diag`` (the host clock around the fetch of the
window's outputs to the host, the card's copies included) per traced
window, in ms. Nothing where the program never counted it."""

KEY = "fetch_s"


def read(run):
    got = [w["ingest"][KEY] for w in run.windows
           if w["ingest"].get(KEY) is not None]
    return 1e3 * sum(got) / len(run.windows) if got else None
