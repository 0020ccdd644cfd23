"""h2d_ms: the batch ingest's ``h2d_s`` in
``TDOAProcessor.ingest_diag`` (the host clock around the pageable
copies of the files' bytes to the card, each of which returns once it
is done) per traced window, in ms. Nothing where the batch ingest never
counted it."""

KEY = "h2d_s"


def read(run):
    got = [w["ingest"][KEY] for w in run.windows
           if w["ingest"].get(KEY) is not None]
    return 1e3 * sum(got) / len(run.windows) if got else None
