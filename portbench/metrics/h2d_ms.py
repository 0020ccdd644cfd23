"""h2d_ms: the batch ingest's ``h2d_s`` in
``TDOAProcessor.ingest_diag`` (the host clock that the ring's readers in
``io/datfile.load_window`` spend waiting for their pinned slots' earlier
copies to the card, summed over the readers, and the final wait for the
last copies: the copy time left exposed) per traced window, in ms.
Nothing where the batch ingest never counted it."""

KEY = "h2d_s"


def read(run):
    got = [w["ingest"][KEY] for w in run.windows
           if w["ingest"].get(KEY) is not None]
    return 1e3 * sum(got) / len(run.windows) if got else None
