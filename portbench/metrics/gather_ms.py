"""gather_ms: the overlapped ingest's ``gather_s`` in
``TDOAProcessor.ingest_diag`` (the host clock around the copies out of
the mmaps into pinned memory, which are the file reads) per traced
window, in ms. Nothing where the overlapped ingest never ran."""

KEY = "gather_s"


def read(run):
    got = [w["ingest"][KEY] for w in run.windows
           if w["ingest"].get(KEY) is not None]
    return 1e3 * sum(got) / len(run.windows) if got else None
