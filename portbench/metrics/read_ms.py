"""read_ms: the batch ingest's ``read_s`` in
``TDOAProcessor.ingest_diag`` (the host clock while at least one file
read of ``io/datfile.load_window`` was in progress: the union of the
intervals of the ring's readers' reads; on the CPU, the one thread's
reads summed) per traced window, in ms. Nothing where the batch ingest never counted it."""

KEY = "read_s"


def read(run):
    got = [w["ingest"][KEY] for w in run.windows
           if w["ingest"].get(KEY) is not None]
    return 1e3 * sum(got) / len(run.windows) if got else None
