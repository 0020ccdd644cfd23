"""copy_ms: the overlapped ingest's ``transfer_stream_s`` in
``TDOAProcessor.ingest_diag`` (the chunks' time on the copy stream, from
CUDA events) per traced window, in ms. Nothing where the overlapped
ingest never ran."""

KEY = "transfer_stream_s"


def read(run):
    got = [w["ingest"][KEY] for w in run.windows
           if w["ingest"].get(KEY) is not None]
    return 1e3 * sum(got) / len(run.windows) if got else None
