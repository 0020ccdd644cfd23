"""pinned_wait_ms: the overlapped ingest's ``wait_s`` in
``TDOAProcessor.ingest_diag`` (the host clock around the stager's waits
for a pinned buffer's last copy before it gathers into it again) per
traced window, in ms. Nothing where the stager never counted it."""

KEY = "wait_s"


def read(run):
    got = [w["ingest"][KEY] for w in run.windows
           if w["ingest"].get(KEY) is not None]
    return 1e3 * sum(got) / len(run.windows) if got else None
