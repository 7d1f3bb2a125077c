"""Seconds per pass the main thread waits in the chunk loop for its
chunks' read and staging (``EntryResult.stage_seconds``)."""


def read(run):
    passes = run["passes"]
    if not passes:
        return None
    return sum(p["stage_s"] for p in passes) / len(passes)
