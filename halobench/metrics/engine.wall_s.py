"""Seconds per pass in the engine, to its results on the host
(``EntryResult.engine_seconds``)."""


def read(run):
    passes = run["passes"]
    if not passes:
        return None
    return sum(p["engine_s"] for p in passes) / len(passes)
