"""Bucket programs per pass (``EngineStats.n_bucket_calls``)."""


def read(run):
    passes = run["passes"]
    if not passes:
        return None
    return sum(p["bucket_calls"] for p in passes) / len(passes)
