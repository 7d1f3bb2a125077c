"""Seconds per pass the entry spends on the host outside the chunk loop:
``EntryResult.prep_seconds`` (selections, context) plus ``post_seconds``
(category filters, sort, derived columns, catalogue)."""


def read(run):
    passes = run["passes"]
    if not passes:
        return None
    return sum(p["prep_s"] + p["post_s"] for p in passes) / len(passes)
