"""Device kernels launched in the traced passes per halo catalogued
(copies and memsets not counted)."""


def read(run):
    dev = run["device"]
    if not dev:
        return None
    n = sum(c for name, (c, _) in dev["by_name"].items()
            if not name.startswith(("Memcpy", "Memset")))
    halos = sum(p["halos"] for p in run["passes"])
    return n / halos if halos and n else None
