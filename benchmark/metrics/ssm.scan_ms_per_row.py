"""ssm.scan_ms_per_row: The Mamba layers' chunked scans of the traced window (prefills, latent passes), ms per row scanned (ssm.scan spans)."""

from portbench.spans import in_window


def read(obs):
    scans = [s for s in in_window(obs) if s[2] == "ssm.scan"]
    rows = sum(int(s[5]["rows"]) for s in scans)
    return 1e-6 * sum(s[4] - s[3] for s in scans) / rows if rows else None
