"""BFGS layer (models/bfgs.py): device-to-host reads a window
(`SolveResult.n_host_syncs`), over every window of every chain."""


def read(run):
    recs = [r for chain in run.records for r in chain]
    return sum(r["syncs"] for r in recs) / len(recs) if recs else None
