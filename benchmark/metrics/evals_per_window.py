"""BFGS layer (models/bfgs.py): loss evaluations a window, from each
level's `n_fun_evals` (value-and-gradient evaluations and Armijo probes),
over every window of every chain."""


def read(run):
    recs = [r for chain in run.records for r in chain]
    return sum(r["evals"] for r in recs) / len(recs) if recs else None
