"""loss layer (models/loss.py and below): host-clock ms per loss
evaluation, the windows' time over their evaluations, so the cost of one
evaluation apart from how many a window takes; windows under the profiler
left out."""


def read(run):
    recs = [r for chain in run.records for r in chain if not r["profiled"]]
    evals = sum(r["evals"] for r in recs)
    return sum(r["ms"] for r in recs) / evals if evals else None
