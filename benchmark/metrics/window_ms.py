"""pyramid layer (models/pyramid.py): a window's host-clock time (ms).

Per chain, the time of its windows over their number, then the mean over
the chains; windows under the profiler left out. Each solve
ends in its own host reads, so the clock covers the card's work."""


def read(run):
    means = []
    for recs in run.records:
        ms = [r["ms"] for r in recs if not r["profiled"]]
        if ms:
            means.append(sum(ms) / len(ms))
    return sum(means) / len(means) if means else None
