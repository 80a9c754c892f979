"""device layer: the share (%) of the traced span in which the card ran
no device operation of any chain: the union of every chain's kernels,
copies and fills from its `torch.profiler` trace (one time base for all
processes of the host). The card runs one process's operations at a time,
so the union is its busy time; NVML's utilization.gpu is not used, as it
counts the card busy while it switches between the chains' contexts."""


def read(run):
    t = run.trace
    if not t or t["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
