"""loss layer: device operations (kernels, copies, fills) a loss
evaluation, from every chain's `torch.profiler` trace over the windows it
traced."""


def read(run):
    t = run.trace
    if not t or not t["evals"]:
        return None
    return t["device_ops"] / t["evals"]
