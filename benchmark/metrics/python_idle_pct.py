"""host dispatch layer: the share (%) of the traced span in which the card
ran none of chain 0's device operations while its host was inside one of
the program's own spans (`eincm.*`, `eincm_tpu_torch/utils/profiling.py`)
and in no finer host operation the trace names: the program's own host
work between its ops, and under `eincm.grad` the autograd engine's between
its backward nodes. Read from chain 0's named idle gaps, only the ten
longest names the trace keeps; None where no such gap is named (a program
without the spans)."""

PREFIX = "eincm."


def read(run):
    t = run.trace
    if not t or not t.get("idle_gaps") or t["span_s"] <= 0:
        return None
    ours = [sec for name, sec in t["idle_gaps"]
            if name.split("/", 1)[-1].startswith(PREFIX)]
    if not ours:
        return None
    return 100.0 * sum(ours) / t["span_s"]
