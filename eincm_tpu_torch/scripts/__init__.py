"""The solver and accuracy studies of the JAX package's `scripts/`, as
entry points of the port: `python -m eincm_tpu_torch.scripts.<name>
[--device cuda] [--out PATH]`. Each keeps its JAX script's protocol,
function names and the keys of the JSON line it prints; its functions take
the sizes (windows, rounds, solver overrides) as keyword arguments, with
the JAX script's values as defaults. Their H100 readings are in PERF.md."""
