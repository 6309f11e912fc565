"""The fused Mamba scan's forward (``ops.mamba_scan_fused``) against its
bound at the cell's microbatch: the bound over the mean span, on the
device, of a profiler range around the entry's kernel wrapper (from the
first kernel launched inside it to the end of the last), in percent.
Kernels are not matched by name."""

LABEL = "perfbench.scan_fwd"
RANGES = [(LABEL, "repro_torch.kernels.mamba_scan", "mamba_scan_fused_cuda")]


def read(ctx):
    calls = (ctx.trace or {}).get("range_ms", {}).get(LABEL)
    if not calls or min(calls) <= 0:
        return None
    bound = ctx.counts("mamba_scan_fused").microbatch_bound(
        "fwd", ctx.model, ctx.traffic, ctx.hw)
    return bound / (sum(calls) / len(calls)) * 100
