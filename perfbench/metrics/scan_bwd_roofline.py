"""The fused Mamba scan's backward against its bound at the cell's
microbatch, as ``scan_fwd_roofline`` reads the forward: a profiler range
around ``mamba_scan_fused_backward_cuda``."""

LABEL = "perfbench.scan_bwd"
RANGES = [(LABEL, "repro_torch.kernels.mamba_scan",
           "mamba_scan_fused_backward_cuda")]


def read(ctx):
    calls = (ctx.trace or {}).get("range_ms", {}).get(LABEL)
    if not calls or min(calls) <= 0:
        return None
    bound = ctx.counts("mamba_scan_fused").microbatch_bound(
        "bwd", ctx.model, ctx.traffic, ctx.hw)
    return bound / (sum(calls) / len(calls)) * 100
