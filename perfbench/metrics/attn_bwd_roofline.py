"""Causal attention's backward against its bound at the cell's
microbatch, as ``attn_fwd_roofline`` reads the forward: a profiler range
around ``flash_attention_backward_cuda`` (all its launches). Reads
nothing where the program has no such wrapper."""
import importlib

LABEL = "perfbench.attn_bwd"
MODULE = "repro_torch.kernels.flash_attention"
ATTR = "flash_attention_backward_cuda"
RANGES = ([(LABEL, MODULE, ATTR)]
          if hasattr(importlib.import_module(MODULE), ATTR) else [])


def read(ctx):
    calls = (ctx.trace or {}).get("range_ms", {}).get(LABEL)
    if not calls or min(calls) <= 0:
        return None
    bound = ctx.counts("flash_attention_causal").microbatch_bound(
        "bwd", ctx.model, ctx.traffic, ctx.hw)
    return bound / (sum(calls) / len(calls)) * 100
