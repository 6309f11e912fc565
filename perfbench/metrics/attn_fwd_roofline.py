"""Causal attention's training forward (``ops.flash_attention_train``)
against its bound at the cell's microbatch: the bound over the mean span,
on the device, of a profiler range around the entry's kernel wrapper
``flash_attention_train_cuda`` (from the first kernel launched inside it
to the end of the last), in percent. Kernels are not matched by name.
Where the program has no such wrapper there is no range to put, and the
metric reads nothing."""
import importlib

LABEL = "perfbench.attn_fwd"
MODULE = "repro_torch.kernels.flash_attention"
ATTR = "flash_attention_train_cuda"
RANGES = ([(LABEL, MODULE, ATTR)]
          if hasattr(importlib.import_module(MODULE), ATTR) else [])


def read(ctx):
    calls = (ctx.trace or {}).get("range_ms", {}).get(LABEL)
    if not calls or min(calls) <= 0:
        return None
    bound = ctx.counts("flash_attention_causal").microbatch_bound(
        "fwd", ctx.model, ctx.traffic, ctx.hw)
    return bound / (sum(calls) / len(calls)) * 100
