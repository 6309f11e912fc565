"""The bounds of causal attention's training forward and backward
(``counts/flash_attention_causal.py``) at the cells' shapes."""
import pytest

import harness

CELL = "phi4-mini.train.b8s2048"


def _module():
    spec = harness.load_spec(CELL)
    return spec, harness.counts_module(spec, "flash_attention_causal")


@pytest.mark.parametrize("S,window", [(1, 0), (2, 0), (33, 0), (33, 1),
                                      (33, 5), (33, 32), (33, 33), (40, 64)])
def test_attention_kept_pairs_match_the_mask(S, window):
    """The causal (and sliding-window) mask counted pair by pair."""
    _, mod = _module()
    want = sum(1 for i in range(S) for j in range(S)
               if j <= i and (window <= 0 or i - j < window))
    assert mod.kept_pairs(S, window) == want


@pytest.mark.parametrize("direction,flops,bound_ms", [
    ("fwd", 51_564_773_376, 0.0521383), ("bwd", 128_911_933_440, 0.1303457),
])
def test_attention_bound_at_the_cells_microbatch(direction, flops, bound_ms):
    """phi4-mini's microbatch: B=2, H=24, hd 128, S=2048 causal."""
    spec, mod = _module()
    b = mod.bound(direction, 2, 2048, 24, 128, 0, spec.hw)
    assert b["pairs"] == 2048 * 2049 // 2
    assert b["flops"] == flops
    assert b["bound_ms"] == pytest.approx(bound_ms, rel=1e-5)
    assert b["bound_by"] == "operations"
    assert mod.microbatch_bound(direction, harness.reference_model(spec),
                                spec.traffic, spec.hw) == b["bound_ms"]
