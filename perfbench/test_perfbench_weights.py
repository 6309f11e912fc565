"""The init rules of ``weights.make`` against their closed forms."""
import torch

import weights


def test_fan_in_at_scales_stacked_experts_by_one_dim():
    """``fan_in_at 1`` scales ``(E, d, ff)`` by d^-1/2 and ``(E, ff, d)`` by
    ff^-1/2, as the port's MoE init does; ``fan_in 1`` would take E."""
    E, d, ff = 4, 6, 10
    shapes = weights.tree_from_shapes({"ffn.down": (E, ff, d),
                                       "ffn.gate": (E, d, ff)})
    rules = {"*": ["fan_in_at", 1]}
    params, flat = weights.make(shapes, rules, 2**31 + 7, "cpu")
    gen = torch.Generator().manual_seed(2**31 + 7)
    draw = torch.empty(flat.numel()).normal_(generator=gen)
    n, at = E * d * ff, weights.ALIGN * 4     # 240 elements a leaf, 256 apart
    assert torch.equal(params["ffn"]["down"],
                       draw[:n].view(E, ff, d) * ff ** -0.5)
    assert torch.equal(params["ffn"]["gate"],
                       draw[at:at + n].view(E, d, ff) * d ** -0.5)
    by_e, _ = weights.make(shapes, {"*": ["fan_in", 1]}, 2**31 + 7, "cpu")
    assert not torch.equal(by_e["ffn"]["gate"], params["ffn"]["gate"])
