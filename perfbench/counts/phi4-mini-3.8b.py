"""Model FLOPs of one training step of a dense GQA + SwiGLU stack with a
tied head: 6 per matmul parameter and token (forward and backward), plus
the attention scores and their product with V (4 S^2 hd a head forward,
three times that with the backward), unmasked; no recompute counted."""


def matmul_params(m) -> int:
    d, H, K, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    attn = d * H * hd + 2 * d * K * hd + H * hd * d
    mlp = 3 * d * m["d_ff"]
    head = m["vocab_size"] * d          # the tied table, as the unembedding
    return m["num_layers"] * (attn + mlp) + head


def step_flops(m, t) -> float:
    B, S = t["global_batch"], t["seq_len"]
    L, H, hd = m["num_layers"], m["num_heads"], m["head_dim"]
    return 6 * B * S * matmul_params(m) + 12 * L * B * S * S * H * hd
