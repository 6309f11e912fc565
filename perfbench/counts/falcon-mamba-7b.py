"""Model FLOPs of one training step of a Mamba-1 stack with an untied
head: 6 per matmul parameter and token (in_proj, x_proj, dt_proj,
out_proj a layer, and the head); the conv, the scan and the elementwise
work are not matmuls and are not counted; no recompute counted."""


def matmul_params(m) -> int:
    d, di, n, r = m["d_model"], m["d_inner"], m["ssm_state"], m["dt_rank"]
    layer = d * 2 * di + di * (r + 2 * n) + r * di + di * d
    head = 0 if m["tie_embeddings"] else m["vocab_size"] * d
    return m["num_layers"] * layer + head


def step_flops(m, t) -> float:
    return 6 * t["global_batch"] * t["seq_len"] * matmul_params(m)
