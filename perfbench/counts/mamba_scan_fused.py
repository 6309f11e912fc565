"""The bound of one call of the fused Mamba scan (``ops.mamba_scan_fused``)
and of its backward, at a microbatch of B rows of S tokens, D channels, N
states and dt rank r: the larger of its bytes over the memory rate and its
special-function results (ex2, lg2, rcp, rsqrt) over their peak. Each input
is read and each output written once. Forward: xin, dt_pre, z read and y
written (B, S, D), Bc and Cc read, the (D,) and (D, N) params; one ex2 a
state element, softplus's and silu's four a (b, t, d), A's exp a (d, n).
Backward: gy, xin, dt_pre, z read and dxin, ddt_pre, dz written, proj read
and dproj written, the params and their gradients; the same results but
A's."""


def bound(direction: str, B: int, S: int, D: int, N: int, r: int,
          elem_bytes: int, hw) -> dict:
    e = elem_bytes
    if direction == "fwd":
        nbytes = e * (4 * B * S * D + 2 * N * B * S) + 4 * (2 * D + D * N)
        results = B * S * D * N + 4 * B * S * D + D * N
    elif direction == "bwd":
        nbytes = e * (7 * B * S * D + 2 * B * S * (r + 2 * N)) + 8 * (2 * D + D * N)
        results = B * S * D * N + 4 * B * S * D
    else:
        raise ValueError(direction)
    bytes_ms = nbytes / hw["hbm_bytes_per_s"] * 1e3
    sfu_ms = results / (hw["sfu_results_per_sm_clock"] * hw["sms"]
                        * hw["sm_clock_hz"]) * 1e3
    return {"bytes": nbytes, "results": results, "bytes_ms": bytes_ms,
            "results_ms": sfu_ms, "bound_ms": max(bytes_ms, sfu_ms),
            "bound_by": "bytes" if bytes_ms >= sfu_ms else "operations"}


def microbatch_bound(direction: str, m, t, hw) -> float:
    e = {"bfloat16": 2, "float16": 2, "float32": 4}[m["dtype"]]
    return bound(direction, t["global_batch"] // t["microbatches"],
                 t["seq_len"], m["d_inner"], m["ssm_state"], m["dt_rank"],
                 e, hw)["bound_ms"]
