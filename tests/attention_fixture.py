"""A phi4-mini-shaped causal attention and its gradients as the JAX
reference computes them, stored so that the card tests, which run where
JAX is not installed, hold the training kernels against the reference
itself.

The inputs come from an integer hash (:func:`inputs`): multiples of 1/64
in [-2, 2), exact in bf16 and the same bits on every machine. The stored
result is ``jax.vjp`` of ``repro/models/attention.py``'s ``_sdpa`` under
its causal mask, in float32 on those inputs: the output and dq, dk, dv for
the cotangent ``dout``, kept in float16 (``DATA``). Regenerate it with

    PYTHONPATH=src python tests/attention_fixture.py

and ``tests/test_torch_flash_attention_train.py`` checks on every CPU run
that the file still holds what JAX gives.
"""
from pathlib import Path
from typing import Dict

import numpy as np

# (B, S, H, K, hd): phi4-mini's head size and group of 3; S spans three
# 64-row tiles, the last ragged.
SHAPE = (1, 130, 6, 2, 128)
DATA = Path(__file__).resolve().parent / "data" / "flash_attention_train_jax.npz"


def _hashed(shape, salt: int) -> np.ndarray:
    """SplitMix64 of each element's index (uint64 arithmetic wraps), its
    top 8 bits as a multiple of 1/64 in [-2, 2)."""
    u = np.uint64
    z = np.arange(int(np.prod(shape)), dtype=u) + u(salt * 0x9E3779B97F4A7C15 % 2**64)
    z = (z ^ (z >> u(30))) * u(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> u(27))) * u(0x94D049BB133111EB)
    z = z ^ (z >> u(31))
    return ((z >> u(56)).astype(np.float32) - 128.0).reshape(shape) / 64.0


def inputs() -> Dict[str, np.ndarray]:
    """q, dout ``(B, S, H, hd)`` and k, v ``(B, S, K, hd)``, float32."""
    B, S, H, K, hd = SHAPE
    return {"q": _hashed((B, S, H, hd), 1), "k": _hashed((B, S, K, hd), 2),
            "v": _hashed((B, S, K, hd), 3),
            "dout": _hashed((B, S, H, hd), 4) / 4}


def jax_result(x: Dict[str, np.ndarray], window: int = 0) -> Dict[str, np.ndarray]:
    """``jax.vjp`` of the reference's ``_sdpa`` (causal, with ``window`` a
    sliding window too) at float32: out, dq, dk, dv."""
    import jax
    import jax.numpy as jnp

    from repro.models.attention import _sdpa, causal_window_mask

    S = x["q"].shape[1]
    mask = causal_window_mask(S, S, window)
    out, vjp = jax.vjp(lambda q, k, v: _sdpa(q, k, v, mask=mask),
                       *(jnp.asarray(x[n]) for n in "qkv"))
    dq, dk, dv = vjp(jnp.asarray(x["dout"]))
    return {n: np.asarray(t, dtype=np.float32)
            for n, t in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv))}


def load() -> Dict[str, np.ndarray]:
    with np.load(DATA) as f:
        return {n: f[n].astype(np.float32) for n in ("out", "dq", "dk", "dv")}


if __name__ == "__main__":
    DATA.parent.mkdir(exist_ok=True)
    np.savez(DATA, **{n: t.astype(np.float16)
                      for n, t in jax_result(inputs()).items()})
    print(f"wrote {DATA}")
