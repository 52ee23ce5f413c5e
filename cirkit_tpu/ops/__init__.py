"""The log-einsum-exp contractions of the circuit hot path."""

from cirkit_tpu.ops.lse_einsum import (
    lse_matmul,
    lse_matmul_softmax,
    lse_tucker2,
    lse_tucker2_softmax,
)

__all__ = [
    "lse_matmul",
    "lse_matmul_softmax",
    "lse_tucker2",
    "lse_tucker2_softmax",
]
