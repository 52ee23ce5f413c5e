"""cirkit-tpu: a JAX probabilistic-circuit and tensor-network framework.

A from-scratch JAX/XLA rebuild with the capabilities of
april-tools/cirkit: a symbolic circuit IR, a rule-based compiler that lowers
circuits to folded, jit-compiled evaluation plans under pluggable semirings,
tractable circuit operators (integrate / multiply / differentiate /
conjugate), region-graph and tensor-factorization templates, and
data- and tensor-parallel training over device meshes.
"""

__version__ = "0.1.1"

from cirkit_tpu import models, ops, parallel, symbolic, utils  # noqa: E402,F401
from cirkit_tpu.pipeline import (  # noqa: E402,F401
    PipelineContext,
    compile,
    concatenate,
    conjugate,
    differentiate,
    integrate,
    mixture,
    multiply,
)

__all__ = [
    "PipelineContext",
    "compile",
    "concatenate",
    "conjugate",
    "differentiate",
    "integrate",
    "mixture",
    "multiply",
    "models",
    "ops",
    "parallel",
    "symbolic",
    "utils",
]
