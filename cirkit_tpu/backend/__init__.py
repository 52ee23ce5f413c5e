"""Backends: compilers lowering the symbolic IR to executable plans.

The JAX/XLA backend (``cirkit_tpu.backend.jax``) is the compute path;
compiled circuits are static jitted evaluation plans over a parameter
store pytree.
"""

from cirkit_tpu.backend.base import SUPPORTED_BACKENDS, AbstractCompiler
