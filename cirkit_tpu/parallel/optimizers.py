"""Low-memory optimizers for HBM-bound parameter updates.

The flagship circuit's Adam update moves ~28 bytes of p/g/mu/nu HBM traffic
per parameter per step. Storing the Adam moments in bfloat16 cuts that to
~20 bytes (and the optimizer-state memory in half) while computing every
update in float32.

Plain round-to-nearest bf16 moments would *stall* the second-moment EMA:
``(1 - b2) = 1e-3`` relative increments fall below bf16's ~2^-8 relative
resolution, so ``nu`` stops moving once it is warm. Both moments are instead
written back with **stochastic rounding**, which is unbiased — the EMA is
preserved in expectation.

The rounding bits are the overhead to manage: XLA *materializes* the
generated bits to HBM, so their volume counts as traffic, and a u32 per
parameter would cost as many bytes as the bf16 moments save. The bits come
from the **rbg** PRNG, and one u16 draw serves both moments: mu adds the
bits as-is, nu adds a
multiplicative-hash scramble of them (a bijection on 16-bit values, so
both streams are marginally uniform and each cast stays unbiased; the
mu/nu rounding errors are correlated but individually tiny).

This is a new capability relative to the reference (which has no optimizer
story at all — training is user-land torch, SURVEY.md §3.5). The transform is
a drop-in ``optax.GradientTransformation``; pass it to :func:`fit` or
:func:`data_parallel_step` like any other optimizer, and it composes with the
ZeRO-1 state sharding (the moment leaves keep their leading fold axis). The
state holds only plain arrays (no typed PRNG keys), so npz/orbax checkpoints
round-trip it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from cirkit_tpu.utils.lazy import LazyModule

# call-time only (annotations are strings under future-annotations):
# deferred so package import stays off the time-to-first-batch bill
optax = LazyModule("optax", "optax", globals())

_LOW16 = jnp.uint32(0xFFFF)
_HIGH16 = jnp.uint32(0xFFFF0000)


def _sr_to_bf16(x: jnp.ndarray, rnd16: jnp.ndarray) -> jnp.ndarray:
    """Stochastically round a float32 array to bfloat16 using the provided
    random values (uint32, only the low 16 bits are used).

    Adds the random bits below the bf16 mantissa cut of the f32 bit pattern
    and truncates: values round up with probability proportional to the
    discarded fraction, so the cast is unbiased. Carries propagate into the
    exponent exactly when rounding up crosses a binade, which is the correct
    behavior. Sign-magnitude layout makes the same trick valid for negative
    values (rounding happens in magnitude, still unbiased).
    """
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    bits = (bits + (rnd16 & _LOW16)) & _HIGH16
    return jax.lax.bitcast_convert_type(bits, jnp.float32).astype(jnp.bfloat16)


def _rbg_bits16(seed: int, leaf_idx: int, count: jnp.ndarray, shape) -> jnp.ndarray:
    """One u16 of rounding entropy per element from the rbg PRNG (XLA's
    RngBitGenerator, cheaper per bit than threefry's hash rounds). The key
    is derived from (seed, leaf, step), so the state
    needs no key array and updates stay deterministic given the seed."""
    data = jnp.array([seed & 0xFFFFFFFF, leaf_idx, 0x5EEDB175, 0], jnp.uint32)
    data = data.at[3].set(count.astype(jnp.uint32))
    key = jax.random.wrap_key_data(data, impl="rbg")
    return jax.random.bits(key, shape, jnp.uint16).astype(jnp.uint32)


def _scramble16(rnd16: jnp.ndarray) -> jnp.ndarray:
    """An odd-multiplier hash: a bijection on 16-bit values, so a uniform
    input stays uniform — the second moment's rounding stream."""
    return (rnd16 * jnp.uint32(0x9E37)) & _LOW16


class LowMemAdamState(NamedTuple):
    count: jnp.ndarray  # () int32
    mu: optax.Updates  # first moment, ``state_dtype``
    nu: optax.Updates  # second moment, ``state_dtype``


def adam_lowmem(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    *,
    state_dtype=jnp.bfloat16,
    seed: int = 0,
) -> optax.GradientTransformation:
    """Adam with moments stored in ``state_dtype`` via stochastic rounding.

    Math is float32 throughout: moments are widened on read, the update is
    the standard bias-corrected Adam step, and the fresh moments are
    stochastically rounded on write. With ``state_dtype=float32`` this is
    exactly ``optax.adam`` (the rounding is skipped).
    """
    if state_dtype not in (jnp.bfloat16, jnp.float32):
        raise ValueError(f"state_dtype must be bfloat16 or float32, got {state_dtype}")
    lowmem = state_dtype == jnp.bfloat16

    def init(params):
        zeros = lambda p: jnp.zeros(jnp.shape(p), state_dtype)
        return LowMemAdamState(
            count=jnp.zeros([], jnp.int32),
            mu=jax.tree_util.tree_map(zeros, params),
            nu=jax.tree_util.tree_map(zeros, params),
        )

    def update(updates, state, params=None):
        del params
        count = state.count + 1
        leaves, treedef = jax.tree_util.tree_flatten(updates)
        mu_leaves = treedef.flatten_up_to(state.mu)
        nu_leaves = treedef.flatten_up_to(state.nu)

        bc1 = 1.0 - b1 ** count.astype(jnp.float32)
        bc2 = 1.0 - b2 ** count.astype(jnp.float32)

        new_updates, new_mu, new_nu = [], [], []
        for i, (g, mu, nu) in enumerate(zip(leaves, mu_leaves, nu_leaves)):
            g = g.astype(jnp.float32)
            mu_f = b1 * mu.astype(jnp.float32) + (1.0 - b1) * g
            nu_f = b2 * nu.astype(jnp.float32) + (1.0 - b2) * jnp.square(g)
            step = -learning_rate * (mu_f / bc1) / (jnp.sqrt(nu_f / bc2) + eps)
            new_updates.append(step)
            if lowmem:
                # one u16 per element serves both moments
                rnd = _rbg_bits16(seed, i, count, g.shape)
                new_mu.append(_sr_to_bf16(mu_f, rnd))
                new_nu.append(_sr_to_bf16(nu_f, _scramble16(rnd)))
            else:
                new_mu.append(mu_f)
                new_nu.append(nu_f)

        return (
            jax.tree_util.tree_unflatten(treedef, new_updates),
            LowMemAdamState(
                count=count,
                mu=jax.tree_util.tree_unflatten(treedef, new_mu),
                nu=jax.tree_util.tree_unflatten(treedef, new_nu),
            ),
        )

    return optax.GradientTransformation(init, update)
