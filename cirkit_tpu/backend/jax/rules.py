"""Default compilation rules: symbolic nodes -> compiled JAX nodes.

Rebuild of ``cirkit/backend/torch/rules/`` (layers.py, parameters.py,
initializers.py): three type-keyed tables mapping every symbolic layer,
parameter node and initializer to its compiled form. Users register rules
for new symbolic types through the PipelineContext without touching the core.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np

from cirkit_tpu.backend.jax import layers as jl
from cirkit_tpu.backend.jax import parameters as jp
from cirkit_tpu.backend.jax.utils import (
    default_complex_dtype,
    default_int_dtype,
    default_real_dtype,
)
from cirkit_tpu.symbolic import initializers as syi
from cirkit_tpu.symbolic import layers as syl
from cirkit_tpu.symbolic import parameters as syp
from cirkit_tpu.symbolic.dtypes import DataType

if TYPE_CHECKING:
    from cirkit_tpu.backend.jax.compiler import JaxCompiler


def compiled_dtype(dtype: DataType):
    if dtype == DataType.INTEGER:
        return default_int_dtype()
    if dtype == DataType.COMPLEX:
        return default_complex_dtype()
    return default_real_dtype()


# --------------------------------------------------------------------------- #
# Initializer rules: symbolic Initializer -> InitFn(key, shape, dtype)
# --------------------------------------------------------------------------- #


def compile_constant_tensor_initializer(
    compiler: "JaxCompiler", init: syi.ConstantTensorInitializer
) -> jp.InitFn:
    value = init.value

    def _init(key, shape, dtype):
        return jnp.broadcast_to(jnp.asarray(value, dtype=dtype), shape)

    _init.constant = np.asarray(value)
    return _init


def compile_uniform_initializer(
    compiler: "JaxCompiler", init: syi.UniformInitializer
) -> jp.InitFn:
    a, b = init.a, init.b

    def _init(key, shape, dtype):
        return jax.random.uniform(key, shape, dtype=dtype, minval=a, maxval=b)

    def _host(rng, shape, dtype):
        np_dtype = np.dtype(dtype)
        if np_dtype == np.float32 or np_dtype == np.float64:
            # draw in the target dtype: float64 draws + astype dominate the
            # build time of big folded circuits (hundreds of M parameters)
            u = rng.random(size=shape, dtype=np_dtype)
            return u * np_dtype.type(b - a) + np_dtype.type(a)
        return rng.uniform(a, b, size=shape).astype(np_dtype)

    _init.batch_key = ("uniform", a, b)
    _init.host = _host
    return _init


def compile_normal_initializer(
    compiler: "JaxCompiler", init: syi.NormalInitializer
) -> jp.InitFn:
    mean, stddev = init.mean, init.stddev

    def _init(key, shape, dtype):
        if jnp.issubdtype(dtype, jnp.complexfloating):
            real_dt = jnp.finfo(dtype).dtype
            re = jax.random.normal(key, shape, dtype=real_dt)
            im = jax.random.normal(jax.random.fold_in(key, 1), shape, dtype=real_dt)
            return (re + 1j * im).astype(dtype) * stddev + mean
        return jax.random.normal(key, shape, dtype=dtype) * stddev + mean

    def _host(rng, shape, dtype):
        np_dtype = np.dtype(dtype)
        if np.issubdtype(np_dtype, np.complexfloating):
            re = rng.normal(size=shape)
            im = rng.normal(size=shape)
            return ((re + 1j * im) * stddev + mean).astype(np_dtype)
        if np_dtype == np.float32 or np_dtype == np.float64:
            out = rng.standard_normal(size=shape, dtype=np_dtype)
            if stddev != 1.0:
                out *= np_dtype.type(stddev)
            if mean != 0.0:
                out += np_dtype.type(mean)
            return out
        return (rng.normal(size=shape) * stddev + mean).astype(np_dtype)

    _init.batch_key = ("normal", mean, stddev)
    _init.host = _host
    return _init


def compile_dirichlet_initializer(
    compiler: "JaxCompiler", init: syi.DirichletInitializer
) -> jp.InitFn:
    alpha, axis = init.alpha, init.axis

    def _init(key, shape, dtype):
        ax = axis if axis >= 0 else axis + len(shape)
        if not isinstance(alpha, list) and float(alpha) == 1.0:
            # Dirichlet(1, ..., 1) = normalized exponentials (-log U). The
            # general path's gamma rejection sampler compiles a while-loop
            # program over every element at flagship sizes; this is exact
            # for the default alpha.
            u = jax.random.uniform(key, shape, dtype=dtype, minval=jnp.finfo(dtype).tiny)
            e = -jnp.log(u)
            return e / jnp.sum(e, axis=ax, keepdims=True)
        k = shape[ax]
        a = jnp.full((k,), alpha, dtype=dtype) if not isinstance(alpha, list) else jnp.asarray(
            alpha, dtype=dtype
        )
        batch_shape = shape[:ax] + shape[ax + 1 :]
        sample = jax.random.dirichlet(key, a, shape=batch_shape, dtype=dtype)
        return jnp.moveaxis(sample, -1, ax)

    def _host(rng, shape, dtype):
        ax = axis if axis >= 0 else axis + len(shape)
        k = shape[ax]
        a = np.asarray(alpha if isinstance(alpha, list) else [alpha] * k, dtype=float)
        batch_shape = shape[:ax] + shape[ax + 1 :]
        sample = rng.dirichlet(a, size=batch_shape)
        return np.moveaxis(sample, -1, ax).astype(np.dtype(dtype))

    _init.host = _host
    if axis < 0:
        # Negative axes resolve identically on the fold-extended shape, so a
        # single (F, ...) draw is valid for the batched-init fast path.
        alpha_key = tuple(alpha) if isinstance(alpha, list) else alpha
        _init.batch_key = ("dirichlet", alpha_key, axis)
    return _init


DEFAULT_INITIALIZER_COMPILATION_RULES = [
    compile_constant_tensor_initializer,
    compile_uniform_initializer,
    compile_normal_initializer,
    compile_dirichlet_initializer,
]


# --------------------------------------------------------------------------- #
# Parameter node rules: symbolic ParameterNode -> JaxParameterNode
# --------------------------------------------------------------------------- #


def compile_tensor_parameter(
    compiler: "JaxCompiler", p: syp.TensorParameter
) -> jp.JaxParameterNode:
    state = compiler.state
    if state.has_parameter(p):
        # The same symbolic tensor already has a slot: share it via a pointer.
        slot, positions = state.lookup(p)
        return jp.JaxPointerSlot(
            slot, p.shape, fold_idx=np.asarray(positions), learnable=p.learnable
        )
    init_fn = compiler.compile_initializer(p)
    slot = state.alloc_slot()
    node = jp.JaxTensorSlot(
        slot,
        p.shape,
        dtype=compiled_dtype(p.dtype),
        learnable=p.learnable,
        inits=[init_fn],
        origins=[p],
    )
    state.register(p, slot)
    return node


def compile_reference_parameter(
    compiler: "JaxCompiler", p: syp.ReferenceParameter
) -> jp.JaxParameterNode:
    slot, positions = compiler.state.lookup(p.deref())
    return jp.JaxPointerSlot(
        slot,
        p.shape,
        fold_idx=np.asarray(positions),
        learnable=getattr(p.deref(), "learnable", False),
    )


def _unary(cls):
    def rule(compiler: "JaxCompiler", p: syp.UnaryParameterOp) -> jp.JaxParameterNode:
        return cls(*p.in_shapes)

    return rule


def compile_index_parameter(compiler, p: syp.IndexParameter) -> jp.JaxParameterNode:
    return jp.JaxIndexParameter(*p.in_shapes, indices=p.indices, axis=p.axis)


def compile_scaled_sigmoid_parameter(
    compiler, p: syp.ScaledSigmoidParameter
) -> jp.JaxParameterNode:
    return jp.JaxScaledSigmoidParameter(*p.in_shapes, vmin=p.vmin, vmax=p.vmax)


def compile_clamp_parameter(compiler, p: syp.ClampParameter) -> jp.JaxParameterNode:
    return jp.JaxClampParameter(*p.in_shapes, vmin=p.vmin, vmax=p.vmax)


def compile_polynomial_differential(
    compiler, p: syp.PolynomialDifferential
) -> jp.JaxParameterNode:
    return jp.JaxPolynomialDifferential(*p.in_shapes, order=p.order)


def _axis_op(cls):
    def rule(compiler: "JaxCompiler", p) -> jp.JaxParameterNode:
        return cls(*p.in_shapes, axis=p.axis)

    return rule


_SIMPLE_PARAM_RULES: dict[type, type] = {
    syp.SumParameter: jp.JaxSumParameter,
    syp.HadamardParameter: jp.JaxHadamardParameter,
    syp.KroneckerParameter: jp.JaxKroneckerParameter,
    syp.ExpParameter: jp.JaxExpParameter,
    syp.LogParameter: jp.JaxLogParameter,
    syp.SquareParameter: jp.JaxSquareParameter,
    syp.SoftplusParameter: jp.JaxSoftplusParameter,
    syp.SigmoidParameter: jp.JaxSigmoidParameter,
    syp.ConjugateParameter: jp.JaxConjugateParameter,
    syp.MixingWeightParameter: jp.JaxMixingWeightParameter,
    syp.GaussianProductMean: jp.JaxGaussianProductMean,
    syp.GaussianProductStddev: jp.JaxGaussianProductStddev,
    syp.GaussianProductLogPartition: jp.JaxGaussianProductLogPartition,
    syp.PolynomialProduct: jp.JaxPolynomialProduct,
}

_AXIS_PARAM_RULES: dict[type, type] = {
    syp.OuterProductParameter: jp.JaxOuterProductParameter,
    syp.OuterSumParameter: jp.JaxOuterSumParameter,
    syp.ReduceSumParameter: jp.JaxReduceSumParameter,
    syp.ReduceProductParameter: jp.JaxReduceProductParameter,
    syp.ReduceLSEParameter: jp.JaxReduceLSEParameter,
    syp.SoftmaxParameter: jp.JaxSoftmaxParameter,
    syp.LogSoftmaxParameter: jp.JaxLogSoftmaxParameter,
}


def default_parameter_rules() -> dict[type, object]:
    rules: dict[type, object] = {
        syp.TensorParameter: compile_tensor_parameter,
        syp.ConstantParameter: compile_tensor_parameter,
        syp.ReferenceParameter: compile_reference_parameter,
        syp.IndexParameter: compile_index_parameter,
        syp.ScaledSigmoidParameter: compile_scaled_sigmoid_parameter,
        syp.ClampParameter: compile_clamp_parameter,
        syp.PolynomialDifferential: compile_polynomial_differential,
    }
    for sym_cls, jax_cls in _SIMPLE_PARAM_RULES.items():
        rules[sym_cls] = (
            lambda compiler, p, _cls=jax_cls: _cls(*p.in_shapes)
        )
    for sym_cls, jax_cls in _AXIS_PARAM_RULES.items():
        rules[sym_cls] = (
            lambda compiler, p, _cls=jax_cls: _cls(*p.in_shapes, axis=p.axis)
        )
    return rules


# --------------------------------------------------------------------------- #
# Layer rules: symbolic Layer -> JaxLayer
# --------------------------------------------------------------------------- #


def _scope_idx(sl: syl.InputLayer) -> np.ndarray:
    return np.asarray([sorted(sl.scope)], dtype=np.int32)


def compile_categorical_layer(compiler: "JaxCompiler", sl: syl.CategoricalLayer) -> jl.JaxLayer:
    probs = None if sl.probs is None else compiler.compile_parameter(sl.probs)
    logits = None if sl.logits is None else compiler.compile_parameter(sl.logits)
    return jl.JaxCategoricalLayer(
        _scope_idx(sl),
        sl.num_output_units,
        num_categories=sl.num_categories,
        probs=probs,
        logits=logits,
        semiring=compiler.semiring,
    )


def compile_embedding_layer(compiler: "JaxCompiler", sl: syl.EmbeddingLayer) -> jl.JaxLayer:
    return jl.JaxEmbeddingLayer(
        _scope_idx(sl),
        sl.num_output_units,
        num_states=sl.num_states,
        weight=compiler.compile_parameter(sl.weight),
        semiring=compiler.semiring,
    )


def compile_binomial_layer(compiler: "JaxCompiler", sl: syl.BinomialLayer) -> jl.JaxLayer:
    probs = None if sl.probs is None else compiler.compile_parameter(sl.probs)
    logits = None if sl.logits is None else compiler.compile_parameter(sl.logits)
    return jl.JaxBinomialLayer(
        _scope_idx(sl),
        sl.num_output_units,
        total_count=sl.total_count,
        probs=probs,
        logits=logits,
        semiring=compiler.semiring,
    )


def compile_gaussian_layer(compiler: "JaxCompiler", sl: syl.GaussianLayer) -> jl.JaxLayer:
    log_partition = (
        None if sl.log_partition is None else compiler.compile_parameter(sl.log_partition)
    )
    return jl.JaxGaussianLayer(
        _scope_idx(sl),
        sl.num_output_units,
        mean=compiler.compile_parameter(sl.mean),
        stddev=compiler.compile_parameter(sl.stddev),
        log_partition=log_partition,
        semiring=compiler.semiring,
    )


def compile_polynomial_layer(compiler: "JaxCompiler", sl: syl.PolynomialLayer) -> jl.JaxLayer:
    return jl.JaxPolynomialLayer(
        _scope_idx(sl),
        sl.num_output_units,
        degree=sl.degree,
        coeff=compiler.compile_parameter(sl.coeff),
        semiring=compiler.semiring,
    )


def compile_constant_value_layer(
    compiler: "JaxCompiler", sl: syl.ConstantValueLayer
) -> jl.JaxLayer:
    return jl.JaxConstantValueLayer(
        sl.num_output_units,
        log_space=sl.log_space,
        value=compiler.compile_parameter(sl.value),
        semiring=compiler.semiring,
    )


def compile_evidence_layer(compiler: "JaxCompiler", sl: syl.EvidenceLayer) -> jl.JaxLayer:
    inner = compiler.compile_layer_node(sl.layer)
    return jl.JaxEvidenceLayer(
        inner,
        observation=compiler.compile_parameter(sl.observation),
        semiring=compiler.semiring,
    )


def compile_hadamard_layer(compiler: "JaxCompiler", sl: syl.HadamardLayer) -> jl.JaxLayer:
    return jl.JaxHadamardLayer(
        sl.num_input_units, arity=sl.arity, semiring=compiler.semiring
    )


def compile_kronecker_layer(compiler: "JaxCompiler", sl: syl.KroneckerLayer) -> jl.JaxLayer:
    return jl.JaxKroneckerLayer(
        sl.num_input_units, arity=sl.arity, semiring=compiler.semiring
    )


def compile_sum_layer(compiler: "JaxCompiler", sl: syl.SumLayer) -> jl.JaxLayer:
    return jl.JaxSumLayer(
        sl.num_input_units,
        sl.num_output_units,
        arity=sl.arity,
        weight=compiler.compile_parameter(sl.weight),
        semiring=compiler.semiring,
    )


DEFAULT_LAYER_COMPILATION_RULES = [
    compile_categorical_layer,
    compile_embedding_layer,
    compile_binomial_layer,
    compile_gaussian_layer,
    compile_polynomial_layer,
    compile_constant_value_layer,
    compile_evidence_layer,
    compile_hadamard_layer,
    compile_kronecker_layer,
    compile_sum_layer,
]
