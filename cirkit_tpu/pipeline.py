"""The pipeline API: ambient compilation contexts and compiled-circuit operators.

Rebuild of ``cirkit/pipeline.py:22-363``: a context manager binding an
operator registry and a backend compiler, with compiled-circuit operator
wrappers (integrate/multiply/differentiate/conjugate/concatenate) that apply
the symbolic operator and recompile — parameters are shared with the operand
circuits through the compiler state (slot pointers into the same store).

Because the JAX backend is functional, the context additionally manages a
**parameter store**: ``ctx.parameters`` is the flat pytree holding every
compiled circuit's parameters, so a derived circuit evaluates against the
same store as its operands (the sharing the reference gets from
nn.Parameter aliasing).
"""

from __future__ import annotations

from contextlib import AbstractContextManager
from contextvars import ContextVar, Token
from types import TracebackType
from typing import Any, Callable

import jax

import cirkit_tpu.symbolic.functional as SF
from cirkit_tpu.backend.base import SUPPORTED_BACKENDS, AbstractCompiler
from cirkit_tpu.symbolic.circuit import Circuit
from cirkit_tpu.symbolic.layers import LayerOperator
from cirkit_tpu.symbolic.operators import LayerOperatorFunc
from cirkit_tpu.symbolic.registry import OperatorRegistry
from cirkit_tpu.utils.scope import Scope


def retrieve_compiler(backend: str, **backend_kwargs: Any) -> AbstractCompiler:
    """Instantiate a backend compiler by name."""
    if backend not in SUPPORTED_BACKENDS:
        raise NotImplementedError(f"Backend '{backend}' is not implemented")
    from cirkit_tpu.backend.jax.compiler import JaxCompiler

    return JaxCompiler(**backend_kwargs)


class PipelineContext(AbstractContextManager):
    """Compilation context: backend flags, rule-registration hooks, compiled
    circuit operators, and the shared parameter store."""

    def __init__(self, backend: str = "jax", *, seed: int = 42, **backend_kwargs: Any) -> None:
        if backend not in SUPPORTED_BACKENDS:
            raise NotImplementedError(f"Backend '{backend}' is not implemented")
        self._backend = backend
        self._backend_kwargs = backend_kwargs
        self._op_registry = OperatorRegistry.from_default_rules()
        self._compiler = retrieve_compiler(backend, **backend_kwargs)
        self._token: Token[PipelineContext] | None = None
        self._key = jax.random.PRNGKey(seed)
        self._parameters: dict[str, jax.Array] = {}

    @classmethod
    def from_default_backend(cls) -> "PipelineContext":
        """The default configuration: log-space, folded, optimized."""
        return PipelineContext(backend="jax", semiring="lse-sum", fold=True, optimize=True)

    # -- context management ----------------------------------------------------
    def __enter__(self) -> "PipelineContext":
        self._op_registry.__enter__()
        self._token = _PIPELINE_CONTEXT.set(self)
        return self

    def __exit__(
        self,
        exc_type: type[BaseException] | None,
        exc_value: BaseException | None,
        traceback: TracebackType | None,
    ) -> None:
        self._op_registry.__exit__(exc_type, exc_value, traceback)
        assert self._token is not None
        _PIPELINE_CONTEXT.reset(self._token)
        self._token = None

    def __getitem__(self, sc: Circuit):
        return self._compiler.get_compiled_circuit(sc)

    # -- extensibility hooks -----------------------------------------------------
    def add_operator_rule(self, op: LayerOperator, func: LayerOperatorFunc) -> None:
        self._op_registry.add_rule(op, func)

    def add_layer_compilation_rule(self, func: Callable) -> None:
        self._compiler.add_layer_rule(func)

    def add_parameter_compilation_rule(self, func: Callable) -> None:
        self._compiler.add_parameter_rule(func)

    def add_initializer_compilation_rule(self, func: Callable) -> None:
        self._compiler.add_initializer_rule(func)

    def add_layer_optimization_rule(self, pattern, func: Callable, *, shatter: bool = False) -> None:
        """Register a layer-graph fusion/shatter rewrite with the backend
        compiler (ref: ``backend/torch/optimization/registry.py:1-50``)."""
        self._compiler.add_layer_optimization_rule(pattern, func, shatter=shatter)

    def add_parameter_optimization_rule(self, pattern, func: Callable) -> None:
        """Register a parameter-graph rewrite with the backend compiler."""
        self._compiler.add_parameter_optimization_rule(pattern, func)

    # -- compilation + parameter store ----------------------------------------------
    def compile(self, sc: Circuit):
        """Compile a symbolic circuit and initialize its new parameters into
        the context's shared store. Operand circuits compiled implicitly by
        the pipeline ordering are materialized too."""
        cc = self._compiler.compile(sc)
        for compiled in getattr(self._compiler, "_compiled_circuits")._fwd.values():
            self._materialize(compiled)
        return cc

    def _materialize(self, cc) -> None:
        missing = [s for s in cc.slots if s not in self._parameters]
        if missing:
            self._key, sub = jax.random.split(self._key)
            fresh = cc.initialize(sub)
            self._parameters.update({s: fresh[s] for s in missing})
        # Bind the shared store so circuits are callable as ``cc(x)``.
        cc.default_store = self._parameters

    @property
    def parameters(self) -> dict[str, jax.Array]:
        """The shared parameter store (a flat pytree: slot name -> array)."""
        return self._parameters

    def update_parameters(self, store: dict[str, jax.Array]) -> None:
        """Write back a trained store (e.g. from an optax loop)."""
        self._parameters.update(store)
        for cc in getattr(self._compiler, "_compiled_circuits")._fwd.values():
            cc.default_store = self._parameters

    def reset_parameters(self, seed: int | None = None) -> None:
        """Reinitialize every compiled circuit's parameters."""
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        self._parameters.clear()
        for cc in list(getattr(self._compiler, "_compiled_circuits")._fwd.values()):
            self._materialize(cc)

    def is_compiled(self, sc: Circuit) -> bool:
        return self._compiler.is_compiled(sc)

    def has_symbolic(self, cc) -> bool:
        return self._compiler.has_symbolic(cc)

    def get_compiled_circuit(self, sc: Circuit):
        return self._compiler.get_compiled_circuit(sc)

    def get_symbolic_circuit(self, cc) -> Circuit:
        return self._compiler.get_symbolic_circuit(cc)

    # -- compiled-circuit operators ---------------------------------------------
    def _symbolic_operand(self, cc, which: str = "The given"):
        if not self._compiler.has_symbolic(cc):
            raise ValueError(f"{which} compiled circuit is not known in this pipeline")
        return self._compiler.get_symbolic_circuit(cc)

    def concatenate(self, *cc):
        scs = [self._symbolic_operand(c, f"The {i}-th") for i, c in enumerate(cc)]
        return self.compile(SF.concatenate(scs, registry=self._op_registry))

    def integrate(self, cc, scope: Scope | None = None):
        sc = self._symbolic_operand(cc)
        return self.compile(SF.integrate(sc, scope=scope, registry=self._op_registry))

    def mixture(self, *cc, weights=None, weight_factory=None, em_ready=False):
        scs = [self._symbolic_operand(c, f"The {i}-th") for i, c in enumerate(cc)]
        return self.compile(
            SF.mixture(
                scs,
                weights=weights,
                weight_factory=weight_factory,
                em_ready=em_ready,
                registry=self._op_registry,
            )
        )

    def multiply(self, cc1, cc2):
        sc1 = self._symbolic_operand(cc1, "The first")
        sc2 = self._symbolic_operand(cc2, "The second")
        return self.compile(SF.multiply(sc1, sc2, registry=self._op_registry))

    def differentiate(self, cc, *, order: int = 1):
        if order <= 0:
            raise ValueError("The order of differentiation must be positive")
        sc = self._symbolic_operand(cc)
        return self.compile(SF.differentiate(sc, order=order, registry=self._op_registry))

    def conjugate(self, cc):
        sc = self._symbolic_operand(cc)
        return self.compile(SF.conjugate(sc, registry=self._op_registry))


# -- module-level functional API with an ambient default context ----------------


# pylint: disable-next=redefined-builtin
def compile(sc: Circuit, ctx: PipelineContext | None = None):
    if ctx is None:
        ctx = _PIPELINE_CONTEXT.get()
    return ctx.compile(sc)


def concatenate(*cc, ctx: PipelineContext | None = None):
    if ctx is None:
        ctx = _PIPELINE_CONTEXT.get()
    return ctx.concatenate(*cc)


def integrate(cc, scope: Scope | None = None, ctx: PipelineContext | None = None):
    if ctx is None:
        ctx = _PIPELINE_CONTEXT.get()
    return ctx.integrate(cc, scope=scope)


def multiply(cc1, cc2, ctx: PipelineContext | None = None):
    if ctx is None:
        ctx = _PIPELINE_CONTEXT.get()
    return ctx.multiply(cc1, cc2)


def mixture(
    *cc,
    weights=None,
    weight_factory=None,
    em_ready=False,
    ctx: PipelineContext | None = None,
):
    if ctx is None:
        ctx = _PIPELINE_CONTEXT.get()
    return ctx.mixture(
        *cc, weights=weights, weight_factory=weight_factory, em_ready=em_ready
    )


def differentiate(cc, ctx: PipelineContext | None = None, *, order: int = 1):
    if ctx is None:
        ctx = _PIPELINE_CONTEXT.get()
    return ctx.differentiate(cc, order=order)


def conjugate(cc, ctx: PipelineContext | None = None):
    if ctx is None:
        ctx = _PIPELINE_CONTEXT.get()
    return ctx.conjugate(cc)


_PIPELINE_CONTEXT: ContextVar[PipelineContext] = ContextVar(
    "_PIPELINE_CONTEXT", default=PipelineContext.from_default_backend()
)
"""The ambient pipeline context, swapped by entering a context."""
