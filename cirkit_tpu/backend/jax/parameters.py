"""Compiled parameter graphs for the JAX backend.

Rebuild of ``cirkit/backend/torch/parameters/nodes.py`` and
``parameter.py``, redesigned functionally: a compiled parameter node is a
pure function from the **parameter store** (a flat pytree mapping slot names
to ``(F, ...)`` arrays) and its compiled inputs to a ``(F, ...)`` array.
Evaluating a parameter graph is jit-traced into the consuming layer, where
the tiny reparameterization ops (softmax, exp, clamp) fuse into the layer's
einsum under XLA.

Every node carries a leading fold dimension F. Folding a group of
structurally-identical graphs concatenates along F (see
``cirkit_tpu/backend/jax/folding.py``).
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from collections.abc import Callable, Mapping, Sequence
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from cirkit_tpu.backend.jax.utils import csafelog, safelog
from cirkit_tpu.utils.algorithms import RootedDiAcyclicGraph


def _host_init() -> bool:
    """Whether to initialize parameters on the host in numpy.

    Host init avoids all init-time XLA programs — on CPU one eager
    jax.random call per slot costs a compile each, so numpy wins there. On
    accelerators the flagship stores run to GBs, and generating them on
    the device under one jitted program saves the host draw and the upload
    (CIRKIT_TPU_HOST_INIT=1 / CIRKIT_TPU_DEVICE_INIT=1 override)."""
    if os.environ.get("CIRKIT_TPU_HOST_INIT"):
        return True
    if os.environ.get("CIRKIT_TPU_DEVICE_INIT"):
        return False
    import jax as _jax

    return _jax.default_backend() == "cpu"


Shape = tuple[int, ...]
Store = Mapping[str, jnp.ndarray]

# An initializer: (key, shape, dtype) -> array. Constant initializers ignore
# the key (and accept key=None).
InitFn = Callable[[jax.Array | None, Shape, Any], jnp.ndarray]


class JaxParameterNode(ABC):
    """A node of a compiled parameter graph."""

    def __init__(self, *, num_folds: int = 1):
        self.num_folds = num_folds

    @property
    @abstractmethod
    def shape(self) -> Shape:
        """The per-fold output shape."""

    @property
    @abstractmethod
    def config(self) -> dict[str, Any]:
        """Constructor arguments (used by folding to rebuild the node)."""

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        """Hashable key: nodes fold together iff these match."""
        return (type(self).__name__, self.shape, *sorted(self.config.items()))

    @abstractmethod
    def __call__(self, store: Store, *ins: jnp.ndarray) -> jnp.ndarray:
        """Evaluate: inputs and output carry the leading fold axis."""

    def fold(self, group: Sequence["JaxParameterNode"]) -> "JaxParameterNode":
        """Build the folded node for a group (all with my fold_settings)."""
        cfg = self.config
        return type(self)(**cfg, num_folds=sum(n.num_folds for n in group))

    def __repr__(self) -> str:
        return f"{type(self).__name__}(F={self.num_folds}, shape={self.shape})"


class JaxParameterInput(JaxParameterNode, ABC):
    """A parameter node without graph inputs."""


class JaxTensorSlot(JaxParameterInput):
    """A read of a parameter-store slot: the compiled TensorParameter.

    ``origins`` tracks the symbolic TensorParameters stacked into this slot
    (one per fold) so the compiler state can resolve references after folding.
    """

    def __init__(
        self,
        slot: str,
        shape: Shape,
        *,
        dtype: Any,
        learnable: bool,
        inits: Sequence[InitFn],
        origins: Sequence[Any],
        num_folds: int = 1,
    ):
        super().__init__(num_folds=num_folds)
        assert len(inits) == num_folds and len(origins) == num_folds
        self.slot = slot
        self._shape = tuple(shape)
        self.dtype = dtype
        self.learnable = learnable
        self.inits = list(inits)
        self.origins = list(origins)

    @property
    def shape(self) -> Shape:
        return self._shape

    @property
    def config(self) -> dict[str, Any]:
        return {
            "slot": self.slot,
            "shape": self._shape,
            "dtype": self.dtype,
            "learnable": self.learnable,
            "inits": self.inits,
            "origins": self.origins,
        }

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        # Tensor slots fold together when shape/dtype/learnability agree; the
        # folding pass allocates a fresh stacked slot.
        return (type(self).__name__, self._shape, str(self.dtype), self.learnable)

    @property
    def host_initializable(self) -> bool:
        """Whether every fold's initializer has a host (numpy) sampler."""
        return all(
            getattr(init, "host", None) is not None
            or getattr(init, "constant", None) is not None
            for init in self.inits
        )

    def initialize(self, key: jax.Array | None) -> jnp.ndarray:
        """Materialize the (F, ...) initial value of this slot.

        Fast paths keep trace/dispatch cost O(1) per slot instead of O(F):
        constant initializers stack in numpy; folds sharing the same
        elementwise initializer draw a single (F, ...) sample. Random slots
        whose initializers carry a host sampler draw in numpy — avoiding any
        XLA compilation (one eager jax.random call per slot costs a compile
        on CPU).
        """
        consts = [getattr(init, "constant", None) for init in self.inits]
        if all(c is not None for c in consts):
            np_dtype = np.dtype(self.dtype)
            return jnp.asarray(
                np.stack(
                    [np.broadcast_to(np.asarray(c), self._shape) for c in consts]
                ).astype(np_dtype)
            )
        if key is not None and self.host_initializable and _host_init():
            rng = np.random.default_rng(
                np.asarray(jax.random.key_data(key), dtype=np.uint32).ravel()
            )
            batch_keys = {getattr(init, "batch_key", None) for init in self.inits}
            if len(batch_keys) == 1 and None not in batch_keys:
                # every fold shares one elementwise iid initializer: a single
                # (F, ...) draw instead of F draws + stack
                return jnp.asarray(
                    self.inits[0].host(rng, (self.num_folds, *self._shape), self.dtype)
                )
            parts = [
                np.broadcast_to(np.asarray(c), self._shape).astype(np.dtype(self.dtype))
                if (c := getattr(init, "constant", None)) is not None
                else init.host(rng, self._shape, self.dtype)
                for init in self.inits
            ]
            return jnp.asarray(np.stack(parts, axis=0))
        batch_keys = {getattr(init, "batch_key", None) for init in self.inits}
        if len(batch_keys) == 1 and None not in batch_keys and key is not None:
            return self.inits[0](key, (self.num_folds, *self._shape), self.dtype)
        if key is None:
            keys = [None] * self.num_folds
        else:
            keys = list(jax.random.split(key, self.num_folds))
        parts = [init(k, self._shape, self.dtype) for init, k in zip(self.inits, keys)]
        return jnp.stack(parts, axis=0)

    def __call__(self, store: Store, *ins: jnp.ndarray) -> jnp.ndarray:
        return store[self.slot]


class JaxPointerSlot(JaxParameterInput):
    """A fold-indexed view into another circuit's (or layer's) tensor slot:
    the compiled ReferenceParameter (parameter sharing across operator-derived
    circuits, ref: ``backend/torch/parameters/nodes.py:223``)."""

    def __init__(
        self,
        slot: str,
        shape: Shape,
        *,
        fold_idx: np.ndarray | None,
        num_folds: int = 1,
        learnable: bool = False,
    ):
        super().__init__(num_folds=num_folds)
        self.slot = slot
        self._shape = tuple(shape)
        self.fold_idx = None if fold_idx is None else np.asarray(fold_idx, dtype=np.int32)
        # whether the POINTED-TO tensor slot is learnable: lets derived
        # circuits (operator results, ensembles) report shared parameters in
        # learnable_slots, so fit()/fit_em() on them trains the shared store
        # entries — parameter-sharing parity with the reference, where
        # operator outputs reuse the operands' nn.Parameters
        self.learnable = bool(learnable)

    @property
    def shape(self) -> Shape:
        return self._shape

    @property
    def config(self) -> dict[str, Any]:
        return {"slot": self.slot, "shape": self._shape, "fold_idx": self.fold_idx}

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        return (type(self).__name__, self.slot, self._shape)

    def fold(self, group: Sequence[JaxParameterNode]) -> "JaxPointerSlot":
        idx = np.concatenate(
            [
                n.fold_idx if n.fold_idx is not None else np.arange(n.num_folds, dtype=np.int32)
                for n in group
            ]
        )
        return JaxPointerSlot(
            self.slot,
            self._shape,
            fold_idx=idx,
            num_folds=len(idx),
            learnable=any(getattr(n, "learnable", False) for n in group),
        )

    def __call__(self, store: Store, *ins: jnp.ndarray) -> jnp.ndarray:
        x = store[self.slot]
        return x if self.fold_idx is None else x[self.fold_idx]


class JaxParameterOp(JaxParameterNode, ABC):
    """An inner parameter-graph node; subclasses define ``_eval``."""

    def __init__(self, *in_shapes: Shape, num_folds: int = 1):
        super().__init__(num_folds=num_folds)
        self.in_shapes = tuple(tuple(s) for s in in_shapes)

    @property
    def config(self) -> dict[str, Any]:
        return {"in_shapes": self.in_shapes}

    def fold(self, group: Sequence[JaxParameterNode]) -> "JaxParameterOp":
        cfg = self.config
        in_shapes = cfg.pop("in_shapes")
        return type(self)(*in_shapes, **cfg, num_folds=sum(n.num_folds for n in group))

    def __call__(self, store: Store, *ins: jnp.ndarray) -> jnp.ndarray:
        return self._eval(*ins)

    @abstractmethod
    def _eval(self, *ins: jnp.ndarray) -> jnp.ndarray: ...


class _AxisOp(JaxParameterOp, ABC):
    """A parameter op configured by an axis (given in unfolded coordinates;
    the leading fold axis shifts it by one at evaluation time)."""

    def __init__(self, *in_shapes: Shape, axis: int = -1, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        rank = len(self.in_shapes[0])
        self.axis = axis if axis >= 0 else axis + rank

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "axis": self.axis}


class JaxIndexParameter(_AxisOp):
    def __init__(self, *in_shapes, indices: Sequence[int], axis: int = -1, num_folds: int = 1):
        super().__init__(*in_shapes, axis=axis, num_folds=num_folds)
        self.indices = tuple(indices)

    @property
    def shape(self) -> Shape:
        s = self.in_shapes[0]
        return s[: self.axis] + (len(self.indices),) + s[self.axis + 1 :]

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "indices": self.indices}

    def _eval(self, x):
        return jnp.take(x, np.asarray(self.indices), axis=self.axis + 1)


class JaxSumParameter(JaxParameterOp):
    @property
    def shape(self) -> Shape:
        return self.in_shapes[0]

    def _eval(self, a, b):
        return a + b


class JaxHadamardParameter(JaxParameterOp):
    @property
    def shape(self) -> Shape:
        return self.in_shapes[0]

    def _eval(self, a, b):
        return a * b


class JaxKroneckerParameter(JaxParameterOp):
    @property
    def shape(self) -> Shape:
        return tuple(a * b for a, b in zip(*self.in_shapes))

    def _eval(self, a, b):
        # Fold-wise Kronecker product: interleave every axis pair.
        rank = len(self.in_shapes[0])
        out = a
        for ax in range(rank):
            out = jnp.expand_dims(out, 2 + 2 * ax)
        other = b
        for ax in range(rank):
            other = jnp.expand_dims(other, 1 + 2 * ax)
        out = out * other
        return out.reshape((out.shape[0], *self.shape))


class _OuterOp(_AxisOp, ABC):
    @property
    def shape(self) -> Shape:
        s1, s2 = self.in_shapes
        a = self.axis
        return s1[:a] + (s1[a] * s2[a],) + s1[a + 1 :]

    def _outer(self, a, b, combine):
        ax = self.axis + 1  # account for the fold axis
        a1 = jnp.expand_dims(a, ax + 1)
        b1 = jnp.expand_dims(b, ax)
        out = combine(a1, b1)
        return out.reshape((out.shape[0], *self.shape))


class JaxOuterProductParameter(_OuterOp):
    def _eval(self, a, b):
        return self._outer(a, b, jnp.multiply)


class JaxOuterSumParameter(_OuterOp):
    def _eval(self, a, b):
        return self._outer(a, b, jnp.add)


class _EntrywiseOp(JaxParameterOp, ABC):
    @property
    def shape(self) -> Shape:
        return self.in_shapes[0]


class JaxExpParameter(_EntrywiseOp):
    def _eval(self, x):
        return jnp.exp(x)


class JaxLogParameter(_EntrywiseOp):
    def _eval(self, x):
        # complex inputs need the conjugate-gradient safe log
        if jnp.issubdtype(x.dtype, jnp.complexfloating):
            return csafelog(x)
        return safelog(x)


class JaxSquareParameter(_EntrywiseOp):
    def _eval(self, x):
        return jnp.square(x)


class JaxSoftplusParameter(_EntrywiseOp):
    def _eval(self, x):
        return jax.nn.softplus(x)


class JaxSigmoidParameter(_EntrywiseOp):
    def _eval(self, x):
        return jax.nn.sigmoid(x)


class JaxScaledSigmoidParameter(_EntrywiseOp):
    def __init__(self, *in_shapes, vmin: float, vmax: float, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        self.vmin = vmin
        self.vmax = vmax

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "vmin": self.vmin, "vmax": self.vmax}

    def _eval(self, x):
        return jax.nn.sigmoid(x) * (self.vmax - self.vmin) + self.vmin


class JaxClampParameter(_EntrywiseOp):
    def __init__(self, *in_shapes, vmin=None, vmax=None, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        self.vmin = vmin
        self.vmax = vmax

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "vmin": self.vmin, "vmax": self.vmax}

    def _eval(self, x):
        return jnp.clip(x, self.vmin, self.vmax)


class JaxConjugateParameter(_EntrywiseOp):
    def _eval(self, x):
        return jnp.conj(x)


class _ReduceOp(_AxisOp, ABC):
    @property
    def shape(self) -> Shape:
        s = self.in_shapes[0]
        return s[: self.axis] + s[self.axis + 1 :]


class JaxReduceSumParameter(_ReduceOp):
    def _eval(self, x):
        return x.sum(axis=self.axis + 1)


class JaxReduceProductParameter(_ReduceOp):
    def _eval(self, x):
        return x.prod(axis=self.axis + 1)


class JaxReduceLSEParameter(_ReduceOp):
    def _eval(self, x):
        return jax.nn.logsumexp(x, axis=self.axis + 1)


class JaxSoftmaxParameter(_AxisOp):
    @property
    def shape(self) -> Shape:
        return self.in_shapes[0]

    def _eval(self, x):
        return jax.nn.softmax(x, axis=self.axis + 1)


class JaxLogSoftmaxParameter(_AxisOp):
    @property
    def shape(self) -> Shape:
        return self.in_shapes[0]

    def _eval(self, x):
        return jax.nn.log_softmax(x, axis=self.axis + 1)


class JaxMixingWeightParameter(JaxParameterOp):
    """(F, K, H) mixing coefficients -> (F, K, K*H) block-diagonal weight."""

    @property
    def shape(self) -> Shape:
        k, h = self.in_shapes[0]
        return (k, k * h)

    def _eval(self, x):
        k, h = self.in_shapes[0]
        # (F, K, H) -> per column j, a diagonal block diag(x[:, :, j])
        eye = jnp.eye(k, dtype=x.dtype)  # (K, K)
        blocks = eye[None, :, :, None] * x[:, None, :, :]  # (F, K, K, H)
        return jnp.transpose(blocks, (0, 1, 3, 2)).reshape(x.shape[0], k, k * h)


class JaxGaussianProductMean(JaxParameterOp):
    @property
    def shape(self) -> Shape:
        return (self.in_shapes[0][-1] * self.in_shapes[2][-1],)

    def _eval(self, m1, s1, m2, s2):
        v1, v2 = jnp.square(s1), jnp.square(s2)
        num = m1[:, :, None] * v2[:, None, :] + v1[:, :, None] * m2[:, None, :]
        den = v1[:, :, None] + v2[:, None, :]
        return (num / den).reshape(m1.shape[0], -1)


class JaxGaussianProductStddev(JaxParameterOp):
    @property
    def shape(self) -> Shape:
        return (self.in_shapes[0][-1] * self.in_shapes[1][-1],)

    def _eval(self, s1, s2):
        v1, v2 = jnp.square(s1), jnp.square(s2)
        var = (v1[:, :, None] * v2[:, None, :]) / (v1[:, :, None] + v2[:, None, :])
        return jnp.sqrt(var).reshape(s1.shape[0], -1)


class JaxGaussianProductLogPartition(JaxParameterOp):
    @property
    def shape(self) -> Shape:
        return (self.in_shapes[0][-1] * self.in_shapes[2][-1],)

    def _eval(self, m1, s1, m2, s2):
        v1, v2 = jnp.square(s1), jnp.square(s2)
        var = v1[:, :, None] + v2[:, None, :]
        diff = m1[:, :, None] - m2[:, None, :]
        logz = -0.5 * jnp.square(diff) / var - 0.5 * jnp.log(2.0 * jnp.pi * var)
        return logz.reshape(m1.shape[0], -1)


class JaxPolynomialProduct(JaxParameterOp):
    """Coefficient convolution via FFT (ref: ``parameters/nodes.py:991-1021``)."""

    @property
    def shape(self) -> Shape:
        return (
            self.in_shapes[0][0] * self.in_shapes[1][0],
            self.in_shapes[0][1] + self.in_shapes[1][1] - 1,
        )

    def _eval(self, c1, c2):
        f = c1.shape[0]
        deg = self.shape[-1]
        is_complex = jnp.issubdtype(c1.dtype, jnp.complexfloating) or jnp.issubdtype(
            c2.dtype, jnp.complexfloating
        )
        fft, ifft = (jnp.fft.fft, jnp.fft.ifft) if is_complex else (jnp.fft.rfft, jnp.fft.irfft)
        f1 = fft(c1, n=deg, axis=-1)  # (F, K1, deg)
        f2 = fft(c2, n=deg, axis=-1)  # (F, K2, deg)
        prod = f1[:, :, None, :] * f2[:, None, :, :]  # (F, K1, K2, deg)
        out = ifft(prod, n=deg, axis=-1)
        return out.reshape(f, -1, deg)


class JaxPolynomialDifferential(JaxParameterOp):
    def __init__(self, *in_shapes, order: int = 1, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        self.order = order

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "order": self.order}

    @property
    def shape(self) -> Shape:
        k, dp1 = self.in_shapes[0]
        return (k, dp1 - self.order if dp1 > self.order else 1)

    def _eval(self, c):
        dp1 = c.shape[-1]
        if dp1 <= self.order:
            return jnp.zeros((c.shape[0], c.shape[1], 1), dtype=c.dtype)
        for _ in range(self.order):
            c = c[..., 1:] * jnp.arange(1, c.shape[-1], dtype=c.real.dtype)
        return c


class JaxEinsumParameter(JaxParameterOp):
    """A generic folded einsum over parameter inputs, emitted by the
    ReduceSum-of-OuterProduct fusion (ref: ``parameters/optimized.py:10``)."""

    def __init__(self, *in_shapes, equation: str, out_shape: Shape, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        self.equation = equation
        self.out_shape = tuple(out_shape)

    @property
    def shape(self) -> Shape:
        return self.out_shape

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "equation": self.equation, "out_shape": self.out_shape}

    def _eval(self, *ins):
        return jnp.einsum(self.equation, *ins)


class JaxParameter(RootedDiAcyclicGraph[JaxParameterNode]):
    """A compiled parameter computational graph: store -> (F, ...) array."""

    def __init__(self, nodes, in_nodes, outputs):
        super().__init__(nodes, in_nodes, outputs)
        self._ordering = list(self.topological_ordering())

    @property
    def num_folds(self) -> int:
        return self.output.num_folds

    @property
    def shape(self) -> Shape:
        return self.output.shape

    def __call__(self, store: Store, *, node_override=None) -> jnp.ndarray:
        """Evaluate the plan. ``node_override(plan, node, ins)`` — when
        given — may return a replacement value for ``node`` (or ``None`` to
        defer to the node's own evaluation). It is the single hook behind
        the routing-time reinterpretations of fused weights
        (``queries._max_weight`` tropical MatMul, ``topk._parse_weight``
        column expansion), so plan evaluation itself lives in exactly one
        place."""
        values: dict[JaxParameterNode, jnp.ndarray] = {}
        for node in self._ordering:
            ins = [values[n] for n in self.node_inputs(node)]
            out = node_override(self, node, ins) if node_override else None
            values[node] = node(store, *ins) if out is None else out
        return values[self.output]

    # -- canonicalization for folding -----------------------------------------
    def canonical_nodes(self) -> list[JaxParameterNode]:
        """A canonical post-order node sequence (inputs before outputs,
        deterministic), so structurally-identical graphs zip node-wise."""
        seq: list[JaxParameterNode] = []
        seen: set[int] = set()

        def visit(n: JaxParameterNode) -> None:
            if id(n) in seen:
                return
            seen.add(id(n))
            for c in self.node_inputs(n):
                visit(c)
            seq.append(n)

        visit(self.output)
        return seq

    @property
    def fold_settings(self) -> tuple[Any, ...]:
        """Structural signature: graphs fold together iff these match."""
        seq = self.canonical_nodes()
        pos = {id(n): i for i, n in enumerate(seq)}
        sig: list[Any] = []
        for n in seq:
            sig.append((n.fold_settings, tuple(pos[id(c)] for c in self.node_inputs(n))))
        return tuple(sig)

    def tensor_slots(self) -> list[JaxTensorSlot]:
        return [n for n in self._ordering if isinstance(n, JaxTensorSlot)]

    @classmethod
    def from_output(
        cls, output: JaxParameterNode, in_nodes: Mapping[JaxParameterNode, Sequence[JaxParameterNode]]
    ) -> "JaxParameter":
        nodes: list[JaxParameterNode] = []
        seen: set[int] = set()

        def visit(n):
            if id(n) in seen:
                return
            seen.add(id(n))
            for c in in_nodes.get(n, []):
                visit(c)
            nodes.append(n)

        visit(output)
        return cls(nodes, {n: list(in_nodes.get(n, [])) for n in nodes}, [output])

    @classmethod
    def from_input(cls, node: JaxParameterInput) -> "JaxParameter":
        return cls([node], {}, [node])

    @classmethod
    def from_sequence(cls, p: "JaxParameter", *ops: JaxParameterOp) -> "JaxParameter":
        nodes = list(p.nodes) + list(ops)
        in_nodes = dict(p.nodes_inputs)
        prev = p.output
        for op in ops:
            in_nodes[op] = [prev]
            prev = op
        return cls(nodes, in_nodes, [prev])

    @classmethod
    def from_nary(cls, op: JaxParameterOp, *ps: "JaxParameter") -> "JaxParameter":
        nodes = [n for p in ps for n in p.nodes] + [op]
        in_nodes: dict = {}
        for p in ps:
            in_nodes.update(p.nodes_inputs)
        in_nodes[op] = [p.output for p in ps]
        return cls(nodes, in_nodes, [op])


class JaxMatMulParameter(JaxParameterOp):
    """Matrix product of two parameter matrices (emitted by the sum-collapse
    fusion: two stacked dense sums fuse into one with W2 @ W1 weights)."""

    def __init__(self, *in_shapes: Shape, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        if in_shapes[0][0] != in_shapes[1][1]:
            raise ValueError(
                f"Cannot matrix-multiply parameter shapes {in_shapes[1]} @ {in_shapes[0]}"
            )

    @property
    def shape(self) -> Shape:
        # inputs are (inner sum weight, outer sum weight): W2 @ W1
        return (self.in_shapes[1][0], self.in_shapes[0][1])

    def _eval(self, w1, w2):
        return jnp.einsum("foi,fij->foj", w2, w1)


class JaxFlattenParameter(JaxParameterOp):
    """Flatten a contiguous range of axes of the input parameter."""

    def __init__(self, *in_shapes: Shape, start_dim: int = 0, end_dim: int = -1, num_folds: int = 1):
        super().__init__(*in_shapes, num_folds=num_folds)
        rank = len(self.in_shapes[0])
        self.start_dim = start_dim if start_dim >= 0 else start_dim + rank
        self.end_dim = end_dim if end_dim >= 0 else end_dim + rank

    @property
    def config(self) -> dict[str, Any]:
        return {**super().config, "start_dim": self.start_dim, "end_dim": self.end_dim}

    @property
    def shape(self) -> Shape:
        s = self.in_shapes[0]
        flat = 1
        for d in s[self.start_dim : self.end_dim + 1]:
            flat *= d
        return s[: self.start_dim] + (flat,) + s[self.end_dim + 1 :]

    def _eval(self, x):
        return x.reshape((x.shape[0], *self.shape))
