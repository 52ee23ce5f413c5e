"""Probabilistic Integral Circuits (PIC) and quadrature PCs (QPC).

Rebuild of ``cirkit/backend/torch/parameters/pic.py:25-509``, redesigned
functionally for JAX: where the reference mutates a compiled torch circuit
in place and injects forward hooks that overwrite tensor-parameter outputs,
here :func:`pc2qpc` returns a new circuit plus a
:class:`QuadratureParameterization` — a pytree of small "integral network"
parameters and a pure :meth:`~QuadratureParameterization.materialize`
function that computes the circuit's parameter store from them. Training a
QPC is ordinary JAX: differentiate the loss through ``materialize`` into
the network parameters; no hook mechanism is needed.

The integral networks mirror the reference's architecture: random Fourier
features of the quadrature points followed by grouped 1x1-convolution MLPs
(expressed as grouped einsums):

- :class:`PICInputNet` — generates input-layer parameter tensors (e.g. the
  (F, K, C) categorical logits) by evaluating a per-variable function at
  the K quadrature points (ref: ``pic.py:91-178``).
- :class:`PICInnerNet` — generates sum/Tucker/CPT weight tensors by
  evaluating a positive function on the quadrature mesh and normalizing it
  with the quadrature weights, so every generated weight tensor sums to
  one over its input axes (ref: ``pic.py:181-306``).

Sharing modes follow the reference: ``"none"`` (one head per
variable/fold), ``"f"`` (fully shared), ``"c"`` (composite: shared trunk,
per-group heads initialized equal, ref: ``pic.py:138-144, 242-246``).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from cirkit_tpu.backend.jax.circuit import JaxCircuit
from cirkit_tpu.backend.jax.layers import (
    JaxCategoricalLayer,
    JaxGaussianLayer,
    JaxHadamardLayer,
    JaxInputLayer,
    JaxKroneckerLayer,
    JaxSumLayer,
)
from cirkit_tpu.backend.jax.optimized import JaxCPTLayer, JaxTuckerLayer
from cirkit_tpu.backend.jax.parameters import (
    JaxMixingWeightParameter,
    JaxParameter,
    JaxSoftmaxParameter,
    JaxTensorSlot,
    Store,
)

Params = dict[str, jnp.ndarray]


def zw_quadrature(
    integration_method: str,
    nip: int,
    a: float = -1.0,
    b: float = 1.0,
    *,
    return_log_weight: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature nodes and weights on [a, b] (ref: ``pic.py:25-60``).

    Supported: ``leggauss``, ``midpoint``, ``trapezoidal``, ``simpson``
    (odd ``nip``) and ``hermgauss`` (Gauss-Hermite on the real line).
    """
    if integration_method == "leggauss":
        z, w = np.polynomial.legendre.leggauss(nip)
        z = (b - a) * (z + 1.0) / 2.0 + a
        w = w * (b - a) / 2.0
    elif integration_method == "midpoint":
        edges = np.linspace(a, b, num=nip + 1)
        z = (edges[:-1] + edges[1:]) / 2.0
        w = np.full_like(z, (b - a) / nip)
    elif integration_method == "trapezoidal":
        z = np.linspace(a, b, num=nip)
        w = np.full((nip,), (b - a) / (nip - 1))
        w[0] = w[-1] = 0.5 * (b - a) / (nip - 1)
    elif integration_method == "simpson":
        if nip % 2 != 1:
            raise ValueError("Simpson's rule requires an odd number of points")
        z = np.linspace(a, b, num=nip)
        w = np.concatenate([[1.0], np.tile([4.0, 2.0], nip // 2 - 1), [4.0, 1.0]])
        w = (b - a) / (nip - 1) / 3.0 * w
    elif integration_method == "hermgauss":
        z, w = np.polynomial.hermite.hermgauss(nip)
    else:
        raise ValueError(f"Unknown integration method '{integration_method}'")
    if return_log_weight:
        w = np.log(w)
    return z.astype(np.float64), w.astype(np.float64)


def fourier_features(z: jnp.ndarray, coeff: jnp.ndarray) -> jnp.ndarray:
    """Random Fourier features: z (N, D), coeff (D, ff/2) -> (N, ff)
    (ref: ``FourierLayer``, ``pic.py:63-88``)."""
    proj = 2.0 * jnp.pi * (z @ coeff)
    return jnp.concatenate([jnp.cos(proj), jnp.sin(proj)], axis=-1)


def _uniform(key, shape, fan_in, dtype):
    bound = 1.0 / math.sqrt(fan_in)
    return jax.random.uniform(key, shape, dtype, minval=-bound, maxval=bound)


def _grouped_linear(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray | None) -> jnp.ndarray:
    """x (G_in, N, D), w (G, D, P) -> (G, N, P), broadcasting G_in=1.

    A shared input (G_in=1) is contracted against every group's weight as
    one GEMM, never copied per group: a Tucker core's head has one group per
    fold over K^3 quadrature points, and the copy would hold
    F x K^3 x net_dim values (53 GB for the K=64 MNIST flagship)."""
    if x.shape[0] == 1:
        y = jnp.einsum("nd,gdp->gnp", x[0], w)
    else:
        y = jnp.einsum("gnd,gdp->gnp", x, w)
    return y if b is None else y + b[:, None, :]


@dataclass
class PICInputNet:
    """Generates an input layer's (V, nip, P) parameter tensor by evaluating
    per-variable functions at the quadrature points."""

    num_variables: int
    num_param: int
    sharing: str = "f"

    def init(
        self,
        key: jax.Array,
        *,
        net_dim: int = 128,
        ff_dim: int | None = None,
        ff_sigma: float = 1.0,
        bias: bool = True,
        dtype: Any = jnp.float32,
    ) -> Params:
        if self.sharing not in ("none", "f", "c"):
            raise ValueError(f"Unknown sharing mode '{self.sharing}'")
        ff_dim = net_dim if ff_dim is None else ff_dim
        if ff_dim % 2 != 0:
            raise ValueError("The Fourier feature dimension must be even")
        g1 = 1 if self.sharing in ("f", "c") else self.num_variables
        g2 = 1 if self.sharing == "f" else self.num_variables
        k0, k1, k2, k3, k4 = jax.random.split(key, 5)
        p: Params = {
            "ff": ff_sigma * jax.random.normal(k0, (1, ff_dim // 2), dtype),
            "w1": _uniform(k1, (g1, ff_dim, net_dim), ff_dim, dtype),
            "w2": _uniform(k2, (g2, net_dim, self.num_param), net_dim, dtype),
        }
        if self.sharing == "c":  # heads initialized equal across variables
            p["w2"] = jnp.broadcast_to(p["w2"][:1], p["w2"].shape)
        if bias:
            p["b1"] = _uniform(k3, (g1, net_dim), ff_dim, dtype)
            p["b2"] = _uniform(k4, (g2, self.num_param), net_dim, dtype)
            if self.sharing == "c":
                p["b2"] = jnp.broadcast_to(p["b2"][:1], p["b2"].shape)
        return p

    def apply(self, params: Params, z_quad: jnp.ndarray) -> jnp.ndarray:
        """z_quad (nip,) -> (num_variables, nip, num_param)."""
        phi = fourier_features(z_quad[:, None], params["ff"])[None]  # (1, nip, ff)
        h = jnp.tanh(_grouped_linear(phi, params["w1"], params.get("b1")))
        out = _grouped_linear(h, params["w2"], params.get("b2"))  # (G2, nip, P)
        return jnp.broadcast_to(out, (self.num_variables, *out.shape[1:]))


@dataclass
class PICInnerNet:
    """Generates a (num_funcs, nip, ..., nip) weight tensor over ``num_dim``
    quadrature axes, softplus-positive and normalized with the quadrature
    weights over ``norm_dim`` so the result sums to one per output unit."""

    num_dim: int
    num_funcs: int
    norm_dim: tuple[int, ...]  # 1-based axes of the per-func mesh
    sharing: str = "c"

    def init(
        self,
        key: jax.Array,
        *,
        net_dim: int = 128,
        ff_dim: int | None = None,
        ff_sigma: float = 1.0,
        bias: bool = True,
        dtype: Any = jnp.float32,
    ) -> Params:
        if self.sharing not in ("none", "f", "c"):
            raise ValueError(f"Unknown sharing mode '{self.sharing}'")
        ff_dim = net_dim if ff_dim is None else ff_dim
        if ff_dim % 2 != 0:
            raise ValueError("The Fourier feature dimension must be even")
        g1 = 1 if self.sharing in ("f", "c") else self.num_funcs
        g2 = 1 if self.sharing == "f" else self.num_funcs
        ks = jax.random.split(key, 7)
        p: Params = {
            "ff": ff_sigma * jax.random.normal(ks[0], (self.num_dim, ff_dim // 2), dtype),
            "w1": _uniform(ks[1], (g1, ff_dim, net_dim), ff_dim, dtype),
            "w2": _uniform(ks[2], (g1, net_dim, net_dim), net_dim, dtype),
            "w3": _uniform(ks[3], (g2, net_dim, 1), net_dim, dtype),
        }
        if self.sharing == "c":
            p["w3"] = jnp.broadcast_to(p["w3"][:1], p["w3"].shape)
        if bias:
            p["b1"] = _uniform(ks[4], (g1, net_dim), ff_dim, dtype)
            p["b2"] = _uniform(ks[5], (g1, net_dim), net_dim, dtype)
            p["b3"] = _uniform(ks[6], (g2, 1), net_dim, dtype)
            if self.sharing == "c":
                p["b3"] = jnp.broadcast_to(p["b3"][:1], p["b3"].shape)
        return p

    def apply(
        self, params: Params, z_quad: jnp.ndarray, w_quad: jnp.ndarray
    ) -> jnp.ndarray:
        """-> (num_funcs, nip, ..., nip) with sum over norm_dim equal to 1."""
        nip = z_quad.shape[0]
        mesh = jnp.stack(
            jnp.meshgrid(*([z_quad] * self.num_dim), indexing="ij"), axis=0
        ).reshape(self.num_dim, -1).T  # (nip^D, D)
        phi = fourier_features(mesh, params["ff"])[None]
        h = jnp.tanh(_grouped_linear(phi, params["w1"], params.get("b1")))
        h = jnp.tanh(_grouped_linear(h, params["w2"], params.get("b2")))
        out = _grouped_linear(h, params["w3"], params.get("b3"))[..., 0]  # (G2, nip^D)
        eps = math.sqrt(float(jnp.finfo(out.dtype).tiny))
        logits = jax.nn.softplus(out) + eps
        logits = jnp.broadcast_to(logits, (self.num_funcs, logits.shape[1]))
        logits = logits.reshape(self.num_funcs, *([nip] * self.num_dim))
        w_shape = [nip if i in self.norm_dim else 1 for i in range(self.num_dim + 1)]
        w_mesh = jnp.stack(
            jnp.meshgrid(*([w_quad] * len(self.norm_dim)), indexing="ij"), axis=0
        ).prod(axis=0).reshape(w_shape)
        z = (logits * w_mesh).sum(axis=self.norm_dim, keepdims=True)
        return logits / z * w_mesh


@dataclass
class QuadratureParameterization:
    """The trainable state of a QPC: per-slot generator networks plus the
    frozen remainder of the original parameter store.

    ``materialize(net_params)`` evaluates every generator at its quadrature
    grid and returns a full parameter store for the converted circuit; it is
    jit-traceable and differentiable, so ``grad(loss o materialize)`` trains
    the integral networks directly (the functional replacement for the
    reference's parameter-overriding forward hooks, ``pic.py:258-267``).
    """

    net_params: dict[str, Params]
    generators: dict[str, Callable[[Params], jnp.ndarray]] = field(repr=False)
    frozen: dict[str, jnp.ndarray] = field(repr=False)

    def materialize(self, net_params: dict[str, Params] | None = None) -> Store:
        net_params = self.net_params if net_params is None else net_params
        store = dict(self.frozen)
        for slot, gen in self.generators.items():
            store[slot] = gen(net_params[slot])
        return store


def _integral_dims(shape: tuple[int, ...], *, is_tucker: bool) -> tuple[int, int]:
    """Infer (nip, num_dim) from a per-fold weight shape, following the
    reference's convention (``pic.py:461-475``): nip is the (square root of
    the) largest axis, and every axis must be an integer power of nip."""
    dims = [d for d in shape if d > 1]
    if not dims:
        return 1, 1
    nip = round(max(dims) ** (0.5 if is_tucker else 1.0))
    num_dim = 0
    for d in dims:
        e = round(math.log(d, nip)) if nip > 1 else 1
        if nip**e != d:
            raise ValueError(
                f"Weight shape {shape} is not a power of the quadrature size {nip}; "
                "pc2qpc supports square sum/CPT weights and Tucker cores"
            )
        num_dim += e
    return nip, max(num_dim, 1)


def _bare_slot_parameter(slot: JaxTensorSlot, name: str) -> JaxParameter:
    """An identity parameter graph reading a fresh non-learnable slot."""
    node = JaxTensorSlot(
        name,
        slot.shape,
        dtype=slot.dtype,
        learnable=False,
        inits=[lambda key, shape, dtype: jnp.zeros(shape, dtype)] * slot.num_folds,
        origins=list(slot.origins),
        num_folds=slot.num_folds,
    )
    return JaxParameter([node], {}, [node])


def pc2qpc(
    circuit: JaxCircuit,
    store: Store,
    *,
    integration_method: str,
    key: jax.Array,
    net_dim: int = 128,
    bias: bool = True,
    input_sharing: str = "f",
    inner_sharing: str = "c",
    ff_dim: int | None = None,
    ff_sigma: float = 1.0,
) -> tuple[JaxCircuit, QuadratureParameterization]:
    """Convert a compiled PC into a quadrature PC (ref: ``pic.py:336-509``).

    Input layers (Categorical, Gaussian) get :class:`PICInputNet` generators
    producing their raw parameter slots (reparameterization graphs are kept
    intact). Sum/Tucker/CPT weights get :class:`PICInnerNet` generators
    whose outputs are quadrature-normalized; their reparameterization graphs
    are replaced by bare slots so the normalization is not distorted. Mixing
    weights are frozen to uniform. Returns the converted circuit and the
    trainable :class:`QuadratureParameterization`.
    """
    dtype = None
    for v in store.values():
        dtype = v.dtype
        break
    generators: dict[str, Callable] = {}
    net_params: dict[str, Params] = {}
    frozen: dict[str, jnp.ndarray] = dict(store)
    new_layers = []
    keys = iter(jax.random.split(key, 4 * len(circuit.layers) + 1))

    def make_input_generator(slot: JaxTensorSlot, num_param: int, nip: int):
        z, _ = zw_quadrature(integration_method, nip)
        z_quad = jnp.asarray(z, dtype)
        net = PICInputNet(slot.num_folds, num_param, sharing=input_sharing)
        params = net.init(
            next(keys), net_dim=net_dim, ff_dim=ff_dim, ff_sigma=ff_sigma,
            bias=bias, dtype=dtype,
        )
        out_shape = (slot.num_folds, *slot.shape)

        def gen(p, _net=net, _z=z_quad, _shape=out_shape):
            return _net.apply(p, _z).reshape(_shape)

        generators[slot.slot] = gen
        net_params[slot.slot] = params
        frozen.pop(slot.slot, None)

    for layer in circuit.layers:
        new_layer = layer
        if isinstance(layer, JaxCategoricalLayer):
            param = layer.probs if layer.logits is None else layer.logits
            (slot,) = param.tensor_slots()
            make_input_generator(slot, layer.num_categories, layer.num_output_units)
        elif isinstance(layer, JaxGaussianLayer):
            for param in (layer.mean, layer.stddev):
                (slot,) = param.tensor_slots()
                make_input_generator(slot, 1, layer.num_output_units)
        elif isinstance(layer, (JaxSumLayer, JaxTuckerLayer, JaxCPTLayer)):
            weight = layer.weight
            # an UNOPTIMIZED plan expresses a Tucker block as Kronecker ->
            # Sum with a (K, K^2) weight: same latent-variable semantics
            # (one output + two input quadrature dims), so detect it by
            # shape signature and normalize over both input dims
            is_tucker = isinstance(layer, JaxTuckerLayer) or (
                isinstance(layer, JaxSumLayer)
                and layer.num_output_units > 1
                and layer.num_input_units == layer.num_output_units**2
            )
            graph_nodes = list(weight.topological_ordering())
            simple = len(graph_nodes) <= 2
            has_mixing = any(isinstance(n, JaxMixingWeightParameter) for n in graph_nodes)
            has_softmax = any(isinstance(n, JaxSoftmaxParameter) for n in graph_nodes)
            for slot in weight.tensor_slots():
                if has_mixing:
                    # mixing weights freeze to uniform (ref: pic.py:453-458);
                    # with a softmax downstream any constant yields uniform
                    value = 0.0 if has_softmax else 1.0 / slot.shape[-1]
                    frozen[slot.slot] = jnp.full(
                        (slot.num_folds, *slot.shape), value, dtype
                    )
                    continue
                nip, num_dim = _integral_dims(slot.shape, is_tucker=is_tucker)
                z, w = zw_quadrature(integration_method, nip)
                z_quad = jnp.asarray(z, dtype)
                w_quad = jnp.asarray(w, dtype)
                norm = tuple(range(1, num_dim + 1))[-(2 if is_tucker else 1):]
                net = PICInnerNet(
                    num_dim, slot.num_folds, norm_dim=norm, sharing=inner_sharing
                )
                params = net.init(
                    next(keys), net_dim=net_dim, ff_dim=ff_dim, ff_sigma=ff_sigma,
                    bias=bias, dtype=dtype,
                )
                if not simple:
                    raise NotImplementedError(
                        "pc2qpc supports sum weights whose parameter graph is a "
                        "(reparameterized) tensor slot; found a composite graph"
                    )
                name = f"{slot.slot}_qpc"
                out_shape = (slot.num_folds, *slot.shape)

                def gen(p, _net=net, _z=z_quad, _w=w_quad, _shape=out_shape):
                    return _net.apply(p, _z, _w).reshape(_shape)

                generators[name] = gen
                net_params[name] = params
                frozen.pop(slot.slot, None)
                # replace the reparameterized graph with the bare QPC slot
                new_layer = copy.copy(layer)
                new_layer.weight = _bare_slot_parameter(slot, name)
                if hasattr(new_layer, "_logits_slot"):
                    new_layer._logits_slot = None
        elif isinstance(layer, (JaxHadamardLayer, JaxKroneckerLayer, JaxInputLayer)):
            pass
        else:
            raise NotImplementedError(
                f"pc2qpc does not handle layers of type {type(layer).__name__}"
            )
        new_layers.append(new_layer)

    qpc = JaxCircuit(
        circuit.scope,
        circuit.num_variables,
        new_layers,
        circuit._fold_inputs,
        circuit._fold_outputs,
        properties=circuit.properties,
        semiring=circuit.semiring,
    )
    return qpc, QuadratureParameterization(
        net_params=net_params, generators=generators, frozen=frozen
    )
