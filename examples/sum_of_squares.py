"""Sum-of-squares (squared) circuits under the complex and signed semirings.

A non-monotonic circuit c(x) — negative sum weights allowed — is not a
distribution, but |c(x)|^2 is an unnormalized one, and it stays tractable:
conjugate, multiply and integrate are circuit operators. This mirrors the
reference's SoS support (complex semiring + operator suite), and then goes
one step further: for real-parameter circuits the ``signed-lse-sum``
semiring evaluates the same SoS pipeline as an all-real f32 program.

Run: python examples/sum_of_squares.py
"""

import itertools

import numpy as np

from cirkit_tpu.pipeline import PipelineContext
from cirkit_tpu.symbolic.circuit import Circuit
from cirkit_tpu.symbolic.initializers import ConstantTensorInitializer, NormalInitializer
from cirkit_tpu.symbolic.layers import CategoricalLayer, HadamardLayer, SumLayer
from cirkit_tpu.symbolic.parameters import Parameter, TensorParameter
from cirkit_tpu.utils.scope import Scope


def nonmonotonic_circuit(num_vars: int = 3, k: int = 4) -> Circuit:
    rng = np.random.default_rng(7)
    inputs = []
    for v in range(num_vars):
        probs = rng.dirichlet(np.ones(3), size=k)
        inputs.append(
            CategoricalLayer(
                Scope([v]), k, num_categories=3,
                probs=Parameter.from_input(TensorParameter(
                    k, 3, initializer=ConstantTensorInitializer(probs))),
            )
        )
    h = HadamardLayer(k, arity=num_vars)
    # negative weights: a non-monotonic mixture
    w = rng.normal(size=(1, k))
    s = SumLayer(k, 1, weight=Parameter.from_input(
        TensorParameter(1, k, initializer=ConstantTensorInitializer(w))))
    return Circuit(inputs + [h, s], {h: inputs, s: [h]}, [s])


def main() -> None:
    sc = nonmonotonic_circuit()
    ctx = PipelineContext(semiring="complex-lse-sum", fold=True)
    cc = ctx.compile(sc)

    worlds = np.array(list(itertools.product(range(3), repeat=3)))
    c = np.exp(np.asarray(cc(worlds))[:, 0, 0]).real
    print(f"c(x) ranges over [{c.min():.4f}, {c.max():.4f}] — not a density")

    squared = ctx.multiply(ctx.conjugate(cc), cc)
    c2 = np.exp(np.asarray(squared(worlds))[:, 0, 0]).real
    np.testing.assert_allclose(c2, c**2, rtol=1e-3, atol=1e-9)

    z = np.exp(np.asarray(ctx.integrate(squared)(ctx.parameters, worlds[:1]))[0, 0, 0]).real
    p = c2 / z
    print(f"|c|^2 / Z is a distribution: sum = {p.sum():.6f}, Z = {z:.6f}")

    # the same SoS pipeline under the signed (all-real) semiring
    sctx = PipelineContext(semiring="signed-lse-sum", fold=True, optimize=True)
    scc = sctx.compile(sc)
    ssq = sctx.multiply(sctx.conjugate(scc), scc)
    logmag, sign = ssq(worlds)
    c2s = np.asarray(sign)[:, 0, 0] * np.exp(np.asarray(logmag)[:, 0, 0])
    np.testing.assert_allclose(c2s, c2, rtol=1e-3, atol=1e-9)
    za, zs = sctx.integrate(ssq)(sctx.parameters, worlds[:1])
    z_signed = float(zs[0, 0, 0]) * np.exp(float(za[0, 0, 0]))
    print(f"signed semiring agrees: Z = {z_signed:.6f} (all-f32 program)")


if __name__ == "__main__":
    main()
