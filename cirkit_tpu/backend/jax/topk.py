"""Exact k-best parses (top-k MPE) over compiled circuits.

An extension beyond the reference (its only queries are integration and
sampling, ref ``backend/torch/queries.py:19-275``; it has no MAP at all,
let alone k-best). The classic k-best semiring (a.k.a. k-best Viterbi)
lifted onto the evaluation plan:

**Upward pass**: every unit carries the sorted descending vector of its T
best parse scores, (F, B, K, T). Input layers contribute their T best
states per unit (:meth:`JaxInputLayer.topk_modes`; observed variables pin
the single observed state); product-style layers combine their children's
lists with a pairwise-sum ``top_k`` merge; sum-style layers take the top-T
over (composite index m, composite rank t) candidates
``log w[o, m] + comb[m, t]``.

**Downward pass**: the same lazy selected-unit discipline as the 1-best
routing (``queries._build_routing_run``) — the selection state is one
(unit, rank) pair per (fold, sample, slot), with T slots per sample
(slot s extracts the s-th best parse). At each entry the relevant
``top_k`` is recomputed *at the selected unit only* and its returned
indices decompose the rank into per-child (unit, rank) pairs;
``jax.lax.top_k`` is deterministic (ties keep the lower index), so the
downward recomputation reproduces the upward choice bit-for-bit.

Semantics: the T best *latent parses* of the selected root unit. On
deterministic (selective) circuits parses biject with assignments, so
this is the exact top-T MPE; on non-deterministic circuits parse scores
lower-bound assignment probabilities and distinct parses may repeat an
assignment (the standard k-best relaxation). Continuous input layers
contribute only their mode (a unique maximizer — there is no discrete
"second best" state), so ranks beyond the mode route through *other*
latent choices. If a unit has fewer than T parses, the tail slots carry
score ``-inf`` and arbitrary states — filter by score.

Scaling note: this is the XLA moderate-scale path (dense (F, B, O, M*T)
candidate tensors at Tucker entries); it is not meant for the
1560-fold flagship the way the 1-best routing passes are.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cirkit_tpu.backend.jax.circuit import JaxCircuit
from cirkit_tpu.backend.jax.layers import (
    JaxConstantInputLayer,
    JaxHadamardLayer,
    JaxInputLayer,
    JaxKroneckerLayer,
    JaxSumLayer,
)
from cirkit_tpu.backend.jax.optimized import (
    JaxCPTLayer,
    JaxTensorDotLayer,
    JaxTuckerLayer,
)
from cirkit_tpu.backend.jax.parameters import JaxMatMulParameter
from cirkit_tpu.backend.jax.utils import safelog


def _parse_weight(param, st) -> jnp.ndarray:
    """Evaluate a sum-layer weight plan under PARSE semantics: a
    sum-collapsed ``MatMul`` weight sums over the fused inner sum's latent
    units, but top-k ranks *parses* — two parses differing only in that
    latent are distinct candidates, so the latent axis must be KEPT, not
    contracted (nor maxed: ``queries._max_weight`` is the 1-best shortcut).
    MatMul nodes therefore evaluate to the EXPANDED column space
    ``w[o, j * M + m] = W2[o, j] * W1[j, m]`` — latent digits major, the
    real input index minor — and nested collapses compose (an expanded
    operand's minor digit keeps indexing the true input). Consumers tile
    their child candidate lists over the latent digits and recover the
    real input as ``column % M``. Raises if a MatMul feeds any non-MatMul
    parameter node (no optimization rule produces that shape today)."""

    def expand_matmul(plan, node, ins):
        if not isinstance(node, JaxMatMulParameter):
            return None
        for user in plan.node_outputs(node):
            if not isinstance(user, JaxMatMulParameter):
                raise NotImplementedError(
                    "Top-k MPE through a fused weight graph where a "
                    f"MatMul feeds {type(user).__name__} is not supported"
                )
        w1, w2 = ins  # (F, J, C1) inner (maybe expanded), (F, O, C2) outer
        jdim = node.in_shapes[0][0]
        j_of_c2 = jnp.arange(w2.shape[2]) % jdim  # outer minor digit -> row
        w1g = w1[:, j_of_c2, :]  # (F, C2, C1)
        return (w2[:, :, :, None] * w1g[:, None, :, :]).reshape(
            w2.shape[0], w2.shape[1], -1
        )

    return param(st, node_override=expand_matmul)


def _tile_latents(comb: jnp.ndarray, num_cols: int) -> jnp.ndarray:
    """Tile composite top-T lists (F, B, M, T) over a collapsed weight's
    latent digits: column ``j * M + m`` of the expanded weight pairs with
    child composite ``m``, so copies stack latent-major."""
    m = comb.shape[2]
    if num_cols == m:
        return comb
    return jnp.tile(comb, (1, 1, num_cols // m, 1))


def _pair_topk(a: jnp.ndarray, b: jnp.ndarray, t: int):
    """Top-t of the pairwise sums ``a[..., i] + b[..., j]`` along the last
    axes: returns (values (..., t), flat indices i * Tb + j)."""
    cand = (a[..., :, None] + b[..., None, :]).reshape(*a.shape[:-1], -1)
    return jax.lax.top_k(cand, t)


def _cross_topk(a: jnp.ndarray, b: jnp.ndarray, t: int):
    """Kronecker-style combine of per-unit lists: ``a`` (F, B, Ka, Ta) x
    ``b`` (F, B, Kb, Tb) -> top-t lists over the (Ka*Kb) composite units,
    candidate (ua, ub, ta, tb) flattened with the unit axes major
    (matching the row-major composite index) and rank axes minor."""
    f, bb, ka, ta = a.shape
    kb, tb = b.shape[2], b.shape[3]
    cand = (
        a[:, :, :, None, :, None] + b[:, :, None, :, None, :]
    ).reshape(f, bb, ka * kb, ta * tb)
    return jax.lax.top_k(cand, t)


def _take_units(x: jnp.ndarray, units: jnp.ndarray) -> jnp.ndarray:
    """Gather per-unit top-T lists at selected units: ``x`` (F, B, K, T),
    ``units`` (F, B, S) -> (F, B, S, T)."""
    return jnp.take_along_axis(x, units[..., None], axis=2)


def _rank_decompose(lists: list[jnp.ndarray], ranks: jnp.ndarray, t: int):
    """Decompose final ranks through the left-to-right pairwise merges of
    ``lists`` (each (F, B, S, T)): recompute each stage's ``top_k`` and
    walk its indices backwards. Returns per-list ranks [(F, B, S), ...]."""
    prefixes = [lists[0]]
    for li in lists[1:]:
        prefixes.append(_pair_topk(prefixes[-1], li, t)[0])
    out = [None] * len(lists)
    r = ranks
    for h in range(len(lists) - 1, 0, -1):
        _, idx = _pair_topk(prefixes[h - 1], lists[h], t)
        pick = jnp.take_along_axis(idx, r[..., None], axis=-1)[..., 0]
        tb = lists[h].shape[-1]
        out[h] = pick % tb
        r = pick // tb
    out[0] = r
    return out


def build_topk_run(
    cc: JaxCircuit, topk: int, *, root_output: int = 0, root_unit: int = 0
):
    """Build the jittable top-k MPE program: ``(store, x, mask) ->
    (assignments (B, T, D), scores (B, T))``. See the module docstring."""
    num_vars = max(cc.scope) + 1
    entries = cc._entries
    sum_style = (JaxSumLayer, JaxCPTLayer, JaxTuckerLayer, JaxTensorDotLayer)
    t = topk

    def _run(st, xx, mk):
        bsz = xx.shape[0]

        def _gather_in(entry, vals):
            cat = (
                vals[entry.in_ids[0]]
                if len(entry.in_ids) == 1
                else jnp.concatenate([vals[i] for i in entry.in_ids], axis=0)
            )
            return cat[:, None] if entry.fold_idx is None else cat[entry.fold_idx]

        # ---- upward: per-unit sorted top-T parse scores (F, B, K, T) --------
        vals: list[jnp.ndarray] = []
        recs: list = []
        for entry in entries:
            layer = entry.layer
            if isinstance(layer, JaxConstantInputLayer):
                raise NotImplementedError(
                    f"Top-k MPE is not supported for {type(layer).__name__}"
                )
            if isinstance(layer, JaxInputLayer):
                if layer.num_variables != 1:
                    raise NotImplementedError(
                        "Top-k MPE of multivariate input layers is not supported"
                    )
                si = layer.scope_idx
                xin = jnp.transpose(xx[:, si], (1, 0, 2))  # (F, B, 1)
                obs_val = layer(st, xin)  # (F, B, K)
                fvals, fstates = layer.topk_modes(st, t)  # (F, K, T)
                dt = obs_val.dtype
                # observed: the single observed state is the only parse
                obs_l = jnp.concatenate(
                    [
                        obs_val[..., None],
                        jnp.full((*obs_val.shape, t - 1), -jnp.inf, dt),
                    ],
                    axis=-1,
                )
                mrow = jnp.transpose(mk[:, si[:, 0]], (1, 0))  # (F, B)
                free_l = jnp.broadcast_to(
                    fvals[:, None].astype(dt), (fvals.shape[0], bsz, *fvals.shape[1:])
                )
                vals.append(jnp.where(mrow[:, :, None, None], obs_l, free_l))
                xi = xin[..., 0].astype(dt)
                recs.append(("input", xi, mrow, fstates))
                continue

            v = _gather_in(entry, vals)  # (F, H, B, K, T)
            if isinstance(layer, sum_style):
                lw = safelog(_parse_weight(layer.weight, st))
                if isinstance(layer, JaxTensorDotLayer):
                    kj = layer._num_contract_units
                    kq = layer._num_batch_units
                    kk = layer.num_output_units // kq
                    f, _, b, _, _ = v.shape
                    vv = v[:, 0].reshape(f, b, kj, kq, t)
                    vvt = jnp.transpose(vv, (0, 1, 3, 2, 4))  # (F, B, Kq, Kj, T)
                    cand = (
                        lw[:, None, :, None, :, None] + vvt[:, :, None, :, :, :]
                    ).reshape(f, b, kk, kq, kj * t)
                    tv, _ = jax.lax.top_k(cand, t)  # (F, B, Kk, Kq, T)
                    tv = jnp.transpose(tv, (0, 1, 3, 2, 4)).reshape(f, b, kq * kk, t)
                    vals.append(tv)
                    recs.append(("tensordot", kj, kq, kk))
                    continue
                if isinstance(layer, JaxTuckerLayer):
                    comb = v[:, 0]
                    for hh in range(1, layer.arity):
                        comb, _ = _cross_topk(comb, v[:, hh], t)
                    rec = ("tucker", layer.arity, layer.num_input_units)
                elif isinstance(layer, JaxCPTLayer):
                    comb = v[:, 0]
                    for hh in range(1, layer.arity):
                        comb, _ = _pair_topk(comb, v[:, hh], t)
                    rec = ("cpt", layer.arity, layer.num_input_units)
                else:  # mixing sum over (H, K)
                    f, h, b, k, _ = v.shape
                    comb = jnp.transpose(v, (0, 2, 1, 3, 4)).reshape(f, b, h * k, t)
                    rec = ("sum", layer.arity, layer.num_input_units)
                # top-T over (m, t) candidates per output unit (collapsed
                # weights widen m with their latent digits — tiled copies)
                combx = _tile_latents(comb, lw.shape[2])
                cand = (
                    lw[:, None, :, :, None] + combx[:, :, None, :, :]
                ).reshape(*combx.shape[:2], lw.shape[1], -1)
                tv, _ = jax.lax.top_k(cand, t)
                vals.append(tv)
                recs.append(rec)
            elif isinstance(layer, JaxHadamardLayer):
                out = v[:, 0]
                for hh in range(1, layer.arity):
                    out, _ = _pair_topk(out, v[:, hh], t)
                vals.append(out)
                recs.append(("hadamard", layer.arity, layer.num_input_units))
            elif isinstance(layer, JaxKroneckerLayer):
                out = v[:, 0]
                for hh in range(1, layer.arity):
                    out, _ = _cross_topk(out, v[:, hh], t)
                vals.append(out)
                recs.append(("kronecker", layer.arity, layer.num_input_units))
            else:
                raise NotImplementedError(
                    f"Top-k MPE is not supported for {type(layer).__name__}"
                )

        out_cat = (
            vals[cc._outputs.out_ids[0]]
            if len(cc._outputs.out_ids) == 1
            else jnp.concatenate([vals[i] for i in cc._outputs.out_ids], axis=0)
        )
        root_vals = (
            out_cat if cc._outputs.fold_idx is None else out_cat[cc._outputs.fold_idx]
        )  # (O, B, K, T)
        if not 0 <= root_output < root_vals.shape[0]:
            raise ValueError(
                f"root output {root_output} out of range for a circuit with "
                f"{root_vals.shape[0]} outputs"
            )
        if not 0 <= root_unit < root_vals.shape[2]:
            raise ValueError(
                f"root unit {root_unit} out of range for {root_vals.shape[2]} "
                "output units"
            )

        # ---- downward: (unit, rank) selection per (fold, sample, slot) ------
        neg = jnp.int32(-1)
        selu = [jnp.full((v.shape[0], bsz, t), neg, jnp.int32) for v in vals]
        selr = [jnp.full((v.shape[0], bsz, t), neg, jnp.int32) for v in vals]

        root_entry = cc._outputs.out_ids[0]
        root_fold = root_output
        if len(cc._outputs.out_ids) > 1 or cc._outputs.fold_idx is not None:
            flat0 = (
                root_output
                if cc._outputs.fold_idx is None
                else int(cc._outputs.fold_idx[root_output])
            )
            off = 0
            for i in cc._outputs.out_ids:
                nf = vals[i].shape[0]
                if flat0 < off + nf:
                    root_entry, root_fold = i, flat0 - off
                    break
                off += nf
        selu[root_entry] = selu[root_entry].at[root_fold].set(root_unit)
        selr[root_entry] = (
            selr[root_entry].at[root_fold].set(jnp.arange(t, dtype=jnp.int32)[None, :])
        )

        def _push(e, per_op):
            """Push per-operand (units, ranks) — both (F, B, S) with -1 on
            inactive slots — through entry e's static fold gather."""
            entry = entries[e]
            per_op = [
                (u.astype(jnp.int32), jnp.where(u >= 0, r, neg).astype(jnp.int32))
                for u, r in per_op
            ]
            if entry.fold_idx is None:
                i0 = entry.in_ids[0]
                selu[i0] = jnp.maximum(selu[i0], per_op[0][0])
                selr[i0] = jnp.maximum(selr[i0], per_op[0][1])
                return
            total = sum(vals[i].shape[0] for i in entry.in_ids)
            cu = jnp.full((total, bsz, t), neg, jnp.int32)
            cr = jnp.full((total, bsz, t), neg, jnp.int32)
            for h, (u, r) in enumerate(per_op):
                cu = cu.at[entry.fold_idx[:, h]].max(u)
                cr = cr.at[entry.fold_idx[:, h]].max(r)
            off = 0
            for i in entry.in_ids:
                nf = vals[i].shape[0]
                selu[i] = jnp.maximum(selu[i], cu[off : off + nf])
                selr[i] = jnp.maximum(selr[i], cr[off : off + nf])
                off += nf

        def _digit_units(m, h, k, active):
            units = []
            rem = m
            for _ in range(h):
                units.append(jnp.where(active, rem % k, neg))
                rem = rem // k
            units.reverse()
            return units

        for e in range(len(entries) - 1, -1, -1):
            rec = recs[e]
            if rec[0] == "input":
                continue
            u = selu[e]  # (F, B, S)
            r = selr[e]
            active = u >= 0
            safeu = jnp.maximum(u, 0)
            safer = jnp.maximum(r, 0)
            entry = entries[e]
            layer = entry.layer
            v = _gather_in(entry, vals)  # (F, H, B, K, T)

            if rec[0] == "hadamard":
                lists = [_take_units(v[:, h], safeu) for h in range(layer.arity)]
                ranks = _rank_decompose(lists, safer, t)
                _push(e, [(u, rk) for rk in ranks])
                continue
            if rec[0] == "kronecker":
                _, h, k = rec
                units = _digit_units(safeu, h, k, active)
                lists = [
                    _take_units(v[:, hh], jnp.maximum(units[hh], 0))
                    for hh in range(h)
                ]
                ranks = _rank_decompose(lists, safer, t)
                _push(e, list(zip(units, ranks)))
                continue

            # sum-style: recompute the candidate top-T at the selected unit
            lw = safelog(_parse_weight(layer.weight, st))
            if rec[0] == "tensordot":
                _, kj, kq, kk = rec
                f, _, b, _, _ = v.shape
                vv = v[:, 0].reshape(f, b, kj, kq, t)
                q, kout = safeu // kk, safeu % kk
                w_sel = jnp.take_along_axis(
                    lw[:, None], kout[..., None], axis=2
                )  # (F, B, S, Kj)
                vvq = jnp.take_along_axis(
                    jnp.transpose(vv, (0, 1, 3, 2, 4)),
                    q[..., None, None],
                    axis=2,
                )  # (F, B, S, Kj, T)
                cand = (w_sel[..., None] + vvq).reshape(f, b, t, kj * t)
                _, idx = jax.lax.top_k(cand, t)
                pick = jnp.take_along_axis(idx, safer[..., None], axis=-1)[..., 0]
                j, tr = pick // t, pick % t
                _push(e, [(jnp.where(active, j * kq + q, neg), tr)])
                continue

            tag, h, k = rec
            # comb: the composite top-T lists, recomputed as in the upward
            # pass (lax.top_k is deterministic, so indices reproduce)
            if tag == "tucker":
                comb = v[:, 0]
                for hh in range(1, h):
                    comb, _ = _cross_topk(comb, v[:, hh], t)
            elif tag == "cpt":
                comb = v[:, 0]
                for hh in range(1, h):
                    comb, _ = _pair_topk(comb, v[:, hh], t)
            else:  # sum
                f_, hh_, b_, k_, _ = v.shape
                comb = jnp.transpose(v, (0, 2, 1, 3, 4)).reshape(f_, b_, hh_ * k_, t)
            w_sel = jnp.take_along_axis(lw[:, None], safeu[..., None], axis=2)
            combx = _tile_latents(comb, lw.shape[2])
            cand = (w_sel[..., None] + combx[:, :, None]).reshape(
                *combx.shape[:2], t, -1
            )
            _, idx = jax.lax.top_k(cand, t)
            pick = jnp.take_along_axis(idx, safer[..., None], axis=-1)[..., 0]
            m, tcomb = pick // t, pick % t
            m = m % comb.shape[2]  # drop a collapsed weight's latent digits

            if tag == "sum":
                op, unit = m // k, m % k
                per_op = [
                    (
                        jnp.where(active & (op == hh), unit, neg),
                        jnp.where(active & (op == hh), tcomb, neg),
                    )
                    for hh in range(h)
                ]
                _push(e, per_op)
                continue
            if tag == "cpt":
                units = [jnp.where(active, m, neg)] * h
            else:  # tucker: composite row-major over arity digits
                units = _digit_units(m, h, k, active)
            lists = [
                _take_units(v[:, hh], jnp.maximum(units[hh], 0)) for hh in range(h)
            ]
            ranks = _rank_decompose(lists, jnp.maximum(tcomb, 0), t)
            _push(e, list(zip(units, ranks)))

        # ---- assemble the T assignments ------------------------------------
        dtype = root_vals.dtype
        out_asg = jnp.zeros((bsz, t, num_vars), dtype)
        for e, rec in enumerate(recs):
            if rec[0] != "input":
                continue
            _, xi, mrow, fstates = rec
            u = selu[e]
            active = u >= 0
            safeu = jnp.maximum(u, 0)
            safer = jnp.maximum(selr[e], 0)
            st1 = jnp.take_along_axis(
                fstates[:, None].astype(dtype), safeu[..., None], axis=2
            )  # (F, B, S, T)
            free = jnp.take_along_axis(st1, safer[..., None], axis=3)[..., 0]
            picked = jnp.where(mrow[:, :, None], xi[:, :, None], free)  # (F, B, S)
            wv = jnp.where(active, picked, jnp.zeros((), dtype))
            layer = entries[e].layer
            onehot = jax.nn.one_hot(layer.scope_idx[:, 0], num_vars, dtype=dtype)
            out_asg = out_asg + jnp.einsum(
                "fbs,fd->bsd", wv, onehot, precision=jax.lax.Precision.HIGHEST
            )
        out_asg = jnp.where(mk[:, None, :], xx[:, None, :].astype(dtype), out_asg)
        return out_asg, root_vals[root_output, :, root_unit, :]

    return _run
