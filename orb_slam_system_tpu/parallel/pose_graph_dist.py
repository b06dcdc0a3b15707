"""Edge-sharded Sim3 pose-graph optimization over a device mesh.

The single-chip essential-graph solver (solvers/pose_graph.py) is built on
edge-parallel reductions and takes an `axis_name`: under `shard_map` each
device computes residuals/Jacobians for its EDGE shard and every global
quantity (gradient, block-Jacobi diagonal, CG matvec, LM costs) is a
`psum` over the 'graph' axis — the pose-graph analogue of
data-parallel gradient aggregation (SURVEY.md §5: "pose-graph solves
sharded over the interconnect if multi-chip"). Vertices are replicated (a few thousand
7-vectors — tiny next to edge work). This module is the thin mesh wrapper:
pad the edge list to the shard multiple, shard it, call the same solver.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from orb_slam_system_tpu.solvers.pose_graph import optimize_essential_graph


def optimize_essential_graph_sharded(
    mesh: Mesh,
    R0, t0, s0, v_fixed, v_valid,
    e_i, e_j, e_R, e_t, e_s, e_valid,
    n_iters: int = 20, cg_iters: int = 50,
):
    """Same contract as solvers.pose_graph.optimize_essential_graph, with
    edges sharded over the mesh's first axis. Pads the edge list to the
    shard multiple (padding edges are invalid)."""
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    E = e_i.shape[0]
    Ep = -(-E // n_dev) * n_dev
    f32 = jnp.float32

    def pad(x, fill=0):
        if x.shape[0] == Ep:
            return jnp.asarray(x)
        pad_shape = (Ep - x.shape[0],) + x.shape[1:]
        return jnp.concatenate(
            [jnp.asarray(x), jnp.full(pad_shape, fill, x.dtype)], axis=0)

    e_i = pad(jnp.asarray(e_i, jnp.int32))
    e_j = pad(jnp.asarray(e_j, jnp.int32))
    e_R = pad(jnp.asarray(e_R, f32))
    e_t = pad(jnp.asarray(e_t, f32))
    e_s = pad(jnp.asarray(e_s, f32), 1)
    e_valid = pad(jnp.asarray(e_valid), False)

    def local(R0_, t0_, s0_, v_fixed_, v_valid_, ei, ej, eR, et, es, ev):
        # The psums over `axis` make every device's solve globally
        # identical.
        return optimize_essential_graph(
            R0_, t0_, s0_, v_fixed_, v_valid_, ei, ej, eR, et, es, ev,
            n_iters=n_iters, cg_iters=cg_iters, axis_name=axis)

    smapped = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(),
                  P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False)
    return jax.jit(smapped)(
        jnp.asarray(R0, f32), jnp.asarray(t0, f32), jnp.asarray(s0, f32),
        jnp.asarray(v_fixed), jnp.asarray(v_valid),
        e_i, e_j, e_R, e_t, e_s, e_valid)
