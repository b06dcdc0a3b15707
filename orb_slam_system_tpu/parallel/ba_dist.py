"""Edge-sharded global bundle adjustment over a device mesh.

The implicit Schur-CG GBA (solvers/local_ba.bundle_adjust_cg) is built on
edge-parallel reductions; this variant shards the EDGE list over a device
mesh with `shard_map` — each device holds an edge shard (its observations'
residuals/Jacobians) while cameras and points are replicated, and every
edge-reduced quantity (normal-equation blocks, gradients, the Schur
matvec's cross terms, robust costs) is a `psum` over the mesh. This is the
multi-chip analogue of the reference's single-process g2o GBA
(src/Optimizer.cc:22-27) for maps whose observation count outgrows one
chip — the same scale-out axis as parallel/pose_graph_dist.py.

Per-CG-iteration communication: two [C,6] and one [P,3] psum — tiny next
to the edge work, so the shard efficiency approaches E/n_devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from orb_slam_system_tpu.solvers.local_ba import BAProblem, bundle_adjust_cg


def bundle_adjust_cg_sharded(
    mesh: Mesh, prob: BAProblem, fx, fy, cx, cy,
    n_iters: int = 10, use_huber: bool = True, cg_iters: int = 40,
):
    """Same contract as bundle_adjust_cg, with edges sharded over the
    mesh's first axis. Pads the edge list to the shard multiple (padding
    edges are invalid)."""
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    E = prob.e_cam.shape[0]
    Ep = -(-E // n_dev) * n_dev

    def pad(x, fill=0):
        x = jnp.asarray(x)
        if x.shape[0] == Ep:
            return x
        pad_shape = (Ep - x.shape[0],) + x.shape[1:]
        return jnp.concatenate(
            [x, jnp.full(pad_shape, fill, x.dtype)], axis=0)

    prob_p = prob._replace(
        e_cam=pad(prob.e_cam), e_pt=pad(prob.e_pt),
        e_uv=pad(prob.e_uv), e_inv_sigma2=pad(prob.e_inv_sigma2),
        e_valid=pad(prob.e_valid, False),
        e_ur=pad(prob.e_ur, -1.0) if prob.e_ur is not None else None)

    edge_spec = P(axis)
    rep = P()
    # bf is a static float: close over it so the pytree carries arrays only.
    bf = float(prob_p.bf)
    prob_arrays = prob_p._replace(bf=0.0)

    def local(p):
        return bundle_adjust_cg(p._replace(bf=bf), fx, fy, cx, cy,
                                n_iters=n_iters, use_huber=use_huber,
                                cg_iters=cg_iters, axis_name=axis)

    in_specs = BAProblem(
        Tcw=rep, cam_fixed=rep, cam_valid=rep, points=rep, pt_valid=rep,
        e_cam=edge_spec, e_pt=edge_spec, e_uv=edge_spec,
        e_inv_sigma2=edge_spec, e_valid=edge_spec,
        e_ur=edge_spec if prob_p.e_ur is not None else None,
        bf=rep)
    smapped = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(in_specs,),
        out_specs=(rep, rep),
        check_vma=False,
    )
    Tcw, X = jax.jit(smapped)(prob_arrays)
    return Tcw, X
