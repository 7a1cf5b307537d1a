"""Explicit domain decomposition over torch.distributed (counterpart of
stfem_tpu/parallel/): comm.py holds every collective and their counters,
halo.py the host-side split of dof grids and the sharded operator apply,
sharding.py the device-mesh and per-level policy helpers and a rank's
layout (RankLayout), minibench.py the sharded whole solve and dryrun.py
its multi-rank launcher.  Only space communicates: the time-direction
operations are block-local.

The layout convention, which every piece keeps:
  * a rank holds a CONSISTENT slab: the dofs of its cells, every plane
    it shares with a neighbour holding the full value on both ranks
    (halo.split_dof_grid's slabs, sharding.shard_block_vector);
  * an operator apply is the local apply on the rank's sub-mesh under
    the global mask (a shared plane is interior), which leaves partial
    sums on the shared planes, then one accumulate
    (comm.halo_accumulate_nd; halo.Accumulated, make_sharded_vmult);
  * a dot product or norm is comm.psum_dot / psum_norm, whose interface
    weights count each shared plane once;
  * every step of the V-cycle keeps vectors consistent or ends in one
    accumulate: the smoothers' Vanka is the global one's slice (global
    valence and masks), restriction weights its input by the interface
    weights before the local P^T and accumulates (or, into a replicated
    coarse level, all-reduces), prolongation of a consistent slab is
    consistent, replicated levels compute alike on every rank
    (stmg/gmg.py::distribute_gmg).
"""
