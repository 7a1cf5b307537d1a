"""Explicit domain decomposition over torch.distributed (counterpart of
stfem_tpu/parallel/): comm.py holds every collective, halo.py the
host-side split of dof grids and the sharded operator apply, sharding.py
the device-mesh and per-level policy helpers.  Only space communicates:
the time-direction operations are block-local."""
