"""Distribution over `torch.distributed` — counterpart of `evo_tpu/dist/`.

The JAX package runs its sharded functions inside `shard_map` over a
(space, batch) device mesh; here every rank is a process of a
`torch.distributed` group (NCCL between cards, gloo on the CPU), the mesh is
a `DeviceMesh` of the same two axes, and the collectives are explicit calls
on each axis's process group. Every sharded function takes the global
arrays on every rank, as a `shard_map` caller does, computes its own block
and returns the replicated global result. A sharded function called without
an initialised process group raises.

The mesh reaches the production path through `EvaluatorParams(mesh=...)`:
the tracker holds its block of the patch table's rows
(`tracker.detector.EventTracker(mesh=)`, the sharded window scan and fused
frame step, the policy on `tracker.policy.gathered_view`), and compensation
solves its tile columns over ``space`` on process groups of its own.

- `temporal`: W compensation windows solved at once (one card, or windows
  over the `batch` axis);
- `mesh`: the (space, batch) mesh, its placements, the tracker's group
  (`table_group`), compensation's (`fork_mesh`) and the row gather;
- `halo`: boundary strips exchanged between `space` neighbours;
- `tiling`: the batch-sharded splat and patch solve, the space-sharded
  contrast-max tile solve;
- `reduce`: the BA normal equations reduced over `batch`;
- `multihost`: process-group set-up, a launcher of local ranks, the
  cross-process parity check and the scaling measurements.
"""
