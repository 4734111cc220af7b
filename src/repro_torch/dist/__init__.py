"""repro_torch.dist — of the distributed runtime (ROADMAP.md §1 item 11)
the single-process pieces are ported: ``checkpoint`` (``atomic_save_npz``
and the step ``CheckpointManager``) and ``fault.ResilientLoop``; the
mesh-sharded map/reduce, collectives and ``BackupShardPlan`` are not."""
