"""repro_torch.dist — of the distributed runtime (ROADMAP.md §1 item 11)
only ``checkpoint.atomic_save_npz`` is ported, for the search index."""
