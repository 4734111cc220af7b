"""Serving steps of the LM (``serve_step``) for every family; training is
not ported yet (ROADMAP.md §1 item 14)."""
