"""Serving steps of the LM (``serve_step``); training is not ported yet
(ROADMAP.md §1 item 14)."""
