"""Training of the LM (``optimizer``, ``train_step``) and its serving steps
(``serve_step``) for every family."""
