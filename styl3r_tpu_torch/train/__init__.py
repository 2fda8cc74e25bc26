"""Training: the loss bundle, scratch init and the train step (counterpart
of styl3r_tpu/train/losses.py, scratch_init.py and step.py)."""
