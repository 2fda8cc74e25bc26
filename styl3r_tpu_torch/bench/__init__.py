"""The port's measurement entry points (counterparts of bench.py,
scripts/bench_train_step.py and scripts/profile_stages.py):

    python -m styl3r_tpu_torch.bench.serve       # scenes/s of predict + render
    python -m styl3r_tpu_torch.bench.train_step  # fwd + bwd of stages 1 and 2
    python -m styl3r_tpu_torch.bench.stages      # per-stage breakdown

Each runs on the card unless given --cpu (with --tiny for a quick run) and
prints one JSON line last. `batch.py` holds their example scene,
`timing.py` their clocks and the profiler's readings. The model code never
imports this package.
"""
