"""``round_p95_ms``: the 95th percentile (linear between order
statistics) of every root round's wall time in the window, each solve's
cold first round included -- the gap of the round streamed by
``on_round`` from the one before it, the first from the job's start."""
import numpy as np


def read(ctx):
    r = ctx["round_seconds"]
    return float(np.percentile(r, 95)) * 1e3 if r else None
