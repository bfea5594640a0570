"""Frozen least-work formulas of the port's kernels and the card's peaks:
the yardstick the roofline and mfu readers hold device times against."""
