"""Core of the port: the tree topology record, the losses and objectives,
the threefry key replay, the single-leaf oracle, run instrumentation and
the tree-schedule engine."""
