"""Core of the port: the tree topology record, the losses and objectives,
the threefry key replay, the single-leaf oracle, run instrumentation, the
tree-schedule engine (host and mesh backends) and the recursion oracle
(``treedual``, with the mesh shim in ``treedual_mesh``)."""
