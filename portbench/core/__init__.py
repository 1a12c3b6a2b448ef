"""The benchmark's own modules: the registry of cells, configurations and
metrics, the inputs (BAL text, the stand-in generator, start points), the
trace reduction, the roofline counts and the comparison that decides
``correct``. None of them imports JAX or the JAX package; only
``session`` imports the port under test."""
