"""The benchmark's harness: cells by name, the inputs made from the seed,
the measured window, the comparison that decides ``correct``, and the
reading of the trace. Nothing here imports JAX or the JAX package."""
