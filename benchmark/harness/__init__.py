"""The benchmark harness of ma_tpu_torch: cell lookup, workload generation,
the measured window, trace reading. Imports nothing of the JAX package."""
