"""Benchmark labs of the port, the counterparts of the JAX package's
``benchmarks/`` on the paths that are ported: ``exp_ad`` (the fit step's
fixed cost, K9), ``neural_crossover``, ``autotune`` and ``suite``.  Each is
run as ``python -m sdf3d_tpu_torch.benchmarks.<name>`` on a machine with a
card."""
