"""portbench: the benchmark of ``sdf3d_tpu_torch``, the PyTorch and CUDA port.

One run measures one cell (a configuration under a traffic mix) of
``BENCHMARK.json``:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data: a configuration is ``configs/<name>.json``
(its scene tree, whose nodes' plain distances are ``reference/nodes/<op>.py``
and whose nodes' operation counts are ``work/nodes/<op>.json``), a traffic
mix is ``traffic/<name>.json`` and a per-layer metric is
``metrics/<name>.py``, each found by its name in ``BENCHMARK.json`` (a
variant ``<name>.<suffix>``, the same quantity under a bound of its own, is
read by ``<name>``'s reader unless it has a file of its own).
Nothing here imports the JAX package or JAX.
"""
