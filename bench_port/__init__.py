"""The benchmark of ``tpuclip_torch`` on one NVIDIA card.

One command runs one cell once::

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root lists the cells. Every piece of a
cell is found by its name: the configuration's file (``configs/``), the
traffic mix (``traffic/<traffic>.json``), the limits of the comparison that
decides ``correct`` (``limits/<workload>.json``), the driver the mix names
(``drivers/<driver>.py``) and one reader per per-layer metric
(``metrics/<metric>.py``). A later change adds a cell, a mix or a metric as
new files and new entries. Nothing here imports ``jax`` or the JAX package;
the plain reference (``reference/``) imports nothing of the program either.
"""
