"""stretchbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` on the card::

    python3 -m stretchbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is a deployment (``deployments/<name>.json``) under a traffic mix
(``traffic/<name>.json``); the deployment's ``kind`` names the module of
``kinds/`` that builds its pipeline and checks its outputs against the
plain reference in ``reference/``.  Each end-to-end metric is read by
``e2e/<name>.py`` and each per-layer metric by ``layers/<name>.py``.  See
``README.md``.
"""
