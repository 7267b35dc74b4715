"""The benchmark of the PyTorch/CUDA port (``pose_transfer_torch``).

``python3 -m portbench.run`` runs one cell of ``BENCHMARK.json`` once;
configurations (``configs/``), traffic mixes (``traffic/*.json``, read by
the generator module ``traffic/<kind>.py``), cells (``workloads/``) and
per-layer metric readers (``metrics/<metric>.py``) are files found by
name. ``reference/`` is the plain reference that decides ``correct``;
``calibrate.py`` and ``sweep.py`` are the one-off tools its limits and the
open-loop mix's rate were set with.
"""
