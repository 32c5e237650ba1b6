"""The benchmark of hemocell_tpu_torch: ``run.py`` runs one cell of the
repository's ``BENCHMARK.json``; see README.md."""
