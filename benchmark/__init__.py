"""The PyTorch port's benchmark (``BENCHMARK.json``): ``run.py`` runs one cell,
``harness.py`` finds its parts by name."""
