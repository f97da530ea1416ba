"""The benchmark of lzfse_rust_tpu_torch: ``run.py`` runs one cell of
``BENCHMARK.json``; see ``harness.py`` for what a run does."""
