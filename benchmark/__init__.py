"""The benchmark of ``pyrayt_tpu_torch`` on one NVIDIA H100 (see BENCHMARK.json)."""
