"""portbench: the benchmark of qoipp_tpu_torch, the PyTorch and CUDA port
of the QOI codec, on an NVIDIA H100.  See PERF.md and BENCHMARK.json."""
