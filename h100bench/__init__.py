"""The benchmark of the PyTorch / CUDA port (``t2v_metrics_tpu_torch``) on
one NVIDIA H100: one cell, one seed, one run per process
(``python3 -m h100bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``). See README.md."""
