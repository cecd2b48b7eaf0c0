"""The port's command-line entry points (copies of t2v_metrics_tpu/cli)."""
