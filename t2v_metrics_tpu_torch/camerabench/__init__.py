"""CameraBench two-stage evaluation harness (reference camerabench/*).

Stage 1 (method-specific) generates standardized JSON score files; Stage 2
(method-agnostic) evaluates any score file matching the contracts — so
Stage 2 doubles as an offline test surface (reference camerabench/README.md).

The port's copy of t2v_metrics_tpu/camerabench (without ``data_download``,
which downloads). The Stage-1 loops record a sample whose media cannot be
read as an error with score 0.0, as the reference does; they catch only
the readers' ``MediaError``, so a failure of torch, CUDA or a kernel (its
wrapper's ValueError, a library that does not load) stops the run.
"""
