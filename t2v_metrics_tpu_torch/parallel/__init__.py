"""Multi-process parallelism over ``torch.distributed`` (port of
t2v_metrics_tpu/parallel/{mesh,pipeline,sp}.py).

  * ``mesh``: the rank layout with the JAX axis names ("dp"[, "sp"][, "ep"],
    "tp"; "dcn", "dp", "tp" across hosts), one process group per axis slice,
    the partition specs of the JAX path rules and the sharding of the port's
    modules (tensor, data and expert parallelism);
  * ``comm``: the collectives the port calls, host-staged on gloo where gloo
    takes no CUDA tensor;
  * ``pipeline``: GPipe over a "pp" axis for the T5 encoder;
  * ``sp``: sequence parallelism, explicit: the ambient ``with mesh:`` and
    ``shard_seq``;
  * ``launch``: ranks as spawned processes with a time limit.

``parallel/deploy.py`` (the v5e AOT fit plans) has no counterpart.
"""
