"""The LEGO mapping engine of the port.

Copies of the reference's NumPy modules (``affine``, ``workload``,
``dataflow``, the closed-form part of ``cost``, ``perf_model``, ``mapper``
and ``fusion.estimate_data_nodes``), the batched engine ``mapper_batch``,
and ``perf_model_torch``, the twin of the reference's JAX scoring engine:
every mapping candidate of a query batch, design axis included, scored on
the card in int64/float64.  Importing this package does not initialise
CUDA.
"""
