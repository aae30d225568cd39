"""The LEGO core of the port: the mapping engine and the generator.

Copies of the reference's NumPy modules (``affine``, ``workload``,
``dataflow``, ``cost``, ``perf_model``, ``mapper``, ``fusion``,
``baselines``), the batched engine ``mapper_batch``, and
``perf_model_torch``, the twin of the reference's JAX scoring engine:
every mapping candidate of a query batch, design axis included, scored on
the card in int64/float64.

The generator (the paper's Fig. 1 flow): ``interconnect``, ``spanning``,
``memory``, ``fusion`` and ``adg`` build the fused architecture
description graph, ``dag``, ``passes`` and ``emit`` lower it to primitives,
run the LP/ILP back end and write structural Verilog (host NumPy/SciPy,
the reference's results bit for bit), and ``funcsim`` and ``rtlsim``
execute it on the device the inputs lie on.  Importing this package does
not initialise CUDA.
"""
