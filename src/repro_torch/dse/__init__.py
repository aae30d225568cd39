"""The mapping half of the reference's design-space exploration
(``repro.dse``), with candidates scored on the card.

``space``       — copy of the declarative :class:`DesignSpace` and ``SPACES``
``cache``       — the storage half of the persistent mapping cache (the
reference's file format, both ways)
``batch_sweep`` — design-batched prefill of that cache
(``python -m repro_torch.dse.batch_sweep``)

The evaluation over a warm cache (fusion credits, baselines, the Pareto
frontier) stays the reference's NumPy code.
"""
