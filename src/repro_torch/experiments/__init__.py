"""The paper's experiments on the exact AsyncPSGD simulator (the
counterparts of ``examples/async_vs_sync_cnn.py``, ``benchmarks/convergence.py``
and ``benchmarks/ablation_momentum.py``).  Each module runs as
``python -m repro_torch.experiments.<name>``, on the card by default
(``--device cpu`` for a CPU run), and takes a ``params`` hook so a caller can
start it from given initial params (e.g. the reference's, through
:func:`repro_torch.bridge.cnn_params_from_jax`)."""
