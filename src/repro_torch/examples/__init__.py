"""The port's entry-point examples, one module each, run as
``python -m repro_torch.examples.<name>``:

  * ``fairness_demo``       — the paper's Figs. 9, 10, 12, 13 on the host
    simulators (host numpy on every machine);
  * ``qos_controller_demo`` — the closed QoS loop on the serving engine's
    scheduling core (host numpy; no model);
  * ``quickstart``          — build a model, take three training steps,
    serve two tenants;
  * ``multi_tenant_serving`` — the congestor/victim scenario served by a
    real model;
  * ``train_100m``          — a ~100M-parameter decoder trained with
    gradient accumulation and asynchronous checkpoints.

The last three run a model: on the card (``--device cuda``, the default;
without a card they raise) through the hand-written kernels
(``attn_impl="pallas"``), or on the CPU with ``--device cpu``, where the
kernels' plain versions run.  Each module has ``main(argv=None)``.
"""
