"""The reference's examples as entry points of the port.

``python -m repro_torch.examples.<name>`` for ``quickstart`` and
``autoscale_spike`` (numpy runs of the planner, the Tuner and the
simulated cluster: no device), ``serve_real_models`` (real models
served as a two-stage cascade: profile, plan, serve, closed-loop tune)
and ``train_arch`` (any architecture's smoke config trained, with a
checkpoint round trip). The last two run on the card unless given
``--device cpu``.
"""
