"""Launchers of the language-model path (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``) and
their tooling — ports of ``repro/launch``: meshes of ranks
(``launch.mesh``: ``make_host_mesh``, ``make_production_mesh``,
``batch_axes``, ``axis_group``) and the analytic roofline model
(``launch.analytic``: ``step_flops``, ``step_hbm_bytes``,
``roofline_terms`` with the H100's constants)."""
