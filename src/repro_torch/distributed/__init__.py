"""Distribution layer; port of repro.distributed: the logical-axis rules
(:mod:`~repro_torch.distributed.sharding`), the mesh surface
(:mod:`~repro_torch.distributed.compat`), the collectives
(:mod:`~repro_torch.distributed.collectives`) and the straggler and hang
watchdog (:mod:`~repro_torch.distributed.watchdog`)."""
