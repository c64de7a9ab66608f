"""Distribution layer; port of repro.distributed.  Only the straggler and
hang watchdog so far (:mod:`repro_torch.distributed.watchdog`); sharding
and collectives come with the multi-GPU slice."""
