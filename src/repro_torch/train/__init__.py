"""The training substrate, the port of ``repro.train``: optimizers
(``optimizer``), the TrainState and its step (``train_state``), the
single-process loop (``loop``), checkpoints in the reference's format
(``checkpoint``), the restart loop and watchdog (``fault_tolerance``)
and int8 gradient compression (``compression``)."""
