"""Training substrate of the port (counterpart of ``repro.training``):
AdamW with an f32 master, the deterministic data pipeline, atomic
checkpoints, restarts after a failure and the straggler watchdog."""
