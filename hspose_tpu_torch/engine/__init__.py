"""Train loop and checkpoints, train step, optimizer and learning-rate
schedules (counterpart of ``hspose_tpu/engine``)."""
