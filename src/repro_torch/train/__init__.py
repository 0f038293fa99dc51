"""Training: loss, AdamW, the train step and checkpoints (the port's copy
of repro.train, single device).

    from repro_torch.train.train_step import make_train_step, init_train_state
    from repro_torch.train.checkpoint import CheckpointManager
"""
