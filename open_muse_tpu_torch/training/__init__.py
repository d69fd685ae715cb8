"""Training of MaskGiTUViT_v2: masking, schedules, optimizer, EMA, the train
step, checkpoints, pre-encoded data and the ``train_muse`` entry point."""
