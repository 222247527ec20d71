"""Training: losses, targets, metrics, the optimizer and the train, BN
re-estimation and eval steps (port of insmos_tpu/train)."""
