"""YOLOv8 training on one card: the TAL assigner, the CIoU / BCE / DFL loss,
the AdamW train step, the augmenting data loader, checkpoints and the
synthetic dataset writers (port of ``rtmodt_tpu/training``)."""
