from collide.ckpt.checkpoint import CheckpointManager, BackupManager
