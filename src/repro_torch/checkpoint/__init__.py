"""Checkpoints with a CRC envelope, and the switching-cost model."""
from repro_torch.checkpoint.ckpt import (CheckpointCorruptError,
                                         checkpoint_bytes, deserialize,
                                         reconfiguration_mu, restore, save,
                                         serialize, transfer_seconds)

__all__ = ["CheckpointCorruptError", "checkpoint_bytes", "deserialize",
           "reconfiguration_mu", "restore", "save", "serialize",
           "transfer_seconds"]
