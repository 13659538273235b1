"""Checkpoints of the port in the reference's on-disk format."""

from repro_torch.checkpoint.io import (ASYNC_FIELDS, CHANNEL_FIELDS,
                                       CorruptCheckpointError,
                                       latest_server_step, latest_step,
                                       migrate_server_state, restore,
                                       restore_server_state, save,
                                       save_server_state, server_steps)

__all__ = ["latest_step", "restore", "save", "save_server_state",
           "restore_server_state", "latest_server_step", "server_steps",
           "migrate_server_state", "ASYNC_FIELDS", "CHANNEL_FIELDS",
           "CorruptCheckpointError"]
