"""Federated-learning loop of the port (paper Algorithm 1, packed backend)."""

from repro_torch.fl.trainer import (FLConfig, ServerState, init_server,
                                    make_fl_step, train)

__all__ = ["FLConfig", "ServerState", "init_server", "make_fl_step", "train"]
