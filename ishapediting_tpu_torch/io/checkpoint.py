"""Train-state checkpoints: the counterpart of the JAX package's
``io/checkpoint.py`` (orbax) for a torch ``TrainState``.

A checkpoint is a directory (``step_<N>`` under a run's checkpoint
directory) holding one ``torch.save`` file with the step, the parameters,
their EMA and the optimizer's state (Adam moments and step counts). A save
is written into a sibling temporary directory and renamed into place, so a
run cut off mid-save leaves no partial ``step_<N>`` behind. Reading the JAX
package's orbax directories waits for the orbax reader (ROADMAP).
"""

from __future__ import annotations

import os
import shutil

import torch

STATE_FILE = "train_state.pt"


def save_train_state(path: str, state) -> int:
    """Write ``state`` (a ``train.trainer.TrainState``) into the directory
    ``path``, replacing one that is there. Returns the bytes written."""
    path = os.path.abspath(path)
    tmp = path + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    blob = {
        "step": int(state.step),
        "params": state.model.state_dict(),
        "ema_params": state.ema_params,
        "optimizer": state.optimizer.state_dict(),
    }
    torch.save(blob, os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return os.path.getsize(os.path.join(path, STATE_FILE))


def load_train_state(path: str, state):
    """Load the checkpoint directory ``path`` into ``state`` in place (every
    tensor keeps its device; the optimizer places its state as it does when
    it creates it, Adam's step counts on the host); returns ``state``."""
    blob = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    state.model.load_state_dict(blob["params"])
    if blob["ema_params"].keys() != state.ema_params.keys():
        raise ValueError(f"{path}: EMA parameters do not match the model's")
    with torch.no_grad():
        for k, v in state.ema_params.items():
            v.copy_(blob["ema_params"][k])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return state
