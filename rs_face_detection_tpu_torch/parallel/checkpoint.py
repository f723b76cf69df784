"""Checkpoint and resume of a TrainState through torch.distributed.checkpoint.

Counterpart of rs_face_detection_tpu/parallel/checkpoint.py (orbax), with
the same ``<directory>/<step>/`` layout and errors.  The parameters, the
BatchNorm buffers, the optimizer state (through
``torch.distributed.checkpoint.state_dict``, keyed by parameter names), the
step and the EMA parameters survive a restart.  It runs in one process
without a process group, or sharded: a state of ``Trainer(mesh=...)`` is
saved by every rank, each writing its own shards into the one directory,
and a restore loads into the template's placements, as orbax re-applies the
template's shardings, so a state saved on one mesh restores onto another
mesh shape or onto one device.  Inference weights use the registry .npz
instead (models/weights.py::save_flax_checkpoint).
"""

from __future__ import annotations

import copy
import os
import shutil
import warnings
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.state_dict import get_state_dict, set_state_dict

from .train import TrainState

#: DCP warns on every call made without a process group; one process is the
#: intended use here.
_SINGLE_PROCESS = "torch.distributed is disabled, unavailable or uninitialized"


def _steps(directory: str):
    return [int(d) for d in os.listdir(directory) if d.isdigit()]


def save_train_state(directory: str, state: TrainState, step: Optional[int] = None) -> str:
    """Save a TrainState under directory/<step> (replacing one there);
    returns the path.  Sharded: a collective, called by every rank."""
    step = state.step if step is None else step
    path = os.path.join(os.path.abspath(directory), str(step))
    model, optimizer = state.model, state.optimizer
    if not optimizer.state:
        # get_state_dict makes an optimizer's state by a zero step when it
        # has none; a state that has taken no step keeps its own untouched.
        model, optimizer = copy.deepcopy((model, optimizer))
    model_sd, optim_sd = get_state_dict(model, optimizer)
    tree = {"model": model_sd, "optim": optim_sd, "step": torch.tensor(state.step)}
    if state.ema_params is not None:
        tree["ema"] = state.ema_params
    distributed = dist.is_initialized()
    if not distributed or dist.get_rank() == 0:
        shutil.rmtree(path, ignore_errors=True)
    if distributed:
        dist.barrier()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_SINGLE_PROCESS)
        dcp.save(tree, checkpoint_id=path)
    return path


def restore_train_state(directory: str, template: TrainState, step: Optional[int] = None) -> TrainState:
    """Restore a TrainState saved by save_train_state into ``template`` (a
    freshly initialized state of a Trainer of the same model, whose tensors
    keep their devices and placements), from the latest step unless
    ``step`` is given; returns it.  FileNotFoundError when there is no
    checkpoint.  A sharded template: a collective, called by every rank."""
    directory = os.path.abspath(directory)
    if step is None:
        steps = _steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = max(steps)
    path = os.path.join(directory, str(step))
    if not os.path.isdir(path):
        raise FileNotFoundError(path)
    model_sd, optim_sd = get_state_dict(template.model, template.optimizer)
    tree = {"model": model_sd, "optim": optim_sd, "step": torch.tensor(0)}
    if template.ema_params is not None:
        tree["ema"] = template.ema_params
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_SINGLE_PROCESS)
        dcp.load(tree, checkpoint_id=path)
    set_state_dict(template.model, template.optimizer, model_state_dict=tree["model"], optim_state_dict=tree["optim"])
    template.step = int(tree["step"])
    if template.step == 0:  # saved before any update: no optimizer state yet
        template.optimizer.state.clear()
    return template


def latest_step(directory: str) -> Optional[int]:
    """The largest saved step under ``directory``, or None."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None
