"""Checkpoint helpers: so far only the JAX-free :func:`load_finalized_trials`
of :mod:`maggy_tpu.train.checkpoint`, which ``resume_from`` needs. The rest of
the module (the Checkpointer on safetensors) is ROADMAP queue 1 item 4."""

from __future__ import annotations

import json
import os


def load_finalized_trials(exp_dir: str) -> list:
    """Load every persisted trial.json under a previous experiment directory
    (the driver's persistence format, hpo.py _persist_trial). Goes through the
    Env abstraction."""
    from maggy_tpu_torch.core.env import EnvSing
    from maggy_tpu_torch.trial import Trial

    env = EnvSing.get_instance()
    out = []
    if not env.exists(exp_dir):
        raise FileNotFoundError(f"resume_from directory does not exist: {exp_dir}")
    for name in env.listdir(exp_dir):
        path = os.path.join(exp_dir, name, "trial.json")
        if not env.exists(path):
            continue
        try:
            trial = Trial.from_dict(env.load_json(path))
        except (json.JSONDecodeError, KeyError, ValueError):
            continue
        if trial.status in (Trial.FINALIZED, Trial.ERROR):
            out.append(trial)
    return out
