"""Launch-environment profiles per platform and workload (the port of
``repro.launch.xla_flags``).

The reference keeps its tuned ``XLA_FLAGS`` in one table keyed by
*profile* (train / serve / dryrun) and *platform*, and its launchers
apply them before jax initialises its backend.  The port's counterpart
is the environment variables that PyTorch and the CUDA runtime read
once, when CUDA initialises in the process: the launchers call
:func:`apply_env_flags` before their first CUDA call.

Rules:

* This module imports nothing of torch: the variables only take effect
  if they are in the environment before CUDA initialises.
  :func:`detect_platform` decides from ``CUDA_VISIBLE_DEVICES`` and the
  driver's device node, never by asking torch (``torch.cuda.is_available()``
  would initialise the driver).
* Platform-specific variables are applied only on that platform.
* What the user set wins: a variable already in the environment is kept.
"""
from __future__ import annotations

import os
from collections.abc import Mapping, MutableMapping

__all__ = ["FLAG_SETS", "detect_platform", "flag_env", "merged_flags", "apply_env_flags"]

#: profile -> platform -> {variable: value}.  A variable goes in only when
#: a run on the card shows its launcher needs it.  None has yet: growable
#: allocator segments (``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``)
#: read slower granite train steps and changed neither the serve launcher's
#: tokens/s nor its peak memory on an H100 (PERF.md §6).
FLAG_SETS: dict[str, dict[str, dict[str, str]]] = {
    "train": {"cuda": {}, "cpu": {}},
    "serve": {"cuda": {}, "cpu": {}},
    # the meta-device dry run (ROADMAP.md, Queue 1 item 7) needs none yet
    "dryrun": {"cuda": {}, "cpu": {}},
}


def detect_platform(env: Mapping[str, str] = os.environ) -> str:
    """``cuda`` if a card is visible to this process, else ``cpu``, without
    initialising CUDA: an empty or ``-1`` ``CUDA_VISIBLE_DEVICES`` hides
    every card; otherwise the driver's first device node decides."""
    visible = env.get("CUDA_VISIBLE_DEVICES")
    if visible is not None and visible.strip() in ("", "-1"):
        return "cpu"
    return "cuda" if os.path.exists("/dev/nvidia0") else "cpu"


def flag_env(profile: str, *, platform: str | None = None,
             extra: Mapping[str, str] | None = None) -> dict[str, str]:
    """The variables of ``profile`` on ``platform`` (default: detected)."""
    platform = platform or detect_platform()
    try:
        flags = dict(FLAG_SETS[profile].get(platform, {}))
    except KeyError:
        raise ValueError(f"unknown launch-environment profile {profile!r}; "
                         f"one of {sorted(FLAG_SETS)}") from None
    if extra:
        flags.update(extra)
    return flags


def merged_flags(profile: str, existing: Mapping[str, str] | None = None, *,
                 platform: str | None = None,
                 extra: Mapping[str, str] | None = None) -> dict[str, str]:
    """The profile's variables merged with an ``existing`` environment:
    a variable the user set (to anything but blanks) keeps its value."""
    existing = {} if existing is None else existing
    out = {}
    for name, value in flag_env(profile, platform=platform, extra=extra).items():
        have = existing.get(name)
        out[name] = value if have is None or not have.strip() else have
    return out


def apply_env_flags(profile: str, *, platform: str | None = None,
                    extra: Mapping[str, str] | None = None,
                    env: MutableMapping[str, str] = os.environ) -> dict[str, str]:
    """Set ``profile``'s variables in ``env``, keeping what the user set.
    Returns the variables as set; call before CUDA initialises."""
    merged = merged_flags(profile, env, platform=platform or detect_platform(env),
                          extra=extra)
    env.update(merged)
    return merged
