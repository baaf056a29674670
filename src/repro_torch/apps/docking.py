"""Molecular docking proxy (paper Table II): batched pose scoring rounds.

Predicting the orientation/position of two molecules: each *dock* task
scores a batch of random rigid-body poses of a ligand against a receptor
(real numpy geometry: rotation matrices, Lennard-Jones-style scoring) and
returns the best pose; rounds select the most promising poses to refine.
Paper config: 8 initial simulations, batch 8, 3 rounds (160 tasks).
"""
from __future__ import annotations

import numpy as np

from repro_torch.apps.base import register_app
from repro_torch.engine.task import task
from repro_torch.injection.engines import NoInjector

SCALES = {
    # (initial, batch, rounds, atoms, poses_per_task)
    "tiny": (2, 2, 2, 16, 8),
    "small": (4, 4, 2, 24, 16),
    "medium": (8, 8, 3, 48, 64),   # paper shape
    "paper": (8, 8, 3, 64, 256),
}


def _molecule(seed: int, atoms: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((atoms, 3))


def _rotation(seed: int) -> np.ndarray:
    q = np.random.default_rng(seed).standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


@task(name="dock", memory_gb=1.0)
def dock(receptor_seed: int, ligand_seed: int, pose_seed: int,
         atoms: int, n_poses: int) -> tuple[float, int]:
    """Score n_poses random rigid placements; return (best_score, best_seed)."""
    receptor = _molecule(receptor_seed, atoms)
    ligand = _molecule(ligand_seed, atoms // 2)
    best, best_seed = np.inf, pose_seed
    for p in range(n_poses):
        seed = pose_seed * 10_007 + p
        rot = _rotation(seed)
        shift = np.random.default_rng(seed + 1).standard_normal(3) * 2.0
        placed = ligand @ rot.T + shift
        d2 = ((receptor[:, None, :] - placed[None, :, :]) ** 2).sum(-1)
        d2 = np.maximum(d2, 1e-3)
        # 6-12 potential: clash penalty + attraction
        e = (1.0 / d2**6 - 1.0 / d2**3).sum()
        if e < best:
            best, best_seed = float(e), seed
    return best, best_seed


@task(name="select_poses", memory_gb=0.5)
def select_poses(results: list[tuple[float, int]], k: int) -> list[int]:
    ranked = sorted(results)[:k]
    return [seed for _, seed in ranked]


@register_app("docking")
def submit(injector=None, scale: str = "small", seed: int = 0) -> list:
    injector = injector or NoInjector()
    initial, batch, rounds, atoms, n_poses = SCALES[scale]
    idx = 0

    def nxt(td, *, is_parent=True):
        nonlocal idx
        idx += 1
        return injector.maybe(td, idx, is_parent=is_parent)

    out: list = []
    results = [nxt(dock)(seed, seed + 1, 100 + i, atoms, n_poses)
               for i in range(initial)]
    out.extend(results)
    for r in range(rounds):
        picked = nxt(select_poses, is_parent=False)(results, batch)
        out.append(picked)
        results = [nxt(dock)(seed, seed + 1, 1000 * (r + 1) + i, atoms, n_poses)
                   for i in range(batch)]
        out.extend(results)
    return out
