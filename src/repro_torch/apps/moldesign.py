"""ML-in-the-loop molecule design (paper Table II / §III-A).

Surrogate-model search for molecules with the largest ionization energy:
rounds of (simulate → train surrogate → inference → select).  The
*simulate* task reproduces the paper's **Random Seed Error** (§III-A): for
an unlucky fraction of randomly initialized "molecules" the quantum-
chemistry proxy diverges and raises; after regeneration with a new seed the
task succeeds — the canonical retriable application-layer failure.

The numerical payload is real torch on ``device``: the "simulation"
computes the largest eigenvalue of a molecule-derived symmetric matrix;
the surrogate is ridge regression on random features, fitted with
``torch.linalg``.

Ports ``src/repro/apps/moldesign.py``.  The reference computes in float32
(jax with x64 off makes its float64 features float32), so the port casts
to float32 where ``torch.from_numpy`` would keep float64.  Tasks take and
return host data, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.apps.base import register_app
from repro_torch.core.failures import RandomSeedError
from repro_torch.device import resolve_device
from repro_torch.engine.task import task
from repro_torch.injection.engines import NoInjector

SCALES = {
    # (initial_sims, batch_size, rounds, candidate_pool)
    "tiny": (2, 2, 2, 16),
    "small": (4, 4, 3, 32),
    "medium": (4, 4, 16, 64),   # paper: init 4, batch 4, search count 16
    "paper": (4, 4, 16, 64),
}

_FEAT = 16
_SEED_FAIL_FRACTION = 0.15  # fraction of seeds whose simulation diverges
# per-molecule attempt counter: every (re)execution regenerates the random
# initial assumption, so a retried simulation may succeed (§III-A)
_ATTEMPTS: dict[tuple[int, int], int] = {}


def _molecule_features(mol_id: int) -> np.ndarray:
    rng = np.random.default_rng(10_000 + mol_id)
    return rng.standard_normal(_FEAT)


def _features(mol_ids: list[int], device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.stack([_molecule_features(m) for m in mol_ids]),
                           dtype=torch.float32, device=device)


@task(name="simulate", memory_gb=1.0)
def simulate(mol_id: int, attempt_seed: int = 0,
             device: str = "cuda") -> tuple[int, float]:
    """Quantum-chemistry proxy: largest eigenvalue of a feature-derived
    symmetric matrix.  Sporadically diverges depending on the random
    initial assumption (Random Seed Error, §III-A)."""
    device = resolve_device(device)
    key = (mol_id, attempt_seed)
    attempt = _ATTEMPTS[key] = _ATTEMPTS.get(key, -1) + 1
    rng = np.random.default_rng(((mol_id << 16) ^ attempt_seed) + 7919 * attempt)
    if rng.random() < _SEED_FAIL_FRACTION:
        raise RandomSeedError(
            f"simulation diverged for molecule {mol_id} "
            f"(bad random initial assumption, attempt {attempt})")
    f = _features([mol_id], device)[0]
    m = torch.outer(f, f) + torch.eye(_FEAT, device=device) * 0.1
    energy = float(torch.linalg.eigvalsh(m)[-1])
    return mol_id, energy


@task(name="train_surrogate", memory_gb=1.0)
def train_surrogate(results: list[tuple[int, float]],
                    device: str = "cuda") -> np.ndarray:
    """Ridge regression: features -> energy."""
    device = resolve_device(device)
    x = _features([mid for mid, _ in results], device)
    y = torch.tensor([e for _, e in results], dtype=torch.float32, device=device)
    lam = 1e-3
    w = torch.linalg.solve(x.T @ x + lam * torch.eye(_FEAT, device=device), x.T @ y)
    return w.cpu().numpy()


@task(name="inference", memory_gb=0.5)
def inference(w: np.ndarray, mol_ids: list[int],
              device: str = "cuda") -> list[tuple[int, float]]:
    device = resolve_device(device)
    preds = _features(mol_ids, device) @ torch.tensor(w, device=device)
    return [(m, float(p)) for m, p in zip(mol_ids, preds.cpu())]


@task(name="select", memory_gb=0.5)
def select(preds: list[tuple[int, float]], k: int,
           done: list[int]) -> list[int]:
    ranked = sorted(preds, key=lambda t: -t[1])
    picked = [m for m, _ in ranked if m not in done][:k]
    return picked


@register_app("moldesign")
def submit(injector=None, scale: str = "small", seed: int = 0,
           device: str = "cuda") -> list:
    injector = injector or NoInjector()
    device = str(resolve_device(device))
    init, batch, rounds, pool = SCALES[scale]
    idx = 0

    def nxt(td, *, is_parent=True):
        nonlocal idx
        idx += 1
        return injector.maybe(td, idx, is_parent=is_parent)

    out: list = []
    done_ids = list(range(init))
    sims = [nxt(simulate)(m, seed, device=device) for m in done_ids]
    out.extend(sims)
    candidates = list(range(init, pool))
    results_futures = list(sims)
    for r in range(rounds):
        w = nxt(train_surrogate, is_parent=False)(results_futures, device=device)
        preds = nxt(inference, is_parent=False)(w, candidates, device=device)
        picked = nxt(select, is_parent=False)(preds, batch, done_ids)
        # the next round simulates the picked molecules; since picked is a
        # future we submit the batch via a bridge task producing concrete ids
        new_sims = [nxt(simulate)(mid, seed + r + 1, device=device)
                    for mid in candidates[r * batch:(r + 1) * batch]]
        out.append(picked)
        out.extend(new_sims)
        results_futures = results_futures + new_sims
    return out
