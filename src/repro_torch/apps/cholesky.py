"""Blocked (tiled) Cholesky decomposition as a task DAG (paper Table II).

Right-looking algorithm over an nb×nb grid of tiles: potrf on the diagonal,
trsm down the panel, syrk/gemm trailing updates.  Paper scale: 10 000² with
1000² tiles; our default scales are laptop-sized but the DAG shape is
identical.  Output is verified against ``numpy.linalg.cholesky``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.apps.base import register_app
from repro_torch.engine.task import task
from repro_torch.injection.engines import NoInjector

SCALES = {
    "tiny": (4, 32),      # nb=4 tiles of 32  -> 20 tasks
    "small": (6, 64),     # nb=6              -> 56 tasks
    "medium": (10, 128),  # nb=10             -> 220 tasks
    "paper": (10, 1000),  # paper config      -> 220 tasks, 10k matrix
}


def make_spd(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, n)).astype(np.float64)
    return b @ b.T + n * np.eye(n)


@task(name="potrf", memory_gb=0.5)
def potrf(a_kk: np.ndarray) -> np.ndarray:
    return np.linalg.cholesky(a_kk)


@task(name="trsm", memory_gb=0.5)
def trsm(l_kk: np.ndarray, a_ik: np.ndarray) -> np.ndarray:
    # solve X L_kk^T = A_ik  =>  solve L_kk X^T = A_ik^T
    x_t = np.linalg.solve(l_kk, a_ik.T)
    return x_t.T


@task(name="syrk", memory_gb=0.5)
def syrk(l_ik: np.ndarray, a_ii: np.ndarray) -> np.ndarray:
    return a_ii - l_ik @ l_ik.T


@task(name="gemm", memory_gb=0.5)
def gemm(l_ik: np.ndarray, l_jk: np.ndarray, a_ij: np.ndarray) -> np.ndarray:
    return a_ij - l_ik @ l_jk.T


@register_app("cholesky")
def submit(injector=None, scale: str = "small", seed: int = 0) -> list:
    injector = injector or NoInjector()
    nb, bs = SCALES[scale]
    n = nb * bs
    a = make_spd(n, seed)
    tiles: dict[tuple[int, int], object] = {}
    for i in range(nb):
        for j in range(i + 1):
            tiles[(i, j)] = a[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs]

    idx = 0

    def nxt(td, *, is_parent=True):
        nonlocal idx
        idx += 1
        return injector.maybe(td, idx, is_parent=is_parent)

    out: list = []
    for k in range(nb):
        tiles[(k, k)] = nxt(potrf)(tiles[(k, k)])
        out.append(tiles[(k, k)])
        for i in range(k + 1, nb):
            tiles[(i, k)] = nxt(trsm)(tiles[(k, k)], tiles[(i, k)])
            out.append(tiles[(i, k)])
        for i in range(k + 1, nb):
            tiles[(i, i)] = nxt(syrk, is_parent=False)(tiles[(i, k)], tiles[(i, i)])
            for j in range(k + 1, i):
                tiles[(i, j)] = nxt(gemm, is_parent=False)(
                    tiles[(i, k)], tiles[(j, k)], tiles[(i, j)])
    return out


def verify(n: int = 384, nb: int = 6) -> float:
    """Standalone correctness check used by tests (no failure injection)."""
    a = make_spd(n)
    ref = np.linalg.cholesky(a)
    bs = n // nb
    tiles = {}
    for i in range(nb):
        for j in range(i + 1):
            tiles[(i, j)] = a[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs].copy()
    for k in range(nb):
        tiles[(k, k)] = np.linalg.cholesky(tiles[(k, k)])
        for i in range(k + 1, nb):
            tiles[(i, k)] = np.linalg.solve(tiles[(k, k)], tiles[(i, k)].T).T
        for i in range(k + 1, nb):
            tiles[(i, i)] = tiles[(i, i)] - tiles[(i, k)] @ tiles[(i, k)].T
            for j in range(k + 1, i):
                tiles[(i, j)] = tiles[(i, j)] - tiles[(i, k)] @ tiles[(j, k)].T
    l = np.zeros_like(a)
    for (i, j), t in tiles.items():
        l[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = t
    return float(np.max(np.abs(l - ref)))
