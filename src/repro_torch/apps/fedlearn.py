"""Federated learning (paper Table II): torch MLP on synthetic MNIST.

Per round, each client runs local SGD steps on its shard (one task per
client), then an aggregation task averages the weights (FedAvg), then an
evaluation task scores the global model.  Labels derive from a fixed random
linear map of the images, so the model genuinely learns and the test
asserts decreasing loss.

Ports ``src/repro/apps/fedlearn.py``: the jitted jax MLP and its SGD are
plain torch functions, differentiated by ``torch.autograd`` on ``device``.
Tasks take and return host data (numpy dicts and floats), as the
reference's do, so ``aggregate`` is a copy and every task boundary is the
same in both packages.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.apps.base import register_app
from repro_torch.device import resolve_device
from repro_torch.engine.task import task
from repro_torch.injection.engines import NoInjector

SCALES = {
    # (clients, rounds, local_epochs, samples_per_client)
    "tiny": (2, 2, 1, 64),
    "small": (4, 2, 2, 128),
    "medium": (8, 3, 3, 256),   # paper: 8 clients, 3 rounds, 3 epochs
    "paper": (8, 3, 3, 1024),
}

_IMG = 64        # flattened "image" size (synthetic MNIST proxy)
_CLASSES = 10
_HIDDEN = 32


def _client_data(client: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(500 + client)
    x = rng.standard_normal((n, _IMG)).astype(np.float32)
    w_true = np.random.default_rng(42).standard_normal((_IMG, _CLASSES))
    y = np.argmax(x @ w_true, axis=1)
    return x, y


def init_params(seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "w1": (rng.standard_normal((_IMG, _HIDDEN)) * 0.1).astype(np.float32),
        "b1": np.zeros(_HIDDEN, np.float32),
        "w2": (rng.standard_normal((_HIDDEN, _CLASSES)) * 0.1).astype(np.float32),
        "b2": np.zeros(_CLASSES, np.float32),
    }


def loss_fn(params: dict[str, torch.Tensor], x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(x @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    return F.nll_loss(F.log_softmax(logits, dim=-1), y)


def sgd_epoch(params: dict[str, torch.Tensor], x: torch.Tensor,
              y: torch.Tensor, lr: float) -> dict[str, torch.Tensor]:
    """One full-batch gradient step."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    # tasks run on the executor's worker threads, never in forked
    # processes: grad mode is per thread (on by default, so enabled here
    # for callers that turned it off) and the TF32 switch is global, so
    # both hold inside a task as the caller set them
    with torch.enable_grad():
        grads = torch.autograd.grad(loss_fn(leaves, x, y), list(leaves.values()))
    return {k: (p - lr * g).detach() for (k, p), g in zip(leaves.items(), grads)}


def _on(device: torch.device, params: dict, client: int,
        n: int) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    x, y = _client_data(client, n)
    return ({k: torch.tensor(v, device=device) for k, v in params.items()},
            torch.as_tensor(x, device=device), torch.as_tensor(y, device=device))


@task(name="client_update", memory_gb=1.0, est_duration_s=0.5)
def client_update(params: dict, client: int, n: int, epochs: int,
                  lr: float = 0.5, device: str = "cuda") -> dict:
    params, x, y = _on(resolve_device(device), params, client, n)
    for _ in range(epochs):
        params = sgd_epoch(params, x, y, lr)
    return {k: v.cpu().numpy() for k, v in params.items()}


@task(name="aggregate", memory_gb=0.5)
def aggregate(client_params: list[dict]) -> dict:
    out = {}
    for k in client_params[0]:
        out[k] = np.mean([cp[k] for cp in client_params], axis=0)
    return out


@task(name="evaluate", memory_gb=0.5)
def evaluate(params: dict, n: int = 256, device: str = "cuda") -> float:
    params, x, y = _on(resolve_device(device), params, 999, n)
    with torch.no_grad():
        return float(loss_fn(params, x, y))


@register_app("fedlearn")
def submit(injector=None, scale: str = "small", seed: int = 0,
           device: str = "cuda") -> list:
    injector = injector or NoInjector()
    device = str(resolve_device(device))
    clients, rounds, epochs, n = SCALES[scale]
    idx = 0

    def nxt(td, *, is_parent=True):
        nonlocal idx
        idx += 1
        return injector.maybe(td, idx, is_parent=is_parent)

    params: object = init_params(seed)
    out: list = []
    for r in range(rounds):
        updates = [nxt(client_update)(params, c, n, epochs, device=device)
                   for c in range(clients)]
        params = nxt(aggregate, is_parent=False)(updates)
        out.append(nxt(evaluate, is_parent=False)(params, device=device))
    out.append(params)
    return out
