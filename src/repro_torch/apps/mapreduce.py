"""MapReduce word count (paper Table II): N map tasks + 1 reduce task.

Each map task deterministically generates a "file" of words and counts
them; the reduce task merges the counts.  Paper config: 100 map tasks over
100 generated files.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from repro_torch.apps.base import register_app
from repro_torch.engine.task import task
from repro_torch.injection.engines import NoInjector

_WORDS = ("wrath task pool node retry failure heartbeat monitor worker "
          "manager pilot resilience layer hierarchy denylist policy").split()

SCALES = {
    "tiny": (8, 200),
    "small": (20, 500),
    "medium": (100, 2000),
    "paper": (100, 20000),
}


@task(name="map_count", memory_gb=0.5)
def map_count(seed: int, n_words: int) -> dict[str, int]:
    rng = np.random.default_rng(seed)
    words = rng.choice(_WORDS, size=n_words)
    return dict(Counter(words.tolist()))


@task(name="reduce_merge", memory_gb=0.5)
def reduce_merge(counts: list[dict[str, int]]) -> dict[str, int]:
    total: Counter = Counter()
    for c in counts:
        total.update(c)
    return dict(total)


@register_app("mapreduce")
def submit(injector=None, scale: str = "small", seed: int = 0) -> list:
    injector = injector or NoInjector()
    n_map, n_words = SCALES[scale]
    maps = []
    for i in range(n_map):
        td = injector.maybe(map_count, i, is_parent=True)
        maps.append(td(seed + i, n_words))
    red = injector.maybe(reduce_merge, n_map, is_parent=False)
    return [red(maps)]
