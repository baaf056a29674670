#!/usr/bin/env python3
"""How far fp32 decode lies from the kernel-driven forward, and why.

    python3 tools/decode_sensitivity.py [ARCH ...]    # default: the three below

On one NVIDIA GPU, from the repo root.  For each architecture at full
width and ``chip_smoke.py``'s card depth (``card_config``; random weights
from seed 0, as ``chip_smoke.py`` draws them, cast to fp32; an MoE at
capacity factor n_experts / top_k, where nothing drops) it prints one JSON
line per reading of ``chip_smoke.py``'s decode-vs-forward measure (the
per-row relative L2 error of the logits at the prompt's last position and
at 8 teacher-forced decode steps), over ``chip_smoke.py``'s compared
prompt (``CMP_PROMPT``, else ``PROMPT``; an ``embeds`` model fed
unit-normal embeddings):

* ``reference_init`` at ``chip_smoke.py``'s comparison depth (the card's
  depth, or its ``CMP_CUT`` where fp32 there does not fit), and the
  model cut to its first 1, 2, 4, 8 and 16 units of layers (the same
  weights; a unit is the first scan segment's, one layer but for the
  windowed models): how the reading grows with depth;
* ``fan_in_per_layer``: the same draws with each stacked matrix rescaled
  to the fan-in of its input width (a well-conditioned init);
* for an MoE, each of those again with the forward's routing replayed
  from the prefill's and the decode steps' (``_replayed``), which shows
  whether top-k flips carry the difference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

import chip_smoke as cs  # noqa: E402

ARCHS = ("minitron_4b", "seamless_m4t_medium", "olmoe_1b_7b")


@contextlib.contextmanager
def replay_routes(b: int, n_layers: int, steps: int):
    """The forward's top-k experts taken from the prefill's and the decode
    steps' for the same tokens (a ``_path_logits`` run calls each layer
    once in the prefill, once a decode step, then once in the forward); the
    combine weights are the forward's own probabilities of those experts."""
    import repro_torch.models.moe as moe

    route, count, seen = moe._route, [0], [[] for _ in range(n_layers)]

    def replayed(params, xf, m):
        w, idx, aux = route(params, xf, m)
        layer, run = count[0] % n_layers, count[0] // n_layers
        count[0] += 1
        if run <= steps:
            seen[layer].append(idx)
            return w, idx, aux
        idx = torch.cat([r.reshape(b, -1, m.top_k) for r in seen[layer]], 1)
        idx = idx.reshape(-1, m.top_k)
        w = torch.softmax(xf.float() @ params["router"].float(), dim=-1).gather(1, idx)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return w.to(xf.dtype), idx, aux

    moe._route = replayed
    try:
        yield
    finally:
        moe._route = route


def reading(case: str, params, cfg, ids, s: int, steps: int, enc, replay: bool) -> None:
    t0 = time.perf_counter()
    ctx = replay_routes(ids.shape[0], cfg.n_layers, steps) if replay else contextlib.nullcontext()
    with ctx:
        r = cs._path_logits(params, cfg, ids, s, steps, enc=enc, timed=False)
    rel = cs._rel_rows(r["got"], r["ref"])
    print(json.dumps({"config": cfg.name, "case": case + ("_replayed" if replay else ""),
                      "layers": cfg.n_layers, "rel_err_max": rel.max().item(),
                      "rel_err_by_pos": rel.max(dim=0).values.tolist(),
                      "seconds": time.perf_counter() - t0}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_sensitivity: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.models import materialize, param_defs

    build.build_all()
    for arch in sys.argv[1:] or ARCHS:
        drawn = cs.card_config(arch)
        cfg = drawn.scaled(compute_dtype="float32")
        if cfg.moe:
            cfg = cfg.scaled(moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        b, steps, enc = 4, 8, None
        s = cs.CMP_PROMPT.get(arch, cs.PROMPT.get(arch, 1024))
        params = materialize(param_defs(drawn), 0, "cuda")
        if arch in cs.CMP_CUT:      # fp32 at the card's depth does not fit: chip_smoke's cut
            params, cfg = cs._cut_in_place(params, cfg, cfg.scaled(**cs.CMP_CUT[arch]))
            torch.cuda.empty_cache()
        depth = cfg.n_layers
        cs._recast(params, torch.float32)
        rng = np.random.default_rng(0)
        if cfg.input_kind == "embeds":
            ids = torch.from_numpy(rng.standard_normal((b, s + steps, cfg.d_model))
                                   .astype(np.float32)).cuda()
        else:
            ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s + steps),
                                                dtype=np.int32)).cuda()
        if cfg.encoder_layers:
            enc = torch.from_numpy(rng.standard_normal((b, 1024, cfg.d_model))
                                   .astype(np.float32) * 0.02).cuda()
        replays = (False, True) if cfg.moe else (False,)
        unit = len(cfg.scan_segments()[0][0])
        repeats = cfg.scan_segments()[0][1]
        for n in [unit * r for r in (1, 2, 4, 8, 16) if r <= repeats and unit * r < depth]:
            cut, cut_cfg = cs._first_layers(params, cfg, n)
            for replay in replays:
                reading(f"depth{n}", cut, cut_cfg, ids, s, steps, enc, replay)
            del cut
        for replay in replays:
            reading("reference_init", params, cfg, ids, s, steps, enc, replay)
        params = cs._fan_in_per_layer(params, drawn)
        for replay in replays:
            reading("fan_in_per_layer", params, cfg, ids, s, steps, enc, replay)
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
