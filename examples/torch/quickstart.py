"""Quickstart on the PyTorch port: the task-hierarchy API in ~70 lines.

The port's counterpart of ``examples/quickstart.py``, through
``repro_torch`` alone.  Builds the paper's §VII-C heterogeneous testbed
(192 GB nodes + one 6 TB node), then runs a small DAG inside a
:class:`Workflow` scope with a composable resilience-policy stack.  A
memory-hungry task OOMs on the default pool; WRATH categorizes the
failure (runtime layer → resource starvation → capacity mismatch) and
retries it hierarchically onto the big-memory pool (rung 4), while the
same workload under a baseline ``replay(3)`` stack burns its budget in
place and dies.  The engine schedules host tasks: nothing here runs on a
card.

    PYTHONPATH=src python examples/torch/quickstart.py
"""
import argparse

from repro_torch.api import (
    Cluster,
    DataFlowKernel,
    DependencyError,
    MonitoringDatabase,
    WrathPolicy,
    replay,
    task,
)


@task(memory_gb=1)
def tokenize(doc: str) -> list[str]:
    return doc.split()


@task(memory_gb=200)          # needs more than the 192 GB default nodes
def embed_corpus(tokens: list[str]) -> dict[str, float]:
    return {t: float(len(t)) for t in tokens}


@task(memory_gb=1)
def top_word(emb: dict[str, float]) -> str:
    return max(emb, key=emb.get)


def main(argv: list[str] | None = None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    cluster = Cluster.paper_testbed(small_nodes=3, big_nodes=1)
    wrath = WrathPolicy()

    with DataFlowKernel(cluster, monitor=MonitoringDatabase(),
                        policy=[wrath], default_pool="small-mem") as dfk:
        # a named scope: per-scope retry default, scope-wide wait()/stats()
        with dfk.workflow("quickstart", retries=2) as wf:
            toks = tokenize("wrath makes task based parallel programming resilient")
            emb = embed_corpus(toks)     # OOMs on small-mem, recovers on big-mem
            best = top_word(emb)
        word = best.result(timeout=30)
        print("longest word:", word)
        wf.wait(timeout=30)
        print("\nWRATH decisions:")
        for d in wrath.decisions:
            print(f"  [{d['layer']}/{d['failure_type']}] -> {d['action']} "
                  f"(rung {d['rung']}): {d['reason'][:80]}")
        print("\nscope stats:", wf.stats())
        print("engine stats:", {k: round(v, 4) for k, v in dfk.stats.items() if v})

    # same workload on an explicit baseline stack: replay(3) retries in
    # place (HPX-style task replay, no resource analysis) and fails
    baseline_error = None
    with DataFlowKernel(Cluster.paper_testbed(small_nodes=3, big_nodes=1),
                        monitor=MonitoringDatabase(),
                        default_pool="small-mem") as dfk:
        try:
            doomed = embed_corpus.options(policy=replay(3))(tokenize("same workload"))
            top_word(doomed).result(timeout=30)
        except (MemoryError, DependencyError) as e:
            baseline_error = type(e).__name__
            print(f"\nbaseline replay(3) failed as expected after "
                  f"{dfk.stats['retries']:.0f} wasted retries: "
                  f"{type(e).__name__}: {e}")
    return {"word": word, "decisions": len(wrath.decisions), "baseline_error": baseline_error}


if __name__ == "__main__":
    main()
